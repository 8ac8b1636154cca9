"""Build the CUDA kernels of `csrc/` at first use and call them through ctypes.

Every `csrc/*.cu` file is compiled by nvcc for `sm_90a` into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds): one small source per entry point of `SIGNATURES`, most of them a
mode of a shared header (`gemv.cuh`: the int8 and int4 GEMVs, the expert
gathers and both fused MLPs; `wgmma_gemm.cuh`: the int8 and int4 GEMMs,
per-channel and group-wise; `wgmma_grouped.cuh`: the int8 and int4 grouped
expert GEMMs; `a8_gemm.cuh`: W8A8 and W4A8 on the int8 `wgmma`;
`hopper.cuh`: the `cp.async`, `mbarrier` and `wgmma` wrappers of the
`wgmma` kernels and `flash_attention.cu`), compiled in parallel. The library lands in `eetq_tpu_torch/_build/<hash>/`, keyed on a
hash of the sources and flags, so it is rebuilt only when they change.

Each C entry point launches on the stream it is given, allocates nothing,
and returns `cudaGetLastError()` after its launches; `launch` raises on a
non-zero code. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from eetq_tpu_torch.kernels.autotune import compile_defines

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libeetq_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v", *compile_defines(),
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point; each returns a cudaError_t as int
SIGNATURES = {
    # x, m, k, w, weight rows, np, scales, groups, group_size, bias, gamma,
    # eps, out, n, partials, counters, splits, stream
    "eetq_w8a16_gemv": (_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _F, _P, _I, _P, _P, _I, _P),
    "eetq_w4a16_gemv": (_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _F, _P, _I, _P, _P, _I, _P),
    # x, m, k, w, kp, np, scales, groups, group_size, bias, out, n, stream
    "eetq_w8a16_gemm": (_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P),
    "eetq_w4a16_gemm": (_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P),
    # x, m, k, bank, weight rows, np, scales, groups, group_size, expert_ids,
    # n_sel, out, n, partials, counters, splits, stream
    "eetq_w8a16_expert_gemv": (
        _P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P, _P, _I, _P,
    ),
    "eetq_w4a16_expert_gemv": (
        _P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P, _P, _I, _P,
    ),
    # x, bm, nb, k, bank, kp, np, scales, groups, group_size, block_expert,
    # out, n, real_blocks, stream
    "eetq_w8a16_grouped_gemm": (_P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P),
    "eetq_w4a16_grouped_gemm": (_P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _P),
    # q, k, v, out, b, sq, skv, hq, hkv, d, q strides (b, s, h),
    # k strides, v strides, scale, causal, stream
    "eetq_flash_attention_fwd": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P,
    ),
    # q, k, v, lengths, out, partials, counters, b, hq, hkv, l, d, chunk,
    # scale, stream
    "eetq_flash_decode": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, k_scale, v_scale, lengths, out, partials, counters, b, hq,
    # hkv, l, d, chunk, scale, stream
    "eetq_flash_decode_int8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, k pool, v pool, table, lengths, out, partials, counters, b, hq,
    # hkv, max_blocks, block size, d, chunk, scale, stream
    "eetq_paged_flash_decode": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, k pool, v pool, k_scale, v_scale, table, lengths, out, partials,
    # counters, b, hq, hkv, max_blocks, block size, d, chunk, scale, stream
    "eetq_paged_flash_decode_int8": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
    # xq, m, kp, w, np, sx, sw, bias, out, n, stream
    "eetq_w8a8_gemm": (_P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _P),
    # xq, m, kp, w, np, sx, sw, groups, group_size, bias, out, n, stream
    "eetq_w4a8_gemm": (_P, _I, _I, _P, _I, _P, _P, _I, _I, _P, _P, _I, _P),
    # x, m, k, gamma, eps, gu, kp, i, gu_scales, d, np, d_scales, residual,
    # h, out, n, act, partials, counters, gate/up splits, down splits, stream
    "eetq_fused_mlp_gemv": (
        _P, _I, _I, _P, _F, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P,
    ),
    "eetq_fused_mlp_gemv_i4": (
        _P, _I, _I, _P, _F, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P,
    ),
}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> str:
    """Compile each source in parallel, then link; returns nvcc's output."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "nvcc.log").write_text("\n".join(log))
        os.replace(lib_tmp, out_dir / LIB_NAME)
    return "\n".join(log)


@functools.cache
def build() -> dict:
    """Build (or find) the kernel library; returns {nvcc_version, path, seconds,
    cached, log}."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = BUILD_DIR / _source_hash(nvcc)
    lib_path = out_dir / LIB_NAME
    t0 = time.perf_counter()
    cached = lib_path.exists()
    log = (out_dir / "nvcc.log").read_text() if cached else _compile(nvcc, out_dir)
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    return {
        "nvcc_version": version.stdout.strip().splitlines()[-1],
        "path": str(lib_path),
        "seconds": time.perf_counter() - t0,
        "cached": cached,
        "log": log,
    }


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.eetq_error_string.argtypes = [ctypes.c_int]
    lib.eetq_error_string.restype = ctypes.c_char_p
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call the C entry point `name`; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {lib.eetq_error_string(rc).decode()} ({rc})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# Scratch of the kernels that split a reduction across blocks (the decode
# GEMV's K split, the flash-decode's chunks), per user and device: f32
# partials and int32 counters. The counters are zeroed once here and each
# launch leaves them at zero; both only grow. Launches on one stream use
# them in turn. A larger request replaces a buffer; a CUDA graph captured
# against the old one keeps it alive itself (`live_scratch`), and a request
# that would grow a buffer while a stream is capturing raises: the graph's
# warm-up call sizes the scratch before its capture.
_SCRATCH: dict = {}


def scratch(user: str, device: torch.device, floats: int,
            counters: int) -> tuple[int | None, int | None]:
    """(partials, counters) pointers of `user`'s scratch with room for
    `floats` f32 partials and `counters` int32 counters on `device` (None
    where none are needed)."""
    if not floats:
        return None, None
    part, ctr = _SCRATCH.get((user, device), (None, None))
    grow_part = part is None or part.numel() < floats
    grow_ctr = ctr is None or ctr.numel() < counters
    if (grow_part or grow_ctr) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{user} scratch would grow during a CUDA graph capture: run the "
                           "step once before capturing it")
    if grow_part:
        part = torch.empty(max(floats, 1 << 18), dtype=torch.float32, device=device)
    if grow_ctr:
        ctr = torch.zeros(max(counters, 1 << 12), dtype=torch.int32, device=device)
    _SCRATCH[(user, device)] = part, ctr
    return part.data_ptr(), ctr.data_ptr()


def live_scratch() -> list[torch.Tensor]:
    """Every scratch buffer in use now: what a graph captured now must keep
    alive."""
    return [t for pair in _SCRATCH.values() for t in pair]
