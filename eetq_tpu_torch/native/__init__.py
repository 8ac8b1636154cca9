"""Native host-side quantizer and packer (C++ and OpenMP, through ctypes).

Port of `eetq_tpu/native/`: the O(K*N) per-column absmax, round and clip
loops of weight quantization run multithreaded on the host, for weights that
lie on the CPU (a checkpoint converted to a CPU device, `models/hf.py`). On
the card the weights are quantized there (`quant/quantizer.py`).
`quantizer.cc` is a copy of the JAX package's, whose int4 packing follows
the port's layout (rows 2i and 2i + 1 in byte i, `layout/tiling.py`).

The library is built with g++ at first use into `eetq_tpu_torch/_build/`,
keyed by a hash of the source. A build or load that fails raises: there is
no silent fallback. `EETQ_DISABLE_NATIVE=1` is the explicit way to the plain
torch quantizer and packer (the same values, bit for bit).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "quantizer.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
DISABLE_ENV = "EETQ_DISABLE_NATIVE"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-march=native")


def _disabled() -> bool:
    return os.environ.get(DISABLE_ENV, "") not in ("", "0")


@functools.cache
def _build() -> Path:
    """Compile quantizer.cc into a shared library under BUILD_DIR (once per
    source hash); a failed build raises."""
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / f"native-{tag}"
    lib = out_dir / "libeetq_host.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # several processes may build at once: the last one wins
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build()))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name, argtypes in {
        "eetq_quantize_f32": [p, i64, i64, i64, i32, i64, p, p],
        "eetq_quantize_f16": [p, i64, i64, i64, i32, i64, p, p],
        "eetq_quantize_bf16": [p, i64, i64, i64, i32, i64, p, p],
        "eetq_pack_int4": [p, i64, i64, p],
        "eetq_transpose_i8": [p, i64, i64, p],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    lib.eetq_native_version.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    """True unless EETQ_DISABLE_NATIVE is set; builds and loads the library
    (a failure raises)."""
    if _disabled():
        return False
    _load()
    return True


def _check_cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{what} takes a CPU tensor, got one on {t.device}")


_QUANTIZE = {torch.float32: "eetq_quantize_f32", torch.float16: "eetq_quantize_f16",
             torch.bfloat16: "eetq_quantize_bf16"}


def host_symmetric_quantize(w: torch.Tensor, bits: int = 8, group_size: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a CPU weight [K, N] or bank [E, K, N] (f32, f16 or bf16;
    other floats go through f32) on the host: (int8 q of w's shape, f32
    scales [N] / [G, N], with the expert axis in front). The semantics and
    bits of `quant/quantizer.py::symmetric_quantize`."""
    from eetq_tpu_torch.quant.quantizer import symmetric_quantize

    _check_cpu(w, "host_symmetric_quantize")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w.dim() not in (2, 3):
        raise ValueError(f"weight must be 2-D or 3-D, got {tuple(w.shape)}")
    e, k, n = (1, *w.shape) if w.dim() == 2 else tuple(w.shape)
    if group_size is not None and k % group_size:
        raise ValueError(f"group_size {group_size} must divide K {k}")
    if _disabled():
        return symmetric_quantize(w, bits=bits, group_size=group_size)
    if w.dtype not in _QUANTIZE:
        w = w.float()
    w = w.contiguous()
    groups = k // group_size if group_size else 1
    q = torch.empty(w.shape, dtype=torch.int8)
    s = torch.empty((e, groups, n), dtype=torch.float32)
    getattr(_load(), _QUANTIZE[w.dtype])(w.data_ptr(), e, k, n, bits, group_size or 0,
                                         q.data_ptr(), s.data_ptr())
    if group_size is None:
        s = s[:, 0]
    return q, s[0] if w.dim() == 2 else s


def host_pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values held in int8 [Kp, N] (Kp even) to [Kp/2, N] bytes in
    the port's layout: row 2i in the low nibble, row 2i + 1 in the high
    (`layout/tiling.py::pack_int4_rows`)."""
    from eetq_tpu_torch.layout.tiling import pack_int4_rows

    _check_cpu(q, "host_pack_int4")
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] % 2:
        raise ValueError(f"need int8 [even K, N], got {q.dtype} {tuple(q.shape)}")
    if _disabled():
        return pack_int4_rows(q)
    q = q.contiguous()
    kp, n = q.shape
    out = torch.empty((kp // 2, n), dtype=torch.int8)
    _load().eetq_pack_int4(q.data_ptr(), kp, n, out.data_ptr())
    return out


def host_transpose_i8(a: torch.Tensor) -> torch.Tensor:
    """Cache-tiled int8 transpose [rows, cols] -> [cols, rows] (a checkpoint's
    [out, in] to the kernels' [in, out])."""
    _check_cpu(a, "host_transpose_i8")
    if a.dtype != torch.int8 or a.dim() != 2:
        raise ValueError(f"need int8 2-D, got {a.dtype} {tuple(a.shape)}")
    if _disabled():
        return a.t().contiguous()
    a = a.contiguous()
    rows, cols = a.shape
    out = torch.empty((cols, rows), dtype=torch.int8)
    _load().eetq_transpose_i8(a.data_ptr(), rows, cols, out.data_ptr())
    return out


__all__ = [
    "native_available",
    "host_symmetric_quantize",
    "host_pack_int4",
    "host_transpose_i8",
]
