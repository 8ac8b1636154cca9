"""Launch configuration of the Hopper kernels.

Port of the part of `eetq_tpu/kernels/autotune.py` the ported paths need:
the decode/prefill threshold and one fixed launch shape per regime. Most
tile shapes are compile-time constants of the CUDA sources (`csrc/*.cu`);
the W8A8 tile and the fused-MLP slice width are defined here and compiled
in through `-D` flags (`kernels/_build.py`). What is chosen per call lives
here too. The measured sweep and its persistent cache are not ported yet.
"""

from __future__ import annotations

import torch

# Rows at or below this go to the GEMV kernel, above it to the GEMM kernel
# (`eetq_tpu/kernels/autotune.py:42`). The GEMV kernel is instantiated for
# every m in 1..MAX_DECODE_M.
MAX_DECODE_M = 8

# W8A8 GEMM tile: output rows, output columns, K bytes per pipeline step
# (`csrc/w8a8_gemm.cu`; its 256 threads' load mapping asserts this shape).
W8A8_TILE = (128, 128, 64)

# Fused MLP: intermediate columns per gate/up block, the GEMV's 32-column
# strip (`csrc/gemv.cuh`), taken once over the gate and once over the up half.
FUSED_MLP_SLICE = 32

# Dynamic shared memory a block may use on Hopper (232,448 bytes); the GEMV
# kernel holds all of x in it.
MAX_SMEM_BYTES = 232_448

# Flash-decode: one key range ("split") per block. Enough splits that the
# grid covers every SM at least twice, and no split shorter than this.
DECODE_MIN_SPLIT_LEN = 64


def compile_defines() -> tuple[str, ...]:
    """The constants above as nvcc `-D` flags."""
    bm, bn, bk = W8A8_TILE
    return (f"-DEETQ_W8A8_BM={bm}", f"-DEETQ_W8A8_BN={bn}", f"-DEETQ_W8A8_BK={bk}",
            f"-DEETQ_FUSED_MLP_SLICE={FUSED_MLP_SLICE}")


def gemv_smem_bytes(m: int, kp: int) -> int:
    """Shared memory of one GEMV block: x as [Kp, m] bf16 plus its f32
    reduction buffers (1060 bytes per row of x, `csrc/w8a16_gemv.cu`)."""
    return m * (2 * kp + 1060)


def decode_splits(rows: int, max_len: int, device: torch.device) -> tuple[int, int]:
    """(number of splits, keys per split) for a flash-decode launch over
    `rows` = batch x kv heads blocks and a cache of `max_len` slots."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ns = max(1, min(-(-2 * sms // rows), -(-max_len // DECODE_MIN_SPLIT_LEN)))
    chunk = -(-max_len // ns)
    return -(-max_len // chunk), chunk
