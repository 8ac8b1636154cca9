"""Launch configuration of the Hopper kernels.

Port of the part of `eetq_tpu/kernels/autotune.py` the ported paths need:
the decode/prefill threshold and one fixed launch shape per regime. Most
tile shapes are compile-time constants of the CUDA sources (`csrc/*.cu`);
the W8A8 tile, the fused-MLP slice width and the granule of a scale group
are defined here and compiled in through `-D` flags (`kernels/_build.py`). What is chosen per call lives
here too. The measured sweep and its persistent cache are not ported yet.
"""

from __future__ import annotations

import torch

# Rows at or below this go to the GEMV kernel, above it to the GEMM kernel
# (`eetq_tpu/kernels/autotune.py:42`). The GEMV kernel is instantiated for
# every m in 1..MAX_DECODE_M.
MAX_DECODE_M = 8

# W8A8 / W4A8 GEMM tile with per-channel scales: output rows, output columns,
# K bytes per pipeline step (`csrc/a8_gemm.cuh` asserts it: two consumer
# warpgroups of 128 rows on wgmma m64n128k32, one 128-byte swizzled row of K
# a step; a 128-row tile where m <= 128).
W8A8_TILE = (256, 128, 128)

# Fused MLP: intermediate columns per gate/up block, the GEMV's 32-column
# strip (`csrc/gemv.cuh`), taken once over the gate and once over the up half.
FUSED_MLP_SLICE = 32

# Group-wise scales [K/g, N]: g is a multiple of this. It is the depth of two
# bf16 wgmma slices and of one int8 one, so no slice straddles two groups
# (`csrc/wgmma_gemm.cuh`, `csrc/wgmma_grouped.cuh` and `csrc/a8_gemm.cuh`
# fold a group after the slice that closes it); g = 64 and 128, the usual
# int4 settings, pass.
GROUP_GRANULE = 32

# Token-grouped expert GEMM: rows per row block, a multiple of 8 between
# these (`modules/moe.py::_grouped_bm`, `csrc/wgmma_grouped.cuh`, whose wide
# tile has 128 rows).
GROUPED_BM_MIN, GROUPED_BM_MAX = 8, 128
# Row blocks of at most this many rows run the grouped GEMM's skinny tile
# (out^T = W^T x^T, the block as wgmma's N: 8, 16 or 32), larger ones the
# 128-row tile (0: always the wide tile). Measured on Mixtral-8x7B's banks
# (`PERF.md` §6, `scripts/torch_server_ab.py --grouped-sweep`).
GROUPED_SKINNY_BM = 32

# Flash-decode: one key range ("split") per block. Enough splits that the
# grid covers every SM at least twice, and no split shorter than this.
DECODE_MIN_SPLIT_LEN = 64

# Paged flash-decode: a block walks its keys in steps of 16 (D = 128) or 32
# (D = 64) from a multiple of the step; the pool's block size and the split
# length are multiples of this, so no step straddles two pool blocks or two
# splits (`csrc/flash_decode.cu::kMaxSlots` checks both).
PAGED_KEY_STEP = 32


def compile_defines() -> tuple[str, ...]:
    """The constants above as nvcc `-D` flags."""
    bm, bn, bk = W8A8_TILE
    return (f"-DEETQ_W8A8_BM={bm}", f"-DEETQ_W8A8_BN={bn}", f"-DEETQ_W8A8_BK={bk}",
            f"-DEETQ_FUSED_MLP_SLICE={FUSED_MLP_SLICE}", f"-DEETQ_GROUP_GRANULE={GROUP_GRANULE}",
            f"-DEETQ_GROUPED_SKINNY_BM={GROUPED_SKINNY_BM}")


def group_size_of(k: int, scales: torch.Tensor) -> int:
    """The group size K / G of group-wise scales [..., G, N] for a weight of
    logical K; it must be a whole multiple of GROUP_GRANULE."""
    groups = scales.shape[-2]
    if groups < 1 or k % groups:
        raise ValueError(f"scale rows {groups} must divide K {k}")
    g = k // groups
    if g % GROUP_GRANULE:
        raise ValueError(f"group size {g} is not a multiple of {GROUP_GRANULE} "
                         "(a kernel's K step must not straddle two groups)")
    return g


def decode_splits(rows: int, max_len: int, device: torch.device,
                  step: int = 1) -> tuple[int, int]:
    """(number of splits, keys per split) for a flash-decode launch over
    `rows` = batch x kv heads blocks and a cache of `max_len` slots; the
    keys per split a multiple of `step`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ns = max(1, min(-(-2 * sms // rows), -(-max_len // DECODE_MIN_SPLIT_LEN)))
    chunk = -(-max_len // (ns * step)) * step
    return -(-max_len // chunk), chunk
