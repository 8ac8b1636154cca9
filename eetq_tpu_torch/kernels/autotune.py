"""Launch configuration of the Hopper kernels.

Port of the part of `eetq_tpu/kernels/autotune.py` the ported paths need:
the decode/prefill threshold and one fixed launch shape per regime. Most
tile shapes are compile-time constants of the CUDA sources (`csrc/*.cu`);
the W8A8 tile, the fused-MLP slice width and the granule of a scale group
are defined here and compiled in through `-D` flags (`kernels/_build.py`). What is chosen per call lives
here too. The measured sweep and its persistent cache are not ported yet.
"""

from __future__ import annotations

import functools

import torch

# Rows at or below this go to the GEMV kernel, above it to the GEMM kernel
# (`eetq_tpu/kernels/autotune.py:42`). The GEMV kernel's tensor-core product
# takes the rows of x as the MMA's N = 8, so one body serves every m here.
MAX_DECODE_M = 8

# W8A8 / W4A8 GEMM tile with per-channel scales: output rows, output columns,
# K bytes per pipeline step (`csrc/a8_gemm.cuh` asserts it: two consumer
# warpgroups of 128 rows on wgmma m64n128k32, one 128-byte swizzled row of K
# a step; a 128-row tile where m <= 128).
W8A8_TILE = (256, 128, 128)

# Decode GEMV (`csrc/gemv.cuh`): a block of 8 warps takes 128 weight
# columns and its K range in steps of 16 weight rows (each warp a step in
# turn). K is split across blocks where the column strips alone leave the
# card short of blocks (`gemv_splits`).
GEMV_BLOCK_N = 128
GEMV_STEP_ROWS = 16
GEMV_WARPS = 8
# Blocks an SM holds (the kernel's `__launch_bounds__` minimum): the split
# fills this many blocks per SM and no more, since a block left over for a
# second wave runs with the card's bandwidth mostly idle.
GEMV_BLOCKS_PER_SM = 2
# No K range shorter than two steps a warp.
GEMV_MIN_SPLIT_STEPS = 2 * GEMV_WARPS
# Shared memory a block may take for its staged x and scale rows, so that
# two blocks share an SM (227 KB).
GEMV_SMEM_BYTES = 96 * 1024

# Fused MLP: intermediate columns per gate/up block: the GEMV block's 128
# weight columns are 64 of the gate half and the matching 64 of the up half,
# taken in one K loop (`csrc/gemv.cuh`).
FUSED_MLP_SLICE = GEMV_BLOCK_N // 2

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
            f"-DEETQ_GROUPED_SKINNY_BM={GROUPED_SKINNY_BM}",
            f"-DEETQ_GEMV_BLOCK_N={GEMV_BLOCK_N}", f"-DEETQ_GEMV_STEP_ROWS={GEMV_STEP_ROWS}")


@functools.lru_cache(maxsize=4096)  # called once per GEMV launch, on the host's decode path
def gemv_splits(rows: int, strips: int, sels: int, bits: int, m: int, group_size: int,
                sms: int) -> int:
    """K ranges of one decode GEMV launch over `rows` weight rows (Kp, or
    Kp / 2 for int4), `strips` column strips of GEMV_BLOCK_N and `sels`
    expert selections, for m rows of x and scale groups of `group_size`
    logical rows (0: per-channel), on a card of `sms` SMs.

    As many ranges as fill GEMV_BLOCKS_PER_SM blocks on every SM (never a
    second wave), none shorter than GEMV_MIN_SPLIT_STEPS steps; but at least
    as many as keep a block's staged x (2m bytes a logical row) and scale
    rows (512 / group_size bytes a logical row) within GEMV_SMEM_BYTES."""
    steps = rows // GEMV_STEP_ROWS
    if (steps < 1 or rows % GEMV_STEP_ROWS or strips < 1 or sels < 1
            or not 1 <= m <= MAX_DECODE_M):
        raise ValueError(f"no GEMV over {rows} rows, {strips} strips, {sels} selections, m={m}")
    k = rows * (2 if bits == 4 else 1)
    per_row = 2 * m + (4 * GEMV_BLOCK_N / group_size if group_size else 0)
    need = -(-int(k * per_row) // GEMV_SMEM_BYTES)
    fill = GEMV_BLOCKS_PER_SM * sms // (strips * sels)
    return min(steps, max(need, min(fill, steps // GEMV_MIN_SPLIT_STEPS), 1))


def gemv_scratch_size(splits: int, strips: int, sels: int) -> tuple[int, int]:
    """(f32 partials, int32 counters) of one GEMV launch's K split: a
    [MAX_DECODE_M, GEMV_BLOCK_N] partial per block, a counter per strip and
    selection; none without a split."""
    if splits == 1:
        return 0, 0
    return sels * splits * strips * MAX_DECODE_M * GEMV_BLOCK_N, sels * strips


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
