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
from typing import NamedTuple

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

# Flash-decode (`csrc/flash_decode.cu`): block (c, head, row) takes chunk c
# of a row's keys, keys [c * chunk, (c + 1) * chunk), in tiles of
# DECODE_TILE keys staged through shared memory. The tile divides 128, and
# pool blocks are multiples of 128 keys, so a tile never straddles two of
# them. The chunk is DECODE_CHUNK keys, longer (by whole tiles, up to
# DECODE_MAX_CHUNK) where the cache would need more than DECODE_MAX_CHUNKS
# chunks a row (the last block of a row keeps a weight and a sum of every
# chunk in shared memory). Measured on an H100 by `scripts/torch_server_ab.py
# --decode-sweep` (`PERF.md` §6): shorter chunks where the grid leaves SMs
# idle were no faster at b=1 and up to 42% slower at b=4.
DECODE_TILE = 64
DECODE_CHUNK = 256
DECODE_MAX_CHUNK = 1024
DECODE_MAX_CHUNKS = 480
# GQA groups whose decode step (one query token a row) is compiled apart
# (G a constant, one length for every row: no per-row masks); any other
# group runs the multi-query body, which takes any G * S query rows a kv
# head in row blocks of `max_query_rows(D)`. Groups 7
# (qwen2-7b) and 16 (chatglm3-6b) were timed both ways on an H100
# (`scripts/torch_server_ab.py --kernels-of DIR --decode-only --families`,
# DIR a copy with this tuple cut to 1, 2, 4, 8; `PERF.md` §6).
DECODE_STEP_GROUPS = (1, 2, 4, 7, 8, 16)


def compile_defines() -> tuple[str, ...]:
    """The constants above as nvcc `-D` flags."""
    bm, bn, bk = W8A8_TILE
    return (f"-DEETQ_W8A8_BM={bm}", f"-DEETQ_W8A8_BN={bn}", f"-DEETQ_W8A8_BK={bk}",
            f"-DEETQ_FUSED_MLP_SLICE={FUSED_MLP_SLICE}", f"-DEETQ_GROUP_GRANULE={GROUP_GRANULE}",
            f"-DEETQ_GROUPED_SKINNY_BM={GROUPED_SKINNY_BM}",
            f"-DEETQ_GEMV_BLOCK_N={GEMV_BLOCK_N}", f"-DEETQ_GEMV_STEP_ROWS={GEMV_STEP_ROWS}",
            f"-DEETQ_DECODE_TILE={DECODE_TILE}", f"-DEETQ_DECODE_MAX_CHUNK={DECODE_MAX_CHUNK}",
            f"-DEETQ_DECODE_MAX_CHUNKS={DECODE_MAX_CHUNKS}",
            f"-DEETQ_DECODE_STEP_GROUPS={sum(1 << g for g in DECODE_STEP_GROUPS)}u")


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


# A flash-decode block holds the softmax states of its query rows (q heads
# of the group times tokens) for each of its key warps in shared memory at
# the end: 4 (D + 2) bytes a row and warp. A block takes the most rows, 64 or
# 32, whose states fit the 227 KB a block may have (`csrc/flash_decode.cuh`
# computes the same, kMaxRowsOf); a launch of more cuts them into row blocks.
DECODE_ROW_STEPS = (64, 32)
DECODE_SMEM_BYTES = 227 * 1024


def max_query_rows(d: int) -> int:
    """Query rows of a kv head one flash-decode block takes at head dim d
    (a row block): 64 at d = 64 and 128, 32 at d = 256."""
    warps = DECODE_TILE // 16
    return next((r for r in DECODE_ROW_STEPS if 4 * warps * r * (d + 2) <= DECODE_SMEM_BYTES), 0)


class DecodePlan(NamedTuple):
    """The launch of one flash-decode call: grid (chunks, Hkv x row blocks, B)."""

    chunk: int  # keys of a chunk: chunk c covers keys [c * chunk, (c + 1) * chunk)
    chunks: int  # chunks of the cache's capacity
    floats: int  # f32 scratch: [B, Hkv, chunks, G, D] outputs, [B, Hkv, chunks, G, 2] (max, sum)
    # (G: the query rows of a kv head, its q heads times the query tokens)
    counters: int  # int32 scratch: one ticket counter per (row, kv head, row block)


@functools.lru_cache(maxsize=4096)  # called once per flash-decode launch, on the host's decode path
def decode_plan(b: int, hkv: int, group: int, max_len: int, d: int) -> DecodePlan:
    """The plan of a flash-decode launch over B rows, Hkv kv heads of
    `group` query rows each (q heads times query tokens: S > 1 rows of a
    verify widen the scratch, and past one row block of `max_query_rows(d)`
    add a counter per row block) and head dim d, on a cache of `max_len`
    keys a row (dense L, or max_blocks * BS). The lengths and the query rows
    play no part in the chunks: those of a cache are the same at any length,
    so S sequential S = 1 calls cut it as one S-token call does."""
    if min(b, hkv, group, max_len, d) < 1:
        raise ValueError(f"no flash-decode over B={b} Hkv={hkv} G={group} L={max_len} D={d}")
    if max_len > DECODE_MAX_CHUNK * DECODE_MAX_CHUNKS:
        raise ValueError(f"a cache of {max_len} keys a row is more than the flash-decode's "
                         f"{DECODE_MAX_CHUNKS} chunks of {DECODE_MAX_CHUNK}")
    chunk = DECODE_CHUNK
    while -(-max_len // chunk) > DECODE_MAX_CHUNKS:
        chunk += DECODE_TILE
    chunks = -(-max_len // chunk)
    if chunks == 1:
        return DecodePlan(chunk, 1, 0, 0)
    row_blocks = -(-group // max_query_rows(d))
    return DecodePlan(chunk, chunks, b * hkv * chunks * group * (d + 2), b * hkv * row_blocks)
