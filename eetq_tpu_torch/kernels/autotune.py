"""Launch configuration of the Hopper kernels.

Port of `eetq_tpu/kernels/autotune.py`: the decode/prefill threshold, one
rule per launch choice, and the measured sweep with its persistent
per-device cache. Most tile shapes are compile-time constants of the CUDA
sources (`csrc/*.cu`); the W8A8 tile, the fused-MLP slice width and the
granule of a scale group are defined here and compiled in through `-D`
flags (`kernels/_build.py`). What is chosen per call lives here too.

The measured autotune (`measured_autotune`, `autotune_shapes`,
`scripts/torch_autotune.py`) tunes the port's own launch choices of the
dense W8A16 / W4A16 matmul (`w8a16_matmul_kernel_call`'s two regimes; the
TPU's bm/bn/bk blocks mean nothing here): the decode GEMV's K split
(`gemv_splits` is the rule) and the per-channel GEMM's 128- or 256-row tile
(the rule: 128 where m <= 128). Winners persist per device name in a JSON
file (`EETQ_AUTOTUNE_CACHE`, default ~/.cache/eetq_tpu_torch/autotune.json).
A launch on the card looks its shape up in that file first, then, with
`EETQ_AUTOTUNE=1`, sweeps on first use, then takes the rule
(`choose_gemv_splits`, `choose_gemm_tile`, as `choose_config` does). The
fused MLP and the expert GEMV keep the rule.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
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
    need = gemv_split_floor(rows, bits, m, group_size)
    fill = GEMV_BLOCKS_PER_SM * sms // (strips * sels)
    return min(steps, max(need, min(fill, steps // GEMV_MIN_SPLIT_STEPS), 1))


def gemv_split_floor(rows: int, bits: int, m: int, group_size: int) -> int:
    """The fewest K ranges of a GEMV launch whose blocks keep their staged x
    (2m bytes a logical row) and scale rows within GEMV_SMEM_BYTES."""
    k = rows * (2 if bits == 4 else 1)
    per_row = 2 * m + (4 * GEMV_BLOCK_N / group_size if group_size else 0)
    return -(-int(k * per_row) // GEMV_SMEM_BYTES)


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


# ---- measured autotune (persistent per-device cache) ----

# The per-channel GEMM's tile rows (`csrc/wgmma_gemm.cuh::launch`): 128 or
# 256; 0 hands the choice to the rule there (128 where m <= 128). The
# group-wise tile has 256 rows only.
GEMM_TILES = (128, 256)
# A sweep times its candidates in turns, this many rounds, and keeps the
# median of each; a candidate replaces the rule only if it beats the rule's
# median by more than AUTOTUNE_MIN_GAIN (split candidates differ by a few
# percent, and a noisy choice would persist).
AUTOTUNE_ROUNDS = 5
AUTOTUNE_MIN_GAIN = 0.02
# Device time a timed run aims at (a graph of launches replayed once).
AUTOTUNE_RUN_MS = 4.0


def cache_path() -> str:
    return os.environ.get("EETQ_AUTOTUNE_CACHE", os.path.join(
        os.path.expanduser("~"), ".cache", "eetq_tpu_torch", "autotune.json"))


@functools.lru_cache(maxsize=1)
def _load_persistent() -> dict:
    try:
        with open(cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_persistent(cache: dict) -> None:
    """Write the cache atomically, then forget every lookup."""
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    clear_caches()


def clear_caches() -> None:
    """Forget the cache file's contents and every looked-up choice (after
    a sweep, or after pointing EETQ_AUTOTUNE_CACHE elsewhere)."""
    _load_persistent.cache_clear()
    choose_gemv_splits.cache_clear()
    choose_gemm_tile.cache_clear()


@functools.cache
def device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def m_bucket(m: int) -> int:
    """Shapes are cached per m bucket: m = 1 alone, 2..MAX_DECODE_M
    together, larger m by the next power of two (the JAX buckets, but m = 1
    apart: the GEMV stages 2m bytes of x a row, so its split's floor depends
    on m, where the TPU's f32 sublane made every m <= 8 cost the same)."""
    if m == 1:
        return 1
    if m <= MAX_DECODE_M:
        return MAX_DECODE_M
    return 1 << (m - 1).bit_length()


def tune_key(device: str, m: int, rows: int, np_: int, bits: int, group: int) -> str:
    """`{device}|b{bits}|m{bucket}|k{rows}|n{np}|g{group}`: rows the packed
    weight's data rows (Kp, or Kp / 2 for int4, as the JAX key's packed
    Kp), group the scale group's logical rows (0: per-channel)."""
    return f"{device}|b{bits}|m{m_bucket(m)}|k{rows}|n{np_}|g{group}"


def gemv_candidates(rows: int, np_: int, bits: int, m: int, group: int, sms: int) -> tuple:
    """K splits a sweep of the dense GEMV times: the rule's, a few multiples
    of it, and those that fill 1 to 4 blocks an SM; none below the shared
    memory floor at this m, none above the K steps."""
    strips = np_ // GEMV_BLOCK_N
    rule = gemv_splits(rows, strips, 1, bits, m, group, sms)
    lo = max(gemv_split_floor(rows, bits, m, group), 1)
    steps = rows // GEMV_STEP_ROWS
    raw = {rule, rule // 2, 2 * rule // 3, 3 * rule // 2, 2 * rule,
           *(f * sms // strips for f in (1, 2, 3, 4))}
    return tuple(sorted(c for c in raw if lo <= c <= steps))


def gemm_candidates(group: int) -> tuple:
    return (256,) if group else GEMM_TILES


def _rule(m: int, rows: int, np_: int, bits: int, group: int, sms: int) -> int:
    if m <= MAX_DECODE_M:
        return gemv_splits(rows, np_ // GEMV_BLOCK_N, 1, bits, m, group, sms)
    return 128 if m <= 128 and not group else 256


def _tuned(index: int, m: int, rows: int, np_: int, bits: int, group: int, what: str):
    """The cache's choice for the shape, sweeping on a miss under
    EETQ_AUTOTUNE=1; None where there is none."""
    got = _load_persistent().get(tune_key(device_name(index), m, rows, np_, bits, group))
    if got is not None:
        return got.get(what)
    if os.environ.get("EETQ_AUTOTUNE") != "1":
        return None
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"EETQ_AUTOTUNE=1 would sweep m={m} rows={rows} n={np_} int{bits} g={group} "
            "inside a CUDA graph capture: tune first (autotune_shapes, or "
            "scripts/torch_autotune.py), or run the step once before capturing it")
    return measured_autotune(m, rows, np_, bits, group, device=torch.device("cuda", index)).choice


@functools.lru_cache(maxsize=4096)  # called once per GEMV launch, on the host's decode path
def choose_gemv_splits(index: int, rows: int, np_: int, bits: int, m: int, group: int) -> int:
    """The dense GEMV's K split on CUDA device `index`: the cache's, if it
    lies within this m's floor and the K steps, else the rule's."""
    tuned = _tuned(index, m, rows, np_, bits, group, "splits")
    steps = rows // GEMV_STEP_ROWS
    if tuned is not None and max(gemv_split_floor(rows, bits, m, group), 1) <= tuned <= steps:
        return int(tuned)
    return gemv_splits(rows, np_ // GEMV_BLOCK_N, 1, bits, m, group, sm_count(index))


@functools.lru_cache(maxsize=4096)
def choose_gemm_tile(index: int, m: int, rows: int, np_: int, bits: int, group: int) -> int:
    """The dense GEMM's tile rows on CUDA device `index`: the cache's (128
    or 256, per-channel scales only), else 0, the rule in the kernel."""
    if group:
        return 0
    tuned = _tuned(index, m, rows, np_, bits, group, "tile_m")
    return int(tuned) if tuned in GEMM_TILES else 0


@dataclasses.dataclass
class Tuned:
    """One sweep: its key and shape (m, rows, np_, bits, group), what it
    chose ("splits" or "tile_m"), the choice and the rule's, and the median
    ms of every candidate."""

    key: str
    shape: tuple
    what: str
    choice: int
    rule: int
    ms: dict

    @property
    def gain(self) -> float:
        """The rule's time over the choice's, less one."""
        return self.ms[self.rule] / self.ms[self.choice] - 1.0


def _problem(m: int, rows: int, np_: int, bits: int, group: int, device, seed: int = 0):
    """x [m, K] and enough distinct (weight, scales) copies of a packed
    [rows, np_] weight to total `utils/profiling.py::ROTATE_BYTES`, from a
    seeded generator on `device`: llama2-7b's o_proj (16.8 MB) and down (45
    MB) fit the H100's 50 MB L2, where launches back to back on one weight
    would read L2 and not the HBM a decode step reads (the JAX sweep's stack
    of distinct weights, `eetq_tpu/kernels/autotune.py:299-320`)."""
    from eetq_tpu_torch.utils.profiling import ROTATE_BYTES

    k = rows * (2 if bits == 4 else 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    copies = max(2, -(-ROTATE_BYTES // (rows * np_)))
    srows = (np_,) if not group else (k // group, np_)
    weights = [(torch.randint(-128, 128, (rows, np_), generator=gen, device=device,
                              dtype=torch.int8),
                torch.rand(srows, generator=gen, device=device) * 2e-3 + 1e-4)
               for _ in range(copies)]
    return x, weights


def time_candidates(m: int, rows: int, np_: int, bits: int, group: int, candidates,
                    rounds: int = AUTOTUNE_ROUNDS, iters: int | None = None,
                    device=None) -> dict:
    """{candidate: median ms a call} of the dense GEMV at each K split (m <=
    MAX_DECODE_M) or the GEMM at each tile (m > MAX_DECODE_M), timed in
    turns by `utils/profiling.py::device_time`, each run rotating over
    distinct weight copies (`_problem`)."""
    from eetq_tpu_torch.kernels.w8a16 import w4a16_gemm, w4a16_gemv, w8a16_gemm, w8a16_gemv
    from eetq_tpu_torch.utils.device import resolve
    from eetq_tpu_torch.utils.profiling import device_time

    device = resolve(device)
    if device.type != "cuda":
        raise ValueError("a sweep times the kernels on a CUDA device")
    x, weights = _problem(m, rows, np_, bits, group, device)
    decode = m <= MAX_DECODE_M
    kern = ((w4a16_gemv if bits == 4 else w8a16_gemv) if decode
            else (w4a16_gemm if bits == 4 else w8a16_gemm))
    arg = "splits" if decode else "tile_m"

    def run(c):
        turn = iter(range(1 << 62))

        def fn():
            w, s = weights[next(turn) % len(weights)]
            return kern(x, w, s, np_, **{arg: c})
        return fn

    if iters is None:  # enough launches for AUTOTUNE_RUN_MS of device work
        one = device_time(run(candidates[0]), iters=len(weights), reps=1, device=device)
        iters = max(len(weights), min(2000, int(AUTOTUNE_RUN_MS / max(1e3 * one, 1e-3))))
    times = {c: [] for c in candidates}
    for _ in range(rounds):
        for c in candidates:
            times[c].append(1e3 * device_time(run(c), iters=iters, reps=1, device=device))
    return {c: statistics.median(t) for c, t in times.items()}


def measured_autotune(m: int, kp: int, np_: int, bits: int = 8, group: int = 0,
                      iters: int | None = None, save: bool = True, verbose: bool = False,
                      device=None) -> Tuned:
    """Sweep the launch choice of the dense matmul at (m, kp, np_) on the
    card (kp the packed weight's data rows, np_ its padded columns, group
    the scale group's logical rows, 0 per-channel) and persist the winner in
    the per-device cache. The rule's choice stays unless a candidate beats
    it by more than AUTOTUNE_MIN_GAIN. A sweep that fails raises."""
    from eetq_tpu_torch.utils.device import resolve

    device = resolve(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = sm_count(index)
    decode = m <= MAX_DECODE_M
    what = "splits" if decode else "tile_m"
    cands = (gemv_candidates(kp, np_, bits, m, group, sms) if decode
             else gemm_candidates(group))
    rule = _rule(m, kp, np_, bits, group, sms)
    key = tune_key(device_name(index), m, kp, np_, bits, group)
    ms = (time_candidates(m, kp, np_, bits, group, cands, iters=iters, device=device)
          if len(cands) > 1 else {rule: float("nan")})
    best = min(ms, key=ms.get)
    if best != rule and not ms[best] < (1.0 - AUTOTUNE_MIN_GAIN) * ms[rule]:
        best = rule
    if verbose:
        for c, t in ms.items():
            mark = " (rule)" if c == rule else ""
            print(f"    {what}={c}{mark}: {t:.4f} ms")
    if save:
        cache = dict(_load_persistent())
        cache[key] = {what: best}
        _save_persistent(cache)
    return Tuned(key, (m, kp, np_, bits, group), what, best, rule, ms)


def autotune_shapes(shapes: list[tuple[int, int, int]] | None = None, cfg=None, bits: int = 8,
                    batch: int = 1, group: int = 0, verbose: bool = True,
                    device=None) -> dict:
    """Tune a list of (m, k_logical, n) shapes, or every projection of a
    ModelConfig (qkv, o_proj, gate|up, down) at m = batch (the GEMV) and m =
    1024 (the GEMM), persisting the winners (`eetq_tpu/kernels/autotune.py::
    autotune_shapes`). Returns {key: Tuned}."""
    from eetq_tpu_torch.layout.tiling import padded

    if shapes is None:
        if cfg is None:
            raise ValueError("pass shapes or a ModelConfig")
        h, i = cfg.hidden_size, cfg.intermediate_size
        proj = [(h, cfg.qkv_out), (cfg.num_heads * cfg.head_dim, h), (h, 2 * i), (i, h)]
        shapes = [(batch, k, n) for k, n in proj] + [(1024, k, n) for k, n in proj]
    tuned = {}
    for m, k, n in shapes:
        rows = padded(k) // (2 if bits == 4 else 1)
        if verbose:
            print(f"  tuning m={m} k={k} n={n} (int{bits}, g={group})")
        t = measured_autotune(m, rows, padded(n), bits, group, verbose=verbose, device=device)
        tuned[t.key] = t
        if verbose:
            print(f"    -> {t.what}={t.choice} ({t.ms[t.choice]:.4f} ms; the rule's "
                  f"{t.what}={t.rule}: {t.ms[t.rule]:.4f} ms)")
    return tuned
