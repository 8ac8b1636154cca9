"""The flash-decode's launch plan (`kernels/autotune.py::decode_plan`): the
chunk and the count of chunks the wrappers launch, and the scratch the
chunks' merge needs. A pure function of the shapes, so it runs on the
CPU. The kernel's own walk of keys, tiles and live chunks is checked on the
card (`tests/test_torch_gpu.py`)."""

import inspect
import itertools

import pytest

from eetq_tpu_torch.kernels import autotune
from eetq_tpu_torch.kernels.autotune import (
    DECODE_CHUNK,
    DECODE_MAX_CHUNK,
    DECODE_MAX_CHUNKS,
    DECODE_TILE,
    decode_plan,
)

D = 128
BATCHES = [1, 4, 8]
KV_HEADS = [8, 32]
CAPACITIES = [1152, 2048]
BLOCK_SIZES = [128, 256, 384]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("hkv", KV_HEADS)
@pytest.mark.parametrize("cap", CAPACITIES)
def test_every_live_key_falls_in_exactly_one_chunk(b, hkv, cap):
    """Chunk c covers keys [c * chunk, (c + 1) * chunk): the grid's chunks
    cover the capacity, and the last one starts inside it."""
    plan = decode_plan(b, hkv, 32 // hkv, cap, D)
    assert plan.chunks * plan.chunk >= cap > (plan.chunks - 1) * plan.chunk
    assert all(k // plan.chunk < plan.chunks for k in (0, cap // 2, cap - 1))


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("hkv", KV_HEADS)
@pytest.mark.parametrize("cap", CAPACITIES)
def test_boundaries_do_not_change_with_the_lengths(b, hkv, cap):
    """The plan takes no lengths, and its boundaries are whole tiles: a row
    cut at length n is staged in the same tiles as the same row cut at
    n + 1 (what S > 1 verify against S sequential calls relies on)."""
    assert list(inspect.signature(decode_plan).parameters) == [
        "b", "hkv", "group", "max_len", "d"]
    plan = decode_plan(b, hkv, 32 // hkv, cap, D)
    assert plan.chunk % DECODE_TILE == 0 and DECODE_TILE <= plan.chunk <= DECODE_MAX_CHUNK
    assert decode_plan(b, hkv, 32 // hkv, cap, D) == plan


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("hkv", KV_HEADS)
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_a_tile_never_straddles_a_pool_block(b, hkv, bs):
    cap = (2048 // bs) * bs  # a table of whole blocks
    plan = decode_plan(b, hkv, 32 // hkv, cap, D)
    for c in range(plan.chunks):
        for start in range(c * plan.chunk, min(cap, (c + 1) * plan.chunk), DECODE_TILE):
            assert start // bs == (start + DECODE_TILE - 1) // bs


@pytest.mark.parametrize("b,hkv,group,cap,d", itertools.product(
    BATCHES, KV_HEADS, [1, 4], CAPACITIES + [128, 64], [64, 128]))
def test_scratch_covers_the_grid(b, hkv, group, cap, d):
    """(max, sum) and D outputs per (row, kv head, chunk, q head) of the grid
    (chunks, Hkv, B), and a counter per (row, kv head); none with one chunk."""
    plan = decode_plan(b, hkv, group, cap, d)
    if plan.chunks == 1:
        assert (plan.floats, plan.counters) == (0, 0)
    else:
        assert plan.floats >= b * hkv * plan.chunks * group * (d + 2)
        assert plan.counters >= b * hkv


@pytest.mark.parametrize("b,hkv,cap", [
    (1, 32, 1152), (1, 8, 1152), (2, 8, 1152), (4, 32, 160), (4, 8, 160),
    (8, 32, 2048), (8, 8, 2048), (1, 8, 2048)])
def test_the_chunk_is_fixed_below_the_merge_limit(b, hkv, cap):
    """DECODE_CHUNK keys whatever the grid: shorter chunks where the grid
    leaves SMs idle measured no faster (`PERF.md` §6)."""
    plan = decode_plan(b, hkv, 1, cap, D)
    assert plan.chunk == DECODE_CHUNK and plan.chunks == -(-cap // DECODE_CHUNK)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("cap,want", [
    (DECODE_MAX_CHUNKS * DECODE_CHUNK, DECODE_CHUNK),
    (DECODE_MAX_CHUNKS * DECODE_CHUNK + 1, DECODE_CHUNK + DECODE_TILE),
    (DECODE_MAX_CHUNKS * 2 * DECODE_CHUNK, 2 * DECODE_CHUNK),
    (DECODE_MAX_CHUNKS * DECODE_MAX_CHUNK, DECODE_MAX_CHUNK)])
def test_a_long_cache_lengthens_the_chunk(b, cap, want):
    """Past DECODE_MAX_CHUNKS chunks a row (what the kernel's merge holds) the
    chunk grows by whole tiles, up to DECODE_MAX_CHUNK."""
    plan = decode_plan(b, 32, 1, cap, D)
    assert plan.chunk == want and plan.chunks <= DECODE_MAX_CHUNKS


@pytest.mark.parametrize("args", [(0, 8, 1, 2048, 128), (1, 0, 1, 2048, 128),
                                  (1, 8, 0, 2048, 128), (1, 8, 1, 0, 128),
                                  (1, 8, 1, DECODE_MAX_CHUNKS * DECODE_MAX_CHUNK + 1, 128)])
def test_bad_launches_raise(args):
    with pytest.raises(ValueError):
        decode_plan(*args)


def test_the_kernel_is_compiled_with_the_plan_units():
    defines = autotune.compile_defines()
    assert f"-DEETQ_DECODE_TILE={DECODE_TILE}" in defines
    assert f"-DEETQ_DECODE_MAX_CHUNK={DECODE_MAX_CHUNK}" in defines
    assert f"-DEETQ_DECODE_MAX_CHUNKS={DECODE_MAX_CHUNKS}" in defines
    assert 128 % DECODE_TILE == 0 and DECODE_CHUNK % DECODE_TILE == 0
    assert DECODE_MAX_CHUNK % DECODE_TILE == 0 and DECODE_CHUNK <= DECODE_MAX_CHUNK


@pytest.mark.parametrize("b,hkv,group", [(1, 32, 1), (8, 8, 4), (4, 8, 8)])
@pytest.mark.parametrize("s", [2, 3, 8])
@pytest.mark.parametrize("cap", CAPACITIES)
def test_query_tokens_widen_only_the_scratch(b, hkv, group, s, cap):
    """An S-token verify plans G * S query rows a kv head: the chunks are
    those of the S = 1 call (so S sequential S = 1 calls cut the cache as
    one S-token call does) and the scratch holds a state for every row."""
    one, many = decode_plan(b, hkv, group, cap, D), decode_plan(b, hkv, group * s, cap, D)
    assert (many.chunk, many.chunks, many.counters) == (one.chunk, one.chunks, one.counters)
    assert many.floats == s * one.floats


@pytest.mark.parametrize("b,hkv,group,s,d", [
    (1, 2, 16, 8, 128), (1, 4, 8, 9, 128), (8, 2, 16, 5, 64), (1, 1, 16, 4, 256),
    (4, 1, 8, 8, 256)])
@pytest.mark.parametrize("cap", CAPACITIES)
def test_rows_past_one_block_take_a_counter_per_row_block(b, hkv, group, s, d, cap):
    """More query rows a kv head than one block takes (`max_query_rows(d)`:
    64, or 32 at d = 256) run as row blocks, each with a ticket counter of
    its own per (row, kv head): chatglm3-6b's 128 rows at S = 8 are two row
    blocks. The chunks stay those of the S = 1 call, the scratch a state for
    every row."""
    one, many = decode_plan(b, hkv, group, cap, d), decode_plan(b, hkv, group * s, cap, d)
    blocks = -(-group * s // autotune.max_query_rows(d))
    assert blocks > 1
    assert (many.chunk, many.chunks) == (one.chunk, one.chunks)
    assert many.counters == blocks * one.counters == b * hkv * blocks
    assert many.floats == s * one.floats
