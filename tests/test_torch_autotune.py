"""The port's measured-autotune cache (`kernels/autotune.py`), the
counterpart of `tests/test_autotune.py`: the persistent file's round trip,
the cache overriding the rule, the sweep's candidates within the GEMV's
shared-memory floor and K steps, the m buckets (m = 1 apart from 2..8) and
the key's format, and that a CPU call never reads the cache. The sweep
itself times kernels on the card (`tests/test_torch_gpu.py`)."""

import json
import os

import pytest
import torch

from eetq_tpu_torch.kernels import autotune
from eetq_tpu_torch.kernels.autotune import (
    GEMV_BLOCK_N,
    GEMV_STEP_ROWS,
    MAX_DECODE_M,
    choose_gemm_tile,
    choose_gemv_splits,
    gemv_candidates,
    gemv_split_floor,
    gemv_splits,
    m_bucket,
    tune_key,
)
from eetq_tpu_torch.kernels.w8a16 import w8a16_gemm, w8a16_gemv, w8a16_matmul_ref
from eetq_tpu_torch.layout.tiling import pack_weights

H100_SMS = 132
CARD = "NVIDIA H100 80GB HBM3"
# llama2-7b's four projections as packed (rows, np_): qkv, o_proj, gate|up, down
LLAMA = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Each test on its own cache file, a named card of 132 SMs, no sweep."""
    monkeypatch.setenv("EETQ_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("EETQ_AUTOTUNE", raising=False)
    monkeypatch.setattr(autotune, "device_name", lambda index: CARD)
    monkeypatch.setattr(autotune, "sm_count", lambda index: H100_SMS)
    autotune.clear_caches()
    yield
    autotune.clear_caches()


def test_persistent_cache_file_roundtrip():
    autotune._save_persistent({"k": {"splits": 3}})
    with open(os.environ["EETQ_AUTOTUNE_CACHE"]) as f:
        assert json.load(f) == {"k": {"splits": 3}}
    autotune._load_persistent.cache_clear()
    assert autotune._load_persistent() == {"k": {"splits": 3}}
    assert not os.path.exists(os.environ["EETQ_AUTOTUNE_CACHE"] + ".tmp")


def test_cache_path_default():
    os.environ.pop("EETQ_AUTOTUNE_CACHE")
    assert autotune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "eetq_tpu_torch", "autotune.json")


@pytest.mark.parametrize("rows,np_", LLAMA)
def test_persistent_cache_overrides_the_rule(rows, np_):
    rule = choose_gemv_splits(0, rows, np_, 8, 1, 0)
    assert rule == gemv_splits(rows, np_ // GEMV_BLOCK_N, 1, 8, 1, 0, H100_SMS)
    assert choose_gemm_tile(0, 512, rows, np_, 8, 0) == 0  # the kernel's rule
    tuned = rule + 1
    autotune._save_persistent({tune_key(CARD, 1, rows, np_, 8, 0): {"splits": tuned},
                               tune_key(CARD, 512, rows, np_, 8, 0): {"tile_m": 128}})
    assert choose_gemv_splits(0, rows, np_, 8, 1, 0) == tuned
    assert choose_gemm_tile(0, 512, rows, np_, 8, 0) == 128
    # other shapes, m buckets, bit widths, groups and cards keep the rule
    assert choose_gemv_splits(0, rows, np_, 8, 2, 0) == gemv_splits(
        rows, np_ // GEMV_BLOCK_N, 1, 8, 2, 0, H100_SMS)
    assert choose_gemv_splits(0, rows, np_, 4, 1, 0) == gemv_splits(
        rows, np_ // GEMV_BLOCK_N, 1, 4, 1, 0, H100_SMS)
    assert choose_gemm_tile(0, 1024, rows, np_, 8, 0) == 0
    assert choose_gemm_tile(0, 512, rows, np_, 8, 128) == 0  # group-wise: one tile
    autotune.device_name = lambda index: "another card"
    autotune.clear_caches()
    assert choose_gemv_splits(0, rows, np_, 8, 1, 0) == rule


def test_a_cached_split_outside_the_floor_or_the_steps_is_never_launched():
    """A split tuned at m = 2 that is below the floor at m = 8 (its bucket
    shares the key) and a split past the K steps fall back to the rule."""
    rows, np_, group = 11008, 4096, 128
    lo2, lo8 = gemv_split_floor(rows, 8, 2, group), gemv_split_floor(rows, 8, 8, group)
    assert lo2 < lo8
    autotune._save_persistent({tune_key(CARD, 2, rows, np_, 8, group): {"splits": lo2}})
    assert choose_gemv_splits(0, rows, np_, 8, 2, group) == lo2
    assert choose_gemv_splits(0, rows, np_, 8, 8, group) == gemv_splits(
        rows, np_ // GEMV_BLOCK_N, 1, 8, 8, group, H100_SMS)
    autotune._save_persistent({tune_key(CARD, 1, rows, np_, 8, 0): {"splits": rows}})
    assert choose_gemv_splits(0, rows, np_, 8, 1, 0) == gemv_splits(
        rows, np_ // GEMV_BLOCK_N, 1, 8, 1, 0, H100_SMS)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n,group", [
    (4096, 12288, 0), (4096, 4096, 0), (4096, 22016, 0), (11008, 4096, 0), (1000, 300, 0),
    (4096, 4096, 128), (11008, 4096, 128), (4096, 4096, 2048), (11008, 4096, 5504),
    (11008, 4096, 1376), (4096, 4096, 512)])
def test_candidates_within_the_floor_and_the_steps(k, n, group, m, bits):
    rows = -(-k // 128) * 128 // (2 if bits == 4 else 1)
    np_ = -(-n // 128) * 128
    cands = gemv_candidates(rows, np_, bits, m, group, H100_SMS)
    rule = gemv_splits(rows, np_ // GEMV_BLOCK_N, 1, bits, m, group, H100_SMS)
    assert rule in cands and len(cands) <= 9 and list(cands) == sorted(set(cands))
    lo = max(gemv_split_floor(rows, bits, m, group), 1)
    assert all(lo <= c <= rows // GEMV_STEP_ROWS for c in cands)
    assert autotune.gemm_candidates(group) == ((256,) if group else (128, 256))


def test_m_buckets_share_with_m1_apart():
    assert m_bucket(1) == 1
    assert {m_bucket(m) for m in range(2, MAX_DECODE_M + 1)} == {MAX_DECODE_M}
    assert [m_bucket(m) for m in (9, 16, 17, 200, 256, 257, 1024)] == [16, 16, 32, 256, 256,
                                                                       512, 1024]
    rows, np_ = LLAMA[1]
    autotune._save_persistent({tune_key(CARD, 8, rows, np_, 8, 0): {"splits": 4},
                               tune_key(CARD, 300, rows, np_, 8, 0): {"tile_m": 128}})
    assert all(choose_gemv_splits(0, rows, np_, 8, m, 0) == 4 for m in range(2, 9))
    assert choose_gemv_splits(0, rows, np_, 8, 1, 0) != 4 or gemv_splits(
        rows, np_ // GEMV_BLOCK_N, 1, 8, 1, 0, H100_SMS) == 4
    assert [choose_gemm_tile(0, m, rows, np_, 8, 0) for m in (257, 512, 513)] == [128, 128, 0]


def test_key_format():
    assert tune_key(CARD, 1, 4096, 12288, 8, 0) == f"{CARD}|b8|m1|k4096|n12288|g0"
    assert tune_key(CARD, 5, 5504, 4096, 4, 128) == f"{CARD}|b4|m8|k5504|n4096|g128"
    assert tune_key(CARD, 1000, 4096, 4096, 8, 2048) == f"{CARD}|b8|m1024|k4096|n4096|g2048"


def test_a_cpu_call_never_reads_the_cache(monkeypatch):
    """The wrappers take their plain versions on the CPU before any lookup:
    a cache that cannot be read does not matter there."""
    def unreadable():
        raise AssertionError("the cache was read")

    unreadable.cache_clear = lambda: None
    monkeypatch.setattr(autotune, "_load_persistent", unreadable)
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (256, 128), generator=g, dtype=torch.int8)
    s = torch.rand(128, generator=g) * 1e-2
    data = pack_weights(q).data
    for m, kern in ((1, w8a16_gemv), (40, w8a16_gemm)):
        x = torch.randn(m, 256, generator=g).to(torch.bfloat16)
        assert torch.equal(kern(x, data, s, 128), w8a16_matmul_ref(x, q, s))


def test_a_sweep_on_first_use_refuses_a_capture(monkeypatch):
    """Under EETQ_AUTOTUNE=1 a miss sweeps, but never inside a graph
    capture: it raises and names autotune_shapes."""
    monkeypatch.setenv("EETQ_AUTOTUNE", "1")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="autotune_shapes"):
        choose_gemv_splits(0, 4096, 4096, 8, 1, 0)
    swept = []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(autotune, "measured_autotune", lambda *a, **k: swept.append(a) or
                        autotune.Tuned("k", a[:5], "splits", 5, 8, {}))
    assert choose_gemv_splits(0, 4096, 4096, 8, 1, 0) == 5 and swept == [(1, 4096, 4096, 8, 0)]


def test_a_sweep_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        autotune.time_candidates(1, 256, 128, 8, 0, (1,), device="cpu")
