"""The device timeline: busy time is the union of the operations'
intervals, an idle share is taken inside the spans, and kernel names map to
their classes."""

import pytest

from servebench import trace


def test_union_idle_and_breakdown():
    ops = [("a", 0, 10), ("b", 5, 15), ("c", 30, 40), ("d", 100, 110)]
    tl = trace.Timeline(ops)
    assert trace.union(ops, 0, 50) == [(0, 15), (30, 40)]
    assert tl.busy_ns(0, 50) == 25
    assert tl.busy_ns(8, 35) == 12  # clipped to the window
    assert tl.idle_share([(0, 20), (30, 50)]) == pytest.approx(1 - 25 / 40)
    assert tl.idle_share([]) is None
    assert [op[0] for op in tl.started(5, 31)] == ["b", "c"]
    bd = tl.breakdown(0, 120, [("decode", 0, 50), ("admission", 50, 120)])
    assert bd["device_ops"][0][1] == pytest.approx(10e-9)
    assert bd["idle_gaps"][0] == ["admission", pytest.approx(60e-9)]
    assert ["decode", pytest.approx(15e-9)] in bd["idle_gaps"]


@pytest.mark.parametrize("name, cls, short", [
    ("void eetq::wgmma_grouped::(anonymous namespace)::grouped_kernel<8, 8, 0>(eetq::Args)",
     "moe_grouped", "grouped_kernel"),
    ("void eetq::wgmma_gemm::(anonymous namespace)::gemm_kernel<8, 2, 128>(eetq::Args)",
     "w8a16", "gemm_kernel"),
    ("void eetq::a8::(anonymous namespace)::a8_gemm_kernel<8, 2, 1>(eetq::a8::Args)",
     "w8a8", "a8_gemm_kernel"),
    ("void (anonymous namespace)::flash_decode_kernel<8, 4, 128, true>(Params)",
     "attention_decode", "flash_decode_kernel"),
    ("nvjet_tst_256x32_64x5_2x1_v_bz_NNT", "other", "nvjet_tst_256x32_64x5_2x1_v_bz_NNT"),
])
def test_kernel_classes(name, cls, short):
    assert trace.classify(name, trace.kernel_classes()) == cls
    assert trace.short_name(name) == short
