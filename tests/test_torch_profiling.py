"""The port's `utils/profiling.py` against the JAX package's on the CPU:
`roofline` and the tensor- and pipeline-parallel decode models give the
same numbers as JAX's with both packages' peaks and link rates patched to
the same values (the arithmetic is unchanged; only the card's tables and
NVLink replace the TPU's), `device_time` and `host_sync_overhead` on a CPU
device, `trace` writing a Chrome trace, and a card the peak table does not
hold raising with its name."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import eetq_tpu.utils.profiling as jax_prof
from eetq_tpu.models.config import PRESETS as JAX_PRESETS
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.utils import profiling as prof

HBM_GBS, BF16_TFLOPS, INT8_TOPS = 3350.0, 989.0, 1979.0
LINK_BW, HOP_S = 450e9, 1e-6


@pytest.fixture
def same_peaks(monkeypatch):
    """Both packages on the H100's datasheet peaks, the same link rate."""
    monkeypatch.setattr(jax_prof, "chip_peaks", lambda: (HBM_GBS, BF16_TFLOPS))
    monkeypatch.setattr(jax_prof, "ICI_BW_PER_LINK", {"": LINK_BW})  # every device kind
    monkeypatch.setattr(jax_prof, "ICI_HOP_LATENCY_S", HOP_S)
    monkeypatch.setattr(prof, "chip_peaks",
                        lambda device=None: prof.Peaks(HBM_GBS, BF16_TFLOPS, INT8_TOPS))
    monkeypatch.setattr(prof, "nvlink_bw", lambda device=None: LINK_BW)


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("seconds,nbytes,flops", [
    (2e-3, 10**9, 10**6),  # memory-bound
    (0.1, 10**6, 10**13),  # compute-bound
    (1.46e-4, 6_738_149_376, 2 * 6_738_149_376),  # a llama2-7b decode step's weights
])
def test_roofline_matches_jax(same_peaks, seconds, nbytes, flops):
    got, want = prof.roofline(seconds, nbytes, flops), jax_prof.roofline(seconds, nbytes, flops)
    assert got.bound == want.bound
    for key, val in _fields(want).items():
        if key != "bound":
            np.testing.assert_allclose(getattr(got, key), val, rtol=1e-12)
    assert str(got) == str(want)


@pytest.mark.parametrize("name", ["llama2-7b", "llama2-70b"])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("t1", [None, 10.2])
@pytest.mark.parametrize("bits", [8, 4])
def test_tp_decode_scaling_matches_jax(same_peaks, name, tp, t1, bits):
    got = prof.tp_decode_scaling(PRESETS[name], tp, HOP_S, bits=bits, measured_t1_ms=t1)
    want = jax_prof.tp_decode_scaling(JAX_PRESETS[name], tp, bits=bits, measured_t1_ms=t1)
    w = _fields(want)
    w["t_link_ms"], w["link_bytes_per_step"] = w.pop("t_ici_ms"), w.pop("ici_bytes_per_step")
    for key, val in w.items():
        np.testing.assert_allclose(getattr(got, key), val, rtol=1e-9, err_msg=key)
    assert 0 < got.efficiency <= 1


@pytest.mark.parametrize("name", ["llama2-7b", "llama2-70b"])
@pytest.mark.parametrize("pp", [2, 4, 8])
@pytest.mark.parametrize("t1", [None, 10.2])
def test_pp_decode_scaling_matches_jax(same_peaks, name, pp, t1):
    got = prof.pp_decode_scaling(PRESETS[name], pp, 12.5, 25e-6, batch=4, measured_t1_ms=t1)
    want = jax_prof.pp_decode_scaling(JAX_PRESETS[name], pp, batch=4, measured_t1_ms=t1)
    for key, val in _fields(want).items():
        np.testing.assert_allclose(getattr(got, key), val, rtol=1e-9, err_msg=key)


def test_scaling_constants_without_a_datasheet_figure_have_no_default():
    with pytest.raises(TypeError):
        prof.tp_decode_scaling(PRESETS["llama2-7b"], 2)
    with pytest.raises(TypeError):
        prof.pp_decode_scaling(PRESETS["llama2-7b"], 2)


def test_device_time_measures_something_on_the_cpu():
    x = torch.randn(64, 64)
    t = prof.device_time(lambda a: (a @ a).sum(), x, iters=20, reps=2, device="cpu")
    assert 0 < t < 1.0
    assert prof.host_sync_overhead(reps=2, device="cpu") > 0


def test_an_unknown_card_raises_with_its_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="A100-SXM4-80GB"):
        prof.chip_peaks()
    with pytest.raises(KeyError, match="A100-SXM4-80GB"):
        prof.nvlink_bw()
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=None: "NVIDIA H100 80GB HBM3")
    assert prof.chip_peaks() == (HBM_GBS, BF16_TFLOPS, INT8_TOPS)
    assert prof.nvlink_bw() == LINK_BW


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with prof.trace(str(path)):
        torch.ones(16).sum()
    with open(path) as f:
        assert "traceEvents" in json.load(f)
