"""Perplexity of the port (`serve/eval.py`) against the JAX package's
`eetq_tpu/serve/eval.py` on the same converted parameters: dense bf16 and
W8A16, a stream whose last window is padded and masked, a batch of windows
with the window count padded to a multiple of it, and `delta_ppl`; then the
port against a straight-line per-window cross-entropy and its own plain
path. The token streams are seeded numpy draws.

Tolerances: the two packages' logits differ by about a bf16 ulp (1/32 at
|logit| in [4, 8)) at scattered entries (`tests/test_torch_model.py`), which
moves a mean NLL over ~100 targets by about 2e-3 nats (1.2e-3 seen): PPL
within 5e-3 relative, ΔPPL within 5e-3 of the dense PPL. The protocol itself
(which targets count, the padding masked) is held exactly within the port:
the same forward summed token by token, 1e-4 relative (f32 sums of a few
hundred NLLs against float64).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.serve.eval import delta_ppl as jax_delta_ppl
from eetq_tpu.serve.eval import perplexity as jax_perplexity
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import forward_inner
from eetq_tpu_torch.serve.eval import delta_ppl, perplexity
from test_torch_model import jax_params_to_numpy

CFG = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=2, head_dim=16, max_position=64)
# (stream length, window, batch): a padded last window (100 = 3 x 32 + 4),
# batches of 3 (4 windows padded to 6) and 4, and the window cut to
# max_position
STREAMS = [(100, 32, 1), (100, 32, 3), (128, 32, 4), (150, 128, 1)]


@pytest.fixture(scope="module")
def models():
    dense_j = jax_random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    quant_j = jax_quantize_params(dense_j)
    return {"dense": (dense_j, params_from_numpy(jax_params_to_numpy(dense_j), device="cpu")),
            "w8a16": (quant_j, params_from_numpy(jax_params_to_numpy(quant_j), device="cpu"))}


def _ids(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, size=n)


@pytest.mark.parametrize("n,window,batch", STREAMS)
@pytest.mark.parametrize("kind", ["dense", "w8a16"])
def test_perplexity_matches_jax(models, kind, n, window, batch):
    jp, tp = models[kind]
    ids = _ids(n, n + window + batch)
    want = jax_perplexity(jp, CFG, ids, window=window, batch_size=batch)
    got = perplexity(tp, CFG, ids, window=window, batch_size=batch)
    assert got == pytest.approx(want, rel=5e-3)


def test_delta_ppl_matches_jax(models):
    ids = _ids(256, 2)
    want = jax_delta_ppl(models["dense"][0], models["w8a16"][0], CFG, ids, window=64)
    got = delta_ppl(models["dense"][1], models["w8a16"][1], CFG, ids, window=64)
    assert set(got) == {"ppl_dense", "ppl_quant", "delta_ppl"}
    for key in ("ppl_dense", "ppl_quant"):
        assert got[key] == pytest.approx(want[key], rel=5e-3)
    assert got["delta_ppl"] == pytest.approx(want["delta_ppl"], abs=5e-3 * want["ppl_dense"])
    assert got["delta_ppl"] == got["ppl_quant"] - got["ppl_dense"]


def _manual_ppl(params, ids, window: int) -> float:
    """Straight-line reference: each window's shifted cross-entropy, token by
    token (`tests/test_eval.py::_manual_ppl`)."""
    total, cnt = 0.0, 0
    for i in range(0, len(ids), window):
        chunk = torch.from_numpy(ids[i:i + window])[None]
        with torch.no_grad():
            logits, _ = forward_inner(params, CFG, chunk, torch.arange(chunk.shape[1])[None],
                                      None, 0)
        logp = torch.log_softmax(logits[0].double(), dim=-1)
        for t in range(chunk.shape[1] - 1):
            total -= float(logp[t, chunk[0, t + 1]])
            cnt += 1
    return math.exp(total / cnt)


@pytest.mark.parametrize("batch", [1, 3])
def test_perplexity_matches_manual(models, batch):
    ids = _ids(100, 5)
    tp = models["w8a16"][1]
    assert perplexity(tp, CFG, ids, window=32, batch_size=batch) == pytest.approx(
        _manual_ppl(tp, ids, 32), rel=1e-4)


def test_perplexity_plain_path_and_errors(models):
    """use_kernels=False runs the plain versions, within the cross-package
    bound of the kernel path (they too part at ulps of scattered logits);
    quantization is near-lossless near PPL ~ vocab on a random model, as
    `tests/test_eval.py` holds it; a stream of one token has no target."""
    ids = _ids(128, 6)
    tp = models["w8a16"][1]
    assert perplexity(tp, CFG, ids, window=64, use_kernels=False) == pytest.approx(
        perplexity(tp, CFG, ids, window=64), rel=5e-3)
    r = delta_ppl(models["dense"][1], tp, CFG, ids, window=64)
    assert abs(r["delta_ppl"]) / r["ppl_dense"] < 0.01, r
    with pytest.raises(ValueError, match="no target tokens"):
        perplexity(tp, CFG, ids[:1], window=64)
