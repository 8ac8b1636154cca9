"""Sequence-parallel long-context prefill (`eetq_tpu_torch/dist/
long_context.py`) against the JAX package on the CPU
(`tests/test_long_context.py`): the port's `long_prefill` and
`generate_long` run in spawned gloo ranks holding the whole model (pools of
2 and 4 for the module, `tests/torch_pipeline_tasks.py`), JAX's on the fake
CPU devices of `tests/conftest.py`, both over the same W8A16 weights (JAX's
quantized params carried across with `params_from_numpy`).

Tolerances, the JAX test's: last-token logits and the gathered caches
within 0.05 of JAX's `long_prefill` and of the port's one-card `prefill`
(ring attention merges chunk statistics in f32 where the one-card path
runs one softmax); greedy tokens equal to JAX's `generate_long`, and to
the port's one-card `greedy_generate`. Collectives: JAX's jaxpr counts with
the ring's `scan` body times its trip count (2 p ppermutes a layer), one
logits gather and 2 L K/V gathers. The ranks' outputs are identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pipeline_tasks as tasks
from eetq_tpu.dist import generate_long as jax_generate_long
from eetq_tpu.dist import long_prefill as jax_long_prefill
from eetq_tpu.dist import make_mesh as jax_make_mesh
from eetq_tpu.models import ModelConfig as JaxConfig
from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu_torch.dist.launch import RankPool
from eetq_tpu_torch.dist.long_context import long_prefill
from eetq_tpu_torch.dist.sharding import Mesh
from eetq_tpu_torch.models.config import PRESETS, ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.serve.generate import greedy_generate, prefill
from test_torch_model import jax_params_to_numpy
from test_torch_pipeline import _jax_counts

SHAPE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, max_position=256)
CFG, JCFG = ModelConfig(**SHAPE), JaxConfig(**SHAPE)
TOL = 0.05


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world: int) -> RankPool:
        if world not in made:
            rdv = tmp_path_factory.mktemp(f"rdv{world}") / "store"
            made[world] = RankPool(world, f"file://{rdv}", device="cpu", threads=1,
                                   timeout_s=300)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


@pytest.fixture(scope="module")
def model():
    """(JAX W8A16 params, their numpy tree, the port's one-card params)."""
    jp = jax_quantize_params(jax_random_dense_params(JCFG, jax.random.PRNGKey(0),
                                                     dtype=jnp.bfloat16))
    tree = jax_params_to_numpy(jp)
    return jp, tree, params_from_numpy(tree, device="cpu")


def _same(res: list, key: str):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key] if key else r, res[0][key] if key else res[0])
    return res[0][key] if key else res[0]


@pytest.mark.parametrize("p", [2, 4])
def test_long_prefill_matches_jax_and_one_card(pools, model, p):
    """Last-token logits and the caches over the prompt against JAX's
    long_prefill and the port's one-card prefill (`tests/test_long_context.
    py:40-66`); the collectives against JAX's: 2 p ppermutes a layer, one
    logits gather, 2 L K/V gathers."""
    jp, tree, params = model
    s = 64
    toks = np.random.default_rng(0).integers(1, CFG.vocab_size, size=(2, s)).astype(np.int32)
    jmesh = jax_make_mesh(tp=p, dp=1)
    jlogits, jcaches = jax_long_prefill(jp, JCFG, jnp.asarray(toks), jmesh)
    res = pools(p).run(tasks.long_prefill_task, tree, CFG, toks)
    got = _same(res, "logits")
    for r in res[1:]:
        for (k, v), (k0, v0) in zip(r["caches"], res[0]["caches"]):
            np.testing.assert_array_equal(k, k0)
            np.testing.assert_array_equal(v, v0)
    logits1, caches1 = prefill(params, CFG, torch.from_numpy(toks).long(),
                               init_caches(CFG, 2, s, device="cpu"))
    np.testing.assert_allclose(got, np.asarray(jlogits), atol=TOL)
    np.testing.assert_allclose(got, logits1.numpy(), atol=TOL)
    for (k, v), jc, c1 in zip(res[0]["caches"], jcaches, caches1):
        for a, want in ((k, jc.k), (v, jc.v), (k, c1.k.float().numpy()), (v, c1.v.float().numpy())):
            np.testing.assert_allclose(a[:, :, :s], np.asarray(want, np.float32)[:, :, :s],
                                       atol=TOL)
    want = _jax_counts(lambda t: jax_long_prefill(jp, JCFG, t, jmesh), jnp.asarray(toks))
    chunk = 2 * (s // p) * CFG.num_kv_heads * CFG.head_dim * 2
    assert want == {"ppermute": 2 * p * CFG.num_layers * chunk,
                    "ppermute_count": 2 * p * CFG.num_layers,
                    "all_gather": 2 * CFG.vocab_size * 4 + 2 * CFG.num_layers * chunk,
                    "all_gather_count": 1 + 2 * CFG.num_layers}, want
    for r in res:
        assert r["counts"] == want, (r["counts"], want)


@pytest.mark.parametrize("case,s", [("plain", 32), ("window", 64), ("alibi", 32)])
def test_generate_long_matches_jax_and_greedy(pools, model, case, s):
    """generate_long greedy over 4 ranks (`tests/test_long_context.py:69-121`):
    plain, a sliding window of 24 crossing the 16-token chunks (mistral's
    case) and ALiBi (baichuan-13b's, no rope), each equal to JAX's
    generate_long and to the port's one-card greedy_generate."""
    jp, tree, params = model
    over = {"plain": {}, "window": dict(sliding_window=24), "alibi": dict(alibi=True)}[case]
    cfg, jcfg = dataclasses.replace(CFG, **over), dataclasses.replace(JCFG, **over)
    seed = {"plain": 1, "window": 2, "alibi": 3}[case]
    prompt = np.random.default_rng(seed).integers(1, cfg.vocab_size, size=(1, s)).astype(np.int32)
    want = np.asarray(jax_generate_long(jp, jcfg, jnp.asarray(prompt), 6,
                                        jax_make_mesh(tp=4, dp=1)))
    got = _same(pools(4).run(tasks.generate_long_task, tree, cfg, prompt, 6), None)
    np.testing.assert_array_equal(got, want)
    one = greedy_generate(params, cfg, torch.from_numpy(prompt).long(), 6)
    np.testing.assert_array_equal(got, one.numpy())


def test_long_prefill_refusals_match_jax(model):
    """A prompt the axis does not divide raises ValueError, MoE layers
    NotImplementedError, with JAX's messages (`tests/test_long_context.py:
    83-87`; the checks come before any exchange)."""
    jp, tree, params = model
    two = Mesh(tp=2, rank=0, device=torch.device("cpu"))

    def same(exc, jfn, fn):
        with pytest.raises(exc) as want:
            jfn()
        with pytest.raises(exc) as got:
            fn()
        assert str(got.value) == str(want.value)

    same(ValueError, lambda: jax_long_prefill(jp, JCFG, jnp.zeros((1, 9), jnp.int32),
                                              jax_make_mesh(tp=2, dp=1)),
         lambda: long_prefill(params, CFG, torch.zeros(1, 9, dtype=torch.long), two))
    moe = JAX_PRESETS["toy-moe"]
    jmoe = jax_random_dense_params(moe, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    same(NotImplementedError, lambda: jax_long_prefill(jmoe, moe, jnp.zeros((1, 8), jnp.int32),
                                                       jax_make_mesh(tp=2, dp=1)),
         lambda: long_prefill(params_from_numpy(jax_params_to_numpy(jmoe), device="cpu"),
                              PRESETS["toy-moe"], torch.zeros(1, 8, dtype=torch.long), two))
