"""The engine's sharded backend (`serve/engine.py` over a
`dist.sharding.ShardedModel`) on the CPU: two gloo ranks spawned for the
module (`dist/launch.py::RankPool`, tasks in `tests/torch_sharding_tasks.py`),
each running the same scheduler over its shard of a `quantize_params_tp(tp=2)`
artifact made by the JAX package, against JAX's sharded engine
(`tests/test_engine.py:142-175`), the port's one-card engine on the same
artifact, and each other.

Tolerance. The ranks' outputs are identical (the same gathered logits and
the same seeded sampler on every rank). Against the one-card engine and
JAX's sharded engine a greedy request is equal, or parts at a near tie: at
its first differing token both tokens' logits lie within NEAR_TIE_ULPS bf16
ulps (of the largest |logit|) of the top logit after the common prefix, by
the port's one-card forward (the sums of two bf16 partials round where the
one-card GEMM does not). The spec engine equals its sharded non-spec twin
(`tests/test_engine.py:612`): the same kernels' plain versions on the same
shards."""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

import torch_sharding_tasks as tasks
from eetq_tpu.dist import make_mesh as jax_make_mesh
from eetq_tpu.models import ModelConfig as JaxConfig
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu.surgery import tp_reshard as jax_tp
from eetq_tpu_torch.dist.launch import RankPool
from eetq_tpu_torch.dist.sharding import ShardedModel, make_mesh
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import forward_inner, init_caches
from eetq_tpu_torch.modules.linear import LoraAdapter
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.surgery.tp_reshard import shard_quantized
from test_torch_model import jax_params_to_numpy

# tests/test_engine.py's CFG
DIMS = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, max_position=128)
CFG, JCFG = ModelConfig(**DIMS), JaxConfig(**DIMS)
TP = 2
NEAR_TIE_ULPS = 8
ENGINE = dict(max_batch=2, max_len=64, prompt_buckets=(16,))
PROMPTS = [[5, 6, 7], [11] * 10, [1, 2]]
NEW = 6


@pytest.fixture(scope="module")
def artifact():
    """JAX's quantize_params_tp(tp=2) artifact; the port's copy of it."""
    dense = jax_random_dense_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    qp = jax_tp.quantize_params_tp(dense, JCFG, tp=TP)
    tree = jax_params_to_numpy(qp)
    return qp, tree, params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def pool(tmp_path_factory, artifact):
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    with RankPool(TP, f"file://{rdv}", device="cpu", threads=1, timeout_s=300) as p:
        p.run(tasks.build, artifact[1], CFG, "quantized")
        yield p


def _one_card(params, requests, **kw) -> list:
    eng = Engine(params, CFG, **dict(ENGINE, **kw))
    uids = [eng.add_request(p, n, **k) for p, n, k in requests]
    eng.run()
    return [eng.result(u) for u in uids]


def _near_tie(params, ids: list[int], a: int, b: int) -> bool:
    """Both tokens within NEAR_TIE_ULPS bf16 ulps of the top next-token logit
    after ids, by the one-card forward."""
    toks = torch.tensor([ids])
    lg, _ = forward_inner(params, CFG, toks, torch.arange(len(ids))[None],
                          init_caches(CFG, 1, len(ids), device="cpu"), 0, last_only=True)
    row = lg[0, -1].double()
    ulp = 2.0 ** (math.floor(math.log2(float(row.abs().max()))) - 7)
    return float(row.max() - min(row[a], row[b])) <= NEAR_TIE_ULPS * ulp


def _equal_or_near_tie(params, got: list, want: list, prompts: list) -> None:
    for g, w, p in zip(got, want, prompts):
        assert len(g) == len(w)
        first = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if first is not None:
            assert _near_tie(params, p + w[:first], g[first], w[first]), (p, g, w, first)


def test_sharded_engine_matches_jax_and_one_card(pool, artifact):
    """Greedy requests through the sharded engine on both ranks: the ranks
    agree token for token, and each request equals (or parts at a near tie
    from) the one-card engine on the same artifact and JAX's sharded engine
    (which allows "a third may differ"; this holds the port to a near tie)."""
    qp, _, params = artifact
    requests = [(p, NEW, {}) for p in PROMPTS]
    got = pool.run(tasks.serve, requests, ENGINE)
    assert got[0] == got[1]
    _equal_or_near_tie(params, got[0], _one_card(params, requests), PROMPTS)
    jeng = JaxEngine(jax_tp.shard_quantized(qp, JCFG, jax_make_mesh(tp=TP, dp=1)), **ENGINE)
    _equal_or_near_tie(params, got[0], jeng.generate_all(PROMPTS, max_new_tokens=NEW), PROMPTS)


def test_ranks_stay_in_lockstep(pool, artifact):
    """More requests than slots, sampled ones among them, decode windows of
    4 chained: every rank commits the same tokens (the same gathered logits,
    the same seeded sampler), and the greedy ones equal the one-card
    engine's or part at a near tie."""
    _, _, params = artifact
    prompts = PROMPTS + [[9, 9], [3, 17, 42, 9, 3, 17], [40] * 12]
    requests = [(p, 4 + i, dict(temperature=0.8, top_k=20) if i % 3 == 1 else {})
                for i, p in enumerate(prompts)]
    got = pool.run(tasks.serve, requests, dict(ENGINE, decode_window=4, seed=5))
    assert got[0] == got[1]
    greedy = [i for i, (_, _, kw) in enumerate(requests) if not kw]
    want = _one_card(params, [requests[i] for i in greedy], decode_window=4, seed=5)
    _equal_or_near_tie(params, [got[0][i] for i in greedy], want, [prompts[i] for i in greedy])
    assert all(len(g) == n for g, (_, n, _) in zip(got[0], requests))


@pytest.mark.parametrize("k", [3, 7])
def test_sharded_spec_engine_equals_twin(pool, k):
    """Engine(sharded, spec_ngram=k): the n-gram speculative windows verify
    through the sharded forward, and every request equals the sharded
    non-spec engine's at the same window."""
    prompts = [[3, 17, 42, 9, 3, 17], [11] * 10, [5, 6, 7], [2, 4, 2, 4, 2]]
    requests = [(p, NEW + 2, {}) for p in prompts]
    spec = pool.run(tasks.serve, requests, dict(ENGINE, decode_window=4, spec_ngram=k))
    plain = pool.run(tasks.serve, requests, dict(ENGINE, decode_window=4))
    assert spec[0] == spec[1] == plain[0] == plain[1]


def _one_rank(params) -> ShardedModel:
    return shard_quantized(params, CFG, make_mesh(device="cpu"))


def test_one_rank_sharded_engine_is_the_engine(artifact):
    """The sharded backend over a mesh of one rank serves what the one-card
    engine serves, token for token (its cache the same bf16 cache)."""
    _, _, params = artifact
    requests = [(p, NEW, {}) for p in PROMPTS]
    eng = Engine(_one_rank(params), **ENGINE)
    assert eng.kv_dtype == torch.bfloat16 and not eng.a8_prefill and eng.mesh is not None
    assert eng.generate_all(PROMPTS, NEW) == _one_card(params, requests)


def test_refusals_match_jax(artifact):
    """The sharded backend refuses what JAX's refuses, with JAX's messages:
    a8 prefill, an int8 cache, a paged cache, prefill chunks and banked
    LoRA."""
    qp, _, params = artifact
    jmodel = jax_tp.shard_quantized(qp, JCFG, jax_make_mesh(tp=TP, dp=1))
    model = _one_rank(params)
    cases = [(dict(a8_prefill=True), dict(a8_prefill=True)),
             (dict(kv_dtype=torch.int8), dict(kv_dtype=jnp.int8)),
             (dict(paged_blocks=8), dict(paged_blocks=8)),
             (dict(prefill_chunk=8), dict(prefill_chunk=8))]
    for kw, jkw in cases:
        with pytest.raises(ValueError) as jerr:
            JaxEngine(jmodel, **ENGINE, **jkw)
        with pytest.raises(ValueError) as err:
            Engine(model, **ENGINE, **kw)
        assert str(err.value).split("(")[0] == str(jerr.value).split("(")[0], kw
    lp = model.params.layers[0]
    bank = LoraAdapter(torch.zeros(2, lp.qkv.k, 4), torch.zeros(2, 4, lp.qkv.n))
    lp.qkv_lora = bank
    with pytest.raises(ValueError, match="banked LoRA serving is local-backend only"):
        Engine(model, **ENGINE)
    with pytest.raises(TypeError, match="ShardedModel"):
        Engine(params)
