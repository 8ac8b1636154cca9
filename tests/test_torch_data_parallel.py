"""Data parallelism (dp > 1) and the hybrid mesh (`eetq_tpu_torch/dist/`)
against the JAX package on the CPU. The JAX side runs in this process on the
fake CPU devices of `tests/conftest.py` (`shard_map` over a (data, model) or
(data, pipe, model) mesh); the port's side runs in spawned gloo ranks
(`dist/launch.py::RankPool`), one pool each of 2, 4 and 8 ranks for the
module, each rank building its own shard of the same numpy weights and
returning numpy (`tests/torch_dp_tasks.py`).

Held: the meshes' layout (each rank's (data, model) index where JAX's
`mesh.devices` holds its device, the data and model groups' members) and
refusals; the sharded forward at (tp, dp) = (2, 2), (4, 2), (2, 4), dense
and quantized, and toy-moe at (2, 2), against JAX's `make_forward_fn` on the
same mesh shape at `test_torch_sharding.py`'s tolerances (DENSE_TOL 2e-2,
QUANT_TOL 5e-2 of the largest logit; the ranks of a data shard identical);
`count_collectives` under dp 2 x tp 2 equal to JAX's; the engine in JAX's
`test_sharded_engine_dp2` setup (`tests/test_engine.py:177-209`) against
JAX's dp 2 engine and the port's one-process engine (equal, or parting at a
near tie of NEAR_TIE_ULPS bf16 ulps, as `test_torch_engine_sharded.py`
judges it), its two admission rounds, the ranks identical, sampled requests
equal to the tp-only (dp 1) engine's, the spec engine equal to its twin;
and dp 2 x pp 2 x tp 2 greedy tokens equal to JAX's
(`tests/test_pipeline.py:198-231`) with JAX's refusals and messages."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_tasks as tasks
from eetq_tpu.dist import make_mesh as jax_make_mesh
from eetq_tpu.dist import make_pp_mesh as jax_make_pp_mesh
from eetq_tpu.dist import multihost as jax_multihost
from eetq_tpu.dist import pp_generate as jax_pp_generate
from eetq_tpu.dist import pp_prefill as jax_pp_prefill
from eetq_tpu.dist import shard_model as jax_shard_model
from eetq_tpu.dist import shard_model_pp as jax_shard_model_pp
from eetq_tpu.dist.pipeline import pp_decode_loop as jax_pp_decode_loop
from eetq_tpu.dist.sharding import make_forward_fn as jax_forward_fn
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.modules import moe as jax_moe
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu.surgery import tp_reshard as jax_tp
from eetq_tpu.utils.profiling import count_collectives as jax_count_collectives
from eetq_tpu_torch.dist.pipeline import pp_decode_loop, pp_prefill, shard_model_pp
from eetq_tpu_torch.dist.sharding import Mesh, ShardedModel, make_mesh, shard_model
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.serve.engine import Engine
from test_torch_engine_sharded import CFG as ENGINE_CFG
from test_torch_engine_sharded import JCFG as ENGINE_JCFG
from test_torch_engine_sharded import _equal_or_near_tie
from test_torch_model import jax_params_to_numpy
from test_torch_pipeline import CFG as PP_CFG
from test_torch_pipeline import JCFG as PP_JCFG
from test_torch_sharding import DENSE_TOL, QUANT_TOL, _cfgs

B, S, STEPS = 4, 12, 2
ENGINE = dict(max_batch=4, max_len=64, prompt_buckets=(16,))
PROMPTS = [[5, 6, 7], [11] * 10, [1, 2], [9, 9]]
NEW = 6


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools of 2, 4, 8 ranks, started together, closed with the module."""
    made = tasks.start_pools((2, 4, 8), tmp_path_factory)
    yield made.__getitem__
    tasks.close_pools(made)


@pytest.fixture(scope="module")
def models():
    """case -> (JAX bf16 dense params, their numpy tree), made once."""
    out = {}

    def get(case):
        if case not in out:
            _, jcfg, _ = _cfgs(case)
            jp = jax_random_dense_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
            out[case] = jp, jax_params_to_numpy(jp)
        return out[case]

    return get


def test_mesh_layout_matches_jax(pools):
    """make_mesh(tp=2, dp=2) and make_hybrid_mesh(tp=2, dp=2) over 4 ranks:
    the axis sizes, each rank's (data, model) index where JAX's
    `mesh.devices` holds device `rank`, its data group (the ranks of its
    column) and model group (of its row), and `gather_rows` in data order;
    tp = dp = 3 refused by both packages; make_hybrid_mesh's defaults: tp 2,
    dp 2 under LOCAL_WORLD_SIZE=2 (two hosts of 2 ranks) and by host names,
    and a model group across hosts refused."""
    devs = np.asarray(jax_make_mesh(tp=2, dp=2, devices=jax.devices()[:4]).devices)
    jhybrid = jax_multihost.make_hybrid_mesh(tp=2, dp=2, devices=jax.devices()[:4])
    assert dict(jhybrid.shape) == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match=r"dp\*tp = 3\*3 != device count"):
        jax_multihost.make_hybrid_mesh(tp=3, dp=3)
    got = pools(4).run(tasks.mesh_layouts)
    for rank, out in enumerate(got):
        (d,), (t,) = np.nonzero(np.vectorize(lambda x: x.id)(devs) == rank)
        for key in ("make_mesh", "hybrid", "local_world", "by_host"):
            place = out[key]
            assert place["sizes"] == (2, 1, 2) and place["index"] == (d, t), (rank, key, place)
            assert place["data_sum"] == sum(x.id for x in devs[:, t]), (rank, key)
            assert place["model_sum"] == sum(x.id for x in devs[d, :]), (rank, key)
            assert place["gathered"] == [x.id for x in devs[:, t]], (rank, key)
        assert "world size 4" in out["mesh_3x3"]
        assert out["hybrid_3x3"] == "dp*tp = 3*3 != device count 4"
        assert "spans hosts" in out["across_hosts"]


def _jax_routes(routes: list):
    """JAX's `modules.moe.route` hands back, call by call, the routing the
    port's data shard recorded for its rows: routes[d] is data shard d's
    list of (weights, ids), picked inside `shard_map` by the data index."""
    stacked = [tuple(np.stack(parts) for parts in zip(*calls)) for calls in zip(*routes)]
    return iter(stacked)


@contextlib.contextmanager
def _replayed(routes):
    route, it = jax_moe.route, (_jax_routes(routes) if routes else None)

    def replay(router, x2, top_k):
        w, i = next(it)
        d = jax.lax.axis_index("data")
        assert w.shape[1:] == (x2.shape[0], top_k), (w.shape, x2.shape)
        return jnp.asarray(w)[d], jnp.asarray(i, jnp.int32)[d]

    if routes:
        jax_moe.route = replay
    try:
        yield
    finally:
        jax_moe.route = route
    if routes:
        assert next(it, None) is None, "routings left unused"


def _jax_run(jmodel, jcfg, tokens, steps, routes=None):
    """JAX's make_forward_fn over its (data, model) mesh: prefill logits [B,
    S, V], then a teacher-forced decode step a column of steps ([STEPS, B,
    V]); a forward made per call where routings are replayed."""
    caches = jax_init_caches(jcfg, B, S + STEPS + 1)
    n = steps.shape[1]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    with _replayed(routes):
        fwd = jax_forward_fn(jmodel, use_flash=False)
        lg, caches = fwd(jmodel.params, jnp.asarray(tokens), pos, caches, jnp.int32(0))
        dec = []
        for j in range(n):
            fwd = jax_forward_fn(jmodel, use_flash=False) if routes else fwd
            step, caches = fwd(jmodel.params, jnp.asarray(steps[:, j:j + 1]),
                               jnp.full((B, 1), S + j, jnp.int32), caches, jnp.int32(S + j))
            dec.append(np.asarray(step[:, -1]))
    return np.asarray(lg), np.stack(dec) if dec else None


def _tokens(cfg):
    rng = np.random.default_rng(5)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32))


def _close(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err} > {tol} x {np.abs(want).max()}"


@pytest.mark.parametrize("case,tp,dp,quantize,n", [
    ("toy2", 2, 2, False, STEPS), ("toy2", 2, 2, True, STEPS), ("toy4", 4, 2, False, 0),
    ("toy4", 4, 2, True, 0), ("toy2", 2, 4, False, 0), ("toy2", 2, 4, True, 0),
    ("moe2", 2, 2, True, 0)])
def test_dp_forward_matches_jax(pools, models, case, tp, dp, quantize, n):
    """The sharded forward on a dp x tp mesh (`tests/test_sharding.py:
    107-130`): every rank given the global batch runs its data shard's rows;
    the logits gathered over `data` against JAX's `make_forward_fn` on the
    same mesh shape, prefill and n teacher-forced decode steps at per-row
    offsets; a rank's own logits are its rows of the gathered ones, and the
    ranks of a data shard agree bit for bit. toy-moe: JAX replays each data
    shard's routing (`test_torch_sharding.py` says why)."""
    cfg, jcfg, _ = _cfgs(case)
    jp, tree = models(case)
    jmodel = jax_shard_model(jp, jcfg, jax_make_mesh(tp=tp, dp=dp), quantize=quantize)
    tokens, steps = _tokens(cfg)
    steps = steps[:, :n]
    pool = pools(tp * dp)
    pool.run(tasks.dp_build, tp, dp, tree, cfg, "quantize" if quantize else "dense")
    got = pool.run(tasks.dp_forward, tokens, steps)
    rows = B // dp
    for r, out in enumerate(got):
        d = r // tp
        assert out["dp_rank"] == d
        np.testing.assert_array_equal(out["prefill"], got[0]["prefill"])
        if n:
            np.testing.assert_array_equal(out["decode"], got[0]["decode"])
        np.testing.assert_array_equal(out["local"], got[0]["prefill"][d * rows:(d + 1) * rows])
        first = got[d * tp]
        for (w, i), (w0, i0) in zip(out["routes"], first["routes"]):
            np.testing.assert_array_equal(w, w0)
            np.testing.assert_array_equal(i, i0)
    routes = [got[d * tp]["routes"] for d in range(dp)] if cfg.num_experts else None
    want_p, want_d = _jax_run(jmodel, jcfg, tokens, steps, routes)
    tol = QUANT_TOL if quantize else DENSE_TOL
    _close(got[0]["prefill"], want_p, tol, "prefill")
    if n:
        _close(got[0]["decode"], want_d, tol, "decode")


def test_dp_count_collectives_matches_jax(pools, models):
    """Under dp 2 x tp 2 one prefill forward's collectives on a rank stay on
    the model axis: 2 all-reduces a layer of (B / dp) S H 2 bytes and one
    vocab gather, equal to JAX's `count_collectives` (whose avals are a
    shard's); gathering the logits over `data` is one all_gather outside
    it."""
    cfg, jcfg, _ = _cfgs("toy2")
    jp, tree = models("toy2")
    jmodel = jax_shard_model(jp, jcfg, jax_make_mesh(tp=2, dp=2), quantize=True)
    fwd = jax_forward_fn(jmodel, use_flash=False)
    tokens, steps = _tokens(cfg)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = jax_count_collectives(lambda p, t, q, c: fwd(p, t, q, c, jnp.int32(0)), jmodel.params,
                                 jnp.asarray(tokens), pos, jax_init_caches(jcfg, B, S + 4))
    assert want["psum"] == 2 * cfg.num_layers * (B // 2) * S * cfg.hidden_size * 2
    pool = pools(4)
    pool.run(tasks.dp_build, 2, 2, tree, cfg, "quantize")
    for c in pool.run(tasks.dp_forward, tokens, steps[:, :0]):
        assert c["counts"] == {"all_reduce": want["psum"], "all_reduce_count": want["psum_count"],
                               "all_gather": want["all_gather"],
                               "all_gather_count": want["all_gather_count"]}, (c, want)
        assert c["gathers"] == {"all_gather": (B // 2) * S * cfg.vocab_size * 4,
                                "all_gather_count": 1}


@pytest.fixture(scope="module")
def artifact():
    """`tests/test_engine.py`'s quantize_params_tp(tp=2) artifact (JAX's), the
    port's copy of it, JAX's dp 2 x tp 2 sharded model and its engine's
    outputs."""
    dense = jax_random_dense_params(ENGINE_JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    qp = jax_tp.quantize_params_tp(dense, ENGINE_JCFG, tp=2)
    tree = jax_params_to_numpy(qp)
    jmodel = jax_tp.shard_quantized(qp, ENGINE_JCFG, jax_make_mesh(tp=2, dp=2))
    jax_out = JaxEngine(jmodel, **ENGINE).generate_all(PROMPTS, NEW)
    return tree, params_from_numpy(tree, device="cpu"), jax_out, jmodel


def _one_process(params, requests, **kw) -> list:
    eng = Engine(params, ENGINE_CFG, **dict(ENGINE, **kw))
    uids = [eng.add_request(p, n, **k) for p, n, k in requests]
    eng.run()
    return [eng.result(u) for u in uids]


def _same(got: list, key: str = "outputs"):
    for g in got[1:]:
        assert g[key] == got[0][key]
    return got[0][key]


def test_dp_engine_matches_jax_and_one_process(pools, artifact):
    """JAX's `test_sharded_engine_dp2` on dp 2 x tp 2 ranks: every rank
    commits the same tokens; each request equals (or parts at a near tie
    from) JAX's dp 2 engine's and the one-process engine's; the 4 prompts
    take 2 admission rounds of 2 (one scratch row a data shard)."""
    tree, params, jax_out, _ = artifact
    pool = pools(4)
    pool.run(tasks.dp_build, 2, 2, tree, ENGINE_CFG, "quantized")
    got = pool.run(tasks.dp_serve, [(p, NEW, {}) for p in PROMPTS], ENGINE)
    outs = _same(got)
    assert all(g["rounds"] == [2, 2] for g in got), [g["rounds"] for g in got]
    assert all(len(o) == NEW for o in outs)
    _equal_or_near_tie(params, outs, jax_out, PROMPTS)
    _equal_or_near_tie(params, outs, _one_process(params, [(p, NEW, {}) for p in PROMPTS]),
                       PROMPTS)


def test_dp_engine_refuses_a_batch_dp_does_not_divide(artifact):
    """max_batch 3 under dp 2 raises ValueError with JAX's message."""
    _, params, _, jmodel = artifact
    with pytest.raises(ValueError) as want:
        JaxEngine(jmodel, max_batch=3, max_len=64)
    fake = Mesh(tp=2, rank=0, device=torch.device("cpu"), dp=2)
    with pytest.raises(ValueError) as got:
        Engine(ShardedModel(ENGINE_CFG, fake, params), max_batch=3, max_len=64)
    assert str(got.value) == str(want.value)


def test_dp_sampled_and_spec_engines(pools, artifact):
    """Sampled requests under dp 2 x tp 2: identical on every rank, and
    equal to the same requests through the tp-only (dp 1) engine over 2
    ranks (the positional sampler keys a token by request and emission
    index, not by slot or mesh); the spec engine (k = 3, windows of 4)
    equal to its non-spec twin, also sampled."""
    tree = artifact[0]
    requests = [(p, NEW + 2, dict(temperature=0.8, top_k=20) if i % 2 else {})
                for i, p in enumerate(PROMPTS + [[3, 17, 42, 9, 3, 17], [2, 4, 2, 4, 2]])]
    kw = dict(ENGINE, decode_window=4, seed=3)
    pool = pools(4)
    pool.run(tasks.dp_build, 2, 2, tree, ENGINE_CFG, "quantized")
    dp2 = _same(pool.run(tasks.dp_serve, requests, kw))
    spec = pool.run(tasks.dp_serve, requests, dict(kw, spec_ngram=3))
    assert _same(spec) == dp2
    assert spec[0]["spec_rounds"] > 0
    two = pools(2)
    two.run(tasks.dp_build, 2, 1, tree, ENGINE_CFG, "quantized")
    assert _same(two.run(tasks.dp_serve, requests, kw)) == dp2


def _pp_tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, PP_CFG.vocab_size, (b, s)).astype(np.int32)


def test_pp_with_dp_matches_jax(pools):
    """dp 2 x pp 2 x tp 2 on 8 ranks (`tests/test_pipeline.py:198-231`): each
    data shard pipelines its rows; greedy tokens equal to JAX's pp_generate
    on the same mesh, the same on every rank, each rank at its (data, pipe,
    model) place; a sampled decode ring over two data shards holding the
    same prompts draws different tokens in each (the stream folded by the
    data index), the same on every rank."""
    jp = jax_random_dense_params(PP_JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tree = jax_params_to_numpy(jp)
    prompt, n = _pp_tokens(4, 8, seed=13), 5
    jmodel = jax_shard_model_pp(jp, PP_JCFG, jax_make_pp_mesh(pp=2, tp=2, dp=2), quantize=True)
    want = np.asarray(jax_pp_generate(jmodel, jnp.asarray(prompt), n, microbatches=2))
    twins = np.concatenate([prompt[:2], prompt[:2]])
    got = pools(8).run(tasks.dp_pp, 2, 2, 2, tree, PP_CFG, prompt, n, 2, twins)
    assert [g["place"] for g in got] == [(r // 4, r // 2 % 2, r % 2) for r in range(8)]
    for g in got:
        np.testing.assert_array_equal(g["tokens"], want)
        np.testing.assert_array_equal(g["sampled"], got[0]["sampled"])
    sampled = got[0]["sampled"]
    assert not np.array_equal(sampled[:2, 1:], sampled[2:, 1:]), sampled
    assert got[0]["counts"]["all_gather_count"] == 2  # the logits' and the tokens' gathers


def test_pp_batch_refusals_match_jax():
    """`_check_pp_batch` under dp 2 (`eetq_tpu/dist/pipeline.py:470-483`): a
    batch dp does not divide, and a shard's rows the microbatches do not
    divide, refused with JAX's messages by pp_prefill and pp_decode_loop."""
    jp = jax_random_dense_params(PP_JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    jmodel = jax_shard_model_pp(jp, PP_JCFG, jax_make_pp_mesh(pp=2, tp=1, dp=2), quantize=True)
    fake = Mesh(tp=1, rank=0, device=torch.device("cpu"), pp=2, dp=2)  # no exchange reached
    pmodel = shard_model_pp(params_from_numpy(jax_params_to_numpy(jp), device="cpu"), PP_CFG, fake)
    cases = [(3, 1), (2, 2)]  # (batch, microbatches)
    for b, m in cases:
        for jfn, fn in (
                (lambda: jax_pp_prefill(jmodel, jnp.zeros((b, 8), jnp.int32), [], microbatches=m),
                 lambda: pp_prefill(pmodel, torch.zeros((b, 8), dtype=torch.long), [],
                                    microbatches=m)),
                (lambda: jax_pp_decode_loop(jmodel, jnp.zeros((b,), jnp.int32), 8, [], 4,
                                            microbatches=m),
                 lambda: pp_decode_loop(pmodel, torch.zeros(b, dtype=torch.long), 8, [], 4,
                                        microbatches=m))):
            with pytest.raises(ValueError) as want:
                jfn()
            with pytest.raises(ValueError) as got:
                fn()
            assert str(got.value) == str(want.value), (b, m)


def test_one_rank_mesh_and_shard_dp():
    """On one rank make_mesh() is the plain mesh (data index 0, no groups)
    whose `data_rows` are the whole batch; a ShardedModel's caches hold its
    data shard's batch / dp rows, and a batch dp does not divide raises."""
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.dp_rank, mesh.data_group) == (1, 0, None)
    assert mesh.data_rows(6) == slice(0, 6)
    cfg = dataclasses.replace(ENGINE_CFG, num_layers=1)
    tree = jax_params_to_numpy(jax_random_dense_params(dataclasses.replace(ENGINE_JCFG,
                                                                           num_layers=1),
                                                       jax.random.PRNGKey(1)))
    model = shard_model(params_from_numpy(tree, device="cpu"), cfg, mesh)
    assert model.init_caches(6, 8)[0].k.shape[0] == 6
    half = ShardedModel(cfg, Mesh(tp=1, rank=1, device=torch.device("cpu"), dp=2), model.params)
    assert half.mesh.data_rows(6) == slice(3, 6) and half.init_caches(6, 8)[0].k.shape[0] == 3
    with pytest.raises(ValueError, match="batch 5 not divisible by data shards 2"):
        half.init_caches(5, 8)
