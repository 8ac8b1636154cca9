"""Pipeline parallelism (`eetq_tpu_torch/dist/pipeline.py`) against the JAX
package on the CPU. The JAX side runs in this process on the fake CPU
devices of `tests/conftest.py` (`shard_map` over a (data, pipe, model)
mesh, `ppermute` between stages); the port's side runs in spawned gloo
ranks (`dist/launch.py::RankPool`), one pool of 2 and one of 4 for the
module, each rank building its own stage of the same numpy weights and
returning numpy (`tests/torch_pipeline_tasks.py`).

The config is `tests/test_pipeline.py`'s (4 layers, GQA 8/4), with bf16
weights on both sides so that both quantize the same values.

Tolerances. Stage shards: the unpacked ints and the scales of every
projection equal JAX's stacked leaf at [p] (or [p, t] under tp), bit for
bit. Greedy tokens: equal to JAX's `pp_generate`, to the port's one-card
`greedy_generate` (the stages hold whole layers quantized as
`quantize_params` quantizes them, so only the schedule differs) and under
pp x tp to the port's tp = 2 sharded forward driven step by step. Prefill
logits and the caches advanced by the decode ring: JAX's 2e-2 rtol and
atol (`tests/test_pipeline.py:112-153`). Collectives: the counts and bytes
of JAX's jaxpr, where the count of a `scan` body is multiplied by its trip
count (the port counts calls as they happen; `count_collectives` in the
JAX package counts a body once). The ranks' outputs are identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pipeline_tasks as tasks
from eetq_tpu.dist import init_pp_caches as jax_init_pp_caches
from eetq_tpu.dist import make_pp_mesh as jax_make_pp_mesh
from eetq_tpu.dist import pp_decode_loop as jax_pp_decode_loop
from eetq_tpu.dist import pp_generate as jax_pp_generate
from eetq_tpu.dist import pp_prefill as jax_pp_prefill
from eetq_tpu.dist import shard_model_pp as jax_shard_model_pp
from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.models import ModelConfig as JaxConfig
from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.modules.linear import QuantLinear as JaxQuant
from eetq_tpu_torch.dist.launch import RankPool
from eetq_tpu_torch.dist.pipeline import pp_decode_loop, shard_model_pp
from eetq_tpu_torch.dist.sharding import Mesh
from eetq_tpu_torch.models.config import PRESETS, ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import quantize_params
from eetq_tpu_torch.serve.generate import greedy_generate
from test_torch_model import jax_params_to_numpy

SHAPE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=8,
             num_kv_heads=4, head_dim=16, max_position=64)
CFG, JCFG = ModelConfig(**SHAPE), JaxConfig(**SHAPE)
B, S, NEW = 4, 8, 6
RTOL = ATOL = 2e-2


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools by world size, started on first use, closed with the module."""
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
    """(JAX bf16 dense params, their numpy tree)."""
    jp = jax_random_dense_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return jp, jax_params_to_numpy(jp)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


def _jax_leaf(lin, at: tuple) -> dict:
    """JAX's stacked leaf at stage (and shard) `at`, as `tasks.leaves` gives it."""
    if isinstance(lin, JaxQuant):
        qw = lin.qweight
        data = jnp.asarray(np.asarray(qw.data)[at])  # off the mesh
        return {"q": np.asarray(jax_unpack(dataclasses.replace(qw, data=data))),
                "s": np.asarray(lin.scales)[at]}
    return {"w": np.asarray(lin.weight, np.float32)[at]}


def _same_stage(got: dict, jmodel, tp: int) -> None:
    at = (got["stage"], got["shard"]) if tp > 1 else (got["stage"],)
    for j, lp in enumerate(jmodel.params.layers):
        for name in ("qkv", "o_proj", "gateup", "down"):
            for part, arr in _jax_leaf(getattr(lp, name), at).items():
                np.testing.assert_array_equal(got[f"{j}.{name}"][part], arr,
                                              err_msg=f"stage {at} layer {j} {name} {part}")
        np.testing.assert_array_equal(got["norms"][j][0],
                                      np.asarray(lp.input_norm)[got["stage"]])
        np.testing.assert_array_equal(got["norms"][j][1], np.asarray(lp.post_norm)[got["stage"]])
    np.testing.assert_array_equal(got["lm_head"]["w"],
                                  np.asarray(jmodel.params.lm_head.weight, np.float32))


@pytest.mark.parametrize("pp,tp", [(2, 1), (4, 1), (2, 2)])
def test_stage_shards_equal_jax(pools, model, pp, tp):
    """Each rank's shard_model_pp(quantize=True) stage: its layers' unpacked
    ints and scales (and norms) equal JAX's stacked leaf at [p] or [p, t],
    and the replicated dense lm_head is the whole head."""
    jp, tree = model
    jmodel = jax_shard_model_pp(jp, JCFG, jax_make_pp_mesh(pp=pp, tp=tp, dp=1), quantize=True)
    got = pools(pp * tp).run(tasks.pp_build, pp, tp, tree, CFG)
    assert [(g["stage"], g["shard"]) for g in got] == [(r // tp, r % tp) for r in range(pp * tp)]
    for g in got:
        assert len([k for k in g if k.endswith(".qkv")]) == CFG.num_layers // pp
        _same_stage(g, jmodel, tp)


def _same_ranks(res: list, key: str = "tokens") -> np.ndarray:
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key])
    return res[0][key]


@pytest.mark.parametrize("pp,m", [(2, 2), (4, 4), (2, 4)])
def test_pp_generate_matches_jax_and_one_card(pools, model, pp, m):
    """Greedy pp_generate (`tests/test_pipeline.py:58-75`) equals JAX's
    pp_generate and the port's one-card greedy_generate, also with more
    microbatches in flight than stages; every rank returns the same
    tokens."""
    jp, tree = model
    prompt = _tokens(B, S)
    jmodel = jax_shard_model_pp(jp, JCFG, jax_make_pp_mesh(pp=pp, tp=1, dp=1), quantize=True)
    want = np.asarray(jax_pp_generate(jmodel, jnp.asarray(prompt), NEW, microbatches=m))
    pool = pools(pp)
    pool.run(tasks.pp_build, pp, 1, tree, CFG)
    got = _same_ranks(pool.run(tasks.pp_generate_task, prompt, NEW, m))
    np.testing.assert_array_equal(got, want)
    one = greedy_generate(quantize_params(params_from_numpy(tree, device="cpu")), CFG,
                          torch.from_numpy(prompt).long(), NEW)
    np.testing.assert_array_equal(got, one.numpy())


def test_pp_tp_matches_jax_and_tp_reference(pools, model):
    """pp 2 x tp 2 greedy (`tests/test_pipeline.py:78-109`): equal to JAX's
    pp_generate on the same mesh and to the port's tp = 2 sharded forward
    driven step by step (the stage split adds no numerics)."""
    jp, tree = model
    prompt = _tokens(B, S, seed=11)
    jmodel = jax_shard_model_pp(jp, JCFG, jax_make_pp_mesh(pp=2, tp=2, dp=1), quantize=True)
    want = np.asarray(jax_pp_generate(jmodel, jnp.asarray(prompt), NEW, microbatches=2))
    pool = pools(4)
    pool.run(tasks.pp_build, 2, 2, tree, CFG)
    got = _same_ranks(pool.run(tasks.pp_generate_task, prompt, NEW, 2))
    np.testing.assert_array_equal(got, want)
    ref = pools(2).run(tasks.tp_greedy, tree, CFG, prompt, NEW)
    np.testing.assert_array_equal(ref[1], ref[0])
    np.testing.assert_array_equal(got, ref[0])


def _jax_counts(fn, *args) -> dict:
    """JAX's collectives in fn's jaxpr as the port counts them: psum read
    as all_reduce, and the collectives of a `scan` body multiplied by its
    trip count (the port's loops run the body that many times)."""
    names = {"psum": "all_reduce", "psum2": "all_reduce", "psum_invariant": "all_reduce",
             "all_gather": "all_gather", "ppermute": "ppermute"}
    out: dict = {}

    def visit(jx, mult):
        for eqn in jx.eqns:
            op = names.get(eqn.primitive.name)
            if op is not None:
                nbytes = sum(v.aval.size * v.aval.dtype.itemsize for v in eqn.invars
                             if hasattr(v.aval, "size"))
                out[op] = out.get(op, 0) + mult * nbytes
                out[f"{op}_count"] = out.get(f"{op}_count", 0) + mult
            inner = mult * eqn.params["length"] if eqn.primitive.name == "scan" else mult
            for pval in eqn.params.values():
                for sub in jax.tree.leaves(pval, is_leaf=lambda x: hasattr(x, "eqns")
                                           or hasattr(x, "jaxpr")):
                    if hasattr(sub, "jaxpr"):
                        visit(sub.jaxpr, inner)
                    elif hasattr(sub, "eqns"):
                        visit(sub, inner)

    visit(jax.make_jaxpr(fn)(*args).jaxpr, 1)
    return out


def test_pp_prefill_and_decode_match_jax(pools, model):
    """pp_prefill's logits (`tests/test_pipeline.py:112-130`) and the stage
    caches after prefill and after the decode ring (`:133-153`) against
    JAX's at 2e-2; decoding two windows from the returned caches equals one
    long window; the collectives of the prefill and of each decode equal
    JAX's (a ppermute a tensor a tick, the logits' and the tokens' psum over
    pipe)."""
    jp, tree = model
    prompt = _tokens(B, S, seed=5)
    m, max_len = 2, 32
    jmodel = jax_shard_model_pp(jp, JCFG, jax_make_pp_mesh(pp=2, tp=1, dp=1), quantize=True)
    jlogits, jcaches = jax_pp_prefill(jmodel, jnp.asarray(prompt),
                                      jax_init_pp_caches(jmodel, B, max_len), microbatches=m)
    jpre = [(np.asarray(c.k, np.float32), np.asarray(c.v, np.float32)) for c in jcaches]
    first = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
    jtoks, jcaches = jax_pp_decode_loop(jmodel, jnp.asarray(first), S, jcaches, 9,
                                        microbatches=m)
    jdec = [(np.asarray(c.k, np.float32), np.asarray(c.v, np.float32)) for c in jcaches]
    pool = pools(2)
    pool.run(tasks.pp_build, 2, 1, tree, CFG)
    long = pool.run(tasks.pp_prefill_decode, prompt, m, max_len, first, ((S, 9),))
    split = pool.run(tasks.pp_prefill_decode, prompt, m, max_len, first, ((S, 5), (S + 4, 5)))
    np.testing.assert_array_equal(long[1]["logits"], long[0]["logits"])
    np.testing.assert_array_equal(long[1]["tokens"][0], long[0]["tokens"][0])
    np.testing.assert_allclose(long[0]["logits"], np.asarray(jlogits), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(long[0]["tokens"][0], np.asarray(jtoks))
    for p, res in enumerate(long):  # rank p holds stage p
        for j, ((k, v), (jk, jv)) in enumerate(zip(res["prefill_caches"], jpre)):
            np.testing.assert_allclose(k, jk[p], rtol=RTOL, atol=ATOL, err_msg=f"{p} {j} k")
            np.testing.assert_allclose(v, jv[p], rtol=RTOL, atol=ATOL, err_msg=f"{p} {j} v")
        for j, ((k, v), (jk, jv)) in enumerate(zip(res["caches"], jdec)):
            np.testing.assert_allclose(k, jk[p], rtol=RTOL, atol=ATOL, err_msg=f"{p} {j} k")
            np.testing.assert_allclose(v, jv[p], rtol=RTOL, atol=ATOL, err_msg=f"{p} {j} v")
    a, b = split[0]["tokens"]
    np.testing.assert_array_equal(np.concatenate([a, b[:, 1:]], 1), long[0]["tokens"][0])
    # the collectives, the same on every rank
    caches = jax_init_pp_caches(jmodel, B, max_len)
    want = _jax_counts(lambda t, c: jax_pp_prefill(jmodel, t, c, microbatches=m),
                       jnp.asarray(prompt), caches)
    assert want["ppermute_count"] == m + 1 and want["all_reduce_count"] == 1, want
    for res in long:
        assert res["prefill_counts"] == want, (res["prefill_counts"], want)
    want = _jax_counts(lambda f, c: jax_pp_decode_loop(jmodel, f, S, c, 9, microbatches=m),
                       jnp.asarray(first), caches)
    # a tick's (activations, token) pair is two ppermutes, one a leaf
    assert want["ppermute_count"] == 2 * (8 * m + 1) and want["all_reduce_count"] == 1, want
    for res in long:
        assert res["decode_counts"][0] == want, (res["decode_counts"][0], want)


def test_pp_sampled_decode(pools, model):
    """Sampled pp_generate (`tests/test_pipeline.py:156-173`): every rank
    returns the same tokens, all in the vocabulary, and the same seed gives
    the same tokens again (the port's sampler draws other numbers than
    JAX's, so the tokens are held against themselves)."""
    _, tree = model
    prompt = _tokens(B, S, seed=7)
    pool = pools(2)
    pool.run(tasks.pp_build, 2, 1, tree, CFG)
    a = _same_ranks(pool.run(tasks.pp_generate_task, prompt, 5, 2, 0.8, 40, 42))
    b = _same_ranks(pool.run(tasks.pp_generate_task, prompt, 5, 2, 0.8, 40, 42))
    assert a.shape == (B, 5) and ((a >= 0) & (a < CFG.vocab_size)).all()
    np.testing.assert_array_equal(a, b)


def test_pp_refusals_match_jax(model):
    """What JAX refuses (`tests/test_pipeline.py:176-195`), the port refuses
    with the same exception and message: fewer microbatches than stages, a
    batch the microbatches do not divide, a layer count pp does not divide,
    MoE layers and a row-parallel bias; and a dp pp tp mesh that is not the
    world (one rank here)."""
    jp, tree = model
    jmesh = jax_make_pp_mesh(pp=2, tp=1, dp=1)
    jmodel = jax_shard_model_pp(jp, JCFG, jmesh, quantize=True)
    jcaches = jax_init_pp_caches(jmodel, 4, 32)
    mesh = Mesh(tp=1, rank=0, device=torch.device("cpu"), pp=2)  # stage 0, no exchange reached
    params = params_from_numpy(tree, device="cpu")
    pmodel = shard_model_pp(params, CFG, mesh)

    def same(exc, jfn, fn):
        with pytest.raises(exc) as want:
            jfn()
        with pytest.raises(exc) as got:
            fn()
        assert str(got.value) == str(want.value)

    same(ValueError, lambda: jax_pp_decode_loop(jmodel, jnp.zeros((4,), jnp.int32), 8, jcaches, 4,
                                                microbatches=1),
         lambda: pp_decode_loop(pmodel, torch.zeros(4, dtype=torch.long), 8, [], 4,
                                microbatches=1))
    same(ValueError, lambda: jax_pp_decode_loop(jmodel, jnp.zeros((3,), jnp.int32), 8, jcaches, 4,
                                                microbatches=2),
         lambda: pp_decode_loop(pmodel, torch.zeros(3, dtype=torch.long), 8, [], 4,
                                microbatches=2))
    bad, jbad = (dataclasses.replace(c, num_layers=3) for c in (CFG, JCFG))
    jp3 = jax_random_dense_params(jbad, jax.random.PRNGKey(2), dtype=jnp.bfloat16)
    same(ValueError, lambda: jax_shard_model_pp(jp3, jbad, jmesh),
         lambda: shard_model_pp(params_from_numpy(jax_params_to_numpy(jp3), device="cpu"), bad,
                                mesh))
    jmoe = jax_random_dense_params(JAX_PRESETS["toy-moe"], jax.random.PRNGKey(0),
                                   dtype=jnp.bfloat16)
    same(NotImplementedError, lambda: jax_shard_model_pp(jmoe, JAX_PRESETS["toy-moe"], jmesh),
         lambda: shard_model_pp(params_from_numpy(jax_params_to_numpy(jmoe), device="cpu"),
                                PRESETS["toy-moe"], mesh))
    jbias = dataclasses.replace(jp, layers=list(jp.layers))
    jbias.layers[3] = dataclasses.replace(
        jp.layers[3], down=dataclasses.replace(jp.layers[3].down,
                                               bias=jnp.zeros((64,), jnp.bfloat16)))
    biased = params_from_numpy(tree, device="cpu")
    biased.layers[3].down.bias = torch.zeros(64, dtype=torch.bfloat16)
    same(NotImplementedError, lambda: jax_shard_model_pp(jbias, JCFG, jmesh),
         lambda: shard_model_pp(biased, CFG, mesh))
    from eetq_tpu_torch.dist.pipeline import make_pp_mesh

    with pytest.raises(ValueError, match="world size 1"):  # dp pp tp must be the world
        make_pp_mesh(2, 1, dp=2, device="cpu")
