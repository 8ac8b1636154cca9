"""Tensor and expert parallelism (`eetq_tpu_torch/dist/`) against the JAX
package on the CPU. The JAX side runs in this process on the fake CPU
devices of `tests/conftest.py` (`shard_map`, psum, all_gather); the port's
side runs in spawned gloo ranks (`dist/launch.py::RankPool`), one pool of 2
and one of 4 for the module, each rank building its own shard of the same
numpy weights and returning numpy (`tests/torch_sharding_tasks.py`).

Configs: TOY at tp = 2; TOY with 4 kv heads at tp = 4 (one head a rank);
TOY under ALiBi at tp = 2; toy-moe at tp = 2 (2 experts a rank = top_k:
JAX's masked scan at prefill, the expert gather with parked selections in
the port's decode step).

Tolerances. Shards: the unpacked ints and the scales of every projection
equal JAX's stacked leaf at the rank, bit for bit (both packages quantize
the same bf16 shard with the same arithmetic). Logits: both sides sum bf16
partials over the ranks (two terms at tp = 2, four in another order at
tp = 4) and round at the same bf16 boundaries in between, so they part by
bf16 ulps of activations that reach the logits through two layers:
DENSE_TOL = 2e-2 of the largest logit for bf16 weights, QUANT_TOL = 5e-2
quantized (JAX's own sharded tests allow 5e-2 relative plus 8e-2
absolute). The ranks' logits are identical (gloo hands every rank the same
sum). Collective counts and bytes equal JAX's `count_collectives`, psum
read as all_reduce."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_sharding_tasks as tasks
from eetq_tpu.dist import make_mesh as jax_make_mesh
from eetq_tpu.dist import shard_model as jax_shard_model
from eetq_tpu.dist.sharding import make_forward_fn as jax_forward_fn
from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.modules import moe as jax_moe
from eetq_tpu.modules.linear import QuantLinear as JaxQuant
from eetq_tpu.surgery import tp_reshard as jax_tp
from eetq_tpu.utils.profiling import count_collectives as jax_count_collectives
from eetq_tpu_torch.dist.launch import RankPool
from eetq_tpu_torch.dist.sharding import split_qkv_columns
from eetq_tpu_torch.layout.tiling import unpack_weights
from eetq_tpu_torch.models.auto import EETQCausalLM
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.modules.linear import DenseLinear
from eetq_tpu_torch.surgery import tp_reshard
from test_torch_model import jax_params_to_numpy

DENSE_TOL, QUANT_TOL = 2e-2, 5e-2
B, S, STEPS = 2, 12, 2
CONFIGS = {
    "toy2": ("toy", {}, 2),
    "toy4": ("toy", dict(num_kv_heads=4), 4),
    "alibi2": ("toy", dict(alibi=True), 2),
    "moe2": ("toy-moe", {}, 2),
}


def _cfgs(case):
    name, over, tp = CONFIGS[case]
    return (dataclasses.replace(PRESETS[name], **over),
            dataclasses.replace(JAX_PRESETS[name], **over), tp)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools by tp, started on first use, closed with the module."""
    made = {}

    def get(tp: int) -> RankPool:
        if tp not in made:
            rdv = tmp_path_factory.mktemp(f"rdv{tp}") / "store"
            made[tp] = RankPool(tp, f"file://{rdv}", device="cpu", threads=1, timeout_s=300)
        return made[tp]

    yield get
    for pool in made.values():
        pool.close()


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


def _jax_leaf(lin, r: int) -> dict:
    """Rank r's slice of a JAX stacked leaf, as `tasks.leaves` gives it."""
    if isinstance(lin, JaxQuant):
        qw = lin.qweight
        data = jnp.asarray(np.asarray(qw.data)[r])  # off the mesh
        return {"q": np.asarray(jax_unpack(dataclasses.replace(qw, data=data))),
                "s": np.asarray(lin.scales)[r]}
    return {"w": np.asarray(lin.weight, np.float32)[r]}


def _same_leaves(got: dict, jmodel, r: int) -> None:
    p = jmodel.params
    for i, lp in enumerate(p.layers):
        names = ("qkv", "o_proj") + (() if lp.moe is not None else ("gateup", "down"))
        pairs = [(f"{i}.{n}", getattr(lp, n)) for n in names]
        if lp.moe is not None:
            pairs += [(f"{i}.moe.{n}", getattr(lp.moe, n)) for n in ("gateup", "down")]
            np.testing.assert_array_equal(got[f"{i}.moe.router"]["w"],
                                          np.asarray(lp.moe.router.weight, np.float32))
        for key, lin in pairs:
            want = _jax_leaf(lin, r)
            for part, arr in want.items():
                np.testing.assert_array_equal(got[key][part], arr, err_msg=f"rank {r} {key} {part}")
    np.testing.assert_array_equal(got["lm_head"]["w"], _jax_leaf(p.lm_head, r)["w"])


@pytest.mark.parametrize("case", ["toy2", "toy4", "moe2"])
def test_shard_leaves_equal_jax(pools, models, case):
    """Each rank's shard_model(quantize=True) shard: the unpacked ints and
    scales of qkv, o_proj, gate|up and down (or the expert banks: E / tp
    experts, each quantized on its own), the replicated router and the
    vocab slice of the dense lm_head equal JAX's stacked leaf at the rank."""
    cfg, jcfg, tp = _cfgs(case)
    jp, tree = models(case)
    jmodel = jax_shard_model(jp, jcfg, jax_make_mesh(tp=tp, dp=1), quantize=True)
    got = pools(tp).run(tasks.build, tree, cfg, "quantize")
    for r in range(tp):
        _same_leaves(got[r], jmodel, r)


def _tokens(cfg):
    rng = np.random.default_rng(3)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32))


@contextlib.contextmanager
def _replayed(routes):
    """JAX's `modules.moe.route` hands back `routes` (the port's rank 0's
    record, (weights, ids) a call) in order, as constants of the traced
    program; every entry must be used."""
    route, it = jax_moe.route, iter(routes or ())

    def replay(router, x2, top_k):
        w, i = next(it)
        assert w.shape == (x2.shape[0], top_k), (w.shape, x2.shape)
        return jnp.asarray(w), jnp.asarray(i, jnp.int32)

    if routes is not None:
        jax_moe.route = replay
    try:
        yield
    finally:
        jax_moe.route = route
    assert next(it, None) is None, "routings left unused"


def _jax_run(jmodel, jcfg, tokens, steps, routes=None):
    """JAX's make_forward_fn: prefill logits [B, S, V], then a teacher-forced
    decode step a column of steps ([STEPS, B, V]). routes: replay these
    routings (a forward made per call, so that each is traced with its
    own)."""
    fn = jax_forward_fn(jmodel, use_flash=False)
    caches = jax_init_caches(jcfg, B, S + STEPS + 1)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    with _replayed(routes):
        fwd = jax_forward_fn(jmodel, use_flash=False) if routes else fn
        lg, caches = fwd(jmodel.params, jnp.asarray(tokens), pos, caches, jnp.int32(0))
        dec = []
        for j in range(STEPS):
            fwd = jax_forward_fn(jmodel, use_flash=False) if routes else fn
            step, caches = fwd(jmodel.params, jnp.asarray(steps[:, j:j + 1]),
                               jnp.full((B, 1), S + j, jnp.int32), caches, jnp.int32(S + j))
            dec.append(np.asarray(step[:, -1]))
    return np.asarray(lg), np.stack(dec)


def _close(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), f"{what}: {err} > {tol} x {np.abs(want).max()}"


@pytest.mark.parametrize("case,quantize", [
    ("toy2", False), ("toy2", True), ("toy4", False), ("toy4", True), ("alibi2", True),
    ("moe2", False), ("moe2", True)])
def test_sharded_forward_matches_jax(pools, models, case, quantize):
    """Prefill logits and two teacher-forced decode steps of the sharded
    forward against JAX's `make_forward_fn` on the same shards
    (`tests/test_sharding.py:108-180`); the ranks' logits identical. Top-2
    routing is discontinuous: a token whose top two router logits are
    within an ulp picks another expert in either arithmetic and moves its
    logits far past any ulp bound, so JAX replays rank 0's routing (the
    ranks route alike: the router is replicated and the activations
    all-reduced)."""
    cfg, jcfg, tp = _cfgs(case)
    jp, tree = models(case)
    jmodel = jax_shard_model(jp, jcfg, jax_make_mesh(tp=tp, dp=1), quantize=quantize)
    tokens, steps = _tokens(cfg)
    pool = pools(tp)
    pool.run(tasks.build, tree, cfg, "quantize" if quantize else "dense")
    got = pool.run(tasks.forward, tokens, steps)
    for r in range(1, tp):
        np.testing.assert_array_equal(got[r]["prefill"], got[0]["prefill"])
        np.testing.assert_array_equal(got[r]["decode"], got[0]["decode"])
        for (w, i), (w0, i0) in zip(got[r]["routes"], got[0]["routes"]):
            np.testing.assert_array_equal(w, w0)
            np.testing.assert_array_equal(i, i0)
    assert len(got[0]["routes"]) == (cfg.num_layers * (1 + STEPS) if cfg.num_experts else 0)
    want_p, want_d = _jax_run(jmodel, jcfg, tokens, steps, got[0]["routes"] or None)
    tol = QUANT_TOL if quantize else DENSE_TOL
    _close(got[0]["prefill"], want_p, tol, "prefill")
    _close(got[0]["decode"], want_d, tol, "decode")


@pytest.mark.parametrize("case", ["toy2", "moe2"])
def test_count_collectives_matches_jax(pools, models, case):
    """One prefill forward's collectives on a rank: 2 all-reduces a layer
    (after o_proj and after down or the MoE block) and one vocab gather,
    their counts and bytes equal to JAX's psum and all_gather
    (`tests/test_profiling.py::test_count_collectives_matches_model`)."""
    cfg, jcfg, tp = _cfgs(case)
    jp, tree = models(case)
    jmodel = jax_shard_model(jp, jcfg, jax_make_mesh(tp=tp, dp=1), quantize=True)
    fwd = jax_forward_fn(jmodel, use_flash=False)
    tokens, steps = _tokens(cfg)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = jax_count_collectives(lambda p, t, q, c: fwd(p, t, q, c, jnp.int32(0)), jmodel.params,
                                 jnp.asarray(tokens), pos, jax_init_caches(jcfg, B, S + 4))
    pool = pools(tp)
    pool.run(tasks.build, tree, cfg, "quantize")
    counts = pool.run(tasks.forward, tokens, steps[:, :0])
    for c in counts:
        assert c["counts"] == {"all_reduce": want["psum"], "all_reduce_count": want["psum_count"],
                               "all_gather": want["all_gather"],
                               "all_gather_count": want["all_gather_count"]}, (c, want)
    assert want["psum_count"] == 2 * cfg.num_layers and want["all_gather_count"] == 1


def _stored(lin):
    return unpack_weights(lin.packed), lin.scales


@pytest.mark.parametrize("bits", [8, 4])
def test_shard_quantized_slices_stored_ints(pools, models, bits):
    """shard_quantized of a `quantize_params_tp(tp=2)` artifact, sliced in
    each rank without requantization: qkv and gate|up the rank's columns of
    the stored ints and scales, o_proj and down its rows with its row of the
    group scales (= per-channel scales), bit for bit; and equal to JAX's
    shard_quantized of JAX's artifact at the rank."""
    cfg, jcfg, tp = _cfgs("toy2")
    jp, tree = models("toy2")
    art = tp_reshard.quantize_params_tp(params_from_numpy(tree, device="cpu"), cfg, tp, bits=bits)
    jmodel = jax_tp.shard_quantized(jax_tp.quantize_params_tp(jp, jcfg, tp=tp, bits=bits), jcfg,
                                    jax_make_mesh(tp=tp, dp=1))
    from eetq_tpu_torch.dist.sharding import split_gateup_columns

    got = pools(tp).run(tasks.build, _quant_tree(art), cfg, "quantized")
    for r in range(tp):
        for i, lp in enumerate(art.layers):
            q, s = _stored(lp.qkv)
            np.testing.assert_array_equal(got[r][f"{i}.qkv"]["q"],
                                          split_qkv_columns(q, cfg, tp)[r].numpy())
            np.testing.assert_array_equal(got[r][f"{i}.qkv"]["s"],
                                          split_qkv_columns(s, cfg, tp)[r].numpy())
            q, s = _stored(lp.gateup)
            np.testing.assert_array_equal(got[r][f"{i}.gateup"]["q"],
                                          split_gateup_columns(q, tp)[r].numpy())
            for name in ("o_proj", "down"):
                q, s = _stored(getattr(lp, name))
                rows = q.shape[0] // tp
                np.testing.assert_array_equal(got[r][f"{i}.{name}"]["q"],
                                              q[r * rows:(r + 1) * rows].numpy())
                np.testing.assert_array_equal(got[r][f"{i}.{name}"]["s"], s[r].numpy())
        _same_leaves(got[r], jmodel, r)


def _quant_tree(params) -> dict:
    """A quantized port ModelParams as the numpy tree params_from_numpy takes."""
    def lin(ql):
        if isinstance(ql, DenseLinear):
            return {"weight": ql.weight.float().numpy()}
        return {"qweight": unpack_weights(ql.packed).numpy(), "scales": ql.scales.numpy(),
                "bits": ql.bits}

    return {"embed": params.embed.float().numpy(), "final_norm": params.final_norm.numpy(),
            "lm_head": None if params.lm_head is None else lin(params.lm_head),
            "layers": [{"input_norm": lp.input_norm.numpy(), "post_norm": lp.post_norm.numpy(),
                        **{n: lin(getattr(lp, n)) for n in ("qkv", "o_proj", "gateup", "down")}}
                       for lp in params.layers]}


def test_shard_from_checkpoint(pools, models, tmp_path):
    """`from_quantized(dir).shard(mesh)` of a tp = 2 checkpoint saved by
    `quantize(save_dir, tp=2)`: each rank's shard bit-equal to
    `shard_quantized` of the same loaded model (the stored ints sliced, the
    scales as the checkpoint holds them), and its forward equal."""
    cfg, _, tp = _cfgs("toy2")
    _, tree = models("toy2")
    EETQCausalLM(cfg, params_from_numpy(tree, device="cpu")).quantize(str(tmp_path), tp=tp)
    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM

    loaded = AutoEETQForCausalLM.from_quantized(str(tmp_path), device="cpu")
    assert loaded.tp == tp
    pool = pools(tp)
    want = pool.run(tasks.build, _quant_tree(loaded.params), cfg, "quantized")
    tokens, steps = _tokens(cfg)
    want_out = pool.run(tasks.forward, tokens, steps)
    got = pool.run(tasks.load_and_shard, str(tmp_path))
    got_out = pool.run(tasks.forward, tokens, steps)
    for r in range(tp):
        assert got[r].keys() == want[r].keys()
        for key in want[r]:
            for part, arr in (want[r][key] or {}).items():
                if arr is not None:
                    np.testing.assert_array_equal(got[r][key][part], arr, err_msg=f"{key} {part}")
        np.testing.assert_array_equal(got_out[r]["prefill"], want_out[r]["prefill"])
        np.testing.assert_array_equal(got_out[r]["decode"], want_out[r]["decode"])
