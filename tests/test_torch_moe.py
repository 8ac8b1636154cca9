"""The port's routed MoE against the JAX package on the CPU: the expert
gather and the token-grouped GEMM (JAX's Pallas kernels in interpret mode,
the port's plain versions), `moe_apply` in its three regimes, the toy-moe
model (prefill, teacher-forced decode, greedy tokens) and its engine.
Inputs are made from a numpy seed and handed to both packages.

Tolerance of the products: both sides multiply exact bf16 x int8 values,
sum in f32 and round once to bf16, so they differ only where another
summation order tips that rounding: one bf16 ulp (rtol 2^-7), plus an
absolute 1e-3 of the output scale for values near zero. Through a whole
MoE block three such roundings chain (gate|up, the gated hidden, down), so
the block's outputs are held to 2^-6 of the largest output.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.layout import pack_weights as jax_pack
from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.transformer import forward as jax_forward
from eetq_tpu.modules import moe as jax_moe
from eetq_tpu.modules.linear import DenseLinear as JaxDense
from eetq_tpu.modules.linear import QuantLinear as JaxQuant
from eetq_tpu.ops.moe import w8a16_expert_matmul as jax_expert_matmul
from eetq_tpu.ops.moe import w8a16_grouped_matmul as jax_grouped_matmul
from eetq_tpu.quant import symmetric_quantize as jax_quantize
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.layout.tiling import TILE, pack_weights, unpack_weights
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import (
    quantize_params,
    random_dense_params,
    random_quantized_params,
)
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.modules import moe as port_moe
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear
from eetq_tpu_torch.ops.moe import w8a16_expert_matmul, w8a16_grouped_matmul
from eetq_tpu_torch.serve.engine import Engine
from test_torch_model import jax_params_to_numpy

jax_gen = importlib.import_module("eetq_tpu.serve.generate")
port_gen = importlib.import_module("eetq_tpu_torch.serve.generate")

CFG = PRESETS["toy-moe"]
JCFG = JAX_PRESETS["toy-moe"]
H, I, E = 64, 96, 4  # a narrow bank for the op tests
B, S, STEPS = 2, 12, 8
# Logits of the toy-moe model (|logit| < 4, one bf16 ulp 2^-6) against JAX
# as XLA compiles it by default: see the logits test.
MOE_LOGIT_ATOL = 2.0 ** -4
BLOCK_TOL = 2.0 ** -6


def _close(t: torch.Tensor, j) -> None:
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), j, rtol=2**-7, atol=1e-3 * np.abs(j).max())


def _block_close(t: torch.Tensor, j) -> None:
    j = np.asarray(j, np.float32)
    err = np.abs(t.float().numpy() - j).max()
    assert err <= BLOCK_TOL * np.abs(j).max(), err


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _bank(rng, e, k, n):
    """A quantized [E, K, N] bank: (int8, scales) as numpy."""
    q, s = jax_quantize(jnp.asarray(rng.standard_normal((e, k, n)).astype(np.float32)))
    return np.asarray(q), np.asarray(s)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def moe_pair():
    """One quantized MoE block (router [H, E], gate|up [E, H, 2I], down
    [E, I, H]) as a JAX MoEMLP and the port's."""
    rng = np.random.default_rng(0)
    router = (rng.standard_normal((H, E)) / np.sqrt(H)).astype(np.float32)
    gu, gs = _bank(rng, E, H, 2 * I)
    dn, ds = _bank(rng, E, I, H)
    jm = jax_moe.MoEMLP(
        router=JaxDense(weight=jnp.asarray(router, jnp.bfloat16)),
        gateup=JaxQuant(qweight=jax_pack(jnp.asarray(gu)), scales=jnp.asarray(gs)),
        down=JaxQuant(qweight=jax_pack(jnp.asarray(dn)), scales=jnp.asarray(ds)),
    )
    tm = port_moe.MoEMLP(
        DenseLinear(torch.from_numpy(router).to(torch.bfloat16)),
        QuantLinear(pack_weights(_t(gu)), _t(gs)),
        QuantLinear(pack_weights(_t(dn)), _t(ds)),
    )
    return jm, tm


@pytest.mark.parametrize("m", [1, 4])
def test_expert_matmul_matches_jax(m):
    rng = np.random.default_rng(m)
    q, s = _bank(rng, 4, 192, 200)
    x_j, x_t = _bf16(rng.standard_normal((m, 192)).astype(np.float32))
    ids = np.array([0, 2, 2, 1, 3], np.int32)  # with a repeat
    out_j = jax_expert_matmul(x_j, jax_pack(jnp.asarray(q)), jnp.asarray(s), jnp.asarray(ids),
                              interpret=True)
    out_t = w8a16_expert_matmul(x_t, pack_weights(_t(q)), _t(s), _t(ids))
    assert out_t.shape == (5, m, 200) and out_t.dtype == torch.bfloat16
    _close(out_t, out_j)
    assert torch.equal(out_t[1], out_t[2])  # a repeated id gives the same product


@pytest.mark.parametrize("bm", [8, 128])
def test_grouped_matmul_matches_jax(bm):
    rng = np.random.default_rng(bm)
    q, s = _bank(rng, 4, 192, 256)
    be = np.array([0, 2, 2, 1, 3, 3], np.int32)  # the last block is padding: zero rows
    x = rng.standard_normal((len(be) * bm, 192)).astype(np.float32)
    x[-bm:] = 0.0
    x_j, x_t = _bf16(x)
    out_j = jax_grouped_matmul(x_j, jax_pack(jnp.asarray(q)), jnp.asarray(s), jnp.asarray(be),
                               interpret=True)
    out_t = w8a16_grouped_matmul(x_t, pack_weights(_t(q)), _t(s), _t(be))
    assert out_t.shape == (len(be) * bm, 256)
    _close(out_t, out_j)
    assert not out_t[-bm:].any()


def test_bank_ops_check_shapes():
    q = pack_weights(torch.zeros(2, 64, 32, dtype=torch.int8))
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a 2-D weight is not a bank
        w8a16_expert_matmul(x, pack_weights(torch.zeros(64, 32, dtype=torch.int8)),
                            torch.ones(2, 32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):  # K mismatch
        w8a16_expert_matmul(x[:, :56], q, torch.ones(2, 32), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):  # rows that do not divide into the blocks
        w8a16_grouped_matmul(x, q, torch.ones(2, 32), torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("regime,shape,use_kernel", [
    ("gather", (1, 1), True),  # n_sel 2 <= min(8, E)
    ("gather", (2, 1), True),  # n_sel 4
    ("masked scan (kernels)", (3, 1), True),  # n_sel 6: above E, not above 8
    ("grouped", (1, 17), True),  # n_sel 34 > 8
    ("grouped", (2, 40), True),  # n_sel 160: bm 40
    ("masked scan (plain)", (2, 9), False),
])
def test_moe_apply_matches_jax(moe_pair, regime, shape, use_kernel):
    jm, tm = moe_pair
    rng = np.random.default_rng(sum(shape))
    x_j, x_t = _bf16(rng.standard_normal((*shape, H)).astype(np.float32))
    tw_j, ti_j = jax_moe.route(jm.router, x_j.reshape(-1, H), 2)
    tw_t, ti_t = port_moe.route(tm.router, x_t.reshape(-1, H), 2)
    np.testing.assert_array_equal(ti_t.numpy(), np.asarray(ti_j))  # identical routing
    np.testing.assert_allclose(tw_t.numpy(), np.asarray(tw_j), rtol=1e-6, atol=1e-7)
    out_j = jax_moe.moe_apply(jm, x_j, 2, interpret=True, use_kernel=use_kernel)
    out_t = port_moe.moe_apply(tm, x_t, 2, use_kernel=use_kernel)
    assert out_t.shape == (*shape, H) and out_t.dtype == torch.bfloat16
    _block_close(out_t, out_j)
    # every regime agrees with the port's own plain path
    _block_close(out_t, port_moe.moe_apply(tm, x_t, 2, use_kernel=False).float().numpy())


def test_grouped_with_empty_experts_matches_plain(moe_pair):
    """A router that sends every token to experts 0 and 1: experts 2 and 3
    own no rows and no blocks, and the padding blocks clamp to expert 3."""
    _, tm = moe_pair
    rw = torch.zeros(H, E)
    rw[:, 0], rw[:, 1] = 5.0, 4.0
    skewed = port_moe.MoEMLP(DenseLinear(rw.to(torch.bfloat16)), tm.gateup, tm.down)
    x = torch.randn(1, 17, H, generator=torch.Generator().manual_seed(8)).abs().to(torch.bfloat16)
    got = port_moe.moe_apply(skewed, x, 2)
    want = port_moe.moe_apply(skewed, x, 2, use_kernel=False)
    _block_close(got, want.float().numpy())


def _routing(case: str) -> tuple[torch.Tensor, int]:
    """Seeded top-k ids [T, k] and the expert count E."""
    rng = np.random.default_rng(len(case))
    if case == "one expert takes all":
        return torch.full((40, 1), 2), 4
    e, t = (8, 8) if case == "engine step" else (8, 300)
    pool = np.array([0, 3, 5]) if case == "empty experts" else np.arange(e)
    ids = np.stack([rng.choice(pool, 2, replace=False) for _ in range(t)])
    return torch.from_numpy(ids), e


@pytest.mark.parametrize("case", ["seeded", "empty experts", "one expert takes all",
                                  "engine step"])
def test_group_selections_counts_the_real_blocks(case):
    """The count of real blocks that moe_grouped_combine hands the grouped
    GEMMs (which skip the blocks past it on the card) is the number of
    blocks holding a selection: those blocks come first, each holds rows of
    the expert it names, and every selection has a row of its own. The
    engine's 8-slot step is 16 selections at E = 8."""
    topi, e = _routing(case)
    n_sel = topi.numel()
    bm = port_moe._grouped_bm(n_sel, e)
    order, dest, block_expert, real = port_moe.group_selections(topi, e, bm)
    assert real.dtype == torch.int32 and real.shape == (1,)
    assert block_expert.shape == (n_sel // bm + e,)
    used = torch.unique(dest // bm).tolist()
    counts = np.bincount(topi.reshape(-1).numpy(), minlength=e)
    assert int(real) == len(used) == sum(-(-c // bm) for c in counts)
    assert used == list(range(int(real)))
    assert len(set(dest.tolist())) == n_sel
    assert torch.equal(block_expert[dest // bm].long(), topi.reshape(-1)[order])


def test_grouped_matmul_count_zeroes_the_padding_blocks():
    """With the count of real blocks, rows of the blocks past it come out
    zero (what their zero rows of x give on the main path) even where x is
    not zero there; the real rows do not change."""
    rng = np.random.default_rng(3)
    q, s = _bank(rng, 4, 192, 256)
    be = torch.tensor([0, 2, 2, 1, 3, 3], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((6 * 8, 192)).astype(np.float32)).to(torch.bfloat16)
    bank = pack_weights(_t(q))
    full = w8a16_grouped_matmul(x, bank, _t(s), be)
    counted = w8a16_grouped_matmul(x, bank, _t(s), be, torch.tensor([4], dtype=torch.int32))
    assert full[32:].any() and not counted[32:].any()
    assert torch.equal(counted[:32], full[:32])


@pytest.mark.parametrize("shape", [(1, 8), (2, 512)])  # 16 and 2048 selections
def test_moe_apply_matches_jax_at_engine_and_prompt_sizes(moe_pair, shape):
    """The grouped regime at the engine step's 16 selections (bm 8) and a
    prompt's 2048 (bm 128), the real-block count passed, against JAX."""
    jm, tm = moe_pair
    rng = np.random.default_rng(shape[1])
    x_j, x_t = _bf16(rng.standard_normal((*shape, H)).astype(np.float32))
    out_j = jax_moe.moe_apply(jm, x_j, 2, interpret=True)
    out_t = port_moe.moe_apply(tm, x_t, 2)
    _block_close(out_t, out_j)


def test_grouped_blocks_are_static():
    assert port_moe._grouped_bm(2048, 8) == 128  # a Mixtral prompt of 1024 tokens
    assert port_moe._grouped_bm(16, 8) == 8  # the engine's 8-slot decode
    assert port_moe._grouped_bm(34, 4) == 8 and port_moe._grouped_bm(160, 4) == 40


def test_moe_knobs_and_expert_bias_raise(moe_pair, monkeypatch):
    """An EETQ_MOE_GROUPED_BM the grouped GEMM cannot take raises, and so
    does a bank with expert biases."""
    _, tm = moe_pair
    for bad in ("12", "0", "136"):
        monkeypatch.setenv("EETQ_MOE_GROUPED_BM", bad)
        with pytest.raises(ValueError, match="EETQ_MOE_GROUPED_BM"):
            port_moe.moe_apply(tm, torch.zeros(1, 8, H, dtype=torch.bfloat16), 2)
    monkeypatch.delenv("EETQ_MOE_GROUPED_BM")
    dense = port_moe.MoEMLP(tm.router, DenseLinear(torch.zeros(E, H, 2 * I), torch.zeros(2 * I)),
                            DenseLinear(torch.zeros(E, I, H)))
    with pytest.raises(NotImplementedError):
        port_moe.quantize_moe(dense)


def test_pack_bank_pads_each_expert():
    q = torch.from_numpy(np.random.default_rng(0).integers(-128, 128, (3, 200, 72), np.int8))
    packed = pack_weights(q)
    assert packed.data.shape == (3, 256, 128) and (packed.k, packed.n) == (200, 72)
    assert not packed.data[:, 200:].any() and not packed.data[:, :, 72:].any()
    assert torch.equal(unpack_weights(packed), q)
    assert packed.data.shape[-1] % TILE == 0


@pytest.fixture(scope="module")
def models():
    jp = jax_quantize_params(jax_random_dense_params(JCFG, jax.random.PRNGKey(0)),
                             quantize_lm_head=True)
    return jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def test_moe_params_carried_across_exactly(models):
    jp, tp = models
    for lj, lt in zip(jp.layers, tp.layers):
        assert lt.gateup is None and lt.down is None
        for name in ("gateup", "down"):
            bank_j, bank_t = getattr(lj.moe, name), getattr(lt.moe, name)
            np.testing.assert_array_equal(unpack_weights(bank_t.packed).numpy(),
                                          np.asarray(jax.numpy.asarray(
                                              bank_j.qweight.data)[:, :bank_t.k, :bank_t.n]))
            np.testing.assert_array_equal(bank_t.scales.numpy(), np.asarray(bank_j.scales))
        np.testing.assert_array_equal(lt.moe.router.weight.float().numpy(),
                                      np.asarray(lj.moe.router.weight, np.float32))


@pytest.mark.parametrize("cfg_name", ["toy-moe", "toy"])
def test_layerwise_quantized_init_equals_quantize_params(cfg_name):
    cfg = PRESETS[cfg_name]
    want = quantize_params(random_dense_params(cfg, torch.Generator().manual_seed(3)),
                           quantize_lm_head=True)
    got = random_quantized_params(cfg, torch.Generator().manual_seed(3), quantize_lm_head=True)
    sw, sg = want.state_dict(), got.state_dict()
    assert sw.keys() == sg.keys()
    for name in sw:
        assert torch.equal(sw[name], sg[name]), name


def _exact(fn, *args, **static):
    """`fn` (a jitted JAX function) compiled with XLA's excess precision off
    (as in tests/test_torch_model_int8.py); takes the dynamic arguments."""
    return fn.lower(*args, **static).compile(
        compiler_options={"xla_allow_excess_precision": False})


@pytest.mark.parametrize("exact", [False, True])
def test_prefill_and_teacher_forced_decode_logits_match_jax(models, prompt, exact):
    """Prefill runs the grouped regime (24 selections), decode the gather
    (4), with the routing ids of both packages equal at every layer.
    Against JAX compiled to round to bf16 wherever the program says, the
    port's logits are bit-identical. As XLA compiles by default it keeps the
    gated hidden and the expert outputs in f32 inside fusions, which moves
    the toy-moe logits by up to 3 bf16 ulps of the largest (2^-6 each)."""
    jp, tp = models
    atol = 0 if exact else MOE_LOGIT_ATOL
    tokens, caches_j = jnp.asarray(prompt), jax_init_caches(JCFG, B, S + STEPS)
    prefill_j = _exact(jax_gen.prefill, jp, JCFG, tokens, caches_j) if exact else (
        lambda *a: jax_gen.prefill(a[0], JCFG, *a[1:]))
    logits_j, caches_j = prefill_j(jp, tokens, caches_j)
    logits_t, caches_t = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                                          init_caches(CFG, B, S + STEPS, device="cpu"))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=atol)
    token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    step = None
    for i in range(STEPS):
        # both packages get JAX's greedy token, so one near-tie cannot cascade
        args = (jp, token[:, None], jnp.full((B, 1), S + i, jnp.int32), caches_j,
                jnp.int32(S + i))
        if exact:
            step = step or _exact(jax_forward, args[0], JCFG, *args[1:])
            lj, caches_j = step(*args)
        else:
            lj, caches_j = jax_forward(args[0], JCFG, *args[1:])
        lt, caches_t = port_gen.decode_step(
            tp, CFG, torch.from_numpy(np.array(token)).long()[:, None], S + i, caches_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj[:, -1]), rtol=0, atol=atol,
                                   err_msg=f"decode step {i}")
        token = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)


def test_greedy_generate_matches_jax(models, prompt):
    jp, tp = models
    toks_j = np.asarray(jax_gen.generate(jp, JCFG, jnp.asarray(prompt), STEPS))
    toks_t = port_gen.generate(tp, CFG, torch.from_numpy(prompt).long(), STEPS)
    np.testing.assert_array_equal(toks_t.numpy(), toks_j)


def test_fused_mlp_decode_is_a_noop_on_moe_layers(models, prompt):
    _, tp = models
    p = torch.from_numpy(prompt).long()
    out = {}
    for fused in (False, True):
        caches = init_caches(CFG, B, S + STEPS, device="cpu")
        logits, caches = port_gen.prefill(tp, CFG, p, caches)
        out[fused], _ = port_gen.decode_loop(tp, CFG, torch.argmax(logits, -1), S, caches, STEPS,
                                             fused_mlp=fused)
    assert torch.equal(out[False], out[True])


def test_moe_engine_matches_jax_engine_and_generate(models):
    """Greedy requests through the JAX engine and the port's (CPU defaults:
    bf16 KV, W8A16 prefill): the same tokens, and the port's equal its own
    generate (as tests/test_moe.py::test_moe_engine_matches_generate)."""
    jp, tp = models
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, CFG.vocab_size, size=n)] for n in (10, 3, 7)]
    budgets = [8, 5, 6]
    je = JaxEngine(jp, JCFG, max_batch=2, max_len=64)
    te = Engine(tp, CFG, max_batch=2, max_len=64)
    for eng in (je, te):
        for p, n in zip(prompts, budgets):
            eng.add_request(p, n)
        eng.run()
    for uid, (p, n) in enumerate(zip(prompts, budgets)):
        assert te.result(uid) == je.result(uid), p
        assert te.result(uid) == port_gen.generate(tp, CFG, torch.tensor([p]), n)[0].tolist()


def test_moe_spec_engine_matches_jax_spec_engine(models):
    """`Engine(spec_ngram=3)` on the routed model (a verify of 4 tokens a
    row through `moe_apply`): the greedy tokens of `JaxEngine(spec_ngram=3)`
    on repeating prompts, where drafts are accepted."""
    jp, tp = models
    rng = np.random.default_rng(3)
    base = [int(t) for t in rng.integers(1, CFG.vocab_size, size=5)]
    prompts = [base * 3, [int(t) for t in rng.integers(1, CFG.vocab_size, size=7)]]
    kw = dict(max_batch=2, max_len=64, decode_window=4, spec_ngram=3)
    je, te = JaxEngine(jp, JCFG, **kw), Engine(tp, CFG, **kw)
    for eng in (je, te):
        for p in prompts:
            eng.add_request(p, 10)
        eng.run()
    for uid, p in enumerate(prompts):
        assert te.result(uid) == je.result(uid), p
    assert te.spec_rounds > 0


@pytest.mark.parametrize("knob,value,shape,regime", [
    ("EETQ_MOE_NO_GATHER", "1", (1, 1), "scan"),  # 2 selections: gather off
    ("EETQ_MOE_NO_GATHER", "1", (2, 9), "scan"),  # 36: the grouped GEMM off too
    ("EETQ_MOE_NO_GROUPED", "1", (2, 9), "scan"),
    ("EETQ_MOE_NO_GROUPED", "1", (1, 1), "gather"),  # decode shapes keep the gather
    ("EETQ_MOE_GROUPED_BM", "16", (2, 40), "grouped"),  # 160 selections at bm 16, not 40
    ("EETQ_MOE_GROUPED_BM", "128", (1, 17), "grouped"),  # 34 at bm 128, not 8
])
def test_moe_knobs_take_jaxs_branches(moe_pair, monkeypatch, knob, value, shape, regime):
    """Each A/B knob sends both packages down the same branch (the grouped
    GEMM, the gather, or the masked scan: JAX's expert kernel on one id in
    its scanned body, the port's dense kernels on each expert's slice), at
    the same rows per block, and the outputs agree."""
    jm, tm = moe_pair
    rng = np.random.default_rng(sum(shape) + len(knob))
    x_j, x_t = _bf16(rng.standard_normal((*shape, H)).astype(np.float32))
    calls = {}

    def counted(mod, name, key):
        """Record each call of mod.name: the expert kernels by how many ids
        they take (a gather all the selections, the scan's traced body one)."""
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls.setdefault(key, []).append(a[3].shape[0] if "expert" in key else 1)
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    counted(jax_moe, "moe_grouped_combine", "jax grouped")
    counted(jax_moe, "w8a16_expert_matmul", "jax expert")
    counted(port_moe, "moe_grouped_combine", "port grouped")
    counted(port_moe, "w8a16_expert_matmul", "port expert")
    counted(port_moe, "w8a16_matmul", "port dense")
    bms = []
    grouped_bm = port_moe._grouped_bm
    monkeypatch.setattr(port_moe, "_grouped_bm", lambda n, e: bms.append(grouped_bm(n, e)) or
                        bms[-1])
    monkeypatch.setenv(knob, value)
    out_j = jax_moe.moe_apply(jm, x_j, 2, interpret=True)
    out_t = port_moe.moe_apply(tm, x_t, 2)
    _block_close(out_t, out_j)
    n_sel = 2 * shape[0] * shape[1]
    want = {"grouped": {"jax grouped": [1], "port grouped": [1]},
            "gather": {"jax expert": [n_sel] * 2, "port expert": [n_sel] * 2},
            "scan": {"jax expert": [1, 1], "port dense": [1] * 2 * E}}[regime]
    if regime == "grouped":
        assert bms == [int(value)] and jax_moe._grouped_bm(shape[0] * shape[1] * 2, E) == bms[0]
    assert calls == want, calls
