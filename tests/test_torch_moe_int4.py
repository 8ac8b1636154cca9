"""The port's routed MoE over int4 and group-wise expert banks against the
JAX package on the CPU: the expert gather and the token-grouped GEMM (JAX's
Pallas kernels in interpret mode, the port's plain versions), `moe_apply` in
its three regimes, and the toy-moe model quantized by JAX to int4 with
64-row scale groups, carried across as unpacked values: prefill and
teacher-forced decode logits, greedy tokens, and the engine (dense and paged)
against the JAX engine. Inputs are made from a numpy seed and handed to both
packages.

Tolerances. The bank products: JAX's int4 kernel multiplies by biased
nibbles and corrects in f32, the port by the exact values; both sum exact
products in f32 in other orders and round once to bf16: four bf16 ulps
(2^-8 each) of the largest output, as tests/test_torch_int4.py. A whole MoE
block chains three such roundings: 2^-6 of the largest output, as
tests/test_torch_moe.py. Logits of the toy-moe model (|logit| < 4, one bf16
ulp 2^-6) through 2 layers of int4 kernels that round an ulp apart: 2^-4,
the bound tests/test_torch_moe.py holds the int8 model to.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.layout import pack_weights as jax_pack
from eetq_tpu.layout import unpack_weights as jax_unpack
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
from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
from eetq_tpu_torch.kernels.w8a16 import (
    w4a16_expert_gemv,
    w4a16_grouped_gemm,
    w8a16_expert_gemv,
    w8a16_grouped_gemm,
)
from eetq_tpu_torch.layout.tiling import pack_weights, unpack_weights
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
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
H, I, E = 128, 192, 4  # a narrow bank for the op tests; both divide by 64
B, S, STEPS = 2, 12, 6
GROUP = 64
# (bits, group size) of the banks the two MoE kernels newly take
MODES = [(4, None), (4, GROUP), (8, GROUP)]
MODE_IDS = ["int4", "int4-g64", "int8-g64"]
LOGIT_ATOL = 2.0 ** -4
BLOCK_TOL = 2.0 ** -6


def _close(t: torch.Tensor, j, ulps: int = 4) -> None:
    j = np.asarray(jnp.asarray(j, jnp.float32))
    np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                               atol=ulps * 2.0 ** -8 * np.abs(j).max())


def _block_close(t: torch.Tensor, j) -> None:
    j = np.asarray(jnp.asarray(j, jnp.float32))
    err = np.abs(t.float().numpy() - j).max()
    assert err <= BLOCK_TOL * np.abs(j).max(), err


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bank(rng, e, k, n, bits, group):
    """A quantized [E, K, N] bank (values one per int8, scales [E, N] or
    [E, K/g, N]) as JAX's and the port's packed weights and scales."""
    q, s = jax_quantize(jnp.asarray(rng.standard_normal((e, k, n)).astype(np.float32)),
                        bits=bits, group_size=group)
    assert s.shape == ((e, n) if group is None else (e, k // group, n))
    return (jax_pack(q, bits=bits), s), (pack_weights(_t(q), bits=bits), _t(s))


@pytest.mark.parametrize("bits,group", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("m", [1, 4])
def test_expert_matmul_matches_jax(m, bits, group):
    rng = np.random.default_rng(m + bits)
    (qj, sj), (qt, st) = _bank(rng, 4, 192, 200, bits, group)
    x_j, x_t = _bf16(rng.standard_normal((m, 192)).astype(np.float32))
    ids = np.array([0, 2, 2, 1, 3], np.int32)  # with a repeat
    out_j = jax_expert_matmul(x_j, qj, sj, jnp.asarray(ids), interpret=True)
    reset_launch_counts()
    out_t = w8a16_expert_matmul(x_t, qt, st, _t(ids))
    assert out_t.shape == (5, m, 200) and out_t.dtype == torch.bfloat16
    _close(out_t, out_j)
    assert torch.equal(out_t[1], out_t[2])  # a repeated id gives the same product
    assert not any(launch_counts().values())  # CPU tensors: the plain version
    # the wrapper of the bank's bit width on the packed data is the same call
    kernel = w4a16_expert_gemv if bits == 4 else w8a16_expert_gemv
    assert torch.equal(kernel(x_t, qt.data, st, _t(ids), 200), out_t)


@pytest.mark.parametrize("bits,group", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("bm", [8, 128])
def test_grouped_matmul_matches_jax(bm, bits, group):
    rng = np.random.default_rng(bm + bits)
    (qj, sj), (qt, st) = _bank(rng, 4, 192, 256, bits, group)
    be = np.array([0, 2, 2, 1, 3, 3], np.int32)  # the last block is padding: zero rows
    x = rng.standard_normal((len(be) * bm, 192)).astype(np.float32)
    x[-bm:] = 0.0
    x_j, x_t = _bf16(x)
    out_j = jax_grouped_matmul(x_j, qj, sj, jnp.asarray(be), interpret=True)
    out_t = w8a16_grouped_matmul(x_t, qt, st, _t(be))
    assert out_t.shape == (len(be) * bm, 256)
    _close(out_t, out_j)
    assert not out_t[-bm:].any()
    kernel = w4a16_grouped_gemm if bits == 4 else w8a16_grouped_gemm
    assert torch.equal(kernel(x_t, qt.data, st, _t(be), 256), out_t)


def test_bank_ops_check_group_shapes():
    q = pack_weights(torch.zeros(2, 128, 32, dtype=torch.int8), bits=4)
    x = torch.zeros(3, 128, dtype=torch.bfloat16)
    ids = torch.zeros(1, dtype=torch.int32)
    assert q.data.shape == (2, 64, 128) and q.kp == 128
    with pytest.raises(ValueError, match="divide K"):  # 3 scale rows over K = 128
        w8a16_expert_matmul(x, q, torch.ones(2, 3, 32), ids)
    with pytest.raises(ValueError, match=r"\[E, N\] or \[E, G, N\]"):
        w8a16_grouped_matmul(x[:2], q, torch.ones(32), ids)
    assert w8a16_expert_matmul(x, q, torch.ones(2, 2, 32), ids).shape == (1, 3, 32)


@pytest.fixture(scope="module", params=MODES, ids=MODE_IDS)
def moe_pair(request):
    """One quantized MoE block (router [H, E], gate|up [E, H, 2I], down
    [E, I, H]) as a JAX MoEMLP and the port's."""
    bits, group = request.param
    rng = np.random.default_rng(0)
    router = (rng.standard_normal((H, E)) / np.sqrt(H)).astype(np.float32)
    (guj, gsj), (gut, gst) = _bank(rng, E, H, 2 * I, bits, group)
    (dnj, dsj), (dnt, dst) = _bank(rng, E, I, H, bits, group)
    jm = jax_moe.MoEMLP(router=JaxDense(weight=jnp.asarray(router, jnp.bfloat16)),
                        gateup=JaxQuant(qweight=guj, scales=gsj),
                        down=JaxQuant(qweight=dnj, scales=dsj))
    tm = port_moe.MoEMLP(DenseLinear(torch.from_numpy(router).to(torch.bfloat16)),
                         QuantLinear(gut, gst), QuantLinear(dnt, dst))
    return jm, tm


@pytest.mark.parametrize("regime,shape,use_kernel", [
    ("gather", (1, 1), True),  # n_sel 2 <= min(8, E)
    ("masked scan (kernels)", (3, 1), True),  # n_sel 6: above E, not above 8
    ("grouped", (2, 20), True),  # n_sel 80: bm 16
    ("masked scan (plain)", (2, 9), False),
])
def test_moe_apply_matches_jax(moe_pair, regime, shape, use_kernel):
    jm, tm = moe_pair
    rng = np.random.default_rng(sum(shape))
    x_j, x_t = _bf16(rng.standard_normal((*shape, H)).astype(np.float32))
    _, ti_j = jax_moe.route(jm.router, x_j.reshape(-1, H), 2)
    _, ti_t = port_moe.route(tm.router, x_t.reshape(-1, H), 2)
    np.testing.assert_array_equal(ti_t.numpy(), np.asarray(ti_j))  # identical routing
    out_t = port_moe.moe_apply(tm, x_t, 2, use_kernel=use_kernel)
    assert out_t.shape == (*shape, H) and out_t.dtype == torch.bfloat16
    # JAX's plain scan over group-wise banks is a bf16 einsum that XLA's CPU
    # backend refuses; there the port's plain path is held to JAX's kernels
    if not use_kernel and tm.gateup.scales.dim() == 3:
        use_kernel = True
    _block_close(out_t, jax_moe.moe_apply(jm, x_j, 2, interpret=True, use_kernel=use_kernel))
    # every regime agrees with the port's own plain path
    _block_close(out_t, port_moe.moe_apply(tm, x_t, 2, use_kernel=False).float().numpy())


def test_quantize_moe_int4_groups_equals_jax():
    """The port's own quantizer on a bf16 bank gives JAX's int4 group-wise
    values and scales."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((E, H, 2 * I)).astype(np.float32)
    d = rng.standard_normal((E, I, H)).astype(np.float32)
    r = np.zeros((H, E), np.float32)
    tm = port_moe.quantize_moe(port_moe.MoEMLP(
        DenseLinear(_t(r).to(torch.bfloat16)), DenseLinear(_t(w).to(torch.bfloat16)),
        DenseLinear(_t(d).to(torch.bfloat16))), bits=4, group_size=GROUP)
    jm = jax_moe.quantize_moe(jax_moe.MoEMLP(
        router=JaxDense(weight=jnp.asarray(r, jnp.bfloat16)),
        gateup=JaxDense(weight=jnp.asarray(w, jnp.bfloat16)),
        down=JaxDense(weight=jnp.asarray(d, jnp.bfloat16))), bits=4, group_size=GROUP)
    for name in ("gateup", "down"):
        bt, bj = getattr(tm, name), getattr(jm, name)
        assert bt.bits == 4 and bt.scales.shape == bj.scales.shape
        assert bt.scales.shape[1] == bt.k // GROUP
        np.testing.assert_array_equal(bt.scales.numpy(), np.asarray(bj.scales))
        np.testing.assert_array_equal(
            unpack_weights(bt.packed).numpy(),
            np.asarray(jax_unpack(bj.qweight)))


@pytest.fixture(scope="module")
def models():
    jp = jax_quantize_params(jax_random_dense_params(JCFG, jax.random.PRNGKey(0)), bits=4,
                             quantize_lm_head=True, group_size=GROUP)
    return jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def test_int4_moe_params_carried_across_exactly(models):
    jp, tp = models
    for lj, lt in zip(jp.layers, tp.layers):
        for name in ("gateup", "down"):
            bank_j, bank_t = getattr(lj.moe, name), getattr(lt.moe, name)
            assert bank_t.bits == 4 and bank_t.qweight.dim() == 3
            assert bank_t.qweight.shape[1] * 2 == bank_t.packed.kp
            assert bank_t.scales.shape == (CFG.num_experts, bank_t.k // GROUP, bank_t.n)
            np.testing.assert_array_equal(bank_t.scales.numpy(), np.asarray(bank_j.scales))
            q = unpack_weights(bank_t.packed)
            assert q.shape == (CFG.num_experts, bank_t.k, bank_t.n)
            assert int(q.min()) >= -8 and int(q.max()) <= 7
        assert lt.qkv.bits == 4 and lt.qkv.scales.dim() == 2


def test_port_quantize_params_builds_int4_group_banks():
    p = quantize_params(random_dense_params(CFG, torch.Generator().manual_seed(0)), bits=4,
                        group_size=GROUP)
    bank = p.layers[0].moe.down
    assert bank.bits == 4 and bank.scales.shape == (4, CFG.intermediate_size // GROUP,
                                                    CFG.hidden_size)
    logits, _ = port_gen.prefill(p, CFG, torch.zeros(1, 9, dtype=torch.long),
                                 init_caches(CFG, 1, 16, device="cpu"))
    plain, _ = port_gen.prefill(p, CFG, torch.zeros(1, 9, dtype=torch.long),
                                init_caches(CFG, 1, 16, device="cpu"), use_kernels=False)
    assert torch.isfinite(logits).all()
    assert (logits - plain).abs().max() <= LOGIT_ATOL


def test_prefill_and_teacher_forced_decode_logits_match_jax(models, prompt):
    """Prefill runs the grouped regime (24 selections), decode the gather
    (4), over int4 g=64 banks."""
    jp, tp = models
    logits_j, caches_j = jax_gen.prefill(jp, JCFG, jnp.asarray(prompt),
                                         jax_init_caches(JCFG, B, S + STEPS))
    logits_t, caches_t = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                                          init_caches(CFG, B, S + STEPS, device="cpu"))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=LOGIT_ATOL)
    token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        # both packages get JAX's greedy token, so one near-tie cannot cascade
        lj, caches_j = jax_forward(jp, JCFG, token[:, None], jnp.full((B, 1), S + i, jnp.int32),
                                   caches_j, jnp.int32(S + i))
        lt, caches_t = port_gen.decode_step(
            tp, CFG, torch.from_numpy(np.array(token)).long()[:, None], S + i, caches_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj[:, -1]), rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"decode step {i}")
        token = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)


def test_greedy_generate_matches_jax(models, prompt):
    jp, tp = models
    toks_j = np.asarray(jax_gen.generate(jp, JCFG, jnp.asarray(prompt), STEPS))
    toks_t = port_gen.generate(tp, CFG, torch.from_numpy(prompt).long(), STEPS)
    np.testing.assert_array_equal(toks_t.numpy(), toks_j)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int4_moe_engine_matches_jax_engine_and_generate(models, paged):
    """Greedy requests through the JAX engine and the port's, over the dense
    cache and over a paged pool: the same tokens, and the port's equal its
    own generate."""
    jp, tp = models
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, CFG.vocab_size, size=n)] for n in (10, 3, 7)]
    budgets = [8, 5, 6]
    kw = dict(max_batch=2, max_len=256, prompt_buckets=(32,))
    if paged:
        kw.update(paged_blocks=5, paged_block_size=128)
    je = JaxEngine(jp, JCFG, **kw)
    te = Engine(tp, CFG, **kw)
    for eng in (je, te):
        for p, n in zip(prompts, budgets):
            eng.add_request(p, n)
        eng.run()
    for uid, (p, n) in enumerate(zip(prompts, budgets)):
        assert te.result(uid) == je.result(uid), p
        assert te.result(uid) == port_gen.generate(tp, CFG, torch.tensor([p]), n)[0].tolist()
