"""The port's int4 slice on the TOY preset against the JAX package: JAX's
int4 parameters (per-channel, and group-wise with g = 64; the lm_head
quantized the same way) are carried across as unpacked values with
`params_from_numpy` and packed by the port's own layout. Compared: prefill
and teacher-forced decode logits over a bf16 cache, the `bench.py` decode
configuration (int8 KV and the fused int4 MLP, per-channel), W4A8 prefill,
greedy tokens, and the `Engine` with W4A8 prefill against the JAX engine.
The JAX side runs its Pallas kernels in interpret mode and decode attention
through its einsum oracle.

Tolerances, on logits of up to 4.4 (one bf16 ulp is 2^-5 above 4, 2^-6
below). The int4 kernels of the two packages round apart by an ulp here and
there (see tests/test_torch_int4.py), and 2 layers carry that on:
- W4A16 prefill and decode over a bf16 cache: 2^-5, one ulp of the largest
  logit (the port is 0.016-0.023 off);
- int8-KV decode with the fused MLP: 2^-3 (an ulp that reaches the cache's
  quantizer can come out as a whole int8 step, two ulps);
- W4A8 prefill: 2^-3, as for W8A8 (tests/test_torch_model_int8.py), since an
  ulp that reaches a projection's activation quantizer comes out as a step.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.transformer import forward as jax_forward
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.layout.tiling import unpack_weights
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import (
    quantize_params,
    random_dense_params,
    random_quantized_params,
)
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.modules.linear import QuantLinear
from eetq_tpu_torch.ops.mlp import can_fuse_mlp
from eetq_tpu_torch.serve.engine import Engine
from test_torch_model import jax_params_to_numpy

jax_gen = importlib.import_module("eetq_tpu.serve.generate")
port_gen = importlib.import_module("eetq_tpu_torch.serve.generate")

CFG = PRESETS["toy"]
JCFG = JAX_PRESETS["toy"]
B, S, STEPS = 2, 12, 8
GROUPS = [None, 64]
W4A16_ATOL = 2.0 ** -5
KV8_ATOL = 2.0 ** -3
A8_ATOL = 2.0 ** -3


@pytest.fixture(scope="module")
def models():
    dense = jax_random_dense_params(JCFG, jax.random.PRNGKey(0))
    out = {}
    for g in GROUPS:
        jp = jax_quantize_params(dense, bits=4, quantize_lm_head=True, group_size=g)
        out[g] = jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return out


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("group", GROUPS)
def test_int4_params_carried_across(models, group):
    jp, tp = models[group]
    assert isinstance(tp.lm_head, QuantLinear) and tp.lm_head.bits == 4
    for lj, lt in zip(jp.layers, tp.layers):
        for name in ("qkv", "o_proj", "gateup", "down"):
            lin = lt.get_submodule(name)
            assert lin.bits == 4 and lin.qweight.shape[0] * 2 == lin.packed.kp
            assert lin.scales.dim() == (1 if group is None else 2)
            np.testing.assert_array_equal(lin.scales.numpy(),
                                          np.asarray(getattr(lj, name).scales))
            q = unpack_weights(lin.packed)
            assert int(q.min()) >= -8 and int(q.max()) <= 7


@pytest.mark.parametrize("group", GROUPS)
def test_w4a16_prefill_and_decode_logits_match_jax(models, prompt, group):
    jp, tp = models[group]
    logits_j, caches_j = jax_gen.prefill(jp, JCFG, jnp.asarray(prompt),
                                         jax_init_caches(JCFG, B, S + STEPS))
    logits_t, caches_t = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                                          init_caches(CFG, B, S + STEPS, device="cpu"))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=W4A16_ATOL)
    token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        # both packages get JAX's greedy token, so one near-tie cannot cascade
        logits_j, caches_j = jax_gen.decode_step(jp, JCFG, token[:, None], jnp.int32(S + i),
                                                 caches_j)
        logits_t, caches_t = port_gen.decode_step(
            tp, CFG, torch.from_numpy(np.array(token)).long()[:, None], S + i, caches_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0,
                                   atol=W4A16_ATOL, err_msg=f"decode step {i}")
        token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)


@pytest.mark.parametrize("group", GROUPS)
def test_w4a8_prefill_logits_match_jax(models, prompt, group):
    jp, tp = models[group]
    lj, _ = jax_gen.prefill(jp, JCFG, jnp.asarray(prompt), jax_init_caches(JCFG, B, S + 1),
                            a8=True)
    lt, _ = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                             init_caches(CFG, B, S + 1, device="cpu"),
                             a8=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=A8_ATOL)
    lw, _ = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                             init_caches(CFG, B, S + 1, device="cpu"))
    assert not torch.equal(lt, lw)  # int8 activations are another answer than W4A16's


def test_int8_kv_fused_int4_mlp_decode_logits_match_jax(models, prompt):
    """`EETQ_BENCH_BITS=4 bench.py`'s decode configuration: int4 per-channel
    layers, int8 KV, fused MLP. (The toy's I = 256 is below what the JAX
    package fuses for int4, so its side runs the MLP unfused: the same
    function.)"""
    jp, tp = models[None]
    assert can_fuse_mlp(tp.layers[0].gateup, tp.layers[0].down, B)
    caches_j = jax_init_caches(JCFG, B, S + STEPS, dtype=jnp.int8)
    caches_t = init_caches(CFG, B, S + STEPS, dtype=torch.int8, device="cpu")
    logits_j, caches_j = jax_gen.prefill(jp, JCFG, jnp.asarray(prompt), caches_j)
    logits_t, caches_t = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(), caches_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=W4A16_ATOL)
    token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        lj, caches_j = jax_forward(jp, JCFG, token[:, None], jnp.full((B, 1), S + i, jnp.int32),
                                   caches_j, jnp.int32(S + i), fused_mlp=True)
        lt, caches_t = port_gen.decode_step(
            tp, CFG, torch.from_numpy(np.array(token)).long()[:, None], S + i, caches_t,
            fused_mlp=True)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj[:, -1]), rtol=0, atol=KV8_ATOL,
                                   err_msg=f"decode step {i}")
        token = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)
    # the fused op and the unfused layers are the same function in the port
    lu, _ = port_gen.decode_step(tp, CFG, torch.from_numpy(np.array(token)).long()[:, None],
                                 S + STEPS - 1, caches_t, fused_mlp=False)
    assert lu.shape == lt.shape


@pytest.mark.parametrize("group", GROUPS)
def test_int4_greedy_generate_runs_and_agrees_with_jax_logits(models, prompt, group):
    """Greedy tokens: equal to JAX's wherever JAX's own top-1/top-2 gap is
    above twice the logit tolerance (an int4 toy model has near-ties, where
    either token is right); the port's tokens follow its own prefill."""
    jp, tp = models[group]
    toks_t = port_gen.generate(tp, CFG, torch.from_numpy(prompt).long(), STEPS)
    assert toks_t.shape == (B, STEPS)
    lt, _ = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                             init_caches(CFG, B, S + STEPS, device="cpu"))
    assert torch.equal(toks_t[:, 0], torch.argmax(lt, -1))
    lj, _ = jax_gen.prefill(jp, JCFG, jnp.asarray(prompt), jax_init_caches(JCFG, B, S + STEPS))
    top2 = np.sort(np.asarray(lj), axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * W4A16_ATOL
    np.testing.assert_array_equal(toks_t[:, 0].numpy()[clear],
                                  np.asarray(jnp.argmax(lj, -1))[clear])


@pytest.mark.parametrize("group", GROUPS)
def test_engine_w4a8_prefill_matches_its_own_prefill_and_decode(models, group):
    _, tp = models[group]
    prompts, budgets = [[5, 6, 7], [11] * 10, [1, 2], [99, 42, 7, 7, 7, 7]], [6, 3, 9, 5]
    eng = Engine(tp, CFG, max_batch=4, max_len=64, prompt_buckets=(4, 16), a8_prefill=True,
                 kv_dtype=torch.int8)
    uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
    eng.run()
    for uid, p, n in zip(uids, prompts, budgets):
        caches = init_caches(CFG, 1, len(p) + n, dtype=torch.int8, device="cpu")
        logits, caches = port_gen.prefill(tp, CFG, torch.tensor([p]), caches, a8=True)
        want, _ = port_gen.decode_loop(tp, CFG, torch.argmax(logits, -1), len(p), caches, n)
        assert eng.result(uid) == want[0].tolist(), (p, n)


@pytest.mark.parametrize("group", GROUPS)
def test_engine_w4a8_first_tokens_match_jax_engine(models, group):
    """The same requests through the JAX engine (W4A8 prefill, its kernels in
    interpret mode) and the port's: each request's tokens agree up to the
    first step at which JAX's greedy choice is a near-tie; the first token of
    every request with a clear gap is equal."""
    jp, tp = models[group]
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, CFG.vocab_size, size=rng.integers(2, 14))]
               for _ in range(6)]
    je = JaxEngine(jp, JCFG, max_batch=4, max_len=64, prompt_buckets=(8, 16), a8_prefill=True,
                   kv_dtype=jnp.bfloat16)
    te = Engine(tp, CFG, max_batch=4, max_len=64, prompt_buckets=(8, 16), a8_prefill=True,
                kv_dtype=torch.bfloat16)
    for eng in (je, te):
        for p in prompts:
            eng.add_request(p, 4)
        eng.run()
    agree = sum(te.result(u)[0] == je.result(u)[0] for u in range(len(prompts)))
    for u, p in enumerate(prompts):
        lj, _ = jax_gen.prefill(jp, JCFG, jnp.asarray([p]), jax_init_caches(JCFG, 1, len(p) + 1),
                                a8=True)
        top2 = np.sort(np.asarray(lj), axis=-1)[0, -2:]
        if top2[1] - top2[0] > 2 * A8_ATOL:
            assert te.result(u)[0] == je.result(u)[0], p
    assert agree >= len(prompts) - 2


@pytest.mark.parametrize("group", GROUPS)
def test_port_int4_random_init_and_quantize(group):
    gen = torch.Generator().manual_seed(0)
    dense = random_dense_params(CFG, gen)
    q = quantize_params(dense, bits=4, quantize_lm_head=True, group_size=group)
    assert q.layers[0].qkv.bits == 4 and q.lm_head.bits == 4
    assert q.layers[0].down.scales.shape == ((CFG.hidden_size,) if group is None
                                             else (CFG.intermediate_size // group,
                                                   CFG.hidden_size))
    assert quantize_params(dense, bits=4).lm_head is dense.lm_head  # stays dense by default
    # built layer by layer: the same draws, the same model
    lazy = random_quantized_params(CFG, torch.Generator().manual_seed(0), quantize_lm_head=True,
                                   bits=4, group_size=group)
    for a, b in zip(q.buffers(), lazy.buffers()):
        assert torch.equal(a, b)
    logits, _ = port_gen.prefill(q, CFG, torch.zeros(1, 4, dtype=torch.long),
                                 init_caches(CFG, 1, 8, device="cpu"))
    assert logits.shape == (1, CFG.vocab_size) and torch.isfinite(logits).all()
    # bench.py's int4 model: int4 layers, an int8 lm_head
    mixed = quantize_params(dense, bits=4)
    mixed.lm_head = quantize_params(dense, quantize_lm_head=True).lm_head
    assert mixed.lm_head.bits == 8 and mixed.layers[0].gateup.bits == 4


def test_int4_moe_banks_run_on_the_plain_path():
    """int4 and group-wise expert banks: quantized and run by the plain
    versions on the CPU (the MoE kernels take int8 per-channel banks)."""
    cfg = PRESETS["toy-moe"]
    dense = random_dense_params(cfg, torch.Generator().manual_seed(0))
    q = quantize_params(dense, bits=4, group_size=64)
    bank = q.layers[0].moe.gateup
    assert bank.bits == 4 and bank.qweight.dim() == 3 and bank.scales.dim() == 3
    for s in (1, 9):  # the gather and the grouped regime
        logits, _ = port_gen.prefill(q, cfg, torch.zeros(1, s, dtype=torch.long),
                                     init_caches(cfg, 1, 16, device="cpu"))
        ref, _ = port_gen.prefill(q, cfg, torch.zeros(1, s, dtype=torch.long),
                                  init_caches(cfg, 1, 16, device="cpu"), use_kernels=False)
        assert torch.isfinite(logits).all()
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=0, atol=W4A16_ATOL)
