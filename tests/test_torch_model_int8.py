"""The port's second slice on the TOY preset against the JAX package, with
JAX's W8A16 parameters (int8 lm_head) carried across: W8A8 prefill logits,
teacher-forced decode logits over an int8 KV cache with the fused MLP
(`bench.py`'s decode configuration), and 8 greedy tokens of prefill +
`decode_loop(fused_mlp=True)` over an int8 cache. The JAX side runs its
Pallas kernels (w8a8, flash attention, fused MLP) in interpret mode and
decode attention through its einsum oracle.

Each logits check runs twice. Against JAX compiled with XLA's
`xla_allow_excess_precision` off, so that XLA rounds to bf16 wherever the
program says, the port's logits are bit-identical. Against JAX as it
compiles by default, XLA keeps some bf16 intermediates in f32 inside
fusions, so values reach the int8 quantizers (of the W8A8 activations and
of the cached K/V) unrounded; an int8 step (absmax/127) is two bf16 ulps
(absmax/256), so such a difference can come out as a whole step. Bounds
on logits of at most ~4, where one bf16 ulp is 2^-6:
- W8A16 prefill: the generate slice's `LOGIT_ATOL` (tests/test_torch_model.py);
- int8-KV decode: 2^-4 (the port is up to 3 ulps off default JAX);
- W8A8 prefill: 2^-3. JAX's own W8A8 prefill logits move by 0.086-0.109 on
  the prompts of seeds 1-3 when only its attention changes from the Pallas
  flash kernel to its einsum oracle (the port is 0.056-0.082 off).
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
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import init_caches
from test_torch_model import LOGIT_ATOL, jax_params_to_numpy

jax_gen = importlib.import_module("eetq_tpu.serve.generate")
port_gen = importlib.import_module("eetq_tpu_torch.serve.generate")

CFG = PRESETS["toy"]
JCFG = JAX_PRESETS["toy"]
B, S, STEPS = 2, 12, 8
KV8_LOGIT_ATOL = 2.0 ** -4
A8_LOGIT_ATOL = 2.0 ** -3


def _exact(fn, *args, **static):
    """`fn` (a jitted JAX function) compiled for `args` with XLA's excess
    precision off; returns the compiled callable, which takes the dynamic
    arguments only."""
    return fn.lower(*args, **static).compile(
        compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def models():
    jp = jax_quantize_params(
        jax_random_dense_params(JCFG, jax.random.PRNGKey(0)), quantize_lm_head=True
    )
    return jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(1).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def test_a8_prefill_logits_match_jax(models, prompt):
    jp, tp = models
    tokens, caches = jnp.asarray(prompt), jax_init_caches(JCFG, B, S + 1)
    lj, _ = jax_gen.prefill(jp, JCFG, tokens, caches, a8=True)
    lx, _ = _exact(jax_gen.prefill, jp, JCFG, tokens, caches, a8=True)(jp, tokens, caches)
    lt, _ = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                             init_caches(CFG, B, S + 1, device="cpu"),
                             a8=True)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lx))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=A8_LOGIT_ATOL)
    # and it is another answer than W8A16's
    lw, _ = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                             init_caches(CFG, B, S + 1, device="cpu"))
    assert not torch.equal(lt, lw)


@pytest.mark.parametrize("exact", [False, True])
def test_int8_kv_fused_mlp_decode_logits_match_jax(models, prompt, exact):
    jp, tp = models
    tokens = jnp.asarray(prompt)
    caches_j = jax_init_caches(JCFG, B, S + STEPS, dtype=jnp.int8)
    caches_t = init_caches(CFG, B, S + STEPS, dtype=torch.int8, device="cpu")
    if exact:
        logits_j, caches_j = _exact(jax_gen.prefill, jp, JCFG, tokens, caches_j)(
            jp, tokens, caches_j)
    else:
        logits_j, caches_j = jax_gen.prefill(jp, JCFG, tokens, caches_j)
    logits_t, caches_t = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(), caches_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0,
                               atol=0 if exact else LOGIT_ATOL)
    token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    step = None
    for i in range(STEPS):
        # both packages get JAX's greedy token, so one near-tie cannot cascade
        args = (jp, token[:, None], jnp.full((B, 1), S + i, jnp.int32), caches_j,
                jnp.int32(S + i))
        if exact:
            step = step or _exact(jax_forward, args[0], JCFG, *args[1:], fused_mlp=True)
            lj, caches_j = step(*args)
        else:
            lj, caches_j = jax_forward(args[0], JCFG, *args[1:], fused_mlp=True)
        lt, caches_t = port_gen.decode_step(
            tp, CFG, torch.from_numpy(np.array(token)).long()[:, None], S + i, caches_t,
            fused_mlp=True)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj[:, -1]), rtol=0,
                                   atol=0 if exact else KV8_LOGIT_ATOL,
                                   err_msg=f"decode step {i}")
        token = jnp.argmax(lj[:, -1], axis=-1).astype(jnp.int32)
    for c in caches_t:
        assert c.quantized and c.k.dtype == torch.int8


def test_bench_decode_greedy_tokens_match_jax(models, prompt):
    """prefill into an int8 cache, then decode_loop(fused_mlp=True): the
    configuration `bench.py` runs for a quantized model."""
    jp, tp = models
    lj, cj = jax_gen.prefill(jp, JCFG, jnp.asarray(prompt),
                             jax_init_caches(JCFG, B, S + STEPS, dtype=jnp.int8))
    first = jnp.argmax(lj, axis=-1).astype(jnp.int32)
    toks_j, _ = jax_gen.decode_loop(jp, JCFG, first, jnp.int32(S), cj, STEPS, fused_mlp=True)
    lt, ct = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                              init_caches(CFG, B, S + STEPS, dtype=torch.int8, device="cpu"))
    toks_t, _ = port_gen.decode_loop(tp, CFG, torch.argmax(lt, -1), S, ct, STEPS, fused_mlp=True)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    # generate(kv_dtype=int8) is the same path with the env's MLP choice
    gen = port_gen.generate(tp, CFG, torch.from_numpy(prompt).long(), STEPS, kv_dtype=torch.int8)
    assert gen.shape == (B, STEPS)
