"""The attention variants of four model families against the JAX package on
the CPU, at toy size: a sliding window (mistral), ALiBi over a head count
that is not a power of two (baichuan-13b), GQA group 7 with a qkv bias
(qwen2) and group 16 with the interleaved half rope and a qkv bias
(chatglm3).

- `ops/alibi.py::alibi_slopes` bit-identical to JAX's for 1..64 heads.
- The plain versions of the kernels with `window` and `slopes`
  (flash-attention; flash-decode dense bf16 and int8, S = 1 and S > 1;
  paged bf16 and int8) against JAX's Pallas kernels in interpret mode.
- Each family's toy model (JAX's W8A16 parameters carried across): the
  prefill logits of every position and teacher-forced decode steps against
  JAX's `forward`, and the paged engine's greedy tokens against JAX's paged
  engine (window and ALiBi).
- `Engine(spec_ngram=k)` at group 16 with k = 4 and 7 (80 and 128 query
  rows a kv head, past one row block of the flash-decode) against
  `JaxEngine(spec_ngram=k)`.

Tolerances. Kernel outputs: as tests/test_torch_paged.py, JAX's Pallas
kernels round q * scale and the unnormalised p to bf16 against a running
max: a few bf16 ulps of |v| < 5, atol 2^-6. Logits: the bf16 outputs of the
int8 lm_head, rounded at the same bf16 boundaries and summed in other
orders, about one ulp of the largest logit (LOGIT_ATOL, as
tests/test_torch_model.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from eetq_tpu.kernels.flash_decode import flash_decode as jax_flash_decode
from eetq_tpu.kernels.flash_decode import paged_flash_decode as jax_paged_flash_decode
from eetq_tpu.models import ModelConfig as JaxModelConfig
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.transformer import forward as jax_forward
from eetq_tpu.modules import paged as jax_paged
from eetq_tpu.ops.alibi import alibi_slopes as jax_alibi_slopes
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.kernels.flash_attention import flash_attention
from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_int8,
    paged_flash_decode,
    paged_flash_decode_int8,
)
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import forward_inner, init_caches
from eetq_tpu_torch.modules.attention import init_kv_cache, update_cache
from eetq_tpu_torch.modules.paged import init_paged_kv_cache, paged_insert_dense
from eetq_tpu_torch.ops import alibi as port_alibi
from eetq_tpu_torch.serve.engine import Engine
from test_torch_model import jax_params_to_numpy

jax_attn = importlib.import_module("eetq_tpu.modules.attention")

D, BS = 32, 128
WINDOW = 8  # the window toy's: shorter than its prompts
KERNEL_ATOL = 2**-6
LOGIT_ATOL = 2e-2
# the attention variants, (q heads, kv heads, window, ALiBi)
VARIANTS = {"window": (4, 2, 48, False), "alibi": (5, 5, None, True),
            "group7": (14, 2, None, False), "group16": (16, 1, None, False),
            "window+alibi": (6, 3, 48, True)}

BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
            max_position=512)
FAMILIES = {
    "window": dict(num_heads=4, num_kv_heads=2, head_dim=32, sliding_window=WINDOW,
                   model_type="mistral"),
    "alibi": dict(num_heads=5, num_kv_heads=5, head_dim=32, alibi=True, model_type="baichuan"),
    "group7": dict(num_heads=7, num_kv_heads=1, head_dim=16, qkv_bias=True,
                   rope_theta=1e6, rms_eps=1e-6, model_type="qwen2"),
    "group16": dict(num_heads=16, num_kv_heads=1, head_dim=16, rope_dim=8,
                    rope_interleaved=True, qkv_bias=True, model_type="chatglm"),
}
B, S, STEPS = 2, 12, 4


def _both(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _slopes(hq: int, alibi: bool):
    if not alibi:
        return None, None
    return jnp.asarray(jax_alibi_slopes(hq)), port_alibi.alibi_slopes_cache(hq, "cpu")


@pytest.mark.parametrize("n", range(1, 65))
def test_alibi_slopes_bit_identical_to_jax(n):
    got = port_alibi.alibi_slopes(n)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, jax_alibi_slopes(n))
    np.testing.assert_array_equal(port_alibi.alibi_slopes_cache(n, "cpu").numpy(), got)


def test_alibi_slopes_built_once_per_heads_and_device():
    port_alibi._shared_slopes.cache_clear()
    a = port_alibi.alibi_slopes_cache(40, "cpu")
    assert port_alibi.alibi_slopes_cache(40, torch.device("cpu")) is a
    assert port_alibi.alibi_slopes_cache(32, "cpu") is not a
    assert port_alibi._shared_slopes.cache_info().misses == 2
    with pytest.raises(ValueError):
        port_alibi.alibi_slopes(0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_flash_attention_variants_match_jax_kernel(variant):
    """Prefill (causal, the last query on the last key) under the window
    and ALiBi, any group; the window also over a query block appended to a
    cache."""
    hq, hkv, window, alibi = VARIANTS[variant]
    rng = np.random.default_rng(len(variant))
    sj, st = _slopes(hq, alibi)
    for sq, skv in ((70, 70), (20, 90))[:2 if window else 1]:
        qj, qt = _both(rng.standard_normal((1, sq, hq, D)).astype(np.float32))
        kj, kt = _both(rng.standard_normal((1, skv, hkv, D)).astype(np.float32))
        vj, vt = _both(rng.standard_normal((1, skv, hkv, D)).astype(np.float32))
        want = jax_flash_attention(qj, kj, vj, causal=True, window=window, scale=D ** -0.5,
                                   interpret=True, slopes=sj)
        got = flash_attention(qt, kt, vt, window=window, slopes=st)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=KERNEL_ATOL,
                                   err_msg=f"{variant} sq={sq} skv={skv}")


def _dense_pair(rng, b, hkv, l, lengths, int8: bool):
    """The same [B, Hkv, L, D] cache in both packages, filled below each
    row's length (positions past it hold garbage neither may read)."""
    kj, kt = _both(rng.standard_normal((b, l, hkv, D)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((b, l, hkv, D)).astype(np.float32))
    dtype = (torch.int8, jnp.int8) if int8 else (torch.bfloat16, jnp.bfloat16)
    cj = jax.jit(jax_attn.update_cache)(jax_attn.init_kv_cache(b, l, hkv, D, dtype=dtype[1]),
                                        kj, vj, jnp.int32(0))
    ct = update_cache(init_kv_cache(b, l, hkv, D, dtype=dtype[0], device="cpu"), kt, vt, 0)
    return cj, ct


@pytest.mark.parametrize("int8,s", [(False, 1), (True, 3)], ids=["bf16-S1", "int8-S3"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_flash_decode_variants_match_jax_kernel(variant, int8, s):
    """Dense decode (S = 1) and verify (S = 3, token i at length - S + i)
    under the window and ALiBi, any group: rows shorter and longer than the
    window, against JAX's multi-query flash_decode in interpret mode."""
    hq, hkv, window, alibi = VARIANTS[variant]
    rng = np.random.default_rng(7 * s + len(variant))
    lengths = np.array([200, 30], np.int32)
    cj, ct = _dense_pair(rng, 2, hkv, 256, lengths, int8)
    qj, qt = _both(rng.standard_normal((2, s, hq, D)).astype(np.float32))
    sj, st = _slopes(hq, alibi)
    want = jax_flash_decode(qj, cj, jnp.asarray(lengths), window=window, scale=D ** -0.5,
                            block_l=128, interpret=True, slopes=sj)
    lt = torch.from_numpy(lengths)
    if int8:
        got = flash_decode_int8(qt, ct.k, ct.v, ct.k_scale, ct.v_scale, lt, window=window,
                                slopes=st)
    else:
        got = flash_decode(qt, ct.k, ct.v, lt, window=window, slopes=st)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=KERNEL_ATOL)
    ref = jax.jit(jax_attn.attention_verify_ref, static_argnums=(3, 4))(
        qj, cj, jnp.asarray(lengths), window, D ** -0.5, slopes=sj)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2**-7, atol=2**-8)


@pytest.mark.parametrize("int8,s", [(False, 1), (True, 4)], ids=["bf16-S1", "int8-S4"])
@pytest.mark.parametrize("variant", ["window", "alibi"])
def test_paged_flash_decode_variants_match_jax_kernel(variant, int8, s):
    """Paged decode and verify over blocks permuted through the pool,
    against JAX's paged Pallas kernel in interpret mode; equal to the
    port's dense plain version on the cache the pool was cut from."""
    hq, hkv, window, alibi = VARIANTS[variant]
    rng = np.random.default_rng(3 + len(variant))
    lengths = np.array([3 * BS + 17, 40], np.int32)
    maxb, nb = 4, 12
    cj_d, ct_d = _dense_pair(rng, 2, hkv, maxb * BS, lengths, int8)
    table = rng.permutation(nb)[:2 * maxb].reshape(2, maxb).astype(np.int32)
    dtype = (torch.int8, jnp.int8) if int8 else (torch.bfloat16, jnp.bfloat16)
    cj = jax_paged.init_paged_kv_cache(nb, BS, hkv, D, 2, maxb, dtype[1])
    cj = cj.__class__(**{**cj.__dict__, "table": jnp.asarray(table)})
    ct = init_paged_kv_cache(nb, BS, hkv, D, 2, maxb, dtype[0], device="cpu",
                             table=torch.from_numpy(table.copy()))
    for r in range(2):
        cj = jax_paged.paged_insert_dense(cj, cj_d, jnp.int32(r), jnp.asarray(table[r]), maxb)
        paged_insert_dense(ct, ct_d, r, torch.from_numpy(table[r]), maxb)
    sj, st = _slopes(hq, alibi)
    lt = torch.from_numpy(lengths)
    qj, qt = _both(rng.standard_normal((2, s, hq, D)).astype(np.float32))
    want = jax_paged_flash_decode(qj, cj, jnp.asarray(lengths), window=window, scale=D ** -0.5,
                                  interpret=True, slopes=sj)
    if int8:
        got = paged_flash_decode_int8(qt, ct.k, ct.v, ct.k_scale, ct.v_scale, ct.table, lt,
                                      window=window, slopes=st)
        dense = flash_decode_int8(qt, ct_d.k, ct_d.v, ct_d.k_scale, ct_d.v_scale, lt,
                                  window=window, slopes=st)
    else:
        got = paged_flash_decode(qt, ct.k, ct.v, ct.table, lt, window=window, slopes=st)
        dense = flash_decode(qt, ct_d.k, ct_d.v, lt, window=window, slopes=st)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=KERNEL_ATOL)
    assert torch.equal(got, dense)


def _configs(family: str):
    dims = dict(BASE, **FAMILIES[family])
    return ModelConfig(**dims), JaxModelConfig(**dims)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(name, port config, JAX config, JAX W8A16 params with an int8
    lm_head, the same carried across to the port)."""
    cfg, jcfg = _configs(request.param)
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0)),
                             quantize_lm_head=True)
    return request.param, cfg, jcfg, jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


def test_family_prefill_and_decode_logits_match_jax(family):
    """Every position's prefill logits (S = 12, longer than the window toy's
    window of 8), then teacher-forced decode steps on JAX's greedy tokens,
    against JAX's forward (flash prefill in interpret mode, the decode
    oracle)."""
    name, cfg, jcfg, jp, tp = family
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    caches_j = jax_init_caches(jcfg, B, S + STEPS)
    fwd = jax.jit(jax_forward, static_argnums=1)
    logits_j, caches_j = fwd(jp, jcfg, jnp.asarray(prompt), jnp.asarray(pos), caches_j, 0)
    caches_t = init_caches(cfg, B, S + STEPS, device="cpu")
    with torch.inference_mode():
        logits_t, _ = forward_inner(tp, cfg, torch.from_numpy(prompt).long(),
                                    torch.from_numpy(pos.copy()).long(), caches_t, 0)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=LOGIT_ATOL,
                               err_msg=f"{name} prefill")
    token = np.asarray(jnp.argmax(logits_j[:, -1], -1)).astype(np.int32)
    for i in range(STEPS):
        p = np.full((B, 1), S + i, np.int32)
        logits_j, caches_j = fwd(jp, jcfg, jnp.asarray(token[:, None]), jnp.asarray(p), caches_j,
                                 jnp.int32(S + i))
        with torch.inference_mode():
            logits_t, _ = forward_inner(tp, cfg, torch.from_numpy(token[:, None]).long(),
                                        torch.from_numpy(p).long(), caches_t,
                                        torch.full((B,), S + i))
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"{name} decode step {i}")
        token = np.asarray(jnp.argmax(logits_j[:, -1], -1)).astype(np.int32)


@pytest.mark.parametrize("name", ["window", "alibi"])
def test_paged_engine_greedy_tokens_equal_jax_paged_engine(name):
    """Four requests longer than the window toy's window through two slots
    of a paged pool (blocks recycled): the port's paged engine gives JAX's
    paged engine's greedy tokens."""
    cfg, jcfg = _configs(name)
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0),
                                                     dtype=jnp.bfloat16))
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in (9, 20, 14, 3)]
    kw = dict(max_batch=2, max_len=256, prompt_buckets=(32,), paged_blocks=7,
              paged_block_size=BS)
    je, pe = JaxEngine(jp, jcfg, **kw), Engine(tp, cfg, **kw)
    for eng in (je, pe):
        for p in prompts:
            eng.add_request(p, 10)
        eng.run()
    for uid, p in enumerate(prompts):
        assert pe.result(uid) == je.result(uid), (name, p)
    assert sorted(pe._free_blocks) == list(range(1, 7))


def test_spec_engine_refuses_more_than_64_query_rows_a_kv_head():
    """Group 16: a verify of k + 1 tokens is 80 (k = 4) or 128 (k = 7) query
    rows a kv head, past one row block of the flash-decode (64). The engine
    no longer refuses them: as JAX's, it takes every k in [1, 7], its greedy
    tokens those of `JaxEngine(spec_ngram=k)` on a repeating prompt, where
    drafts match."""
    cfg, jcfg = _configs("group16")
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    for k in (4, 7):
        rng = np.random.default_rng(k)
        base = [int(t) for t in rng.integers(1, cfg.vocab_size, size=6)]
        prompts = [base * 3, [int(t) for t in rng.integers(1, cfg.vocab_size, size=9)]]
        kw = dict(max_batch=2, max_len=96, prompt_buckets=(32,), decode_window=4, spec_ngram=k)
        je, pe = JaxEngine(jp, jcfg, **kw), Engine(tp, cfg, **kw)
        assert pe.spec_ngram == k
        for eng in (je, pe):
            for p in prompts:
                eng.add_request(p, 12)
            eng.run()
        for uid, p in enumerate(prompts):
            assert pe.result(uid) == je.result(uid), (k, p)
        assert pe.spec_rounds > 0
