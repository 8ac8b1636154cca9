"""Head dim 256 (gemma-7b) in the port against the JAX package on the CPU,
at toy size.

- The plain versions of the attention kernels at D = 256 against JAX's
  Pallas kernels in interpret mode: prefill flash-attention (causal, a
  window, ALiBi); the dense flash-decode, bf16 and int8, S = 1 and S > 1;
  the paged flash-decode, bf16 and int8, over a permuted table, equal to
  the dense plain version on the cache the pool was cut from.
- `max_query_rows` (a row block of the flash-decode: 64 rows a kv head at
  D <= 128, 32 at 256) and the decode plan's scratch at D = 256; the spec
  engine at D = 256 past one row block.
- A gemma-style toy at head dim 256 (tied head, unit-offset norms, the
  embedding multiplier, gelu; 2 layers, JAX's W8A16 parameters carried
  across): every prefill position's logits and teacher-forced decode steps
  against JAX's `forward`, and the paged engine's greedy tokens against
  JAX's paged engine.

Tolerances as tests/test_torch_families.py: kernel outputs KERNEL_ATOL =
2^-6 (a few bf16 ulps of |v| < 5: JAX's Pallas kernels round q * scale and
the unnormalised p to bf16 against a running max), logits LOGIT_ATOL = 2e-2
(about one bf16 ulp of the largest logit, summed in other orders).
"""

import dataclasses
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
from eetq_tpu_torch.kernels.autotune import decode_plan, max_query_rows
from eetq_tpu_torch.kernels.flash_attention import flash_attention
from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_int8,
    paged_flash_decode,
    paged_flash_decode_int8,
)
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import random_dense_params
from eetq_tpu_torch.models.transformer import forward_inner, init_caches
from eetq_tpu_torch.modules.attention import init_kv_cache, update_cache
from eetq_tpu_torch.modules.paged import init_paged_kv_cache, paged_insert_dense
from eetq_tpu_torch.ops import alibi as port_alibi
from eetq_tpu_torch.serve.engine import Engine
from test_torch_model import jax_params_to_numpy

jax_attn = importlib.import_module("eetq_tpu.modules.attention")

D, BS = 256, 128
KERNEL_ATOL = 2**-6
LOGIT_ATOL = 2e-2
# gemma-style toy: 2 heads of 256, a tied head, unit-offset norms, the
# embedding multiplier sqrt(hidden), GeGLU
GEMMA = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
             num_heads=2, num_kv_heads=2, head_dim=D, max_position=512, activation="gelu",
             tie_word_embeddings=True, embedding_multiplier=128 ** 0.5,
             rmsnorm_unit_offset=True, model_type="gemma")
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


def test_max_query_rows_by_head_dim():
    """A block's warps' states of 64 rows fit shared memory at D <= 128,
    of 32 at D = 256 (csrc/flash_decode.cuh, kMaxRowsOf): a row block."""
    assert [max_query_rows(d) for d in (64, 128, 256)] == [64, 64, 32]


def test_decode_plan_scratch_at_head_dim_256():
    """The plan's chunks do not depend on D; its scratch holds D + 2 floats
    a (chunk, query row)."""
    p128, p256 = decode_plan(8, 16, 1, 2048, 128), decode_plan(8, 16, 1, 2048, 256)
    assert (p256.chunk, p256.chunks, p256.counters) == (p128.chunk, p128.chunks, p128.counters)
    assert p256.floats == 8 * 16 * p256.chunks * 1 * (256 + 2)
    assert decode_plan(1, 16, 1, 256, 256).floats == 0  # one chunk: no scratch


@pytest.mark.parametrize("window,alibi", [(None, False), (48, False), (None, True)],
                         ids=["causal", "window", "alibi"])
def test_flash_attention_head256_matches_jax_kernel(window, alibi):
    """Prefill at D = 256 (the last query on the last key; causal also over
    a query block appended to a cache) against JAX's flash kernel."""
    hq, hkv = (4, 2) if not alibi else (3, 3)
    rng = np.random.default_rng(256 + (window or 0) + alibi)
    sj, st = _slopes(hq, alibi)
    for sq, skv in ((70, 70), (20, 90))[:1 if window or alibi else 2]:
        qj, qt = _both(rng.standard_normal((1, sq, hq, D)).astype(np.float32))
        kj, kt = _both(rng.standard_normal((1, skv, hkv, D)).astype(np.float32))
        vj, vt = _both(rng.standard_normal((1, skv, hkv, D)).astype(np.float32))
        want = jax_flash_attention(qj, kj, vj, causal=True, window=window, scale=D ** -0.5,
                                   interpret=True, slopes=sj)
        got = flash_attention(qt, kt, vt, window=window, slopes=st)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=KERNEL_ATOL,
                                   err_msg=f"sq={sq} skv={skv}")


def _dense_pair(rng, b, hkv, l, int8: bool):
    """The same [B, Hkv, L, D] cache in both packages."""
    kj, kt = _both(rng.standard_normal((b, l, hkv, D)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((b, l, hkv, D)).astype(np.float32))
    dtype = (torch.int8, jnp.int8) if int8 else (torch.bfloat16, jnp.bfloat16)
    cj = jax.jit(jax_attn.update_cache)(jax_attn.init_kv_cache(b, l, hkv, D, dtype=dtype[1]),
                                        kj, vj, jnp.int32(0))
    ct = update_cache(init_kv_cache(b, l, hkv, D, dtype=dtype[0], device="cpu"), kt, vt, 0)
    return cj, ct


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s", [1, 3])
def test_flash_decode_head256_matches_jax_kernel(int8, s):
    """Dense decode (S = 1) and verify (S = 3, token i at length - S + i) at
    D = 256, GQA 2, against JAX's flash_decode in interpret mode and its
    multi-query reference."""
    hq, hkv = 4, 2
    rng = np.random.default_rng(10 * s + int8)
    lengths = np.array([200, 30], np.int32)
    cj, ct = _dense_pair(rng, 2, hkv, 256, int8)
    qj, qt = _both(rng.standard_normal((2, s, hq, D)).astype(np.float32))
    want = jax_flash_decode(qj, cj, jnp.asarray(lengths), scale=D ** -0.5, block_l=128,
                            interpret=True)
    lt = torch.from_numpy(lengths)
    if int8:
        got = flash_decode_int8(qt, ct.k, ct.v, ct.k_scale, ct.v_scale, lt)
    else:
        got = flash_decode(qt, ct.k, ct.v, lt)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=KERNEL_ATOL)
    ref = jax.jit(jax_attn.attention_verify_ref, static_argnums=(3, 4))(
        qj, cj, jnp.asarray(lengths), None, D ** -0.5)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2**-7, atol=2**-8)


@pytest.mark.parametrize("int8,s", [(False, 1), (True, 4)], ids=["bf16-S1", "int8-S4"])
def test_paged_flash_decode_head256_matches_jax_kernel(int8, s):
    """Paged decode and verify at D = 256 over blocks permuted through the
    pool, against JAX's paged kernel in interpret mode; equal to the port's
    dense plain version on the cache the pool was cut from."""
    hq, hkv = 2, 2
    rng = np.random.default_rng(5 + int8)
    lengths = np.array([2 * BS + 17, 40], np.int32)
    maxb, nb = 3, 8
    cj_d, ct_d = _dense_pair(rng, 2, hkv, maxb * BS, int8)
    table = rng.permutation(nb)[:2 * maxb].reshape(2, maxb).astype(np.int32)
    dtype = (torch.int8, jnp.int8) if int8 else (torch.bfloat16, jnp.bfloat16)
    cj = jax_paged.init_paged_kv_cache(nb, BS, hkv, D, 2, maxb, dtype[1])
    cj = cj.__class__(**{**cj.__dict__, "table": jnp.asarray(table)})
    ct = init_paged_kv_cache(nb, BS, hkv, D, 2, maxb, dtype[0], device="cpu",
                             table=torch.from_numpy(table.copy()))
    for r in range(2):
        cj = jax_paged.paged_insert_dense(cj, cj_d, jnp.int32(r), jnp.asarray(table[r]), maxb)
        paged_insert_dense(ct, ct_d, r, torch.from_numpy(table[r]), maxb)
    lt = torch.from_numpy(lengths)
    qj, qt = _both(rng.standard_normal((2, s, hq, D)).astype(np.float32))
    want = jax_paged_flash_decode(qj, cj, jnp.asarray(lengths), scale=D ** -0.5, interpret=True)
    if int8:
        got = paged_flash_decode_int8(qt, ct.k, ct.v, ct.k_scale, ct.v_scale, ct.table, lt)
        dense = flash_decode_int8(qt, ct_d.k, ct_d.v, ct_d.k_scale, ct_d.v_scale, lt)
    else:
        got = paged_flash_decode(qt, ct.k, ct.v, ct.table, lt)
        dense = flash_decode(qt, ct_d.k, ct_d.v, lt)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=KERNEL_ATOL)
    assert torch.equal(got, dense)


@pytest.fixture(scope="module")
def gemma():
    """(port config, JAX config, JAX W8A16 params, the same carried across);
    the head is tied, so quantize_lm_head leaves it the bf16 table."""
    cfg, jcfg = ModelConfig(**GEMMA), JaxModelConfig(**GEMMA)
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0)),
                             quantize_lm_head=True)
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    assert jp.lm_head is None and tp.lm_head is None
    return cfg, jcfg, jp, tp


def test_gemma_toy_prefill_and_decode_logits_match_jax(gemma):
    """Every prefill position's logits, then teacher-forced decode steps on
    JAX's greedy tokens, against JAX's forward (flash prefill in interpret
    mode, the decode oracle)."""
    cfg, jcfg, jp, tp = gemma
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
                               err_msg="prefill")
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
                                   atol=LOGIT_ATOL, err_msg=f"decode step {i}")
        token = np.asarray(jnp.argmax(logits_j[:, -1], -1)).astype(np.int32)


def test_gemma_toy_paged_engine_greedy_tokens_equal_jax_paged_engine():
    """Three requests through two slots of a paged pool (blocks recycled):
    the port's paged engine gives JAX's paged engine's greedy tokens."""
    cfg, jcfg = ModelConfig(**GEMMA), JaxModelConfig(**GEMMA)
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0),
                                                     dtype=jnp.bfloat16))
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in (9, 20, 3)]
    kw = dict(max_batch=2, max_len=256, prompt_buckets=(32,), paged_blocks=7,
              paged_block_size=BS)
    je, pe = JaxEngine(jp, jcfg, **kw), Engine(tp, cfg, **kw)
    for eng in (je, pe):
        for p in prompts:
            eng.add_request(p, 6)
        eng.run()
    for uid, p in enumerate(prompts):
        assert pe.result(uid) == je.result(uid), p
    assert sorted(pe._free_blocks) == list(range(1, 7))


def test_spec_engine_refuses_more_than_32_query_rows_a_kv_head_at_head_dim_256():
    """Group 8 at D = 256: a verify of k + 1 = 4 tokens is 32 query rows a
    kv head, one row block; k = 4 is 40, two. The engine takes both, and its
    greedy tokens are those of the engine without speculation."""
    cfg = dataclasses.replace(ModelConfig(**GEMMA), num_heads=8, num_kv_heads=1)
    tp = random_dense_params(cfg, torch.Generator().manual_seed(0))
    prompt = [3, 9, 4, 3, 9, 4, 3, 9, 4, 3]
    want = None
    for k in (None, 3, 4):
        eng = Engine(tp, cfg, max_batch=1, max_len=64, decode_window=4, spec_ngram=k)
        assert eng.spec_ngram == k
        got = eng.generate_all([prompt], 10)
        want = want or got
        assert got == want, k
        assert (eng.spec_rounds > 0) == (k is not None)
