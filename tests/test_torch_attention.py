"""The port's attention against the JAX package: prefill against the
Pallas flash-attention kernel (interpret mode on the CPU), decode against
`attention_decode_ref`, the in-place cache update against JAX's, and the
multi-query verify of speculative decoding against JAX's multi-query
`flash_decode` (interpret mode) and `attention_verify_ref`."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from eetq_tpu_torch.kernels.flash_attention import flash_attention
from eetq_tpu_torch.kernels.flash_decode import dequantize_kv, flash_decode
from eetq_tpu_torch.modules.attention import (
    attention,
    attention_decode,
    attention_prefill,
    attention_verify,
    init_kv_cache,
    update_cache,
)

# the module, not the function of the same name that `eetq_tpu.modules` exports
jax_attn = importlib.import_module("eetq_tpu.modules.attention")

B, HQ, HKV, D = 2, 4, 2, 32


def _both(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("s", [37, 64])
def test_attention_prefill_matches_jax_flash(s):
    """The flash path against JAX's flash kernel, the plain path against
    JAX's oracle. Both flash versions round q*scale and the unnormalised p
    to bf16, but the online softmax rounds p against a running max rather
    than the row max: a few bf16 ulps of |v| < 5 (atol 2^-6); the oracles
    differ in summation order only (one ulp, rtol 2^-7)."""
    rng = np.random.default_rng(s)
    q_j, q_t = _both(rng.standard_normal((B, s, HQ, D)).astype(np.float32))
    k_j, k_t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    v_j, v_t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    out_j = jax_flash_attention(q_j, k_j, v_j, causal=True, scale=D ** -0.5)
    out_t = attention_prefill(q_t, k_t, v_t)
    assert out_t.shape == (B, s, HQ, D) and out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(out_t.float().numpy(), _np(out_j), rtol=0, atol=2**-6)
    # the kernel wrapper on CPU tensors is the same plain version
    assert torch.equal(flash_attention(q_t, k_t, v_t), out_t)
    ref_j = jax_attn.attention_prefill(q_j, k_j, v_j, use_flash=False)
    ref_t = attention_prefill(q_t, k_t, v_t, use_flash=False)
    np.testing.assert_allclose(ref_t.float().numpy(), _np(ref_j), rtol=2**-7, atol=1e-3)


def test_attention_prefill_first_row_sees_only_itself():
    rng = np.random.default_rng(0)
    _, q = _both(rng.standard_normal((1, 5, HQ, D)).astype(np.float32))
    _, k = _both(rng.standard_normal((1, 5, HKV, D)).astype(np.float32))
    _, v = _both(rng.standard_normal((1, 5, HKV, D)).astype(np.float32))
    out = attention_prefill(q, k, v)
    # q head h reads kv head h // 2
    torch.testing.assert_close(out[0, 0], v[0, 0].repeat_interleave(HQ // HKV, dim=0),
                               rtol=0, atol=0)


def test_attention_decode_matches_jax_ref():
    """Both sides run an f32 softmax over the same bf16 cache: only the
    summation order differs, so one bf16 ulp (rtol 2^-7) bounds it."""
    rng = np.random.default_rng(7)
    l = 128
    lengths = np.array([5, 128], np.int32)
    q_j, q_t = _both(rng.standard_normal((B, 1, HQ, D)).astype(np.float32))
    k_j, k_t = _both(rng.standard_normal((B, HKV, l, D)).astype(np.float32))
    v_j, v_t = _both(rng.standard_normal((B, HKV, l, D)).astype(np.float32))
    out_j = jax_attn.attention_decode_ref(
        q_j, jax_attn.KVCache(k=k_j, v=v_j), jnp.asarray(lengths), None, D ** -0.5
    )
    cache = init_kv_cache(B, l, HKV, D, device="cpu")
    cache.k.copy_(k_t)
    cache.v.copy_(v_t)
    out_t = attention_decode(q_t, cache, torch.from_numpy(lengths))
    np.testing.assert_allclose(out_t.float().numpy(), _np(out_j), rtol=2**-7, atol=1e-3)
    # keys past each row's length do not matter
    cache.k[0, :, 5:] = 100.0
    assert torch.equal(attention_decode(q_t, cache, torch.from_numpy(lengths))[0], out_t[0])
    assert torch.equal(
        flash_decode(q_t, cache.k, cache.v, torch.from_numpy(lengths))[1], out_t[1]
    )


def test_init_kv_cache_rounds_to_128():
    cache = init_kv_cache(3, 130, HKV, D, device="cpu")
    assert cache.k.shape == (3, HKV, 256, D) and cache.max_len == 256
    assert cache.k.dtype == torch.bfloat16 and not cache.k.any()


@pytest.mark.parametrize("offset", [3, "per_row"])
def test_update_cache_matches_jax(offset):
    rng = np.random.default_rng(1)
    s = 4
    k_j, k_t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    v_j, v_t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    off = 3 if offset == 3 else np.array([0, 9], np.int32)
    cache_j = jax_attn.update_cache(jax_attn.init_kv_cache(B, 16, HKV, D), k_j, v_j,
                                    jnp.asarray(off))
    cache_t = init_kv_cache(B, 16, HKV, D, device="cpu")
    same = update_cache(cache_t, k_t, v_t, off if offset == 3 else torch.from_numpy(off))
    assert same is cache_t  # in place
    np.testing.assert_array_equal(cache_t.k.float().numpy(), _np(cache_j.k))
    np.testing.assert_array_equal(cache_t.v.float().numpy(), _np(cache_j.v))


def test_attention_prefill_then_decode_matches_jax():
    """The unified entry: prefill writes the cache and attends causally,
    decode appends one token and attends over the prefix."""
    rng = np.random.default_rng(3)
    s = 9
    xs = [rng.standard_normal((B, s + 1, h, D)).astype(np.float32) for h in (HQ, HKV, HKV)]
    (q_j, q_t), (k_j, k_t), (v_j, v_t) = (_both(x) for x in xs)
    cache_j = jax_attn.init_kv_cache(B, s + 1, HKV, D)
    cache_t = init_kv_cache(B, s + 1, HKV, D, device="cpu")
    outs_j, outs_t = [], []
    for sl, off in ((slice(0, s), 0), (slice(s, s + 1), s)):
        o_j, cache_j = jax_attn.attention(q_j[:, sl], k_j[:, sl], v_j[:, sl], cache_j, off)
        o_t, cache_t = attention(q_t[:, sl], k_t[:, sl], v_t[:, sl], cache_t, off)
        outs_j.append(_np(o_j))
        outs_t.append(o_t.float().numpy())
    np.testing.assert_array_equal(cache_t.k.float().numpy(), _np(cache_j.k))
    np.testing.assert_allclose(outs_t[0], outs_j[0], rtol=0, atol=2**-6)
    np.testing.assert_allclose(outs_t[1], outs_j[1], rtol=2**-7, atol=1e-3)
    # a prefill chunk at an int offset: written there, it attends over the
    # cached prefix (tests/test_torch_chunked_prefill.py holds it at length)
    o_j, cache_j = jax_attn.attention(q_j[:, :2], k_j[:, :2], v_j[:, :2], cache_j, 4)
    o_t, cache_t = attention(q_t[:, :2], k_t[:, :2], v_t[:, :2], cache_t, 4)
    np.testing.assert_array_equal(cache_t.k.float().numpy(), _np(cache_j.k))
    np.testing.assert_allclose(o_t.float().numpy(), _np(o_j), rtol=0, atol=2**-6)



# ---- the multi-query (S > 1) verify mode of speculative decoding ----

def _old_decode_ref(q, k, v, lengths, scale):
    """The plain decode attention before it took S > 1: every query row
    masked by pos < length (right for S = 1 only)."""
    b, s, hq, d = q.shape
    hkv, l = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,bkld->bkgsl", qg, k.float()) * scale
    mask = torch.arange(l).reshape(1, 1, 1, 1, l) < torch.as_tensor(lengths).reshape(-1, 1, 1, 1, 1)
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bkgsl,bkld->bskgd", probs, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def _verify_case(rng, s, hq, hkv, lengths, int8, l=128):
    """A query of S tokens a row and one cache in both packages (bf16, or
    quantized to int8 by each package's own writer from the same values)."""
    b = len(lengths)
    q_j, q_t = _both(rng.standard_normal((b, s, hq, D)).astype(np.float32))
    k_j, k_t = _both(rng.standard_normal((b, l, hkv, D)).astype(np.float32))
    v_j, v_t = _both(rng.standard_normal((b, l, hkv, D)).astype(np.float32))
    jdt, tdt = (jnp.int8, torch.int8) if int8 else (jnp.bfloat16, torch.bfloat16)
    # JAX quantizes inside its jitted forwards (tests/test_torch_kv_int8.py)
    cache_j = jax.jit(jax_attn.update_cache)(jax_attn.init_kv_cache(b, l, hkv, D, dtype=jdt),
                                             k_j, v_j, jnp.int32(0))
    cache_t = update_cache(init_kv_cache(b, l, hkv, D, device="cpu", dtype=tdt), k_t, v_t, 0)
    return q_j, q_t, cache_j, cache_t


VERIFY_CASES = [(2, 4, 2, [5, 128]), (3, 4, 4, [3, 70]), (8, 8, 2, [9, 64, 127])]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("s,hq,hkv,lengths", VERIFY_CASES, ids=["S2-gqa", "S3-mha", "S8-gqa"])
def test_multiquery_decode_ref_matches_jax(s, hq, hkv, lengths, int8):
    """The plain flash-decode with S > 1 query tokens is per-row causal
    (token i at length - S + i): against JAX's multi-query `flash_decode`
    (interpret mode) and its `attention_verify_ref`, per-row lengths, GQA,
    bf16 and int8 caches. The decode mask it had before (every token sees
    the whole prefix) is far off. One bf16 ulp against the oracle, a few
    against the Pallas kernel (it rounds q * scale and p to bf16)."""
    from eetq_tpu.kernels.flash_decode import flash_decode as jax_flash_decode

    rng = np.random.default_rng(s + hq)
    q_j, q_t, cache_j, cache_t = _verify_case(rng, s, hq, hkv, lengths, int8)
    lens = np.array(lengths, np.int32)
    got = attention_verify(q_t, cache_t, torch.from_numpy(lens))
    assert got.shape == (len(lengths), s, hq, D)
    oracle = jax_attn.attention_verify_ref(q_j, cache_j, jnp.asarray(lens), None, D ** -0.5)
    np.testing.assert_allclose(got.float().numpy(), _np(oracle), rtol=2**-7, atol=2**-8)
    kern = jax_flash_decode(q_j, cache_j, jnp.asarray(lens), scale=D ** -0.5, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), _np(kern), rtol=0, atol=2**-6)
    k, v = cache_t.k, cache_t.v
    if int8:
        k, v = dequantize_kv(k, cache_t.k_scale), dequantize_kv(v, cache_t.v_scale)
    old = _old_decode_ref(q_t, k, v, lens, D ** -0.5)
    assert (old.float() - got.float()).abs().max() > 0.1


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_single_query_decode_ref_unchanged(int8):
    """S = 1 results are those of the decode mask, bit for bit."""
    rng = np.random.default_rng(4)
    _, q_t, _, cache_t = _verify_case(rng, 1, 8, 2, [1, 77, 128], int8)
    lens = torch.tensor([1, 77, 128], dtype=torch.int32)
    k, v = cache_t.k, cache_t.v
    if int8:
        k, v = dequantize_kv(k, cache_t.k_scale), dequantize_kv(v, cache_t.v_scale)
    assert torch.equal(attention_decode(q_t, cache_t, lens), _old_decode_ref(q_t, k, v, lens,
                                                                             D ** -0.5))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_multiquery_rows_equal_sequential_single_queries(int8):
    """Token i of an S-token call against an S = 1 call at length - S + i + 1
    on the same cache (the plain versions: one bf16 ulp; the CUDA kernel is
    held to bit-equality in tests/test_torch_gpu.py); a token that sees no
    key gives zeros, as the kernels do."""
    rng = np.random.default_rng(5)
    s = 5
    _, q_t, _, cache_t = _verify_case(rng, s, 8, 2, [64, 6, 3], int8)
    lens = torch.tensor([64, 6, 3], dtype=torch.int32)
    out = attention_verify(q_t, cache_t, lens)
    for i in range(s):
        one = attention_decode(q_t[:, i:i + 1], cache_t, (lens - s + i + 1).clamp(min=0))
        keep = (lens - s + i + 1) > 0
        torch.testing.assert_close(out[keep, i:i + 1], one[keep], rtol=2**-7, atol=2**-8)
        assert not out[~keep, i].any()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_attention_verify_writes_and_attends_as_jax(int8):
    """`attention(verify=True)`: S tokens a row written at per-row offsets
    and attended causally, the cache and the output as JAX's."""
    rng = np.random.default_rng(6)
    s, l = 4, 128
    off = np.array([9, 60], np.int32)
    q_j, q_t, cache_j, cache_t = _verify_case(rng, s, HQ, HKV, [l, l], int8, l)
    k_j, k_t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    v_j, v_t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    o_j, cache_j = jax.jit(jax_attn.attention, static_argnames=("verify", "decode_kernel"))(
        q_j, k_j, v_j, cache_j, jnp.asarray(off), verify=True, decode_kernel=False)
    o_t, same = attention(q_t, k_t, v_t, cache_t, torch.from_numpy(off), verify=True)
    assert same is cache_t
    np.testing.assert_array_equal(cache_t.k.float().numpy(), _np(cache_j.k))
    if int8:
        np.testing.assert_array_equal(cache_t.k_scale.numpy(), np.asarray(cache_j.k_scale))
    np.testing.assert_allclose(o_t.float().numpy(), _np(o_j), rtol=2**-7, atol=2**-8)
