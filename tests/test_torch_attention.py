"""The port's attention against the JAX package: prefill against the
Pallas flash-attention kernel (interpret mode on the CPU), decode against
`attention_decode_ref`, and the in-place cache update against JAX's."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from eetq_tpu_torch.kernels.flash_attention import flash_attention
from eetq_tpu_torch.kernels.flash_decode import flash_decode
from eetq_tpu_torch.modules.attention import (
    attention,
    attention_decode,
    attention_prefill,
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
    with pytest.raises(NotImplementedError):
        attention(q_t[:, :2], k_t[:, :2], v_t[:, :2], cache_t, 4)  # chunked prefill

