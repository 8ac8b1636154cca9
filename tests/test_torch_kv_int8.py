"""The port's int8 KV cache against the JAX package: the per-(head, token)
quantizer and the cache contents after `update_cache` bit-identical to
JAX's (at an int offset and at per-row [B] offsets), and decode attention
over an int8 cache against JAX's `attention_decode_ref`.

JAX runs `_quantize_kv` inside its jitted forwards, where XLA folds the
division of the absmax by 127 into a multiply by the f32 reciprocal; the
tests hold the port to that compiled form (`jax.jit`).

Decode tolerance: both sides dequantize in bf16 and attend in f32, and
differ only in summation order: one bf16 ulp of the output (rtol 2^-7,
atol 2^-8 for values near zero).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu_torch.kernels.flash_decode import dequantize_kv
from eetq_tpu_torch.kernels.w8a8 import quantize_activations
from eetq_tpu_torch.modules.attention import attention, init_kv_cache, update_cache

jax_attn = importlib.import_module("eetq_tpu.modules.attention")

B, HQ, HKV, D, L = 2, 4, 2, 32, 128


def _both(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_quantize_kv_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, HKV, 9, D)).astype(np.float32) * 2
    x[0, 0, 0] = 0.0  # zero row
    # exact .5 ties: absmax 127 makes the scale 1
    x[1, 1, 3, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    xj, xt = _both(x)
    qj, sj = jax.jit(jax_attn._quantize_kv)(xj)
    qt, st = quantize_activations(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt[1, 1, 3, 1:6].tolist() == [0, 2, 2, 0, -2]
    np.testing.assert_array_equal(_np(dequantize_kv(qt, st)),
                                  _np(jax_attn._dequantize_kv(qj, sj)))


def _assert_caches_equal(ct, cj):
    assert ct.quantized and cj.quantized
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(getattr(ct, name)), _np(getattr(cj, name)), name)


def test_init_int8_cache():
    c = init_kv_cache(B, 100, HKV, D, dtype=torch.int8, device="cpu")
    assert c.quantized and c.k.dtype == torch.int8 and c.k.shape == (B, HKV, L, D)
    assert c.k_scale.shape == (B, HKV, L) and c.k_scale.dtype == torch.float32
    assert not init_kv_cache(B, 100, HKV, D, device="cpu").quantized


@pytest.mark.parametrize("s", [1, 7])
def test_update_cache_int_and_row_offsets(s):
    rng = np.random.default_rng(s)
    update = jax.jit(jax_attn.update_cache)
    cj = jax_attn.init_kv_cache(B, L, HKV, D, dtype=jnp.int8)
    ct = init_kv_cache(B, L, HKV, D, dtype=torch.int8, device="cpu")
    # int offset (every row at one position), then per-row offsets
    for offset in (5, np.array([20, 61], np.int32)):
        kj, kt = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
        vj, vt = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
        off_t = offset if isinstance(offset, int) else torch.from_numpy(offset)
        cj = update(cj, kj, vj, jnp.asarray(offset))
        assert update_cache(ct, kt, vt, off_t) is ct  # in place
        _assert_caches_equal(ct, cj)


@pytest.mark.parametrize("length", [9, 40])
def test_decode_over_int8_cache_matches_jax(length):
    """Prefill `length - 1` tokens into both caches, then one decode step:
    the port's decode (the int8 flash-decode wrapper's plain version on the
    CPU) against JAX's `attention_decode_ref` on its int8 cache."""
    rng = np.random.default_rng(length)
    s = length - 1
    q0j, q0t = _both(rng.standard_normal((B, s, HQ, D)).astype(np.float32))
    k0j, k0t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    v0j, v0t = _both(rng.standard_normal((B, s, HKV, D)).astype(np.float32))
    cj = jax_attn.init_kv_cache(B, L, HKV, D, dtype=jnp.int8)
    ct = init_kv_cache(B, L, HKV, D, dtype=torch.int8, device="cpu")
    pj, cj = jax.jit(jax_attn.attention, static_argnames=("use_flash",))(
        q0j, k0j, v0j, cj, 0, use_flash=False)
    pt, ct = attention(q0t, k0t, v0t, ct, 0, use_kernels=False)
    # prefill attends over the unquantized new K/V; only the cache is int8
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=2**-7, atol=2**-8)
    _assert_caches_equal(ct, cj)
    q1j, q1t = _both(rng.standard_normal((B, 1, HQ, D)).astype(np.float32))
    k1j, k1t = _both(rng.standard_normal((B, 1, HKV, D)).astype(np.float32))
    v1j, v1t = _both(rng.standard_normal((B, 1, HKV, D)).astype(np.float32))
    oj, cj = jax.jit(jax_attn.attention)(q1j, k1j, v1j, cj, jnp.asarray([s, s], jnp.int32))
    for use in (True, False):
        c = init_kv_cache(B, L, HKV, D, dtype=torch.int8, device="cpu")
        attention(q0t, k0t, v0t, c, 0, use_kernels=use)
        ot, c = attention(q1t, k1t, v1t, c, torch.tensor([s, s]), use_kernels=use)
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=2**-7, atol=2**-8)
    _assert_caches_equal(c, cj)
