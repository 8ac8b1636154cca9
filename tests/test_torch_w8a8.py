"""The port's W8A8 path against the JAX package: per-token activation
quantization and the plain W8A8 product bit-identical to JAX's, the port's
`w8a8_matmul` against JAX's Pallas kernel in interpret mode, and the `a8`
route of `linear_apply`.

Tolerance against the interpret-mode kernel: both sides sum the same int8
products exactly and apply the same f32 epilogue, so they may differ only
where the kernel's f32 epilogue is contracted or reordered: one bf16 ulp
(rtol 2^-7) with an absolute 1e-3 of the output scale near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.kernels.w8a8 import quantize_activations as jax_quantize_activations
from eetq_tpu.kernels.w8a8 import w8a8_matmul_ref as jax_w8a8_ref
from eetq_tpu.layout import pack_weights as jax_pack
from eetq_tpu.ops.linear8 import w8a8_matmul as jax_w8a8_matmul
from eetq_tpu.quant import symmetric_quantize as jax_quantize
from eetq_tpu_torch.kernels.w8a8 import quantize_activations, w8a8_gemm, w8a8_matmul_ref
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear, linear_apply
from eetq_tpu_torch.ops.linear8 import w8a8_matmul
from eetq_tpu_torch.ops.rmsnorm import rmsnorm

K, N = 200, 328  # neither a multiple of the 256 (JAX) nor the 128 (port) granule


def _bf16(a: np.ndarray) -> tuple[jnp.ndarray, torch.Tensor]:
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module")
def weight():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    q, s = jax_quantize(jnp.asarray(w))
    return np.array(q), np.array(s)  # writable copies for torch.from_numpy


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_quantize_activations_bit_identical(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 300)).astype(np.float32) * 3
    x[1] = 0.0  # zero row: scale 0, values 0
    # exact .5 ties: absmax 127 makes the scale 1, so x / scale is x itself
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    if dtype == "bf16":
        xj, xt = _bf16(x)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    qj, sj = jax_quantize_activations(xj)
    qt, st = quantize_activations(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # half to even, as jnp.round
    assert qt[2, 1:8].tolist() == [0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("m", [1, 37, 128])
@pytest.mark.parametrize("with_bias", [False, True])
def test_w8a8_matmul_matches_jax(weight, m, with_bias):
    q, s = weight
    rng = np.random.default_rng(m)
    x_j, x_t = _bf16(rng.standard_normal((m, K)).astype(np.float32))
    bias_j, bias_t = _bf16(rng.standard_normal(N).astype(np.float32) * 0.1) if with_bias \
        else (None, None)
    ref_j = jax_w8a8_ref(x_j, jnp.asarray(q), jnp.asarray(s), bias_j)
    ref_t = w8a8_matmul_ref(x_t, torch.from_numpy(q), torch.from_numpy(s), bias_t)
    np.testing.assert_array_equal(_np(ref_t), _np(ref_j))  # bit-identical plain versions
    packed = pack_weights(torch.from_numpy(q))
    out_t = w8a8_matmul(x_t, packed, torch.from_numpy(s), bias=bias_t)
    assert out_t.shape == (m, N) and out_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out_t), _np(ref_t))  # the wrapper's CPU path: exact
    out_j = jax_w8a8_matmul(x_j, jax_pack(jnp.asarray(q)), jnp.asarray(s), bias=bias_j)
    j = _np(out_j)
    np.testing.assert_allclose(_np(out_t), j, rtol=2**-7, atol=1e-3 * np.abs(j).max())


def test_w8a8_gemm_operands_and_plain_path(weight):
    q, s = weight
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 3, K)).astype(np.float32))
    x = x.to(torch.bfloat16)
    packed = pack_weights(torch.from_numpy(q))
    out = w8a8_matmul(x, packed, torch.from_numpy(s))
    assert out.shape == (4, 3, N)
    plain = w8a8_matmul(x, packed, torch.from_numpy(s), use_kernel=False)
    assert torch.equal(out, plain)
    xq, sx = quantize_activations(x.reshape(12, K))
    xq = torch.nn.functional.pad(xq, (0, packed.kp - K))
    assert torch.equal(w8a8_gemm(xq, sx, packed.data, torch.from_numpy(s), N),
                       out.reshape(12, N))
    with pytest.raises(ValueError):  # group-wise int8 stays on the W8A16 path
        w8a8_matmul(x, packed, torch.ones(2, N))
    with pytest.raises(ValueError):
        w8a8_matmul(x[..., :-1], packed, torch.from_numpy(s))


def test_linear_apply_a8_route(weight):
    """a8 on an int8 per-channel QuantLinear: RMSNorm, then W8A8; a dense
    layer ignores it (`eetq_tpu/modules/linear.py:161-175`)."""
    q, s = weight
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, K)).astype(np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(K)).astype(np.float32))
    lin = QuantLinear(pack_weights(torch.from_numpy(q)), torch.from_numpy(s))
    got = linear_apply(lin, x, prenorm=(gamma, 1e-5), a8=True)
    want = w8a8_matmul(rmsnorm(x, gamma, 1e-5), lin.packed, lin.scales)
    assert torch.equal(got, want)
    w16 = linear_apply(lin, x, prenorm=(gamma, 1e-5))
    assert not torch.equal(got, w16)  # the int8 activations are a different answer
    dense = DenseLinear(torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16))
    assert torch.equal(linear_apply(dense, x, a8=True), linear_apply(dense, x))
