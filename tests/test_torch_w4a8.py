"""The port's W4A8 path against the JAX package: int4 weights, per-channel
and group-wise scales, through `w8a8_matmul` (JAX's Pallas kernel in
interpret mode) and the `a8` route of `linear_apply`.

Per-channel: both plain versions sum the int8 x int4 products exactly and
apply the same f32 epilogue, so they are bit-identical; JAX's kernel folds
x16 and 1/16 into its sums (exact) and may contract its epilogue: one bf16
ulp. Group-wise: each group's exact integer sum is scaled in f32 and the
groups are added in f32, in an order that differs between the oracle
(einsum), JAX's kernel and the port: a few f32 ulps before the one rounding
to bf16, so one bf16 ulp (rtol 2^-7) with 1e-3 of the output scale near
zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.kernels.w8a8 import w8a8_matmul_ref as jax_w8a8_ref
from eetq_tpu.layout import pack_weights as jax_pack
from eetq_tpu.ops.linear8 import w8a8_matmul as jax_w8a8_matmul
from eetq_tpu.quant import symmetric_quantize as jax_quantize
from eetq_tpu_torch.kernels.w8a8 import quantize_activations, w4a8_gemm, w8a8_matmul_ref
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.modules.linear import QuantLinear, linear_apply
from eetq_tpu_torch.ops.linear8 import w8a8_matmul
from eetq_tpu_torch.ops.rmsnorm import rmsnorm

N = 328
CASES = [(256, None), (256, 64), (256, 128), (200, None), (320, 64)]  # (K, group size)


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(1)
    out = {}
    for k, g in CASES:
        w = rng.standard_normal((k, N)).astype(np.float32) / np.sqrt(k)
        q, s = jax_quantize(jnp.asarray(w), bits=4, group_size=g)
        out[k, g] = np.array(q), np.array(s)
    return out


@pytest.mark.parametrize("m", [1, 37, 128])
@pytest.mark.parametrize("case", CASES)
def test_w4a8_matmul_matches_jax(weights, m, case):
    k, g = case
    q, s = weights[case]
    rng = np.random.default_rng(m)
    x_j, x_t = _bf16(rng.standard_normal((m, k)).astype(np.float32))
    bias_j, bias_t = _bf16(rng.standard_normal(N).astype(np.float32) * 0.1)
    ref_j = _np(jax_w8a8_ref(x_j, jnp.asarray(q), jnp.asarray(s), bias_j))
    ref_t = _np(w8a8_matmul_ref(x_t, _t(q), _t(s), bias_t))
    if g is None:
        np.testing.assert_array_equal(ref_t, ref_j)  # bit-identical plain versions
    else:
        np.testing.assert_allclose(ref_t, ref_j, rtol=2**-7, atol=1e-3 * np.abs(ref_j).max())
    packed = pack_weights(_t(q), bits=4)
    out_t = w8a8_matmul(x_t, packed, _t(s), bias=bias_t)
    assert out_t.shape == (m, N) and out_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out_t), ref_t)  # the wrapper's CPU path: the plain version
    out_j = _np(jax_w8a8_matmul(x_j, jax_pack(jnp.asarray(q), bits=4), jnp.asarray(s),
                                bias=bias_j))
    np.testing.assert_allclose(_np(out_t), out_j, rtol=2**-7, atol=1e-3 * np.abs(out_j).max())


def test_w4a8_gemm_operands_and_plain_path(weights):
    q, s = weights[320, 64]
    x = torch.randn(4, 3, 320, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    packed = pack_weights(_t(q), bits=4)
    out = w8a8_matmul(x, packed, _t(s))
    assert out.shape == (4, 3, N)
    assert torch.equal(out, w8a8_matmul(x, packed, _t(s), use_kernel=False))
    xq, sx = quantize_activations(x.reshape(12, 320))
    xq = torch.nn.functional.pad(xq, (0, packed.kp - 320))  # Kp = 384
    assert torch.equal(w4a8_gemm(xq, sx, packed.data, _t(s), N, group_size=64),
                       out.reshape(12, N))
    with pytest.raises(ValueError):  # 3 scale rows do not divide K
        w8a8_matmul(x, packed, torch.ones(3, N))
    with pytest.raises(ValueError):  # group-wise int8 stays on the W8A16 path
        w8a8_matmul(x, pack_weights(_t(q)), _t(s))


@pytest.mark.parametrize("case", [(256, None), (256, 128)])
def test_linear_apply_a8_takes_any_int4_layer(weights, case):
    """a8 on an int4 QuantLinear, per-channel or group-wise: RMSNorm, then
    W4A8 (`eetq_tpu/modules/linear.py:161-169`); an int8 group-wise layer
    ignores a8 and stays W8A16."""
    q, s = weights[case]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 256)).astype(np.float32)).to(torch.bfloat16)
    gamma = torch.from_numpy((1 + 0.1 * rng.standard_normal(256)).astype(np.float32))
    lin = QuantLinear(pack_weights(_t(q), bits=4), _t(s))
    got = linear_apply(lin, x, prenorm=(gamma, 1e-5), a8=True)
    assert torch.equal(got, w8a8_matmul(rmsnorm(x, gamma, 1e-5), lin.packed, lin.scales))
    assert not torch.equal(got, linear_apply(lin, x, prenorm=(gamma, 1e-5)))
    if case[1] is not None:
        lin8 = QuantLinear(pack_weights(_t(q)), _t(s))
        assert torch.equal(linear_apply(lin8, x, prenorm=(gamma, 1e-5), a8=True),
                           linear_apply(lin8, x, prenorm=(gamma, 1e-5)))
