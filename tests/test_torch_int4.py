"""The port's int4 weights against the JAX package: the nibble helpers and
the packed layout (exact), `w8a16_matmul` on int4 weights with per-channel
and group-wise scales against JAX's Pallas kernel in interpret mode, the
int4 fused MLP against JAX's, and the gates of `can_fuse_mlp`.

The two packages pack differently (JAX: row i with row i + Kp/2 in a byte;
the port: rows 2i and 2i + 1), so the packed bytes are never compared: the
contract is the unpacked [K, N] values.

Tolerance of the matmuls: the JAX kernel multiplies x by the biased nibble
(lo + 8) and takes 8 * rowsum(x) off again in f32, and feeds the high half
x / 16 against 16 * hi; the port multiplies by the exact values in [-8, 7].
Both sum exact products in f32, in other orders, and round once to bf16: a
few bf16 ulps (2^-8 each) of the largest output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eetq_tpu_torch.ops.linear as port_linear
from eetq_tpu.layout import pack_weights as jax_pack
from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.modules.linear import quantize_linear as jax_quantize_linear
from eetq_tpu.ops import w8a16_matmul as jax_w8a16_matmul
from eetq_tpu.ops.mlp import can_fuse_mlp as jax_can_fuse
from eetq_tpu.ops.mlp import fused_mlp as jax_fused_mlp
from eetq_tpu.quant import quantizer as jax_quantizer
from eetq_tpu.quant import symmetric_quantize as jax_quantize
from eetq_tpu_torch.kernels.autotune import GROUP_GRANULE, group_size_of
from eetq_tpu_torch.kernels.w8a16 import w4a16_gemm, w4a16_gemv, w8a16_gemv, w8a16_matmul_ref
from eetq_tpu_torch.layout.tiling import PackedWeight, pack_weights, unpack_weights
from eetq_tpu_torch.modules.linear import (
    QuantLinear,
    init_only_linear,
    linear_apply,
    quantize_linear,
)
from eetq_tpu_torch.ops.linear import w8a16_matmul
from eetq_tpu_torch.ops.mlp import can_fuse_mlp, fused_mlp
from eetq_tpu_torch.quant.quantizer import (
    int4_pack,
    int4_unpack,
    quantize_and_pack,
    symmetric_quantize,
)

N = 328  # off both packages' column granules


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, ulps: int = 4) -> None:
    j = _np(j)
    np.testing.assert_allclose(_np(t), j, rtol=0, atol=ulps * 2.0**-8 * np.abs(j).max())


def _port(lin) -> QuantLinear:
    """The port's twin of a JAX QuantLinear, through the unpacked values."""
    bias = None if lin.bias is None else _t(np.asarray(lin.bias, np.float32)).to(torch.bfloat16)
    return QuantLinear(pack_weights(_t(jax_unpack(lin.qweight)), bits=lin.qweight.bits),
                       _t(lin.scales), bias)


@pytest.mark.parametrize("shape", [(5, 32), (3, 7, 10)])
def test_int4_pack_unpack_equal_jax(rng, shape):
    q = rng.integers(-8, 8, shape).astype(np.int8)
    packed = int4_pack(_t(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_quantizer.int4_pack(jnp.asarray(q))))
    np.testing.assert_array_equal(int4_unpack(packed).numpy(), q)
    np.testing.assert_array_equal(
        int4_unpack(packed).numpy(), np.asarray(jax_quantizer.int4_unpack(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError):
        int4_pack(_t(q[..., :-1]))


@pytest.mark.parametrize("shape", [(200, 328), (256, 128), (3, 130, 40), (2, 1)])
def test_pack_weights_int4_round_trip(rng, shape):
    q = rng.integers(-8, 8, shape).astype(np.int8)
    packed = pack_weights(_t(q), bits=4)
    kp, np_ = -(-shape[-2] // 128) * 128, -(-shape[-1] // 128) * 128
    assert packed.bits == 4 and (packed.k, packed.n) == shape[-2:]
    assert packed.data.shape == (*shape[:-2], kp // 2, np_) and (packed.kp, packed.np) == (kp, np_)
    assert packed.data.dtype == torch.int8 and packed.data.is_contiguous()
    np.testing.assert_array_equal(unpack_weights(packed).numpy(), q)
    # the same values JAX recovers from its own (split-half) packing
    np.testing.assert_array_equal(unpack_weights(packed).numpy(),
                                  np.asarray(jax_unpack(jax_pack(jnp.asarray(q), bits=4))))
    # byte (i, n): row 2i in the low nibble, row 2i + 1 in the high one
    two = pack_weights(_t(np.array([[-3], [5]], np.int8)), bits=4).data
    assert int(two[0, 0]) == np.int8((5 << 4) | (-3 & 0xF)).item() == 0x5D


def test_pack_weights_refuses_other_bits():
    with pytest.raises(ValueError):
        pack_weights(torch.zeros(4, 4, dtype=torch.int8), bits=2)


@pytest.mark.parametrize("group", [None, 64])
def test_int4_quantizer_and_quantize_linear_equal_jax(rng, group):
    w = rng.standard_normal((256, N)).astype(np.float32)
    qj, sj = jax_quantize(jnp.asarray(w), bits=4, group_size=group)
    qt, st = symmetric_quantize(_t(w), bits=4, group_size=group)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    lin = quantize_linear(_t(w), bits=4, group_size=group)
    jl = jax_quantize_linear(jnp.asarray(w), bits=4, group_size=group)
    assert lin.bits == 4 and lin.qweight.shape == (128, 384) and lin.packed.bits == 4
    np.testing.assert_array_equal(unpack_weights(lin.packed).numpy(),
                                  np.asarray(jax_unpack(jl.qweight)))
    np.testing.assert_array_equal(lin.scales.numpy(), np.asarray(jl.scales))
    # an already quantized weight is packed as it is
    ext = quantize_linear(qt, bits=4, external_scales=st)
    assert torch.equal(ext.qweight, lin.qweight) and ext.scales is st
    with pytest.raises(ValueError):
        quantize_linear(qt, bits=4)
    with pytest.raises(ValueError):
        quantize_linear(_t(w), external_scales=st)


def test_quantize_and_pack_and_init_only(rng):
    w = _t(rng.standard_normal((64, 40)).astype(np.float32))
    for bits in (8, 4):
        packed, s = quantize_and_pack(w, bits=bits)
        q, s2 = symmetric_quantize(w, bits=bits)
        assert isinstance(packed, PackedWeight) and packed.bits == bits
        assert torch.equal(unpack_weights(packed), q) and torch.equal(s, s2)
    shell = init_only_linear(100, 60, with_bias=True, device="cpu")
    assert shell.bits == 8 and shell.qweight.shape == (128, 128) and shell.bias.shape == (60,)
    assert shell.scales.dtype == torch.float32 and not shell.qweight.any()


# (K, group size): K = 200 and 320 need padding in both packages
CASES = [(256, None), (256, 64), (256, 128), (200, None), (320, 64)]


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(1)
    out = {}
    for k, g in CASES:
        w = rng.standard_normal((k, N)).astype(np.float32) / np.sqrt(k)
        q, s = jax_quantize(jnp.asarray(w), bits=4, group_size=g)
        out[k, g] = np.array(q), np.array(s)
    return out


@pytest.mark.parametrize("m", [1, 4, 37])
@pytest.mark.parametrize("case", CASES)
def test_w4a16_matmul_matches_jax(weights, m, case):
    k, g = case
    q, s = weights[case]
    rng = np.random.default_rng(m)
    x_j, x_t = _bf16(rng.standard_normal((m, k)).astype(np.float32))
    bias_j, bias_t = _bf16(rng.standard_normal(N).astype(np.float32) * 0.1)
    gamma = (1.0 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    out_j = jax_w8a16_matmul(x_j, jax_pack(jnp.asarray(q), bits=4), jnp.asarray(s), bias=bias_j,
                             prenorm_gamma=jnp.asarray(gamma), prenorm_eps=1e-5)
    packed = pack_weights(_t(q), bits=4)
    out_t = w8a16_matmul(x_t, packed, _t(s), bias=bias_t, prenorm_gamma=_t(gamma),
                         prenorm_eps=1e-5)
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (m, N)
    _close(out_t, out_j)
    plain = w8a16_matmul(x_t, packed, _t(s), bias=bias_t, prenorm_gamma=_t(gamma),
                         prenorm_eps=1e-5, use_kernel=False)
    assert torch.equal(out_t, plain)  # the wrappers' CPU path is the plain version


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,kernel", [(1, "gemv"), (8, "gemv"), (9, "gemm")])
def test_dispatch_by_bits_and_rows(monkeypatch, weights, bits, m, kernel):
    q, s = weights[256, 64]
    calls = []
    for name in ("w8a16_gemv", "w8a16_gemm", "w4a16_gemv", "w4a16_gemm"):
        monkeypatch.setattr(port_linear, name, lambda x, *a, _n=name, **kw: calls.append(_n) or
                            torch.zeros(x.shape[0], N, dtype=x.dtype))
    w8a16_matmul(torch.ones(m, 256, dtype=torch.bfloat16), pack_weights(_t(q), bits=bits), _t(s))
    assert calls == [f"w{bits}a16_{kernel}"]


def test_wrappers_take_the_packed_int4_data(weights):
    """The kernel wrappers on CPU tensors: the plain version on the unpacked
    values, int4 and int8 group-wise alike."""
    q, s = weights[320, 64]
    x = torch.randn(3, 320, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ref = w8a16_matmul_ref(x, _t(q), _t(s))
    assert torch.equal(w4a16_gemv(x, pack_weights(_t(q), bits=4).data, _t(s), N), ref)
    assert torch.equal(w4a16_gemm(x, pack_weights(_t(q), bits=4).data, _t(s), N), ref)
    assert torch.equal(w8a16_gemv(x, pack_weights(_t(q)).data, _t(s), N), ref)


def test_group_size_rules():
    """A group is whole K steps of the kernels: a multiple of GROUP_GRANULE
    that divides K."""
    assert GROUP_GRANULE == 32
    assert group_size_of(256, torch.ones(2, 8)) == 128
    assert group_size_of(320, torch.ones(5, 8)) == 64
    with pytest.raises(ValueError):  # g = 16
        group_size_of(256, torch.ones(16, 8))
    with pytest.raises(ValueError):  # 3 rows do not divide 256
        group_size_of(256, torch.ones(3, 8))
    with pytest.raises(ValueError):
        w8a16_matmul(torch.ones(1, 256, dtype=torch.bfloat16),
                     pack_weights(torch.zeros(256, 8, dtype=torch.int8), bits=4), torch.ones(3, 8))


def test_linear_apply_routes_int4(weights):
    q, s = weights[256, 128]
    lin = QuantLinear(pack_weights(_t(q), bits=4), _t(s))
    x = torch.randn(2, 3, 256, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert torch.equal(linear_apply(lin, x), w8a16_matmul(x, lin.packed, lin.scales))
    assert lin(x).shape == (2, 3, N)


# The fused MLP: K, N off the granules; I = 512, the least the JAX package
# fuses for int4 (its split halves are whole 256-row tiles)
K, I = 200, 512


@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(0)
    gu = jax_quantize_linear(jnp.asarray(rng.standard_normal((K, 2 * I)).astype(np.float32) / 14),
                             bits=4)
    down = jax_quantize_linear(jnp.asarray(rng.standard_normal((I, N)).astype(np.float32) / 16),
                               bits=4)
    return gu, down, (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_mlp_int4_matches_jax(mlp, m, activation, with_residual):
    """h is rounded to bf16 between the two products on both sides, so a
    one-ulp difference in h can move the output by a couple of ulps: 2^-6 of
    the largest output, as for int8."""
    gu, down, gamma = mlp
    rng = np.random.default_rng(m)
    x_j, x_t = _bf16(rng.standard_normal((m, K)).astype(np.float32))
    res_j, res_t = _bf16(rng.standard_normal((m, N)).astype(np.float32)) if with_residual \
        else (None, None)
    assert jax_can_fuse(gu, down, m) and can_fuse_mlp(_port(gu), _port(down), m)
    out_j = jax_fused_mlp(gu, down, x_j, jnp.asarray(gamma), 1e-5, activation=activation,
                          residual=res_j)
    out_t = fused_mlp(_port(gu), _port(down), x_t, _t(gamma), 1e-5, activation=activation,
                      residual=res_t)
    assert out_t.shape == (m, N) and out_t.dtype == torch.bfloat16
    _close(out_t, out_j, ulps=4)
    plain = fused_mlp(_port(gu), _port(down), x_t, _t(gamma), 1e-5, activation=activation,
                      residual=res_t, use_kernel=False)
    assert torch.equal(plain, out_t)


def _gate_cases():
    rng = np.random.default_rng(1)

    def q(k, n, **kw):
        return jax_quantize_linear(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)),
                                   **kw)

    gu4, dn4 = q(K, 2 * I, bits=4), q(I, N, bits=4)
    return [
        ("int4 decode rows", gu4, dn4, 8),
        ("int4 prefill rows", gu4, dn4, 9),
        ("int8 gate/up, int4 down", q(K, 2 * I), dn4, 1),
        ("int4 gate/up, int8 down", gu4, q(I, N), 1),
        ("int4 group-wise down", gu4, q(I, N, bits=4, group_size=128), 1),
        ("int4 group-wise gate/up", q(256, 2 * I, bits=4, group_size=64), dn4, 1),
        ("int4 bias", q(K, 2 * I, bits=4, bias=jnp.ones((2 * I,), jnp.bfloat16)), dn4, 1),
        ("int4 unaligned I = 250", q(K, 500, bits=4), q(250, N, bits=4), 1),
    ]


@pytest.mark.parametrize("case", range(8))
def test_can_fuse_mlp_int4_agrees_with_jax(case):
    name, gu, dn, m = _gate_cases()[case]
    want = jax_can_fuse(gu, dn, m)
    assert can_fuse_mlp(_port(gu), _port(dn), m) == want, name
    assert want == (case == 0), name
