"""The port's fused decode MLP against the JAX package: `fused_mlp` against
JAX's `fused_mlp` (its Pallas kernel in interpret mode), the `can_fuse_mlp`
gate against JAX's, and the decoder layer's EETQ_FUSED_MLP switch.

Tolerance: both sides take the same f32 dots of the same bf16 y and int8
weights, and round h to bf16 between the two products, so a one-ulp
difference in h can move the output by a couple of bf16 ulps: rtol 2^-6,
atol 2^-6 of the largest output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eetq_tpu_torch.models.transformer as port_transformer
from eetq_tpu.modules.linear import DenseLinear as JaxDenseLinear
from eetq_tpu.modules.linear import QuantLinear as JaxQuantLinear
from eetq_tpu.modules.linear import quantize_linear as jax_quantize_linear
from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.ops.mlp import can_fuse_mlp as jax_can_fuse
from eetq_tpu.ops.mlp import fused_mlp as jax_fused_mlp
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.modules.attention import init_kv_cache
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear
from eetq_tpu_torch.ops.mlp import can_fuse_mlp, fused_mlp
from eetq_tpu_torch.ops.rope import make_cos_sin_cache

K, I, N = 200, 256, 328  # K, N off both granules; I a multiple of both


def _port(lin):
    """The port's twin of a JAX linear."""
    if isinstance(lin, JaxQuantLinear):
        q = torch.from_numpy(np.array(jax_unpack(lin.qweight)))
        bias = None if lin.bias is None else torch.from_numpy(
            np.asarray(lin.bias, np.float32)).to(torch.bfloat16)
        return QuantLinear(pack_weights(q), torch.from_numpy(np.array(lin.scales)), bias)
    return DenseLinear(torch.from_numpy(np.asarray(lin.weight, np.float32)).to(torch.bfloat16))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(0)
    gu = jax_quantize_linear(jnp.asarray(rng.standard_normal((K, 2 * I)).astype(np.float32) / 14))
    down = jax_quantize_linear(jnp.asarray(rng.standard_normal((I, N)).astype(np.float32) / 16))
    gamma = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    return gu, down, gamma


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_mlp_matches_jax(layers, m, activation, with_residual):
    gu, down, gamma = layers
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    res = rng.standard_normal((m, N)).astype(np.float32) if with_residual else None
    out_j = jax_fused_mlp(
        gu, down, jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma), 1e-5,
        activation=activation,
        residual=None if res is None else jnp.asarray(res, jnp.bfloat16))
    out_t = fused_mlp(
        _port(gu), _port(down), torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gamma),
        1e-5, activation=activation,
        residual=None if res is None else torch.from_numpy(res).to(torch.bfloat16))
    assert out_t.shape == (m, N) and out_t.dtype == torch.bfloat16
    j = _np(out_j)
    np.testing.assert_allclose(_np(out_t), j, rtol=2**-6, atol=2**-6 * np.abs(j).max())
    plain = fused_mlp(_port(gu), _port(down), torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(gamma), 1e-5, activation=activation,
                      residual=None if res is None else torch.from_numpy(res).to(torch.bfloat16),
                      use_kernel=False)
    assert torch.equal(plain, out_t)  # the wrapper's CPU path is the plain version


def test_fused_mlp_lead_dims(layers):
    gu, down, gamma = layers
    x = torch.randn(2, 1, K, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out = fused_mlp(_port(gu), _port(down), x, torch.from_numpy(gamma), 1e-5, residual=x[..., :1]
                    .expand(2, 1, N))
    assert out.shape == (2, 1, N)


def _gate_cases():
    """(name, JAX gateup, JAX down, m) for the cases where the two layouts
    agree."""
    rng = np.random.default_rng(1)

    def q(k, n, **kw):
        return jax_quantize_linear(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32)),
                                   **kw)

    gu, dn = q(K, 2 * I), q(I, N)
    return [
        ("decode rows", gu, dn, 8),
        ("prefill rows", gu, dn, 9),
        ("dense down", gu, JaxDenseLinear(weight=jnp.zeros((I, N), jnp.bfloat16)), 1),
        ("dense gate/up (the port's stand-in for a bits mismatch: it holds no int4 weight)",
         JaxDenseLinear(weight=jnp.zeros((K, 2 * I), jnp.bfloat16)), dn, 1),
        ("bias", q(K, 2 * I, bias=jnp.ones((2 * I,), jnp.bfloat16)), dn, 1),
        ("unaligned I = 250", q(K, 500), q(250, N), 1),
    ]


@pytest.mark.parametrize("case", range(6))
def test_can_fuse_mlp_agrees_with_jax(case):
    name, gu, dn, m = _gate_cases()[case]
    assert can_fuse_mlp(_port(gu), _port(dn), m) == jax_can_fuse(gu, dn, m), name


def test_can_fuse_mlp_refuses_group_wise():
    rng = np.random.default_rng(2)
    q = torch.randint(-127, 128, (I, N), dtype=torch.int8)
    gw = QuantLinear(pack_weights(q), torch.rand(2, N))  # group-wise scales [G, N]
    gu = QuantLinear(pack_weights(torch.randint(-127, 128, (K, 2 * I), dtype=torch.int8)),
                     torch.rand(2 * I))
    jgw = jax_quantize_linear(jnp.asarray(rng.standard_normal((I, N)).astype(np.float32)),
                              group_size=128)
    assert not can_fuse_mlp(gu, gw, 1) and not jax_can_fuse(
        jax_quantize_linear(jnp.ones((K, 2 * I))), jgw, 1)
    # I = 384: a multiple of the port's 128 tile but not of JAX's 256, so
    # only the port's layout keeps the gate|up halves at column I
    gu3 = QuantLinear(pack_weights(torch.ones(K, 768, dtype=torch.int8)), torch.rand(768))
    dn3 = QuantLinear(pack_weights(torch.ones(384, N, dtype=torch.int8)), torch.rand(N))
    assert can_fuse_mlp(gu3, dn3, 1)


def test_decoder_layer_fused_switch(monkeypatch):
    """fused_mlp=True (or EETQ_FUSED_MLP=1 with fused_mlp=None) runs a
    decode-regime MLP as the fused op, whose output is the layer's (the
    residual is added inside); prefill rows and a8 keep the unfused path."""
    cfg = ModelConfig(vocab_size=64, hidden_size=128, intermediate_size=256, num_layers=1,
                      num_heads=4, num_kv_heads=2, head_dim=32, max_position=64)
    p = quantize_params(random_dense_params(cfg, torch.Generator().manual_seed(0)))
    layer = p.layers[0]
    calls = []
    real = port_transformer.fused_mlp_op
    monkeypatch.setattr(port_transformer, "fused_mlp_op",
                        lambda *a, **kw: calls.append(a[2].shape) or real(*a, **kw))
    cos_sin = make_cos_sin_cache(cfg.max_position, cfg.rot_dim, device="cpu")
    x = torch.randn(2, 1, 128, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    pos = torch.zeros(2, 1, dtype=torch.long)

    def cache():
        return init_kv_cache(2, 64, cfg.num_kv_heads, cfg.head_dim, device="cpu")

    unfused, _ = port_transformer.decoder_layer(layer, cfg, x, pos, cos_sin, cache(), 0,
                                                fused_mlp=False)
    assert calls == []
    monkeypatch.setenv("EETQ_FUSED_MLP", "1")
    fused, _ = port_transformer.decoder_layer(layer, cfg, x, pos, cos_sin, cache(), 0)
    assert calls == [(2, 1, 128)]
    np.testing.assert_allclose(fused.float().numpy(), unfused.float().numpy(),
                               rtol=2**-6, atol=2**-6 * unfused.float().abs().max().item())
    xs = torch.randn(2, 5, 128, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    port_transformer.decoder_layer(layer, cfg, xs, torch.arange(5).expand(2, 5), cos_sin, None,
                                   0, fused_mlp=True)  # 10 rows: no fusion
    port_transformer.decoder_layer(layer, cfg, x, pos, cos_sin, cache(), 0, a8=True,
                                   fused_mlp=True)  # a8: no fusion
    assert len(calls) == 1
