"""The GEMMs' fused epilogue (an activation, then a residual added or
multiplied, after the scale and the bias) of the port against the JAX
package's: `w8a16_matmul` in both regimes (GEMV m <= 8, GEMM m = 40), int8
per-channel and int4 with 64-row scale groups, `w8a8_matmul(activation=)` on
int8 and int4 weights, and `linear_apply` on QuantLinear and DenseLinear.
On the CPU the port's wrappers run their plain versions; the JAX side runs
its plain reference (`use_kernel=False`, on x's exact bf16 values in f32,
the result rounded to bf16) for the whole grid of cases and its Pallas
kernels in interpret mode for a cross-section of it.

Tolerance: both sides compute the epilogue in f32 and round once to bf16,
the activations through two libraries' exp and tanh; they differ where a
summation order or a last f32 bit tips a bf16 rounding: one bf16 ulp, rtol
2^-7, plus an absolute 1e-3 of the output scale for values near zero.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.layout import pack_weights as jax_pack
from eetq_tpu.modules.linear import DenseLinear as JaxDense
from eetq_tpu.modules.linear import QuantLinear as JaxQuant
from eetq_tpu.modules.linear import linear_apply as jax_linear_apply
from eetq_tpu.ops import w8a16_matmul as jax_w8a16_matmul
from eetq_tpu.ops.linear8 import w8a8_matmul as jax_w8a8_matmul
from eetq_tpu.quant import symmetric_quantize as jax_quantize
from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
from eetq_tpu_torch.kernels.w8a16 import w8a16_gemm, w8a16_gemv
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear, linear_apply
from eetq_tpu_torch.ops.linear import w8a16_matmul
from eetq_tpu_torch.ops.linear8 import w8a8_matmul

K, N = 256, 200  # N off the port's 128 granule
ACTS = (None, "relu", "gelu", "silu")
MODES = (None, "add", "mul")
WEIGHTS = {"int8": (8, None), "int4-g64": (4, 64)}


def _close(t: torch.Tensor, j) -> None:
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), j, rtol=2**-7, atol=1e-3 * np.abs(j).max())


def _bf16(a: np.ndarray) -> tuple[jnp.ndarray, torch.Tensor]:
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
    out = {}
    for name, (bits, g) in WEIGHTS.items():
        q, s = jax_quantize(jnp.asarray(w), bits=bits, group_size=g)
        out[name] = (bits, np.array(q), np.array(s))
    return out


def _inputs(m: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, K)).astype(np.float32)
    res = rng.standard_normal((m, N)).astype(np.float32)
    bias = 0.1 * rng.standard_normal(N).astype(np.float32)
    return _bf16(x), _bf16(res), _bf16(bias)


def _both(wt, m, act, mode, with_bias, jax_kernel):
    bits, q, s = wt
    (xj, xt), (rj, rt), (bj, bt) = _inputs(m, 7 * m + 3)
    kw_j = dict(bias=bj if with_bias else None, activation=act)
    kw_t = dict(bias=bt if with_bias else None, activation=act)
    if mode is not None:
        kw_j.update(residual=rj, residual_mode=mode)
        kw_t.update(residual=rt, residual_mode=mode)
    if not jax_kernel:
        # the reference's dot of exact bf16 values in f32 (XLA's CPU backend has
        # no bf16 x bf16 -> f32 batched dot), rounded to bf16 as it rounds
        xj = xj.astype(jnp.float32)
    out_j = jax_w8a16_matmul(xj, jax_pack(jnp.asarray(q), bits=bits), jnp.asarray(s),
                             use_kernel=jax_kernel, **kw_j).astype(jnp.bfloat16)
    out_t = w8a16_matmul(xt, pack_weights(torch.from_numpy(q), bits=bits), torch.from_numpy(s),
                         **kw_t)
    return out_t, out_j


@pytest.mark.parametrize("weight", list(WEIGHTS))
@pytest.mark.parametrize("m", [1, 8, 40])
@pytest.mark.parametrize("act,mode,with_bias", list(itertools.product(ACTS, MODES, (False, True))))
def test_w8a16_epilogue_matches_jax_reference(weights, weight, m, act, mode, with_bias):
    out_t, out_j = _both(weights[weight], m, act, mode, with_bias, jax_kernel=False)
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (m, N)
    _close(out_t, out_j)


@pytest.mark.parametrize("weight", list(WEIGHTS))
@pytest.mark.parametrize("m,act,mode", [(1, "gelu", "mul"), (8, "silu", "add"),
                                        (40, "relu", "mul"), (40, "gelu", None)])
def test_w8a16_epilogue_matches_jax_kernel(weights, weight, m, act, mode):
    """The JAX side through its Pallas kernel (interpret mode)."""
    out_t, out_j = _both(weights[weight], m, act, mode, True, jax_kernel=True)
    _close(out_t, out_j)


@pytest.mark.parametrize("weight", list(WEIGHTS))
@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("act", ACTS)
def test_w8a8_activation_matches_jax(weights, weight, m, act):
    bits, q, s = weights[weight]
    (xj, xt), _, (bj, bt) = _inputs(m, m + 11)
    jax_kernel = act in (None, "gelu")
    out_j = jax_w8a8_matmul(xj, jax_pack(jnp.asarray(q), bits=bits), jnp.asarray(s), bias=bj,
                            activation=act, use_kernel=jax_kernel)
    out_t = w8a8_matmul(xt, pack_weights(torch.from_numpy(q), bits=bits), torch.from_numpy(s),
                        bias=bt, activation=act)
    _close(out_t, out_j)
    if act in (None, "relu"):  # no transcendental: the plain products are bit-identical
        np.testing.assert_array_equal(out_t.float().numpy(),
                                      np.asarray(out_j, np.float32))


def test_prenorm_fuses_beside_the_epilogue(weights):
    """A prenorm with an activation and a residual: the GEMV regime fuses the
    norm into the prologue and equals the GEMM regime's plain norm first."""
    bits, q, s = weights["int8"]
    (xj, xt), (rj, rt), _ = _inputs(4, 5)
    gamma = 1.0 + 0.1 * np.random.default_rng(9).standard_normal(K).astype(np.float32)
    kw = dict(activation="silu", residual_mode="mul", prenorm_eps=1e-5)
    out_j = jax_w8a16_matmul(xj, jax_pack(jnp.asarray(q)), jnp.asarray(s), residual=rj,
                             prenorm_gamma=jnp.asarray(gamma), **kw)
    packed, st = pack_weights(torch.from_numpy(q)), torch.from_numpy(s)
    out_t = w8a16_matmul(xt, packed, st, residual=rt, prenorm_gamma=torch.from_numpy(gamma), **kw)
    _close(out_t, out_j)
    plain = w8a16_matmul(xt, packed, st, residual=rt, prenorm_gamma=torch.from_numpy(gamma),
                         use_kernel=False, **kw)
    assert torch.equal(out_t, plain)


@pytest.mark.parametrize("kind", ["quant", "dense"])
@pytest.mark.parametrize("m", [2, 40])
@pytest.mark.parametrize("act,residual", [("gelu", False), (None, True), ("silu", True)])
def test_linear_apply_epilogue_matches_jax(weights, kind, m, act, residual):
    bits, q, s = weights["int8"]
    (xj, xt), (rj, rt), (bj, bt) = _inputs(m, 2 * m + 1)
    xj, xt = xj.reshape(1, m, K), xt.reshape(1, m, K)
    rj, rt = (rj.reshape(1, m, N), rt.reshape(1, m, N)) if residual else (None, None)
    if kind == "quant":
        lj = JaxQuant(qweight=jax_pack(jnp.asarray(q)), scales=jnp.asarray(s), bias=bj)
        lt = QuantLinear(pack_weights(torch.from_numpy(q)), torch.from_numpy(s), bt)
    else:
        w = (np.random.default_rng(4).standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
        (wj, wt) = _bf16(w)
        lj, lt = JaxDense(weight=wj, bias=bj), DenseLinear(wt, bt)
    out_j = jax_linear_apply(lj, xj, activation=act, residual=rj)
    out_t = linear_apply(lt, xt, activation=act, residual=rt)
    assert out_t.shape == (1, m, N)
    _close(out_t[0], np.asarray(out_j, np.float32)[0])
    assert torch.equal(lt(xt, activation=act, residual=rt), out_t)  # forward passes them on


def test_a8_takes_no_residual(weights):
    """a8 with a residual stays on the W8A16 path (`modules/linear.py:161-175`)."""
    bits, q, s = weights["int8"]
    (_, xt), (_, rt), _ = _inputs(8, 1)
    lt = QuantLinear(pack_weights(torch.from_numpy(q)), torch.from_numpy(s))
    got = linear_apply(lt, xt, activation="relu", residual=rt, a8=True)
    assert torch.equal(got, linear_apply(lt, xt, activation="relu", residual=rt))
    assert not torch.equal(linear_apply(lt, xt, activation="relu", a8=True),
                           linear_apply(lt, xt, activation="relu"))


def test_epilogue_arguments_checked(weights):
    bits, q, s = weights["int8"]
    x = torch.ones(2, K, dtype=torch.bfloat16)
    packed, st = pack_weights(torch.from_numpy(q)), torch.from_numpy(s)
    with pytest.raises(ValueError, match="activation"):
        w8a16_matmul(x, packed, st, activation="tanh")
    with pytest.raises(ValueError, match="residual mode"):
        w8a16_matmul(x, packed, st, residual=torch.ones(2, N, dtype=torch.bfloat16),
                     residual_mode="sub")
    with pytest.raises(ValueError, match="activation"):
        w8a8_matmul(x, packed, st, activation="tanh")
    with pytest.raises(ValueError, match="activation"):
        w8a16_gemv(x, packed.data, st, N, activation="swish")


def test_cpu_wrappers_count_no_launch(weights):
    """A CPU tensor runs the plain version: no launch, no epilogue variant."""
    bits, q, s = weights["int8"]
    x = torch.ones(16, K, dtype=torch.bfloat16)
    reset_launch_counts()
    w8a16_gemm(x, pack_weights(torch.from_numpy(q)).data, torch.from_numpy(s), N,
               activation="relu")
    counts = launch_counts()
    assert counts["w8a16_gemm"] == 0 and counts["w8a16_gemm[epilogue]"] == 0
