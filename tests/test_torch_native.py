"""The port's native host quantizer (`eetq_tpu_torch/native/`) against the
JAX package's (`eetq_tpu/native/`) and the port's own torch quantizer on
the CPU: int8 values and f32 scales bit-equal for f32, f16 and bf16
weights, int8 and int4, per-channel and groups of 64 and 128, 2-D weights
and 3-D expert banks, a zero column; the port's int4 layout (rows 2i and
2i + 1 in byte i, not JAX's split halves), the int8 transpose, the plain
torch path under EETQ_DISABLE_NATIVE=1, and a build that fails raising."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.native import host_symmetric_quantize as jax_host_quantize
from eetq_tpu_torch import native
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.quant.quantizer import symmetric_quantize

DTYPES = {"f32": (np.float32, torch.float32), "f16": (np.float16, torch.float16),
          "bf16": (None, torch.bfloat16)}


def _pair(w32: np.ndarray, dtype: str):
    """The same weight for both packages: numpy (bf16 as JAX's ml_dtypes
    array) and torch."""
    np_dt, t_dt = DTYPES[dtype]
    if np_dt is None:
        return np.asarray(jnp.asarray(w32, jnp.bfloat16)), torch.from_numpy(w32).to(t_dt)
    return w32.astype(np_dt), torch.from_numpy(w32.astype(np_dt))


def test_native_builds_and_loads():
    assert native.native_available()
    assert native._load().eetq_native_version() == 1


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [None, 64, 128])
def test_bit_exact_against_jax_and_the_torch_quantizer(dtype, bits, group):
    rng = np.random.default_rng(bits * 1000 + (group or 0))
    w32 = (rng.standard_normal((256, 192)) * 0.1).astype(np.float32)
    w32[:, 5] = 0.0  # a zero column: scale 0, q 0
    w_np, w_t = _pair(w32, dtype)
    q, s = native.host_symmetric_quantize(w_t, bits=bits, group_size=group)
    q_j, s_j = jax_host_quantize(w_np, bits=bits, group_size=group)
    np.testing.assert_array_equal(q.numpy(), q_j)
    np.testing.assert_array_equal(s.numpy(), s_j)
    q_t, s_t = symmetric_quantize(w_t, bits=bits, group_size=group)
    assert torch.equal(q, q_t) and torch.equal(s, s_t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert not q[:, 5].any() and not s[..., 5].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("group", [None, 32])
def test_expert_banks(dtype, group):
    rng = np.random.default_rng(7)
    w_np, w_t = _pair(rng.standard_normal((3, 64, 96)).astype(np.float32), dtype)
    q, s = native.host_symmetric_quantize(w_t, group_size=group)
    q_j, s_j = jax_host_quantize(w_np, group_size=group)
    np.testing.assert_array_equal(q.numpy(), q_j)
    np.testing.assert_array_equal(s.numpy(), s_j)
    assert s.shape == ((3, 96) if group is None else (3, 2, 96))


def test_other_floats_go_through_f32():
    w = torch.randn(64, 32, dtype=torch.float64)
    q, s = native.host_symmetric_quantize(w)
    q_t, s_t = symmetric_quantize(w)
    assert torch.equal(q, q_t) and torch.equal(s, s_t)


def test_pack_int4_is_the_ports_layout():
    q = torch.from_numpy(np.random.default_rng(1).integers(-8, 8, (512, 256), np.int8))
    packed = native.host_pack_int4(q)
    assert torch.equal(packed, pack_weights(q, bits=4).data)
    assert torch.equal(packed[3] & 0x0F, q[6] & 0x0F)  # rows 2i (low) and 2i + 1 (high)
    assert torch.equal(packed[3] >> 4, q[7])


def test_transpose():
    a = torch.from_numpy(np.random.default_rng(2).integers(-128, 128, (300, 513), np.int8))
    assert torch.equal(native.host_transpose_i8(a), a.t())


def test_disable_native_is_the_torch_path(monkeypatch):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((3, 128, 64)).astype(np.float32)).to(torch.bfloat16)
    q4 = torch.from_numpy(rng.integers(-8, 8, (128, 64), np.int8))
    a = torch.from_numpy(rng.integers(-128, 128, (33, 65), np.int8))
    native_out = [native.host_symmetric_quantize(w, 4, 32), native.host_pack_int4(q4),
                  native.host_transpose_i8(a)]
    monkeypatch.setenv("EETQ_DISABLE_NATIVE", "1")
    assert not native.native_available()
    plain = [native.host_symmetric_quantize(w, 4, 32), native.host_pack_int4(q4),
             native.host_transpose_i8(a)]
    assert all(torch.equal(x, y) for x, y in zip(native_out[0], plain[0]))
    assert torch.equal(native_out[1], plain[1]) and torch.equal(native_out[2], plain[2])


def test_refusals():
    with pytest.raises(ValueError, match="CPU tensor"):
        native.host_symmetric_quantize(torch.empty(4, 4, device="meta"))
    with pytest.raises(ValueError, match="must divide"):
        native.host_symmetric_quantize(torch.zeros(100, 8), group_size=64)
    with pytest.raises(ValueError, match="bits"):
        native.host_symmetric_quantize(torch.zeros(64, 8), bits=2)
    with pytest.raises(ValueError, match="even K"):
        native.host_pack_int4(torch.zeros(3, 8, dtype=torch.int8))


def test_a_build_that_fails_raises(tmp_path, monkeypatch):
    bad = tmp_path / "quantizer.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build.__wrapped__()
