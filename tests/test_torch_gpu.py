"""The port's CUDA kernels against their plain versions, on a CUDA device.

These need the card and nvcc; without a CUDA device each test skips. On
the card (a machine without JAX, hence no conftest):
python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
(`chip_smoke.py` checks the same kernels at the llama2-7b shapes.)
"""

import pytest
import torch

from eetq_tpu_torch.kernels import KERNELS
from eetq_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_int8,
    flash_decode_int8_ref,
    flash_decode_ref,
)
from eetq_tpu_torch.kernels.mlp_fused import fused_mlp_gemv, fused_mlp_ref
from eetq_tpu_torch.kernels.w8a8 import quantize_activations, w8a8_gemm, w8a8_gemm_ref
from eetq_tpu_torch.kernels.w8a16 import w8a16_gemm, w8a16_gemv, w8a16_matmul_ref
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.ops.linear8 import w8a8_matmul
from eetq_tpu_torch.ops.rmsnorm import rmsnorm

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(out, ref):
    """Four bf16 ulps of the largest output (see chip_smoke.TOL)."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2**-6 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("m", [1, 3, 8, 9, 200])
@pytest.mark.parametrize("norm", [False, True])
def test_w8a16_kernels(dev, m, norm):
    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 1000, 300  # packed to 1024 x 384; only n columns are written
    q = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    packed = pack_weights(q)
    scales = torch.rand(n, generator=g, device=dev) * 1e-2
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    y = rmsnorm(x, gamma, 1e-5) if norm else x
    ref = w8a16_matmul_ref(y, q, scales, bias)
    if m <= 8:
        out = w8a16_gemv(x, packed.data, scales, n, bias, gamma if norm else None, 1e-5)
    else:
        out = w8a16_gemm(y, packed.data, scales, n, bias)
    assert out.shape == (m, n)
    _close(out, ref)


@pytest.mark.parametrize("s,hq,hkv,d", [(1, 4, 4, 128), (77, 8, 2, 64), (300, 4, 1, 128)])
def test_flash_attention(dev, s, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(2, s, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(2, s, 2 * hkv, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = kv[:, :, :hkv], kv[:, :, hkv:]
    _close(flash_attention(q, k, v), flash_attention_ref(q, k, v))


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (8, 2, 128), (16, 2, 64)])
def test_flash_decode(dev, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(hq)
    q = torch.randn(3, 1, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn(3, hkv, 384, d, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(3, hkv, 384, d, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([1, 200, 384], dtype=torch.int32, device=dev)
    _close(flash_decode(q, kc, vc, lengths), flash_decode_ref(q, kc, vc, lengths))


@pytest.mark.parametrize("m,k,n", [(1, 1000, 300), (37, 4096, 4096), (200, 11008, 4096),
                                   (1024, 4096, 12288)])
def test_w8a8_gemm_bit_identical(dev, m, k, n):
    """The integer sum is exact and the epilogue rounds as the plain version
    does, so the kernel's output is bit-identical to it."""
    g = torch.Generator(device=dev).manual_seed(m)
    packed = pack_weights(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                        dtype=torch.int8))
    scales = torch.rand(n, generator=g, device=dev) * 1e-2
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16) if m < 100 else None
    xq, sx = quantize_activations(torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16))
    xq = torch.nn.functional.pad(xq, (0, packed.kp - k)).contiguous()
    out = w8a8_gemm(xq, sx, packed.data, scales, n, bias)
    torch.cuda.synchronize()
    assert out.shape == (m, n)
    assert torch.equal(out, w8a8_gemm_ref(xq, sx, packed.data, scales, n, bias))


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("shape", [(1000, 256, 300), (4096, 11008, 4096)])
def test_fused_mlp_gemv(dev, m, act, shape):
    k, i, n = shape  # K and N need not be tile multiples; I must be
    g = torch.Generator(device=dev).manual_seed(m)
    gu = pack_weights(torch.randint(-127, 128, (k, 2 * i), generator=g, device=dev,
                                    dtype=torch.int8))
    dn = pack_weights(torch.randint(-127, 128, (i, n), generator=g, device=dev,
                                    dtype=torch.int8))
    gu_s = torch.rand(2 * i, generator=g, device=dev) * 2e-3 + 1e-4
    dn_s = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    for res in (None, torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)):
        out = fused_mlp_gemv(x, gamma, 1e-5, gu.data, gu_s, dn.data, dn_s, n, res, act)
        assert out.shape == (m, n)
        _close(out, fused_mlp_ref(x, gamma, gu.data[:k], gu_s, dn.data[:, :n], dn_s, 1e-5,
                                  act, res))


@pytest.mark.parametrize("b,l,hq,hkv,d", [(1, 1152, 32, 32, 128), (8, 2048, 32, 8, 128),
                                          (3, 384, 16, 2, 64), (2, 256, 8, 8, 64)])
def test_flash_decode_int8(dev, b, l, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(b)
    q = torch.randn(b, 1, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kc, ks = quantize_activations(torch.randn(b, hkv, l, d, generator=g, device=dev))
    vc, vs = quantize_activations(torch.randn(b, hkv, l, d, generator=g, device=dev))
    lengths = torch.tensor([1, l, l // 2 + 3, 17, 1000 % l, 5, l - 1, 64][:b],
                           dtype=torch.int32, device=dev)
    _close(flash_decode_int8(q, kc, vc, ks, vs, lengths),
           flash_decode_int8_ref(q, kc, vc, ks, vs, lengths))


def test_unsupported_variants_raise(dev):
    x = torch.zeros(1, 128, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(128, 128, dtype=torch.int8, device=dev)
    with pytest.raises(NotImplementedError):  # group-wise scales
        w8a16_gemv(x, w, torch.ones(2, 128, device=dev), 128)
    with pytest.raises(TypeError):  # f32 activations
        w8a16_gemv(x.float(), w, torch.ones(128, device=dev), 128)
    q = torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):  # sliding window
        flash_attention(q, q, q, window=2)
    cache = torch.zeros(1, 2, 128, 128, dtype=torch.bfloat16, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):  # multi-query decode
        flash_decode(q, cache, cache, lengths)
    i8 = torch.zeros(1, 2, 128, 128, dtype=torch.int8, device=dev)
    sc = torch.ones(1, 2, 128, device=dev)
    with pytest.raises(NotImplementedError):  # multi-query int8 decode
        flash_decode_int8(q, i8, i8, sc, sc, lengths)
    with pytest.raises(TypeError):  # a bf16 cache handed to the int8 kernel
        flash_decode_int8(q[:, :1], cache, cache, sc, sc, lengths)
    xq = torch.zeros(1, 128, dtype=torch.int8, device=dev)
    with pytest.raises(NotImplementedError):  # group-wise W8A8
        w8a8_gemm(xq, torch.ones(1, device=dev), w, torch.ones(2, 128, device=dev), 128)
    with pytest.raises(ValueError):  # group-wise int8 stays on the W8A16 path
        w8a8_matmul(x, pack_weights(w), torch.ones(2, 128, device=dev))
    gu = torch.zeros(128, 256, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):  # more rows than the decode regime
        fused_mlp_gemv(torch.zeros(9, 128, dtype=torch.bfloat16, device=dev),
                       torch.ones(128, device=dev), 1e-5, gu, torch.ones(256, device=dev),
                       w, torch.ones(128, device=dev), 128)


def test_every_kernel_counts_its_launches(dev):
    before = {name: fn.launches for name, fn in KERNELS.items()}
    test_w8a16_kernels(dev, 1, True)
    test_w8a16_kernels(dev, 9, False)
    test_flash_attention(dev, 77, 8, 2, 64)
    test_flash_decode(dev, 8, 2, 128)
    test_w8a8_gemm_bit_identical(dev, 200, 11008, 4096)
    test_flash_decode_int8(dev, 3, 384, 16, 2, 64)
    after = {name: fn.launches for name, fn in KERNELS.items()}
    test_fused_mlp_gemv(dev, 1, "silu", (1000, 256, 300))  # two calls: with and without residual
    assert all(after[name] == before[name] + 1 for name in KERNELS if name != "fused_mlp_gemv")
    assert KERNELS["fused_mlp_gemv"].launches == before["fused_mlp_gemv"] + 2
