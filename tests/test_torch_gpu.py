"""The port's CUDA kernels against their plain versions, on a CUDA device.

These need the card and nvcc; without a CUDA device each test skips. On
the card (a machine without JAX, hence no conftest):
python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
(`chip_smoke.py` checks the same kernels at the llama2-7b and Mixtral
shapes.)
"""

import pytest
import torch

from eetq_tpu_torch.kernels import KERNELS
from eetq_tpu_torch.kernels.autotune import GEMV_BLOCK_N, gemv_splits, sm_count
from eetq_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_int8,
    flash_decode_int8_ref,
    flash_decode_ref,
    gather_pool,
    paged_flash_decode,
    paged_flash_decode_int8,
    paged_flash_decode_int8_ref,
    paged_flash_decode_ref,
)
from eetq_tpu_torch.kernels.mlp_fused import fused_mlp_gemv, fused_mlp_gemv_i4, fused_mlp_ref
from eetq_tpu_torch.kernels.w8a8 import (
    quantize_activations,
    w4a8_gemm,
    w8a8_gemm,
    w8a8_gemm_ref,
)
from eetq_tpu_torch.kernels.w8a16 import (
    expert_matmul_ref,
    grouped_matmul_ref,
    w4a16_expert_gemv,
    w4a16_gemm,
    w4a16_gemv,
    w4a16_grouped_gemm,
    w8a16_expert_gemv,
    w8a16_gemm,
    w8a16_gemv,
    w8a16_grouped_gemm,
    w8a16_matmul_ref,
)
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.modules import moe as moe_mod
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear
from eetq_tpu_torch.ops.linear8 import w8a8_matmul
from eetq_tpu_torch.ops.moe import w8a16_expert_matmul
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


def _twice(fn):
    """fn() twice: the two outputs must be bit-equal (the GEMV sums the
    partials of its K split in a fixed order, with no float atomics)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    return first


GEMV_GROUPS = [None, 32, 64, 96, 128]


@pytest.mark.parametrize("norm", [False, True], ids=["x", "prenorm"])
@pytest.mark.parametrize("group", GEMV_GROUPS, ids=["per-channel", "g32", "g64", "g96", "g128"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", range(1, 9))
def test_gemv_modes(dev, m, bits, group, norm):
    """Every row count of the tensor-core GEMV, int8 and int4, per-channel and
    group-wise, with and without the RMSNorm prologue, on an odd (K, N) with
    bias: K = 1000 (per-channel) or 1152 (a whole number of every group size)
    is padded to 1024 or 1152 rows, N = 300 to 384 columns."""
    g = torch.Generator(device=dev).manual_seed(100 * m + bits)
    k, n = (1000 if group is None else 1152), 300
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    scales = _scales(g, dev, k, n, group)
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    gemv = w4a16_gemv if bits == 4 else w8a16_gemv
    out = _twice(lambda: gemv(x, data, scales, n, bias, gamma if norm else None, 1e-5))
    assert out.shape == (m, n)
    _close(out, w8a16_matmul_ref(rmsnorm(x, gamma, 1e-5) if norm else x, q, scales, bias))


@pytest.mark.parametrize("k", [4096, 11008, 14336])
@pytest.mark.parametrize("group", [None, 128], ids=["per-channel", "g128"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8])
def test_gemv_split_shapes(dev, m, bits, group, k):
    """N = 4096 (o_proj, llama's and Mixtral's down): 32 column strips, so K
    is split across blocks and the strip's last block sums the partials."""
    g = torch.Generator(device=dev).manual_seed(k + m)
    n = 4096
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    assert gemv_splits(data.shape[0], n // GEMV_BLOCK_N, 1, bits, m, group or 0,
                       sm_count(dev.index)) > 1
    scales = _scales(g, dev, k, n, group)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    gemv = w4a16_gemv if bits == 4 else w8a16_gemv
    _close(_twice(lambda: gemv(x, data, scales, n)), w8a16_matmul_ref(x, q, scales))


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


def _scales(g, dev, k, n, group):
    shape = (n,) if group is None else (k // group, n)
    return torch.rand(shape, generator=g, device=dev) * 1e-2 + 1e-4


@pytest.mark.parametrize("m", [1, 3, 4, 8, 9, 200])  # m = 4 at K = 4096, g = 32: 48 KB of x and scales
@pytest.mark.parametrize("k,group", [(1000, None), (960, 64), (1024, 128), (4096, 32)])
@pytest.mark.parametrize("bits", [4, 8])
def test_group_wise_and_int4_kernels(dev, m, k, group, bits):
    """The GEMV and the GEMM on int4 weights (per-channel and group-wise) and
    on int8 weights with group-wise scales; K = 1000 and 960 need padding."""
    g = torch.Generator(device=dev).manual_seed(m)
    n = 300
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    scales = _scales(g, dev, k, n, group)
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    gemv, gemm = (w4a16_gemv, w4a16_gemm) if bits == 4 else (w8a16_gemv, w8a16_gemm)
    if m <= 8:
        out = gemv(x, data, scales, n, bias, gamma, 1e-5)
        ref = w8a16_matmul_ref(rmsnorm(x, gamma, 1e-5), q, scales, bias)
    else:
        out = gemm(x, data, scales, n, bias)
        ref = w8a16_matmul_ref(x, q, scales, bias)
    assert out.shape == (m, n)
    _close(out, ref)


@pytest.mark.parametrize("group", [None, 128])
def test_w4a16_gemv_stages_x_in_chunks(dev, group):
    """m = 8 at K = 14336: x and, group-wise, the scale rows do not fit
    shared memory whole; the K split stages them in parts."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randint(-8, 8, (14336, 256), generator=g, device=dev, dtype=torch.int8)
    scales = _scales(g, dev, 14336, 256, group)
    x = torch.randn(8, 14336, generator=g, device=dev).to(torch.bfloat16)
    _close(w4a16_gemv(x, pack_weights(q, bits=4).data, scales, 256),
           w8a16_matmul_ref(x, q, scales))


@pytest.mark.parametrize("m,k,n", [(1, 1000, 300), (37, 4096, 4096), (200, 11008, 4096),
                                   (1024, 4096, 12288), (37, 1000, 300), (200, 1000, 300),
                                   (1024, 1000, 300)])
@pytest.mark.parametrize("group", [None, 32, 64, 96, 128])
def test_w4a8_gemm(dev, m, k, n, group):
    """Per-channel: the integer sum is exact and the epilogue rounds as the
    plain version does, so the output is bit-identical. Group-wise: the f32
    sum over groups runs in another order."""
    if group is not None:
        k = k // group * group  # 1000 -> 992, 960, 896: still padded to 1024
    g = torch.Generator(device=dev).manual_seed(m)
    q = torch.randint(-8, 8, (k, n), generator=g, device=dev, dtype=torch.int8)
    packed = pack_weights(q, bits=4)
    scales = _scales(g, dev, k, n, group)
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16) if m < 100 else None
    xq, sx = quantize_activations(torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16))
    xq = torch.nn.functional.pad(xq, (0, packed.kp - k)).contiguous()
    out = w4a8_gemm(xq, sx, packed.data, scales, n, bias, group)
    ref = w8a8_gemm_ref(xq, sx, torch.nn.functional.pad(q, (0, 0, 0, packed.kp - k)), scales, n,
                        bias, group_size=group)
    torch.cuda.synchronize()
    assert out.shape == (m, n)
    if group is None:
        assert torch.equal(out, ref)
    else:
        _close(out, ref)


@pytest.mark.parametrize("m", [1, 3, 4, 8])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("shape", [(1000, 256, 300), (4096, 11008, 4096)])
def test_fused_mlp_gemv_i4(dev, m, act, shape):
    k, i, n = shape  # K and N need not be tile multiples; I must be
    g = torch.Generator(device=dev).manual_seed(m)
    gu = torch.randint(-8, 8, (k, 2 * i), generator=g, device=dev, dtype=torch.int8)
    dn = torch.randint(-8, 8, (i, n), generator=g, device=dev, dtype=torch.int8)
    gu_d, dn_d = pack_weights(gu, bits=4).data, pack_weights(dn, bits=4).data
    gu_s, dn_s = _scales(g, dev, k, 2 * i, None), _scales(g, dev, i, n, None)
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    for res in (None, torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)):
        out = fused_mlp_gemv_i4(x, gamma, 1e-5, gu_d, gu_s, dn_d, dn_s, n, res, act)
        assert out.shape == (m, n)
        _close(out, fused_mlp_ref(x, gamma, gu, gu_s, dn, dn_s, 1e-5, act, res))


def test_w8a16_gemv_stages_x_in_chunks(dev):
    """m = 8 at K = 14336 (Mixtral's down projection) does not fit shared
    memory whole: the K split stages x in parts."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randint(-127, 128, (14336, 256), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand(256, generator=g, device=dev) * 1e-3
    x = torch.randn(8, 14336, generator=g, device=dev).to(torch.bfloat16)
    _close(w8a16_gemv(x, q, scales, 256), w8a16_matmul_ref(x, q, scales))


def _bank(g, dev, e, k, n):
    q = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    return pack_weights(q), torch.rand(e, n, generator=g, device=dev) * 1e-3 + 1e-4


@pytest.mark.parametrize("m,k,ids", [(1, 1000, [3, 0]), (4, 4096, [1, 1, 2, 0, 3, 2, 2, 0]),
                                     (8, 14336, [0, 2, 2, 1, 3, 0, 1, 3])])
def test_w8a16_expert_gemv(dev, m, k, ids):
    g = torch.Generator(device=dev).manual_seed(m)
    n = 300 if k == 1000 else 512
    bank, scales = _bank(g, dev, 4, k, n)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    eids = torch.tensor(ids, dtype=torch.int32, device=dev)
    out = w8a16_expert_gemv(x, bank.data, scales, eids, n)
    assert out.shape == (len(ids), m, n)
    _close(out, expert_matmul_ref(x, bank.data[:, :k, :n], scales, eids))


@pytest.mark.parametrize("bm,nb,k", [(8, 10, 1000), (128, 5, 4096), (40, 6, 1024)])
def test_w8a16_grouped_gemm(dev, bm, nb, k):
    g = torch.Generator(device=dev).manual_seed(bm)
    n = 300
    bank, scales = _bank(g, dev, 4, k, n)
    be = torch.randint(0, 4, (nb,), generator=g, device=dev, dtype=torch.int32)
    x = torch.randn(nb * bm, k, generator=g, device=dev).to(torch.bfloat16)
    x[-bm:] = 0  # a padding block
    out = w8a16_grouped_gemm(x, bank.data, scales, be, n)
    assert out.shape == (nb * bm, n)
    _close(out, grouped_matmul_ref(x, bank.data[:, :k, :n], scales, be, bm))
    assert not out[-bm:].any()


def _bank_modes(g, dev, e, k, n, bits, group):
    """A random bank in one of the MoE kernels' modes: (logical int8
    [E, K, N], packed data, scales [E, N] or [E, K/g, N])."""
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    shape = (e, n) if group is None else (e, k // group, n)
    return q, pack_weights(q, bits=bits).data, torch.rand(shape, generator=g,
                                                          device=dev) * 1e-2 + 1e-4


BANK_MODES = [(4, 1000, None), (4, 960, 64), (4, 4096, 128), (8, 960, 64), (8, 4096, 32)]


@pytest.mark.parametrize("bits,k,group", BANK_MODES)
@pytest.mark.parametrize("m,ids", [(1, [3, 0]), (4, [1, 1, 2, 0, 3, 2, 2, 0]), (8, [2, 2, 1])])
def test_expert_gemv_int4_and_group_wise_banks(dev, bits, k, group, m, ids):
    """K = 1000 and 960 need padding, N = 300 too; ids repeat."""
    g = torch.Generator(device=dev).manual_seed(m + k)
    n = 300
    q, data, scales = _bank_modes(g, dev, 4, k, n, bits, group)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    eids = torch.tensor(ids, dtype=torch.int32, device=dev)
    kernel = w4a16_expert_gemv if bits == 4 else w8a16_expert_gemv
    out = kernel(x, data, scales, eids, n)
    assert out.shape == (len(ids), m, n)
    _close(out, expert_matmul_ref(x, q, scales, eids))


def test_expert_gemv_int4_stages_x_in_chunks(dev):
    """m = 8 at K = 14336 (Mixtral's down projection) with 128-row groups."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, data, scales = _bank_modes(g, dev, 3, 14336, 256, 4, 128)
    x = torch.randn(8, 14336, generator=g, device=dev).to(torch.bfloat16)
    eids = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    _close(w4a16_expert_gemv(x, data, scales, eids, 256), expert_matmul_ref(x, q, scales, eids))


@pytest.mark.parametrize("bits,k,group", BANK_MODES)
@pytest.mark.parametrize("bm,nb", [(8, 10), (128, 5), (40, 6)])
def test_grouped_gemm_int4_and_group_wise_banks(dev, bits, k, group, bm, nb):
    g = torch.Generator(device=dev).manual_seed(bm + k)
    n = 300
    q, data, scales = _bank_modes(g, dev, 4, k, n, bits, group)
    be = torch.randint(0, 4, (nb,), generator=g, device=dev, dtype=torch.int32)
    x = torch.randn(nb * bm, k, generator=g, device=dev).to(torch.bfloat16)
    x[-bm:] = 0  # a padding block
    kernel = w4a16_grouped_gemm if bits == 4 else w8a16_grouped_gemm
    out = kernel(x, data, scales, be, n)
    assert out.shape == (nb * bm, n)
    _close(out, grouped_matmul_ref(x, q, scales, be, bm))
    assert not out[-bm:].any()


def _grouped_case(g, dev, bits, k, n, group, bm, experts):
    """x [len(experts) * bm, k] and a bank of 4 experts in one mode: (x,
    logical bank, packed data, scales, block ids)."""
    q, data, scales = _bank_modes(g, dev, 4, k, n, bits, group)
    x = torch.randn(len(experts) * bm, k, generator=g, device=dev).to(torch.bfloat16)
    return x, q, data, scales, torch.tensor(experts, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("bm", [8, 16, 40, 64, 128])
@pytest.mark.parametrize("group", [None, 32, 96, 128], ids=["per-channel", "g32", "g96", "g128"])
@pytest.mark.parametrize("bits", [8, 4])
def test_grouped_gemm_designs(dev, bits, group, bm):
    """Both designs of csrc/wgmma_grouped.cuh (the skinny tile up to
    GROUPED_SKINNY_BM rows, the 128-row tile above) in every scale mode:
    K = 1152 holds 36, 12 and 9 groups of 32, 96 and 128 rows (g = 32 and 96
    close groups in the middle of a 64-deep K step), N = 320 ends inside a
    column strip; ids repeat, and the last block is padding behind the
    count of real blocks."""
    g = torch.Generator(device=dev).manual_seed(bits * 1000 + bm + (group or 0))
    x, q, data, scales, be = _grouped_case(g, dev, bits, 1152, 320, group, bm, [2, 0, 0, 3, 1, 1])
    x[-bm:] = 0
    kernel = w4a16_grouped_gemm if bits == 4 else w8a16_grouped_gemm
    count = torch.tensor([5], dtype=torch.int32, device=dev)
    out = kernel(x, data, scales, be, 320, count)
    _close(out, grouped_matmul_ref(x, q, scales, be, bm))
    assert not out[-bm:].any()


@pytest.mark.parametrize("bm", [8, 16, 128])
@pytest.mark.parametrize("bits,k,n,group", [(8, 1000, 300, None), (4, 1000, 300, None),
                                            (4, 960, 300, 64), (8, 4096, 4096, 128)])
def test_grouped_gemm_one_block_and_odd_shapes(dev, bits, k, n, group, bm):
    """nb = 1, and K, N that need padding (odd N: rows of out are not
    16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(k + bm)
    x, q, data, scales, be = _grouped_case(g, dev, bits, k, n, group, bm, [3])
    kernel = w4a16_grouped_gemm if bits == 4 else w8a16_grouped_gemm
    _close(kernel(x, data, scales, be, n), grouped_matmul_ref(x, q, scales, be, bm))


@pytest.mark.parametrize("bm", [8, 128])
@pytest.mark.parametrize("bits,group", [(8, None), (4, 128)])
def test_grouped_gemm_skips_padding_blocks(dev, bits, group, bm):
    """Blocks at or past the count come out zero however their rows of x
    look, without reading the bank; the real blocks are the same, bit for
    bit, as without the count, which computes every block."""
    g = torch.Generator(device=dev).manual_seed(bm + bits)
    x, q, data, scales, be = _grouped_case(g, dev, bits, 1024, 512, group, bm, [1, 2, 2, 3, 3, 3])
    kernel = w4a16_grouped_gemm if bits == 4 else w8a16_grouped_gemm
    count = torch.tensor([3], dtype=torch.int32, device=dev)
    skipped, full = kernel(x, data, scales, be, 512, count), kernel(x, data, scales, be, 512)
    torch.cuda.synchronize()
    assert not skipped[3 * bm:].any()
    assert torch.equal(skipped[:3 * bm], full[:3 * bm])
    _close(full, grouped_matmul_ref(x, q, scales, be, bm))
    assert full[3 * bm:].any()


@pytest.mark.parametrize("tokens", [1, 4, 17])
def test_moe_apply_int4_groups_on_the_card(dev, tokens):
    """The three regimes over int4 banks with 64-row groups, no host sync."""
    g = torch.Generator(device=dev).manual_seed(tokens)
    h, inter, e = 256, 512, 8
    dense = moe_mod.MoEMLP(
        DenseLinear((torch.randn(h, e, generator=g, device=dev) / 16).to(torch.bfloat16)),
        DenseLinear((torch.randn(e, h, 2 * inter, generator=g, device=dev) / 16).to(
            torch.bfloat16)),
        DenseLinear((torch.randn(e, inter, h, generator=g, device=dev) / 22).to(torch.bfloat16)))
    moe = moe_mod.quantize_moe(dense, bits=4, group_size=64)
    x = torch.randn(1, tokens, h, generator=g, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe_mod.moe_apply(moe, x, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _close(out, moe_mod.moe_apply(moe, x, 2, use_kernel=False))


def _paged_case(g, dev, b, hq, hkv, d, bs, max_blocks, nblocks, int8):
    """Random pools behind a random table, rows of odd lengths (one token, a
    block edge, mid-block, the whole table), and the table the kernel gets:
    entries past each row's last live block point far out of the pool."""
    table = torch.randperm(nblocks, generator=g, device=dev)[:b * max_blocks].reshape(
        b, max_blocks).to(torch.int32).contiguous()
    top = max_blocks * bs
    lengths = torch.tensor([1, bs, top, bs + 1, top - 77, 17, 2 * bs - 1, 333 % top][:b],
                           dtype=torch.int32, device=dev)
    live = torch.arange(max_blocks, device=dev)[None] * bs < lengths[:, None]
    wild = torch.where(live, table, torch.full_like(table, 2 ** 30))
    q = torch.randn(b, 1, hq, d, generator=g, device=dev).to(torch.bfloat16)
    pools = [torch.randn(nblocks, hkv, bs, d, generator=g, device=dev) for _ in range(2)]
    if int8:
        (k, ks), (v, vs) = (quantize_activations(t) for t in pools)
        return q, (k, v, ks, vs), table, wild, lengths
    return q, tuple(t.to(torch.bfloat16) for t in pools), table, wild, lengths


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b,hq,hkv,d,bs,max_blocks", [
    (8, 32, 32, 128, 256, 8), (8, 32, 8, 128, 256, 8), (3, 8, 8, 64, 128, 3),
    (5, 16, 4, 64, 384, 2), (2, 8, 1, 128, 128, 5), (1, 4, 2, 128, 128, 1)])
def test_paged_flash_decode(dev, b, hq, hkv, d, bs, max_blocks, int8):
    """Against the plain version, and bit-equal to the dense kernel on the
    cache gathered through the table (the same chunks, tiles and order);
    groups 1, 2, 4 and 8, D 64 and 128, blocks of 128, 256 and 384 keys."""
    g = torch.Generator(device=dev).manual_seed(b + hq)
    q, pools, table, wild, lengths = _paged_case(g, dev, b, hq, hkv, d, bs, max_blocks,
                                                 b * max_blocks + 7, int8)
    kernel, ref, dense = ((paged_flash_decode_int8, paged_flash_decode_int8_ref,
                           flash_decode_int8) if int8
                          else (paged_flash_decode, paged_flash_decode_ref, flash_decode))
    out = kernel(q, *pools, wild, lengths)
    assert out.shape == (b, 1, hq, d)
    _close(out, ref(q, *pools, table, lengths))
    assert torch.equal(out, dense(q, *(gather_pool(t, table) for t in pools), lengths))


def _decode_calls(g, dev, mode, b, hq, hkv, d, lengths, l=2048, bs=256):
    """(kernel call, plain call) of one flash-decode entry point on random
    caches of l keys a row (paged: pools of bs-key blocks behind a permuted
    table) and the given lengths."""
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(b, 1, hq, d, generator=g, device=dev).to(torch.bfloat16)
    int8, paged = "int8" in mode, mode.startswith("paged")
    shape = (b * l // bs + 3, hkv, bs, d) if paged else (b, hkv, l, d)
    caches = [torch.randn(shape, generator=g, device=dev) for _ in range(2)]
    if int8:
        (k, ks), (v, vs) = (quantize_activations(t) for t in caches)
        caches = (k, v, ks, vs)
    else:
        caches = tuple(t.to(torch.bfloat16) for t in caches)
    if not paged:
        kernel, ref = ((flash_decode_int8, flash_decode_int8_ref) if int8
                       else (flash_decode, flash_decode_ref))
        return (lambda: kernel(q, *caches, lengths)), (lambda: ref(q, *caches, lengths))
    table = torch.randperm(shape[0], generator=g, device=dev)[:b * (l // bs)].reshape(
        b, l // bs).to(torch.int32).contiguous()
    kernel, ref = ((paged_flash_decode_int8, paged_flash_decode_int8_ref) if int8
                   else (paged_flash_decode, paged_flash_decode_ref))
    return (lambda: kernel(q, *caches, table, lengths)), (lambda: ref(q, *caches, table, lengths))


DECODE_MODES = ["dense", "dense_int8", "paged", "paged_int8"]


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("b,hq,hkv,d,lengths", [
    (1, 32, 32, 128, [1074]), (8, 32, 8, 128, [1, 2048, 17, 1500, 300, 1024, 640, 2047]),
    (3, 16, 2, 64, [129, 64, 1])])
def test_flash_decode_repeats_bit_equal(dev, mode, b, hq, hkv, d, lengths):
    """Two launches give bit-equal outputs: the chunks' states are merged in
    chunk order by one block, with no float atomics."""
    g = torch.Generator(device=dev).manual_seed(b)
    kernel, ref = _decode_calls(g, dev, mode, b, hq, hkv, d, lengths)
    out = _twice(kernel)
    _close(out, ref())


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("hq,hkv", [(32, 32), (32, 8)])
def test_flash_decode_long_rows_beside_rows_of_one_key(dev, mode, hq, hkv):
    """B = 8 rows of the cache's whole length L = 2048 beside rows of one key:
    the long rows' chunks merge across blocks, the short rows write at once."""
    g = torch.Generator(device=dev).manual_seed(hkv)
    kernel, ref = _decode_calls(g, dev, mode, 8, hq, hkv, 128, [2048, 1, 2048, 1, 1, 2048, 1, 2048])
    _close(kernel(), ref())


def test_paged_flash_decode_idle_rows_beside_live_rows(dev):
    """Idle rows of an engine (length 1 in the zeroed trash block 0) beside
    live rows: the idle rows' outputs are zeros, the live rows' agree with
    the plain version, for bf16 and int8 pools."""
    g = torch.Generator(device=dev).manual_seed(5)
    b, hq, hkv, bs, max_blocks = 6, 16, 4, 128, 4
    idle = torch.tensor([True, False, True, False, True, True], device=dev)
    q = torch.randn(b, 1, hq, 128, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.where(idle, 1, torch.tensor([0, 300, 0, 512, 0, 0], device=dev)).to(
        torch.int32)
    table = (1 + torch.arange(b * max_blocks, device=dev, dtype=torch.int32)).reshape(b, max_blocks)
    table[idle] = 0
    pools = [torch.randn(b * max_blocks + 1, hkv, bs, 128, generator=g, device=dev)
             for _ in range(2)]
    for t in pools:
        t[0] = 0
    k, v = (t.to(torch.bfloat16) for t in pools)
    out = paged_flash_decode(q, k, v, table, lengths)
    (k8, ks), (v8, vs) = (quantize_activations(t) for t in pools)
    out8 = paged_flash_decode_int8(q, k8, v8, ks, vs, table, lengths)
    torch.cuda.synchronize()
    assert not out[idle].any() and not out8[idle].any()
    _close(out[~idle], paged_flash_decode_ref(q, k, v, table, lengths)[~idle])
    _close(out8[~idle], paged_flash_decode_int8_ref(q, k8, v8, ks, vs, table, lengths)[~idle])


@pytest.mark.parametrize("mode", DECODE_MODES)
def test_flash_decode_is_one_launch(dev, mode):
    """One kernel launch per call (torch.profiler), with rows whose chunks
    merge across blocks: the merge runs in the same launch."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=dev).manual_seed(1)
    kernel, _ = _decode_calls(g, dev, mode, 8, 32, 8, 128, [2048, 1, 640, 1500, 17, 1, 300, 1024])
    kernel()  # the scratch is allocated (and its counters zeroed) once, here
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "flash_decode" in names[0], names


def test_paged_flash_decode_idle_rows_in_the_trash_block(dev):
    """Every row of length 1 in block 0 of a zeroed pool, as the idle slots
    of an engine: finite output (zeros), for bf16 and int8 pools."""
    q = torch.randn(4, 1, 8, 128, device=dev).to(torch.bfloat16)
    table = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    lengths = torch.ones(4, dtype=torch.int32, device=dev)
    pool = torch.zeros(3, 8, 256, 128, dtype=torch.bfloat16, device=dev)
    out = paged_flash_decode(q, pool, pool, table, lengths)
    i8, sc = pool.to(torch.int8), torch.zeros(3, 8, 256, device=dev)
    out8 = paged_flash_decode_int8(q, i8, i8, sc, sc, table, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and not out.any() and not out8.any()


@pytest.mark.parametrize("tokens", [1, 4, 17])
def test_moe_apply_on_the_card_makes_no_host_sync(dev, tokens):
    """The gather (2 and 8 selections) and the grouped regime (34): ids and
    blocks stay on the card, and the output agrees with the plain path."""
    g = torch.Generator(device=dev).manual_seed(tokens)
    h, inter, e = 256, 512, 8
    gu, gs = _bank(g, dev, e, h, 2 * inter)
    dn, ds = _bank(g, dev, e, inter, h)
    router = DenseLinear((torch.randn(h, e, generator=g, device=dev) / 16).to(torch.bfloat16))
    moe = moe_mod.MoEMLP(router, QuantLinear(gu, gs), QuantLinear(dn, ds))
    x = torch.randn(1, tokens, h, generator=g, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe_mod.moe_apply(moe, x, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _close(out, moe_mod.moe_apply(moe, x, 2, use_kernel=False))


@pytest.mark.parametrize("s,hq,hkv,d", [(1, 4, 4, 128), (77, 8, 2, 64), (300, 4, 1, 128)])
def test_flash_attention(dev, s, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(2, s, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(2, s, 2 * hkv, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = kv[:, :, :hkv], kv[:, :, hkv:]
    _close(flash_attention(q, k, v), flash_attention_ref(q, k, v))


# (batch, sq, skv, q heads, kv heads, head_dim, causal): ragged lengths in
# one- and two-warpgroup tiles, GQA, a query block appended to a cache
# (delta = skv - sq = 256), a batch of short prompts, full attention
FLASH_EDGES = [
    (1, 77, 77, 32, 8, 128, True), (1, 1000, 1000, 32, 8, 128, True),
    (1, 1000, 1000, 32, 32, 64, True), (2, 77, 77, 8, 2, 64, True),
    (1, 128, 384, 32, 8, 128, True), (1, 200, 456, 8, 8, 64, True),
    (4, 128, 128, 32, 32, 128, True), (1, 1024, 1024, 32, 32, 128, True),
    (2, 130, 130, 4, 4, 128, False), (1, 300, 77, 8, 1, 128, False),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", FLASH_EDGES)
def test_flash_attention_edges(dev, b, sq, skv, hq, hkv, d, causal):
    g = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(b, skv, 2 * hkv, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = kv[:, :, :hkv], kv[:, :, hkv:]  # strided views of one tensor
    out = flash_attention(q, k, v, causal=causal)
    assert out.shape == q.shape and out.is_contiguous()
    _close(out, flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("m", [9, 64, 65, 200, 512, 700, 1024])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11008, 4096), (1000, 300), (4096, 32000),
                                 (264, 1096)])
@pytest.mark.parametrize("bits", [8, 4])
def test_dense_gemm_per_channel_edges(dev, m, k, n, bits):
    """The per-channel GEMM tile: row counts off the 64- and 128-row tiles, K
    that needs padding (1000 pads to 1024, 264 to 384), N off
    the 128-column tile and off the 16-byte row alignment (300), with bias."""
    g = torch.Generator(device=dev).manual_seed(m + k)
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    scales = _scales(g, dev, k, n, None)
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    out = (w4a16_gemm if bits == 4 else w8a16_gemm)(x, data, scales, n, bias)
    assert out.shape == (m, n)
    _close(out, w8a16_matmul_ref(x, q, scales, bias))


@pytest.mark.parametrize("m", [9, 37, 200, 1024])
@pytest.mark.parametrize("group", [32, 64, 96, 128])
@pytest.mark.parametrize("bits", [8, 4])
def test_dense_gemm_group_wise(dev, m, group, bits):
    """The group-wise GEMM tile: every fold unit (g = 64, 128: whole K steps;
    32, 96: halves), K off the 128-deep padding (1000 rounded down to whole
    groups), N off the column strip and the 16-byte row alignment, with bias,
    m from one ragged row block to four."""
    g = torch.Generator(device=dev).manual_seed(m + group)
    k, n = 1000 // group * group, 300
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    scales = _scales(g, dev, k, n, group)
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    out = (w4a16_gemm if bits == 4 else w8a16_gemm)(x, data, scales, n, bias)
    assert out.shape == (m, n)
    _close(out, w8a16_matmul_ref(x, q, scales, bias))


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (8, 2, 128), (16, 2, 64)])
def test_flash_decode(dev, hq, hkv, d):
    g = torch.Generator(device=dev).manual_seed(hq)
    q = torch.randn(3, 1, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn(3, hkv, 384, d, generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn(3, hkv, 384, d, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([1, 200, 384], dtype=torch.int32, device=dev)
    _close(flash_decode(q, kc, vc, lengths), flash_decode_ref(q, kc, vc, lengths))


@pytest.mark.parametrize("k,group", [(8320, 4160), (16384, 8192)])
def test_w4a8_gemm_large_groups(dev, k, group):
    """Groups of thousands of rows: one s32 sum a group, converted to f32
    at the fold (4160: units of half a K step; 8192: whole steps)."""
    g = torch.Generator(device=dev).manual_seed(group)
    m, n = 37, 300
    q = torch.randint(-8, 8, (k, n), generator=g, device=dev, dtype=torch.int8)
    packed = pack_weights(q, bits=4)
    scales = _scales(g, dev, k, n, group)
    xq, sx = quantize_activations(torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16))
    xq = torch.nn.functional.pad(xq, (0, packed.kp - k)).contiguous()
    out = w4a8_gemm(xq, sx, packed.data, scales, n, None, group)
    _close(out, w8a8_gemm_ref(xq, sx, torch.nn.functional.pad(q, (0, 0, 0, packed.kp - k)),
                              scales, n, group_size=group))


@pytest.mark.parametrize("m,k,n", [(1, 1000, 300), (37, 4096, 4096), (200, 11008, 4096),
                                   (1024, 4096, 12288), (37, 1000, 300), (129, 1000, 300),
                                   (200, 1000, 300), (1024, 1000, 300)])
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


@pytest.mark.parametrize("m", [1, 3, 4, 8])
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
    with pytest.raises(ValueError):  # groups of 16 rows: not whole K steps
        w8a16_gemv(x, w, torch.ones(8, 128, device=dev), 128)
    w4 = torch.zeros(64, 128, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        w4a16_gemm(x, w4, torch.ones(8, 128, device=dev), 128)
    with pytest.raises(ValueError):  # an int8 [128, 128] weight is not int4 data for K = 128
        w4a16_gemv(torch.zeros(1, 256, dtype=torch.bfloat16, device=dev), w4,
                   torch.ones(128, device=dev), 128)
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
    with pytest.raises(ValueError):  # group-wise W4A8 without its group size
        w4a8_gemm(xq, torch.ones(1, device=dev), w4, torch.ones(2, 128, device=dev), 128)
    with pytest.raises(ValueError):  # groups of 16 rows
        w4a8_gemm(xq, torch.ones(1, device=dev), w4, torch.ones(8, 128, device=dev), 128,
                  group_size=16)
    with pytest.raises(ValueError):  # group-wise int8 stays on the W8A16 path
        w8a8_matmul(x, pack_weights(w), torch.ones(2, 128, device=dev))
    gu = torch.zeros(128, 256, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):  # more rows than the decode regime
        fused_mlp_gemv(torch.zeros(9, 128, dtype=torch.bfloat16, device=dev),
                       torch.ones(128, device=dev), 1e-5, gu, torch.ones(256, device=dev),
                       w, torch.ones(128, device=dev), 128)
    bank = torch.zeros(2, 128, 128, dtype=torch.int8, device=dev)
    ids = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # expert banks with groups of 16 rows
        w8a16_expert_gemv(x, bank, torch.ones(2, 8, 128, device=dev), ids, 128)
    with pytest.raises(TypeError):  # group-wise scales of another expert count
        w8a16_expert_gemv(x, bank, torch.ones(3, 2, 128, device=dev), ids, 128)
    with pytest.raises(TypeError):  # int64 ids
        w8a16_expert_gemv(x, bank, torch.ones(2, 128, device=dev), ids.long(), 128)
    bank4 = pack_weights(torch.zeros(2, 128, 128, dtype=torch.int8, device=dev), bits=4)
    assert w8a16_expert_matmul(x, bank4, torch.ones(2, 128, device=dev), ids).shape == (2, 1, 128)
    with pytest.raises(ValueError):  # int4 data handed to the int8 bank kernel: K 128 > 64 rows
        w8a16_expert_gemv(x, bank4.data, torch.ones(2, 128, device=dev), ids, 128)
    pool = torch.zeros(4, 2, 128, 128, dtype=torch.bfloat16, device=dev)
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):  # multi-query decode over a paged cache
        paged_flash_decode(q, pool, pool, table, lengths)
    with pytest.raises(NotImplementedError):  # sliding window over a paged cache
        paged_flash_decode(q[:, :1], pool, pool, table, lengths, window=64)
    with pytest.raises(TypeError):  # an int64 table
        paged_flash_decode(q[:, :1], pool, pool, table.long(), lengths)
    with pytest.raises(TypeError):  # a table of another batch
        paged_flash_decode(q[:, :1], pool, pool, table.repeat(2, 1), lengths)
    with pytest.raises(ValueError):  # blocks of 64 keys
        paged_flash_decode(q[:, :1], pool[:, :, :64].contiguous(), pool[:, :, :64].contiguous(),
                           table, lengths)
    with pytest.raises(TypeError):  # a bf16 pool handed to the int8 kernel
        paged_flash_decode_int8(q[:, :1], pool, pool, torch.ones(4, 2, 128, device=dev),
                                torch.ones(4, 2, 128, device=dev), table, lengths)
    with pytest.raises(ValueError):  # more rows than the decode regime
        w8a16_expert_gemv(torch.zeros(9, 128, dtype=torch.bfloat16, device=dev), bank,
                          torch.ones(2, 128, device=dev), ids, 128)
    with pytest.raises(ValueError):  # row blocks of 4 rows
        w8a16_grouped_gemm(torch.zeros(8, 128, dtype=torch.bfloat16, device=dev), bank,
                           torch.ones(2, 128, device=dev), ids, 128)
    with pytest.raises(TypeError):  # an int64 count of real blocks
        w8a16_grouped_gemm(torch.zeros(16, 128, dtype=torch.bfloat16, device=dev), bank,
                           torch.ones(2, 128, device=dev), ids, 128, ids[:1].long())


def test_every_kernel_counts_its_launches(dev):
    before = {name: fn.launches for name, fn in KERNELS.items()}
    test_w8a16_kernels(dev, 1, True)
    test_w8a16_kernels(dev, 9, False)
    test_flash_attention(dev, 77, 8, 2, 64)
    test_flash_decode(dev, 8, 2, 128)
    test_w8a8_gemm_bit_identical(dev, 200, 11008, 4096)
    test_flash_decode_int8(dev, 3, 384, 16, 2, 64)
    test_w8a16_expert_gemv(dev, 1, 1000, [3, 0])
    test_w8a16_grouped_gemm(dev, 8, 10, 1000)
    test_group_wise_and_int4_kernels(dev, 1, 1000, None, 4)
    test_group_wise_and_int4_kernels(dev, 9, 960, 64, 4)
    test_w4a8_gemm(dev, 37, 4096, 4096, 64)
    test_expert_gemv_int4_and_group_wise_banks(dev, 4, 1000, None, 1, [3, 0])
    test_grouped_gemm_int4_and_group_wise_banks(dev, 4, 960, 64, 8, 10)
    after = {name: fn.launches for name, fn in KERNELS.items()}
    # two calls each: with and without residual
    test_fused_mlp_gemv(dev, 1, "silu", (1000, 256, 300))
    test_fused_mlp_gemv_i4(dev, 1, "silu", (1000, 256, 300))
    fused = ("fused_mlp_gemv", "fused_mlp_gemv_i4")
    paged = ("paged_flash_decode", "paged_flash_decode_int8")
    assert all(after[name] == before[name] + 1 for name in KERNELS if name not in fused + paged)
    assert all(KERNELS[name].launches == before[name] + 2 for name in fused)
    # the paged kernel, and the dense kernel on the gathered cache beside it
    for int8, dense in ((False, "flash_decode"), (True, "flash_decode_int8")):
        counts = {name: fn.launches for name, fn in KERNELS.items()}
        test_paged_flash_decode(dev, 3, 8, 8, 64, 128, 3, int8)
        assert KERNELS[paged[int8]].launches == counts[paged[int8]] + 1
        assert KERNELS[dense].launches == counts[dense] + 1
        assert KERNELS[paged[not int8]].launches == counts[paged[not int8]]


@pytest.mark.parametrize("shape", [(1000, 256, 300), (4096, 11008, 4096)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_fused_mlp_repeats_bit_equal(dev, m, bits, act, shape):
    """Both fused MLPs, with the residual, twice: bit-equal, and within the
    tolerance of the plain version (the down launch's K split at N = 4096)."""
    k, i, n = shape
    g = torch.Generator(device=dev).manual_seed(10 * m + bits)
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    gu = torch.randint(lo, hi, (k, 2 * i), generator=g, device=dev, dtype=torch.int8)
    dn = torch.randint(lo, hi, (i, n), generator=g, device=dev, dtype=torch.int8)
    gu_d, dn_d = pack_weights(gu, bits=bits).data, pack_weights(dn, bits=bits).data
    gu_s, dn_s = _scales(g, dev, k, 2 * i, None), _scales(g, dev, i, n, None)
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
    kernel = fused_mlp_gemv_i4 if bits == 4 else fused_mlp_gemv
    out = _twice(lambda: kernel(x, gamma, 1e-5, gu_d, gu_s, dn_d, dn_s, n, res, act))
    _close(out, fused_mlp_ref(x, gamma, gu, gu_s, dn, dn_s, 1e-5, act, res))


@pytest.mark.parametrize("bits,k,group", BANK_MODES + [(8, 14336, None), (4, 14336, 128)])
@pytest.mark.parametrize("m,ids", [(1, [3, 3]), (4, [1, 1, 2, 0, 3, 2, 2, 0]), (8, [2, 2, 1])])
def test_expert_gemv_repeats_bit_equal(dev, bits, k, group, m, ids):
    """The expert gathers with repeated ids, twice: bit-equal, and within the
    tolerance of the plain version (K = 14336 at N = 512: a K split)."""
    g = torch.Generator(device=dev).manual_seed(m + k + bits)
    n = 300 if k < 4096 else 512
    q, data, scales = _bank_modes(g, dev, 4, k, n, bits, group)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    eids = torch.tensor(ids, dtype=torch.int32, device=dev)
    kernel = w4a16_expert_gemv if bits == 4 else w8a16_expert_gemv
    out = _twice(lambda: kernel(x, data, scales, eids, n))
    _close(out, expert_matmul_ref(x, q, scales, eids))
