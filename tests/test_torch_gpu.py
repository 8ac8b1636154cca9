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
from eetq_tpu_torch.kernels.autotune import GEMV_BLOCK_N, gemv_split_floor, gemv_splits, sm_count
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
        return (lambda **kw: kernel(q, *caches, lengths, **kw)), (lambda: ref(q, *caches, lengths))
    table = torch.randperm(shape[0], generator=g, device=dev)[:b * (l // bs)].reshape(
        b, l // bs).to(torch.int32).contiguous()
    kernel, ref = ((paged_flash_decode_int8, paged_flash_decode_int8_ref) if int8
                   else (paged_flash_decode, paged_flash_decode_ref))
    return ((lambda **kw: kernel(q, *caches, table, lengths, **kw)),
            (lambda: ref(q, *caches, table, lengths)))


DECODE_MODES = ["dense", "dense_int8", "paged", "paged_int8"]


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("b,hq,hkv,d,lengths", [
    (1, 32, 32, 128, [1074]), (8, 32, 8, 128, [1, 2048, 17, 1500, 300, 1024, 640, 2047]),
    (3, 16, 2, 64, [129, 64, 1]), (1, 16, 16, 256, [1074]),
    (8, 16, 16, 256, [1, 2048, 17, 1500, 300, 1024, 640, 2047])])
def test_flash_decode_repeats_bit_equal(dev, mode, b, hq, hkv, d, lengths):
    """Two launches give bit-equal outputs: the chunks' states are merged in
    chunk order by one block, with no float atomics."""
    g = torch.Generator(device=dev).manual_seed(b)
    kernel, ref = _decode_calls(g, dev, mode, b, hq, hkv, d, lengths)
    out = _twice(kernel)
    _close(out, ref())


def _decode_fns(g, dev, mode, b, hq, hkv, d, l=2048, bs=256):
    """(kernel(q, lengths), plain(q, lengths)) of one flash-decode entry
    point on random caches of l keys a row (paged: pools of bs-key blocks
    behind a permuted table), for q of any S."""
    int8, paged = "int8" in mode, mode.startswith("paged")
    shape = (b * l // bs + 3, hkv, bs, d) if paged else (b, hkv, l, d)
    caches = [torch.randn(shape, generator=g, device=dev) for _ in range(2)]
    if int8:
        (k, ks), (v, vs) = (quantize_activations(t) for t in caches)
        caches = (k, v, ks, vs)
    else:
        caches = tuple(t.to(torch.bfloat16) for t in caches)
    if paged:
        table = torch.randperm(shape[0], generator=g, device=dev)[:b * (l // bs)].reshape(
            b, l // bs).to(torch.int32).contiguous()
        caches = caches + (table,)
        kernel, ref = ((paged_flash_decode_int8, paged_flash_decode_int8_ref) if int8
                       else (paged_flash_decode, paged_flash_decode_ref))
    else:
        kernel, ref = ((flash_decode_int8, flash_decode_int8_ref) if int8
                       else (flash_decode, flash_decode_ref))
    return (lambda q, n: kernel(q, *caches, n)), (lambda q, n: ref(q, *caches, n))


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("s", [2, 3, 8])
@pytest.mark.parametrize("group", [1, 4])
def test_multiquery_flash_decode_bit_equal_to_sequential_calls(dev, mode, s, group):
    """S query tokens a row (the verify of speculative decoding): within the
    plain version's tolerance, repeats bit-equal, and token i bit-equal to
    an S = 1 call at length - S + i + 1 (the same chunks, tiles and order).
    Rows end across a chunk edge (255, 256, 257 + S), beside a row whose
    first token sees one key, a row of the whole cache, and a row shorter
    than S whose first tokens see no key (zeros, as S = 1 calls at length 0
    give)."""
    g = torch.Generator(device=dev).manual_seed(10 * s + group)
    hkv = 8
    kernel, ref = _decode_fns(g, dev, mode, 6, hkv * group, hkv, 128)
    q = torch.randn(6, s, hkv * group, 128, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([255 + s, 256 + s, 257 + s, s, 2048, 1], dtype=torch.int32,
                           device=dev)
    out = _twice(lambda: kernel(q, lengths))
    assert out.shape == q.shape
    _close(out, ref(q, lengths))
    for i in range(s):
        one = kernel(q[:, i:i + 1].contiguous(), lengths - s + i + 1)
        torch.cuda.synchronize()
        assert torch.equal(out[:, i:i + 1], one), i
    assert not out[5, :s - 1].any()


@pytest.mark.parametrize("mode", DECODE_MODES)
def test_multiquery_flash_decode_mixtral_rows(dev, mode):
    """Mixtral's GQA 32/8 at S = 8: 32 query rows a kv head, two M tiles
    over each staged tile; bit-equal to sequential calls."""
    g = torch.Generator(device=dev).manual_seed(32)
    kernel, ref = _decode_fns(g, dev, mode, 2, 32, 8, 128)
    q = torch.randn(2, 8, 32, 128, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([1074, 517], dtype=torch.int32, device=dev)
    out = _twice(lambda: kernel(q, lengths))
    _close(out, ref(q, lengths))
    for i in range(8):
        assert torch.equal(out[:, i:i + 1], kernel(q[:, i:i + 1].contiguous(), lengths - 7 + i))


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
    merge across blocks: the merge runs in the same launch; and each of 32
    launches into its own NaN-filled `out` writes the whole of it, bit-equal
    to a launch of its own (a skipped launch would leave NaN)."""
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
    # ... and every launch writes its output, seen in the buffers rather than
    # in a trace: 32 launches, each into its own NaN-filled buffer
    ref = kernel()
    outs = [torch.full_like(ref, float("nan")) for _ in range(32)]
    name = {"dense": "flash_decode", "dense_int8": "flash_decode_int8",
            "paged": "paged_flash_decode", "paged_int8": "paged_flash_decode_int8"}[mode]
    before = KERNELS[name].launches
    for o in outs:
        assert kernel(out=o) is o
    torch.cuda.synchronize()
    assert KERNELS[name].launches - before == len(outs)
    for o in outs:
        assert torch.equal(o, ref)


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


def _rows_bit_equal(kernel, q, lengths):
    """kernel(q, lengths) for q [B, S, Hq, D]: token i bit-equal to a
    one-token call at length - S + i + 1. Returns the output."""
    s = q.shape[1]
    out = kernel(q, lengths)
    for i in range(s):
        one = kernel(q[:, i:i + 1].contiguous(), lengths - s + i + 1)
        torch.cuda.synchronize()
        assert torch.equal(out[:, i:i + 1], one), i
    return out


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
    q96 = torch.zeros(1, 4, 2, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):  # head_dim 96, also under a window
        flash_attention(q96, q96, q96, window=2)
    with pytest.raises(NotImplementedError):  # head_dim 96 in the flash-decode
        flash_decode(q96[:, :1].contiguous(), q96.transpose(1, 2).contiguous(),
                     q96.transpose(1, 2).contiguous(), torch.ones(1, dtype=torch.int32,
                                                                  device=dev))
    with pytest.raises(ValueError):  # a window of no key
        flash_attention(q, q, q, window=0)
    with pytest.raises(TypeError):  # ALiBi slopes of another head count
        flash_attention(q, q, q, slopes=torch.ones(3, device=dev))
    g = torch.Generator(device=dev).manual_seed(96)
    cache = torch.randn(1, 2, 128, 128, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    wide = torch.randn(1, 9, 16, 128, generator=g, device=dev).to(torch.bfloat16)
    # 8 q heads x 9 tokens: 72 query rows a kv head, two row blocks; each
    # token bit-equal to a one-token call
    _rows_bit_equal(lambda q, n: flash_decode(q, cache, cache, n), wide, 100 * lengths)
    i8, sc = quantize_activations(torch.randn(1, 2, 128, 128, generator=g, device=dev))
    # the same over an int8 cache
    _rows_bit_equal(lambda q, n: flash_decode_int8(q, i8, i8, sc, sc, n), wide, 100 * lengths)
    # at head dim 256 a block takes 32 query rows a kv head: 16 q heads x 4
    # tokens (64) are two row blocks, 16 x 2 one
    wide256 = torch.randn(1, 4, 16, 256, generator=g, device=dev).to(torch.bfloat16)
    cache256 = torch.randn(1, 1, 128, 256, generator=g, device=dev).to(torch.bfloat16)
    _rows_bit_equal(lambda q, n: flash_decode(q, cache256, cache256, n), wide256, 100 * lengths)
    i8_256, sc256 = quantize_activations(torch.randn(1, 1, 128, 256, generator=g, device=dev))
    _rows_bit_equal(lambda q, n: flash_decode_int8(q, i8_256, i8_256, sc256, sc256, n), wide256,
                    100 * lengths)
    assert flash_decode(wide256[:, :2].contiguous(), cache256, cache256, 2 * lengths).shape == (
        1, 2, 16, 256)
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
    pool = torch.randn(4, 2, 128, 128, generator=g, device=dev).to(torch.bfloat16)
    table = torch.tensor([[2, 0]], dtype=torch.int32, device=dev)
    # 72 query rows a kv head over a paged cache: bit-equal to one-token calls
    # and to the dense kernel on the gathered cache
    out = _rows_bit_equal(lambda q, n: paged_flash_decode(q, pool, pool, table, n), wide,
                          200 * lengths)
    dense = gather_pool(pool, table)
    assert torch.equal(out, flash_decode(wide, dense, dense, 200 * lengths))
    pool96 = torch.zeros(4, 2, 128, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):  # head_dim 96 under a window over a paged cache
        paged_flash_decode(q96[:, :1], pool96, pool96, table, lengths, window=64)
    pool256 = torch.randn(4, 1, 128, 256, generator=g, device=dev).to(torch.bfloat16)
    # 64 query rows a kv head at head_dim 256: two row blocks
    out = _rows_bit_equal(lambda q, n: paged_flash_decode(q, pool256, pool256, table, n),
                          wide256, 200 * lengths)
    dense = gather_pool(pool256, table)
    assert torch.equal(out, flash_decode(wide256, dense, dense, 200 * lengths))
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


# ---- the captured decode step (serve/graph.py) ----

# a small llama on the card whose decode GEMVs split K (4 ranges at K = 1024)
# and whose flash-decode merges chunks (a cache of 384 keys, two chunks):
# both use the kernels' scratch
GRAPH_DIMS = dict(vocab_size=1024, hidden_size=1024, intermediate_size=2048, num_layers=2,
                  num_heads=8, num_kv_heads=2, head_dim=128, max_position=1024)
GRAPH_PROMPT, GRAPH_STEPS = 300, 16


def _graph_model(dev):
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params

    cfg = ModelConfig(**GRAPH_DIMS)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, quantize_params(random_dense_params(cfg, gen), quantize_lm_head=True)


def _prefilled(cfg, params, dev, kv):
    """(first tokens [2], caches) after a prompt of GRAPH_PROMPT tokens."""
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import prefill

    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, GRAPH_PROMPT), generator=gen, device=dev)
    caches = init_caches(cfg, 2, GRAPH_PROMPT + GRAPH_STEPS, device=dev, dtype=kv)
    logits, caches = prefill(params, cfg, prompt, caches)
    return torch.argmax(logits, -1), caches


def _clone_caches(caches):
    from eetq_tpu_torch.modules.attention import KVCache

    return [KVCache(*(None if t is None else t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)))
            for c in caches]


@pytest.mark.parametrize("kv,fused", [(torch.bfloat16, False), (torch.int8, True)],
                         ids=["bf16", "int8-fused-mlp"])
def test_graph_decode_loop_bit_equal_to_eager(dev, kv, fused):
    """decode_loop (one step captured, replayed) against a Python loop of
    eager decode_step on a copy of the same caches: the same greedy tokens
    and the same caches, bit for bit, and the launches of n - 1 eager
    steps; `stats` receives the warm-up's and the capture's ms."""
    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step

    cfg, params = _graph_model(dev)
    first, caches = _prefilled(cfg, params, dev, kv)
    twin = _clone_caches(caches)
    s, n = GRAPH_PROMPT, GRAPH_STEPS
    tok, eager = first, [first]
    for i in range(n - 1):
        reset_launch_counts()
        logits, _ = decode_step(params, cfg, tok[:, None], s + i, twin, fused_mlp=fused)
        if i == 0:
            one_step = launch_counts()
        tok = torch.argmax(logits, -1)
        eager.append(tok)
    reset_launch_counts()
    stats = {}
    toks, _ = decode_loop(params, cfg, first, s, caches, n, fused_mlp=fused, stats=stats)
    counts = launch_counts()
    assert stats["warm_ms"] > 0 and stats["capture_ms"] > 0
    assert torch.equal(toks, torch.stack(eager, dim=1))
    for a, b in zip(caches, twin):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("k", "v", "k_scale", "v_scale")
                   if getattr(a, f) is not None)
    assert sum(one_step.values()) > 0
    assert counts == {k: (n - 1) * v for k, v in one_step.items()}


def _logits_step(cfg, params, dev, caches, first):
    """A StepGraph over one forward at a fixed position, its logits copied
    into a static buffer (the same writes and logits at every call)."""
    from eetq_tpu_torch.models.transformer import forward
    from eetq_tpu_torch.serve.graph import StepGraph

    pos = torch.full((2,), GRAPH_PROMPT, dtype=torch.int64, device=dev)
    out = torch.empty((2, cfg.vocab_size), dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def step():
        logits, _ = forward(params, cfg, first[:, None], pos[:, None], caches, pos)
        out.copy_(logits[:, -1])

    return StepGraph(step, dev), out


def test_graph_replay_counts_one_eager_step(dev):
    """A replay adds the launches its capture counted, which are those of an
    eager call; the capture itself adds none."""
    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts

    cfg, params = _graph_model(dev)
    first, caches = _prefilled(cfg, params, dev, torch.bfloat16)
    graph, _ = _logits_step(cfg, params, dev, caches, first)
    reset_launch_counts()
    graph()  # eager, the warm-up
    eager = launch_counts()
    reset_launch_counts()
    graph.prepare()  # the capture
    assert graph.captured and not any(launch_counts().values())
    for _ in range(3):
        graph()
    assert launch_counts() == {k: 3 * v for k, v in eager.items()}
    assert graph.counts == {k: v for k, v in eager.items() if v}
    assert eager["w8a16_gemv"] and eager["flash_decode"] == cfg.num_layers


def test_graph_keeps_its_scratch_when_the_scratch_grows(dev):
    """After capture the kernels' scratch is replaced by larger buffers and
    the freed memory is filled with NaN: the graph still reads the buffers
    of its capture, which it holds, and gives the same logits."""
    from eetq_tpu_torch.kernels import _build

    cfg, params = _graph_model(dev)
    first, caches = _prefilled(cfg, params, dev, torch.bfloat16)
    graph, out = _logits_step(cfg, params, dev, caches, first)
    graph()
    want = out.clone()
    graph()
    assert graph.captured and torch.equal(out, want)
    old = {key: pair[0].data_ptr() for key, pair in _build._SCRATCH.items()}
    assert {"gemv", "decode"} <= {user for user, _ in old}
    for user in ("gemv", "decode"):
        _build.scratch(user, dev, 1 << 26, 1 << 20)
    assert all(_build._SCRATCH[key][0].data_ptr() != p for key, p in old.items())
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 24,), float("nan"), device=dev) for _ in range(8)]
    graph()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    del junk


def test_scratch_cannot_grow_during_a_capture(dev):
    from eetq_tpu_torch.kernels import _build

    graph = torch.cuda.CUDAGraph()
    size = max(_build._SCRATCH.get(("decode", dev), (torch.empty(0),))[0].numel(), 1) * 4
    with pytest.raises(RuntimeError, match="grow during a CUDA graph capture"):
        with torch.cuda.graph(graph):
            _build.scratch("decode", dev, size, 1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_windows_on_the_card(dev, paged):
    """The CUDA default window (8) with chains: the greedy tokens of a
    window-1 twin, every program a captured graph after warmup()."""
    from eetq_tpu_torch.serve.engine import Engine

    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    lengths, budgets = (17, 300, 5, 120, 64, 9), (20, 33, 9, 40, 17, 25)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist()
               for n in lengths]
    kw = dict(max_batch=4, max_len=512, prompt_buckets=(64, 512))
    if paged:
        kw.update(paged_blocks=9, paged_block_size=256)
    outs = []
    for window in ({}, dict(decode_window=1)):
        eng = Engine(params, cfg, **kw, **window)
        eng.warmup()
        assert all(g.captured for g, _ in eng._programs.values())
        uids = [eng.add_request(p, b) for p, b in zip(prompts, budgets)]
        eng.run()
        outs.append([eng.result(u) for u in uids])
        if not window:
            assert eng.decode_window == 8 and set(eng._programs) == {(1, False), (8, False)}
        if paged:
            assert sorted(eng._free_blocks) == list(range(1, 9))
    assert outs[0] == outs[1] and [len(t) for t in outs[0]] == list(budgets)


def test_tied_head_makes_no_f32_copy_of_the_table(dev):
    """The tied head's peak memory stays far below one f32 copy of the table
    (524 MB here; a chunk is 64 MB), and its f32 logits are the f32 product
    of the bf16 values (cuBLAS sums in its own order: 1e-5)."""
    from eetq_tpu_torch.models.transformer import _tied_head

    v, h = 64000, 2048
    gen = torch.Generator(device=dev).manual_seed(0)
    embed = (torch.randn(v, h, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    x = torch.randn(8, 1, h, generator=gen, device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    logits = _tied_head(x, embed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert logits.dtype == torch.float32 and logits.shape == (8, 1, v)
    assert peak < v * h * 4 // 4, peak
    ref = x.float() @ embed.float().T
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)


LLAMA_GEMV_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("bits,group", [(8, None), (4, 128), (4, None)],
                         ids=["int8", "int4-g128", "int4"])
@pytest.mark.parametrize("k,n", LLAMA_GEMV_SHAPES)
def test_gemv_rows_bit_equal_to_single_rows(dev, bits, group, k, n):
    """Row i of an m = 8 GEMV (a b=1 verify of k = 7 drafts) is bit-equal to
    an m = 1 call on that row (a decode step), with and without the RMSNorm
    prologue: the same K split at both m (`gemv_splits` takes m in its
    shared-memory term), rows of x the MMA's N. Greedy speculation is exact
    because of it."""
    g = torch.Generator(device=dev).manual_seed(k + n + bits)
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    assert (gemv_splits(data.shape[0], -(-n // GEMV_BLOCK_N), 1, bits, 1, group or 0,
                        sm_count(dev.index))
            == gemv_splits(data.shape[0], -(-n // GEMV_BLOCK_N), 1, bits, 8, group or 0,
                           sm_count(dev.index)))
    scales = _scales(g, dev, k, n, group)
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(8, k, generator=g, device=dev).to(torch.bfloat16)
    gemv = w4a16_gemv if bits == 4 else w8a16_gemv
    for norm in (None, gamma):
        out = gemv(x, data, scales, n, None, norm, 1e-5)
        for i in range(8):
            assert torch.equal(out[i:i + 1], gemv(x[i:i + 1].contiguous(), data, scales, n, None,
                                                  norm, 1e-5)), i


@pytest.mark.parametrize("fused", [fused_mlp_gemv, fused_mlp_gemv_i4], ids=["int8", "int4"])
def test_fused_mlp_rows_bit_equal_to_single_rows(dev, fused):
    """The same for the fused MLP at llama2-7b's shape (bench.py's decode
    configuration under speculation), with the residual."""
    g = torch.Generator(device=dev).manual_seed(7)
    k, i, n = 4096, 11008, 4096
    bits = 4 if fused is fused_mlp_gemv_i4 else 8
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    gu = pack_weights(torch.randint(lo, hi, (k, 2 * i), generator=g, device=dev,
                                    dtype=torch.int8), bits=bits)
    dn = pack_weights(torch.randint(lo, hi, (i, n), generator=g, device=dev, dtype=torch.int8),
                      bits=bits)
    gu_s = torch.rand(2 * i, generator=g, device=dev) * 2e-3 + 1e-4
    dn_s = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
    gamma = 1.0 + 0.1 * torch.randn(k, generator=g, device=dev)
    x = torch.randn(8, k, generator=g, device=dev).to(torch.bfloat16)
    res = torch.randn(8, n, generator=g, device=dev).to(torch.bfloat16)
    out = fused(x, gamma, 1e-5, gu.data, gu_s, dn.data, dn_s, n, res, "silu")
    for r in range(8):
        one = fused(x[r:r + 1].contiguous(), gamma, 1e-5, gu.data, gu_s, dn.data, dn_s, n,
                    res[r:r + 1].contiguous(), "silu")
        assert torch.equal(out[r:r + 1], one), r


@pytest.mark.parametrize("kv,fused", [(torch.bfloat16, False), (torch.int8, True)],
                         ids=["bf16", "int8-fused-mlp"])
def test_ngram_spec_bit_equal_to_decode_loop_on_the_card(dev, kv, fused):
    """ngram_spec_generate (each round a replayed graph) gives decode_loop's
    greedy tokens on a small model, with drafts accepted on a tiled prompt;
    sampled, the stream of positional_generate at the same seed. One row:
    the verify's m = k + 1 = 8 rows take the GEMV, as the decode steps do
    (more rows would take the GEMM, which sums in another order)."""
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve import spec
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen, device=dev).repeat(1, 8)
    n = 40
    caches = init_caches(cfg, 1, prompt.shape[1] + n, device=dev, dtype=kv)
    logits, caches = prefill(params, cfg, prompt, caches)
    want, _ = decode_loop(params, cfg, torch.argmax(logits, -1), prompt.shape[1], caches, n,
                          fused_mlp=fused)
    stats = {}
    got = spec.ngram_spec_generate(params, cfg, prompt, n, k=7, kv_dtype=kv, fused_mlp=fused,
                                   stats=stats)
    assert torch.equal(got, want)
    assert stats["capture_ms"] > 0 and stats["rounds"] < n - 1
    draft, dcfg = spec.truncated_draft(params, cfg, 1)
    assert torch.equal(spec.spec_generate(params, cfg, draft, dcfg, prompt, n, k=3, kv_dtype=kv,
                                          fused_mlp=fused), want)
    sampled = dict(temperature=0.8, top_k=20, seed=5, kv_dtype=kv, fused_mlp=fused)
    assert torch.equal(spec.ngram_spec_generate(params, cfg, prompt, n, k=7, **sampled),
                       spec.positional_generate(params, cfg, prompt, n, **sampled))


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_spec_generate_self_draft_accepts_every_draft_on_the_card(dev, kv):
    """spec_generate with the target as its own draft: drafts are accepted
    (up to k + 1 tokens a round), so later rounds run the draft's 2-token
    catch-up over an accepted round's cache hole, and the tokens are still
    decode_loop's. Not every draft need be: the first catch-up recomputes
    the prompt's last KV on the GEMV where the target's prefill used the
    GEMM, so a near tie in the draft may flip."""
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve import spec
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (1, 100), generator=gen, device=dev)
    k, n = 7, 33
    caches = init_caches(cfg, 1, prompt.shape[1] + n, device=dev, dtype=kv)
    logits, caches = prefill(params, cfg, prompt, caches)
    want, _ = decode_loop(params, cfg, torch.argmax(logits, -1), prompt.shape[1], caches, n)
    draft, dcfg = spec.truncated_draft(params, cfg, cfg.num_layers)
    got, stats = spec.spec_generate(params, cfg, draft, dcfg, prompt, n, k=k, kv_dtype=kv,
                                    return_stats=True)
    assert torch.equal(got, want)
    assert stats["accepted_drafts"] >= 3 * k and stats["rounds"] <= 5, stats


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_engine_on_the_card(dev, paged):
    """Engine(spec_ngram=3) at the CUDA window (8): the greedy tokens of a
    window-1 engine without speculation (2 slots: a verify is m = 8, the
    GEMV, as a step's), every program captured after warmup(), every block
    freed."""
    from eetq_tpu_torch.serve.engine import Engine

    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    lengths, budgets = (17, 300, 5, 64), (20, 33, 9, 40)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist() * 2
               for n in lengths]
    kw = dict(max_batch=2, max_len=1024, prompt_buckets=(64, 1024))
    if paged:
        kw.update(paged_blocks=9, paged_block_size=256)
    outs = []
    for extra in (dict(spec_ngram=3), dict(decode_window=1)):
        eng = Engine(params, cfg, **kw, **extra)
        eng.warmup()
        graphs = [g for g, _ in eng._programs.values()] + [
            p.graph for p in eng._spec_programs.values()]
        assert all(g.captured for g in graphs)
        uids = [eng.add_request(p, b) for p, b in zip(prompts, budgets)]
        eng.run()
        outs.append([eng.result(u) for u in uids])
        if "spec_ngram" in extra:
            assert set(eng._spec_programs) == {(8, False)} and eng.spec_rounds > 0
        if paged:
            assert sorted(eng._free_blocks) == list(range(1, 9))
    assert outs[0] == outs[1]


# ---- the attention kernels' variants: a sliding window, ALiBi, any group ----

# (batch, sq, skv, q heads, kv heads, head_dim, window, ALiBi): windows shorter
# and longer than a tile, over a query block appended to a cache (delta > 0),
# both together, in one- and two-warpgroup tiles, D = 64, groups 7 and 16
FLASH_VARIANTS = [
    (1, 300, 300, 8, 2, 128, 64, False), (1, 1000, 1000, 32, 8, 128, 256, False),
    (2, 77, 333, 8, 8, 64, 100, False), (1, 1000, 1000, 40, 40, 128, None, True),
    (2, 130, 200, 5, 5, 64, None, True), (1, 500, 500, 6, 3, 128, 40, True),
    (1, 1024, 1024, 28, 4, 128, None, False), (1, 300, 300, 32, 2, 128, None, False),
    # head dim 256 (gemma-7b): one- and two-warpgroup tiles, a block appended
    # to a cache, GQA, the window and ALiBi
    (1, 1024, 1024, 16, 16, 256, None, False), (2, 1024, 1024, 16, 16, 256, None, False),
    (2, 77, 333, 8, 2, 256, None, False), (1, 1000, 1000, 16, 16, 256, 256, False),
    (1, 500, 500, 6, 3, 256, 40, True), (2, 130, 200, 5, 5, 256, None, True),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window,alibi", FLASH_VARIANTS)
def test_flash_attention_variants(dev, b, sq, skv, hq, hkv, d, window, alibi):
    from eetq_tpu_torch.ops.alibi import alibi_slopes_cache

    g = torch.Generator(device=dev).manual_seed(sq + skv + hq)
    q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16)
    kv = torch.randn(b, skv, 2 * hkv, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = kv[:, :, :hkv], kv[:, :, hkv:]
    slopes = alibi_slopes_cache(hq, dev) if alibi else None
    out = _twice(lambda: flash_attention(q, k, v, window=window, slopes=slopes))
    _close(out, flash_attention_ref(q, k, v, window=window, slopes=slopes))


def _variant_fns(g, dev, mode, b, hq, hkv, l, window, slopes, bs=256, d=128):
    """(kernel(q, lengths), plain(q, lengths), dense(q, lengths)) of one
    flash-decode entry point under a window and ALiBi slopes; a paged mode's
    pool holds the dense cache's keys behind a permuted table, and dense()
    is the dense kernel on that cache (the paged kernel must equal it)."""
    int8, paged = "int8" in mode, mode.startswith("paged")
    caches = [torch.randn(b, hkv, l, d, generator=g, device=dev) for _ in range(2)]
    if int8:
        (k, ks), (v, vs) = (quantize_activations(t) for t in caches)
        leaves = (k, v, ks, vs)
        dense, ref = flash_decode_int8, flash_decode_int8_ref
        pkernel, pref = paged_flash_decode_int8, paged_flash_decode_int8_ref
    else:
        leaves = tuple(t.to(torch.bfloat16) for t in caches)
        dense, ref = flash_decode, flash_decode_ref
        pkernel, pref = paged_flash_decode, paged_flash_decode_ref
    kw = dict(window=window, slopes=slopes)
    on_dense = lambda q, n: dense(q, *leaves, n, **kw)  # noqa: E731
    if not paged:
        return on_dense, (lambda q, n: ref(q, *leaves, n, **kw)), on_dense
    nb = l // bs
    table = torch.randperm(b * nb, generator=g, device=dev).reshape(b, nb).to(torch.int32)
    pools = []
    for t in leaves:
        pool = torch.empty(b * nb, hkv, bs, *t.shape[3:], dtype=t.dtype, device=dev)
        pool[table.reshape(-1).long()] = t.reshape(b, hkv, nb, bs, *t.shape[3:]).transpose(
            1, 2).reshape(b * nb, hkv, bs, *t.shape[3:])
        pools.append(pool)
    return ((lambda q, n: pkernel(q, *pools, table, n, **kw)),
            (lambda q, n: pref(q, *pools, table, n, **kw)), on_dense)


# (q heads, kv heads, window, ALiBi): mistral's window, baichuan-13b's 40
# ALiBi heads, both together, qwen2-7b's group 7 and chatglm3-6b's 16
DECODE_VARIANTS = {"window": (32, 8, 300, False), "alibi": (40, 40, None, True),
                   "window+alibi": (16, 8, 200, True), "group7": (28, 4, None, False),
                   "group16": (32, 2, None, False)}


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("variant", DECODE_VARIANTS)
def test_flash_decode_variants(dev, mode, variant):
    """One token a row under each variant: within the plain version's
    tolerance, repeats bit-equal, paged bit-equal to dense. Rows whose
    window starts in chunk 0, on a chunk edge and past it, rows shorter than
    the window, a row of one key and one of the whole cache."""
    from eetq_tpu_torch.ops.alibi import alibi_slopes_cache

    hq, hkv, window, alibi = DECODE_VARIANTS[variant]
    g = torch.Generator(device=dev).manual_seed(hq + hkv)
    slopes = alibi_slopes_cache(hq, dev) if alibi else None
    kernel, ref, dense = _variant_fns(g, dev, mode, 6, hq, hkv, 2048, window, slopes)
    q = torch.randn(6, 1, hq, 128, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([555, 256 + (window or 0), 2048, 1, 100, 1300], dtype=torch.int32,
                           device=dev)
    out = _twice(lambda: kernel(q, lengths))
    _close(out, ref(q, lengths))
    assert torch.equal(out, dense(q, lengths))


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("variant,s", [("window", 8), ("alibi", 8), ("window+alibi", 3),
                                       ("group7", 9), ("group16", 4)])
def test_multiquery_variants_bit_equal_to_sequential_calls(dev, mode, variant, s):
    """S query tokens a row under each variant (as many as 64 query rows a
    kv head allow): token i bit-equal to an S = 1 call at length - S + i + 1,
    whose window starts at its own position; rows whose tokens' windows
    start on both sides of a tile and of a chunk edge."""
    from eetq_tpu_torch.ops.alibi import alibi_slopes_cache

    hq, hkv, window, alibi = DECODE_VARIANTS[variant]
    g = torch.Generator(device=dev).manual_seed(10 * s + hq)
    slopes = alibi_slopes_cache(hq, dev) if alibi else None
    kernel, ref, dense = _variant_fns(g, dev, mode, 5, hq, hkv, 2048, window, slopes)
    q = torch.randn(5, s, hq, 128, generator=g, device=dev).to(torch.bfloat16)
    w = window or 0
    lengths = torch.tensor([w + 256 + 3, w + 64 + 2, 2048, s, 1074], dtype=torch.int32,
                           device=dev)
    out = _twice(lambda: kernel(q, lengths))
    _close(out, ref(q, lengths))
    assert torch.equal(out, dense(q, lengths))
    for i in range(s):
        assert torch.equal(out[:, i:i + 1], kernel(q[:, i:i + 1].contiguous(), lengths - s + i + 1))


# small models of the four families on the card: a window of 64 keys under a
# 300-token prompt, ALiBi over 5 heads, groups 7 and 16
FAMILY_DIMS = {
    "window": dict(num_heads=8, num_kv_heads=2, sliding_window=64),
    "alibi": dict(num_heads=5, num_kv_heads=5, alibi=True),
    "group7": dict(num_heads=7, num_kv_heads=1, qkv_bias=True),
    "group16": dict(num_heads=16, num_kv_heads=1, rope_dim=64, rope_interleaved=True,
                    qkv_bias=True),
    # gemma-style: 4 heads of 256, a tied head, unit-offset norms, the
    # embedding multiplier, GeGLU
    "d256": dict(num_heads=4, num_kv_heads=4, head_dim=256, tie_word_embeddings=True,
                 rmsnorm_unit_offset=True, activation="gelu", embedding_multiplier=32.0),
}


@pytest.mark.parametrize("kv,fused", [(torch.bfloat16, False), (torch.int8, True)],
                         ids=["bf16", "int8-fused-mlp"])
@pytest.mark.parametrize("family", FAMILY_DIMS)
def test_family_decode_on_the_card(dev, family, kv, fused):
    """Prefill and one decode step against the plain path, then decode_loop
    bit-equal to eager decode_step on a copy of the caches; the kernels run
    their variant."""
    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step, prefill

    dims = {**GRAPH_DIMS, "head_dim": 128, **FAMILY_DIMS[family]}
    cfg = ModelConfig(**dims)
    params = quantize_params(random_dense_params(cfg, torch.Generator(device=dev).manual_seed(0)),
                             quantize_lm_head=True)
    first, caches = _prefilled(cfg, params, dev, kv)
    twin, plain = _clone_caches(caches), _clone_caches(caches)
    s, n = GRAPH_PROMPT, GRAPH_STEPS
    reset_launch_counts()
    got, _ = decode_step(params, cfg, first[:, None], s, twin, fused_mlp=fused)
    counts = launch_counts()
    want, _ = decode_step(params, cfg, first[:, None], s, plain, fused_mlp=fused,
                          use_kernels=False)
    err = (got - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item(), err
    variant = "group" if family.startswith("group") else family
    decode = "flash_decode_int8" if kv == torch.int8 else "flash_decode"
    assert counts[f"{decode}[{variant}]"] == cfg.num_layers == counts[decode]
    twin = _clone_caches(caches)
    tok, eager = first, [first]
    for i in range(n - 1):
        logits, _ = decode_step(params, cfg, tok[:, None], s + i, twin, fused_mlp=fused)
        tok = torch.argmax(logits, -1)
        eager.append(tok)
    toks, _ = decode_loop(params, cfg, first, s, caches, n, fused_mlp=fused)
    assert torch.equal(toks, torch.stack(eager, dim=1))


# ---- head dim 256 (gemma-7b) in the flash-decode ----

# (q heads, kv heads, window, ALiBi): gemma-7b's 16 heads, a window, ALiBi,
# and group 16 (the decode step's 16-row instance)
HEAD256_DECODE = {"mha": (16, 16, None, False), "window": (16, 8, 300, False),
                  "alibi": (8, 8, None, True), "group16": (32, 2, None, False)}


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("case", HEAD256_DECODE)
def test_flash_decode_head256(dev, mode, case):
    """One token a row at head dim 256: within the plain version's
    tolerance, repeats bit-equal, paged bit-equal to dense; rows of one key,
    of the whole cache and across chunk edges."""
    from eetq_tpu_torch.ops.alibi import alibi_slopes_cache

    hq, hkv, window, alibi = HEAD256_DECODE[case]
    g = torch.Generator(device=dev).manual_seed(256 + hq + hkv)
    slopes = alibi_slopes_cache(hq, dev) if alibi else None
    kernel, ref, dense = _variant_fns(g, dev, mode, 6, hq, hkv, 2048, window, slopes, d=256)
    q = torch.randn(6, 1, hq, 256, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([555, 257, 2048, 1, 100, 1300], dtype=torch.int32, device=dev)
    out = _twice(lambda: kernel(q, lengths))
    _close(out, ref(q, lengths))
    assert torch.equal(out, dense(q, lengths))


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("hq,hkv,s", [(16, 16, 8), (16, 4, 4), (32, 2, 2)],
                         ids=["8-rows", "16-rows", "32-rows"])
def test_multiquery_head256_bit_equal_to_sequential_calls(dev, mode, hq, hkv, s):
    """S query tokens a row at head dim 256, 8, 16 and 32 query rows a kv
    head (32 is the most there): token i bit-equal to an S = 1 call at
    length - S + i + 1, paged bit-equal to dense."""
    g = torch.Generator(device=dev).manual_seed(2560 + s)
    kernel, ref, dense = _variant_fns(g, dev, mode, 4, hq, hkv, 2048, None, None, d=256)
    q = torch.randn(4, s, hq, 256, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([255 + s, 2048, s, 1074], dtype=torch.int32, device=dev)
    out = _twice(lambda: kernel(q, lengths))
    _close(out, ref(q, lengths))
    assert torch.equal(out, dense(q, lengths))
    for i in range(s):
        assert torch.equal(out[:, i:i + 1], kernel(q[:, i:i + 1].contiguous(), lengths - s + i + 1))


# ---- the flash-decode's verify past one row block; chunked prefill ----

# (q heads, kv heads, S, window, ALiBi, head dim): query rows a kv head past
# one row block (64, or 32 at D = 256): chatglm3-6b's 32/2 at S = 8 (128
# rows, two blocks, the block edge on a token edge), 32/4 at S = 9 (72 rows,
# the edge inside token 8's rows), under a window and with ALiBi, and at
# D = 256 16/1 at S = 4 (64 rows) and 32/2 at S = 3 (48)
ROW_BLOCK_CASES = {
    "g16-s8": (32, 2, 8, None, False, 128), "g8-s9": (32, 4, 9, None, False, 128),
    "window-g16-s8": (32, 2, 8, 300, False, 128), "alibi-g16-s8": (32, 2, 8, None, True, 128),
    "window-alibi-g8-s9": (32, 4, 9, 200, True, 128), "d256-g16-s4": (16, 1, 4, None, False, 256),
    "d256-g16-s3": (32, 2, 3, None, False, 256),
}


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("case", ROW_BLOCK_CASES)
def test_multiquery_row_blocks_bit_equal_to_sequential_calls(dev, mode, case):
    """Query rows a kv head past one row block: within the plain version's
    tolerance, repeats bit-equal, paged bit-equal to dense, token i
    bit-equal to an S = 1 call at length - S + i + 1; rows across tile and
    chunk edges, a row of the whole cache and one shorter than S."""
    from eetq_tpu_torch.ops.alibi import alibi_slopes_cache

    hq, hkv, s, window, alibi, d = ROW_BLOCK_CASES[case]
    g = torch.Generator(device=dev).manual_seed(hq * s + hkv)
    slopes = alibi_slopes_cache(hq, dev) if alibi else None
    kernel, ref, dense = _variant_fns(g, dev, mode, 5, hq, hkv, 2048, window, slopes, d=d)
    q = torch.randn(5, s, hq, d, generator=g, device=dev).to(torch.bfloat16)
    w = window or 0
    lengths = torch.tensor([w + 256 + 3, w + 64 + 2, 2048, s - 1, 1074], dtype=torch.int32,
                           device=dev)
    out = _twice(lambda: kernel(q, lengths))
    _close(out, ref(q, lengths))
    assert torch.equal(out, dense(q, lengths))
    _rows_bit_equal(kernel, q, lengths)


# chunk shapes of the prefill flash-attention over the cache's [B, L, Hkv, D]
# view (head stride L D > sequence stride D): (batch, chunk, keys, q heads,
# kv heads, cache capacity, window): a late chunk, a chunk under a window
# shorter than its prefix, a batch of four, GQA
CHUNK_CASES = [(1, 512, 2048, 32, 32, 4096, None), (1, 512, 2560, 32, 8, 4096, 1024),
               (4, 256, 1024, 8, 8, 1024, None), (2, 128, 384, 16, 2, 512, 256)]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,cap,window", CHUNK_CASES)
def test_flash_attention_over_the_cache_view(dev, b, sq, skv, hq, hkv, cap, window):
    """A prefill chunk of sq queries over the first skv keys of a cache
    [B, Hkv, cap, D], read as the strided view [B, skv, Hkv, D]: within the
    plain version's tolerance, and bit-equal to the kernel on a contiguous
    copy of the same keys."""
    g = torch.Generator(device=dev).manual_seed(sq + skv)
    q = torch.randn(b, sq, hq, 128, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(b, hkv, cap, 128, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    k, v = kc[:, :, :skv].transpose(1, 2), vc[:, :, :skv].transpose(1, 2)
    assert k.stride()[1:] == (128, cap * 128, 1)
    out = flash_attention(q, k, v, window=window)
    _close(out, flash_attention_ref(q, k, v, window=window))
    assert torch.equal(out, flash_attention(q, k.contiguous(), v.contiguous(), window=window))


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_prefill_chunked_on_the_card(dev, kv):
    """prefill_chunked over 4 chunks of 128: every chunk's attention on the
    prefill kernel (its launch count), the logits within 5e-2 of the largest
    of the unchunked prefill's, and decode after it bit-equal between a
    replayed decode_loop and eager steps."""
    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step, prefill, prefill_chunked

    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    caches = init_caches(cfg, 2, 512 + GRAPH_STEPS, device=dev, dtype=kv)
    reset_launch_counts()
    logits, caches = prefill_chunked(params, cfg, prompt, caches, chunk=128)
    assert launch_counts()["flash_attention_fwd"] == 4 * cfg.num_layers
    full, _ = prefill(params, cfg, prompt, init_caches(cfg, 2, 512, device=dev, dtype=kv))
    err = (logits - full).abs().max().item()
    assert err <= 5e-2 * full.abs().max().item(), err
    first = torch.argmax(logits, -1)
    twin = _clone_caches(caches)
    toks, _ = decode_loop(params, cfg, first, 512, caches, GRAPH_STEPS)
    tok, eager = first, [first]
    for i in range(GRAPH_STEPS - 1):
        lg, _ = decode_step(params, cfg, tok[:, None], 512 + i, twin)
        tok = torch.argmax(lg, -1)
        eager.append(tok)
    assert torch.equal(toks, torch.stack(eager, dim=1))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_engine_on_the_card(dev, paged):
    """Engine(prefill_chunk=128) at the CUDA window (8): two long prompts
    (bucket 512: four chunks each) among short ones, the running slots'
    decode advancing in every chunk step; the greedy tokens of the same
    engine without chunks admitting with W8A16 (the chunks' projections)
    over a bf16 cache (an int8 one would hold a chunk's own keys quantized),
    every block freed."""
    from eetq_tpu_torch.serve.engine import Engine

    cfg, params = _graph_model(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    lengths, budgets = (17, 450, 5, 400, 64), (20, 12, 40, 9, 25)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist()
               for n in lengths]
    kw = dict(max_batch=4, max_len=1024, prompt_buckets=(64, 512), a8_prefill=False,
              kv_dtype=torch.bfloat16)
    if paged:
        kw.update(paged_blocks=13, paged_block_size=256)
    outs = []
    for extra in (dict(prefill_chunk=128), {}):
        eng = Engine(params, cfg, **kw, **extra)
        uids = [eng.add_request(p, b) for p, b in zip(prompts, budgets)]
        chunk_steps, advanced = 0, 0
        while eng.has_work:
            busy = [r for i, r in enumerate(eng.slot_req) if r is not None and eng.lengths[i] > 0]
            before = [len(r.out_tokens) for r in busy]
            chunking = eng._chunking is not None
            eng.step()
            if chunking and busy:  # a chunk step beside running slots
                chunk_steps += 1
                advanced += all(len(r.out_tokens) > n for r, n in zip(busy, before))
        outs.append([eng.result(u) for u in uids])
        if extra:
            assert chunk_steps > 0 and advanced == chunk_steps
        if paged:
            assert sorted(eng._free_blocks) == list(range(1, 13))
    assert outs[0] == outs[1]


# ---- checkpoints and quantization on the card (models/hf.py, quant/quantizer.py) ----

CKPT_BASE = dict(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=64, max_position=2048)
CKPT_FAMILIES = {"llama": {}, "mixtral": dict(num_experts=4, model_type="mixtral"),
                 "chatglm": dict(rope_dim=32, rope_interleaved=True, qkv_bias=True,
                                 max_position=8192, model_type="chatglm")}


@pytest.mark.parametrize("shape", [(1024, 384), (3, 512, 256)], ids=["linear", "bank"])
@pytest.mark.parametrize("group", [None, 64, 128], ids=["per-channel", "g64", "g128"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32],
                         ids=["f16", "bf16", "f32"])
def test_quantize_on_the_card_equals_the_cpu(dev, dtype, bits, group, shape):
    """`symmetric_quantize` on the card gives the CPU's int8 values and f32
    scales bit for bit (the loaders quantize on the device they load to)."""
    from eetq_tpu_torch.quant.quantizer import symmetric_quantize

    gen = torch.Generator().manual_seed(bits * 10 + len(shape))
    w = (torch.randn(shape, generator=gen) * 0.05).to(dtype)
    q_cpu, s_cpu = symmetric_quantize(w, bits=bits, group_size=group)
    q_card, s_card = symmetric_quantize(w.to(dev), bits=bits, group_size=group)
    assert q_card.is_cuda and torch.equal(q_card.cpu(), q_cpu)
    assert torch.equal(s_card.cpu(), s_cpu)


def _assert_as_stored(src, got):
    """Every tensor of `got` equal to `src`'s: int8 as it is, the rest as
    the checkpoint's fp16 holds it."""
    have = dict(got.named_buffers())
    for name, t in src.named_buffers():
        g, t = have[name].cpu(), t.cpu()
        want = t if t.dtype == torch.int8 else t.to(torch.float16).to(t.dtype)
        assert g.dtype == t.dtype and torch.equal(g, want), name


@pytest.mark.parametrize("card_first", [True, False], ids=["card-to-cpu", "cpu-to-card"])
@pytest.mark.parametrize("quant", [(8, None), (4, 64)], ids=["int8", "int4-g64"])
@pytest.mark.parametrize("family", CKPT_FAMILIES)
def test_checkpoint_between_the_card_and_the_cpu(dev, tmp_path, family, quant, card_first):
    """save_quantized of params on the card, load_quantized(device="cpu"),
    and the reverse: the same tensors and config, in several shards."""
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.hf import load_quantized, save_quantized
    from eetq_tpu_torch.models.init import random_quantized_params

    cfg = ModelConfig(**{**CKPT_BASE, **CKPT_FAMILIES[family]})
    src_dev, dst_dev = (dev, torch.device("cpu")) if card_first else (torch.device("cpu"), dev)
    bits, group = quant
    params = random_quantized_params(cfg, torch.Generator(device=src_dev).manual_seed(0),
                                     quantize_lm_head=True, bits=bits, group_size=group)
    save_quantized(params, cfg, str(tmp_path), max_shard_bytes=1 << 19)
    assert len(list(tmp_path.glob("*.safetensors"))) >= 3
    cfg2, got = load_quantized(str(tmp_path), device=dst_dev)
    assert cfg2 == cfg
    assert all(b.device.type == dst_dev.type for b in got.buffers())
    _assert_as_stored(params, got)


def test_load_quantized_defaults_to_the_card(dev, tmp_path):
    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.hf import load_quantized, save_quantized
    from eetq_tpu_torch.models.init import random_quantized_params

    cfg = ModelConfig(**CKPT_BASE)
    params = random_quantized_params(cfg, torch.Generator().manual_seed(0))
    save_quantized(params, cfg, str(tmp_path))
    for got in (load_quantized(str(tmp_path))[1],
                AutoEETQForCausalLM.from_quantized(str(tmp_path)).params):
        assert all(b.is_cuda for b in got.buffers())
        _assert_as_stored(params, got)


# ---- the GEMMs' fused epilogue and multi-adapter LoRA ----

EPILOGUES = ("relu", "gelu", "silu", "add", "mul")
EPI_KERNELS = {"w8a16_gemv": (w8a16_gemv, 8), "w4a16_gemv": (w4a16_gemv, 4),
               "w8a16_gemm": (w8a16_gemm, 8), "w4a16_gemm": (w4a16_gemm, 4),
               "w8a8_gemm": (w8a8_gemm, 8), "w4a8_gemm": (w4a8_gemm, 4)}


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("group", [None, 64], ids=["per-channel", "g64"])
@pytest.mark.parametrize("name", list(EPI_KERNELS))
@pytest.mark.parametrize("n", [384, 300])
def test_epilogue_against_plain(dev, name, group, epilogue, n):
    """act(x W s + bias) [+|*] residual against the plain version, in every
    kernel of the three GEMM families (GEMV m = 1 and 8, K split across blocks
    at N = 384; GEMM and W8A8 / W4A8 at m = 200, N = 300 through the scalar
    stores); W8A8 without a transcendental bit-equal; the GEMV's repeats
    bit-equal; the launch counted as the variant "epilogue"."""
    kernel, bits = EPI_KERNELS[name]
    if name == "w8a8_gemm" and group is not None:
        pytest.skip("group-wise W8A8 has no kernel (it stays on the W8A16 path)")
    gen = torch.Generator(device=dev).manual_seed(17)
    k = 512
    lo, hi = (-127, 128) if bits == 8 else (-8, 8)
    q = torch.randint(lo, hi, (k, n), generator=gen, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    shape = (n,) if group is None else (k // group, n)
    sc = torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4
    bias = (0.1 * torch.randn(n, generator=gen, device=dev)).to(torch.bfloat16)
    epi = (dict(activation=epilogue) if epilogue in ("relu", "gelu", "silu")
           else dict(residual_mode=epilogue))
    for m in ((1, 8) if "gemv" in name else (200,)):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        if "residual_mode" in epi:
            epi["residual"] = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        before = dict(kernel.variant_launches)
        if name.endswith("a8_gemm"):
            xq, sx = quantize_activations(x)
            xq = torch.nn.functional.pad(xq, (0, data.shape[0] * (8 // bits) - k)).contiguous()
            qp = torch.nn.functional.pad(q, (0, 0, 0, xq.shape[1] - k))
            grp = {} if bits == 8 else dict(group_size=group)
            out = kernel(xq, sx, data, sc, n, bias, **grp, **epi)
            ref = w8a8_gemm_ref(xq, sx, qp, sc, n, bias, group_size=group, **epi)
        else:
            out = kernel(x, data, sc, n, bias, **epi)
            ref = w8a16_matmul_ref(x, q, sc, bias, **epi)
        assert kernel.variant_launches["epilogue"] == before["epilogue"] + 1
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2.0 ** -6 * ref.float().abs().max().item(), (m, err)
        if name == "w8a8_gemm" and epilogue in ("relu", "add", "mul"):
            assert torch.equal(out, ref)
        if "gemv" in name:
            again = kernel(x, data, sc, n, bias, **epi)
            assert torch.equal(out, again)
            row = kernel(x[3:4] if m == 8 else x, data, sc, n, bias,
                         **{key: (v[3:4] if m == 8 and key == "residual" else v)
                            for key, v in epi.items()})
            assert torch.equal(row[0], out[3 if m == 8 else 0])


def test_epilogue_wrappers_raise_on_the_card(dev):
    """A CUDA tensor with an epilogue reaches the kernel or raises: no plain
    fallback."""
    q = torch.randint(-127, 128, (256, 256), device=dev, dtype=torch.int8)
    sc = torch.ones(256, device=dev)
    x = torch.ones(4, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="residual"):
        w8a16_gemv(x, q, sc, 256, residual=torch.ones(4, 256, device=dev))  # f32
    res = torch.randn(4, 257, device=dev).to(torch.bfloat16)[:, 1:]  # not contiguous
    with pytest.raises(TypeError, match="residual"):
        w8a16_gemv(x, q, sc, 256, residual=res)
    with pytest.raises(TypeError, match="residual"):
        w8a16_gemm(torch.ones(40, 256, dtype=torch.bfloat16, device=dev), q, sc, 256,
                   residual=torch.ones(4, 256, dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="activation"):
        w8a16_gemm(x, q, sc, 256, activation="tanh")


def _lora_toy(dev):
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params
    from eetq_tpu_torch.surgery import attach_lora, stack_adapters

    # the toy preset's head dim 32 has no CUDA attention kernel
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=64, max_position=512)
    gen = torch.Generator(device=dev).manual_seed(5)
    base = quantize_params(random_dense_params(cfg, gen), quantize_lm_head=True)
    singles = []
    for i in range(3):
        adapted = attach_lora(base, 8, gen)  # adapter 0 keeps B = 0
        for lp in adapted.layers if i else ():
            for ad in (lp.qkv_lora, lp.o_lora):
                ad.lora_b.normal_(0, 0.05 * i, generator=gen)
        singles.append(adapted)
    return cfg, base, singles, stack_adapters(singles)


@pytest.mark.parametrize("kw", [dict(), dict(paged_blocks=9, paged_block_size=128),
                                dict(spec_ngram=3)], ids=["dense", "paged", "spec"])
def test_lora_engine_on_the_card(dev, kw):
    """A bank behind the engine on the card (captured windows of 8): each
    request's tokens equal those of the same engine serving it alone, slots
    recycled with new ids between windows included (a stale id in the
    captured graphs would part them); the ids' buffer keeps its address and
    holds the host's ids; every adapter moves some request off the base."""
    from eetq_tpu_torch.serve.engine import Engine

    cfg, base, _, bank = _lora_toy(dev)
    prompts = [[3 + i, 17, 42, 9, 3, 17 + i] for i in range(6)]
    ids = [1, 2, 0, 2, 1, 2]
    make = lambda p: Engine(p, cfg, max_batch=2, max_len=128,  # noqa: E731
                            prompt_buckets=(8, 16), **kw)
    eng = make(bank)
    buf = eng._lora_ids
    uids = [eng.add_request(p, 20, lora_id=i) for p, i in zip(prompts, ids)]
    eng.run()
    got = [eng.result(u) for u in uids]
    assert eng._lora_ids is buf and eng._lora_ids.tolist() == eng.lora_ids.tolist()
    alone = []
    for p, i in zip(prompts, ids):
        e = make(bank)
        alone.append(e.generate_all([p], 20, lora_id=i)[0])
    assert got == alone
    plain = make(base).generate_all(prompts, 20)
    for a in (1, 2):
        assert any(g != b for g, b, i in zip(got, plain, ids) if i == a)
    assert all(g == b for g, b, i in zip(got, plain, ids) if i == 0)  # B = 0


def test_capture_survives_a_collection_of_another_graph(dev):
    """A captured graph left in a reference cycle (as an engine behind a
    stopped HTTP server is) is freed by the cyclic collector; a capture
    during which a collection would run must not destroy it mid-capture
    (the capture is then invalidated)."""
    import gc

    from eetq_tpu_torch.serve.graph import StepGraph

    x = torch.zeros(1024, device=dev)
    old = StepGraph(lambda: x.add_(1), dev)
    old()
    old()  # warmed, captured, replayed
    cycle = [old]
    cycle.append(cycle)
    del old, cycle
    thresholds = gc.get_threshold()
    gc.set_threshold(1)  # a collection at (nearly) every allocation
    try:
        step = StepGraph(lambda: x.copy_(x * 2 + torch.ones_like(x)), dev)
        step()
        step()
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    torch.cuda.synchronize()
    assert step.captured and bool(torch.isfinite(x).all())


# ---- LoRA finetuning's backward on the card ----

def _grads(out, leaves, gout):
    return torch.autograd.grad(out.float(), leaves, gout)


def _close_grad(got, want, tol, what):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert scale > 0 and err <= tol * scale, (what, err, scale)


# (activation, residual mode, prenorm)
GRAD_EPILOGUES = [(None, None, True), ("relu", "add", False), ("gelu", "mul", True),
                  ("silu", "mul", False)]


@pytest.mark.parametrize("m", [3, 200])  # the GEMV and the GEMM under DequantMatmul
@pytest.mark.parametrize("act,mode,prenorm", GRAD_EPILOGUES)
@pytest.mark.parametrize("bits,group", [(8, None), (8, 64), (4, None), (4, 128)])
def test_dequant_matmul_grads_on_the_card(dev, bits, group, act, mode, prenorm, m):
    """`w8a16_matmul` under grad: the kernel forward inside `DequantMatmul`,
    its gradients w.r.t. x, scales, bias, residual and gamma against
    autograd through the plain path on the card (tolerances of
    `tests/test_torch_train.py`: 2^-6 for dx and dgamma, 2^-7 for the rest);
    a second backward is bit-equal."""
    from eetq_tpu_torch.ops.linear import w8a16_matmul
    from eetq_tpu_torch.quant.quantizer import symmetric_quantize

    g = torch.Generator(device=dev).manual_seed(m + bits)
    k, n = 1024, 768
    w = torch.randn(k, n, generator=g, device=dev) / 32
    q, s = symmetric_quantize(w, bits=bits, group_size=group)
    packed = pack_weights(q, bits=bits)
    base = {"x": torch.randn(m, k, generator=g, device=dev).bfloat16(), "scales": s,
            "bias": torch.randn(n, generator=g, device=dev).bfloat16()}
    if mode is not None:
        base["residual"] = torch.randn(m, n, generator=g, device=dev).bfloat16()
    if prenorm:
        base["gamma"] = 1 + 0.1 * torch.randn(k, generator=g, device=dev)
    gout = torch.randn(m, n, generator=g, device=dev)
    names = list(base)

    def run(use_kernel):
        t = {name: v.clone().requires_grad_() for name, v in base.items()}
        out = w8a16_matmul(t["x"], packed, t["scales"], bias=t["bias"], activation=act,
                           residual=t.get("residual"), residual_mode=mode or "add",
                           prenorm_gamma=t.get("gamma"), use_kernel=use_kernel)
        return _grads(out, [t[name] for name in names], gout)

    got, again, want = run(True), run(True), run(False)
    for name, a, b, r in zip(names, got, again, want):
        assert torch.equal(a, b), name
        _close_grad(a, r, 2.0**-6 if name in ("x", "gamma") else 2.0**-7, name)


# (batch, Sq, Skv, Hq, Hkv, D, window, ALiBi)
FLASH_GRAD_CASES = [
    (1, 1024, 1024, 32, 32, 128, None, False),  # llama2-7b's training shape
    (2, 300, 300, 8, 2, 64, None, False),
    (1, 128, 640, 8, 1, 128, None, False),  # delta 512, three chunks
    (1, 512, 512, 8, 8, 128, 128, False),
    (1, 256, 256, 8, 2, 128, None, True),
    (1, 512, 512, 16, 16, 256, None, False),  # gemma-7b's head dim
    (1, 300, 300, 4, 2, 256, 100, True),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window,alibi", FLASH_GRAD_CASES)
def test_flash_attention_grads_on_the_card(dev, b, sq, skv, hq, hkv, d, window, alibi):
    """`flash_attention` under grad: the CUDA forward inside `FlashAttention`,
    dq, dk and dv against autograd through the plain f32 attention on the
    card (2^-6 of the largest), a second backward bit-equal, and a zero
    gradient for the ALiBi slopes."""
    from eetq_tpu_torch.kernels.flash_attention import attention_reference, causal_mask

    g = torch.Generator(device=dev).manual_seed(sq + d)
    q = torch.randn(b, sq, hq, d, generator=g, device=dev).bfloat16()
    kv = torch.randn(b, skv, 2 * hkv, d, generator=g, device=dev).bfloat16()
    slopes = (2.0 ** -torch.arange(1, hq + 1, device=dev, dtype=torch.float32)) if alibi else None
    do = torch.randn(b, sq, hq, d, generator=g, device=dev)

    def run(kernel):
        qq, kk = q.clone().requires_grad_(), kv.clone().requires_grad_()
        k, v = kk[:, :, :hkv], kk[:, :, hkv:]  # strided views, as the model's split
        sl = None if slopes is None else slopes.clone().requires_grad_(kernel)
        if kernel:
            before = flash_attention.launches
            out = flash_attention(qq, k, v, window=window, slopes=sl)
            assert flash_attention.launches == before + 1
        else:
            out = attention_reference(qq, k, v, causal_mask(sq, window, skv, dev), d ** -0.5,
                                      slopes=sl)
        leaves = [qq, kk] + ([sl] if kernel and sl is not None else [])
        return _grads(out, leaves, do)

    got, again, want = run(True), run(True), run(False)
    for name, a, b2, r in zip(("dq", "dkv"), got, again, want):
        assert torch.equal(a, b2), name
        _close_grad(a, r, 2.0**-6, name)
    if alibi:
        assert not got[2].any()


@pytest.mark.parametrize("name", ["w8a8_gemm", "fused_mlp_gemv", "w8a16_expert_gemv",
                                  "w8a16_grouped_gemm", "flash_decode", "flash_decode_int8",
                                  "paged_flash_decode", "paged_flash_decode_int8"])
def test_entries_without_backward_raise_on_the_card(dev, name):
    """A gradient through W8A8, the fused MLP, the expert kernels or the
    flash-decode raises NotImplementedError on the card, naming the entry
    point; the same call runs under no_grad."""
    g = torch.Generator(device=dev).manual_seed(7)
    k = n = 256
    x = torch.randn(2, k, generator=g, device=dev).bfloat16()
    q8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    s = torch.rand(n, generator=g, device=dev) / 100
    bank = torch.randint(-127, 128, (2, k, n), generator=g, device=dev, dtype=torch.int8)
    bs = torch.rand(2, n, generator=g, device=dev) / 100
    ids = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    qd = torch.randn(2, 1, 4, 128, generator=g, device=dev).bfloat16()
    kc = torch.randn(2, 2, 256, 128, generator=g, device=dev).bfloat16()
    k8 = torch.randint(-127, 128, (2, 2, 256, 128), generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand(2, 2, 256, generator=g, device=dev)
    lens = torch.tensor([5, 200], dtype=torch.int32, device=dev)
    table = torch.tensor([[0], [1]], dtype=torch.int32, device=dev)
    xg, qg = x.clone().requires_grad_(), qd.clone().requires_grad_()
    calls = {
        "w8a8_gemm": lambda x: w8a8_matmul(x, pack_weights(q8), s),
        "fused_mlp_gemv": lambda x: fused_mlp_gemv(x, torch.ones(k, device=dev), 1e-6,
                                                   torch.cat([q8, q8], 1), torch.cat([s, s]),
                                                   q8, s, n),
        "w8a16_expert_gemv": lambda x: w8a16_expert_gemv(x, bank, bs, ids, n),
        "w8a16_grouped_gemm": lambda x: w8a16_grouped_gemm(
            torch.cat([x] * 8), bank, bs, ids, n),  # two blocks of 8 rows
        "flash_decode": lambda q: flash_decode(q, kc, kc, lens),
        "flash_decode_int8": lambda q: flash_decode_int8(q, k8, k8, ks, ks, lens),
        "paged_flash_decode": lambda q: paged_flash_decode(q, kc, kc, table, lens),
        "paged_flash_decode_int8": lambda q: paged_flash_decode_int8(q, k8, k8, ks, ks, table,
                                                                     lens),
    }
    arg, frozen = (qg, qd) if "decode" in name else (xg, x)
    with pytest.raises(NotImplementedError, match=name):
        calls[name](arg)
    with torch.no_grad():
        calls[name](arg)
    calls[name](frozen)
    torch.cuda.synchronize()


def test_lora_grads_on_the_card(dev):
    """LoRA gradients through `forward_inner` (prefill, caches=None) on the
    kernel path against the plain path on the card, within the JAX test's
    5e-2 (`tests/test_flash_attention.py:194-197`); only the GEMM and the
    prefill flash-attention launch."""
    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params
    from eetq_tpu_torch.models.transformer import ModelParams, forward_inner
    from eetq_tpu_torch.surgery import init_lora
    from eetq_tpu_torch.surgery.lora import replace_layer

    cfg = ModelConfig(vocab_size=1024, hidden_size=1024, intermediate_size=2048, num_layers=2,
                      num_heads=8, num_kv_heads=8, head_dim=128, max_position=2048)
    g = torch.Generator(device=dev).manual_seed(0)
    base = quantize_params(random_dense_params(cfg, g), quantize_lm_head=True)

    def adapter(lin):
        ad = init_lora(g, lin.in_features, lin.out_features, 16)
        ad.lora_b.copy_(torch.randn(ad.lora_b.shape, generator=g, device=dev) * 0.005)
        return ad

    params = ModelParams(base.embed, [replace_layer(lp, qkv_lora=adapter(lp.qkv),
                                                    o_lora=adapter(lp.o_proj))
                                      for lp in base.layers], base.final_norm, base.lm_head)
    leaves = [getattr(ad, n).requires_grad_() for lp in params.layers
              for ad in (lp.qkv_lora, lp.o_lora) for n in ("lora_a", "lora_b")]
    toks = torch.randint(0, cfg.vocab_size, (1, 512), generator=g, device=dev)
    pos = torch.arange(512, device=dev)[None]

    def grads(use):
        logits, _ = forward_inner(params, cfg, toks, pos, None, 0, use_kernels=use)
        loss = torch.nn.functional.cross_entropy(logits[0, :-1], toks[0, 1:])
        return torch.autograd.grad(loss, leaves)

    reset_launch_counts()
    got = grads(True)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"w8a16_gemm": 4 * 2 + 1, "flash_attention_fwd": 2}, counts
    want = grads(False)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.abs().sum() > 0, i
        _close_grad(a, b, 5e-2, f"adapter tensor {i}")


# ---- the measured autotune's launch choices, the offline tp reshard's
# group sizes, the host quantizer ----


@pytest.mark.parametrize("tile_m", [0, 128, 256])
@pytest.mark.parametrize("m", [9, 130, 300])
@pytest.mark.parametrize("bits", [8, 4])
def test_gemm_tiles(dev, bits, m, tile_m):
    """The per-channel GEMM at either tile (or the rule's, 0) on an odd
    (K, N) with bias, against the plain version."""
    g = torch.Generator(device=dev).manual_seed(m + tile_m)
    k, n = 1000, 300
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    scales = _scales(g, dev, k, n, None)
    bias = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    gemm = w4a16_gemm if bits == 4 else w8a16_gemm
    _close(gemm(x, data, scales, n, bias, tile_m=tile_m), w8a16_matmul_ref(x, q, scales, bias))


def test_gemm_invalid_tile_raises(dev):
    """A tile the GEMM has not (64), and 128 under group-wise scales (one
    256-row tile there), are refused by the kernel's entry point; 256 there
    is the rule's own launch."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randint(-127, 128, (256, 256), generator=g, device=dev, dtype=torch.int8)
    x = torch.randn(64, 256, generator=g, device=dev).to(torch.bfloat16)
    data = pack_weights(q).data
    per_channel, grouped = _scales(g, dev, 256, 256, None), _scales(g, dev, 256, 256, 128)
    with pytest.raises(RuntimeError, match="eetq_w8a16_gemm"):
        w8a16_gemm(x, data, per_channel, 256, tile_m=64)
    with pytest.raises(RuntimeError, match="eetq_w8a16_gemm"):
        w8a16_gemm(x, data, grouped, 256, tile_m=128)
    out = w8a16_gemm(x, data, grouped, 256, tile_m=256)
    assert torch.equal(out, w8a16_gemm(x, data, grouped, 256, tile_m=0))
    _close(out, w8a16_matmul_ref(x, q, grouped))


@pytest.mark.parametrize("m", [1, 8, 9, 1024])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,group", [(4096, 2048), (11008, 5504), (11008, 1376), (4096, 512)])
def test_tp_reshard_group_sizes(dev, k, group, bits, m):
    """The GEMV (m <= 8) and the GEMM at the offline tp reshard's group sizes
    (o_proj K = 4096 and down K = 11008 over tp 2, 4, 8): 5504 and 1376 are
    multiples of 32 but not of the GEMM's 64-deep K step or of 128."""
    g = torch.Generator(device=dev).manual_seed(k + group + m)
    n = 512
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q = torch.randint(lo, hi, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    scales = _scales(g, dev, k, n, group)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    kern = ((w4a16_gemv if bits == 4 else w8a16_gemv) if m <= 8
            else (w4a16_gemm if bits == 4 else w8a16_gemm))
    out = _twice(lambda: kern(x, data, scales, n)) if m <= 8 else kern(x, data, scales, n)
    _close(out, w8a16_matmul_ref(x, q, scales))


def test_tuned_split_is_read_and_launched(dev, tmp_path, monkeypatch):
    """A K split written to the autotune cache for this card is what the
    GEMV launches (bit-equal to an explicit call at that split), a split
    below the floor at the call's m is ignored, and the GEMM's tuned tile is
    read back."""
    from eetq_tpu_torch.kernels import autotune

    monkeypatch.setenv("EETQ_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.delenv("EETQ_AUTOTUNE", raising=False)
    autotune.clear_caches()
    g = torch.Generator(device=dev).manual_seed(1)
    k, n = 11008, 4096
    q = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q).data
    scales = _scales(g, dev, k, n, None)
    x = torch.randn(1, k, generator=g, device=dev).to(torch.bfloat16)
    rows, np_ = data.shape
    rule = autotune.choose_gemv_splits(dev.index, rows, np_, 8, 1, 0)
    tuned = 3 if rule != 3 else 5
    name = autotune.device_name(dev.index)
    autotune._save_persistent({
        autotune.tune_key(name, 1, rows, np_, 8, 0): {"splits": tuned},
        autotune.tune_key(name, 1024, rows, np_, 8, 0): {"tile_m": 128},
    })
    try:
        assert autotune.choose_gemv_splits(dev.index, rows, np_, 8, 1, 0) == tuned
        got = w8a16_gemv(x, data, scales, n)
        assert torch.equal(got, w8a16_gemv(x, data, scales, n, splits=tuned))
        _close(got, w8a16_matmul_ref(x, q, scales))
        assert autotune.choose_gemm_tile(dev.index, 1024, rows, np_, 8, 0) == 128
        xg = torch.randn(1024, k, generator=g, device=dev).to(torch.bfloat16)
        assert torch.equal(w8a16_gemm(xg, data, scales, n), w8a16_gemm(xg, data, scales, n,
                                                                       tile_m=128))
        with pytest.raises(ValueError, match="K splits"):
            w8a16_gemv(x, data, scales, n, splits=rows)
    finally:
        autotune.clear_caches()


def test_measured_autotune_sweeps_and_persists(dev, tmp_path, monkeypatch):
    """One sweep of each regime on the card: the winner is a candidate, the
    rule stays unless beaten by more than AUTOTUNE_MIN_GAIN, and the file
    holds it under this card's name."""
    import json

    from eetq_tpu_torch.kernels import autotune

    monkeypatch.setenv("EETQ_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    autotune.clear_caches()
    try:
        for m in (1, 512):
            t = autotune.measured_autotune(m, 4096, 4096, device=dev, iters=50)
            assert t.choice in t.ms and t.rule in t.ms
            assert t.choice == t.rule or t.ms[t.choice] < (1 - autotune.AUTOTUNE_MIN_GAIN) * \
                t.ms[t.rule]
            with open(tmp_path / "tune.json") as f:
                assert json.load(f)[t.key] == {t.what: t.choice}
            assert autotune.device_name(dev.index) in t.key
    finally:
        autotune.clear_caches()


def test_device_time_on_the_card(dev):
    from eetq_tpu_torch.utils.profiling import chip_peaks, device_time, host_sync_overhead

    x = torch.randn(2048, 2048, device=dev)
    t = device_time(lambda: x @ x, iters=20, reps=3, device=dev)
    assert 0 < t < 1.0
    assert host_sync_overhead(device=dev) > 0
    assert chip_peaks(dev).hbm_gbs > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("bits,group", [(8, None), (8, 128), (4, 64)])
def test_native_quantizer_against_the_card(dev, dtype, bits, group):
    """The host quantizer bit-equal to `symmetric_quantize` on the card, a
    bank of 3 experts and an all-zero column included."""
    from eetq_tpu_torch.native import host_symmetric_quantize
    from eetq_tpu_torch.quant.quantizer import symmetric_quantize

    g = torch.Generator(device=dev).manual_seed(bits)
    w = (torch.randn(3, 512, 384, generator=g, device=dev) * 0.05).to(dtype)
    w[:, :, 7] = 0
    q, s = host_symmetric_quantize(w.cpu(), bits=bits, group_size=group)
    qd, sd = symmetric_quantize(w, bits=bits, group_size=group)
    assert torch.equal(q, qd.cpu()) and torch.equal(s, sd.cpu())


# ---- tensor parallelism across ranks (dist/): two gloo ranks on cuda:0 ----

# llama2-7b's widths at 2 layers
SHARDED_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_layers=2,
                   num_heads=32, num_kv_heads=32, head_dim=128, max_position=4096,
                   model_type="llama")


def test_sharded_forward_on_the_card(dev, tmp_path):
    """Two ranks on cuda:0 over gloo, each drawing the same 2-layer
    llama2-7b-width model from the seed and keeping its shard
    (`shard_model(quantize=True)`): prefill and two teacher-forced decode
    steps against the plain path of the one-card model of the same integers
    (`quantize_params_tp(tp=2)`: o_proj and down group-wise at K / 2), within
    5e-2 of the largest logit; the ranks' logits identical; each rank
    launched the GEMM, the GEMV and both attention kernels, and no
    group-wise GEMV or GEMM (its row shards are per-channel)."""
    import dataclasses

    import numpy as np

    import torch_sharding_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.init import random_dense_layers, random_dense_params
    from eetq_tpu_torch.models.transformer import ModelParams, forward_inner, init_caches
    from eetq_tpu_torch.surgery.tp_reshard import quantize_params_tp

    _build.build()  # once, before the ranks load it
    cfg = ModelConfig(**SHARDED_CFG)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (1, 96))
    steps = rng.integers(0, cfg.vocab_size, (1, 2))
    with RankPool(2, f"file://{tmp_path}/store", backend="gloo", timeout_s=600) as pool:
        pool.run(tasks.build_random, cfg, 7)
        got = pool.run(tasks.forward, tokens, steps)
    stub = random_dense_params(dataclasses.replace(cfg, num_layers=0),
                               torch.Generator(device=dev).manual_seed(8))
    layers = list(random_dense_layers(cfg, torch.Generator(device=dev).manual_seed(7)))
    one = quantize_params_tp(ModelParams(stub.embed, layers, stub.final_norm, stub.lm_head),
                             cfg, 2)
    with torch.inference_mode():
        caches = init_caches(cfg, 1, 99, device=dev)
        lg, _ = forward_inner(one, cfg, torch.as_tensor(tokens, device=dev),
                              torch.arange(96, device=dev)[None], caches, 0, use_kernels=False)
        want = [lg[0].float().cpu().numpy()]
        for j in range(2):
            lg, _ = forward_inner(one, cfg, torch.as_tensor(steps[:, j:j + 1], device=dev),
                                  torch.full((1, 1), 96 + j, device=dev), caches, 96 + j,
                                  use_kernels=False)
            want.append(lg[0, -1].float().cpu().numpy())
    np.testing.assert_array_equal(got[0]["prefill"], got[1]["prefill"])
    np.testing.assert_array_equal(got[0]["decode"], got[1]["decode"])
    for have, ref in zip([got[0]["prefill"][0]] + list(got[0]["decode"][:, 0]), want):
        err = np.abs(have - ref).max()
        assert err <= 5e-2 * np.abs(ref).max(), err
    for r in got:
        counts = r["launches"]
        assert all(counts[k] for k in ("w8a16_gemm", "w8a16_gemv", "flash_attention_fwd",
                                       "flash_decode")), counts
        assert not counts["w8a16_gemv[group]"] and not counts["w8a16_gemm[group]"], counts
        assert r["counts"] == {"all_reduce": 2 * 2 * 96 * 4096 * 2, "all_reduce_count": 4,
                               "all_gather": 96 * 16000 * 2, "all_gather_count": 1}


def test_sharded_engine_on_the_card(dev, tmp_path):
    """The sharded engine on two ranks of cuda:0 (bf16 cache, W8A16 prefill,
    eager windows), plain and speculative (k = 7): every rank commits the
    same tokens, greedy and sampled, each request its budget of in-range
    ids. (Against the one-card engine: chip_smoke.py's tp2_server.)"""
    import torch_sharding_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.models.config import ModelConfig

    _build.build()
    cfg = ModelConfig(**SHARDED_CFG)
    requests = [([7, 8, 9] * 20, 12, {}), (list(range(100, 400)), 8, {}),
                ([5] * 33, 10, dict(temperature=0.8, top_k=20))]
    with RankPool(2, f"file://{tmp_path}/store", backend="gloo", timeout_s=600) as pool:
        pool.run(tasks.build_random, cfg, 3)
        plain = pool.run(tasks.serve, requests, dict(max_batch=4, max_len=512))
        spec = pool.run(tasks.serve, requests[:2], dict(max_batch=4, max_len=512, spec_ngram=7))
    assert plain[0] == plain[1] and spec[0] == spec[1]
    assert [len(o) for o in plain[0]] == [12, 8, 10]
    assert all(0 <= t < cfg.vocab_size for o in plain[0] for t in o)


def test_dp_engine_on_the_card(dev, tmp_path):
    """The engine under dp 2 x tp 2 on four ranks of cuda:0 (gloo; a 2-layer
    llama2-7b-width W8A16 model drawn from the seed), plain and speculative
    (k = 7): every rank commits the same tokens, greedy and sampled, each
    request its budget of in-range ids; admissions take up to 2 requests a
    round; the spec engine's greedy requests equal the plain engine's or
    part where the plain path's verify and decode GEMMs round apart (at
    most one request)."""
    import torch_dp_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.models.config import ModelConfig

    _build.build()
    cfg = ModelConfig(**SHARDED_CFG)
    requests = [([7, 8, 9] * 20, 12, {}), (list(range(100, 400)), 8, {}),
                ([5] * 33, 10, dict(temperature=0.8, top_k=20)), ([3, 1, 4, 1, 5] * 9, 9, {})]
    kw = dict(max_batch=4, max_len=512)
    with RankPool(4, f"file://{tmp_path}/store", backend="gloo", timeout_s=600) as pool:
        pool.run(tasks.build_random_dp, 2, 2, cfg, 3)
        plain = pool.run(tasks.dp_serve, requests, kw)
        spec = pool.run(tasks.dp_serve, requests, dict(kw, spec_ngram=7))
    for runs in (plain, spec):
        assert all(r["outputs"] == runs[0]["outputs"] for r in runs)
        assert all(r["rounds"] == [2, 2] for r in runs), [r["rounds"] for r in runs]
    outs = plain[0]["outputs"]
    assert [len(o) for o in outs] == [12, 8, 10, 9]
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    greedy = [i for i, (_, _, k) in enumerate(requests) if not k]
    assert sum(spec[0]["outputs"][i] != outs[i] for i in greedy) <= 1
    assert spec[0]["spec_rounds"] > 0


def test_server_over_ranks_on_the_card(dev, tmp_path):
    """EngineServer on rank 0 of four ranks of cuda:0 (dp 2 x tp 2, gloo),
    the others following: every answer, plain or streamed, and every rank's
    outputs equal the same engine driven directly; the followers see
    heartbeats through an idle gap, and shutdown() returns every rank."""
    import torch_dp_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.models.config import ModelConfig

    _build.build()
    cfg = ModelConfig(**SHARDED_CFG)
    prompts = [[7, 8, 9] * 20, list(range(100, 400)), [5] * 33, [3, 1, 4, 1, 5] * 9]
    budgets = [12, 8, 10, 9]
    bodies = [{"prompt": p, "max_new_tokens": n, "stream": i % 2 == 1}
              for i, (p, n) in enumerate(zip(prompts, budgets))]
    kw = dict(max_batch=4, max_len=512)
    with RankPool(4, f"file://{tmp_path}/store", backend="gloo", timeout_s=600) as pool:
        pool.run(tasks.build_random_dp, 2, 2, cfg, 3)
        got = pool.run(tasks.serve_http, 2, 2, bodies, 0.5, 2.0, kw)
        direct = pool.run(tasks.dp_serve, [(p, n, {}) for p, n in zip(prompts, budgets)], kw)
    want = direct[0]["outputs"]
    assert all(d["outputs"] == want for d in direct)
    assert [a["tokens"] for a in got[0]["answers"]] == want
    assert all(r["outputs"] == got[0]["outputs"] for r in got)
    assert all(r["follow"]["idle"] >= 2 for r in got[1:]), [r["follow"] for r in got[1:]]


def test_a_failing_rank_fails_on_the_card(dev, tmp_path):
    """A rank that raises on the card fails the call, with its traceback."""
    import torch_sharding_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool

    pool = RankPool(2, f"file://{tmp_path}/store", backend="gloo", timeout_s=120)
    with pytest.raises(RuntimeError, match="(?s)failed:.*boom"):
        pool.run(tasks.fail, "boom")


def _near_tie(row, a: int, b: int, ulps: int = 8) -> bool:
    """a and b both within `ulps` bf16 ulps (of the largest |logit|) of the
    top of `row`."""
    import math

    ulp = 2.0 ** (math.floor(math.log2(float(row.abs().max()))) - 7)
    return float(row.max() - min(row[a], row[b])) <= ulps * ulp


def test_pp_generate_on_the_card(dev, tmp_path):
    """pp_generate over two stages of one layer each on cuda:0 (gloo ranks;
    a 2-layer llama2-7b-width W8A16 model drawn from the seed, b = 2 in two
    microbatches): the ranks' tokens identical; each token the one-card
    model's argmax after the same tokens, or within 8 bf16 ulps of it (the
    stages' GEMMs and GEMVs run at mb rows where the one-card path runs b);
    each rank launched the GEMM, the GEMV and both attention kernels."""
    import numpy as np

    import torch_pipeline_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.transformer import forward_inner, init_caches

    _build.build()
    cfg = ModelConfig(**SHARDED_CFG)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 96))
    n = 8
    with RankPool(2, f"file://{tmp_path}/store", backend="gloo", timeout_s=600) as pool:
        pool.run(tasks.pp_build_random, 2, 1, cfg, 11)
        got = pool.run(tasks.pp_generate_task, prompt, n, 2)
    np.testing.assert_array_equal(got[0]["tokens"], got[1]["tokens"])
    toks = torch.as_tensor(got[0]["tokens"], device=dev)
    one = tasks.seeded_model(cfg, 11, dev)
    with torch.inference_mode():
        caches = init_caches(cfg, 2, 96 + n, device=dev)
        lg, _ = forward_inner(one, cfg, torch.as_tensor(prompt, device=dev),
                              torch.arange(96, device=dev).expand(2, 96), caches, 0,
                              last_only=True)
        for j in range(n):
            for r in range(2):
                want = int(torch.argmax(lg[r, -1]))
                assert want == int(toks[r, j]) or _near_tie(lg[r, -1].float(), want,
                                                            int(toks[r, j])), (j, r)
            if j < n - 1:
                lg, _ = forward_inner(one, cfg, toks[:, j:j + 1],
                                      torch.full((2, 1), 96 + j, device=dev), caches, 96 + j)
    for r in got:
        assert all(r["launches"][k] for k in ("w8a16_gemm", "w8a16_gemv", "flash_attention_fwd",
                                              "flash_decode")), r["launches"]


@pytest.mark.parametrize("window,alibi", [(None, False), (24, False), (None, True)])
def test_ring_attention_on_the_card(dev, tmp_path, window, alibi):
    """ring_attention_sharded over two gloo ranks on cuda:0 (GQA 8/2, 2 x 64
    tokens, plain, a window of 24 and ALiBi) against the one-rank plain
    attention on the card, within 3e-2; the ranks identical; no kernel is
    launched (the statistics are plain torch, as in the JAX package)."""
    import numpy as np

    import torch_pipeline_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.kernels.flash_attention import attention_reference, causal_mask
    from eetq_tpu_torch.ops.alibi import alibi_slopes

    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 128, h, 64)).astype(np.float32) for h in (8, 2, 2))
    slopes = np.asarray(alibi_slopes(8), np.float32) if alibi else None
    with RankPool(2, f"file://{tmp_path}/store", backend="gloo", timeout_s=600) as pool:
        got = pool.run(tasks.ring, q, k, v, True, slopes, window)
    np.testing.assert_array_equal(got[0]["out"], got[1]["out"])
    t = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, k, v)]
    want = attention_reference(*t, causal_mask(128, window, 128, dev), 64 ** -0.5,
                               slopes=None if slopes is None else torch.from_numpy(slopes).to(dev))
    np.testing.assert_allclose(got[0]["out"], want.float().cpu().numpy(), atol=3e-2, rtol=3e-2)
    for r in got:
        assert not any(r["launches"].values()), r["launches"]
        assert r["counts"]["ppermute_count"] == 4, r["counts"]


def test_long_prefill_on_the_card(dev, tmp_path):
    """long_prefill over two gloo ranks on cuda:0 (the 2-layer
    llama2-7b-width W8A16 model, b = 1, 512 tokens) against the one-card
    prefill (the flash-attention kernel) within 5e-2 of the largest logit;
    the ranks identical; each rank's projections on the W8A16 GEMM and no
    flash-attention launch (ring attention), 2 p ppermutes a layer."""
    import numpy as np

    import torch_pipeline_tasks as tasks
    from eetq_tpu_torch.dist.launch import RankPool
    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.models.config import ModelConfig
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import prefill

    _build.build()
    cfg = ModelConfig(**SHARDED_CFG)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 512))
    with RankPool(2, f"file://{tmp_path}/store", backend="gloo", timeout_s=600) as pool:
        got = pool.run(tasks.long_prefill_random, cfg, 13, tokens)
    np.testing.assert_array_equal(got[0]["logits"], got[1]["logits"])
    one = tasks.seeded_model(cfg, 13, dev)
    want, _ = prefill(one, cfg, torch.as_tensor(tokens, device=dev),
                      init_caches(cfg, 1, 512, device=dev))
    want = want.float().cpu().numpy()
    assert np.abs(got[0]["logits"] - want).max() <= 5e-2 * np.abs(want).max()
    for r in got:
        assert r["launches"]["w8a16_gemm"] == 4 * cfg.num_layers, r["launches"]
        assert not r["launches"]["flash_attention_fwd"], r["launches"]
        assert r["counts"]["ppermute_count"] == 2 * 2 * cfg.num_layers, r["counts"]


# The shapes of the presets that first run at full width in chip_smoke.py's
# presets phase: llama2-70b's four layer shapes at int4 g = 128 (qkv, o_proj,
# gate|up at K = 8192; down at K = 28672), llama3-8b's and baichuan-7b's int8
# lm_heads (128,256 and 125,696 rows), the attention kernels at 64 q heads over
# 8 (llama2-70b) and at 32 over 4 with head dim 64 (tinyllama-1.1b).
LLAMA70B_SHAPES = [(8192, 10240), (8192, 8192), (8192, 57344), (28672, 8192)]


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", LLAMA70B_SHAPES)
def test_int4_group_gemv_at_llama70b_shapes(dev, m, k, n):
    """The int4 g = 128 GEMV (a b=1 decode step, an 8-slot engine step)
    against its plain version, two launches bit-equal: at K = 28672 the K
    split has the floor of 28672 rows of staged x and scale rows (the
    scratch `gemv_scratch_size` gives it), summed in order."""
    g = torch.Generator(device=dev).manual_seed(k + n + m)
    q = torch.randint(-8, 8, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=4).data
    splits = gemv_splits(data.shape[0], -(-n // GEMV_BLOCK_N), 1, 4, m, 128, sm_count(dev.index))
    assert splits >= gemv_split_floor(data.shape[0], 4, m, 128)
    if k == 28672:
        assert splits > 1
    scales = _scales(g, dev, k, n, 128)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    out = _twice(lambda: w4a16_gemv(x, data, scales, n))
    assert out.shape == (m, n)
    _close(out, w8a16_matmul_ref(x, q, scales))


def _ref_in_rows(x, q, scales, rows: int = 128):
    """w8a16_matmul_ref a block of rows at a time (its group-wise product
    holds [rows, groups, N] in f32)."""
    return torch.cat([w8a16_matmul_ref(x[i:i + rows], q, scales)
                      for i in range(0, x.shape[0], rows)])


@pytest.mark.parametrize("k,n", LLAMA70B_SHAPES)
def test_int4_group_gemm_at_llama70b_shapes(dev, k, n):
    """The group-wise int4 GEMM (its 256 x 64 tile) at a 1024-token prefill
    of each llama2-70b layer shape, against its plain version; two launches
    bit-equal."""
    g = torch.Generator(device=dev).manual_seed(k + n)
    q = torch.randint(-8, 8, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=4).data
    scales = _scales(g, dev, k, n, 128)
    x = torch.randn(1024, k, generator=g, device=dev).to(torch.bfloat16)
    out = _twice(lambda: w4a16_gemm(x, data, scales, n))
    assert out.shape == (1024, n)
    _close(out, _ref_in_rows(x, q, scales))


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n", [128256, 125696])
def test_int8_lm_head_gemv_at_preset_vocabularies(dev, m, n):
    """The int8 per-channel GEMV over llama3-8b's and baichuan-7b's heads
    (K = 4096; 1002 and 982 column strips of 128), two launches
    bit-equal."""
    g = torch.Generator(device=dev).manual_seed(n + m)
    k = 4096
    q = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=8).data
    scales = _scales(g, dev, k, n, None)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    out = _twice(lambda: w8a16_gemv(x, data, scales, n))
    assert out.shape == (m, n)
    _close(out, w8a16_matmul_ref(x, q, scales))


PRESET_ATTENTION = [(64, 8, 128), (32, 4, 64)]  # (q heads, kv heads, head dim)


@pytest.mark.parametrize("hq,hkv,d", PRESET_ATTENTION)
def test_flash_attention_at_preset_heads(dev, hq, hkv, d):
    """Prefill of a 1024-token prompt (the presets' b=1 paths) and of a
    batch of two ragged prompts appended to cached keys."""
    g = torch.Generator(device=dev).manual_seed(hq + d)
    for b, sq, skv in ((1, 1024, 1024), (2, 300, 812)):
        q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(torch.bfloat16)
        kv = torch.randn(b, skv, 2 * hkv, d, generator=g, device=dev).to(torch.bfloat16)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
        out = _twice(lambda: flash_attention(q, k, v))
        assert out.shape == q.shape
        _close(out, flash_attention_ref(q, k, v))


@pytest.mark.parametrize("mode", DECODE_MODES)
@pytest.mark.parametrize("b,lengths", [(1, [1074]), (8, [1, 2048, 17, 1500, 300, 1024, 640, 2047])])
@pytest.mark.parametrize("hq,hkv,d", PRESET_ATTENTION)
def test_flash_decode_at_preset_heads(dev, mode, b, lengths, hq, hkv, d):
    """The four flash-decode entry points at a b=1 step over 1074 keys and
    an 8-slot step up to the engine's 2048, over a 2048-key cache (paged:
    a permuted table of 256-key blocks); two launches bit-equal."""
    g = torch.Generator(device=dev).manual_seed(b + hq + d)
    kernel, ref = _decode_calls(g, dev, mode, b, hq, hkv, d, lengths)
    _close(_twice(kernel), ref())
