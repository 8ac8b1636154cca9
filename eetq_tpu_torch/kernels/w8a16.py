"""W8A16 and W4A16 dequant-matmul: the decode GEMV and the prefill GEMM
kernels, for int8 and for int4 weights.

All four replace `eetq_tpu/kernels/w8a16.py::w8a16_matmul_kernel_call`
(`pallas_call` at w8a16.py:355), one kernel per regime of that function and
per bit width:

- `w8a16_gemv` (m <= MAX_DECODE_M, `csrc/w8a16_gemv.cu`). Bound by weight
  bytes: a llama2-7b decode step streams about 6.7 GB of int8 weights
  through it and does 2 FLOPs per byte per row of x. The product
  outᵀ = Wᵀ xᵀ runs on the tensor cores (`mma.sync` m16n8k16, the rows of
  x as the MMA's N = 8, so each weight is widened once whatever m), its A
  operand built in registers from coalesced 16-byte weight loads. A block
  takes 128 columns and its warps take 16-row K steps in turns, each
  loading its next step as it multiplies one; where the column strips leave SMs
  idle, K is split across blocks (`autotune.gemv_splits`) and the strip's
  last block sums the f32 partials in split order, in the same launch
  (the scratch: `_build.gemv_scratch`). x (RMSNorm'd in the prologue when
  a gamma is given) is staged in shared memory per block.
- `w8a16_gemm` (m > MAX_DECODE_M, `csrc/w8a16_gemm.cu`). Bound by tensor-core
  FLOPs at prefill sizes: m = 1024 does 2*m FLOPs per weight byte, far above
  the ~295 FLOP/byte balance point of the card (datasheet bf16 peak over
  HBM bandwidth), about 13.8 TFLOP for a llama2-7b prompt. With per-channel
  scales it runs the Hopper tile of `csrc/wgmma_gemm.cuh`: 256 x 128 output
  tiles (128 x 128 where m <= 128), x and the packed weights copied by
  `cp.async` into rings of swizzled shared memory, each weight tile widened
  to bf16 once per block by two producer warpgroups, `wgmma` m64n128k16
  with f32 accumulators in two consumer warpgroups, the scale and bias on
  the accumulators. With group-wise scales the same pipeline keeps the open
  group's sum in a second register set and adds it times the group's scale
  row to the accumulators when the group closes, on a 256 x 64 tile.
- `w4a16_gemv` (`csrc/w4a16_gemv.cu`) and `w4a16_gemm`
  (`csrc/w4a16_gemm.cu`): the same two designs on int4 weights packed two
  neighbouring K rows to a byte (`layout/tiling.py`), half the bytes per
  decode step (about 3.2 GB of layer weights for llama2-7b). A byte's two
  nibbles are the two K-neighbours one MMA register holds; the TPU kernel's biased
  nibbles and its `-8 * rowsum(x)` correction (w8a16.py:186-209) work
  around an instruction set that has no int8 shift, and are not carried
  over.

All four take per-channel scales [N] or group-wise scales [K/g, N] (g a
multiple of `GROUP_GRANULE`). The GEMM applies each group's scale to that
group's f32 partial sum, as the TPU kernel does (w8a16.py:103-126); the
GEMV folds each K step's f32 partial times its group's scales (the same
sum in another order; see `csrc/gemv.cuh`).

The MoE kernels run the same designs over a stacked expert bank, int8
[E, Kp, Np] or int4 [E, Kp/2, Np], with per-channel scales [E, N] or
group-wise scales [E, K/g, N], each block reading its expert id from device
memory:

- `w8a16_expert_gemv` and `w4a16_expert_gemv` (`csrc/w8a16_expert_gemv.cu`,
  `csrc/w4a16_expert_gemv.cu`) replace `w8a16_expert_matmul_kernel_call`
  (`pallas_call` at w8a16.py:513): the GEMV with one grid layer per
  selection, out[s] = x @ dequant(bank[ids[s]]).
- `w8a16_grouped_gemm` and `w4a16_grouped_gemm`
  (`csrc/w8a16_grouped_gemm.cu`, `csrc/w4a16_grouped_gemm.cu`) replace
  `w8a16_grouped_matmul_kernel_call` (`pallas_call` at w8a16.py:611): one
  block per bm-row block and column strip, each times its own expert, in two
  designs of `csrc/wgmma_grouped.cuh` picked by bm: a 128-row `wgmma` tile
  for prompts (operation-bound) and, up to `GROUPED_SKINNY_BM` rows, a
  skinny tile computing outᵀ = Wᵀ xᵀ with the row block as `wgmma`'s N for
  the engine's decode step (bound by the weight bytes). Blocks at or past
  `real_blocks` (a device count) are padding and write zeros unread.

Each wrapper launches its kernel for CUDA tensors (or raises), and runs the
plain PyTorch version for CPU tensors. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.kernels.autotune import (
    GEMV_BLOCK_N,
    GROUPED_BM_MAX,
    GROUPED_BM_MIN,
    MAX_DECODE_M,
    gemv_scratch_size,
    gemv_splits,
    group_size_of,
    sm_count,
)
from eetq_tpu_torch.layout.tiling import TILE, unpack_int4_rows
from eetq_tpu_torch.ops.rmsnorm import rmsnorm


def w8a16_matmul_ref(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: ``x @ dequant(qweight) + bias`` in x.dtype.

    x [m, K]; qweight the logical int8 [K, N]; scales [N] per-channel or
    [G, N] group-wise. Products of the exact bf16 and int8 values summed in
    f32, the per-channel scale applied once to the sum (each group's scale to
    its partial sum), as `eetq_tpu/kernels/w8a16.py::w8a16_matmul_ref`.
    """
    xf = x.float()
    if scales.dim() == 1:
        r = (xf @ qweight.float()) * scales.float()
    else:
        kdim, n = qweight.shape
        gcount = scales.shape[0]
        xg = xf.reshape(xf.shape[0], gcount, kdim // gcount)
        wg = qweight.float().reshape(gcount, kdim // gcount, n)
        parts = torch.einsum("mgk,gkn->mgn", xg, wg)
        r = (parts * scales.float()).sum(dim=-2)
    if bias is not None:
        r = r + bias.float()
    return r.to(x.dtype)


def expert_matmul_ref(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    expert_ids: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the expert gather: [n_sel, m, N], selection s being
    ``x @ dequant(qweight[expert_ids[s]])`` (`eetq_tpu/ops/moe.py::
    expert_matmul_ref`). qweight the logical int8 bank [E, K, N]; scales
    [E, N] or [E, G, N]. Reads the ids on the host: a test oracle."""
    return torch.stack([w8a16_matmul_ref(x, qweight[e], scales[e])
                        for e in expert_ids.tolist()])


def grouped_matmul_ref(
    x: torch.Tensor,
    qweight: torch.Tensor,
    scales: torch.Tensor,
    block_expert: torch.Tensor,
    bm: int,
) -> torch.Tensor:
    """Plain version of the grouped GEMM: row block b of x [nb * bm, K] times
    dequant(qweight[block_expert[b]]) -> [nb * bm, N] (`eetq_tpu/ops/moe.py::
    grouped_matmul_ref`). Reads the ids on the host: a test oracle."""
    return torch.cat([w8a16_matmul_ref(x[b * bm:(b + 1) * bm], qweight[e], scales[e])
                      for b, e in enumerate(block_expert.tolist())])


def _check_cuda(x, qdata, scales, n, bias, bits: int = 8) -> tuple[int, int]:
    """x [m, K] against a packed weight [Kp, Np] (int4: [Kp/2, Np]) with
    scales [N] or [G, N], or a packed bank [E, Kp, Np] (int4: [E, Kp/2, Np])
    with scales [E, N] or [E, G, N]. Returns (G, group size), (0, 0) for
    per-channel scales."""
    m, k = x.shape
    rows, np_ = qdata.shape[-2:]
    kp = rows * 2 if bits == 4 else rows
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous bf16, got {x.dtype}")
    if qdata.dtype != torch.int8 or not qdata.is_contiguous() or qdata.device != x.device:
        raise TypeError("weight must be contiguous int8 on x's device")
    if x.data_ptr() % 16 or qdata.data_ptr() % 16:
        raise ValueError("x and the weight must be 16-byte aligned")
    if kp % TILE or np_ % TILE or not (k <= kp and n <= np_):
        raise ValueError(f"weight {tuple(qdata.shape)} is not a packed int{bits} weight "
                         f"for K={k}, N={n}")
    if k % 8:
        raise NotImplementedError("the CUDA kernels take K % 8 == 0 (16-byte x loads)")
    groups = group = 0
    want = (*qdata.shape[:-2], n)
    if scales.dim() == qdata.dim():
        group = group_size_of(k, scales)
        groups = k // group
        want = (*qdata.shape[:-2], groups, n)
    if (scales.dtype != torch.float32 or scales.shape != want or not scales.is_contiguous()
            or scales.device != x.device):
        raise TypeError(f"scales must be contiguous f32 {list(want)} on x's device")
    if bias is not None and (bias.shape != (n,) or bias.device != x.device):
        raise TypeError("bias must be [N] on x's device")
    return groups, group


def _check_ids(ids: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if (ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous()
            or ids.device != x.device):
        raise TypeError(f"{what} must be a contiguous int32 vector on x's device")
    if not 1 <= ids.shape[0] <= 65535:  # one grid row each
        raise ValueError(f"{what} holds {ids.shape[0]} ids, want 1..65535")


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.float().contiguous()


def _logical(qdata: torch.Tensor, bits: int, k: int, n: int) -> torch.Tensor:
    """The logical [K, N] values of a packed weight, or [E, K, N] of a bank
    (for the plain versions)."""
    return (unpack_int4_rows(qdata) if bits == 4 else qdata)[..., :k, :n]


def _gemv_plan(x, rows: int, strips: int, sels: int, bits: int, m: int, group: int):
    """(K splits, partials pointer, counters pointer) of one GEMV launch."""
    splits = gemv_splits(rows, strips, sels, bits, m, group, sm_count(x.device.index))
    return (splits, *_build.gemv_scratch(x.device, *gemv_scratch_size(splits, strips, sels)))


def _gemv(counter, entry: str, bits: int, x, qdata, scales, n, bias, gamma, eps):
    k = x.shape[-1]
    if not x.is_cuda:
        y = x if gamma is None else rmsnorm(x, gamma, eps)
        return w8a16_matmul_ref(y, _logical(qdata, bits, k, n), scales, bias)
    groups, group = _check_cuda(x, qdata, scales, n, bias, bits)
    m = x.shape[0]
    rows, np_ = qdata.shape
    if not 1 <= m <= MAX_DECODE_M:
        raise ValueError(f"the GEMV kernel takes 1..{MAX_DECODE_M} rows, got {m}")
    if gamma is not None and (gamma.shape != (k,) or gamma.device != x.device):
        raise TypeError("gamma must be [K] on x's device")
    bias, gamma = _f32(bias), _f32(gamma)
    if gamma is not None and gamma.data_ptr() % 16:  # copied 16 bytes at a time
        gamma = gamma.clone()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    splits, partials, counters = _gemv_plan(x, rows, np_ // GEMV_BLOCK_N, 1, bits, m, group)
    _build.launch(
        entry, x.data_ptr(), m, k, qdata.data_ptr(), rows, np_, scales.data_ptr(), groups,
        group, _build.ptr(bias), _build.ptr(gamma), eps, out.data_ptr(), n, partials, counters,
        splits, _build.stream_of(x),
    )
    counter.launches += 1
    return out


def _gemm(counter, entry: str, bits: int, x, qdata, scales, n, bias):
    k = x.shape[-1]
    if not x.is_cuda:
        return w8a16_matmul_ref(x, _logical(qdata, bits, k, n), scales, bias)
    groups, group = _check_cuda(x, qdata, scales, n, bias, bits)
    m = x.shape[0]
    rows, np_ = qdata.shape
    bias = _f32(bias)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _build.launch(
        entry, x.data_ptr(), m, k, qdata.data_ptr(), rows * 2 if bits == 4 else rows, np_,
        scales.data_ptr(), groups, group, _build.ptr(bias), out.data_ptr(), n,
        _build.stream_of(x),
    )
    counter.launches += 1
    return out


def w8a16_gemv(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    n: int,
    bias: torch.Tensor | None = None,
    gamma: torch.Tensor | None = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Decode regime: ``rmsnorm(x) @ dequant(W) + bias`` for m <= 8 rows.

    x [m, K] bf16; qdata the packed int8 [Kp, Np]; scales f32 [N] or
    [K/g, N]; bias [N]; gamma [K] fuses ``rmsnorm(x, gamma, eps)`` into the
    prologue (y in f32, rounded to bf16 before the dot, as
    `w8a16.py:180-184`). Returns [m, N] bf16.
    """
    return _gemv(w8a16_gemv, "eetq_w8a16_gemv", 8, x, qdata, scales, n, bias, gamma, eps)


def w4a16_gemv(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    n: int,
    bias: torch.Tensor | None = None,
    gamma: torch.Tensor | None = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """:func:`w8a16_gemv` on int4 weights: qdata the packed int4 pairs
    [Kp/2, Np]."""
    return _gemv(w4a16_gemv, "eetq_w4a16_gemv", 4, x, qdata, scales, n, bias, gamma, eps)


def w8a16_gemm(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    n: int,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Prefill regime: ``x @ dequant(W) + bias``. x [m, K] bf16; qdata the
    packed int8 [Kp, Np]; scales f32 [N] or [K/g, N]. Returns [m, N] bf16."""
    return _gemm(w8a16_gemm, "eetq_w8a16_gemm", 8, x, qdata, scales, n, bias)


def w4a16_gemm(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    n: int,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`w8a16_gemm` on int4 weights: qdata the packed int4 pairs
    [Kp/2, Np]."""
    return _gemm(w4a16_gemm, "eetq_w4a16_gemm", 4, x, qdata, scales, n, bias)


def _expert_gemv(counter, entry: str, bits: int, x, qdata, scales, expert_ids, n):
    k = x.shape[-1]
    if not x.is_cuda:
        return expert_matmul_ref(x, _logical(qdata, bits, k, n), scales, expert_ids)
    if qdata.dim() != 3:
        raise ValueError(f"expert bank must be 3-D, got {tuple(qdata.shape)}")
    groups, group = _check_cuda(x, qdata, scales, n, None, bits)
    _check_ids(expert_ids, x, "expert_ids")
    m = x.shape[0]
    _, rows, np_ = qdata.shape
    if not 1 <= m <= MAX_DECODE_M:
        raise ValueError(f"the expert GEMV takes 1..{MAX_DECODE_M} rows, got {m}")
    n_sel = expert_ids.shape[0]
    out = torch.empty((n_sel, m, n), dtype=torch.bfloat16, device=x.device)
    splits, partials, counters = _gemv_plan(x, rows, np_ // GEMV_BLOCK_N, n_sel, bits, m, group)
    _build.launch(
        entry, x.data_ptr(), m, k, qdata.data_ptr(), rows, np_, scales.data_ptr(), groups,
        group, expert_ids.data_ptr(), n_sel, out.data_ptr(), n, partials, counters, splits,
        _build.stream_of(x),
    )
    counter.launches += 1
    return out


def _grouped_gemm(counter, entry: str, bits: int, x, qdata, scales, block_expert, n,
                  real_blocks):
    k = x.shape[-1]
    nb = block_expert.shape[0]
    if x.shape[0] % nb:
        raise ValueError(f"rows {x.shape[0]} must divide into {nb} blocks")
    bm = x.shape[0] // nb
    if not x.is_cuda:
        out = grouped_matmul_ref(x, _logical(qdata, bits, k, n), scales, block_expert, bm)
        if real_blocks is None:
            return out
        padding = torch.arange(nb * bm, device=x.device) // bm >= real_blocks.reshape(())
        return out.masked_fill(padding[:, None], 0)
    if qdata.dim() != 3:
        raise ValueError(f"expert bank must be 3-D, got {tuple(qdata.shape)}")
    groups, group = _check_cuda(x, qdata, scales, n, None, bits)
    _check_ids(block_expert, x, "block_expert")
    if real_blocks is not None and (real_blocks.dtype != torch.int32 or real_blocks.shape != (1,)
                                    or real_blocks.device != x.device):
        raise TypeError("real_blocks must be an int32 [1] on x's device")
    if bm % 8 or not GROUPED_BM_MIN <= bm <= GROUPED_BM_MAX:
        raise ValueError(f"row blocks of {bm} rows: the grouped GEMM takes "
                         f"{GROUPED_BM_MIN}..{GROUPED_BM_MAX}, a multiple of 8")
    _, rows, np_ = qdata.shape
    out = torch.empty((nb * bm, n), dtype=torch.bfloat16, device=x.device)
    _build.launch(
        entry, x.data_ptr(), bm, nb, k, qdata.data_ptr(), rows * 2 if bits == 4 else rows, np_,
        scales.data_ptr(), groups, group, block_expert.data_ptr(), out.data_ptr(), n,
        _build.ptr(real_blocks), _build.stream_of(x),
    )
    counter.launches += 1
    return out


def w8a16_expert_gemv(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    expert_ids: torch.Tensor,
    n: int,
) -> torch.Tensor:
    """Expert gather for m <= 8 rows: out[s] = x @ dequant(bank[ids[s]]).

    x [m, K] bf16; qdata the packed int8 bank [E, Kp, Np]; scales f32
    [E, N] or [E, K/g, N]; expert_ids int32 [n_sel] on x's device, each in
    [0, E) (the kernel reads them there and cannot check them). Returns
    [n_sel, m, N] bf16.
    """
    return _expert_gemv(w8a16_expert_gemv, "eetq_w8a16_expert_gemv", 8, x, qdata, scales,
                        expert_ids, n)


def w4a16_expert_gemv(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    expert_ids: torch.Tensor,
    n: int,
) -> torch.Tensor:
    """:func:`w8a16_expert_gemv` on an int4 bank: qdata the packed int4 pairs
    [E, Kp/2, Np]."""
    return _expert_gemv(w4a16_expert_gemv, "eetq_w4a16_expert_gemv", 4, x, qdata, scales,
                        expert_ids, n)


def w8a16_grouped_gemm(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    block_expert: torch.Tensor,
    n: int,
    real_blocks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Token-grouped GEMM: row block b of x [nb * bm, K] (bm = rows / nb, a
    multiple of 8 up to 128) times dequant(bank[block_expert[b]]).

    qdata the packed int8 bank [E, Kp, Np]; scales f32 [E, N] or
    [E, K/g, N]; block_expert int32 [nb] on x's device, each in [0, E),
    padding blocks included; real_blocks int32 [1] on x's device: the rows
    of blocks at or past it come out zero, as zero rows of x give (the
    kernel skips those blocks). Returns [nb * bm, N] bf16.
    """
    return _grouped_gemm(w8a16_grouped_gemm, "eetq_w8a16_grouped_gemm", 8, x, qdata, scales,
                         block_expert, n, real_blocks)


def w4a16_grouped_gemm(
    x: torch.Tensor,
    qdata: torch.Tensor,
    scales: torch.Tensor,
    block_expert: torch.Tensor,
    n: int,
    real_blocks: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`w8a16_grouped_gemm` on an int4 bank: qdata the packed int4
    pairs [E, Kp/2, Np]."""
    return _grouped_gemm(w4a16_grouped_gemm, "eetq_w4a16_grouped_gemm", 4, x, qdata, scales,
                         block_expert, n, real_blocks)


w8a16_gemv.launches = 0
w8a16_gemm.launches = 0
w4a16_gemv.launches = 0
w4a16_gemm.launches = 0
w8a16_expert_gemv.launches = 0
w8a16_grouped_gemm.launches = 0
w4a16_expert_gemv.launches = 0
w4a16_grouped_gemm.launches = 0
