"""Quantized matmuls against a stacked expert bank: the gather (decode) and
the token-grouped GEMM (prefill).

Port of `eetq_tpu/ops/moe.py` for int8 per-channel banks. The bank is a
3-D PackedWeight (data [E, Kp, Np]); the kernels take x unpadded (K % 8 ==
0) and write only the logical N columns, so nothing is padded here. The
expert ids stay on the device. int4 banks and group-wise scales [E, G, N]
run on the plain path only (CPU tensors, or `moe_apply(use_kernel=False)`):
on a CUDA tensor these wrappers raise NotImplementedError, since the two
MoE kernels take int8 per-channel banks; their int4 and group-wise modes
are to come with the paged-KV slice.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels.w8a16 import (
    expert_matmul_ref,
    grouped_matmul_ref,
    w8a16_expert_gemv,
    w8a16_grouped_gemm,
)
from eetq_tpu_torch.layout.tiling import PackedWeight, unpack_weights


def _check_bank(x: torch.Tensor, qweight: PackedWeight, scales: torch.Tensor) -> None:
    if qweight.data.dim() != 3:
        raise ValueError(f"expert bank must be 3-D, got {tuple(qweight.data.shape)}")
    if x.dim() != 2 or x.shape[1] != qweight.k:
        raise ValueError(f"x {tuple(x.shape)} is not [m, K] for the bank's K {qweight.k}")
    if scales.dim() == 3:
        if qweight.k % scales.shape[1]:
            raise ValueError(f"scale rows {scales.shape[1]} must divide K {qweight.k}")
    elif scales.dim() != 2:
        raise ValueError(f"scales must be [E, N] or [E, G, N], got {tuple(scales.shape)}")
    if qweight.bits != 8 and x.is_cuda:
        raise NotImplementedError(
            "int4 expert banks have no CUDA kernel yet (the MoE kernels take int8 "
            "per-channel banks; int4 and group-wise banks come with the paged-KV slice)")


def w8a16_expert_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    expert_ids: torch.Tensor,
) -> torch.Tensor:
    """out[s] = x @ dequant(qweight[expert_ids[s]], scales[expert_ids[s]]).

    x [m, K] (every selection sees all m rows; at decode m is the token
    batch and the caller picks its own row out of each selection); qweight
    a 3-D PackedWeight; scales [E, N] (or [E, G, N] on the plain path);
    expert_ids [n_sel] int32 (ids may repeat). The kernel takes m <= 8.
    Returns [n_sel, m, N] in x.dtype.
    """
    _check_bank(x, qweight, scales)
    if qweight.bits != 8:  # CPU only: the plain version on the logical values
        return expert_matmul_ref(x, unpack_weights(qweight), scales, expert_ids)
    return w8a16_expert_gemv(x.contiguous(), qweight.data, scales, expert_ids, qweight.n)


def w8a16_grouped_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    block_expert: torch.Tensor,
) -> torch.Tensor:
    """Token-grouped expert GEMM over a stacked bank (routed MoE prefill).

    x [M, K] with M = nb * bm, rows pre-sorted so every bm-row block
    belongs to one expert (padding blocks hold zero rows, dropped by the
    caller); block_expert [nb] int32, a valid id for every block. Returns
    [M, N] in x.dtype.
    """
    _check_bank(x, qweight, scales)
    if qweight.bits != 8:  # CPU only: the plain version on the logical values
        nb = block_expert.shape[0]
        return grouped_matmul_ref(x, unpack_weights(qweight), scales, block_expert,
                                  x.shape[0] // nb)
    return w8a16_grouped_gemm(x.contiguous(), qweight.data, scales, block_expert, qweight.n)
