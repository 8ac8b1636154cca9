"""Quantized matmuls against a stacked expert bank: the gather (decode) and
the token-grouped GEMM (prefill).

Port of `eetq_tpu/ops/moe.py`. The bank is a 3-D PackedWeight (data
[E, Kp, Np], or int4 pairs [E, Kp/2, Np]) with per-channel scales [E, N] or
group-wise scales [E, K/g, N]; the kernels take x unpadded (K % 8 == 0) and
write only the logical N columns, so nothing is padded here. The expert ids
stay on the device.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels.w8a16 import (
    w4a16_expert_gemv,
    w4a16_grouped_gemm,
    w8a16_expert_gemv,
    w8a16_grouped_gemm,
)
from eetq_tpu_torch.layout.tiling import PackedWeight


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


def w8a16_expert_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    expert_ids: torch.Tensor,
) -> torch.Tensor:
    """out[s] = x @ dequant(qweight[expert_ids[s]], scales[expert_ids[s]]).

    x [m, K] (every selection sees all m rows; at decode m is the token
    batch and the caller picks its own row out of each selection); qweight
    a 3-D PackedWeight, int8 or int4; scales [E, N] or [E, G, N];
    expert_ids [n_sel] int32 (ids may repeat). The kernel takes m <= 8.
    Returns [n_sel, m, N] in x.dtype.
    """
    _check_bank(x, qweight, scales)
    kernel = w4a16_expert_gemv if qweight.bits == 4 else w8a16_expert_gemv
    return kernel(x.contiguous(), qweight.data, scales, expert_ids, qweight.n)


def w8a16_grouped_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    block_expert: torch.Tensor,
    real_blocks: torch.Tensor | None = None,
) -> torch.Tensor:
    """Token-grouped expert GEMM over a stacked bank (routed MoE prefill).

    x [M, K] with M = nb * bm, rows pre-sorted so every bm-row block
    belongs to one expert (padding blocks hold zero rows, dropped by the
    caller); block_expert [nb] int32, a valid id for every block;
    real_blocks int32 [1] on the device, the number of blocks before the
    padding (the kernel skips the rest), or None. Returns [M, N] in x.dtype.
    """
    _check_bank(x, qweight, scales)
    kernel = w4a16_grouped_gemm if qweight.bits == 4 else w8a16_grouped_gemm
    return kernel(x.contiguous(), qweight.data, scales, block_expert, qweight.n, real_blocks)
