"""Quantized matmuls against a stacked expert bank: the gather (decode) and
the token-grouped GEMM (prefill).

Port of `eetq_tpu/ops/moe.py` for int8 per-channel banks. The bank is a
3-D PackedWeight (data [E, Kp, Np]); the kernels take x unpadded (K % 8 ==
0) and write only the logical N columns, so nothing is padded here. The
expert ids stay on the device. int4 banks have no packed layout in the port
yet; group-wise scales [E, G, N] run on the plain path only (the CUDA
wrappers raise for them).
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels.w8a16 import w8a16_expert_gemv, w8a16_grouped_gemm
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
    a 3-D PackedWeight; scales [E, N] (or [E, G, N] on the plain path);
    expert_ids [n_sel] int32 (ids may repeat). The kernel takes m <= 8.
    Returns [n_sel, m, N] in x.dtype.
    """
    _check_bank(x, qweight, scales)
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
    return w8a16_grouped_gemm(x.contiguous(), qweight.data, scales, block_expert, qweight.n)
