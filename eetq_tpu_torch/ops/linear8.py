"""`w8a8_matmul`: the int8-activation matmul entry of the port.

Port of `eetq_tpu/ops/linear8.py::w8a8_matmul` (`linear8.py:26-108`):
flatten the leading dims to m x K, quantize per token, zero-pad the
quantized activations to the packed Kp, run the W8A8 kernel (int8
per-channel weights) or the W4A8 kernel (int4 weights, per-channel or
group-wise scales), and keep the logical N columns; an activation fuses
into the kernels' epilogue. int8 group-wise stays on the W8A16 path, as in
the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from eetq_tpu_torch.kernels.w8a16 import check_epilogue
from eetq_tpu_torch.kernels.w8a8 import (
    quantize_activations,
    w4a8_gemm,
    w8a8_gemm,
    w8a8_matmul_ref,
)
from eetq_tpu_torch.layout.tiling import PackedWeight, unpack_weights


def w8a8_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    bias: torch.Tensor | None = None,
    activation: str | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """``act((int8(x) @ W) * row_scale * col_scale + bias)`` in x.dtype
    (`eetq_tpu/ops/linear8.py:26-108`).

    x: [..., K] float; qweight: PackedWeight, int8 with scales [N], or int4
    with scales [N] or [K/g, N]; activation: None, "relu", "gelu" (tanh) or
    "silu", fused in the epilogue. use_kernel=False runs the plain version
    on any device.
    """
    check_epilogue(activation, "add")
    if qweight.bits == 8 and scales.dim() != 1:
        raise ValueError(
            "a8 with int8 weights needs per-channel scales "
            "(group-wise int8 stays on the W8A16 path)"
        )
    k, n = qweight.k, qweight.n
    *lead, xk = x.shape
    if xk != k:
        raise ValueError(f"x feature dim {xk} != weight K {k}")
    if scales.dim() == 2 and k % scales.shape[0]:
        raise ValueError(f"scale rows {scales.shape[0]} must divide K {k}")
    m = math.prod(lead)
    x2 = x.reshape(m, k)
    if not use_kernel:
        out = w8a8_matmul_ref(x2, unpack_weights(qweight), scales, bias, activation)
    else:
        xq, sx = quantize_activations(x2)
        xq = F.pad(xq, (0, qweight.kp - k)).contiguous()
        if qweight.bits == 4:
            group_size = None if scales.dim() == 1 else k // scales.shape[0]
            out = w4a8_gemm(xq, sx, qweight.data, scales, n, bias, group_size,
                            activation=activation)
        else:
            out = w8a8_gemm(xq, sx, qweight.data, scales, n, bias, activation=activation)
        out = out.to(x.dtype)
    return out.reshape(*lead, n)
