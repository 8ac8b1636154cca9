"""`w8a8_matmul`: the int8-activation matmul entry of the port.

Port of `eetq_tpu/ops/linear8.py::w8a8_matmul` (`linear8.py:26-108`) for
int8 per-channel weights: flatten the leading dims to m x K, quantize per
token, zero-pad the quantized activations to the packed Kp, run the W8A8
kernel, and keep the logical N columns. W4A8 is not ported: an int4 weight
has no packed layout in the port yet, so it cannot reach this function.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from eetq_tpu_torch.kernels.w8a8 import quantize_activations, w8a8_gemm, w8a8_matmul_ref
from eetq_tpu_torch.layout.tiling import PackedWeight, unpack_weights


def w8a8_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    bias: torch.Tensor | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """``(int8(x) @ W) * row_scale * col_scale + bias`` in x.dtype.

    x: [..., K] float; qweight: PackedWeight (int8); scales: [N]
    per-channel. use_kernel=False runs the plain version on any device.
    """
    if scales.dim() != 1:
        raise ValueError(
            "a8 with int8 weights needs per-channel scales "
            "(group-wise int8 stays on the W8A16 path)"
        )
    k, n = qweight.k, qweight.n
    *lead, xk = x.shape
    if xk != k:
        raise ValueError(f"x feature dim {xk} != weight K {k}")
    m = math.prod(lead)
    x2 = x.reshape(m, k)
    if not use_kernel:
        out = w8a8_matmul_ref(x2, unpack_weights(qweight), scales, bias)
    else:
        xq, sx = quantize_activations(x2)
        xq = F.pad(xq, (0, qweight.kp - k)).contiguous()
        out = w8a8_gemm(xq, sx, qweight.data, scales, n, bias).to(x.dtype)
    return out.reshape(*lead, n)
