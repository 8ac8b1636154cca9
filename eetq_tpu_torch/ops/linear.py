"""`w8a16_matmul`: the quantized matmul entry of the port.

Port of `eetq_tpu/ops/linear.py::w8a16_matmul` (`ops/linear.py:150-243`):
flatten the leading dims to m x K, then m <= MAX_DECODE_M goes to the
GEMV kernel (with the RMSNorm prologue fused) and larger m to the GEMM
kernel (after a plain RMSNorm), the int8 or the int4 one by the weight's
`bits`, with per-channel or group-wise scales, and the fused epilogue
(activation, then a residual added or multiplied; a prenorm still fuses
into the GEMV's prologue beside it). The JAX package fuses the
norm for int8 per-channel only (`ops/linear.py:223-228`); the port's GEMV
fuses it for every variant, which computes the same function. The
dequantizing backward is not ported.
"""

from __future__ import annotations

import math

import torch

from eetq_tpu_torch.kernels.autotune import MAX_DECODE_M
from eetq_tpu_torch.kernels.w8a16 import (
    w4a16_gemm,
    w4a16_gemv,
    w8a16_gemm,
    w8a16_gemv,
    check_epilogue,
    w8a16_matmul_ref,
)
from eetq_tpu_torch.layout.tiling import PackedWeight, unpack_weights
from eetq_tpu_torch.ops.rmsnorm import rmsnorm


def w8a16_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    bias: torch.Tensor | None = None,
    activation: str | None = None,
    residual: torch.Tensor | None = None,
    residual_mode: str = "add",
    prenorm_gamma: torch.Tensor | None = None,
    prenorm_eps: float = 1e-6,
    use_kernel: bool = True,
) -> torch.Tensor:
    """``act(rmsnorm(x) @ dequant(qweight, scales) + bias) [+|*] residual``
    in x.dtype (`eetq_tpu/ops/linear.py:150-175`).

    x: [..., K]; qweight: PackedWeight (int8 or int4); scales: [N]
    per-channel or [K/g, N] group-wise; bias: optional [N]; activation:
    None, "relu", "gelu" (tanh) or "silu", fused in the epilogue; residual:
    optional [..., N], added (residual_mode "add") or multiplied ("mul")
    after the activation; prenorm_gamma: optional [K] RMSNorm gain applied
    to x first. use_kernel=False runs the plain version on any device (the
    reference the kernels are checked against).
    """
    check_epilogue(activation, residual_mode)
    k, n = qweight.k, qweight.n
    *lead, xk = x.shape
    if xk != k:
        raise ValueError(f"x feature dim {xk} != weight K {k}")
    if scales.dim() == 2 and k % scales.shape[0]:
        raise ValueError(f"scale rows {scales.shape[0]} must divide K {k}")
    gemv, gemm = (w4a16_gemv, w4a16_gemm) if qweight.bits == 4 else (w8a16_gemv, w8a16_gemm)
    m = math.prod(lead)
    x2 = x.reshape(m, k).contiguous()
    res2 = None if residual is None else residual.reshape(m, n).contiguous()
    epi = dict(activation=activation, residual=res2, residual_mode=residual_mode)
    if use_kernel and m <= MAX_DECODE_M:
        out = gemv(x2, qweight.data, scales, n, bias, prenorm_gamma, prenorm_eps, **epi)
    else:
        if prenorm_gamma is not None:
            x2 = rmsnorm(x2, prenorm_gamma, eps=prenorm_eps)
        if use_kernel:
            out = gemm(x2, qweight.data, scales, n, bias, **epi)
        else:
            out = w8a16_matmul_ref(x2, unpack_weights(qweight), scales, bias, **epi)
    return out.reshape(*lead, n)
