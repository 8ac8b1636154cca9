"""Quantized and dense linear layers as `nn.Module`s.

Port of `eetq_tpu/modules/linear.py`. Weights are stored [K, N]
(in-features x out-features) as in the JAX package; int8 weights, scales
and biases are buffers (the port serves and trains nothing). `a8=True`
routes an int8 per-channel layer through the W8A8 path (prefill only).
LoRA is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from eetq_tpu_torch.layout.tiling import PackedWeight, pack_weights
from eetq_tpu_torch.ops.linear import w8a16_matmul
from eetq_tpu_torch.ops.linear8 import w8a8_matmul
from eetq_tpu_torch.ops.rmsnorm import rmsnorm
from eetq_tpu_torch.quant.quantizer import symmetric_quantize


class DenseLinear(nn.Module):
    """Unquantized linear (bf16), weight [K, N]."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    @property
    def in_features(self) -> int:
        return self.weight.shape[0]

    @property
    def out_features(self) -> int:
        return self.weight.shape[1]

    def forward(self, x, prenorm=None, use_kernel: bool = True, a8: bool = False):
        return linear_apply(self, x, prenorm=prenorm, use_kernel=use_kernel, a8=a8)


class QuantLinear(nn.Module):
    """W8A16 linear: packed int8 qweight [Kp, Np], f32 per-channel scales [N]
    and an optional bias [N]."""

    def __init__(self, qweight: PackedWeight, scales: torch.Tensor,
                 bias: torch.Tensor | None = None):
        super().__init__()
        self.k, self.n = qweight.k, qweight.n
        self.register_buffer("qweight", qweight.data)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def packed(self) -> PackedWeight:
        return PackedWeight(data=self.qweight, k=self.k, n=self.n)

    @property
    def in_features(self) -> int:
        return self.k

    @property
    def out_features(self) -> int:
        return self.n

    def forward(self, x, prenorm=None, use_kernel: bool = True, a8: bool = False):
        return linear_apply(self, x, prenorm=prenorm, use_kernel=use_kernel, a8=a8)


def quantize_linear(weight: torch.Tensor, bias: torch.Tensor | None = None) -> QuantLinear:
    """QuantLinear from a float [K, N] weight: per-channel symmetric int8."""
    q, s = symmetric_quantize(weight)
    return QuantLinear(pack_weights(q), s, bias)


def linear_apply(
    layer: QuantLinear | DenseLinear,
    x: torch.Tensor,
    prenorm: tuple[torch.Tensor, float] | None = None,
    use_kernel: bool = True,
    a8: bool = False,
) -> torch.Tensor:
    """Forward through a quantized or dense linear. prenorm=(gamma, eps)
    applies ``rmsnorm(x, gamma, eps)`` first, fused into the GEMV kernel's
    prologue in the decode regime. a8=True takes the W8A8 path (per-token
    int8 activations, `eetq_tpu/modules/linear.py:161-175`) for an int8
    per-channel QuantLinear, after a plain RMSNorm; it is ignored for other
    layers."""
    if isinstance(layer, QuantLinear) and a8 and layer.scales.dim() == 1:
        if prenorm is not None:
            x = rmsnorm(x, prenorm[0], eps=prenorm[1])
        return w8a8_matmul(x, layer.packed, layer.scales, bias=layer.bias,
                           use_kernel=use_kernel)
    if isinstance(layer, QuantLinear):
        return w8a16_matmul(
            x, layer.packed, layer.scales, bias=layer.bias,
            prenorm_gamma=None if prenorm is None else prenorm[0],
            prenorm_eps=1e-6 if prenorm is None else prenorm[1],
            use_kernel=use_kernel,
        )
    if prenorm is not None:
        x = rmsnorm(x, prenorm[0], eps=prenorm[1])
    out = x @ layer.weight.to(x.dtype)
    if layer.bias is not None:
        out = out + layer.bias.to(out.dtype)
    return out
