"""Quantized and dense linear layers as `nn.Module`s.

Port of `eetq_tpu/modules/linear.py`. Weights are stored [K, N]
(in-features x out-features) as in the JAX package; packed int8 or int4
weights, per-channel or group-wise scales and biases are buffers (the port
serves and trains nothing). `a8=True` routes an int8 per-channel layer, or
any int4 layer, through the W8A8 / W4A8 path (prefill only). LoRA is not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from eetq_tpu_torch.layout.tiling import PackedWeight, pack_weights
from eetq_tpu_torch.ops.linear import w8a16_matmul
from eetq_tpu_torch.ops.linear8 import w8a8_matmul
from eetq_tpu_torch.ops.rmsnorm import rmsnorm
from eetq_tpu_torch.quant.quantizer import symmetric_quantize
from eetq_tpu_torch.utils.device import resolve


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
    """W8A16 or W4A16 linear: packed qweight (int8 [Kp, Np], or int4 pairs
    [Kp/2, Np] with `bits` = 4), f32 scales [N] per-channel or [K/g, N]
    group-wise, and an optional bias [N]. An expert bank has a leading
    expert axis on qweight and scales."""

    def __init__(self, qweight: PackedWeight, scales: torch.Tensor,
                 bias: torch.Tensor | None = None):
        super().__init__()
        self.k, self.n, self.bits = qweight.k, qweight.n, qweight.bits
        self.register_buffer("qweight", qweight.data)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @property
    def packed(self) -> PackedWeight:
        return PackedWeight(data=self.qweight, k=self.k, n=self.n, bits=self.bits)

    @property
    def in_features(self) -> int:
        return self.k

    @property
    def out_features(self) -> int:
        return self.n

    def forward(self, x, prenorm=None, use_kernel: bool = True, a8: bool = False):
        return linear_apply(self, x, prenorm=prenorm, use_kernel=use_kernel, a8=a8)


def quantize_linear(
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    bits: int = 8,
    group_size: int | None = None,
    external_scales: torch.Tensor | None = None,
) -> QuantLinear:
    """QuantLinear from a float [K, N] weight (`eetq_tpu/modules/linear.py:
    77-105`): symmetric int8 (bits=8) or int4 (bits=4), per-channel scales or,
    with group_size=g, group-wise scales [K/g, N]. An int8 `weight` is taken
    as already quantized (int4 values one per int8) and packed with
    `external_scales` without requantization."""
    if weight.dtype == torch.int8:
        if external_scales is None:
            raise ValueError("int8 weight requires external_scales")
        return QuantLinear(pack_weights(weight, bits=bits), external_scales, bias)
    if external_scales is not None:
        raise ValueError("external_scales only valid with int8 weight")
    q, s = symmetric_quantize(weight, bits=bits, group_size=group_size)
    return QuantLinear(pack_weights(q, bits=bits), s, bias)


def init_only_linear(k: int, n: int, with_bias: bool = False,
                     device: torch.device | str | None = None) -> QuantLinear:
    """Empty int8 shell for checkpoint loading (`eetq_tpu/modules/linear.py:
    108-116`), on the card unless `device` says otherwise."""
    device = resolve(device)
    q = torch.zeros((k, n), dtype=torch.int8, device=device)
    bias = torch.zeros(n, dtype=torch.bfloat16, device=device) if with_bias else None
    return QuantLinear(pack_weights(q), torch.zeros(n, dtype=torch.float32, device=device), bias)


def linear_apply(
    layer: QuantLinear | DenseLinear,
    x: torch.Tensor,
    prenorm: tuple[torch.Tensor, float] | None = None,
    use_kernel: bool = True,
    a8: bool = False,
) -> torch.Tensor:
    """Forward through a quantized or dense linear. prenorm=(gamma, eps)
    applies ``rmsnorm(x, gamma, eps)`` first, fused into the GEMV kernel's
    prologue in the decode regime. a8=True takes the W8A8 / W4A8 path
    (per-token int8 activations, `eetq_tpu/modules/linear.py:161-175`) for an
    int8 per-channel QuantLinear or any int4 one, after a plain RMSNorm; it
    is ignored for other layers."""
    if isinstance(layer, QuantLinear) and a8 and (layer.bits == 4 or layer.scales.dim() == 1):
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
