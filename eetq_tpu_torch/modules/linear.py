"""Quantized and dense linear layers as `nn.Module`s.

Port of `eetq_tpu/modules/linear.py`. Weights are stored [K, N]
(in-features x out-features) as in the JAX package; packed int8 or int4
weights, per-channel or group-wise scales and biases are buffers. `a8=True`
routes an int8 per-channel layer, or any int4 layer, through the W8A8 /
W4A8 path (prefill only; it has no backward and raises under grad). An
activation and a residual fuse into the kernels' epilogue. `LoraAdapter` is
the low-rank side path x A B * scaling beside the frozen base, one adapter
or a bank of them selected per batch row (multi-adapter serving); its two
products are plain batched matmuls, as the JAX package computes them
outside any kernel (`modules/linear.py:198-212`). LoRA finetuning sets
`requires_grad_()` on an adapter's `lora_a` and `lora_b` and differentiates
the model's forward: the quantized base passes the gradient on through
`ops/linear.py::DequantMatmul`.
"""

from __future__ import annotations

import torch
from torch import nn

from eetq_tpu_torch.kernels.mlp_fused import ACTIVATIONS
from eetq_tpu_torch.layout.tiling import PackedWeight, pack_weights
from eetq_tpu_torch.ops.linear import w8a16_matmul
from eetq_tpu_torch.ops.linear8 import w8a8_matmul
from eetq_tpu_torch.ops.rmsnorm import rmsnorm
from eetq_tpu_torch.quant.quantizer import symmetric_quantize
from eetq_tpu_torch.utils.device import resolve


class LoraAdapter(nn.Module):
    """Low-rank side path ``x @ lora_a @ lora_b * scaling`` (the JAX
    package's `LoraAdapter`, `modules/linear.py:62-74`): lora_a [K, r] and
    lora_b [r, N], or banks [n, K, r] and [n, r, N] of n adapters, as
    buffers; scaling a Python float."""

    def __init__(self, lora_a: torch.Tensor, lora_b: torch.Tensor, scaling: float = 1.0):
        super().__init__()
        self.register_buffer("lora_a", lora_a)
        self.register_buffer("lora_b", lora_b)
        self.scaling = float(scaling)

    @property
    def banked(self) -> bool:
        return self.lora_a.dim() == 3


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

    def forward(self, x, **kw):
        """`linear_apply(self, x, **kw)`."""
        return linear_apply(self, x, **kw)


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

    def forward(self, x, **kw):
        """`linear_apply(self, x, **kw)`."""
        return linear_apply(self, x, **kw)


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
    activation: str | None = None,
    lora: LoraAdapter | None = None,
    residual: torch.Tensor | None = None,
    a8: bool = False,
    prenorm: tuple[torch.Tensor, float] | None = None,
    lora_idx: torch.Tensor | None = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Forward through a quantized or dense linear
    (`eetq_tpu/modules/linear.py:119-213`): ``act(x W + bias) + residual``,
    plus the LoRA side path.

    activation (None, "relu", "gelu", "silu") and residual [..., N] (added)
    fuse into the kernels' epilogue. prenorm=(gamma, eps) applies
    ``rmsnorm(x, gamma, eps)`` first, fused into the GEMV kernel's prologue
    in the decode regime. a8=True takes the W8A8 / W4A8 path (per-token int8
    activations) for an int8 per-channel QuantLinear or any int4 one, after a
    plain RMSNorm, where there is no residual; it is ignored otherwise.
    lora adds ``x @ A @ B * scaling``; a bank (A [n, K, r], B [n, r, N])
    takes lora_idx [B], each batch row's adapter, gathered on the device,
    and x [B, S, K]. LoRA takes neither a residual, a prenorm nor an
    activation (the JAX package's four ValueErrors). use_kernel=False runs
    every op's plain version."""
    if lora is not None and residual is not None:
        raise ValueError("fused residual with LoRA is not supported")
    if prenorm is not None and lora is not None:
        raise ValueError("prenorm with LoRA is not supported")
    if lora is not None and activation is not None:
        raise ValueError("LoRA with fused activation is not supported")
    if lora is not None and lora.banked and lora_idx is None:
        raise ValueError("banked LoRA requires lora_idx [B]")

    def norm(x):
        return x if prenorm is None else rmsnorm(x, prenorm[0], eps=prenorm[1])

    if isinstance(layer, QuantLinear):
        if a8 and residual is None and (layer.bits == 4 or layer.scales.dim() == 1):
            out = w8a8_matmul(norm(x), layer.packed, layer.scales, bias=layer.bias,
                              activation=activation, use_kernel=use_kernel)
        else:
            out = w8a16_matmul(
                x, layer.packed, layer.scales, bias=layer.bias, activation=activation,
                residual=residual,
                prenorm_gamma=None if prenorm is None else prenorm[0],
                prenorm_eps=1e-6 if prenorm is None else prenorm[1],
                use_kernel=use_kernel,
            )
    else:
        x = norm(x)
        out = x @ layer.weight.to(x.dtype)  # bf16 out, as the JAX package's dot
        if layer.bias is not None:
            out = out + layer.bias.to(out.dtype)
        if activation is not None:
            out = ACTIVATIONS[activation](out.float())
        if residual is not None:
            out = out + residual.to(out.dtype)
        out = out.to(x.dtype)
    if lora is not None:
        out = out + lora_side(lora, x, lora_idx) * lora.scaling
    return out


def lora_side(lora: LoraAdapter, x: torch.Tensor, lora_idx: torch.Tensor | None = None):
    """``x @ A @ B`` in x.dtype, each product rounded: one adapter, or for a
    bank each row b of x [B, S, K] through adapter lora_idx[b] (the banks
    gathered on the device, then two batched products)."""
    if not lora.banked:
        return (x @ lora.lora_a.to(x.dtype)) @ lora.lora_b.to(x.dtype)
    idx = lora_idx.to(device=lora.lora_a.device, dtype=torch.long)
    side = torch.bmm(x, lora.lora_a[idx].to(x.dtype))
    return torch.bmm(side, lora.lora_b[idx].to(x.dtype))
