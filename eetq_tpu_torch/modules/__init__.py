"""Port of `eetq_tpu.modules`."""

from eetq_tpu_torch.modules.attention import KVCache, attention
from eetq_tpu_torch.modules.linear import (
    DenseLinear,
    LoraAdapter,
    QuantLinear,
    linear_apply,
    quantize_linear,
)
from eetq_tpu_torch.modules.moe import MoEMLP, moe_apply, quantize_moe

__all__ = [
    "QuantLinear",
    "DenseLinear",
    "LoraAdapter",
    "quantize_linear",
    "linear_apply",
    "KVCache",
    "attention",
    "MoEMLP",
    "moe_apply",
    "quantize_moe",
]
