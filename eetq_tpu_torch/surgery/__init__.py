"""Port of `eetq_tpu.surgery`: fusion, LoRA (attach, merge, stack into
banks) and one-line quantization. The offline tensor-parallel reshard
(`tp_reshard.py`) is not ported."""

from eetq_tpu_torch.surgery.fusion import (
    fuse_columns,
    fuse_gateup,
    fuse_qkv,
    split_quant_columns,
)
from eetq_tpu_torch.surgery.lora import attach_lora, init_lora, merge_lora, stack_adapters
from eetq_tpu_torch.surgery.quantize import eet_accelerator, eet_quantize

__all__ = [
    "fuse_columns",
    "split_quant_columns",
    "fuse_qkv",
    "fuse_gateup",
    "attach_lora",
    "init_lora",
    "merge_lora",
    "stack_adapters",
    "eet_quantize",
    "eet_accelerator",
]
