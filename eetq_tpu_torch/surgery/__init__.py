"""Port of `eetq_tpu.surgery`: fusion, LoRA (attach, merge, stack into
banks), one-line quantization and the offline tensor-parallel reshard
(`tp_reshard.py`; placing its shards on a mesh is not ported)."""

from eetq_tpu_torch.surgery.fusion import (
    fuse_columns,
    fuse_gateup,
    fuse_qkv,
    split_quant_columns,
)
from eetq_tpu_torch.surgery.lora import attach_lora, init_lora, merge_lora, stack_adapters
from eetq_tpu_torch.surgery.quantize import eet_accelerator, eet_quantize
from eetq_tpu_torch.surgery.tp_reshard import quantize_params_tp, split_quant_rows

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
    "quantize_params_tp",
    "split_quant_rows",
]
