"""Port of `eetq_tpu.surgery`: fusion and one-line quantization. LoRA
(`lora.py`) and the offline tensor-parallel reshard (`tp_reshard.py`) are
not ported."""

from eetq_tpu_torch.surgery.fusion import (
    fuse_columns,
    fuse_gateup,
    fuse_qkv,
    split_quant_columns,
)
from eetq_tpu_torch.surgery.quantize import eet_accelerator, eet_quantize

__all__ = [
    "fuse_columns",
    "split_quant_columns",
    "fuse_qkv",
    "fuse_gateup",
    "eet_quantize",
    "eet_accelerator",
]
