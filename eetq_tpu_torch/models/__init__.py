"""Port of `eetq_tpu.models`, with the checkpoint entry points of
`models/hf.py` and `models/auto.py`."""

from eetq_tpu_torch.models.auto import AutoEETQForCausalLM, EETQCausalLM
from eetq_tpu_torch.models.config import PRESETS, ModelConfig
from eetq_tpu_torch.models.hf import (
    convert_torch_model,
    load_config,
    load_hf_dense,
    load_quantized,
    save_quantized,
)
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.models.transformer import LayerParams, ModelParams, forward, init_caches

__all__ = [
    "ModelConfig",
    "PRESETS",
    "LayerParams",
    "ModelParams",
    "forward",
    "init_caches",
    "random_dense_params",
    "quantize_params",
    "AutoEETQForCausalLM",
    "EETQCausalLM",
    "load_config",
    "load_hf_dense",
    "load_quantized",
    "save_quantized",
    "convert_torch_model",
]
