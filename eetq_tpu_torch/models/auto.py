"""`AutoEETQForCausalLM`: the user-facing model API.

Port of `eetq_tpu/models/auto.py`: dispatch on config.model_type, then
from_pretrained -> quantize -> save_quantized -> from_quantized over a local
checkpoint directory, or from_torch over a live HuggingFace model.
Generation is the port's own (`serve/generate.py`). Every entry point that
places parameters takes `device`, the card when None. `quantize(tp=N)` is
the offline tensor-parallel reshard (`surgery/tp_reshard.py`): the artifact
serves on one card and records tp in its quant config; `shard()` slices it
into a rank's shard for runtime tensor parallelism (`dist/sharding.py`).
Not ported: the hub download of `resolve_checkpoint`.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.hf import (
    _family,
    convert_torch_model,
    load_config,
    load_hf_dense,
    load_quantized,
    save_quantized,
)
from eetq_tpu_torch.models.transformer import ModelParams, forward, init_caches
from eetq_tpu_torch.modules.linear import QuantLinear

# model_type -> supported (the reference's EETQ_CAUSAL_LM_MODEL_MAP plus
# mistral, chatglm and mixtral, as in the JAX package)
SUPPORTED_MODEL_TYPES = (
    "llama", "mistral", "mixtral", "gemma", "baichuan", "qwen2", "chatglm"
)


@dataclasses.dataclass
class EETQCausalLM:
    """A (config, params) pair with the one-line workflow methods."""

    cfg: ModelConfig
    params: ModelParams
    hf_config: dict | None = None
    tp: int = 1  # the tensor parallelism `quantize` prepared the artifact for

    @property
    def quantized(self) -> bool:
        return isinstance(self.params.layers[0].qkv, QuantLinear)

    def quantize(
        self,
        save_dir: str | None = None,
        bits: int = 8,
        tp: int = 1,
        group_size: int | None = None,
        quantize_lm_head: bool = False,
    ) -> "EETQCausalLM":
        """Quantize in place (fused-projection W8A16/W4A16, where the params
        lie) and optionally save. tp > 1 mirrors the reference's
        `quantize(save_dir, tp)` (`models/base.py:74-102`): the row-parallel
        layers get per-rank K-slice scales (group = K / tp), so that a later
        tp-way reshard is bit-exact, and the artifact still serves on one
        card (the group-wise kernels); the lm_head stays dense."""
        if not self.quantized:
            if tp > 1:
                if group_size is not None:
                    raise ValueError("pass either tp or group_size, not both")
                from eetq_tpu_torch.surgery.tp_reshard import quantize_params_tp

                self.params = quantize_params_tp(self.params, self.cfg, tp=tp, bits=bits)
            else:
                from eetq_tpu_torch.surgery.quantize import eet_quantize

                self.params = eet_quantize(
                    self.params, bits=bits, group_size=group_size,
                    exclude=() if quantize_lm_head else ("lm_head",),
                )
            self.tp = tp
        if save_dir is not None:
            self.save_quantized(save_dir)
        return self

    def save_quantized(self, save_dir: str) -> None:
        if not self.quantized:
            raise ValueError("call quantize() first")
        save_quantized(self.params, self.cfg, save_dir, hf_config=self.hf_config, tp=self.tp)

    def forward(self, tokens, positions, caches=None, offset=0):
        return forward(self.params, self.cfg, tokens, positions, caches, offset)

    def generate(self, prompt, max_new_tokens: int, **kw):
        from eetq_tpu_torch.serve.generate import generate

        return generate(self.params, self.cfg, prompt, max_new_tokens, **kw)

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    device: torch.device | str | None = None):
        return init_caches(self.cfg, batch, max_len, device=device, dtype=dtype)

    def shard(self, mesh=None, tp: int | None = None, dp: int = 1):
        """This rank's shard for runtime tensor parallelism
        (`eetq_tpu/models/auto.py:116-133`) over `mesh`, or over
        `dist.make_mesh(tp, dp)` of the initialised process group. A
        quantized model (say, from a `quantize(tp=N)` checkpoint) is sliced
        without requantization (`shard_quantized`: bit-exact to the stored
        integers); a dense one is split and each shard quantized on its own
        (`shard_model`). Returns a `dist.sharding.ShardedModel`."""
        from eetq_tpu_torch.dist.sharding import make_mesh, shard_model

        if mesh is None:
            mesh = make_mesh(tp=tp, dp=dp)
        if self.quantized:
            from eetq_tpu_torch.surgery.tp_reshard import shard_quantized

            return shard_quantized(self.params, self.cfg, mesh)
        return shard_model(self.params, self.cfg, mesh, quantize=True)


def resolve_checkpoint(path: str) -> str:
    """A local checkpoint directory, as given. The JAX package also takes a
    HuggingFace Hub id (a download); the port reads local files only."""
    if os.path.isdir(path):
        return path
    raise FileNotFoundError(f"{path} is not a local checkpoint directory (the port does not "
                            f"download from the hub)")


class AutoEETQForCausalLM:
    """Entry point: checks config.model_type and builds the model."""

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, quantize: bool = False,
                        device: torch.device | str | None = None) -> EETQCausalLM:
        """A dense HF checkpoint directory in `dtype` on `device`, quantized
        there by `quantize()` (W8A16, lm_head dense) with quantize=True."""
        path = resolve_checkpoint(path)
        cfg, hf = load_config(path)
        _check_supported(cfg)
        cfg2, params = load_hf_dense(path, dtype=dtype, device=device)
        model = EETQCausalLM(cfg=cfg2, params=params, hf_config=hf)
        if quantize:
            model.quantize()
        return model

    @classmethod
    def from_quantized(cls, path: str, dtype=torch.bfloat16,
                       device: torch.device | str | None = None) -> EETQCausalLM:
        path = resolve_checkpoint(path)
        cfg, hf = load_config(path)
        _check_supported(cfg)
        cfg2, params = load_quantized(path, dtype=dtype, device=device)
        tp = int((hf.get("quantization_config") or {}).get("tp", 1))
        return EETQCausalLM(cfg=cfg2, params=params, hf_config=hf, tp=tp)

    @classmethod
    def from_torch(cls, torch_model, quantize: bool = True,
                   device: torch.device | str | None = None) -> EETQCausalLM:
        cfg, params = convert_torch_model(torch_model, quantize=quantize, device=device)
        _check_supported(cfg)
        return EETQCausalLM(cfg=cfg, params=params, hf_config=torch_model.config.to_dict())


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.model_type not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"model_type {cfg.model_type!r} isn't supported yet; "
            f"supported: {SUPPORTED_MODEL_TYPES}"
        )
    _family(cfg.model_type)
