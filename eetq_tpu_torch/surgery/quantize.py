"""One-line quantize-and-swap, also over a HuggingFace torch model.

Port of `eetq_tpu/surgery/quantize.py`:

- `eet_quantize(params)`: every DenseLinear of the model becomes a
  QuantLinear (W8A16, or W4A16 with bits=4, per-channel or group-wise),
  except those whose path matches an `exclude` regex (the lm_head by
  default). Paths are the JAX package's pytree paths (`.layers[0].qkv`,
  `.layers[1].o_proj`, `.lm_head`), built while walking the module tree, so
  one regex selects the same layers in both packages. A MoE layer's expert
  banks are quantized by `modules/moe.py::quantize_moe` whatever `exclude`
  says, and its router stays bf16, as in the JAX package.
- `eet_accelerator(model_or_params)`: a ModelParams is quantized as above;
  a HuggingFace *ForCausalLM is converted by `models/hf.py::
  convert_torch_model` on `dev` (the card when None).

Quantization runs where the weights lie; the result shares the embedding
and the norms with `params`.
"""

from __future__ import annotations

import re

import torch

from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
from eetq_tpu_torch.modules.linear import DenseLinear, quantize_linear
from eetq_tpu_torch.modules.moe import quantize_moe


def eet_quantize(
    params: ModelParams,
    bits: int = 8,
    group_size: int | None = None,
    exclude: tuple[str, ...] = ("lm_head",),
) -> ModelParams:
    """Quantize every DenseLinear in `params` to `bits` (per-channel, or
    group-wise with `group_size`) except those whose path matches an
    `exclude` regex (`re.search` on the JAX pytree path)."""
    patterns = [re.compile(p) for p in exclude]

    def linear(path: str, lin):
        if not isinstance(lin, DenseLinear) or any(p.search(path) for p in patterns):
            return lin
        return quantize_linear(lin.weight, bias=lin.bias, bits=bits, group_size=group_size)

    def layer(i: int, lp: LayerParams) -> LayerParams:
        pfx = f".layers[{i}]"
        moe = lp.moe
        if moe is not None and isinstance(moe.gateup, DenseLinear):
            moe = quantize_moe(moe, bits=bits, group_size=group_size)
        mlp = dict(moe=moe) if moe is not None else dict(
            gateup=linear(f"{pfx}.gateup", lp.gateup), down=linear(f"{pfx}.down", lp.down))
        return LayerParams(lp.input_norm, linear(f"{pfx}.qkv", lp.qkv),
                           linear(f"{pfx}.o_proj", lp.o_proj), lp.post_norm,
                           qkv_lora=lp.qkv_lora, o_lora=lp.o_lora, **mlp)

    layers = [layer(i, lp) for i, lp in enumerate(params.layers)]
    return ModelParams(params.embed, layers, params.final_norm,
                       linear(".lm_head", params.lm_head))


def eet_accelerator(
    model,
    quantize: bool = True,
    fused_attn: bool = True,
    dev: torch.device | str | None = None,
    bits: int = 8,
):
    """One-line accelerate (`eet_accelerator(model, quantize=True,
    fused_attn=True, dev="cuda:0")`): a ModelParams comes back quantized
    where it lies; a HuggingFace torch *ForCausalLM comes back as the port's
    (cfg, params) on `dev`, the card when None. fused_attn is implicit: the
    port always runs the fused qkv and the flash-attention kernels."""
    if isinstance(model, ModelParams):
        return eet_quantize(model, bits=bits) if quantize else model
    from eetq_tpu_torch.models.hf import convert_torch_model

    return convert_torch_model(model, quantize=quantize, bits=bits, device=dev)
