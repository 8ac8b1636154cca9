"""LoRA over a model's parameters: attach adapters to a (quantized) model,
merge them into the base and requantize, stack adapted copies of one base
into a bank for multi-adapter serving.

Port of `eetq_tpu/surgery/lora.py` (:33-154). Random draws come from an
explicit `torch.Generator`, on its own device.

- `init_lora`: A ~ N(0, 1/r), B = 0 (the adapter starts as an exact no-op),
  scaling = alpha / rank.
- `attach_lora`: fresh adapters on every layer's qkv and/or o_proj.
- `merge_lora`: fold each adapter's A B scaling into its base projection and
  drop the side paths. A quantized base is dequantized, merged in f32 and
  requantized per-channel or group-wise at its own bits, on its device.
- `stack_adapters`: N adapted copies of the same base become one model whose
  adapters are banks [N, ...], each batch row picking its adapter through
  `lora_idx` (`Engine.add_request(lora_id=...)`).
"""

from __future__ import annotations

import math

import torch

from eetq_tpu_torch.layout.tiling import unpack_weights
from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
from eetq_tpu_torch.modules.linear import DenseLinear, LoraAdapter, QuantLinear, quantize_linear


def replace_layer(lp: LayerParams, **changes) -> LayerParams:
    """A LayerParams sharing every module of `lp` but those in `changes`."""
    fields = dict(input_norm=lp.input_norm, qkv=lp.qkv, o_proj=lp.o_proj,
                  post_norm=lp.post_norm, gateup=lp.gateup, down=lp.down, moe=lp.moe,
                  qkv_lora=lp.qkv_lora, o_lora=lp.o_lora)
    fields.update(changes)
    return LayerParams(**fields)


def _with_layers(params: ModelParams, layers: list[LayerParams]) -> ModelParams:
    return ModelParams(params.embed, layers, params.final_norm, params.lm_head)


def init_lora(generator: torch.Generator, k: int, n: int, rank: int, alpha: float = 16.0,
              dtype: torch.dtype = torch.bfloat16) -> LoraAdapter:
    """Standard LoRA init on the generator's device: A [k, rank] ~ N(0, 1/r),
    B [rank, n] = 0, scaling = alpha / rank."""
    dev = generator.device
    a = torch.randn((k, rank), generator=generator, device=dev, dtype=torch.float32)
    a = a / math.sqrt(rank)
    return LoraAdapter(a.to(dtype), torch.zeros((rank, n), dtype=dtype, device=dev),
                       alpha / rank)


def attach_lora(
    params: ModelParams,
    rank: int,
    generator: torch.Generator,
    alpha: float = 16.0,
    targets: tuple[str, ...] = ("qkv", "o"),
) -> ModelParams:
    """Fresh (no-op) adapters on every layer's qkv and/or o_proj, drawn on
    the generator's device and moved to the parameters'; the base modules
    are shared with `params`."""
    dev = params.embed.device

    def fresh(lin):
        ad = init_lora(generator, lin.in_features, lin.out_features, rank, alpha)
        return LoraAdapter(ad.lora_a.to(dev), ad.lora_b.to(dev), ad.scaling)

    layers = []
    for lp in params.layers:
        upd = {}
        if "qkv" in targets:
            upd["qkv_lora"] = fresh(lp.qkv)
        if "o" in targets:
            upd["o_lora"] = fresh(lp.o_proj)
        layers.append(replace_layer(lp, **upd))
    return _with_layers(params, layers)


def _merge_one(base, lora: LoraAdapter | None):
    if lora is None:
        return base
    if lora.banked:
        raise ValueError("merge_lora takes single adapters, not a bank")
    delta = (lora.lora_a.float() @ lora.lora_b.float()) * lora.scaling
    if isinstance(base, QuantLinear):
        q = unpack_weights(base.packed).float()
        if base.scales.dim() == 1:  # per-channel
            w, group_size = q * base.scales.float()[None, :], None
        else:  # group-wise [G, N]
            group_size = q.shape[0] // base.scales.shape[0]
            w = q * base.scales.float().repeat_interleave(group_size, dim=0)
        return quantize_linear(w + delta.to(w.device), bias=base.bias, bits=base.bits,
                               group_size=group_size)
    weight = (base.weight.float() + delta.to(base.weight.device)).to(base.weight.dtype)
    return DenseLinear(weight, base.bias)


def merge_lora(params: ModelParams) -> ModelParams:
    """Fold every attached adapter into its base projection and drop the side
    paths; quantized bases are requantized after the merge."""
    return _with_layers(params, [
        replace_layer(lp, qkv=_merge_one(lp.qkv, lp.qkv_lora),
                      o_proj=_merge_one(lp.o_proj, lp.o_lora), qkv_lora=None, o_lora=None)
        for lp in params.layers
    ])


def stack_adapters(adapted: list[ModelParams]) -> ModelParams:
    """Stack N separately adapted copies of the SAME base into one model whose
    adapters are banks (lora_a [N, K, r], lora_b [N, r, N_out]), selected per
    batch row by `lora_idx`. The base modules are adapted[0]'s; every copy
    must carry adapters on the same projections, with one scaling."""
    if not adapted:
        raise ValueError("need at least one adapted model")
    base = adapted[0]

    def bank(ads):
        if any(a is None for a in ads):
            if not all(a is None for a in ads):
                raise ValueError("adapters must target the same projections")
            return None
        if len({a.scaling for a in ads}) != 1:
            raise ValueError("bank adapters must share one scaling")
        return LoraAdapter(torch.stack([a.lora_a for a in ads]),
                           torch.stack([a.lora_b for a in ads]), ads[0].scaling)

    return _with_layers(base, [
        replace_layer(lp, qkv_lora=bank([p.layers[i].qkv_lora for p in adapted]),
                      o_lora=bank([p.layers[i].o_lora for p in adapted]))
        for i, lp in enumerate(base.layers)
    ])
