"""Carry a model's parameters across from numpy arrays.

`params_from_numpy(tree)` builds the port's ModelParams from a nested dict
of numpy arrays that mirrors the JAX package's ModelParams:

    {"embed": [V, H], "final_norm": [H], "lm_head": linear or None,
     "layers": [{"input_norm": [H], "post_norm": [H],
                 "qkv": linear, "o_proj": linear,
                 "gateup": linear, "down": linear}, ...]}

where a linear is ``{"qweight": int8 [K, N], "scales": [N] or [K/g, N],
"bits": 8 or 4 (default 8), "bias": [N]?}`` (quantized: the unpacked
portable format `eetq_tpu/models/hf.py` writes, int4 values held one per
int8, packed here by the port's own `pack_weights`) or ``{"weight": [K, N],
"bias": [N]?}`` (dense). A MoE layer has ``"moe": {"router": linear,
"gateup": bank, "down": bank}`` in place of gateup and down, where a bank
is a linear with a leading expert axis (``"qweight"`` int8 [E, K, N], int4
values one per int8 under ``"bits": 4``, and ``"scales"`` [E, N] or
[E, K/g, N]; or ``"weight"`` [E, K, N]). A layer may carry LoRA adapters
``"qkv_lora"`` and ``"o_lora"``: ``{"lora_a": [K, r], "lora_b": [r, N],
"scaling": float}``, or banks with a leading adapter axis ([n, K, r] and
[n, r, N]). Float arrays of any float dtype (bf16 ones included) are cast to
bf16 for weights, biases, adapters and the embedding, and to f32 for norms
and scales.
"""

from __future__ import annotations

import numpy as np
import torch

from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
from eetq_tpu_torch.modules.linear import DenseLinear, LoraAdapter, QuantLinear
from eetq_tpu_torch.modules.moe import MoEMLP
from eetq_tpu_torch.utils.device import resolve


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if dtype != torch.int8:
        a = a.astype(np.float32)  # exact for bf16 values
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _linear(d: dict, device):
    bias = None if d.get("bias") is None else _tensor(d["bias"], torch.bfloat16, device)
    if "qweight" in d:
        q = _tensor(d["qweight"], torch.int8, device)
        return QuantLinear(pack_weights(q, bits=int(d.get("bits", 8))),
                           _tensor(d["scales"], torch.float32, device), bias)
    return DenseLinear(_tensor(d["weight"], torch.bfloat16, device), bias)


def _lora(d: dict | None, device) -> LoraAdapter | None:
    if d is None:
        return None
    return LoraAdapter(_tensor(d["lora_a"], torch.bfloat16, device),
                       _tensor(d["lora_b"], torch.bfloat16, device), float(d["scaling"]))


def _layer(lp: dict, device) -> LayerParams:
    moe = lp.get("moe")
    if moe is not None:
        mlp = dict(moe=MoEMLP(*(_linear(moe[name], device) for name in ("router", "gateup",
                                                                          "down"))))
    else:
        mlp = dict(gateup=_linear(lp["gateup"], device), down=_linear(lp["down"], device))
    return LayerParams(
        input_norm=_tensor(lp["input_norm"], torch.float32, device),
        qkv=_linear(lp["qkv"], device),
        o_proj=_linear(lp["o_proj"], device),
        post_norm=_tensor(lp["post_norm"], torch.float32, device),
        qkv_lora=_lora(lp.get("qkv_lora"), device),
        o_lora=_lora(lp.get("o_lora"), device),
        **mlp,
    )


def params_from_numpy(tree: dict, device: torch.device | str | None = None) -> ModelParams:
    """The port's ModelParams from the numpy tree above, on the card unless
    `device` says otherwise."""
    device = resolve(device)
    layers = [_layer(lp, device) for lp in tree["layers"]]
    lm_head = None if tree.get("lm_head") is None else _linear(tree["lm_head"], device)
    return ModelParams(
        _tensor(tree["embed"], torch.bfloat16, device), layers,
        _tensor(tree["final_norm"], torch.float32, device), lm_head,
    )
