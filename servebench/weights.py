"""The benchmark's seeded weights: one layer at a time, on the device, in bf16.

Both sides take their weights from here: the deployment hands each layer to
the port's quantizer (`deploy.py`), and the reference makes the same layer
again after the window and quantizes it with its own code
(`reference/model.py`). Every tensor comes from a `torch.Generator` of its
own, keyed on (seed, layer, part), so any layer can be made again alone and
in any order, and a seed of any size gives the same weights on every run.

Draws (the usual random-model convention, listed under `assumed` in each
configuration file): a linear [K, N] ~ N(0, 1/K), drawn in f32 on the device
in one call and rounded once to bf16; an expert bank [E, K, N] in one call
likewise; the router [H, E] ~ N(0, 1/H); the embedding [V, H] ~ N(0, 0.02^2);
the lm_head [H, V] ~ N(0, 1/H); every RMSNorm gain 1. Imports torch alone.
"""

from __future__ import annotations

import hashlib

import torch


def part_seed(seed: int, layer: int | str, part: str) -> int:
    """A 63-bit generator seed for one tensor of one layer."""
    digest = hashlib.blake2b(f"{int(seed)}:{layer}:{part}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _draw(seed: int, layer, part: str, shape, std: float, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, layer, part))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(std).to(torch.bfloat16)


def layer_weights(cfg: dict, seed: int, layer: int, device) -> dict[str, torch.Tensor]:
    """The bf16 weights of decoder layer `layer`, laid out [K, N] (in x out):
    qkv [H, (Hq + 2 Hkv) D] (q, then k, then v), o [Hq D, H], and either
    gateup [H, 2I] (gate columns first) and down [I, H], or on an MoE model
    router [H, E], gateup [E, H, 2I] and down [E, I, H]."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg.get("head_dim") or h // hq
    out = {
        "qkv": _draw(seed, layer, "qkv", (h, (hq + 2 * hkv) * d), h ** -0.5, device),
        "o": _draw(seed, layer, "o", (hq * d, h), (hq * d) ** -0.5, device),
    }
    e = cfg.get("num_local_experts")
    if e:
        out["router"] = _draw(seed, layer, "router", (h, e), h ** -0.5, device)
        out["gateup"] = _draw(seed, layer, "gateup", (e, h, 2 * i), h ** -0.5, device)
        out["down"] = _draw(seed, layer, "down", (e, i, h), i ** -0.5, device)
    else:
        out["gateup"] = _draw(seed, layer, "gateup", (h, 2 * i), h ** -0.5, device)
        out["down"] = _draw(seed, layer, "down", (i, h), i ** -0.5, device)
    return out


def embedding(cfg: dict, seed: int, device) -> torch.Tensor:
    """The token embedding [V, H], bf16."""
    return _draw(seed, "embed", "embed", (cfg["vocab_size"], cfg["hidden_size"]), 0.02, device)


def lm_head(cfg: dict, seed: int, device) -> torch.Tensor:
    """The untied output head [H, V], bf16 (served unquantized)."""
    h = cfg["hidden_size"]
    return _draw(seed, "head", "lm_head", (h, cfg["vocab_size"]), h ** -0.5, device)
