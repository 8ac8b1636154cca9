"""Column and row splits of a tensor-parallel layout, on tensors.

Port of the pure splitters of `eetq_tpu/dist/sharding.py:67-93` (the
runtime counterpart of the reference's offline split_tp_column /
split_tp_row, `utils/base.py:132-186`). They cut a tensor into tp shards and
place nothing: the mesh, the sharded model and its collectives are ROADMAP.md
queue 1 item 9.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.models.config import ModelConfig


def split_qkv_columns(w: torch.Tensor, cfg: ModelConfig, tp: int) -> list[torch.Tensor]:
    """Split a fused qkv weight [K, (Hq + 2 Hkv) D] into tp column shards,
    each holding its own q, k and v heads (Megatron grouping: shard i gets q
    heads [i Hq / tp, (i + 1) Hq / tp) and the matching kv heads, so GQA
    groups stay together). Works on weights, biases and scales alike (the
    last axis is split)."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hq % tp or hkv % tp:
        raise ValueError(f"heads ({hq}, {hkv}) not divisible by tp={tp}")
    q, k, v = w[..., : hq * d], w[..., hq * d: (hq + hkv) * d], w[..., (hq + hkv) * d:]
    qs, ks, vs = (torch.chunk(t, tp, dim=-1) for t in (q, k, v))
    return [torch.cat([qs[i], ks[i], vs[i]], dim=-1) for i in range(tp)]


def split_gateup_columns(w: torch.Tensor, tp: int) -> list[torch.Tensor]:
    """Split a fused gate|up weight [K, 2I] into tp shards [K, 2I / tp], each
    holding its gate slice and its up slice."""
    if w.shape[-1] % (2 * tp):
        raise ValueError(f"gate|up width {w.shape[-1]} not divisible by 2 tp = {2 * tp}")
    gate, up = torch.chunk(w, 2, dim=-1)
    gs, us = torch.chunk(gate, tp, dim=-1), torch.chunk(up, tp, dim=-1)
    return [torch.cat([gs[i], us[i]], dim=-1) for i in range(tp)]


def split_rows(w: torch.Tensor, tp: int) -> list[torch.Tensor]:
    """Row split of o_proj / down [K, N] into tp shards [K / tp, N]."""
    if w.shape[-2] % tp:
        raise ValueError(f"K={w.shape[-2]} not divisible by tp={tp}")
    return list(torch.chunk(w, tp, dim=-2))
