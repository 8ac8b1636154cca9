"""Rotary position embedding, NeoX split-half and GPT-J interleaved forms.

Port of `eetq_tpu/ops/rope.py`: the cache is [max_pos, rot_dim] =
concat([cos, sin]) and the rotation runs in f32. Plain torch elementwise.
"""

from __future__ import annotations

import functools

import torch

from eetq_tpu_torch.utils.device import resolve


def make_cos_sin_cache(
    max_position: int,
    rot_dim: int,
    base: float = 10000.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """[max_position, rot_dim] cache, first half cos, second half sin; on the
    card unless `device` says otherwise."""
    device = resolve(device)
    inv_freq = 1.0 / (
        base ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim)
    )
    t = torch.arange(max_position, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [max_pos, rot_dim/2]
    return torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1).to(dtype)


@functools.lru_cache(maxsize=8)
def _shared_cos_sin_cache(max_position: int, rot_dim: int, base: float,
                          device: torch.device) -> torch.Tensor:
    return make_cos_sin_cache(max_position, rot_dim, base=base, device=device)


def cos_sin_cache(
    max_position: int,
    rot_dim: int,
    base: float = 10000.0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """The f32 table of :func:`make_cos_sin_cache`, built once per
    (max_position, rot_dim, base, device) and shared by every forward that
    asks for it: read it, never write to it."""
    return _shared_cos_sin_cache(max_position, rot_dim, float(base), resolve(device))


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    cos_sin_cache: torch.Tensor,
    interleaved: bool = False,
) -> torch.Tensor:
    """x: [batch, seq, heads, head_dim] (the first rot_dim lanes rotate);
    positions: [batch, seq] int absolute positions. interleaved=False pairs
    x_i with x_{half+i} (NeoX); True pairs adjacent lanes (GPT-J/ChatGLM)."""
    rot_dim = cos_sin_cache.shape[-1]
    half = rot_dim // 2
    cs = cos_sin_cache[positions]  # [b, s, rot_dim]
    cos = cs[..., :half][:, :, None, :].float()  # [b, s, 1, half]
    sin = cs[..., half:][:, :, None, :].float()
    x_rot = x[..., :rot_dim].float()
    if interleaved:
        pairs = x_rot.reshape(*x_rot.shape[:-1], half, 2)
        x1, x2 = pairs[..., 0], pairs[..., 1]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        rotated = rotated.reshape(x_rot.shape)
    else:
        x1, x2 = x_rot[..., :half], x_rot[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = torch.cat([rotated, x[..., rot_dim:].float()], dim=-1)
    return out.to(x.dtype)
