"""ALiBi (Attention with Linear Biases) slopes.

A framework-free copy of `eetq_tpu/ops/alibi.py` (importing it would import
JAX through the package). The slopes feed an additive slope_h * (key_pos -
query_pos) bias in the attention kernels and their plain versions
(`kernels/flash_attention.py`, `kernels/flash_decode.py`) in place of rope
(baichuan-13b). For n a power of two, slope_h = 2^(-8(h+1)/n); for other n
the first p = 2^floor(log2 n) heads take the power-of-two formula at p and
the rest every other slope of the 2p sequence, slope_{p+j} = 2^(-4(2j+1)/p)
(Press et al., "Train Short, Test Long"; baichuan-13b has 40 heads).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from eetq_tpu_torch.utils.device import resolve


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes [n_heads] f32 (closed form, any head count),
    computed in f64 and rounded once, as the JAX package does."""
    if n_heads < 1:
        raise ValueError(f"n_heads must be >= 1, got {n_heads}")
    p = 1 << (n_heads.bit_length() - 1)  # largest power of two <= n_heads
    h = np.arange(n_heads, dtype=np.float64)
    slopes = np.where(
        h < p,
        2.0 ** (-8.0 * (h + 1) / p),
        2.0 ** (-4.0 * (2.0 * (h - p) + 1.0) / p),
    )
    return slopes.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _shared_slopes(n_heads: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(alibi_slopes(n_heads)).to(device)


def alibi_slopes_cache(n_heads: int, device: torch.device | str | None = None) -> torch.Tensor:
    """The f32 [n_heads] slopes on `device`, built once per (n_heads,
    device) and shared by every forward that asks for them (a captured
    decode step reads the same tensor on every replay): read them, never
    write to them. On the card unless `device` says otherwise."""
    return _shared_slopes(n_heads, resolve(device))
