"""Next-token samplers that run on the device: greedy, and Gumbel-max draws
from a counter-based hash.

Port of `eetq_tpu/serve/generate.py::_sample` and
`eetq_tpu/serve/engine.py::_sample_rows`. JAX draws with
`jax.random.categorical`: the argmax of the logits plus Gumbel noise from a
split PRNG key. Here the noise comes from a hash of (seed, draw counter,
element index). The state of a stream is an int64 tensor [2] = (seed,
counter) on the logits' device, and each draw advances its counter in
place: a draw reads nothing from the host and makes no new state tensor, so
a CUDA graph that captured it draws anew on every replay, and the CPU and
the card give the same noise from the same state. The numbers differ from
JAX's (another generator): tests compare properties of sampled streams,
never their tokens.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """Wellons' lowbias32 on int64 tensors of 32-bit values (both multipliers
    are below 2^31, so no product leaves int64)."""
    x = ((x ^ (x >> 16)) * 0x21F0AAAD) & _M32
    x = ((x ^ (x >> 15)) * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def rng_state(seed: int, device: torch.device | str) -> torch.Tensor:
    """A fresh stream: int64 [2] = (seed, draws so far)."""
    return torch.tensor([seed & _M32, 0], dtype=torch.int64, device=device)


def rng_from(generator: torch.Generator | None, device: torch.device | str) -> torch.Tensor:
    """A stream seeded by one draw from `generator` (torch's default CPU
    generator when None)."""
    where = generator.device if generator is not None else "cpu"
    seed = int(torch.randint(0, 1 << 31, (1,), generator=generator, device=where))
    return rng_state(seed, device)


def gumbel(rng: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Standard Gumbel noise of `shape` (f32) from the stream `rng`, whose
    counter advances by one."""
    key = _hash32(_hash32(rng[0:1]) ^ (rng[1:2] & _M32))
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=rng.device).reshape(shape)
    h = _hash32(_hash32(idx ^ key) ^ key)
    rng[1:2].add_(1)
    return -torch.log(-torch.log(_uniform(h)))


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """32-bit hashes -> f32 in (0, 1), both ends excluded: the top 23 bits
    plus a half, whose largest value 1 - 2^-24 is still an f32 below one (24
    bits plus a half would round to 1.0, and its noise to +inf)."""
    return ((h >> 9).float() + 0.5) * 2.0 ** -23


def sample(logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0,
           rng: torch.Tensor | None = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int64: argmax when temperature == 0, else a
    draw from softmax(logits / temperature) over the top_k largest (all when
    top_k == 0), the Gumbel-max way."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    return torch.argmax(scaled + gumbel(rng, tuple(scaled.shape)), dim=-1)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor, topks: torch.Tensor, topk_cap: int,
                rng: torch.Tensor) -> torch.Tensor:
    """Per-row mixed greedy/sampled next tokens (engine.py:161-180). logits
    [B, V]; temps [B] f32 (0 = greedy row); topks [B] int (0 = no top-k
    filter); topk_cap bounds every row's top_k (the top topk_cap are taken
    once and each row reads its own k-th value as its threshold). All rows
    draw from one noise tensor. Returns tokens [B] int64."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / temps.clamp(min=1e-6)[:, None]
    if topk_cap > 0:
        vals = torch.topk(scaled, topk_cap, dim=-1).values
        kth = vals.gather(1, (topks.long() - 1).clamp(0, topk_cap - 1)[:, None])
        scaled = scaled.masked_fill((topks[:, None] > 0) & (scaled < kth), float("-inf"))
    drawn = torch.argmax(scaled + gumbel(rng, tuple(scaled.shape)), dim=-1)
    return torch.where(temps > 0, drawn, greedy)
