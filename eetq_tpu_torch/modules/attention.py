"""Attention with a preallocated KV cache, GQA and causal masking.

Port of `eetq_tpu/modules/attention.py` for the dense cache, bf16 or int8.
The cache layout is [batch, n_kv_heads, max_len, head_dim]; the int8 cache
keeps f32 per-(row, head, position) scales [batch, n_kv_heads, max_len].
Prefill (S > 1, offset 0) runs the flash-attention kernel over the new,
unquantized K/V; decode (S = 1) runs the flash-decode kernel (its int8 mode
for an int8 cache) over each row's live prefix. The verify step of
speculative decoding (`verify=True`, S > 1) writes S tokens at per-row
offsets and attends with the same kernel's multi-query mode, query token i
at length - S + i (`attention_verify`). A paged cache (`modules/paged.py`)
serves decode and verify: scattered writes through the block table, then
the paged flash-decode kernel. Chunked prefill (S > 1 at an int offset >
0, `eetq_tpu/modules/attention.py:430-450`) writes the chunk into the cache,
then attends with the prefill kernel over the cache's first offset + S
positions, read in place as a strided [B, L, Hkv, D] view (an int8 cache
dequantized first), the chunk's last query on the last key. Every
path takes the model's sliding window and ALiBi slopes [Hq] (`slopes`,
`ops/alibi.py`; the bias slope_h * (key_pos - query_pos) in place of rope,
`eetq_tpu/modules/attention.py:168-181`), which the kernels compute.

The prefill offset is the Python int 0. The JAX engine passes a traced
`jnp.int32(0)` (`eetq_tpu/serve/engine.py:114`); the port's engine passes an
int, so `attention` tells prefill (0) from chunked prefill (> 0) by the int
alone.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from eetq_tpu_torch.kernels.flash_attention import (
    attention_reference,
    causal_mask,
    flash_attention,
)
from eetq_tpu_torch.kernels.flash_decode import (
    dequantize_kv,
    flash_decode,
    flash_decode_int8,
    flash_decode_ref,
)
from eetq_tpu_torch.kernels.w8a8 import quantize_activations
from eetq_tpu_torch.utils.device import resolve

if TYPE_CHECKING:  # modules.paged imports this module
    from eetq_tpu_torch.modules.paged import PagedKVCache

__all__ = [
    "DecodeAt", "KVCache", "attention", "attention_decode", "attention_decode_ref",
    "attention_prefill", "attention_reference", "attention_verify", "attention_verify_ref",
    "causal_mask", "decode_at", "init_kv_cache", "update_cache", "write_token",
]


@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache: k, v [batch, n_kv_heads, max_len, head_dim],
    bf16; or int8 with f32 scales k_scale, v_scale [batch, n_kv_heads,
    max_len]."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(
    batch: int,
    max_len: int,
    n_kv_heads: int,
    head_dim: int,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> KVCache:
    """A zeroed cache: bf16, or int8 with zeroed f32 scales; on the card
    unless `device` says otherwise."""
    device = resolve(device)
    # rounded to 128 like the JAX package (unused tail rows are masked by
    # the per-row length everywhere)
    max_len = -(-max_len // 128) * 128
    shape = (batch, n_kv_heads, max_len, head_dim)
    if dtype == torch.int8:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


@dataclasses.dataclass(frozen=True)
class DecodeAt:
    """Where one decode step (or verify round) writes its tokens and how far
    it attends, per row: made once a step by `decode_at` and read by every
    layer (the layers of a model have caches of one capacity and, paged,
    one block table). `index` is the pair of indices into dims 0 and 2 of a
    cache leaf (row and position, or pool block and offset in it), [B] for
    one token a row, [B, S] for S; `lengths` [B] int32 counts the positions
    the last token attends, itself included."""

    index: tuple[torch.Tensor, torch.Tensor]
    lengths: torch.Tensor


def decode_at(cache: KVCache | PagedKVCache, pos: torch.Tensor, s: int = 1) -> DecodeAt:
    """The `DecodeAt` of a decode step at per-row positions `pos` [B], or of
    a verify round of S tokens a row at pos .. pos + S - 1. A position past
    the cache's capacity writes its last slot, as JAX's dynamic_update_slice
    clamps the write, and the lengths stop at the capacity: a decode window
    runs a row up to W - 1 steps past its budget, a speculative round up to
    2k + W, and those tokens are never committed (the speculative loops
    size their caches so that no committed token is clamped)."""
    from eetq_tpu_torch.modules import paged  # at call time: it imports this module

    pos = pos.long()
    if s > 1:
        pos = pos[:, None] + torch.arange(s, device=pos.device)
    if isinstance(cache, paged.PagedKVCache):
        bs = cache.block_size
        pos = pos.clamp(max=cache.table.shape[1] * bs - 1)
        blocks = (pos // bs).reshape(pos.shape[0], -1)
        index = (cache.table.gather(1, blocks).reshape(pos.shape).long(), pos % bs)
    else:
        pos = pos.clamp(max=cache.max_len - 1)
        rows = torch.arange(pos.shape[0], device=pos.device)
        index = (rows[:, None] if s > 1 else rows, pos)
    last = pos[:, -1] if s > 1 else pos
    return DecodeAt(index, (last + 1).to(torch.int32))


def write_token(cache: KVCache | PagedKVCache, index: tuple[torch.Tensor, torch.Tensor],
                k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache | PagedKVCache:
    """Write one token per row ([B] indices, k_new/v_new [B, Hkv, D]) or S
    ([B, S] indices, k_new/v_new [B, S, Hkv, D]), IN PLACE, at `index`
    (`DecodeAt.index`). An int8 cache stores the quantized values and their
    scales (per (row, head) over D, as `update_cache`). Writes whose index
    is the same (a paged engine's inactive slots, all in block 0; clamped
    overshoot) write over each other; any winner is fine. Returns
    `cache`."""
    i0, i2 = index
    if cache.quantized:
        k_new, ks = quantize_activations(k_new)  # scales [B, Hkv]
        v_new, vs = quantize_activations(v_new)
        cache.k_scale[i0, :, i2] = ks
        cache.v_scale[i0, :, i2] = vs
    # advanced indices around a slice come first: the indexed view is [B, Hkv, D]
    cache.k[i0, :, i2] = k_new.to(cache.k.dtype)
    cache.v[i0, :, i2] = v_new.to(cache.v.dtype)
    return cache


def update_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, offset) -> KVCache:
    """Write [B, S, Hkv, D] new keys/values at sequence position `offset`,
    IN PLACE (slice assignment where the JAX package returns a new cache
    from `dynamic_update_slice`). offset is an int (every row at the same
    position), a [B] tensor of per-row positions that fit the cache, or a
    `DecodeAt` of the S tokens. An int8 cache stores the quantized values
    and their scales at the same positions. Returns `cache`."""
    s = k_new.shape[1]
    if isinstance(offset, DecodeAt):
        if s == 1:
            k_new, v_new = k_new[:, 0], v_new[:, 0]
        return write_token(cache, offset.index, k_new, v_new)
    ks = vs = None
    if cache.quantized:
        # per-(head, token) int8 over D: the activation quantizer's arithmetic,
        # as `_quantize_kv` (eetq_tpu/modules/attention.py:76-83) runs under jit
        k_new, ks = quantize_activations(k_new)  # scales [B, S, Hkv]
        v_new, vs = quantize_activations(v_new)
    if isinstance(offset, int):
        cache.k[:, :, offset:offset + s] = k_new.transpose(1, 2)
        cache.v[:, :, offset:offset + s] = v_new.transpose(1, 2)
        if ks is not None:
            cache.k_scale[:, :, offset:offset + s] = ks.transpose(1, 2)
            cache.v_scale[:, :, offset:offset + s] = vs.transpose(1, 2)
        return cache
    b = k_new.shape[0]
    off = torch.as_tensor(offset, device=cache.k.device).reshape(-1).expand(b)
    pos = off[:, None] + torch.arange(s, device=off.device)  # [B, S]
    rows = torch.arange(b, device=off.device)[:, None]
    # advanced indices around a slice put their [B, S] dims first: the
    # indexed view is [B, S, Hkv(, D)], the layout of k_new and its scales
    cache.k[rows, :, pos] = k_new.to(cache.k.dtype)
    cache.v[rows, :, pos] = v_new.to(cache.v.dtype)
    if ks is not None:
        cache.k_scale[rows, :, pos] = ks
        cache.v_scale[rows, :, pos] = vs
    return cache


def attention_prefill(q, k, v, window: int | None = None, use_flash: bool = True,
                      slopes: torch.Tensor | None = None):
    """Causal attention of q [B, S, Hq, D] over k/v [B, L, Hkv, D], L >= S,
    the last query on the last key: the S new tokens among themselves
    (empty cache), or a prefill chunk over its cached prefix."""
    scale = q.shape[-1] ** -0.5
    if use_flash:
        return flash_attention(q, k, v, causal=True, scale=scale, window=window, slopes=slopes)
    return attention_reference(
        q, k, v, causal_mask(q.shape[1], window, k.shape[1], q.device), scale, slopes=slopes
    )


def _lengths(length, batch: int, device) -> torch.Tensor:
    if isinstance(length, int):
        return torch.full((batch,), length, dtype=torch.int32, device=device)
    return torch.as_tensor(length, device=device).to(torch.int32).reshape(-1).expand(batch).contiguous()


def attention_decode(q, cache: KVCache, length, window: int | None = None,
                     use_kernel: bool = True, slopes: torch.Tensor | None = None):
    """One decode step: q [B, 1, Hq, D] attends over cache[:, :, :length].
    length counts the valid entries INCLUDING the token being decoded (its
    K/V already written at length - 1): an int or a per-row [B] tensor.
    With S > 1 tokens it is the verify attention (`attention_verify`). q
    may be a strided view (an ALiBi model's q takes no rope): the kernels
    read a contiguous copy."""
    scale = q.shape[-1] ** -0.5
    lengths = _lengths(length, q.shape[0], q.device)
    q = q.contiguous()
    if not use_kernel:
        return attention_decode_ref(q, cache, lengths, window, scale, slopes=slopes)
    if cache.quantized:
        return flash_decode_int8(q, cache.k, cache.v, cache.k_scale, cache.v_scale, lengths,
                                 scale=scale, window=window, slopes=slopes)
    return flash_decode(q, cache.k, cache.v, lengths, scale=scale, window=window, slopes=slopes)


def attention_decode_ref(q, cache: KVCache, length, window, scale,
                         slopes: torch.Tensor | None = None):
    """Plain decode attention over the [B, H, L, D] cache; an int8 cache is
    dequantized in bf16 first (`eetq_tpu/modules/attention.py:271-273`)."""
    k, v = cache.k, cache.v
    if cache.quantized:
        k, v = dequantize_kv(k, cache.k_scale), dequantize_kv(v, cache.v_scale)
    return flash_decode_ref(q, k, v, length, scale=scale, window=window, slopes=slopes)


# The verify step of speculative decoding (`eetq_tpu/modules/attention.py::
# attention_verify`, :297-358): q [B, S, Hq, D], query token i at position
# length - S + i attending causally over cache[:, :, :length], the S new
# tokens' K/V already written. The flash-decode kernel and its plain version
# take S > 1 with these semantics, so verify is decode with S tokens: token i
# is bit-equal to a decode step at length - S + i + 1, the greedy exactness
# of `serve/spec.py`.
attention_verify = attention_decode
attention_verify_ref = attention_decode_ref


def attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    cache: KVCache | PagedKVCache | None,
    offset,
    window: int | None = None,
    use_kernels: bool = True,
    verify: bool = False,
    slopes: torch.Tensor | None = None,
) -> tuple[torch.Tensor, KVCache | PagedKVCache | None]:
    """Write K/V to the cache at `offset`, then attend: prefill when S > 1
    (offset the int 0; it attends over the unquantized new K/V, so only
    the cache holds int8), chunked prefill when S > 1 at an int offset > 0
    (over cache[:, :, :offset + S], dequantized for an int8 cache), decode
    when S == 1 (offset an int, a [B] tensor
    or the step's `DecodeAt`), the verify step when verify=True and S > 1
    (offset the [B] start positions, an int, or the round's `DecodeAt`:
    token i at offset + i, attending causally over the cache). cache is a
    KVCache, None, or a PagedKVCache (decode and verify: prefill runs on a
    dense scratch and is handed off with `paged_insert_rows`).
    use_kernels=False runs the plain versions. slopes [Hq] f32: the ALiBi
    bias (the caller applies no rope). Returns (out [B, S, Hq, D],
    cache)."""
    from eetq_tpu_torch.modules import paged  # at call time: it imports this module

    b, s = q.shape[:2]
    verify = verify and s > 1
    if verify and cache is None:
        raise ValueError("verify requires a KV cache")
    if (cache is not None and not isinstance(offset, DecodeAt)
            and (verify or (s == 1 and isinstance(offset, torch.Tensor)))):
        start = torch.as_tensor(offset, device=q.device).reshape(-1).expand(b)
        offset = decode_at(cache, start, s)
    length = offset.lengths if isinstance(offset, DecodeAt) else offset + 1
    if isinstance(cache, paged.PagedKVCache):
        if s != 1 and not verify:
            raise NotImplementedError(
                "paged caches serve decode and verify; prefill runs on the dense scratch and "
                "hands off")
        if verify:
            paged.paged_write_multi(cache, k_new, v_new, offset)
        else:
            paged.paged_write(cache, k_new, v_new, offset)
        out = paged.paged_attention_decode(q, cache, length, window=window,
                                           use_kernel=use_kernels, slopes=slopes)
        return out, cache
    if cache is not None:
        cache = update_cache(cache, k_new, v_new, offset)
    if s == 1 or verify:
        if cache is None:
            raise ValueError("decode requires a KV cache")
        out = attention_decode(q, cache, length, window=window, use_kernel=use_kernels,
                               slopes=slopes)
    elif isinstance(offset, int) and offset == 0:
        out = attention_prefill(q, k_new, v_new, window=window, use_flash=use_kernels,
                                slopes=slopes)
    elif isinstance(offset, int) and cache is not None:
        # a prefill chunk, written at [offset, offset + S): it attends over the
        # whole prefix, the cache's [B, Hkv, hist, D] read as [B, hist, Hkv, D]
        hist = offset + s
        k_ctx, v_ctx = cache.k[:, :, :hist], cache.v[:, :, :hist]
        if cache.quantized:
            k_ctx = dequantize_kv(k_ctx, cache.k_scale[:, :, :hist])
            v_ctx = dequantize_kv(v_ctx, cache.v_scale[:, :, :hist])
        out = attention_prefill(q, k_ctx.transpose(1, 2), v_ctx.transpose(1, 2), window=window,
                                use_flash=use_kernels, slopes=slopes)
    else:
        raise NotImplementedError(f"S = {s} tokens at offset {offset!r}: prefill takes the int 0, "
                                  "chunked prefill an int offset and a cache")
    return out, cache
