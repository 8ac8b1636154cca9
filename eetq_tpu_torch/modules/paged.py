"""Paged KV cache: a shared block pool and per-slot block tables.

Port of `eetq_tpu/modules/paged.py` (all of it but the multi-token verify
write and attention, which wait for speculative decoding). The dense engine
cache preallocates [max_batch, max_len] rows per layer, so its memory is set
by the worst-case context whatever the traffic. Paging allocates fixed-size
blocks from a shared pool as sequences grow:

- a pool per layer, k and v [num_blocks, Hkv, block_size, D] (and f32 scale
  pools [num_blocks, Hkv, block_size] for int8), all on the device;
- a block table [B, max_blocks] int32 mapping logical block i of a row to
  its pool block, rebuilt by the host allocator as blocks are granted and
  freed;
- the decode kernel (`kernels.flash_decode.paged_flash_decode`) translates
  key positions through the table and reads only the blocks a row owns;
- a decode step writes one token per row at (table[p // bs], :, p % bs).

Two things differ from the JAX package. The writes are IN PLACE
(`index_put_`, as `modules.attention.update_cache`): nothing returns a new
pool. And ONE table tensor is shared by the PagedKVCache of every layer:
JAX copies the table once per layer because its jitted decode window
donates the cache pytree (`eetq_tpu/serve/engine.py:588-595`); PyTorch has
no donation, so the engine updates the one tensor with a single `copy_`.

The block size is a multiple of 128, the JAX package's rule (there a pool
block is whole Mosaic tiles; the CUDA kernel needs blocks whole in its
64-key tiles), so both packages accept the same engines.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode_int8_ref,
    flash_decode_ref,
    gather_pool,
    paged_flash_decode,
    paged_flash_decode_int8,
)
from eetq_tpu_torch.modules.attention import DecodeAt, KVCache, _lengths, decode_at, write_token
from eetq_tpu_torch.utils.device import resolve

__all__ = [
    "PagedKVCache", "init_paged_kv_cache", "paged_attention_decode", "paged_gather_dense",
    "paged_insert_dense", "paged_write",
]


@dataclasses.dataclass
class PagedKVCache:
    """One layer's paged cache. k/v pools [NB, Hkv, BS, D], bf16, or int8
    with f32 scale pools k_scale/v_scale [NB, Hkv, BS]; table [B, max_blocks]
    int32, the pool block of each logical block of each row (entries past a
    row's length are arbitrary: the row's length masks them). The layers of
    one engine share one table tensor."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_kv_cache(
    num_blocks: int,
    block_size: int,
    n_kv_heads: int,
    head_dim: int,
    batch: int,
    max_blocks_per_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str | None = None,
    table: torch.Tensor | None = None,
) -> PagedKVCache:
    """Zeroed pools (bf16, or int8 with zeroed f32 scale pools) and a zeroed
    table, or `table` where the caller shares one between layers."""
    if block_size % 128:
        raise ValueError(f"block_size {block_size} must be a multiple of 128")
    device = resolve(device)
    shape = (num_blocks, n_kv_heads, block_size, head_dim)
    if table is None:
        table = torch.zeros((batch, max_blocks_per_seq), dtype=torch.int32, device=device)
    elif table.shape != (batch, max_blocks_per_seq) or table.dtype != torch.int32:
        raise ValueError(f"table must be int32 [{batch}, {max_blocks_per_seq}]")
    scales = {}
    if dtype == torch.int8:
        scales = dict(k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
                      v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device))
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device), table=table, **scales)


def paged_write(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                pos) -> PagedKVCache:
    """Write ONE token per row, IN PLACE, at (table[p // bs], :, p % bs).
    k_new/v_new [B, 1, Hkv, D]; pos an int or a [B] tensor, the logical
    position of the new token (a position past the table's last slot writes
    that slot, `decode_at`), or the step's `DecodeAt`. An int8 pool stores
    the quantized values and their scales (`write_token`). Returns
    `cache`."""
    if not isinstance(pos, DecodeAt):
        b = k_new.shape[0]
        pos = decode_at(cache, torch.as_tensor(pos, device=cache.k.device).reshape(-1).expand(b))
    return write_token(cache, pos.index, k_new[:, 0], v_new[:, 0])


def _as_blocks(leaf: torch.Tensor, n_blocks: int, bs: int) -> torch.Tensor:
    """Dense rows [R, Hkv, L(, D)] cut into [R * n_blocks, Hkv, bs(, D)]
    blocks of their first n_blocks * bs positions, zero-padded where the
    rows are shorter than whole blocks."""
    want = n_blocks * bs
    sl = leaf[:, :, :want]
    if sl.shape[2] < want:
        pad = (0, 0) * (leaf.dim() - 3) + (0, want - sl.shape[2])
        sl = F.pad(sl, pad)
    r, hkv = leaf.shape[:2]
    sl = sl.reshape(r, hkv, n_blocks, bs, *leaf.shape[3:]).transpose(1, 2)
    return sl.reshape(r * n_blocks, hkv, bs, *leaf.shape[3:])


def paged_insert_rows(cache: PagedKVCache, dense: KVCache, blocks: torch.Tensor) -> PagedKVCache:
    """Copy the first nb * block_size positions of every row of the dense
    cache into pool blocks `blocks` ([R, nb] integer pool ids, rows padded
    with block 0, the caller's trash block), IN PLACE: one indexed assignment
    per leaf (the hand-off of a prefill from the dense scratch,
    `eetq_tpu/serve/engine.py:556-584`). Returns `cache`."""
    if cache.quantized and not dense.quantized:
        raise ValueError("int8 paged pool needs an int8 dense scratch")
    nb, bs = blocks.shape[1], cache.block_size
    idx = blocks.reshape(-1).long()
    cache.k[idx] = _as_blocks(dense.k, nb, bs).to(cache.k.dtype)
    cache.v[idx] = _as_blocks(dense.v, nb, bs).to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[idx] = _as_blocks(dense.k_scale, nb, bs)
        cache.v_scale[idx] = _as_blocks(dense.v_scale, nb, bs)
    return cache


def paged_insert_dense(cache: PagedKVCache, dense: KVCache, src_row: int, blocks: torch.Tensor,
                       n_blocks: int) -> PagedKVCache:
    """Copy the first n_blocks * block_size positions of dense cache row
    `src_row` into pool blocks `blocks` ([n_blocks] pool ids), IN PLACE.
    Returns `cache`."""
    row = KVCache(*(None if t is None else t[src_row:src_row + 1]
                    for t in (dense.k, dense.v, dense.k_scale, dense.v_scale)))
    return paged_insert_rows(cache, row, blocks[:n_blocks].reshape(1, n_blocks))


def paged_gather_dense(cache: PagedKVCache, max_len: int) -> KVCache:
    """The logical dense [B, Hkv, L, D] view, gathered through the table:
    the oracle of the paged path."""
    tbl = cache.table[:, :max_len // cache.block_size]
    return KVCache(
        k=gather_pool(cache.k, tbl), v=gather_pool(cache.v, tbl),
        k_scale=None if cache.k_scale is None else gather_pool(cache.k_scale, tbl),
        v_scale=None if cache.v_scale is None else gather_pool(cache.v_scale, tbl),
    )


def paged_attention_decode(q: torch.Tensor, cache: PagedKVCache, lengths,
                           window: int | None = None, use_kernel: bool = True) -> torch.Tensor:
    """One decode step over a paged cache. q [B, 1, Hq, D]; lengths an int
    or [B], the valid positions INCLUDING the token just written.
    use_kernel=False gathers the dense view and runs the plain decode
    attention."""
    scale = q.shape[-1] ** -0.5
    lengths = _lengths(lengths, q.shape[0], q.device)
    if not use_kernel:
        dense = paged_gather_dense(cache, cache.table.shape[1] * cache.block_size)
        if cache.quantized:
            return flash_decode_int8_ref(q, dense.k, dense.v, dense.k_scale, dense.v_scale,
                                         lengths, scale, window)
        return flash_decode_ref(q, dense.k, dense.v, lengths, scale, window)
    if cache.quantized:
        return paged_flash_decode_int8(q, cache.k, cache.v, cache.k_scale, cache.v_scale,
                                       cache.table, lengths, scale=scale, window=window)
    return paged_flash_decode(q, cache.k, cache.v, cache.table, lengths, scale=scale,
                              window=window)
