"""Flash-decode: S query tokens per row over the dense [B, Hkv, L, D] cache,
or over a paged cache (block pools and a block table). S = 1 is the decode
step; S > 1 the multi-query verify of speculative decoding, query token i
of a row at position length - S + i, seeing the keys at or before it
(`eetq_tpu/kernels/flash_decode.py::_fd_kernel` with sq > 1). Token i of an
S-token call is bit-equal to an S = 1 call at length - S + i + 1.

`flash_decode` and `flash_decode_int8` replace `eetq_tpu/kernels/
flash_decode.py::flash_decode` (`pallas_call` at flash_decode.py:512),
over a bf16 cache and over an int8 cache with f32 [B, Hkv, L]
scales, with the CUDA kernel of `csrc/flash_decode.cu`. They are bound by
KV-cache bytes: a bf16 step reads 2 * length * D * 2 bytes per kv head
(16.8 MB per llama2-7b layer at length 1024) and does about 2 FLOPs per
byte, far below the card's balance point. The design reads only each
row's live keys, once, for the whole GQA group of a kv head. The key range
of a row is cut into chunks at fixed multiples
(`kernels/autotune.py::decode_plan`, a function of the shapes alone); a
block takes one chunk of one (row, kv head), returns at once where the
chunk lies past the row's length (this replaces the TPU
index-map clamp, flash_decode.py:459-474), stages its keys through shared
memory in tiles and keeps an online softmax in f32. The last block of a
row's live chunks merges their states in chunk order, in the same launch:
one launch per call, the same output from launch to launch, and the
lengths never read on the host. A block scores the query rows of its kv
head (G heads times S tokens, up to `autotune.max_query_rows(D)` of
them, a row block) against each staged tile, so S tokens cost one read of
the keys a row block; more rows take more row blocks, each row bit-equal
whichever block holds it.

`paged_flash_decode` and `paged_flash_decode_int8` replace `eetq_tpu/kernels/
flash_decode.py::paged_flash_decode` (`pallas_call` at flash_decode.py:329):
the same computation over pools [NB, Hkv, BS, D] shared by all
rows, logical block i of row b being pool block table[b, i]. As on the TPU
it is the dense kernel with another address map (a template mode of
`csrc/flash_decode.cu`): each tile of keys is translated through the table,
and only pool blocks holding keys below the row's length are read, wherever
they lie in the pool. Dense and paged run the same plan in
the same order: on a cache gathered through the table their outputs are
bit-equal. The bound is the same as the dense kernel's: the bytes of each
row's live keys.

Every entry point takes a sliding window (`window`: a token at position p
sees the keys p - window < key <= p, flash_decode.py:116-118, :139-149) and
ALiBi (`slopes` [Hq] f32: slope_h * (key - p) added to the scaled scores,
after an int8 key's scale, :170-181), each a variant compiled apart from the
plain body. Under a window only the chunks and tiles that hold a row's
window are read: the others return or are skipped, as the TPU index maps
clamp them (:459-474). Any GQA group and any count of query tokens run, as
in the TPU kernel (:362): a launch cuts the query rows (q heads times query
tokens) of a kv head into row blocks of `autotune.max_query_rows(D)`, 64
at head dims 64 and 128 and 32 at 256 (gemma-7b).
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.kernels.autotune import decode_plan
from eetq_tpu_torch.kernels.flash_attention import (
    VARIANTS,
    alibi_bias,
    check_variant,
    count_launch,
)

HEAD_DIMS = (64, 128, 256)


def flash_decode_ref(q, k_cache, v_cache, lengths, scale=None, window=None, slopes=None):
    """Plain version: q [B, S, Hq, D] against cache[:, :, :length] in f32,
    per-row causal: query token i of a row sits at position length - S + i
    and sees the keys at or before it (`eetq_tpu/modules/attention.py::
    attention_verify_ref`; S = 1 is the decode step), under a window only
    the last `window` of them; slopes [Hq] adds the ALiBi bias slope_h *
    (key - position) to the scaled scores. lengths is an int or a [B]
    tensor of valid entries (the S new tokens' K/V already written at
    length - S .. length - 1). A query token that sees no key gives 0, as
    the kernels do."""
    b, s, hq, d = q.shape
    hkv, l = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,bkld->bkgsl", qg, k_cache.float()) * scale
    pos = torch.arange(l, device=q.device).reshape(1, 1, 1, 1, l)
    lv = torch.as_tensor(lengths, device=q.device).reshape(-1, 1, 1, 1, 1)
    # query token i at position lv - s + i
    qpos = lv - s + torch.arange(s, device=q.device).reshape(1, 1, 1, s, 1)
    if slopes is not None:
        scores = scores + alibi_bias(slopes, hkv, pos, qpos)
    mask = pos <= qpos
    if window is not None:
        mask &= pos > qpos - window
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    probs = probs.masked_fill(~mask.any(dim=-1, keepdim=True), 0.0)
    out = torch.einsum("bkgsl,bkld->bskgd", probs, v_cache.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def _check(q, k_cache, v_cache, lengths, window, slopes, cache_dtype, batch_axis: bool = True):
    """k/v cache [B, Hkv, L, D], or with batch_axis=False pools
    [NB, Hkv, BS, D] shared by all rows."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[1]
    check_variant(q, window, slopes)
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise TypeError("q must be contiguous bf16")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != cache_dtype or not t.is_contiguous() or t.device != q.device:
            raise TypeError(f"{name} must be contiguous {cache_dtype} on q's device")
    if (k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or (batch_axis and k_cache.shape[0] != b) or k_cache.shape[-1] != d):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if (lengths.dtype != torch.int32 or lengths.shape != (b,) or not lengths.is_contiguous()
            or lengths.device != q.device):
        raise TypeError("lengths must be contiguous int32 [B] on q's device")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("q and the caches must be 16-byte aligned")
    if hq % hkv:
        raise ValueError(f"{hq} q heads do not group over {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")


def _launch_args(q, hkv, max_len, out=None):
    """(out, partials, counters, chunk) of one launch over a cache of
    `max_len` keys a row: the plan of (q heads of a group) x S query rows a
    kv head, whose chunks are those of any S. out: the caller's buffer for
    the output (contiguous bf16 of q's shape on its device), else a new
    one."""
    b, s, hq, d = q.shape
    plan = decode_plan(b, hkv, hq // hkv * s, max_len, d)
    partials, counters = _build.scratch("decode", q.device, plan.floats, plan.counters)
    if out is None:
        out = torch.empty((b, s, hq, d), dtype=torch.bfloat16, device=q.device)
    elif (out.shape != q.shape or out.dtype != torch.bfloat16 or not out.is_contiguous()
          or out.device != q.device or out.data_ptr() % 16):
        raise TypeError("out must be contiguous 16-byte aligned bf16 of q's shape on its device")
    return out, partials, counters, plan.chunk


def _into(out: torch.Tensor | None, result: torch.Tensor) -> torch.Tensor:
    """The plain version's result, copied into the caller's `out` if given."""
    return result if out is None else out.copy_(result)


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    scale: float | None = None,
    window: int | None = None,
    slopes: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """q [B, S, Hq, D] bf16; k/v cache [B, Hkv, L, D] bf16; lengths [B]
    int32 valid entries per row (S <= length <= L), query token i at
    position length - S + i; a sliding `window`, ALiBi `slopes` [Hq] f32;
    `out`, a buffer of the output's shape to write (a new tensor where none
    is given).
    Returns [B, S, Hq, D]."""
    _build.refuse_grad("flash_decode", q, k_cache, v_cache, slopes)
    b, s, hq, d = q.shape
    hkv, l = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    if not q.is_cuda:
        return _into(out, flash_decode_ref(q, k_cache, v_cache, lengths, scale, window, slopes))
    _check(q, k_cache, v_cache, lengths, window, slopes, torch.bfloat16)
    out, partials, counters, chunk = _launch_args(q, hkv, l, out)
    _build.launch(
        "eetq_flash_decode", q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), partials, counters, b, s, hq, hkv, l, d, chunk,
        scale, _build.ptr(slopes), window or 0, _build.stream_of(q),
    )
    count_launch(flash_decode, window, slopes, hq // hkv, d)
    return out


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [..., L, D] with f32 [..., L] scales -> bf16, multiplied in bf16
    (`eetq_tpu/modules/attention.py:86-87`)."""
    return q.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def flash_decode_int8_ref(q, k_cache, v_cache, k_scale, v_scale, lengths, scale=None,
                          window=None, slopes=None):
    """Plain version of :func:`flash_decode_int8`: dequantise the cache in
    bf16, then attend as :func:`flash_decode_ref` (the JAX package's
    `attention_decode_ref` on an int8 cache)."""
    return flash_decode_ref(q, dequantize_kv(k_cache, k_scale),
                            dequantize_kv(v_cache, v_scale), lengths, scale, window, slopes)


def flash_decode_int8(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    scale: float | None = None,
    window: int | None = None,
    slopes: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """q [B, S, Hq, D] bf16; k/v cache [B, Hkv, L, D] int8 with f32 scales
    k_scale/v_scale [B, Hkv, L]; lengths [B] int32 (S <= length <= L), as
    :func:`flash_decode`. Returns [B, S, Hq, D] bf16."""
    _build.refuse_grad("flash_decode_int8", q, k_scale, v_scale, slopes)
    b, s, hq, d = q.shape
    hkv, l = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    if not q.is_cuda:
        return _into(out, flash_decode_int8_ref(q, k_cache, v_cache, k_scale, v_scale, lengths,
                                                scale, window, slopes))
    _check(q, k_cache, v_cache, lengths, window, slopes, torch.int8)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.dtype != torch.float32 or t.shape != k_cache.shape[:3] or not t.is_contiguous()
                or t.device != q.device):
            raise TypeError(f"{name} must be contiguous f32 [B, Hkv, L] on q's device")
    out, partials, counters, chunk = _launch_args(q, hkv, l, out)
    _build.launch(
        "eetq_flash_decode_int8", q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), partials,
        counters, b, s, hq, hkv, l, d, chunk, scale, _build.ptr(slopes), window or 0,
        _build.stream_of(q),
    )
    count_launch(flash_decode_int8, window, slopes, hq // hkv, d)
    return out


def gather_pool(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The dense view of a paged leaf: pool [NB, Hkv, BS(, D)] gathered
    through table [B, nb] -> [B, Hkv, nb * BS(, D)]."""
    blocks = pool[table.long()]  # [B, nb, Hkv, BS, ...]
    moved = blocks.transpose(1, 2)  # [B, Hkv, nb, BS, ...]
    return moved.reshape(moved.shape[0], moved.shape[1], -1, *moved.shape[4:])


def paged_flash_decode_ref(q, k_pool, v_pool, table, lengths, scale=None, window=None,
                           slopes=None):
    """Plain version of :func:`paged_flash_decode`: gather the logical dense
    cache through the table, then :func:`flash_decode_ref`. Table entries
    past a row's length must still be valid pool indices here (the kernel
    never reads them)."""
    return flash_decode_ref(q, gather_pool(k_pool, table), gather_pool(v_pool, table), lengths,
                            scale, window, slopes)


def paged_flash_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale, table, lengths,
                                scale=None, window=None, slopes=None):
    """Plain version of :func:`paged_flash_decode_int8`: gather, then
    :func:`flash_decode_int8_ref`."""
    return flash_decode_int8_ref(
        q, gather_pool(k_pool, table), gather_pool(v_pool, table),
        gather_pool(k_scale, table), gather_pool(v_scale, table), lengths, scale, window, slopes)


def _check_paged(q, k_pool, v_pool, table, lengths, window, slopes, cache_dtype):
    """The dense checks (the pools have no batch axis), then the table."""
    b = q.shape[0]
    bs = k_pool.shape[2]
    _check(q, k_pool, v_pool, lengths, window, slopes, cache_dtype, batch_axis=False)
    if (table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != b
            or not table.is_contiguous() or table.device != q.device):
        raise TypeError("table must be contiguous int32 [B, max_blocks] on q's device")
    if bs % 128 or bs < 128:
        raise ValueError(f"block size {bs} must be a multiple of 128 (a tile of keys must not "
                         "straddle two pool blocks)")


def paged_flash_decode(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor,
    scale: float | None = None,
    window: int | None = None,
    slopes: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """q [B, S, Hq, D] bf16; k/v pools [NB, Hkv, BS, D] bf16; table
    [B, max_blocks] int32, entry (b, i) the pool block of keys [i * BS,
    (i + 1) * BS) of row b (used only for blocks below the row's length, each
    in [0, NB): the kernel cannot check them); lengths [B] int32 (S <= length
    <= max_blocks * BS), as :func:`flash_decode`. Returns [B, S, Hq, D] bf16."""
    _build.refuse_grad("paged_flash_decode", q, k_pool, v_pool, slopes)
    b, s, hq, d = q.shape
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    if scale is None:
        scale = d ** -0.5
    if not q.is_cuda:
        return _into(out, paged_flash_decode_ref(q, k_pool, v_pool, table, lengths, scale,
                                                 window, slopes))
    _check_paged(q, k_pool, v_pool, table, lengths, window, slopes, torch.bfloat16)
    max_blocks = table.shape[1]
    out, partials, counters, chunk = _launch_args(q, hkv, max_blocks * bs, out)
    _build.launch(
        "eetq_paged_flash_decode", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(), partials, counters, b, s, hq,
        hkv, max_blocks, bs, d, chunk, scale, _build.ptr(slopes), window or 0,
        _build.stream_of(q),
    )
    count_launch(paged_flash_decode, window, slopes, hq // hkv, d)
    return out


def paged_flash_decode_int8(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor,
    scale: float | None = None,
    window: int | None = None,
    slopes: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`paged_flash_decode` over int8 pools [NB, Hkv, BS, D] with f32
    scale pools k_scale/v_scale [NB, Hkv, BS]."""
    _build.refuse_grad("paged_flash_decode_int8", q, k_scale, v_scale, slopes)
    b, s, hq, d = q.shape
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    if scale is None:
        scale = d ** -0.5
    if not q.is_cuda:
        return _into(out, paged_flash_decode_int8_ref(q, k_pool, v_pool, k_scale, v_scale, table,
                                                      lengths, scale, window, slopes))
    _check_paged(q, k_pool, v_pool, table, lengths, window, slopes, torch.int8)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.dtype != torch.float32 or t.shape != k_pool.shape[:3] or not t.is_contiguous()
                or t.device != q.device):
            raise TypeError(f"{name} must be contiguous f32 [NB, Hkv, BS] on q's device")
    max_blocks = table.shape[1]
    out, partials, counters, chunk = _launch_args(q, hkv, max_blocks * bs, out)
    _build.launch(
        "eetq_paged_flash_decode_int8", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), partials, counters, b, s, hq, hkv, max_blocks, bs, d, chunk, scale,
        _build.ptr(slopes), window or 0, _build.stream_of(q),
    )
    count_launch(paged_flash_decode_int8, window, slopes, hq // hkv, d)
    return out


for _fn in (flash_decode, flash_decode_int8, paged_flash_decode, paged_flash_decode_int8):
    _fn.launches = 0
    _fn.variant_launches = dict.fromkeys(VARIANTS, 0)
del _fn
