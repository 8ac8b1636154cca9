"""Flash-decode: one query token per row over the dense [B, Hkv, L, D] cache.

`flash_decode` and `flash_decode_int8` replace `eetq_tpu/kernels/
flash_decode.py::flash_decode` (`pallas_call` at flash_decode.py:512) for
S = 1, over a bf16 cache and over an int8 cache with f32 [B, Hkv, L]
scales, with the CUDA kernels of `csrc/flash_decode.cu`. They are bound by
KV-cache bytes: a bf16 step reads 2 * length * D * 2 bytes per kv head
(16.8 MB per llama2-7b layer at length 1024) and does about 2 FLOPs per
byte, far below the card's balance point. The design reads only each
row's live prefix: blocks loop to the row's length (this replaces the TPU
index-map clamp, flash_decode.py:459-474), and every block computes the whole GQA group of its kv head, so each cached
key is read once. To cover the 132 SMs at batch 1 the cache is split along
L across blocks ("splits"); each block keeps an online softmax in f32 and
writes (max, sum, partial output), and a second kernel combines the splits.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.kernels.autotune import decode_splits

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)


def flash_decode_ref(q, k_cache, v_cache, lengths, scale=None, window=None):
    """Plain version: q [B, S, Hq, D] against cache[:, :, :length] in f32.
    lengths is an int or a [B] tensor of valid entries (the new token's K/V
    already written at length - 1)."""
    b, s, hq, d = q.shape
    hkv, l = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,bkld->bkgsl", qg, k_cache.float()) * scale
    pos = torch.arange(l, device=q.device).reshape(1, 1, 1, 1, l)
    lv = torch.as_tensor(lengths, device=q.device).reshape(-1, 1, 1, 1, 1)
    mask = pos < lv
    if window is not None:
        mask &= pos >= lv - window
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bkgsl,bkld->bskgd", probs, v_cache.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def _check(q, k_cache, v_cache, lengths, window, cache_dtype):
    b, s, hq, d = q.shape
    hkv = k_cache.shape[1]
    if s != 1:
        raise NotImplementedError("multi-query (S > 1) decode has no CUDA kernel yet")
    if window is not None:
        raise NotImplementedError("sliding-window decode has no CUDA kernel yet")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise TypeError("q must be contiguous bf16")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != cache_dtype or not t.is_contiguous() or t.device != q.device:
            raise TypeError(f"{name} must be contiguous {cache_dtype} on q's device")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[-1] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if (lengths.dtype != torch.int32 or lengths.shape != (b,) or not lengths.is_contiguous()
            or lengths.device != q.device):
        raise TypeError("lengths must be contiguous int32 [B] on q's device")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("q and the caches must be 16-byte aligned")
    group = hq // hkv
    if d not in HEAD_DIMS or group * hkv != hq or group not in GROUPS:
        raise NotImplementedError(f"head_dim {d}, group {hq}/{hkv}: the kernel takes {HEAD_DIMS}, {GROUPS}")


def _scratch(q, hkv, l):
    """(splits, split_len, part_o, part_ml, out) of one launch."""
    b, _, hq, d = q.shape
    group = hq // hkv
    splits, split_len = decode_splits(b * hkv, l, q.device)
    part_o = torch.empty(b * hkv * splits * group * d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(b * hkv * splits * group * 2, dtype=torch.float32, device=q.device)
    out = torch.empty((b, 1, hq, d), dtype=torch.bfloat16, device=q.device)
    return splits, split_len, part_o, part_ml, out


def flash_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """q [B, 1, Hq, D] bf16; k/v cache [B, Hkv, L, D] bf16; lengths [B]
    int32 valid entries per row (1 <= length <= L). Returns [B, 1, Hq, D]."""
    b, s, hq, d = q.shape
    hkv, l = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    if not q.is_cuda:
        return flash_decode_ref(q, k_cache, v_cache, lengths, scale, window)
    _check(q, k_cache, v_cache, lengths, window, torch.bfloat16)
    splits, split_len, part_o, part_ml, out = _scratch(q, hkv, l)
    _build.launch(
        "eetq_flash_decode", q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
        b, hq, hkv, l, d, splits, split_len, scale, _build.stream_of(q),
    )
    flash_decode.launches += 1
    return out


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 [..., L, D] with f32 [..., L] scales -> bf16, multiplied in bf16
    (`eetq_tpu/modules/attention.py:86-87`)."""
    return q.to(torch.bfloat16) * scale[..., None].to(torch.bfloat16)


def flash_decode_int8_ref(q, k_cache, v_cache, k_scale, v_scale, lengths, scale=None,
                          window=None):
    """Plain version of :func:`flash_decode_int8`: dequantise the cache in
    bf16, then attend as :func:`flash_decode_ref` (the JAX package's
    `attention_decode_ref` on an int8 cache)."""
    return flash_decode_ref(q, dequantize_kv(k_cache, k_scale),
                            dequantize_kv(v_cache, v_scale), lengths, scale, window)


def flash_decode_int8(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """q [B, 1, Hq, D] bf16; k/v cache [B, Hkv, L, D] int8 with f32 scales
    k_scale/v_scale [B, Hkv, L]; lengths [B] int32 (1 <= length <= L).
    Returns [B, 1, Hq, D] bf16."""
    b, s, hq, d = q.shape
    hkv, l = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    if not q.is_cuda:
        return flash_decode_int8_ref(q, k_cache, v_cache, k_scale, v_scale, lengths, scale,
                                     window)
    _check(q, k_cache, v_cache, lengths, window, torch.int8)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (t.dtype != torch.float32 or t.shape != k_cache.shape[:3] or not t.is_contiguous()
                or t.device != q.device):
            raise TypeError(f"{name} must be contiguous f32 [B, Hkv, L] on q's device")
    splits, split_len, part_o, part_ml, out = _scratch(q, hkv, l)
    _build.launch(
        "eetq_flash_decode_int8", q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), b, hq, hkv, l, d, splits, split_len, scale,
        _build.stream_of(q),
    )
    flash_decode_int8.launches += 1
    return out


flash_decode.launches = 0
flash_decode_int8.launches = 0
