"""Flash-attention forward: causal prefill attention with GQA.

`flash_attention` replaces `eetq_tpu/kernels/flash_attention.py::
_flash_forward` (`pallas_call` at flash_attention.py:240) with the CUDA
kernel `csrc/flash_attention.cu`. At llama2-7b prefill (S = 1024, 32 heads,
D = 128) it is bound by tensor-core FLOPs, 4*S*S*D*H/2 = 8.6 GFLOP per layer
with causal skipping, while its bytes are small (q, k, v, 25 MB per layer,
read once per q-tile). The design keeps the S x S scores out of device memory: one block
per (batch, q head, q tile of 128 rows: two warpgroups, or 64 rows where
the grid would not fill the card) loops over 64-key tiles that `cp.async`
brings into a three-stage ring of swizzled shared memory, with `wgmma` for
q.k (q in registers) and for p.v (p in registers, v read transposed through
the instruction's descriptor: no copy of v) and an online softmax in f32
registers; it skips tiles above the diagonal, maps q head h to kv head
h // group with no K/V copy, and reads q/k/v in the module's [B, S, H, D]
layout through strides (the TPU version padded and transposed to
[B, H, S, D] for its tiling).

Masking uses -0.7 * f32max, not -inf, and rows whose sum is 0 divide by 1,
as the TPU kernel does (flash_attention.py:24-25, :131).

Two variants are compiled apart from the plain body, as template flags of
the same kernel (flash_attention.py:51-58, :70-86, :119-125): a sliding
window (`window`: row p sees keys p - window < key <= p; the tiles wholly
left of a block's windows are never loaded) and ALiBi (`slopes` [Hq] f32:
slope_h * (key - p) added to the scaled scores before the mask). Any GQA
group runs, the kv head of q head h being h // group.

Head dims 64, 128 and 256 (gemma-7b). At 256 the kernel keeps the scaled q
tile in shared memory as the S = q k^T product's A operand, beside a
two-stage K/V ring, where the narrower head dims hold q in registers: the
output accumulator of a 256-wide head takes 128 registers a thread.

Under grad (grad mode on and q, k, v or the slopes requiring grad) the call
runs inside `FlashAttention`, a `torch.autograd.Function` whose forward is
the same kernel launch (the plain version for CPU tensors) and whose
backward is `flash_attention_bwd_ref`, the JAX package's recompute-based
flash-2 backward (`_flash_vjp`, `_flash_vjp_noalibi` over `_bwd_chunked`,
flash_attention.py:283-427) in plain torch: it saves q, k, v and the
output, and no S x S tensor. The ALiBi slopes are model constants and get
a zero gradient, as in the JAX package (:156-160).
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.utils.device import resolve

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
HEAD_DIMS = (64, 128, 256)
BWD_CHUNK = 256  # keys a step of the backward (`eetq_tpu/kernels/flash_attention.py:280`)
# The variants a launch counts beside its total (`count_launch`): a sliding
# window, ALiBi, a GQA group other than 1, 2, 4, 8 (qwen2-7b's 7,
# chatglm3-6b's 16), and head dim 256 (gemma-7b)
VARIANTS = ("window", "alibi", "group", "d256")
BASE_GROUPS = (1, 2, 4, 8)


def count_launch(fn, window, slopes, group: int, d: int) -> None:
    """One launch of the attention kernel behind wrapper `fn`: its count, and
    the count of each variant it ran."""
    fn.launches += 1
    for name, on in zip(VARIANTS, (window is not None, slopes is not None,
                                   group not in BASE_GROUPS, d == 256)):
        fn.variant_launches[name] += on


def alibi_bias(slopes: torch.Tensor, hkv: int, key_pos: torch.Tensor,
               query_pos: torch.Tensor) -> torch.Tensor:
    """slope_h * (key_pos - query_pos) in f32 for scores [B, Hkv, G, S, L]
    (`eetq_tpu/modules/attention.py:172-178`); the positions broadcast to
    [S, L] or [B, 1, 1, S, L]."""
    return slopes.float().reshape(1, hkv, -1, 1, 1) * (key_pos - query_pos).float()


def causal_mask(
    s: int,
    window: int | None = None,
    kv_len: int | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """[1, 1, s, kv_len] bool causal mask (True = attend), optionally
    sliding-window. With kv_len > s the last query aligns with the last key
    (query row i sits at position i + kv_len - s). On the card unless
    `device` says otherwise."""
    device = resolve(device)
    l = kv_len if kv_len is not None else s
    i = torch.arange(s, device=device)[:, None] + (l - s)
    j = torch.arange(l, device=device)[None, :]
    m = j <= i
    if window is not None:
        m &= j > i - window
    return m[None, None]


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None,
    scale: float,
    slopes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Masked softmax attention in f32. q [B, S, Hq, D], k/v [B, L, Hkv, D],
    mask broadcastable to [B, 1, S, L] (True = attend). slopes [Hq]: the
    ALiBi bias slope_h * (key_pos - query_pos), the last query on the last
    key. Returns q.dtype."""
    b, s, hq, d = q.shape
    hkv, l = k.shape[2], k.shape[1]
    qg = q.float().reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k.float()) * scale
    if slopes is not None:
        pos = torch.arange(l, device=q.device)
        scores = scores + alibi_bias(slopes, hkv, pos[None], pos[l - s:, None])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, :, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def flash_attention_ref(q, k, v, causal=True, scale=None, window=None, slopes=None):
    """Plain version of :func:`flash_attention`. It rounds where the kernels
    (this one and the TPU one) round: q * scale to bf16 before q.k, and the
    unnormalised probabilities to bf16 before p.v; the max, the sum and the
    division stay in f32. The ALiBi bias is added to the scaled scores
    before the mask."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, s, hq, d = q.shape
    hkv, l = k.shape[2], k.shape[1]
    qg = (q.float() * scale).to(q.dtype).float().reshape(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k.float())
    if slopes is not None:
        pos = torch.arange(l, device=q.device)
        scores = scores + alibi_bias(slopes, hkv, pos[None], pos[l - s:, None])
    if causal or window is not None:
        mask = causal_mask(s, window, k.shape[1], q.device)
        scores = scores.masked_fill(~mask[:, :, None], MASK_VALUE)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgsl,blkd->bskgd", p.to(q.dtype).float(), v.float())
    out = out / torch.where(l == 0, 1.0, l).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, hq, d).to(q.dtype)


def _check_qkv(q, k, v):
    b, sq, hq, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"{name} must be bf16 on q's device")
        if t.dim() != 4 or t.shape[0] != b or t.shape[-1] != d or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [B, S, H, D] with unit stride in D")
        if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned")
    if k.shape != v.shape or hq % k.shape[2] or sq < 1 or k.shape[1] < 1:
        raise ValueError(f"bad GQA shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")


def check_variant(q, window, slopes) -> None:
    """The window (None or >= 1) and the ALiBi slopes (None or f32 [Hq] on
    q's device) of an attention kernel call."""
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    if slopes is not None and (slopes.dtype != torch.float32 or slopes.shape != (q.shape[2],)
                               or not slopes.is_contiguous() or slopes.device != q.device):
        raise TypeError(f"slopes must be contiguous f32 [{q.shape[2]}] on q's device")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    window: int | None = None,
    slopes: torch.Tensor | None = None,
) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D] with Hq % Hkv == 0, any
    strides with D contiguous. Causal masking aligns the last query with the
    last key (delta = Skv - Sq); under `window` row p sees only the keys
    p - window < key; `slopes` [Hq] f32 adds ALiBi. Returns a contiguous
    [B, Sq, Hq, D]; differentiable in q, k and v (`FlashAttention`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, slopes)):
        return FlashAttention.apply(q, k, v, slopes, causal, scale, window)
    return _forward(q, k, v, causal, scale, window, slopes)


def _forward(q, k, v, causal: bool, scale: float, window, slopes) -> torch.Tensor:
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal, scale, window, slopes)
    _check_qkv(q, k, v)
    check_variant(q, window, slopes)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, d), dtype=torch.bfloat16, device=q.device)
    _build.launch(
        "eetq_flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, skv, hq, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        scale, int(causal), _build.ptr(slopes), window or 0, _build.stream_of(q),
    )
    count_launch(flash_attention, window, slopes, hq // hkv, d)
    return out


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with the recompute-based flash-2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, causal: bool, scale: float, window):
        out = _forward(q, k, v, causal, scale, window, slopes)
        ctx.save_for_backward(q, k, v, out, slopes)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, slopes = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, do, ctx.causal, ctx.scale,
                                             ctx.window, slopes)
        # the slopes are frozen model constants: a zero gradient by design
        d_slopes = torch.zeros_like(slopes) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, d_slopes, None, None, None


def flash_attention_bwd_ref(q, k, v, out, do, causal: bool = True, scale: float | None = None,
                            window: int | None = None, slopes: torch.Tensor | None = None):
    """(dq, dk, dv) of :func:`flash_attention` at output `out` and output
    gradient `do` [B, Sq, Hq, D], in the inputs' dtypes: the JAX package's
    `_bwd_chunked` (`eetq_tpu/kernels/flash_attention.py:283-385`) in f32,
    over chunks of BWD_CHUNK keys (the keys padded to a whole chunk, the
    padding masked), never an [Sq, Skv] score matrix. Pass 1 takes each
    row's logsumexp, pass 2 its probabilities again per chunk, accumulating
    dq and producing that chunk's dk and dv. The mask is the forward's:
    causal with the last query on the last key (delta = Skv - Sq), the
    sliding window, and the ALiBi bias slope_h (key - p) on the scaled
    scores; masked scores hold MASK_VALUE."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    c = min(BWD_CHUNK, skv)
    nc = -(-skv // c)

    def heads(t):  # [B, S, H, D] -> f32 [B, H, S, D]
        return t.float().permute(0, 2, 1, 3)

    qg = (heads(q) * scale).reshape(b, hkv, g, sq, d)  # the scale folded into q
    dog = heads(do).reshape(b, hkv, g, sq, d)
    pad = (0, 0, 0, nc * c - skv)
    kc = torch.nn.functional.pad(heads(k), pad).split(c, dim=2)  # nc x [B, Hkv, c, D]
    vc = torch.nn.functional.pad(heads(v), pad).split(c, dim=2)
    row = torch.arange(sq, device=q.device)[:, None] + (skv - sq)  # the key a row aligns with
    sl = None if slopes is None else slopes.float().reshape(1, hkv, g, 1, 1)

    def scores(ci):
        col = torch.arange(c, device=q.device)[None, :] + ci * c
        s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kc[ci])
        if sl is not None:
            s = s + sl * (col - row).float()
        mask = col < skv
        if causal or window is not None:
            mask = mask & (col <= row)
        if window is not None:
            mask = mask & (col > row - window)
        return torch.where(mask, s, MASK_VALUE)

    m = torch.full((b, hkv, g, sq), MASK_VALUE, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    for ci in range(nc):  # pass 1: the logsumexp of each row
        s = scores(ci)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(dim=-1)
        m = m_new
    lse = m + torch.log(torch.where(l == 0.0, 1.0, l))
    dsum = (dog * heads(out).reshape(b, hkv, g, sq, d)).sum(dim=-1)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for ci in range(nc):  # pass 2: dq accumulated, dk and dv a chunk at a time
        p = torch.exp(scores(ci) - lse[..., None])  # masked -> 0
        dvs.append(torch.einsum("bkgqc,bkgqd->bkcd", p, dog))
        dp = torch.einsum("bkgqd,bkcd->bkgqc", dog, vc[ci])
        ds = p * (dp - dsum[..., None])
        dq += torch.einsum("bkgqc,bkcd->bkgqd", ds, kc[ci])
        dks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qg))
    dq = (dq * scale).reshape(b, hq, sq, d).permute(0, 2, 1, 3)
    dk = torch.cat(dks, dim=2)[:, :, :skv].permute(0, 2, 1, 3)
    dv = torch.cat(dvs, dim=2)[:, :, :skv].permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention.launches = 0
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)
