"""Ring attention: causal attention with the sequence sharded over ranks.

Port of `eetq_tpu/dist/ring_attention.py`. q, k and v are split along the
sequence over the ranks of a mesh axis, chunk i on the rank of index i.
Each rank computes its queries' unnormalised attention against the KV chunk
it holds, with the online softmax's statistics (m, l), then passes the
chunk on to the next rank of the ring (`Mesh.ppermute`) and merges the
next chunk's statistics flash-2 style; after p rotations every query has
seen every key. Causality at chunk granularity: query chunk i attends KV
chunk j <= i, the diagonal chunk with the elementwise mask; chunks above
the diagonal, and under a sliding window chunks wholly before every local
query's window, are skipped (judged by the first local row, which has the
earliest window), while the ring still advances.

The JAX package computes these statistics in jnp, outside any Pallas
kernel, and so does this port: plain torch in f32 over the bf16 values
(bf16 products are exact in f32), the same arithmetic as the JAX einsums
with f32 accumulation. There is no kernel here.

A rank calls `ring_attention` with its local chunks;
`ring_attention_sharded` takes the full [B, S, H, D] tensors on every rank,
runs the rank's chunk and gathers the result.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.dist.sharding import MODEL_AXIS, Mesh

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _chunk_attn_stats(q, k, v, mask, scale, bias=None):
    """Unnormalised attention over one KV chunk with its softmax statistics
    (`eetq_tpu/dist/ring_attention.py:33-60`). q [B, Sq, Hq, D]; k, v
    [B, Skv, Hkv, D]; mask None or broadcastable to [B, Hq, Sq, Skv]
    (True = attend); bias (ALiBi) broadcastable to the same, added to the
    scaled scores before the mask. Returns (o [B, Sq, Hq, D] f32, m
    [B, Hq, Sq] f32, l [B, Hq, Sq] f32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    # q heads h = kv g + i grouped with their kv head: [B, Hkv, G Sq, D]
    qg = q.float().permute(0, 2, 1, 3).reshape(b, hkv, g * sq, d)
    s = torch.matmul(qg, k.float().permute(0, 2, 3, 1)).reshape(b, hq, sq, skv)
    s.mul_(scale)
    if bias is not None:
        s.add_(bias)
    if mask is not None:
        s.masked_fill_(~mask, NEG_INF)
    m = s.amax(dim=-1)
    p = s.sub_(m[..., None]).exp_()
    l = p.sum(dim=-1)
    o = torch.matmul(p.reshape(b, hkv, g * sq, skv), v.float().permute(0, 2, 1, 3))
    return o.reshape(b, hq, sq, d).permute(0, 2, 1, 3), m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two online-softmax partial results (the flash-2 combine,
    `eetq_tpu/dist/ring_attention.py:63-72`)."""
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)

    def scale_o(o, a):  # [B, Hq, Sq] statistics onto [B, Sq, Hq, D] outputs
        return o * a.transpose(1, 2)[..., None]

    return scale_o(o1, a1) + scale_o(o2, a2), m, l1 * a1 + l2 * a2


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis_name: str = MODEL_AXIS, causal: bool = True, scale: float | None = None,
                   slopes: torch.Tensor | None = None, window: int | None = None) -> torch.Tensor:
    """Sequence-sharded attention, called on every rank of `axis_name` with
    its local chunks (chunk index = the rank's index on the axis;
    `eetq_tpu/dist/ring_attention.py:75-158`). q [B, Sq_local, Hq, D]; k, v
    [B, Skv_local, Hkv, D]. slopes [Hq] adds the ALiBi bias slope_h *
    (col - row) in global positions; window: causal sliding-window
    attention (col > row - window). Returns [B, Sq_local, Hq, D] in q's
    dtype. Each of the p steps rotates k and v one rank on (two
    ppermutes)."""
    p, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = 1.0 / d ** 0.5
    dev = q.device
    qf = q.to(torch.bfloat16)
    row = torch.arange(sq, device=dev)[:, None]
    col = torch.arange(skv, device=dev)[None, :]
    o = torch.zeros((b, sq, hq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, sq), dtype=torch.float32, device=dev)
    kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
    perm = [(j, (j + 1) % p) for j in range(p)]
    for i in range(p):
        src = (idx - i) % p  # the global chunk of the KV held now
        run = True
        if causal:
            run = src <= idx
            if window is not None:
                # a chunk is dead when even its last col falls at or before
                # the first local row's window start (later rows start later)
                run = run and (src * skv + skv - 1) > (idx * sq - window)
        if run:
            row_g, col_g = idx * sq + row, src * skv + col
            bias = mask = None
            if slopes is not None:
                bias = (slopes.float()[None, :, None, None]
                        * (col_g - row_g).float()[None, None])
            if causal:
                mask = col_g <= row_g
                if window is not None:
                    mask &= col_g > row_g - window
                mask = mask[None, None]
            oc, mc, lc = _chunk_attn_stats(qf, kc, vc, mask, scale, bias=bias)
            o, m, l = _merge(o, m, l, oc, mc, lc)
        kc = mesh.ppermute(kc, axis_name, perm)
        vc = mesh.ppermute(vc, axis_name, perm)
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                           axis_name: str = MODEL_AXIS, causal: bool = True,
                           scale: float | None = None, slopes: torch.Tensor | None = None,
                           window: int | None = None) -> torch.Tensor:
    """q [B, S, Hq, D], k, v [B, S, Hkv, D], the same on every rank of
    `axis_name`: the rank's sequence chunk through `ring_attention`, the
    chunks gathered along S. Returns [B, S, Hq, D] on every rank
    (`eetq_tpu/dist/ring_attention.py:161-187`). S must divide by the axis
    size."""
    p, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    s = q.shape[1]
    if s % p or k.shape[1] % p:
        raise ValueError(f"sequence {s} not divisible by the {axis_name} axis size {p}")
    sl, kl = s // p, k.shape[1] // p
    out = ring_attention(q[:, idx * sl:(idx + 1) * sl], k[:, idx * kl:(idx + 1) * kl],
                         v[:, idx * kl:(idx + 1) * kl], mesh, axis_name, causal=causal,
                         scale=scale, slopes=slopes, window=window)
    return mesh.all_gather(out, 1, axis_name)
