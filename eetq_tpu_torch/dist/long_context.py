"""Long-context serving: the prompt prefilled with its sequence sharded over
ranks.

Port of `eetq_tpu/dist/long_context.py`. Each rank of a mesh axis holds the
whole model (the params are replicated: sequence parallelism trades
activation memory, not weight memory) and S / p contiguous prompt tokens;
it runs every layer on its chunk, the projections through the port's
`linear_apply` (the W8A16 GEMM on the card) and attention as ring attention
(`dist/ring_attention.py`). The last token's logits come from the rank of
index p - 1 (an all-gather, as in the JAX package), and each layer's K/V
chunks are all-gathered along the sequence and written into the dense
decode caches at offset 0, so that every rank holds the same caches;
`generate_long` then decodes through the port's `decode_loop` (captured in
a CUDA graph on the card), every rank decoding the same tokens.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.dist.ring_attention import ring_attention
from eetq_tpu_torch.dist.sharding import MODEL_AXIS, Mesh
from eetq_tpu_torch.kernels.mlp_fused import ACTIVATIONS
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, _gamma, _tied_head, init_caches
from eetq_tpu_torch.modules.attention import update_cache
from eetq_tpu_torch.modules.linear import linear_apply
from eetq_tpu_torch.ops.alibi import alibi_slopes_cache
from eetq_tpu_torch.ops.rmsnorm import rmsnorm
from eetq_tpu_torch.ops.rope import cos_sin_cache, rope
from eetq_tpu_torch.serve.sampling import rng_from, sample


def _norm(x: torch.Tensor, gamma: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rmsnorm(x, _gamma(gamma, cfg), eps=cfg.rms_eps)


def _sp_forward_local(params: ModelParams, tokens_local: torch.Tensor, cfg: ModelConfig,
                      mesh: Mesh, axis_name: str):
    """A rank's decoder forward over its chunk tokens_local [B, s_local]
    with ring attention (`eetq_tpu/dist/long_context.py:45-120`). Returns
    (the last token's logits [B, V] f32, the same on every rank; the local
    (k, v) [B, s_local, Hkv, D] of each layer)."""
    b, s_local = tokens_local.shape
    p, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    dev = tokens_local.device
    positions = (idx * s_local + torch.arange(s_local, device=dev))[None].expand(b, s_local)
    positions = positions.clamp(max=cfg.max_position - 1)
    x = params.embed[tokens_local].to(torch.bfloat16)
    if cfg.embedding_multiplier is not None:
        x = (x.float() * cfg.embedding_multiplier).to(x.dtype)
    cos_sin = cos_sin_cache(cfg.max_position, cfg.rot_dim, base=cfg.rope_theta, device=dev)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    slopes = alibi_slopes_cache(hq, dev) if cfg.alibi else None
    act = ACTIVATIONS[cfg.activation]
    kv_chunks = []
    for layer in params.layers:
        residual = x
        qkv = linear_apply(layer.qkv, _norm(x, layer.input_norm, cfg))
        q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
        q, k, v = q.reshape(b, s_local, hq, d), k.reshape(b, s_local, hkv, d), v.reshape(
            b, s_local, hkv, d)
        if not cfg.alibi:
            q = rope(q, positions, cos_sin, interleaved=cfg.rope_interleaved)
            k = rope(k, positions, cos_sin, interleaved=cfg.rope_interleaved)
        kv_chunks.append((k, v))
        attn = ring_attention(q, k, v, mesh, axis_name, causal=True, slopes=slopes,
                              window=cfg.sliding_window)
        x = residual + linear_apply(layer.o_proj, attn.reshape(b, s_local, hq * d))

        residual = x
        gate, up = torch.chunk(linear_apply(layer.gateup, _norm(x, layer.post_norm, cfg)), 2,
                               dim=-1)
        h = (act(gate.float()) * up.float()).to(x.dtype)
        x = residual + linear_apply(layer.down, h)

    # the logits of each rank's last token; the prompt's last is on rank p - 1
    x_last = _norm(x[:, -1:], params.final_norm, cfg)
    if params.lm_head is not None:
        logits = linear_apply(params.lm_head, x_last)
    else:
        logits = _tied_head(x_last, params.embed)
    last = mesh.all_gather(logits.float()[:, 0], 0, axis_name, tiled=False)[p - 1]
    return last, kv_chunks


@torch.inference_mode()
def long_prefill(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor, mesh: Mesh,
                 axis_name: str = MODEL_AXIS, max_len: int | None = None,
                 kv_dtype: torch.dtype = torch.bfloat16):
    """Sequence-parallel prefill of tokens [B, S], the same on every rank of
    `axis_name`, over params replicated on every rank
    (`eetq_tpu/dist/long_context.py:123-180`). Returns (the last token's
    logits [B, V] f32; dense decode caches of max_len positions, S by
    default, holding the whole prompt's K/V), the same on every rank. S must
    divide by the axis size; MoE layers are refused."""
    if any(lp.moe is not None for lp in params.layers):
        raise NotImplementedError(
            "ring attention (sequence-parallel prefill) not supported for MoE layers")
    b, s = tokens.shape
    p, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    if s % p:
        raise ValueError(f"prompt length {s} must divide the {axis_name} axis size {p} "
                         "(pad the prompt)")
    dev = params.embed.device
    sl = s // p
    last, kv_chunks = _sp_forward_local(params, tokens.to(dev)[:, idx * sl:(idx + 1) * sl], cfg,
                                        mesh, axis_name)
    caches = init_caches(cfg, b, max_len or s, device=dev, dtype=kv_dtype)
    for c, (k, v) in zip(caches, kv_chunks):
        update_cache(c, mesh.all_gather(k, 1, axis_name), mesh.all_gather(v, 1, axis_name), 0)
    return last, caches


def generate_long(params: ModelParams, cfg: ModelConfig, prompt: torch.Tensor,
                  max_new_tokens: int, mesh: Mesh, axis_name: str = MODEL_AXIS,
                  temperature: float = 0.0, top_k: int = 0,
                  generator: torch.Generator | None = None, eos_token_id: int | None = None,
                  kv_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Long-context generation: `long_prefill` of prompt [B, S], then the
    port's `decode_loop` (`eetq_tpu/dist/long_context.py:183-214`). Returns
    [B, max_new_tokens] (int64), the same on every rank. Sampling draws from
    `generator` (a generator seeded 0 when None), which every rank must
    seed alike."""
    from eetq_tpu_torch.serve.generate import decode_loop

    b, s = prompt.shape
    logits, caches = long_prefill(params, cfg, prompt, mesh, axis_name=axis_name,
                                  max_len=s + max_new_tokens, kv_dtype=kv_dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    rng = rng_from(generator, logits.device) if temperature > 0 else None
    token = sample(logits, temperature, top_k, rng)
    toks, _ = decode_loop(params, cfg, token, s, caches, max_new_tokens, temperature=temperature,
                          top_k=top_k, generator=generator, eos_token_id=eos_token_id)
    return toks
