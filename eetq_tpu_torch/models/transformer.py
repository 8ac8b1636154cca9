"""The decoder-only transformer forward for the llama family.

Port of `eetq_tpu/models/transformer.py` for the dense MLP: parameters are
`nn.Module`s, qkv and gate/up are fused linears split after the matmul
(`transformer.py:127,193`), the embedding is cast to bf16 (:230), silu runs
in f32 with its product cast to bf16 (:197), and logits come out in f32
(:262). `a8` routes the projections through the W8A8 path (prefill), and
`fused_mlp` runs a decode-regime MLP block as the fused kernel (:172-189);
`fused_mlp=None` reads EETQ_FUSED_MLP as the JAX package does. A tied head
multiplies by the bf16 table a vocabulary chunk at a time (`_tied_head`).
Positions past the rope table read its last row, as JAX's gather clamps
them, and a decode step's cache positions are clamped once for every layer
(`modules.attention.decode_at`): a decode window runs a row a few steps
past its budget. `verify=True` is the verify step of speculative decoding
(:89-95, :217-241): S tokens a row at the per-row positions offset ..
offset + S - 1, written and attended causally through the flash-decode's
multi-query mode, their write positions and lengths likewise clamped once
a round. A layer
with `moe` set runs the routed MLP instead (:158-170), which takes neither
`a8` nor `fused_mlp`, as in the JAX package. Under `cfg.alibi` (baichuan-13b)
no rope is applied and the attention takes the ALiBi slopes instead
(:131-146), one tensor per (head count, device) for every layer and step
(`ops/alibi.py::alibi_slopes_cache`). A layer's `qkv_lora` and `o_lora`
add LoRA side paths to qkv and o_proj (:119-127, :151-152): with a qkv
adapter the input norm runs apart, not fused into the GEMV, and with banks
`lora_idx` [B] picks each row's adapter (multi-adapter serving). The
prefill path with caches=None is differentiable end to end (LoRA
finetuning: the adapters' tensors set to requires_grad_()), through the
quantized linears' and the flash-attention's autograd Functions; the
decode, verify, W8A8 and fused-MLP kernels have no backward and raise
under grad. Under tensor parallelism (`mesh`, `dist/sharding.py`) the
parameters are a rank's shard: local heads (:64-65), ALiBi slopes sliced to
them (:136-140), an all-reduce of the row-parallel partials after o_proj,
after down and after the MoE block (:154, :158-170, :199), the fused MLP
without its residual, added after the all-reduce (:181-189), and the vocab
all-gather of the lm_head's logits (:256-257); a tied head stays replicated.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from eetq_tpu_torch.kernels.mlp_fused import ACTIVATIONS
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.modules.attention import KVCache, attention, decode_at, init_kv_cache
from eetq_tpu_torch.modules.linear import DenseLinear, LoraAdapter, QuantLinear, linear_apply
from eetq_tpu_torch.modules.moe import MoEMLP, moe_apply
from eetq_tpu_torch.ops.alibi import alibi_slopes_cache
from eetq_tpu_torch.ops.mlp import can_fuse_mlp, fused_mlp as fused_mlp_op
from eetq_tpu_torch.ops.rmsnorm import rmsnorm
from eetq_tpu_torch.ops.rope import cos_sin_cache, rope

Linear = QuantLinear | DenseLinear


class LayerParams(nn.Module):
    """One decoder layer: the dense MLP (gateup, down) or, on MoE layers,
    `moe` with gateup and down None; optional LoRA adapters (or banks) on
    qkv and o_proj."""

    def __init__(self, input_norm: torch.Tensor, qkv: Linear, o_proj: Linear,
                 post_norm: torch.Tensor, gateup: Linear | None = None,
                 down: Linear | None = None, moe: MoEMLP | None = None,
                 qkv_lora: LoraAdapter | None = None, o_lora: LoraAdapter | None = None):
        super().__init__()
        if (gateup is None, down is None) != (moe is not None,) * 2:
            raise ValueError("a layer has either gateup and down, or moe")
        self.register_buffer("input_norm", input_norm)
        self.register_buffer("post_norm", post_norm)
        self.qkv, self.o_proj, self.gateup, self.down = qkv, o_proj, gateup, down
        self.moe = moe
        self.qkv_lora, self.o_lora = qkv_lora, o_lora


class ModelParams(nn.Module):
    def __init__(self, embed: torch.Tensor, layers: list[LayerParams],
                 final_norm: torch.Tensor, lm_head: Linear | None):
        super().__init__()
        self.register_buffer("embed", embed)  # [V, H]
        self.layers = nn.ModuleList(layers)
        self.register_buffer("final_norm", final_norm)
        self.lm_head = lm_head  # None -> tied to embed


def _gamma(gamma: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return gamma + 1.0 if cfg.rmsnorm_unit_offset else gamma  # gemma stores gamma - 1


def _fused_mlp_enabled() -> bool:
    return os.environ.get("EETQ_FUSED_MLP", "0") == "1"


def decoder_layer(
    p: LayerParams,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cos_sin: torch.Tensor,
    cache: KVCache | None,
    offset,
    use_kernels: bool = True,
    a8: bool = False,
    fused_mlp: bool | None = None,
    verify: bool = False,
    slopes: torch.Tensor | None = None,
    lora_idx: torch.Tensor | None = None,
    mesh=None,
) -> tuple[torch.Tensor, KVCache | None]:
    """One decoder layer on x [B, S, H]. The RMSNorms before qkv and gate/up
    are handed to the linear as a prenorm (fused into the GEMV kernel in the
    decode regime). a8 routes every projection through W8A8; fused_mlp runs
    the MLP block as one fused dispatch where `can_fuse_mlp` allows (never
    under a8, as in the JAX package). A MoE layer's routed MLP takes
    neither. verify: the S > 1 tokens sit at per-row offsets and attend
    causally over the cache (`modules.attention.attention`). slopes: the
    ALiBi slopes of an ALiBi model, whose q and k take no rope. lora_idx
    [B]: each row's adapter where the layer's adapters are banks. mesh: p is
    this rank's shard (local heads; slopes already the local heads'), and
    the row-parallel partials are all-reduced."""
    b, s, _ = x.shape
    tp = 1 if mesh is None else mesh.tp
    hq, hkv, d = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
    reduce = (lambda t: t) if mesh is None else mesh.all_reduce_  # noqa: E731

    residual = x
    if p.qkv_lora is None:
        qkv = linear_apply(p.qkv, x, prenorm=(_gamma(p.input_norm, cfg), cfg.rms_eps),
                           use_kernel=use_kernels, a8=a8)
    else:  # the norm apart, as the JAX package runs it beside an adapter
        y = rmsnorm(x, _gamma(p.input_norm, cfg), eps=cfg.rms_eps)
        qkv = linear_apply(p.qkv, y, lora=p.qkv_lora, lora_idx=lora_idx, use_kernel=use_kernels,
                           a8=a8)
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    q, k, v = q.reshape(b, s, hq, d), k.reshape(b, s, hkv, d), v.reshape(b, s, hkv, d)
    if slopes is None:
        q = rope(q, positions, cos_sin, interleaved=cfg.rope_interleaved)
        k = rope(k, positions, cos_sin, interleaved=cfg.rope_interleaved)
    attn, cache = attention(q, k, v, cache, offset, window=cfg.sliding_window,
                            use_kernels=use_kernels, verify=verify, slopes=slopes)
    o = linear_apply(p.o_proj, attn.reshape(b, s, hq * d), lora=p.o_lora, lora_idx=lora_idx,
                     use_kernel=use_kernels, a8=a8)
    x = residual + reduce(o)

    residual = x
    gamma2 = _gamma(p.post_norm, cfg)
    if p.moe is not None:
        y = rmsnorm(x, gamma2, eps=cfg.rms_eps)
        out = moe_apply(p.moe, y, cfg.num_experts_per_tok, activation=cfg.activation,
                        use_kernel=use_kernels, mesh=mesh)
        return residual + reduce(out), cache
    if fused_mlp is None:
        fused_mlp = _fused_mlp_enabled()
    if not a8 and fused_mlp and can_fuse_mlp(p.gateup, p.down, b * s):
        # the kernel adds the residual, so its output is the layer's; under
        # tensor parallelism the partial is all-reduced first
        out = fused_mlp_op(p.gateup, p.down, x, gamma2, cfg.rms_eps,
                           activation=cfg.activation,
                           residual=residual if mesh is None else None,
                           use_kernel=use_kernels)
        return (out if mesh is None else residual + reduce(out)), cache
    gateup = linear_apply(p.gateup, x, prenorm=(gamma2, cfg.rms_eps),
                          use_kernel=use_kernels, a8=a8)
    gate, up = torch.chunk(gateup, 2, dim=-1)
    h_mlp = (ACTIVATIONS[cfg.activation](gate.float()) * up.float()).to(x.dtype)
    down = linear_apply(p.down, h_mlp, use_kernel=use_kernels, a8=a8)
    return residual + reduce(down), cache


# the f32 copy of one vocabulary chunk of a tied head's table
_TIED_CHUNK_BYTES = 64 << 20


def _tied_head(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """x [..., H] bf16 against the bf16 table [V, H]: f32 logits of the exact
    bf16 products summed in f32, the reference's bf16 dot with f32
    accumulation (`eetq_tpu/models/transformer.py:259-261`). Only one chunk of
    the table is widened to f32 at a time, never the whole of it (gemma-7b's
    would be 3.1 GB)."""
    rows = max(1, _TIED_CHUNK_BYTES // (embed.shape[1] * 4))
    xf = x.float()
    return torch.cat([xf @ embed[v:v + rows].to(x.dtype).float().T
                      for v in range(0, embed.shape[0], rows)], dim=-1)


def forward_inner(
    params: ModelParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, S] int
    positions: torch.Tensor,  # [B, S] int
    caches: list | None,  # of KVCache, or of PagedKVCache (decode only)
    offset,
    use_kernels: bool = True,
    last_only: bool = False,
    a8: bool = False,
    fused_mlp: bool | None = None,
    last_pos: torch.Tensor | None = None,
    verify: bool = False,
    lora_idx: torch.Tensor | None = None,
    mesh=None,
) -> tuple[torch.Tensor, list[KVCache] | None]:
    """Logits [B, S, V] f32 (or [B, 1, V] with last_only, which runs the
    lm_head on the last position only, or with last_pos [B], each row's
    own position of a right-padded prefill bucket) and the caches, updated
    in place. use_kernels=False runs every op's plain version; a8 and
    fused_mlp as in `decoder_layer`. The lm_head never takes a8 (as in the
    JAX package). verify=True runs the verify step of speculative decoding:
    tokens [B, S] at positions offset .. offset + S - 1, offset [B] (the
    m = B S rows pick the GEMV, the fused MLP or the GEMM as any call
    does). lora_idx [B]: each row's adapter of a model with LoRA banks.
    mesh (`dist.sharding.Mesh`): params are this rank's shard and the
    caches hold its kv heads; the logits are the whole vocabulary's, equal
    on every rank."""
    x = params.embed[tokens].to(torch.bfloat16)
    if cfg.embedding_multiplier is not None:
        x = (x.float() * cfg.embedding_multiplier).to(x.dtype)
    cos_sin = cos_sin_cache(cfg.max_position, cfg.rot_dim, base=cfg.rope_theta, device=x.device)
    slopes = alibi_slopes_cache(cfg.num_heads, x.device) if cfg.alibi else None
    if mesh is not None and mesh.tp == 1:
        mesh = None  # one rank: the plain forward
    if slopes is not None and mesh is not None:  # the rank's contiguous heads
        hq = cfg.num_heads // mesh.tp
        slopes = slopes[mesh.tp_rank * hq:(mesh.tp_rank + 1) * hq]
    positions = positions.clamp(max=cfg.max_position - 1)
    b, s = tokens.shape
    verify = verify and s > 1
    if caches is not None and (s == 1 or verify) and isinstance(offset, torch.Tensor):
        # once a step (a round) for every layer: the write indices and the
        # attention lengths, clamped to the caches' capacity
        offset = decode_at(caches[0], offset.reshape(-1).expand(b), s)
    for i, layer in enumerate(params.layers):
        cache_i = caches[i] if caches is not None else None
        x, _ = decoder_layer(layer, cfg, x, positions, cos_sin, cache_i, offset,
                             use_kernels=use_kernels, a8=a8, fused_mlp=fused_mlp,
                             verify=verify, slopes=slopes, lora_idx=lora_idx, mesh=mesh)

    if last_only:
        x = x[:, -1:, :]
    elif last_pos is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_pos.to(x.device)][:, None]
    x = rmsnorm(x, _gamma(params.final_norm, cfg), eps=cfg.rms_eps)
    if params.lm_head is not None:
        logits = linear_apply(params.lm_head, x, use_kernel=use_kernels)
        if mesh is not None:  # column-parallel over the vocabulary
            logits = mesh.all_gather_last(logits)
    else:
        logits = _tied_head(x, params.embed)
    return logits.float(), caches


# single-device forward: no jit to wrap, so the same function
forward = forward_inner


def init_caches(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> list[KVCache]:
    """One zeroed cache per layer, bf16 or int8 (`dtype`), on the card unless
    `device` says otherwise."""
    return [
        init_kv_cache(batch, max_len, cfg.num_kv_heads, cfg.head_dim, device, dtype)
        for _ in range(cfg.num_layers)
    ]
