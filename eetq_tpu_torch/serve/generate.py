"""Generation: prefill, then one decode step per new token.

Port of `eetq_tpu/serve/generate.py`. The KV caches (bf16 or int8) are
preallocated and updated in place. The JAX decode loop is one `lax.scan`
program (`generate.py:163`); here it is a Python loop over `decode_step`
(capturing the step in a CUDA graph is later work). Sampling takes a
`torch.Generator`. `prefill(a8=True)` runs the W8A8 projections, and
`decode_loop(fused_mlp=True)` the fused-MLP kernel: `bench.py`'s decode
configuration with an int8 cache.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, forward, init_caches


def _sample(logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int64: argmax when temperature == 0, else a
    draw from softmax(logits / temperature) over the top_k largest (all
    when top_k == 0)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


@torch.inference_mode()
def prefill(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor, caches,
            use_kernels: bool = True, a8: bool = False):
    """tokens [B, S], the whole prompt. Returns (last-token logits [B, V] f32,
    caches). a8=True runs the projections through the W8A8 int8-activation
    path (prefill only)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    logits, caches = forward(params, cfg, tokens, positions, caches, 0,
                             use_kernels=use_kernels, last_only=True, a8=a8)
    return logits[:, -1, :], caches


@torch.inference_mode()
def decode_step(params: ModelParams, cfg: ModelConfig, token: torch.Tensor, pos: int,
                caches, use_kernels: bool = True, fused_mlp: bool | None = None):
    """token [B, 1] at position `pos`. Returns (logits [B, V] f32, caches)."""
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=token.device)
    logits, caches = forward(params, cfg, token, positions, caches, pos,
                             use_kernels=use_kernels, fused_mlp=fused_mlp)
    return logits[:, -1, :], caches


@torch.inference_mode()
def decode_loop(
    params: ModelParams,
    cfg: ModelConfig,
    first_token: torch.Tensor,  # [B], sampled from the prefill logits
    start_pos: int,  # position of first_token
    caches,
    num_steps: int,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: torch.Generator | None = None,
    eos_token_id: int | None = None,
    fused_mlp: bool | None = None,
) -> tuple[torch.Tensor, list]:
    """(tokens [B, num_steps], first_token included; the caches after the
    last step), as `eetq_tpu/serve/generate.py::decode_loop`. Rows that
    produced eos_token_id keep emitting it. fused_mlp as in `decoder_layer`
    (None reads EETQ_FUSED_MLP)."""
    token = first_token
    finished = first_token == eos_token_id if eos_token_id is not None else None
    out = [token]
    for i in range(num_steps - 1):
        logits, caches = decode_step(params, cfg, token[:, None], start_pos + i, caches,
                                     fused_mlp=fused_mlp)
        token = _sample(logits, temperature, top_k, generator)
        if finished is not None:
            token = torch.where(finished, eos_token_id, token)
            finished = finished | (token == eos_token_id)
        out.append(token)
    return torch.stack(out, dim=1), caches


def generate(
    params: ModelParams,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, S] int
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    generator: torch.Generator | None = None,
    eos_token_id: int | None = None,
    kv_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Generated tokens [B, max_new_tokens] (prompt excluded); greedy when
    temperature == 0. kv_dtype: bf16 or int8 cache."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    b, s = prompt.shape
    caches = init_caches(cfg, b, s + max_new_tokens, device=prompt.device, dtype=kv_dtype)
    logits, caches = prefill(params, cfg, prompt, caches)
    token = _sample(logits, temperature, top_k, generator)
    tokens, _ = decode_loop(params, cfg, token, s, caches, max_new_tokens,
                            temperature=temperature, top_k=top_k, generator=generator,
                            eos_token_id=eos_token_id)
    return tokens
