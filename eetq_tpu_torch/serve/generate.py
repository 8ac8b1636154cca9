"""Generation: prefill, then one decode step per new token.

Port of `eetq_tpu/serve/generate.py`. The KV caches (bf16 or int8) are
preallocated and updated in place. JAX's decode loop is one `lax.scan`
program (`generate.py:163-205`); here `decode_loop` is one step (forward,
sample, eos mask) captured once in a CUDA graph and replayed for every
further token (`serve/graph.py`), with the position, the token and the
finished mask in device tensors that each replay advances in place. On CPU
tensors the same step runs eagerly. `decode_step(pos: int)` stays an eager
step, and `generate(use_scan=False)` streams through it. Sampling draws
Gumbel noise on the device from a stream seeded by a `torch.Generator`
(`serve/sampling.py`). `prefill(a8=True)` runs the W8A8 projections, and
`decode_loop(fused_mlp=True)` the fused-MLP kernel: `bench.py`'s decode
configuration with an int8 cache.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, forward, init_caches
from eetq_tpu_torch.serve.graph import StepGraph
from eetq_tpu_torch.serve.sampling import rng_from, sample


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
    stats: dict | None = None,
) -> tuple[torch.Tensor, list]:
    """(tokens [B, num_steps], first_token included; the caches after the
    last step), as `eetq_tpu/serve/generate.py::decode_loop`. Rows that
    produced eos_token_id keep emitting it. fused_mlp as in `decoder_layer`
    (None reads EETQ_FUSED_MLP). On the card the step is captured once and
    replayed num_steps - 2 times (the first step is the graph's warm-up);
    the graph goes with the call, so it keeps none of its tensors alive.
    A `stats` dict given receives the graph's warm_ms and capture_ms."""
    b, dev = first_token.shape[0], first_token.device
    out = torch.empty((b, num_steps), dtype=torch.int64, device=dev)
    out[:, 0] = first_token
    token = first_token.to(torch.int64).clone()  # the carry, advanced in place
    pos = torch.full((b,), start_pos, dtype=torch.int64, device=dev)
    col = torch.ones((1,), dtype=torch.int64, device=dev)
    finished = first_token == eos_token_id if eos_token_id is not None else None
    rng = rng_from(generator, dev) if temperature > 0 else None

    def step():
        logits, _ = forward(params, cfg, token[:, None], pos[:, None], caches, pos,
                            fused_mlp=fused_mlp)
        nxt = sample(logits[:, -1, :], temperature, top_k, rng)
        if finished is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished.logical_or_(nxt == eos_token_id)
        token.copy_(nxt)
        pos.add_(1)
        out.index_copy_(1, col, nxt[:, None])
        col.add_(1)

    graph = StepGraph(step, dev)
    for _ in range(num_steps - 1):
        graph()
    if stats is not None:
        stats.update(warm_ms=graph.warm_ms, capture_ms=graph.capture_ms)
    return out, caches


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
    use_scan: bool = True,
) -> torch.Tensor:
    """Generated tokens [B, max_new_tokens] (prompt excluded); greedy when
    temperature == 0. kv_dtype: bf16 or int8 cache. use_scan=True runs the
    decode as `decode_loop` (one captured step, replayed); use_scan=False
    streams token by token through `decode_step` and stops early once every
    row has produced eos_token_id (the rest padded with it)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    b, s = prompt.shape
    caches = init_caches(cfg, b, s + max_new_tokens, device=prompt.device, dtype=kv_dtype)
    logits, caches = prefill(params, cfg, prompt, caches)
    rng = rng_from(generator, prompt.device) if temperature > 0 else None
    token = sample(logits, temperature, top_k, rng)
    if use_scan:
        tokens, _ = decode_loop(params, cfg, token, s, caches, max_new_tokens,
                                temperature=temperature, top_k=top_k, generator=generator,
                                eos_token_id=eos_token_id)
        return tokens
    out = [token]
    finished = token == eos_token_id if eos_token_id is not None else None
    for i in range(1, max_new_tokens):
        logits, caches = decode_step(params, cfg, token[:, None], s + i - 1, caches)
        token = sample(logits, temperature, top_k, rng)
        if finished is not None:
            token = torch.where(finished, eos_token_id, token)
            finished = finished | (token == eos_token_id)
        out.append(token)
        if finished is not None and bool(finished.all()):
            out.extend([torch.full_like(token, eos_token_id)] * (max_new_tokens - 1 - i))
            break
    return torch.stack(out, dim=1)


def greedy_generate(params: ModelParams, cfg: ModelConfig, prompt: torch.Tensor,
                    max_new_tokens: int, **kw) -> torch.Tensor:
    return generate(params, cfg, prompt, max_new_tokens, temperature=0.0, **kw)
