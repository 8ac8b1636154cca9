"""Perplexity over a token stream, and the dense-against-quantized ΔPPL.

Port of `eetq_tpu/serve/eval.py`: the WikiText-2 protocol of non-overlapping
windows (each window predicts its own continuation, its first token context
only), the last window padded and its padding masked out, the window count
padded to a multiple of the batch with empty windows. Each window's summed
NLL and target count come back as f32 device scalars (`_window_nll`) and are
summed across windows on the host, as the JAX package does. The caller
supplies the token ids (a pre-tokenized file): nothing is downloaded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, forward_inner


def _window_nll(params: ModelParams, cfg: ModelConfig, tokens: torch.Tensor, mask: torch.Tensor,
                use_kernels: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, target count), f32 scalars, of the [B, S] windows
    `tokens`: tokens[:, :-1] predict tokens[:, 1:], and `mask` [B, S] marks
    the real target positions (0 for padding)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    logits, _ = forward_inner(params, cfg, tokens, positions, None, 0, use_kernels=use_kernels)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    m = mask[:, 1:].float()
    return (nll * m).sum(), m.sum()


def perplexity(
    params: ModelParams,
    cfg: ModelConfig,
    token_ids,
    window: int = 2048,
    batch_size: int = 1,
    use_kernels: bool = True,
) -> float:
    """exp(mean NLL) of a 1-D token stream over non-overlapping windows of
    `window` tokens (at most cfg.max_position), `batch_size` windows a
    forward, on the device of the params. use_kernels=False runs every op's
    plain version (the JAX package's use_flash=False runs its plain
    attention)."""
    ids = np.asarray(token_ids, dtype=np.int64).ravel()
    window = min(window, cfg.max_position)
    n_chunks = max(1, math.ceil(len(ids) / window))
    padded = np.zeros(n_chunks * window, np.int64)
    padded[:len(ids)] = ids
    mask = np.zeros_like(padded)
    mask[:len(ids)] = 1
    chunks, masks = padded.reshape(n_chunks, window), mask.reshape(n_chunks, window)
    pad_rows = (-n_chunks) % batch_size  # the window count padded to a batch multiple
    if pad_rows:
        chunks = np.concatenate([chunks, np.zeros((pad_rows, window), np.int64)])
        masks = np.concatenate([masks, np.zeros((pad_rows, window), np.int64)])
    device = params.embed.device
    total_nll = total_cnt = 0.0
    with torch.inference_mode():
        for i in range(0, len(chunks), batch_size):
            nll, cnt = _window_nll(params, cfg, torch.from_numpy(chunks[i:i + batch_size]).to(device),
                                   torch.from_numpy(masks[i:i + batch_size]).to(device),
                                   use_kernels)
            total_nll += float(nll)
            total_cnt += float(cnt)
    if total_cnt == 0:
        raise ValueError("no target tokens")
    return math.exp(total_nll / total_cnt)


def delta_ppl(dense_params: ModelParams, quant_params: ModelParams, cfg: ModelConfig, token_ids,
              **kw) -> dict:
    """`BASELINE.md`'s acceptance metric: the quantized model's perplexity
    less the dense model's, on the same stream."""
    p_dense = perplexity(dense_params, cfg, token_ids, **kw)
    p_quant = perplexity(quant_params, cfg, token_ids, **kw)
    return {"ppl_dense": p_dense, "ppl_quant": p_quant, "delta_ppl": p_quant - p_dense}
