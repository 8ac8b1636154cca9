"""Speculative decoding: greedy-exact draft-and-verify generation.

Port of `eetq_tpu/serve/spec.py`. Decode is bound by the weight bytes a step
reads, so a verify forward over k + 1 tokens at m = k + 1 <= 8 rides the
same decode-GEMV regime as one step and costs little more: every accepted
draft is nearly free. Two draft sources:

- a draft model (`spec_generate`), e.g. the target's own first layers;
- n-gram prompt lookup (`ngram_spec_generate`): the k tokens that followed
  the most recent occurrence of the current bigram in the prompt and the
  output so far. No draft cost; the worst round still emits one token.

Both are exact: greedy output equals the target's greedy decode token for
token, and sampled output equals `positional_generate` at the same seed
(`serve/sampling.py::sample_pos` keys a draw by (row, emission index), so a
draft is accepted exactly when it equals the target's own draw). Token i of
a verify is bit-equal to a decode step at its position because every op of
the forward treats its rows alone (the GEMV and the fused MLP take the rows
of x as the MMA's N with the same K split at m = 1 and m = 8; the
flash-decode's multi-query mode gives each query token the S = 1 call's
chunks, tiles and order). That holds while a verify's m = B (k + 1) rows
stay in the GEMV's regime (m <= 8, as b = 1 with k <= 7); more rows take
the GEMM, which sums in another order, and greedy tokens may then part from
the sequential decode's where two logits nearly tie (the JAX package's
verify changes regime at the same m).

JAX runs a whole generation as one `lax.while_loop` program. Here one round
(draft, verify forward, sample, accept and emit, history append, the loop's
condition) is a `serve/graph.py::StepGraph` over static buffers: on the card
one eager warm-up round, then a captured CUDA graph replayed until the host
reads the condition as false, one small fetch a round; on CPU tensors the
same round runs eagerly. The graph goes with the call.

Mechanics of a round (positions absolute, per row; p is the position of
`last`, the last emitted token, whose KV is not cached yet):
  1. drafts: n-gram match, or (draft model) a 2-token step over
     [prev, last] at p - 1 .. p, which heals the cache hole a fully
     accepted round leaves, then k - 1 single draft steps;
  2. one target verify forward over [last, d_1 .. d_k] at p .. p + k;
  3. accept the longest prefix with d_i == g_{i-1} and emit d_1 .. d_a,
     g_a. Rejected drafts' KV stays in the cache, masked by the lengths and
     overwritten next round. Rows that have their tokens keep running,
     frozen: they write only into slack columns and past their lengths, so
     the caches hold s + new + 2k + 1 positions.
"""

from __future__ import annotations

import dataclasses

import torch

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, forward_inner, init_caches
from eetq_tpu_torch.serve.generate import prefill
from eetq_tpu_torch.serve.graph import StepGraph
from eetq_tpu_torch.serve.sampling import row_keys, sample_pos, sample_pos_rows


def _verify_forward(params, cfg, tokens, start, caches, fused_mlp=None, lora_idx=None,
                    mesh=None):
    """tokens [B, S] at per-row positions start .. start + S - 1 (start
    [B]); lora_idx [B] each row's adapter of a model with LoRA banks; mesh:
    params are a rank's shard (`dist/sharding.py`). Returns (logits [B, S,
    V], caches)."""
    s = tokens.shape[1]
    positions = start[:, None] + torch.arange(s, device=start.device)
    return forward_inner(params, cfg, tokens, positions, caches, start, verify=True,
                         fused_mlp=fused_mlp, lora_idx=lora_idx, mesh=mesh)


def _ngram_match(hist: torch.Tensor, valid: torch.Tensor, last: torch.Tensor,
                 k: int) -> torch.Tensor:
    """Per-row prompt-lookup drafts [B, k]: the k tokens that followed the
    most recent occurrence of the bigram (hist[valid - 2], last) in
    hist[:valid - 1]. hist [B, H]; valid [B] counts the real tokens,
    `last` (== hist[:, valid - 1]) included. Rows without a match draft
    whatever follows position 0; the verify rejects it."""
    h = hist.shape[1]
    prev = hist.gather(1, (valid - 2).clamp(min=0)[:, None])
    idx = torch.arange(h, device=hist.device)
    m = ((hist == last[:, None]) & (torch.roll(hist, 1, dims=1) == prev) & (idx >= 1)
         & (idx < (valid - 1)[:, None]))  # strictly before `last` itself
    t = torch.where(m, idx, -1).amax(dim=1)
    # dynamic_slice's start: clamped so that the k tokens fit
    first = (t.clamp(min=0) + 1).clamp(max=h - k)
    return hist.gather(1, first[:, None] + torch.arange(k, device=hist.device))


def _accept_and_emit(drafts, g, t_in, limit: int, n, out, k: int, col0: int = 0):
    """Greedy acceptance: the longest prefix of drafts [B, k] matching the
    target's tokens g [B, k + 1]. Writes the emitted block (d_1 .. d_a, g_a,
    then padding) into out [B, .] at column col0 + min(n, limit), IN PLACE:
    rows with n >= limit are frozen and write only into the slack columns.
    Returns (new last, new prev, adv [B], a [B], em [B, k + 1])."""
    a = torch.cumprod((drafts == g[:, :k]).long(), dim=1).sum(dim=1)  # [0, k]
    g_at_a = g.gather(1, a[:, None])[:, 0]
    j = torch.arange(k + 1, device=g.device)
    d_pad = torch.cat([drafts, drafts[:, -1:]], dim=1)
    em = torch.where(j < a[:, None], d_pad, g_at_a[:, None])
    out.scatter_(1, col0 + n.clamp(max=limit)[:, None] + j, em)
    adv = torch.where(n >= limit, 0, a + 1)
    new_prev = t_in.gather(1, a[:, None])[:, 0]
    return g_at_a, new_prev, adv, a, em


def _caches_len(s: int, new: int, k: int) -> int:
    """Positions a speculative generation's caches hold: the prompt, the
    new tokens and the slack of frozen rows' writes (`spec.py:330`)."""
    return s + new + 2 * k + 1


def _run_rounds(graph: StepGraph, pending: torch.Tensor) -> None:
    """Replay the round until the host reads the loop's condition false."""
    while True:
        graph()
        if not bool(pending.item()):
            return


def _stats(stats: dict | None, graph: StepGraph, rounds, acc) -> tuple[int, int]:
    out = int(rounds.item()), int(acc.item())
    if stats is not None:
        stats.update(rounds=out[0], accepted_drafts=out[1], warm_ms=graph.warm_ms,
                     capture_ms=graph.capture_ms)
    return out


@torch.inference_mode()
def positional_generate(
    params: ModelParams,
    cfg: ModelConfig,
    prompt: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    kv_dtype: torch.dtype = torch.bfloat16,
    fused_mlp: bool | None = None,
) -> torch.Tensor:
    """Plain sequential decode with positional sampling (`sample_pos`): the
    reference of sampled speculation, whose `spec_generate` and
    `ngram_spec_generate` emit exactly this sequence at the same seed,
    temperature and top_k. Tokens [B, max_new_tokens]."""
    b, s = prompt.shape
    dev = prompt.device
    caches = init_caches(cfg, b, s + max_new_tokens, device=dev, dtype=kv_dtype)
    logits, caches = prefill(params, cfg, prompt, caches)
    keys = row_keys(seed, torch.arange(b, device=dev))
    first = sample_pos(logits[:, None], torch.zeros((b, 1), dtype=torch.int64, device=dev), keys,
                       temperature, top_k)[:, 0]
    out = torch.empty((b, max_new_tokens), dtype=torch.int64, device=dev)
    out[:, 0] = first
    token = first.clone()
    pos = torch.full((b,), s, dtype=torch.int64, device=dev)
    col = torch.ones((1,), dtype=torch.int64, device=dev)

    def step():
        lg, _ = forward_inner(params, cfg, token[:, None], pos[:, None], caches, pos,
                              fused_mlp=fused_mlp)
        nxt = sample_pos(lg, col.expand(b)[:, None], keys, temperature, top_k)[:, 0]
        token.copy_(nxt)
        pos.add_(1)
        out.index_copy_(1, col, nxt[:, None])
        col.add_(1)

    graph = StepGraph(step, dev)
    for _ in range(max_new_tokens - 1):
        graph()
    return out


@torch.inference_mode()
def ngram_spec_decode_loop(
    params: ModelParams,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, S], matched against as history
    first_token: torch.Tensor,  # [B], at position start_pos
    start_pos: int,
    caches,
    num_steps: int,
    k: int = 7,
    fused_mlp: bool | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    stats: dict | None = None,
) -> tuple[torch.Tensor, tuple[int, int]]:
    """Prompt-lookup speculative decode (`spec.py::ngram_spec_decode_loop`):
    (tokens [B, num_steps], first_token included; (rounds, accepted drafts)).
    One `NgramWindow` of num_steps - 1 tokens over the batch, the prompt its
    history. The caches hold at least start_pos + num_steps + 2k + 1
    positions. A `stats` dict given receives the counts and the graph's
    warm_ms and capture_ms."""
    b, s = prompt.shape
    dev = prompt.device
    win = NgramWindow(params, cfg, caches, b, s + num_steps + k + 1, num_steps - 1, k, dev,
                      sampled=temperature > 0.0, topk_cap=top_k, fused_mlp=fused_mlp)
    hist = torch.zeros(win.hist.shape, dtype=torch.int64, device=dev)
    hist[:, :s] = prompt
    hist[:, s] = first_token
    win.load(hist, torch.full((b,), s + 1), first_token, torch.full((b,), start_pos),
             emit0=torch.ones((b,)), keys=row_keys(seed, torch.arange(b, device=dev)),
             temps=torch.full((b,), temperature), topks=torch.full((b,), top_k))
    toks = win.out[:, :0]
    if num_steps > 1:
        toks = win.run()[0]
    out = torch.cat([first_token.to(torch.int64)[:, None], toks], dim=1)
    return out, _stats(stats, win.graph, win.rounds, win.accepted)


@torch.inference_mode()
def ngram_spec_generate(
    params: ModelParams,
    cfg: ModelConfig,
    prompt: torch.Tensor,
    max_new_tokens: int,
    k: int = 7,
    kv_dtype: torch.dtype = torch.bfloat16,
    fused_mlp: bool | None = None,
    return_stats: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    stats: dict | None = None,
):
    """Prompt-lookup speculative generation (draft-free): greedy output is
    exactly the target's greedy decode, sampled output exactly
    `positional_generate` at the same seed. return_stats adds
    {"rounds", "accepted_drafts"}."""
    b, s = prompt.shape
    dev = prompt.device
    caches = init_caches(cfg, b, _caches_len(s, max_new_tokens, k), device=dev, dtype=kv_dtype)
    logits, caches = prefill(params, cfg, prompt, caches)
    keys = row_keys(seed, torch.arange(b, device=dev))
    first = sample_pos(logits[:, None], torch.zeros((b, 1), dtype=torch.int64, device=dev), keys,
                       temperature, top_k)[:, 0]
    toks, (rounds, acc) = ngram_spec_decode_loop(
        params, cfg, prompt, first, s, caches, max_new_tokens, k=k, fused_mlp=fused_mlp,
        temperature=temperature, top_k=top_k, seed=seed, stats=stats)
    if return_stats:
        return toks, {"rounds": rounds, "accepted_drafts": acc}
    return toks


@torch.inference_mode()
def spec_decode_loop(
    t_params: ModelParams,
    d_params: ModelParams,
    cfg_t: ModelConfig,
    cfg_d: ModelConfig,
    first_token: torch.Tensor,  # [B], the target's token from the prefill logits
    prev_token: torch.Tensor,  # [B], the last prompt token (position start_pos - 1)
    start_pos: int,  # position of first_token
    t_caches,
    d_caches,
    num_steps: int,
    k: int = 7,
    fused_mlp: bool | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    stats: dict | None = None,
) -> tuple[torch.Tensor, tuple[int, int]]:
    """Speculative decode with a draft model (`spec.py::spec_decode_loop`):
    (tokens [B, num_steps], exactly the target's greedy or positionally
    sampled sequence, first_token included; (rounds, accepted drafts)). The
    draft always takes its argmax."""
    b, dev = first_token.shape[0], first_token.device
    width = num_steps + k + 1
    out = torch.zeros((b, width), dtype=torch.int64, device=dev)
    out[:, 0] = first_token
    last = first_token.to(torch.int64).clone()
    prev = prev_token.to(torch.int64).clone()
    n = torch.ones((b,), dtype=torch.int64, device=dev)
    rounds = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    pending = torch.ones((), dtype=torch.bool, device=dev)
    keys = row_keys(seed, torch.arange(b, device=dev))
    ar = torch.arange(k + 1, device=dev)

    def round_():
        p = n + (start_pos - 1)
        # 1. draft catch-up: [prev, last] at p - 1 .. p (rewrites KV at p - 1)
        lg, _ = _verify_forward(d_params, cfg_d, torch.stack([prev, last], dim=1), p - 1,
                                d_caches, fused_mlp)
        drafts = [torch.argmax(lg[:, -1], dim=-1)]
        # 2. k - 1 single draft steps
        for i in range(1, k):
            pos = p + i
            lg, _ = forward_inner(d_params, cfg_d, drafts[-1][:, None], pos[:, None], d_caches,
                                  pos, fused_mlp=fused_mlp)
            drafts.append(torch.argmax(lg[:, -1], dim=-1))
        drafts = torch.stack(drafts, dim=1)
        # 3. verify: one target forward over [last, d_1 .. d_k] at p .. p + k
        t_in = torch.cat([last[:, None], drafts], dim=1)
        logits, _ = _verify_forward(t_params, cfg_t, t_in, p, t_caches, fused_mlp)
        g = sample_pos(logits, n[:, None] + ar, keys, temperature, top_k)
        # 4. accept and emit
        nxt, nprev, adv, a, _ = _accept_and_emit(drafts, g, t_in, num_steps, n, out, k)
        acc.add_(torch.where(n >= num_steps, 0, a).sum())
        rounds.add_(1)
        last.copy_(nxt)
        prev.copy_(nprev)
        n.add_(adv)
        pending.copy_((n < num_steps).any())

    graph = StepGraph(round_, dev)
    if num_steps > 1:
        _run_rounds(graph, pending)
    return out[:, :num_steps], _stats(stats, graph, rounds, acc)


@torch.inference_mode()
def spec_generate(
    t_params: ModelParams,
    cfg_t: ModelConfig,
    d_params: ModelParams,
    cfg_d: ModelConfig,
    prompt: torch.Tensor,  # [B, S] int
    max_new_tokens: int,
    k: int = 7,
    kv_dtype: torch.dtype = torch.bfloat16,
    fused_mlp: bool | None = None,
    return_stats: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    stats: dict | None = None,
):
    """Speculative generation with a draft model: greedy output is exactly
    `greedy_generate(t_params, cfg_t, prompt, n)`, sampled output exactly
    `positional_generate` at the same seed. k = 7 keeps the verify at
    m = 8, the top of the decode-GEMV regime."""
    b, s = prompt.shape
    dev = prompt.device
    max_len = _caches_len(s, max_new_tokens, k)
    t_caches = init_caches(cfg_t, b, max_len, device=dev, dtype=kv_dtype)
    d_caches = init_caches(cfg_d, b, max_len, device=dev, dtype=kv_dtype)
    t_logits, t_caches = prefill(t_params, cfg_t, prompt, t_caches)
    _, d_caches = prefill(d_params, cfg_d, prompt, d_caches)
    keys = row_keys(seed, torch.arange(b, device=dev))
    first = sample_pos(t_logits[:, None], torch.zeros((b, 1), dtype=torch.int64, device=dev),
                       keys, temperature, top_k)[:, 0]
    toks, (rounds, acc) = spec_decode_loop(
        t_params, d_params, cfg_t, cfg_d, first, prompt[:, -1], s, t_caches, d_caches,
        max_new_tokens, k=k, fused_mlp=fused_mlp, temperature=temperature, top_k=top_k,
        seed=seed, stats=stats)
    if return_stats:
        return toks, {"rounds": rounds, "accepted_drafts": acc}
    return toks


def truncated_draft(params: ModelParams, cfg: ModelConfig,
                    layers: int) -> tuple[ModelParams, ModelConfig]:
    """A draft made of the target's first `layers` layers, its final norm
    and its head (the tensors shared, nothing copied)."""
    draft = ModelParams(params.embed, list(params.layers[:layers]), params.final_norm,
                        params.lm_head)
    return draft, dataclasses.replace(cfg, num_layers=layers)


# ---------------------------------------------------------------------------
# The engine's speculative decode window (`spec.py::_ngram_window_core`).
# ---------------------------------------------------------------------------


class NgramWindow:
    """One engine decode window of n-gram speculative rounds over static
    buffers (`spec.py::_ngram_window_core` and `ngram_spec_window`, the
    engine's program of a (window, sampled) pair): rounds run until every row has emitted `window` tokens (each
    round emits at least one a row, so at most `window` rounds), then each
    row reports min(emitted, window); the overshoot is discarded, its KV
    stale but masked. On entry each row's cache holds KV for positions
    [0, lengths) and `last` is pending at position lengths. The round is one
    `StepGraph`; `run` replays it until the host reads the condition false.

    sampled: the rows draw with `sample_pos_rows` (emission indices emit0 +
    emitted, per-request keys, temperatures and top-k under topk_cap);
    otherwise every row takes its argmax. fused_mlp goes to the verify
    forward (`ngram_spec_decode_loop` passes its caller's; the engine
    leaves it to the model). `accepted` counts the drafts accepted by rows
    still short of their window. lora_ids [batch]: each slot's adapter of a
    model with LoRA banks, a tensor the caller keeps at one address and
    writes in place (the replayed round reads it there, `spec.py:529-540`).
    mesh: params are a rank's shard and the verify forward all-reduces
    (`make_spec_window_fn`, `eetq_tpu/dist/sharding.py:356-423`); every
    rank holds the same row state, so their loops agree round for round.
    Its rounds run eagerly (a collective staged through the host cannot be
    captured)."""

    def __init__(self, params: ModelParams, cfg: ModelConfig, caches, batch: int,
                 hist_len: int, window: int, k: int, device, sampled: bool = False,
                 topk_cap: int = 0, fused_mlp: bool | None = None,
                 lora_ids: torch.Tensor | None = None, mesh=None):
        dev = torch.device(device)
        i64 = dict(dtype=torch.int64, device=dev)
        self.window, self.k = window, k
        self.hist = torch.zeros((batch, hist_len), **i64)  # committed history, padded
        self.valid = torch.zeros((batch,), **i64)  # real tokens in hist, `last` included
        self.last = torch.zeros((batch,), **i64)
        self.lengths = torch.zeros((batch,), **i64)  # cached KV a row == `last`'s position
        self.emitted = torch.zeros((batch,), **i64)
        self.out = torch.zeros((batch, window + k + 1), **i64)
        self.rounds = torch.zeros((), **i64)
        self.accepted = torch.zeros((), **i64)
        self.pending = torch.ones((), dtype=torch.bool, device=dev)
        # sampled rows: first emission index of the window, key, temperature, top-k
        self.emit0 = torch.zeros((batch,), **i64)
        self.keys = torch.zeros((batch,), **i64)
        self.temps = torch.zeros((batch,), dtype=torch.float32, device=dev)
        self.topks = torch.zeros((batch,), **i64)
        ar = torch.arange(k + 1, device=dev)
        top = hist_len - (k + 1)
        hist, valid, last, lengths, m, out = (self.hist, self.valid, self.last, self.lengths,
                                              self.emitted, self.out)
        emit0, keys, temps, topks, rounds, accepted, pending = (
            self.emit0, self.keys, self.temps, self.topks, self.rounds, self.accepted,
            self.pending)

        def round_():
            drafts = _ngram_match(hist, valid, last, k)
            t_in = torch.cat([last[:, None], drafts], dim=1)
            logits, _ = _verify_forward(params, cfg, t_in, lengths + m, caches, fused_mlp,
                                        lora_ids, mesh)
            if sampled:
                g = sample_pos_rows(logits, (emit0 + m)[:, None] + ar, keys, temps, topks,
                                    topk_cap)
            else:
                g = torch.argmax(logits, dim=-1)
            nxt, _, adv, a, em = _accept_and_emit(drafts, g, t_in, window, m, out, k)
            accepted.add_(torch.where(m >= window, 0, a).sum())
            # the emitted tokens join the history later rounds match against;
            # frozen rows (adv 0) write garbage at their cursor, past every
            # index the matcher reads
            hist.scatter_(1, valid.clamp(max=top)[:, None] + ar, em)
            valid.add_(adv)
            last.copy_(nxt)
            m.add_(adv)
            rounds.add_(1)
            pending.copy_((m < window).any())

        self.graph = StepGraph(torch.inference_mode()(round_), dev, eager=mesh is not None)

    def load(self, hist, valid, last, lengths, emit0=None, keys=None, temps=None,
             topks=None) -> None:
        """A window's inputs (tensors or arrays of the buffers' shapes);
        valid is raised to 2 (inactive slots: safe indices)."""
        for buf, val in ((self.hist, hist), (self.valid, valid), (self.last, last),
                         (self.lengths, lengths), (self.emit0, emit0), (self.keys, keys),
                         (self.temps, temps), (self.topks, topks)):
            if val is not None:
                buf.copy_(torch.as_tensor(val).to(buf.dtype))
        self.valid.clamp_(min=2)
        self.emitted.zero_()
        self.rounds.zero_()
        self.accepted.zero_()
        self.pending.fill_(True)

    def run(self) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Replay rounds until every row has its window; (tokens [B, window],
        counts [B], rounds)."""
        _run_rounds(self.graph, self.pending)
        return (self.out[:, :self.window], self.emitted.clamp(max=self.window),
                int(self.rounds.item()))
