"""Pipeline parallelism: the layers held in stages on the ranks of a `pipe`
axis.

Port of `eetq_tpu/dist/pipeline.py`. Each rank is one process that holds the
layers of its stage (global layers p Lps + j, Lps = L / pp), split for
tensor parallelism over its `model` axis where tp > 1 (`dist/sharding.py`),
and runs the port's kernels on them. Where the JAX package calls
`lax.ppermute` over `pipe` inside `shard_map`, the rank exchanges
activations with its neighbours (`Mesh.ppermute`); where it calls `psum`,
the rank all-reduces over its pipe group.

Schedules, as in the JAX package:

- Prefill (`pp_prefill`): GPipe microbatching. The batch is split into M
  microbatches; over M + pp - 1 ticks, stage p runs unit u = t - p at tick
  t when 0 <= u < M: stage 0 embeds the microbatch's tokens, every later
  stage takes its activations from the stage before, and each writes its
  layers' KV rows of the microbatch (a view of its [B, ...] caches, written
  in place). The last stage's logits are shared with every stage by an
  all-reduce over `pipe`. A rank skips the work of an idle tick but takes
  part in every exchange of the schedule.
- Decode (`pp_decode_loop`): a token ring. Unit u = j M + mb (step j of
  microbatch mb) runs on stage s at tick u + s; the last stage samples its
  token and sends it back to stage 0 with the activations that go forward.
  It needs M >= pp: the token of unit u reaches stage 0 at tick u + pp, and
  the microbatch's next unit starts there at tick u + M.

Under dp > 1 (`make_pp_mesh(pp, tp, dp)`) each data shard is a pipeline of
its own over its rows of the batch (B / dp, then microbatched); the shards
meet only to gather the logits and tokens over `data` at the end of a call.

The embedding, the final norm and the dense lm_head are replicated on every
stage (`shard_model_pp`): under pp x tp the head's logits need no vocab
gather. The decode runs eagerly, tick by tick: a gloo exchange cannot be
captured into a CUDA graph. MoE layers are refused, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from eetq_tpu_torch.dist.sharding import (
    DATA_AXIS,
    PIPE_AXIS,
    Mesh,
    make_mesh,
    shard_layer,
)
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import ModelParams, _gamma, _tied_head, decoder_layer
from eetq_tpu_torch.modules.attention import KVCache, init_kv_cache
from eetq_tpu_torch.modules.linear import linear_apply
from eetq_tpu_torch.ops.alibi import alibi_slopes_cache
from eetq_tpu_torch.ops.rmsnorm import rmsnorm
from eetq_tpu_torch.ops.rope import cos_sin_cache
from eetq_tpu_torch.serve.sampling import fold_in, rng_from, sample


def make_pp_mesh(pp: int, tp: int = 1, dp: int = 1,
                 device: torch.device | str | None = None) -> Mesh:
    """This rank's (data, pipe, model) mesh over the initialised process
    group, `model` innermost (`eetq_tpu/dist/pipeline.py:71-83`): the world
    holds dp pp tp ranks, rank ((d pp + p) tp + t) being shard t of stage p
    of data shard d."""
    return make_mesh(tp=tp, dp=dp, pp=pp, device=device)


@dataclasses.dataclass(eq=False)
class PipelinedModel:
    """This rank's stage: its Lps layers (`params.layers`, split over the
    model axis where tp > 1), the replicated embedding, final norm and
    lm_head, the global config and the mesh."""

    cfg: ModelConfig
    mesh: Mesh
    params: ModelParams

    @property
    def pp(self) -> int:
        return self.mesh.pp

    @property
    def tp(self) -> int:
        return self.mesh.tp

    @property
    def layers_per_stage(self) -> int:
        return self.cfg.num_layers // self.pp


def shard_model_pp(dense_params: ModelParams, cfg: ModelConfig, mesh: Mesh,
                   quantize: bool = True, bits: int = 8, layers=None) -> PipelinedModel:
    """This rank's stage of a dense model (`eetq_tpu/dist/pipeline.py:
    105-257`): global layers p Lps + j, each split over the model axis as
    `shard_model` splits it and each shard quantized on its own
    (quantize=True), on the mesh's device; the embedding, final norm and
    lm_head replicated, the head kept dense. Layer by layer: `layers`, an
    iterable of dense LayerParams consumed one at a time, takes the place of
    dense_params.layers, and a rank keeps only its stage's.

    Refuses what the JAX package refuses: MoE layers, a layer count that pp
    does not divide, a row-parallel bias (o_proj, down) in any stage."""
    layers = dense_params.layers if layers is None else layers
    if cfg.num_experts or any(lp.moe is not None for lp in dense_params.layers):
        raise NotImplementedError(
            "MoE layers not supported with pipeline parallelism; use TP/EP via "
            "dist.sharding.shard_model")
    pp = mesh.pp
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by pp={pp}")
    lps = cfg.num_layers // pp
    first = mesh.pp_rank * lps
    out = []
    for i, lp in enumerate(layers):
        if lp.o_proj.bias is not None or (lp.down is not None and lp.down.bias is not None):
            raise NotImplementedError("row-parallel bias sharding not supported")
        if first <= i < first + lps:
            out.append(shard_layer(lp, cfg, mesh, quantize, bits))
        del lp
    dev = mesh.device
    head = dense_params.lm_head
    params = ModelParams(dense_params.embed.to(dev), out, dense_params.final_norm.to(dev),
                         None if head is None else head.to(dev))
    return PipelinedModel(cfg=cfg, mesh=mesh, params=params)


def init_pp_caches(model: PipelinedModel, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> list[KVCache]:
    """This stage's caches of a global batch: one for each of its Lps
    layers (global layer p Lps + j), holding its data shard's batch / dp rows
    of the model axis' Hkv / tp kv heads, on the rank's device
    (`eetq_tpu/dist/pipeline.py:260-279`, spec (pipe, data, model))."""
    cfg, tp = model.cfg, model.tp
    if cfg.num_kv_heads % tp:
        raise ValueError(f"kv heads {cfg.num_kv_heads} not divisible by tp={tp}")
    rows = model.mesh.data_rows(batch)
    return [init_kv_cache(rows.stop - rows.start, max_len, cfg.num_kv_heads // tp, cfg.head_dim,
                          model.mesh.device, dtype)
            for _ in range(model.layers_per_stage)]


def _rows(caches: list[KVCache], row0: int, size: int) -> list[KVCache]:
    """Views of rows row0 .. row0 + size of the caches (dim 0 slices, so
    that a write into them lands in the caches)."""
    return [KVCache(*(None if t is None else t[row0:row0 + size]
                      for t in (c.k, c.v, c.k_scale, c.v_scale))) for c in caches]


def _run_stage(model: PipelinedModel, x: torch.Tensor, positions: torch.Tensor,
               caches: list[KVCache], offset: int) -> torch.Tensor:
    """This stage's layers over x [mb, S, H] at `positions` [mb, S], cache
    writes at `offset` (the port's `decoder_layer` with the model axis'
    mesh); returns x (`eetq_tpu/dist/pipeline.py:335-352`)."""
    cfg, mesh = model.cfg, model.mesh
    cos_sin = cos_sin_cache(cfg.max_position, cfg.rot_dim, base=cfg.rope_theta, device=x.device)
    slopes = None
    if cfg.alibi:  # the model axis' contiguous heads
        hq = cfg.num_heads // mesh.tp
        slopes = alibi_slopes_cache(cfg.num_heads, x.device)[mesh.tp_rank * hq:
                                                             (mesh.tp_rank + 1) * hq]
    positions = positions.clamp(max=cfg.max_position - 1)
    for lp, c in zip(model.params.layers, caches):
        x, _ = decoder_layer(lp, cfg, x, positions, cos_sin, c, offset, slopes=slopes,
                             mesh=mesh if mesh.tp > 1 else None)
    return x


def _head_logits(model: PipelinedModel, x_last: torch.Tensor) -> torch.Tensor:
    """The final norm and the replicated head on x [mb, 1|S, H]: f32 logits
    [mb, V] of the last position, with no vocab gather
    (`eetq_tpu/dist/pipeline.py:355-369`)."""
    p, cfg = model.params, model.cfg
    x = rmsnorm(x_last[:, -1:], _gamma(p.final_norm, cfg), eps=cfg.rms_eps)
    logits = linear_apply(p.lm_head, x) if p.lm_head is not None else _tied_head(x, p.embed)
    return logits[:, -1, :].float()


def _embed(model: PipelinedModel, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [mb, S] -> bf16 [mb, S, H], times the embedding multiplier."""
    x = model.params.embed[tokens].to(torch.bfloat16)
    if model.cfg.embedding_multiplier is not None:
        x = (x.float() * model.cfg.embedding_multiplier).to(x.dtype)
    return x


def _check_pp_batch(model: PipelinedModel, b: int, m: int) -> None:
    """The per-shard batch must divide into microbatches, with JAX's
    messages (`eetq_tpu/dist/pipeline.py:470-483`): the global batch b over
    dp data shards first, then each shard's b / dp rows over m."""
    dp = model.mesh.dp
    if b % dp:
        raise ValueError(f"batch {b} not divisible by data shards {dp}")
    if (b // dp) % m:
        raise ValueError(f"per-shard batch {b // dp} (global {b} / dp {dp}) not divisible by "
                         f"microbatches {m}")


@torch.inference_mode()
def pp_prefill(model: PipelinedModel, tokens: torch.Tensor, caches: list[KVCache],
               microbatches: int = 1):
    """GPipe-microbatched prefill of tokens [B, S] (module docstring), a data
    shard its B / dp rows into its caches (`init_pp_caches`); B / dp must
    divide by microbatches. Returns (last-token logits [B, V] f32, every
    shard's rows gathered over `data`, the same on every rank; this stage's
    caches, written in place)."""
    _check_pp_batch(model, tokens.shape[0], microbatches)
    cfg, mesh, pp = model.cfg, model.mesh, model.pp
    dev = mesh.device
    tokens = tokens[mesh.data_rows(tokens.shape[0])].to(dev)
    b, s = tokens.shape
    m, p = microbatches, mesh.pp_rank
    mbs = b // m
    positions = torch.arange(s, device=dev).expand(mbs, s)
    perm = [(i, i + 1) for i in range(pp - 1)]
    x_recv = torch.zeros((mbs, s, cfg.hidden_size), dtype=torch.bfloat16, device=dev)
    logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32, device=dev)
    for t in range(m + pp - 1):
        u = t - p
        if 0 <= u < m:
            row0 = u * mbs
            x_in = _embed(model, tokens[row0:row0 + mbs]) if p == 0 else x_recv
            x_out = _run_stage(model, x_in, positions, _rows(caches, row0, mbs), 0)
            if p == pp - 1:
                logits[row0:row0 + mbs] = _head_logits(model, x_out)
        else:  # an idle tick: nothing of it is received as work
            x_out = torch.zeros_like(x_recv)
        if perm:
            x_recv = mesh.ppermute(x_out, PIPE_AXIS, perm)
    # only the last stage wrote logits: the sum shares them with every
    # stage, the gather with every data shard
    return mesh.gather_rows(mesh.all_reduce_(logits, PIPE_AXIS)), caches


def _generator(generator: torch.Generator | None) -> torch.Generator:
    """The caller's generator, else one seeded 0 (the JAX package's
    PRNGKey(0)), so that every rank draws alike."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


@torch.inference_mode()
def pp_decode_loop(model: PipelinedModel, first_token: torch.Tensor, start_pos: int,
                   caches: list[KVCache], num_steps: int, microbatches: int | None = None,
                   temperature: float = 0.0, top_k: int = 0,
                   generator: torch.Generator | None = None):
    """The token-ring decode (module docstring; `eetq_tpu/dist/pipeline.py:
    491-643`): first_token [B] at position start_pos, num_steps tokens in
    all, a data shard its B / dp rows. Returns (tokens [B, num_steps] int64,
    first_token included, every shard's rows gathered over `data`, the same
    on every rank; this stage's caches, advanced in place). microbatches
    defaults to pp and must be >= pp and divide B / dp. Sampling
    (temperature > 0) draws on the last stage from one stream per
    microbatch (`serve/sampling.py`), seeded from `generator` (a generator
    seeded 0 when None) and folded by the data shard's index, as JAX folds
    `axis_index(DATA_AXIS)` into its key (:579-586), so that the shards do
    not draw the same noise; every rank must pass alike seeded generators."""
    cfg, mesh, pp = model.cfg, model.mesh, model.pp
    m = microbatches if microbatches is not None else pp
    _check_pp_batch(model, first_token.shape[0], m)
    if m < pp:
        raise ValueError(f"microbatches {m} must be >= pp {pp}")
    dev = mesh.device
    first_token = first_token[mesh.data_rows(first_token.shape[0])].to(dev)
    b, h, p = first_token.shape[0], cfg.hidden_size, mesh.pp_rank
    mbs, steps = b // m, num_steps - 1
    is_first, is_last = p == 0, p == pp - 1
    rngs = None
    if temperature > 0:
        gen = _generator(generator)
        data = mesh.axis_index(DATA_AXIS)
        rngs = [fold_in(rng_from(gen, dev), data) for _ in range(m)]
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    token_buf = first_token.to(torch.int32).reshape(m, mbs).clone()
    x_recv = torch.zeros((mbs, 1, h), dtype=torch.bfloat16, device=dev)
    tok_recv = torch.zeros((mbs,), dtype=torch.int32, device=dev)
    out_buf = torch.zeros((m, mbs, max(steps, 1)), dtype=torch.int32, device=dev)
    for t in range(steps * m + pp - 1):
        u_prev = t - pp  # the token that arrived at stage 0, sent at tick t - 1
        if is_first and 0 <= u_prev < steps * m:
            token_buf[u_prev % m] = tok_recv
        u = t - p
        nxt = torch.zeros((mbs,), dtype=torch.int32, device=dev)
        if 0 <= u < steps * m:
            mb, j = u % m, u // m
            row0, posn = mb * mbs, start_pos + j
            x_in = _embed(model, token_buf[mb][:, None].long()) if is_first else x_recv
            positions = torch.full((mbs, 1), posn, dtype=torch.int64, device=dev)
            x_out = _run_stage(model, x_in, positions, _rows(caches, row0, mbs), posn)
            if is_last:
                lg = _head_logits(model, x_out)
                nxt = sample(lg, temperature, top_k, None if rngs is None else rngs[mb])
                nxt = nxt.to(torch.int32)
                out_buf[mb, :, j] = nxt
        else:
            x_out = torch.zeros_like(x_recv)
        x_recv, tok_recv = mesh.ppermute((x_out, nxt), PIPE_AXIS, perm)
    out_buf = mesh.all_reduce_(out_buf, PIPE_AXIS)  # only the last stage wrote
    toks = torch.cat([first_token.long()[:, None], out_buf.reshape(b, -1)[:, :steps].long()],
                     dim=1)
    return mesh.gather_rows(toks), caches


def pp_generate(model: PipelinedModel, prompt: torch.Tensor, max_new_tokens: int,
                microbatches: int | None = None, temperature: float = 0.0, top_k: int = 0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Pipelined generation: `pp_prefill` of prompt [B, S], then the decode
    ring. Returns the generated tokens [B, max_new_tokens] (int64), the same
    on every rank (`eetq_tpu/dist/pipeline.py:646-676`)."""
    b, s = prompt.shape
    m = microbatches if microbatches is not None else model.pp
    caches = init_pp_caches(model, b, s + max_new_tokens)
    logits, caches = pp_prefill(model, prompt, caches, microbatches=m)
    gen = None
    if temperature == 0.0:
        token = torch.argmax(logits, dim=-1)
    else:
        gen = _generator(generator)
        token = sample(logits, temperature, top_k, rng_from(gen, logits.device))
    toks, _ = pp_decode_loop(model, token, s, caches, max_new_tokens, microbatches=m,
                             temperature=temperature, top_k=top_k, generator=gen)
    return toks
