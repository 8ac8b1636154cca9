"""Rank tasks of the pipeline, ring-attention and long-context tests
(`test_torch_pipeline.py`, `test_torch_ring_attention.py`,
`test_torch_long_context.py`), run by `eetq_tpu_torch.dist.launch.RankPool`
in spawned processes. Like `torch_sharding_tasks.py`, this module imports no
JAX and each task checks that none is loaded. A task takes the rank's mesh
of the whole world (the model axis) first; the pipeline tasks make their
(pipe, model) mesh from it once per shape and keep it, and the model, in
the rank's `state`. What a task returns is numpy."""

from __future__ import annotations

import numpy as np
import torch

from eetq_tpu_torch.dist.long_context import generate_long, long_prefill
from eetq_tpu_torch.dist.pipeline import (
    init_pp_caches,
    make_pp_mesh,
    pp_decode_loop,
    pp_generate,
    pp_prefill,
    shard_model_pp,
)
from eetq_tpu_torch.dist.ring_attention import ring_attention_sharded
from eetq_tpu_torch.dist.sharding import make_forward_fn, shard_model
from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.utils.profiling import count_collectives
from torch_sharding_tasks import _no_jax, leaves


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


def _caches(caches) -> list:
    return [(_np(c.k), _np(c.v)) for c in caches]


def _pp_mesh(mesh, pp: int, tp: int, state: dict):
    """The (pipe, model) mesh of pp x tp over the pool's world, made once."""
    key = ("mesh", pp, tp)
    if key not in state:
        state[key] = make_pp_mesh(pp, tp, device=mesh.device)
    return state[key]


def pp_build(mesh, pp: int, tp: int, tree: dict, cfg, state: dict) -> dict:
    """This rank's `shard_model_pp(quantize=True)` stage of the numpy model
    `tree`, kept as state["pp"]; its leaves, norms and stage index."""
    _no_jax()
    pmesh = _pp_mesh(mesh, pp, tp, state)
    model = shard_model_pp(params_from_numpy(tree, device="cpu"), cfg, pmesh, quantize=True)
    state["pp"] = model
    out = leaves(model)
    out["norms"] = [(lp.input_norm.numpy(), lp.post_norm.numpy()) for lp in model.params.layers]
    out["stage"], out["shard"] = pmesh.pp_rank, pmesh.tp_rank
    return out


def pp_generate_task(mesh, prompt: np.ndarray, n: int, m: int, temperature: float = 0.0,
                     top_k: int = 0, seed: int | None = None, state: dict = None) -> dict:
    """pp_generate of state["pp"]: its tokens and the kernel launches."""
    _no_jax()
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    reset_launch_counts()
    toks = pp_generate(state["pp"], torch.from_numpy(prompt).long(), n, microbatches=m,
                       temperature=temperature, top_k=top_k, generator=gen)
    return {"tokens": toks.cpu().numpy(), "launches": launch_counts()}


def pp_prefill_decode(mesh, prompt: np.ndarray, m: int, max_len: int, first: np.ndarray | None,
                      windows: tuple, state: dict) -> dict:
    """pp_prefill of prompt into fresh stage caches (its logits, caches and
    collectives), then pp_decode_loop windows of (start, steps) in turn from
    `first` (JAX's first token; else the prefill's argmax), each from the
    last token of the one before: their tokens and collectives, and the
    caches after the last."""
    _no_jax()
    model = state["pp"]
    caches = init_pp_caches(model, prompt.shape[0], max_len)
    got = {}
    counts = count_collectives(lambda: got.setdefault("out", pp_prefill(
        model, torch.from_numpy(prompt).long(), caches, microbatches=m)))
    logits, caches = got["out"]
    out = {"logits": _np(logits), "prefill_caches": _caches(caches), "prefill_counts": counts,
           "tokens": [], "decode_counts": []}
    token = torch.from_numpy(first).long() if first is not None else torch.argmax(logits, -1)
    for start, steps in windows:
        res = {}
        out["decode_counts"].append(count_collectives(lambda: res.setdefault("out", pp_decode_loop(
            model, token, start, caches, steps, microbatches=m))))
        toks, caches = res["out"]
        out["tokens"].append(toks.numpy())
        token = toks[:, -1]
    out["caches"] = _caches(caches)
    return out


def tp_greedy(mesh, tree: dict, cfg, prompt: np.ndarray, n: int) -> np.ndarray:
    """shard_model(quantize=True) over the pool's tp ranks, then greedy
    tokens through the sharded forward driven step by step
    (`tests/test_pipeline.py:78-109`)."""
    _no_jax()
    model = shard_model(params_from_numpy(tree, device="cpu"), cfg, mesh, quantize=True)
    fwd = make_forward_fn(model)
    b, s = prompt.shape
    caches = model.init_caches(b, s + n)
    with torch.inference_mode():
        lg, _ = fwd(model.params, torch.from_numpy(prompt).long(),
                    torch.arange(s).expand(b, s), caches, 0)
        toks = [torch.argmax(lg[:, -1], -1)]
        for i in range(n - 1):
            lg, _ = fwd(model.params, toks[-1][:, None], torch.full((b, 1), s + i), caches, s + i)
            toks.append(torch.argmax(lg[:, -1], -1))
    return torch.stack(toks, 1).numpy()


def ring(mesh, q: np.ndarray, k: np.ndarray, v: np.ndarray, causal: bool = True,
         slopes: np.ndarray | None = None, window: int | None = None) -> dict:
    """ring_attention_sharded over the pool's ranks of q, k, v given in f32
    and taken in bf16 on the rank's device: the gathered output in f32, the
    collectives and the kernel launches."""
    _no_jax()

    def bf16(a):
        return torch.from_numpy(a).to(mesh.device, torch.bfloat16)

    got = {}
    reset_launch_counts()
    counts = count_collectives(lambda: got.setdefault("out", ring_attention_sharded(
        bf16(q), bf16(k), bf16(v), mesh, causal=causal,
        slopes=None if slopes is None else torch.from_numpy(slopes).to(mesh.device),
        window=window)))
    return {"out": _np(got["out"]), "counts": counts, "launches": launch_counts()}


def long_prefill_task(mesh, tree: dict, cfg, tokens: np.ndarray) -> dict:
    """long_prefill of the numpy model `tree` (replicated) over the pool's
    ranks: the logits, the caches and the collectives."""
    _no_jax()
    params = params_from_numpy(tree, device="cpu")
    got = {}
    counts = count_collectives(lambda: got.setdefault("out", long_prefill(
        params, cfg, torch.from_numpy(tokens).long(), mesh)))
    logits, caches = got["out"]
    return {"logits": _np(logits), "caches": _caches(caches), "counts": counts}


def generate_long_task(mesh, tree: dict, cfg, prompt: np.ndarray, n: int) -> np.ndarray:
    """generate_long (greedy) of the numpy model `tree` over the pool's ranks."""
    _no_jax()
    return generate_long(params_from_numpy(tree, device="cpu"), cfg,
                         torch.from_numpy(prompt).long(), n, mesh).numpy()


def seeded_model(cfg, seed: int, device, quantize: bool = True):
    """The model drawn from `seed` on `device`: (the embedding, final norm
    and dense lm_head drawn from seed + 1 with no layer; the layers, each
    drawn as taken) with quantize=False, else the W8A16 ModelParams of
    both (per-channel, the head dense), the one-card model of the same
    integers as a pipeline or long-context rank's."""
    import dataclasses

    from eetq_tpu_torch.models.init import _quantize_layer, random_dense_layers, random_dense_params
    from eetq_tpu_torch.models.transformer import ModelParams

    stub = random_dense_params(dataclasses.replace(cfg, num_layers=0),
                               torch.Generator(device=device).manual_seed(seed + 1))
    layers = random_dense_layers(cfg, torch.Generator(device=device).manual_seed(seed))
    if not quantize:
        return stub, layers
    return ModelParams(stub.embed, [_quantize_layer(lp, 8, None) for lp in layers],
                       stub.final_norm, stub.lm_head)


def pp_build_random(mesh, pp: int, tp: int, cfg, seed: int, state: dict) -> None:
    """This rank's shard_model_pp(quantize=True) stage of `seeded_model`,
    drawn layer by layer on the rank's device, kept as state["pp"]."""
    _no_jax()
    pmesh = _pp_mesh(mesh, pp, tp, state)
    stub, layers = seeded_model(cfg, seed, pmesh.device, quantize=False)
    state["pp"] = shard_model_pp(stub, cfg, pmesh, quantize=True, layers=layers)


def long_prefill_random(mesh, cfg, seed: int, tokens: np.ndarray) -> dict:
    """long_prefill over the pool's ranks of `seeded_model` (W8A16, on each
    rank's device): its logits, collectives and kernel launches."""
    _no_jax()
    params = seeded_model(cfg, seed, mesh.device)
    reset_launch_counts()
    got = {}
    counts = count_collectives(lambda: got.setdefault("out", long_prefill(
        params, cfg, torch.from_numpy(tokens).long(), mesh)))
    return {"logits": _np(got["out"][0]), "counts": counts, "launches": launch_counts()}
