"""Rank tasks of the sharded tests (`test_torch_sharding.py`,
`test_torch_engine_sharded.py`), run by `eetq_tpu_torch.dist.launch.RankPool`
in spawned processes. This module imports no JAX, so that a rank never
loads it: each task checks that none is loaded. A task takes the rank's
mesh first and keeps its model in the rank's `state`; what it returns is
numpy."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from eetq_tpu_torch.dist.sharding import make_forward_fn, shard_model
from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
from eetq_tpu_torch.layout.tiling import unpack_weights
from eetq_tpu_torch.models.auto import AutoEETQForCausalLM
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.modules.linear import QuantLinear
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.surgery.tp_reshard import shard_quantized
from eetq_tpu_torch.utils.profiling import count_collectives


def _no_jax() -> None:
    bad = sorted(n for n in sys.modules if n == "jax" or n.startswith(("jax.", "eetq_tpu.")))
    assert not bad, bad


def _linear(lin) -> dict:
    if isinstance(lin, QuantLinear):
        return {"q": unpack_weights(lin.packed).numpy(), "s": lin.scales.numpy(),
                "b": None if lin.bias is None else lin.bias.float().numpy()}
    return {"w": lin.weight.float().numpy(),
            "b": None if lin.bias is None else lin.bias.float().numpy()}


def leaves(model) -> dict:
    """The shard's linears (ints and scales, or weights) as numpy."""
    out = {"lm_head": None if model.params.lm_head is None else _linear(model.params.lm_head)}
    for i, lp in enumerate(model.params.layers):
        for name in ("qkv", "o_proj", "gateup", "down"):
            if getattr(lp, name) is not None:
                out[f"{i}.{name}"] = _linear(getattr(lp, name))
        if lp.moe is not None:
            for name in ("router", "gateup", "down"):
                out[f"{i}.moe.{name}"] = _linear(getattr(lp.moe, name))
    return out


def build(mesh, tree: dict, cfg, how: str, state: dict) -> dict:
    """The rank's shard of the numpy model `tree` (`convert.params_from_numpy`):
    how "dense" / "quantize" (`shard_model(quantize=False / True)`) or
    "quantized" (`shard_quantized` of a quantized tree). Kept as
    state["model"]; returns its leaves."""
    _no_jax()
    params = params_from_numpy(tree, device="cpu")
    if how == "quantized":
        model = shard_quantized(params, cfg, mesh)
    else:
        model = shard_model(params, cfg, mesh, quantize=how == "quantize")
    state["model"] = model
    return leaves(model)


def build_random(mesh, cfg, seed: int, state: dict) -> None:
    """The rank's shard_model(quantize=True) shard of `random_dense_params`
    drawn from `seed` on the rank's device, layer by layer (each rank draws
    the same weights), kept as state["model"]."""
    from eetq_tpu_torch.models.init import random_dense_layers, random_dense_params

    _no_jax()
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    layers = random_dense_layers(cfg, gen)
    stub = random_dense_params(dataclasses.replace(cfg, num_layers=0),
                               torch.Generator(device=mesh.device).manual_seed(seed + 1))
    state["model"] = shard_model(stub, cfg, mesh, quantize=True, layers=layers)


def load_and_shard(mesh, path: str, state: dict) -> dict:
    """`from_quantized(path).shard(mesh)`, kept as state["model"]; its leaves."""
    _no_jax()
    state["model"] = AutoEETQForCausalLM.from_quantized(path, device="cpu").shard(mesh=mesh)
    return leaves(state["model"])


@torch.inference_mode()
def forward(mesh, tokens: np.ndarray, steps: np.ndarray, state: dict) -> dict:
    """Prefill `tokens` [B, S] into fresh caches, then one teacher-forced
    decode step a column of `steps` [B, n]: {"prefill": logits [B, S, V],
    "decode": [n, B, V], "counts": the collectives of the prefill, "routes":
    every `modules.moe.route` call's (weights, ids) in order, "launches": the
    kernel launches of the whole task}."""
    from eetq_tpu_torch.modules import moe

    _no_jax()
    route, routes = moe.route, []

    def recorded(router, x2, top_k):
        routes.append(route(router, x2, top_k))
        return routes[-1]

    moe.route = recorded
    reset_launch_counts()
    try:
        out = _forward(state["model"], tokens, steps)
    finally:
        moe.route = route
    out["routes"] = [(w.cpu().numpy(), i.cpu().numpy()) for w, i in routes]
    out["launches"] = launch_counts()
    return out


def _forward(model, tokens: np.ndarray, steps: np.ndarray) -> dict:
    b, s = tokens.shape
    caches = model.init_caches(b, s + steps.shape[1] + 1)
    logits = []

    fwd = make_forward_fn(model)

    def step(toks, pos, offset):
        lg, _ = fwd(model.params, torch.as_tensor(toks, dtype=torch.int64, device=dev), pos,
                    caches, offset)
        logits.append(lg.cpu().numpy())

    dev = model.mesh.device
    counts = count_collectives(step, tokens, torch.arange(s, device=dev).expand(b, s), 0)
    for j in range(steps.shape[1]):
        step(steps[:, j:j + 1], torch.full((b, 1), s + j, device=dev), s + j)
    return {"prefill": logits[0], "decode": np.stack([lg[:, -1] for lg in logits[1:]], axis=0)
            if len(logits) > 1 else None, "counts": counts}


def serve(mesh, requests: list, engine_kw: dict, state: dict) -> list:
    """Engine(state["model"], **engine_kw) over `requests`, each (prompt,
    max_new_tokens, add_request keywords): their tokens in order."""
    _no_jax()
    eng = Engine(state["model"], **engine_kw)
    uids = [eng.add_request(p, n, **kw) for p, n, kw in requests]
    eng.run()
    return [eng.result(u) for u in uids]


def fail(mesh, what: str) -> None:
    raise RuntimeError(what)


def sleep(mesh, seconds: float) -> None:
    import time

    time.sleep(seconds)
