"""Rank tasks of the data-parallel and server-over-ranks tests
(`test_torch_data_parallel.py`, `test_torch_server_ranks.py`), run by
`eetq_tpu_torch.dist.launch.RankPool` in spawned processes. Like
`torch_sharding_tasks.py`, this module imports no JAX and each task checks
that none is loaded. A task takes the pool's mesh of the whole world first;
the tasks make their (data, pipe, model) meshes from it once a shape and
keep them, and the model, in the rank's `state`. What a task returns is
numpy or plain Python."""

from __future__ import annotations

import http.client
import json
import os
import threading
import time

import numpy as np
import torch

from eetq_tpu_torch.dist import multihost
from eetq_tpu_torch.dist.multihost import make_hybrid_mesh
from eetq_tpu_torch.dist.pipeline import (
    init_pp_caches,
    make_pp_mesh,
    pp_decode_loop,
    pp_generate,
    pp_prefill,
    shard_model_pp,
)
from eetq_tpu_torch.dist.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    collective_counts,
    make_forward_fn,
    make_mesh,
    shard_model,
)
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.serve.api import EngineServer, follow
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.surgery.tp_reshard import shard_quantized
from eetq_tpu_torch.utils.profiling import count_collectives
from torch_sharding_tasks import _no_jax


def start_pools(worlds, tmp_path_factory) -> dict:
    """{world: RankPool(world)} on the CPU for a test module, the pools
    started side by side (their ranks import torch at once); a pool that
    fails to start raises here after the others are closed."""
    from eetq_tpu_torch.dist.launch import RankPool

    rdv = {w: tmp_path_factory.mktemp(f"rdv{w}") / "store" for w in worlds}
    made, errors = {}, []

    def start(w: int) -> None:
        try:
            made[w] = RankPool(w, f"file://{rdv[w]}", device="cpu", threads=1, timeout_s=300)
        except Exception as e:  # raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=start, args=(w,)) for w in worlds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for pool in made.values():
            pool.close()
        raise errors[0]
    return made


def close_pools(pools: dict) -> None:
    """Close `start_pools`' pools side by side."""
    threads = [threading.Thread(target=pool.close) for pool in pools.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _mesh(mesh, tp: int, dp: int, state: dict, pp: int = 1):
    """The (data, pipe, model) mesh of dp x pp x tp over the pool's world, made once."""
    key = ("mesh", dp, pp, tp)
    if key not in state:
        state[key] = make_mesh(tp=tp, dp=dp, pp=pp, device=mesh.device)
    return state[key]


def _place(m) -> dict:
    """A mesh's sizes and this rank's indices, and the sums of the global
    ranks over its data and model axes (one all-reduce each)."""
    ranks = torch.tensor([m.rank])
    return {"sizes": (m.dp, m.pp, m.tp), "index": (m.dp_rank, m.tp_rank),
            "data_sum": int(m.all_reduce_(ranks.clone(), DATA_AXIS)),
            "model_sum": int(m.all_reduce_(ranks.clone(), MODEL_AXIS)),
            "gathered": m.gather_rows(ranks[None]).ravel().tolist()}


def _error(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def mesh_layouts(mesh) -> dict:
    """make_mesh(tp=2, dp=2) and make_hybrid_mesh(tp=2, dp=2) on a world of 4:
    each one's `_place`; the refusals of tp = dp = 3; make_hybrid_mesh's
    defaults under LOCAL_WORLD_SIZE=2 and under host names of two ranks a
    host; and its refusal of a model group across hosts."""
    _no_jax()
    dev = mesh.device
    out = {"make_mesh": _place(make_mesh(tp=2, dp=2, device=dev)),
           "hybrid": _place(make_hybrid_mesh(tp=2, dp=2, device=dev)),
           "mesh_3x3": _error(lambda: make_mesh(tp=3, dp=3, device=dev)),
           "hybrid_3x3": _error(lambda: make_hybrid_mesh(tp=3, dp=3, device=dev))}
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        out["local_world"] = _place(make_hybrid_mesh(device=dev))
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    name = multihost._host_name
    try:
        multihost._host_name = lambda: f"host{mesh.rank // 2}"
        out["by_host"] = _place(make_hybrid_mesh(device=dev))
        multihost._host_name = lambda: f"host{mesh.rank % 2}"
        out["across_hosts"] = _error(lambda: make_hybrid_mesh(tp=2, device=dev))
    finally:
        multihost._host_name = name
    return out


def dp_build(mesh, tp: int, dp: int, tree: dict, cfg, how: str, state: dict) -> None:
    """This rank's shard on the dp x tp mesh of the numpy model `tree`
    (`params_from_numpy`): how "dense" / "quantize" (`shard_model`) or
    "quantized" (`shard_quantized` of a quantized tree), kept as
    state["model"]."""
    _no_jax()
    m = _mesh(mesh, tp, dp, state)
    params = params_from_numpy(tree, device="cpu")
    state["model"] = (shard_quantized(params, cfg, m) if how == "quantized"
                      else shard_model(params, cfg, m, quantize=how == "quantize"))


def build_random_tp(mesh, tp: int, dp: int, cfg, seed: int, state: dict) -> None:
    """`shard_quantized` on the dp x tp mesh of `quantize_params_tp(tp)` of
    the dense model drawn from `seed` (the same on every rank), kept as
    state["model"]."""
    from eetq_tpu_torch.models.init import random_dense_params
    from eetq_tpu_torch.surgery.tp_reshard import quantize_params_tp

    _no_jax()
    dense = random_dense_params(cfg, torch.Generator().manual_seed(seed))
    state["model"] = shard_quantized(quantize_params_tp(dense, cfg, tp), cfg,
                                     _mesh(mesh, tp, dp, state))


def build_random_dp(mesh, tp: int, dp: int, cfg, seed: int, state: dict) -> None:
    """`torch_sharding_tasks.build_random` on the dp x tp mesh: the rank's
    shard_model(quantize=True) shard of the model drawn from `seed` on its
    device, layer by layer, kept as state["model"]."""
    import dataclasses

    from eetq_tpu_torch.models.init import random_dense_layers, random_dense_params

    _no_jax()
    m = _mesh(mesh, tp, dp, state)
    layers = random_dense_layers(cfg, torch.Generator(device=m.device).manual_seed(seed))
    stub = random_dense_params(dataclasses.replace(cfg, num_layers=0),
                               torch.Generator(device=m.device).manual_seed(seed + 1))
    state["model"] = shard_model(stub, cfg, m, quantize=True, layers=layers)


@torch.inference_mode()
def dp_forward(mesh, tokens: np.ndarray, steps: np.ndarray, state: dict) -> dict:
    """The global batch `tokens` [B, S] prefilled through `make_forward_fn`
    into fresh caches of the shard's rows, then a teacher-forced decode step
    a column of `steps` [B, n] at per-row offsets: the shard's own prefill
    logits ("local"), every forward's logits gathered over `data`
    ("prefill" [B, S, V], "decode" [n, B, V]), the collectives of the
    prefill forward alone ("counts") and of the gathers ("gathers"), and
    every `modules.moe.route` call's (weights, ids) in order."""
    from eetq_tpu_torch.modules import moe

    _no_jax()
    model = state["model"]
    m, dev = model.mesh, model.mesh.device
    route, routes = moe.route, []

    def recorded(router, x2, top_k):
        routes.append(route(router, x2, top_k))
        return routes[-1]

    moe.route = recorded
    try:
        b, s = tokens.shape
        caches = model.init_caches(b, s + steps.shape[1] + 1)
        fwd = make_forward_fn(model)
        local = []

        def step(toks, pos, offset):
            lg, _ = fwd(model.params, torch.as_tensor(toks, dtype=torch.int64, device=dev), pos,
                        caches, offset)
            local.append(lg)

        counts = count_collectives(step, tokens, torch.arange(s, device=dev).expand(b, s), 0)
        for j in range(steps.shape[1]):
            step(steps[:, j:j + 1], torch.full((b, 1), s + j, device=dev),
                 torch.full((b,), s + j, device=dev))
        gathers = count_collectives(lambda: local.extend(m.gather_rows(lg) for lg in list(local)))
    finally:
        moe.route = route
    whole = [lg.numpy() for lg in local[len(local) // 2:]]
    return {"local": local[0].numpy(), "prefill": whole[0],
            "decode": np.stack([lg[:, -1] for lg in whole[1:]]) if len(whole) > 1 else None,
            "counts": counts, "gathers": gathers,
            "routes": [(w.numpy(), i.numpy()) for w, i in routes], "dp_rank": m.dp_rank}


def _engine(state: dict, engine_kw: dict) -> Engine:
    """Engine(state["model"]) whose admission rounds are counted in
    eng.rounds (a list of each round's request count)."""
    eng = Engine(state["model"], **engine_kw)
    eng.rounds = []
    group = eng._prefill_group

    def counted(assignments):
        eng.rounds.append(len(assignments))
        return group(assignments)

    eng._prefill_group = counted
    return eng


def dp_serve(mesh, requests: list, engine_kw: dict, state: dict) -> dict:
    """Engine(state["model"], **engine_kw) over `requests`, each (prompt,
    max_new_tokens, add_request keywords): their tokens in order, the
    admission rounds' sizes, the spec rounds and the data-axis gathers."""
    _no_jax()
    eng = _engine(state, engine_kw)
    uids = [eng.add_request(p, n, **kw) for p, n, kw in requests]
    before = collective_counts()
    eng.run()
    after = collective_counts()
    return {"outputs": [eng.result(u) for u in uids], "rounds": eng.rounds,
            "spec_rounds": eng.spec_rounds,
            "collectives": {k: v - before.get(k, 0) for k, v in after.items()}}


def dp_pp(mesh, pp: int, tp: int, dp: int, tree: dict, cfg, prompt: np.ndarray, n: int, m: int,
          twins: np.ndarray, state: dict) -> dict:
    """The dp x pp x tp mesh's stage of the numpy model `tree`
    (shard_model_pp(quantize=True)): greedy pp_generate of `prompt`, its
    collectives; then pp_prefill of `twins` (rows whose data shards hold
    the same prompts) and a sampled pp_decode_loop of n tokens from its
    argmax (temperature 4: a flat distribution; the default generator)."""
    _no_jax()
    pmesh = state.get(("pp", dp, pp, tp))
    if pmesh is None:
        pmesh = state[("pp", dp, pp, tp)] = make_pp_mesh(pp, tp, dp, device=mesh.device)
    model = shard_model_pp(params_from_numpy(tree, device="cpu"), cfg, pmesh, quantize=True)
    got = {}
    counts = count_collectives(lambda: got.setdefault("toks", pp_generate(
        model, torch.from_numpy(prompt).long(), n, microbatches=m)))
    b, s = twins.shape
    caches = init_pp_caches(model, b, s + n)
    logits, caches = pp_prefill(model, torch.from_numpy(twins).long(), caches, microbatches=m)
    sampled, _ = pp_decode_loop(model, torch.argmax(logits, -1), s, caches, n, microbatches=m,
                                temperature=4.0)
    return {"tokens": got["toks"].numpy(), "counts": counts, "sampled": sampled.numpy(),
            "place": (pmesh.dp_rank, pmesh.pp_rank, pmesh.tp_rank)}


def _post(port: int, body: dict) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    raw = r.read()
    if not body.get("stream"):
        return {"status": r.status, **json.loads(raw)}
    events = [json.loads(line[len(b"data: "):]) for line in raw.split(b"\n\n")
              if line.startswith(b"data: ")]
    return {"status": r.status, "tokens": [t for ev in events for t in ev["tokens"]],
            "done": bool(events) and events[-1]["done"]}


def _health(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("GET", "/health")
    r = conn.getresponse()
    return {"status": r.status, **json.loads(r.read())}


def serve_http(mesh, tp: int, dp: int, bodies: list, heartbeat_s: float, idle_s: float,
               engine_kw: dict, state: dict) -> dict:
    """`EngineServer` over the ranks of state["model"] (built on the dp x tp
    mesh): rank 0 serves HTTP and the others `follow`. Rank 0 asks /health,
    posts the first half of `bodies` from one thread each, waits idle_s
    (the followers then see heartbeats), posts the rest, asks /health again
    and shuts the server down; every rank returns its engine's outputs by
    uid, rank 0 the answers, a follower what `follow` returned."""
    _no_jax()
    eng = Engine(state["model"], **engine_kw)
    out = {}
    if _mesh(mesh, tp, dp, state).rank != 0:
        out["follow"] = follow(eng)
    else:
        srv = EngineServer(eng, port=0, heartbeat_s=heartbeat_s)
        srv.start()
        try:
            answers: dict[int, dict] = {}

            def post(i: int) -> None:
                answers[i] = _post(srv.port, bodies[i])

            out["health"] = [_health(srv.port)]
            half = len(bodies) // 2
            for part in (range(half), range(half, len(bodies))):
                threads = [threading.Thread(target=post, args=(i,)) for i in part]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                if part.start == 0:
                    time.sleep(idle_s)
            out["health"].append(_health(srv.port))
            out["answers"] = [answers[i] for i in range(len(bodies))]
        finally:
            srv.shutdown()
    out["outputs"] = {uid: list(r.out_tokens) for uid, r in eng.requests.items()}
    return out
