"""The system under test: the port's model, engine and HTTP server.

This is the one module of the benchmark that imports `eetq_tpu_torch`. It
hands each layer's bf16 weights (`weights.py`) to the port's quantizer as a
loader would (`quantize_linear`, `quantize_moe`: W8A16 per channel, the
lm_head left bf16, the routers bf16), builds `serve.engine.Engine` with the
configuration's engine settings and otherwise its defaults, and serves it
behind `serve.api.EngineServer` on 127.0.0.1 at a port the system picks.

`BenchEngine` is the engine with the benchmark's spans around the calls
into each layer (`add_request`, `_prefill_group`, `_decode`, `_commit`,
`step`), kept in memory as plain tuples of `time.monotonic_ns()` stamps,
and on an MoE model the experts its router chose for every served token
(`RoutingLog`), which the check replays in the reference. A traced run
(`--trace 1`) serves through it; a timed run of a dense model serves
through the plain `Engine`, and of an MoE model through `BenchEngine` with
the routing log alone (a few small copies to the host after each
admission and each decode window's fetch, one stack and one cast on the
card after each graph replay). The log times its own host work, and the
harness prints its share of the window.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

import eetq_tpu_torch.modules.moe as moe_module
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
from eetq_tpu_torch.modules.linear import DenseLinear, quantize_linear
from eetq_tpu_torch.modules.moe import MoEMLP, quantize_moe
from eetq_tpu_torch.serve.api import EngineServer
from eetq_tpu_torch.serve.engine import Engine

from servebench import weights


def build_params(hf: dict, seed: int, device) -> ModelParams:
    """The deployment's model: each layer drawn in bf16, quantized by the
    port and dropped before the next is drawn, so the peak is the quantized
    model plus one bf16 layer."""
    quant = hf.get("quantize", {})
    bits, group = quant.get("bits", 8), quant.get("group_size")
    h = hf["hidden_size"]
    ones = torch.ones(h, dtype=torch.float32, device=device)
    layers = []
    for i in range(hf["num_hidden_layers"]):
        w = weights.layer_weights(hf, seed, i, device)
        qkv = quantize_linear(w["qkv"], bits=bits, group_size=group)
        o = quantize_linear(w["o"], bits=bits, group_size=group)
        if "router" in w:
            moe = quantize_moe(MoEMLP(DenseLinear(w["router"]), DenseLinear(w["gateup"]),
                                      DenseLinear(w["down"])), bits=bits, group_size=group)
            layers.append(LayerParams(ones.clone(), qkv, o, ones.clone(), moe=moe))
        else:
            layers.append(LayerParams(ones.clone(), qkv, o, ones.clone(),
                                      quantize_linear(w["gateup"], bits=bits, group_size=group),
                                      quantize_linear(w["down"], bits=bits, group_size=group)))
        del w
    head = weights.lm_head(hf, seed, device)
    if quant.get("lm_head"):
        raise ValueError("the deployments serve a bf16 lm_head")
    return ModelParams(weights.embedding(hf, seed, device), layers, ones.clone(),
                       DenseLinear(head))


class RoutingLog:
    """The experts the program's router chose for every token it served.

    `install` wraps the program's `modules.moe.route` so that, between
    `begin` and `end`, each call's top-k ids (a device tensor) are kept.
    An admission's calls are copied to the host after its own fetch; a
    decode program's calls are those of its capture (their memory is the
    graph's, rewritten by every replay), stacked after each replay into
    `ring` on the device and copied to the host after the window's fetch.
    prompt[uid]: int8 [layers, prompt tokens, k]; decode[uid]: (first
    position, int8 [steps, layers, k]) chunks. costs: (start ns, host ns,
    after a replay) of each stretch of the log's own work."""

    def __init__(self):
        self.calls: list | None = None
        self.ring: list = []
        self.prompt: dict[int, np.ndarray] = {}
        self.decode: dict[int, list] = {}
        self.costs: list[tuple[int, int, bool]] = []

    def spent(self, t0: int, replay: bool = False) -> None:
        """Record the log's own work since t0 (`time.monotonic_ns()`)."""
        self.costs.append((t0, time.monotonic_ns() - t0, replay))

    def cost_in(self, lo: int, hi: int) -> tuple[int, int]:
        """(host ns, stretches) of the log's work that began in [lo, hi)."""
        inside = [dt for t, dt, _ in self.costs if lo <= t < hi]
        return sum(inside), len(inside)

    def replays_in(self, lo: int, hi: int) -> int:
        return sum(r for t, _, r in self.costs if lo <= t < hi)

    def install(self) -> None:
        """Wrap the program's router (in place of an earlier log's wrapper)."""
        real = getattr(moe_module.route, "unwrapped", moe_module.route)

        def route(router, x2, top_k):
            topw, topi = real(router, x2, top_k)
            if self.calls is not None:
                self.calls.append(topi)
            return topw, topi

        route.unwrapped = real
        moe_module.route = route

    def begin(self) -> None:
        self.calls = []

    def end(self) -> list:
        calls, self.calls = self.calls, None
        return calls

    def routes(self, uid: int, positions: int) -> np.ndarray | None:
        """[layers, positions, k] of request uid's first `positions`
        positions, or None where the log lacks one."""
        p = self.prompt.get(uid)
        if p is None:
            return None
        out = np.full((p.shape[0], positions, p.shape[2]), -1, np.int8)
        n = min(p.shape[1], positions)
        out[:, :n] = p[:, :n]
        for start, chunk in self.decode.get(uid, []):
            stop = min(start + chunk.shape[0], positions)
            if stop > start:
                out[:, start:stop] = chunk[:stop - start].transpose(1, 0, 2)
        return None if (out < 0).any() else out


class RecordedStep:
    """A decode program whose routing is kept after every call (RoutingLog)."""

    def __init__(self, graph, log: RoutingLog):
        self.graph, self.log, self.tensors = graph, log, []
        inner = graph.fn

        def fn():
            log.begin()
            try:
                inner()
            finally:
                self.tensors = log.end()

        graph.fn = fn

    def __call__(self) -> None:
        self.graph()
        t0 = time.monotonic_ns()
        self.log.ring.append(torch.stack(self.tensors).to(torch.int8))
        self.log.spent(t0, replay=True)

    def __getattr__(self, name):
        return getattr(self.graph, name)


class BenchEngine(Engine):
    """`Engine` with the benchmark's instruments around the calls into each
    layer (`add_request`, `_prefill_group`, `_decode`, `_commit`, `step`).

    traced: spans (kind, start_ns, end_ns, info) kept in memory on
    `time.monotonic_ns()`, kind "admission" (info: the (uid, prompt tokens)
    admitted), "decode" (info: (window, chain, busy), busy the (length,
    remaining budget) of each busy slot as the call begins) and "step";
    added[uid] and first_commit[uid]: when a request was added and when its
    first token was committed. routing: a RoutingLog, on an MoE model."""

    def __init__(self, *args, traced: bool = False, routing: RoutingLog | None = None,
                 **kwargs):
        self.traced, self.routing = traced, routing
        self._park: tuple | None = None  # (parked, resume) events: see between_steps
        self.spans: list[tuple] = []
        self.added: dict[int, int] = {}
        self.first_commit: dict[int, int] = {}
        super().__init__(*args, **kwargs)

    def add_request(self, *args, **kwargs) -> int:
        t = time.monotonic_ns()
        uid = super().add_request(*args, **kwargs)
        if self.traced:
            self.added[uid] = t
        return uid

    def _prefill_group(self, assignments) -> None:
        info = tuple((req.uid, len(req.prompt)) for _, _, req in assignments)
        if self.routing is not None:
            self.routing.begin()
        t0 = time.monotonic_ns()
        super()._prefill_group(assignments)
        if self.traced:
            self.spans.append(("admission", t0, time.monotonic_ns(), info))
        if self.routing is not None:
            t1 = time.monotonic_ns()
            calls = self.routing.end()
            ids = torch.stack(calls).to(torch.int8).cpu().numpy()
            ids = ids.reshape(len(calls), self.prefill_rows, -1, ids.shape[-1])
            for row, _, req in assignments:
                self.routing.prompt[req.uid] = ids[:, row, :len(req.prompt)].copy()
            self.routing.spent(t1)

    def _decode(self, window, chain, temps, topks):
        busy = [(i, r.uid, int(self.lengths[i]), r.max_new_tokens - len(r.out_tokens))
                for i, r in enumerate(self.slot_req) if r is not None and self.lengths[i] > 0]
        if self.routing is not None:
            self.routing.ring = []
        t0 = time.monotonic_ns()
        out = super()._decode(window, chain, temps, topks)
        if self.traced:
            self.spans.append(("decode", t0, time.monotonic_ns(),
                               (window, chain, tuple((n, left) for _, _, n, left in busy))))
        if self.routing is not None:
            t1 = time.monotonic_ns()
            ring = torch.stack(self.routing.ring).cpu().numpy()  # [chain, window * L, B, k]
            layers = ring.shape[1] // window
            steps = ring.reshape(chain * window, layers, ring.shape[2], ring.shape[3])
            for i, uid, length, left in busy:
                n = min(window * chain, left)
                self.routing.decode.setdefault(uid, []).append((length, steps[:n, :, i].copy()))
            self.routing.spent(t1)
        return out

    def _program(self, window: int, sample: bool):
        new = (window, sample) not in self._programs
        graph, out = super()._program(window, sample)
        if new and self.routing is not None:
            graph = RecordedStep(graph, self.routing)
            self._programs[(window, sample)] = (graph, out)
        return graph, out

    def _commit(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        if self.traced and not req.out_tokens:
            self.first_commit[req.uid] = time.monotonic_ns()
        super()._commit(slot, tok)

    def step(self) -> None:
        park = self._park
        if park is not None:  # wait, between two steps, for between_steps
            park[0].set()
            park[1].wait()
        t0 = time.monotonic_ns()
        super().step()
        if self.traced:
            self.spans.append(("step", t0, time.monotonic_ns(), None))

    def between_steps(self, fn, wait_s: float = 10.0) -> None:
        """Run fn in the calling thread while the scheduler's thread waits
        between two steps, so that nothing else launches work on the card
        meanwhile (the profiler is started and stopped so). A step in flight
        ends first; an idle scheduler parks at its next step."""
        parked, resume = threading.Event(), threading.Event()
        self._park = (parked, resume)
        try:
            parked.wait(wait_s)
            fn()
        finally:
            self._park = None
            resume.set()


def config_of(hf: dict) -> ModelConfig:
    """The port's configuration, read from the published config.json keys
    as a user's loader reads them."""
    return ModelConfig.from_hf_config(hf)


def serve(hf: dict, seed: int, device, traced: bool):
    """Build the model, the engine (warmed up: every prompt bucket admitted
    once and the decode programs captured) and the server, started. Returns
    (server, engine, {"weights_s", "engine_s", "warmup_s", "warm_ms",
    "capture_ms"})."""
    cfg = config_of(hf)
    t0 = time.perf_counter()
    params = build_params(hf, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    routing = None
    if cfg.num_experts:
        routing = RoutingLog()
        routing.install()
    if traced or routing is not None:
        engine = BenchEngine(params, cfg, traced=traced, routing=routing, **hf.get("engine", {}))
    else:
        engine = Engine(params, cfg, **hf.get("engine", {}))
    t2 = time.perf_counter()
    engine.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    if traced:
        engine.spans.clear()
        engine.added.clear()
        engine.first_commit.clear()
    if routing is not None:
        routing.prompt.clear()
        routing.decode.clear()
        routing.costs.clear()
    graphs = [g for g, _ in engine._programs.values()]
    server = EngineServer(engine, host="127.0.0.1", port=0)
    server.start()
    return server, engine, {
        "weights_s": t1 - t0, "engine_s": t2 - t1, "warmup_s": t3 - t2,
        "warm_ms": sum(g.warm_ms for g in graphs), "capture_ms": sum(g.capture_ms for g in graphs),
    }
