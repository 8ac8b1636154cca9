"""One run of one cell of the benchmark (`run.py` is its command line).

A run: read the cell from BENCHMARK.json and its files by name (the
configuration, `workloads/<cell>.json`, `traffic/<mix>.json`); build the
deployment on the card from the seed and serve it (`deploy.py`); start the
client process (`client.py`, `traffic/<kind>.py`); warm in; measure for
`--seconds`; follow the window's requests to their end; read the metrics
(`metrics/<name>.py`: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer ones, from a profiled stretch of the window); free
the deployment; judge the served tokens (`reference/check.py`); print the
numbers compared beside their limits on stderr and the result as the last
line of stdout.

`correct` holds when every window request came back whole (its budget of
tokens, `failed` = 0), the tokens each stream carried are the tokens the
engine committed, and the mean gap of a served token's logit below the f32
reference's best, over a sample with the longest request in it, is within
the cell's limit (on an MoE model with the program's routing replayed, and
the routing itself within its own limit: `reference/check.py`).

Not part of the run's contract: `--control`, a run of the control. The
fp8 control (`reference/check.py`) is put in the program's place: its
numbers stand where the program's would, against the same limits, so such
a run prints `correct` false; the program's own gaps go to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eetq_tpu")
DRAIN_S = 90.0  # how long past the window the run waits for the window's requests
PROFILE_AT = 0.4  # the profiled stretch starts this far into the window
PROFILE_S = 3.0  # and lasts this long


def process_start_ns() -> int:
    """When this process started, on the monotonic clock: the kernel's
    record of the start, in clock ticks since boot."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    return time.monotonic_ns() - int(since * 1e9)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_reader(root: Path, name: str):
    path = root / "servebench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"servebench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json and the files it names."""

    name: str
    chips: int
    hf: dict  # the configuration file
    spec: dict  # workloads/<cell>.json
    mix: dict  # traffic/<mix>.json
    end_to_end: list[dict]
    per_layer: list[dict]


def load_cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    bench = bench or json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=int(entry["chips"]),
        hf=json.loads((root / config["file"]).read_text()),
        spec=json.loads((root / "servebench" / "workloads" / f"{name}.json").read_text()),
        mix=json.loads((root / "servebench" / "traffic" / f"{entry['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


@dataclasses.dataclass
class RunData:
    """What the metric readers read (`metrics/<name>.py`)."""

    cfg: dict
    seconds: float
    window: tuple[int, int]
    setup_s: float
    requests: list[dict]  # the window's requests, with "uid" where the engine had them
    all_records: list[dict]
    latency: dict  # stats.latencies of the window's requests
    spans: list = dataclasses.field(default_factory=list)
    added: dict = dataclasses.field(default_factory=dict)
    first_commit: dict = dataclasses.field(default_factory=dict)
    timeline: object = None  # trace.Timeline of the profiled stretch
    profiled: tuple[int, int] | None = None
    peaks: dict | None = None
    classes: list = dataclasses.field(default_factory=list)

    def in_window(self, kind: str) -> list[tuple]:
        ws, we = self.window
        return [(t0, t1, info) for k, t0, t1, info in self.spans if k == kind and ws <= t0 < we]

    def profiled_spans(self, kind: str) -> list[tuple]:
        if self.profiled is None:
            return []
        lo, hi = self.profiled
        return [(t0, t1, info) for k, t0, t1, info in self.spans
                if k == kind and lo <= t0 and t1 <= hi]

    def kernel_class(self, name: str) -> str:
        from servebench.trace import classify

        return classify(name, self.classes)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="judge the fp8 control in the program's place (a run that must fail)")
    return p.parse_args(argv)


class Client:
    """The client process (`client.py`) for one stretch of traffic."""

    def __init__(self, root: Path, plan: dict):
        self.proc = subprocess.Popen([sys.executable, str(root / "servebench" / "client.py")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.proc.stdin.write(json.dumps(plan) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line or not json.loads(line).get("ready"):
            raise RuntimeError("the client process did not start")

    def go(self, t0: int) -> None:
        self.proc.stdin.write(json.dumps({"t0": t0}) + "\n")
        self.proc.stdin.flush()

    def result(self, timeout_s: float) -> list[dict]:
        out: list = []
        th = threading.Thread(target=lambda: out.append(self.proc.stdout.readline()), daemon=True)
        th.start()
        th.join(timeout_s)
        if not out or not out[0]:
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError("the client process gave no result")
        self.proc.wait(timeout=30)
        return json.loads(out[0])["records"]


def offer(root: Path, cell: Cell, engine, server, seed: int, seconds: float, warm_in: float,
          drain_s: float, profile: Profiled | None = None):
    """One stretch of traffic: the client's warm-in, window and drain.
    Returns (records, ws, we, end_ns)."""
    plan = {"host": server.host, "port": server.port, "kind": cell.mix["kind"], "mix": cell.mix,
            "cell": cell.spec, "seed": seed, "seconds": seconds, "warm_in_s": warm_in,
            "drain_s": drain_s, "vocab": cell.hf["vocab_size"]}
    client = Client(root, plan)
    t0 = time.monotonic_ns() + 50_000_000
    ws = t0 + int(warm_in * 1e9)
    we = ws + int(seconds * 1e9)
    client.go(t0)
    if profile is not None:
        profile.run(engine, ws + int(PROFILE_AT * seconds * 1e9), min(PROFILE_S, seconds / 2))
    records = client.result(warm_in + seconds + drain_s + 120.0)
    return records, ws, we, time.monotonic_ns()


class Profiled:
    """`torch.profiler` over a stretch of the window, run from the calling
    thread while the server's threads serve: every operation the card runs
    is recorded, whichever thread launched it. A first, empty profile at
    construction (set-up) loads the profiler, so the window's start is
    quick. lo and hi: the stretch recorded, on the monotonic clock; offset:
    the profiler's clock less the monotonic clock."""

    def __init__(self, device):
        import torch

        self.device = device
        self.acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=self.acts):
            torch.zeros(1, device=device).add_(1)
            self._sync()

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, engine, start: int, seconds: float) -> "Profiled":
        """Record from `start` for `seconds`; blocks until done. The profiler
        starts and stops between two engine steps (`between_steps`): started
        or stopped beside a thread launching an admission, it hung two of
        five traced prefill runs on the card."""
        import torch

        self.prof = torch.profiler.profile(activities=self.acts)
        _sleep_until(start)
        engine.between_steps(self._start)
        _sleep_until(self.lo + int(seconds * 1e9))
        engine.between_steps(self._stop)
        return self

    def _start(self) -> None:
        self._sync()
        self.prof.start()
        self.lo = time.monotonic_ns()
        self.offset = time.time_ns() - time.monotonic_ns()

    def _stop(self) -> None:
        self._sync()
        self.hi = time.monotonic_ns()
        self.prof.stop()


def _sleep_until(t: int) -> None:
    while (left := t - time.monotonic_ns()) > 0:
        time.sleep(min(left / 1e9, 0.05))


def join_uids(records: list[dict], engine) -> int:
    """Give each window record its engine uid (requests are told apart by
    their prompts, which are random); returns how many streams differ from
    what the engine committed."""
    by_prompt = {tuple(r.prompt): r for r in engine.requests.values()}
    mismatch = 0
    for rec in records:
        req = by_prompt.get(tuple(rec["prompt"]))
        if req is None:
            mismatch += rec["ok"]
            continue
        rec["uid"] = req.uid
        if rec["ok"] and list(req.out_tokens) != rec["tokens"]:
            mismatch += 1
    return mismatch


def free() -> None:
    """Give the dropped deployment's memory back to the card, once the HTTP
    handlers' threads (which hold the server) have ended."""
    import torch

    for _ in range(50):
        if not any("process_request" in t.name for t in threading.enumerate()):
            break
        time.sleep(0.1)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(argv=None, *, device=None, root: Path = ROOT, bench: dict | None = None) -> int:
    """One run; returns the exit code. device=None asks for the card (and
    exits 2 without one); tests pass a CPU device and a benchmark dict."""
    started = process_start_ns()
    args = parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / ".servebench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / ".servebench_cache" / "torch_ext"))
    import torch

    cell = load_cell(root, args.workload, bench)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"servebench: the cell asks for {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    from servebench import deploy

    server, engine, setup = deploy.serve(cell.hf, args.seed, device, traced=bool(args.trace))
    warm_in = float(cell.spec["warm_in_s"])
    profiled = Profiled(device) if args.trace else None
    records, ws, we, end_ns = offer(root, cell, engine, server, args.seed, args.seconds, warm_in,
                                    DRAIN_S, profile=profiled)
    server.shutdown()
    window = [r for r in records if r["phase"] == "window"]
    mismatch = join_uids(window, engine)
    on_card = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    from servebench import stats

    data = RunData(cfg=cell.hf, seconds=args.seconds, window=(ws, we),
                   setup_s=(ws - started) / 1e9, requests=window, all_records=records,
                   latency=stats.latencies(window, end_ns))
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if args.trace:
        breakdown = read_trace(data, engine, profiled, device_info, on_card)
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = load_reader(root, m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"servebench: setup {setup} ; window requests {len(window)}, all {len(records)}",
          file=sys.stderr)
    failed = sum(not r["ok"] for r in window)
    from servebench.reference import check

    sample = check.sample(window, args.seed)
    routing = getattr(engine, "routing", None)
    routes = None
    if routing is not None:
        cost_ns, stretches = routing.cost_in(ws, we)
        print(f"servebench: routing log: {cost_ns / 1e6:.3f} ms of host time in the window "
              f"({100 * cost_ns / (we - ws):.4f}% of it) over {stretches} stretches, "
              f"{routing.replays_in(ws, we)} of them after a graph replay (one stack and one "
              f"cast on the card each)", file=sys.stderr)
        routes = [routing.routes(r["uid"], r["prompt_len"] + r["n"] - 1) if "uid" in r else None
                  for r in sample]
    engine = server = routing = None  # noqa: F841 (drop the deployment before the reference)
    free()
    checks = judge(cell, args, device, sample, routes, failed, mismatch)
    bad = forbidden_modules()
    if bad:
        print(f"servebench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    correct = all(value <= limit for value, limit in checks.values())
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    result = {"correct": correct, "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    print(json.dumps(result))
    return 0


def read_trace(data: RunData, engine, profiled: Profiled, device_info: dict, on_card: bool):
    """Fill `data` with the traced engine's spans and the profiled stretch;
    set busy_s and window_s; return the breakdown."""
    from servebench import peaks as peak_table
    from servebench import trace

    data.spans, data.added, data.first_commit = engine.spans, engine.added, engine.first_commit
    data.classes = trace.kernel_classes()
    if on_card:
        data.peaks = peak_table.peaks(device_info["kind"])
    lo, hi = profiled.lo, profiled.hi
    data.profiled = (lo, hi)
    data.timeline = trace.Timeline(trace.device_ops(profiled.prof, profiled.offset))
    device_info["busy_s"] = data.timeline.busy_ns(lo, hi) / 1e9
    device_info["window_s"] = (hi - lo) / 1e9
    seen: dict[str, set] = {}
    for name, a, _ in data.timeline.started(lo, hi):
        seen.setdefault(data.kernel_class(name), set()).add(trace.short_name(name))
    print(f"servebench: device operations by class: "
          f"{ {k: sorted(v) for k, v in sorted(seen.items())} }", file=sys.stderr)
    labelled = [(k, t0, t1) for k, t0, t1, _ in engine.spans if k in ("admission", "decode")]
    return data.timeline.breakdown(lo, hi, labelled)


def judge(cell: Cell, args, device, sample: list[dict], routes: list | None, failed: int,
          mismatch: int) -> dict:
    """{name: (value, limit)} of the numbers that decide `correct`."""
    from servebench.reference import check

    limits = cell.spec["limits"]
    checks = {"failed_requests": (failed, 0), "stream_mismatch": (mismatch, 0)}
    nan = float("nan")
    if routes is not None:
        checks["unrouted_requests"] = (sum(r is None for r in routes), 0)
    if not sample or (routes is not None and any(r is None for r in routes)):
        checks["mean_logit_gap"] = (nan, limits["mean_logit_gap"])
        if routes is not None:
            checks["mean_route_gap"] = (nan, limits["mean_route_gap"])
        return checks
    t0 = time.perf_counter()
    got = check.logit_gaps(cell.hf, args.seed, device, sample, routes, control=args.control)
    print(f"servebench: reference over {got['requests']} requests, {got['tokens']} served "
          f"tokens in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(f"servebench: gaps of the served tokens {json.dumps(got['program'])}", file=sys.stderr)
    if args.control:  # the control stands in the program's place
        print(f"servebench: the program's mean_logit_gap {got['mean_logit_gap']!r} "
              f"mean_route_gap {got.get('mean_route_gap')!r}; in its place the control's "
              f"{json.dumps(got['control'])}", file=sys.stderr)
        got["mean_logit_gap"] = got["control_gap"]
        got["mean_route_gap"] = got.get("control_route_gap")
    checks["mean_logit_gap"] = (got["mean_logit_gap"], limits["mean_logit_gap"])
    if routes is not None:
        checks["mean_route_gap"] = (got["mean_route_gap"], limits["mean_route_gap"])
    return checks

