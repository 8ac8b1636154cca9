#!/usr/bin/env python3
"""Put the card's idle gaps in a traced benchmark run down to what the
program's host was doing, from the serving trace
(`eetq_tpu_torch/serve/tracing.py`).

    python3 scripts/torch_trace_gaps.py --workload <cell> --seed <n> --seconds <s> \
        [--top 10] [--out FILE]

Runs one traced run of the benchmark (`servebench/harness.py`, `--trace 1`)
in this process, keeps the run data and the engine's trace that the metric
readers see, and then, over the profiled stretch of the window:

- the `--top` longest gaps with no operation on the card, each with the
  phase the scheduler was in at its midpoint (`admission.launch`,
  `decode.fetch`, ... from the phase stamps; `step` inside a step but
  outside its admission and decode calls; `between steps` outside every
  step: the scheduler waiting for, or handing off, the server's lock), the
  step's path and time off the CPU (where the trace read its CPU time: a
  step begun `tracing.CPU_GAP_NS` or more after the last one read), and the
  garbage collections inside it;
- the idle time summed by phase, and each phase's median and longest
  duration over the window's steps;
- the collections of the window by generation (count, ms, the longest);
- the tokens a second the clients got in the window, and the medians of
  the window's requests' wait for the server's lock (`added - received`)
  and of their add lag (`added` less the client's send).

The run's own result line goes to stdout as the benchmark prints it; the
analysis is printed on stderr and, with `--out`, written as JSON.
"""

import argparse
import bisect
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from servebench import harness  # noqa: E402
from servebench.trace import union  # noqa: E402


def keep_what_readers_see(seen: dict) -> None:
    real = harness.load_reader

    def load_reader(root, name):
        read = real(root, name)

        def keep(run):
            from eetq_tpu_torch.serve import tracing

            seen["run"], seen["trace"] = run, tracing.current()
            seen["gcs"] = tracing.gc_records()
            return read(run)

        return keep

    harness.load_reader = load_reader


def phases(call) -> dict[str, float]:
    """ms of each phase of an admission or decode call, by its range's name."""
    names = [name.removeprefix("eetq.") for name in call.RANGES.values()]
    stamps = [getattr(call, stamp) for stamp in call.RANGES] + [call.committed]
    return {n: (b - a) / 1e6 for n, a, b in zip(names, stamps, stamps[1:])
            if a is not None and b is not None}


def phase_at(t: int, steps, starts) -> tuple[str, object]:
    """The scheduler's phase at t, and the step it fell in (or None)."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0 or steps[i].t1 <= t:
        return "between steps", None
    s = steps[i]
    for call in (s.admission, s.decode):
        if call is None:
            continue
        a = call.start
        for name, ms in phases(call).items():
            b = a + int(ms * 1e6)
            if a <= t < b:
                return name, s
            a = b
    return "step", s


def analyse(run, trace, gcs, top: int) -> dict:
    lo, hi = run.profiled
    ws, we = run.window
    steps = sorted(trace.steps, key=lambda s: s.t0)
    starts = [s.t0 for s in steps]
    gaps, prev = [], lo
    for a, b in union(run.timeline.overlapping(lo, hi), lo, hi) + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by_phase: dict[str, float] = {}
    rows = []
    for a, b in gaps:
        phase, s = phase_at((a + b) // 2, steps, starts)
        by_phase[phase] = by_phase.get(phase, 0.0) + (b - a) / 1e6
        rows.append((a, b, phase, s))
    rows.sort(key=lambda r: r[0] - r[1])
    longest = []
    for a, b, phase, s in rows[:top]:
        inside = [(max(g0, a), min(g1, b), gen) for g0, g1, gen in gcs if g0 < b and g1 > a]
        longest.append({
            "at_s": (a - ws) / 1e9, "ms": (b - a) / 1e6, "phase": phase,
            "step_path": None if s is None else s.path,
            "step_ms": None if s is None else (s.t1 - s.t0) / 1e6,
            "step_offcpu_ms": None if s is None or s.cpu_ns is None
            else (s.t1 - s.t0 - s.cpu_ns) / 1e6,
            "step_phases_ms": {} if s is None else {
                k: round(v, 3) for c in (s.admission, s.decode) if c is not None
                for k, v in phases(c).items()},
            "gc_ms": sum(y - x for x, y, _ in inside) / 1e6,
            "gc_generations": sorted({gen for _, _, gen in inside}),
        })
    window_gcs = [(a, b, gen) for a, b, gen in gcs if ws <= a < we]
    by_gen = {}
    for a, b, gen in window_gcs:
        n, ms, most = by_gen.get(gen, (0, 0.0, 0.0))
        by_gen[gen] = (n + 1, ms + (b - a) / 1e6, max(most, (b - a) / 1e6))
    in_window = [s for s in steps if ws <= s.t0 < we]
    sampled = [s for s in in_window if s.cpu_ns is not None]
    wall = sum(s.t1 - s.t0 for s in sampled)
    records = trace.request_records()
    lags = {"lock_wait_ms": [], "add_lag_ms": []}
    for r in run.requests:
        rec = records.get(r.get("uid"))
        if rec is not None and rec.received is not None:
            lags["lock_wait_ms"].append((rec.added - rec.received) / 1e6)
            lags["add_lag_ms"].append((rec.added - r["sent"]) / 1e6)
    by_name: dict[str, list[float]] = {}
    for s in in_window:
        for c in (s.admission, s.decode):
            if c is not None:
                for k, v in phases(c).items():
                    by_name.setdefault(k, []).append(v)
    return {
        "out_tok_s": sum(r["in_window"] for r in run.all_records) / run.seconds,
        "phase_ms_median_max": {k: (statistics.median(v), max(v)) for k, v in by_name.items()},
        "median_ms": {k: statistics.median(v) if v else None for k, v in lags.items()},
        "profiled_s": (hi - lo) / 1e9,
        "idle_ms_by_phase": {k: round(v, 3) for k, v in sorted(by_phase.items(),
                                                                 key=lambda kv: -kv[1])},
        "longest_gaps": longest,
        "gc_by_generation": {gen: {"count": n, "ms": ms, "longest_ms": most}
                             for gen, (n, ms, most) in sorted(by_gen.items())},
        "steps_in_window": len(in_window),
        "steps_with_cpu": len(sampled),
        "offcpu_ms_of_those": (wall - sum(s.cpu_ns for s in sampled)) / 1e6,
        "wall_ms_of_those": wall / 1e6,
        "longest_offcpu_steps": sorted(
            ({"at_s": (s.t0 - ws) / 1e9, "path": s.path, "ms": (s.t1 - s.t0) / 1e6,
              "offcpu_ms": (s.t1 - s.t0 - s.cpu_ns) / 1e6} for s in sampled),
            key=lambda r: -r["offcpu_ms"])[:top],
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--out", type=Path)
    args = p.parse_args()
    seen: dict = {}
    keep_what_readers_see(seen)
    code = harness.run(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                        str(args.seconds), "--trace", "1"])
    if code or seen.get("trace") is None or seen["run"].timeline is None:
        print("torch_trace_gaps: no traced run with the program's trace to read",
              file=sys.stderr)
        return code or 1
    out = analyse(seen["run"], seen["trace"], seen["gcs"], args.top)
    text = json.dumps(out, indent=1)
    print(text, file=sys.stderr)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
