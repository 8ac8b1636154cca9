"""The per-layer metrics read from the program's own trace
(`eetq_tpu_torch/serve/tracing.py`): whole traced toy runs report all five
within their ranges, the busy slots equal what the benchmark's own decode
spans (`deploy.BenchEngine`) give over the same calls, and the lock wait
lies inside the add lag that contains it."""

import json

import pytest
import torch

from eetq_tpu_torch.serve import tracing
from servebench import harness

NEW = ("api.lock_wait_ms", "sched.offcpu_share", "host.gc_share", "sched.busy_slots",
       "step.admission_pad_share")


def _keep_what_readers_see(monkeypatch) -> dict:
    """Wrap the metric readers so that the run data and the program's
    trace they read stay reachable after the run."""
    seen: dict = {}
    real = harness.load_reader

    def load_reader(root, name):
        read = real(root, name)

        def keep(run):
            seen["run"], seen["trace"] = run, tracing.current()
            return read(run)

        return keep

    monkeypatch.setattr(harness, "load_reader", load_reader)
    return seen


def _bench_busy_slots(run, trace) -> float:
    """The mean busy slots a step from BenchEngine's decode spans, over the
    calls whose trace records began in the window: Σ_j rows busy at step j
    over Σ window x chain, stepped through as the span's readers do."""
    ws, we = run.window
    spans = [(t0, t1, info) for kind, t0, t1, info in run.spans if kind == "decode"]
    rows = steps = 0
    for step in list(trace.steps):
        d = step.decode
        if d is None or not ws <= d.start < we:
            continue
        (w, c, busy), = [info for t0, t1, info in spans if t0 <= d.start <= t1]
        assert (w, c, busy) == (d.window, d.chain, d.busy)
        steps += w * c
        rows += sum(sum(left > j for _, left in busy) for j in range(w * c))
    return rows / steps


@pytest.mark.parametrize("cell", ["toy.chat", "toy-moe.closed"])
def test_traced_run_reports_the_program_trace(capsys, monkeypatch, toy_root, cell):
    seen = _keep_what_readers_see(monkeypatch)
    # the toy window (2 s) is shorter than the gap between the trace's reads
    # of the CPU clock: read it on every step
    monkeypatch.setattr(tracing, "CPU_GAP_NS", 0)
    code = harness.run(["--workload", cell, "--seed", str(2**33 + 17), "--seconds", "2",
                        "--trace", "1"], device=torch.device("cpu"), root=toy_root)
    out, err = capsys.readouterr()
    assert code == 0, err
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, err
    got = {name: res["metrics"][name]["value"] for name in NEW if name in res["metrics"]}
    assert set(got) == set(NEW), res["metrics"]
    for name in ("sched.offcpu_share", "host.gc_share", "step.admission_pad_share"):
        assert 0.0 <= got[name] <= 100.0, (name, got[name])
    assert 0.0 < got["sched.busy_slots"] <= 4  # the toy engine's max_batch
    assert got["step.admission_pad_share"] > 0  # toy prompts fill no bucket exactly
    assert 0.0 <= got["api.lock_wait_ms"] <= res["metrics"]["api.add_lag_ms"]["value"]
    assert got["sched.busy_slots"] == _bench_busy_slots(seen["run"], seen["trace"])
