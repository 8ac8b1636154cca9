"""The serving trace of the port's engine and server
(`eetq_tpu_torch/serve/tracing.py`) on the toy preset: request stamps before
the admissions that took them, an admission's padding, the decode records'
busy rows against the tokens decode committed, the scheduler's CPU time
within its wall time and read by elapsed time, GC records, the profiler
mirror on the program's stamps (and no range without a profiler), and the
handler's wait for the server's lock."""

import gc
import http.client
import json
import threading
import time

import pytest
import torch

from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.serve import tracing
from eetq_tpu_torch.serve.api import EngineServer
from eetq_tpu_torch.serve.engine import Engine

CFG = PRESETS["toy"]
# admissions of two prompts over two buckets; windows of 4, the last pair's
# chained (the batch full, the queue empty)
KW = dict(max_batch=2, max_len=64, prompt_buckets=(8, 16), prefill_rows=2, decode_window=4)
PROMPTS = [[3, 17, 42, 9], [1, 2, 3], [5, 6, 7, 8, 9, 10, 11, 12, 13], [7, 7]]
BUDGETS = [5, 5, 17, 13]


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    return quantize_params(random_dense_params(CFG, gen), quantize_lm_head=True)


def _serve(eng):
    uids = [eng.add_request(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    eng.run()
    return [eng.result(u) for u in uids]


def test_records_of_an_engine_run(params, monkeypatch):
    monkeypatch.setattr(tracing, "CPU_GAP_NS", 0)  # the CPU clock read at every step
    eng = Engine(params, CFG, **KW)
    assert tracing.current() is eng.trace
    outs = _serve(eng)
    tr = eng.trace
    recs = tr.request_records()
    assert not tr.live and sorted(recs) == list(range(len(PROMPTS)))
    assert [recs[uid].added for uid in sorted(recs)] == sorted(r.added for r in recs.values())
    for uid, rec in recs.items():
        assert rec.received is None  # added directly, not through the server
    steps = list(tr.steps)
    assert len(steps) >= 3
    for s in steps:
        assert 0 <= s.cpu_ns <= s.t1 - s.t0
        assert s.path in ("admit", "decode", "admit+decode")
        assert (s.admission is not None) == ("admit" in s.path)
        assert (s.decode is not None) == ("decode" in s.path)
    admissions = [s.admission for s in steps if s.admission is not None]
    assert sum(len(a.requests) for a in admissions) == len(PROMPTS)
    for a in admissions:
        assert a.rows == 2 and a.bucket in (8, 16)
        assert a.padded == a.rows * a.bucket - sum(len(PROMPTS[uid]) for uid, _ in a.requests)
        assert a.start <= a.launched <= a.fetched <= a.committed
        assert all(recs[uid].added <= a.start for uid, _ in a.requests)
    decodes = [s.decode for s in steps if s.decode is not None]
    assert any(d.chain > 1 for d in decodes) and any(d.window == 4 for d in decodes)
    for d in decodes:
        assert d.start <= d.uploaded <= d.launched <= d.fetched <= d.committed
    # admissions commit each request's first token; decode calls the rest
    assert sum(d.busy_rows for d in decodes) == sum(len(o) - 1 for o in outs)


def test_gc_is_recorded(params):
    Engine(params, CFG, **KW)  # the hook comes with the first trace
    before = time.monotonic_ns()
    gc.collect()
    after = time.monotonic_ns()
    assert any(before <= a <= b <= after and gen == 2 for a, b, gen in tracing.gc_records())


def test_cpu_clock_is_read_by_elapsed_time(params, monkeypatch):
    """A step's CPU time is read where it begins CPU_GAP_NS or more after the
    last step that read it: every long step, few of many short ones."""
    tr = Engine(params, CFG, **KW).trace
    clock = iter([0, 5, 100, 105, 300, 310, 350, 360, 610, 620, 2000, 2990, 3000, 3010])
    monkeypatch.setattr(tracing, "_now", lambda: next(clock) * 1_000_000)
    monkeypatch.setattr(tracing, "CPU_GAP_NS", 300_000_000)
    for _ in range(7):
        tr.begin_step()
        tr.end_step()
    steps = list(tr.steps)
    assert [s.t0 // 1_000_000 for s in steps] == [0, 100, 300, 350, 610, 2000, 3000]
    assert [s.cpu_ns is not None for s in steps] == [True, False, True, False, True, True,
                                                    True]
    assert all(s.cpu_ns >= 0 for s in steps if s.cpu_ns is not None)


def test_profiler_ranges_sit_on_the_stamps(params, monkeypatch):
    entered = []
    real = tracing._enter

    def enter(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "_enter", enter)
    eng = Engine(params, CFG, **KW)
    _serve(eng)
    assert entered == []  # no profiler: no range
    with torch.autograd.profiler.record_function("warm-up"):
        pass  # a process's first range looks up torch's op: milliseconds
    done = len(eng.trace.steps)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        offset = time.time_ns() - time.monotonic_ns()
        _serve(eng)
    assert entered
    starts: dict[str, list[int]] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("eetq."):
            starts.setdefault(ev.name(), []).append(ev.start_ns() - offset)
    steps = list(eng.trace.steps)[done:]
    want = {"eetq.step": [s.t0 for s in steps]}
    for s in steps:
        for call in (s.admission, s.decode):
            if call is not None:
                for stamp, name in call.RANGES.items():
                    want.setdefault(name, []).append(getattr(call, stamp))
    assert set(starts) == set(want) == set(entered)
    assert {"eetq.admission.fetch", "eetq.decode.fetch"} <= set(want)
    for name, stamps in want.items():
        got = sorted(starts[name])
        assert len(got) == len(stamps), name
        assert all(abs(g - t) < 2_000_000 for g, t in zip(got, sorted(stamps))), name


def test_lock_wait_is_recorded(params):
    srv = EngineServer(Engine(params, CFG, **KW), port=0)
    srv.start()
    got = {}

    def post():
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
        conn.request("POST", "/generate", json.dumps({"prompt": [3, 17, 42], "max_new_tokens": 4}),
                     {"Content-Type": "application/json"})
        got["uid"] = json.loads(conn.getresponse().read())["uid"]

    try:
        with srv.cond:  # the scheduler and the handler wait for the lock
            th = threading.Thread(target=post)
            th.start()
            time.sleep(0.25)
            released = time.monotonic_ns()
        th.join(timeout=120)
        assert not th.is_alive()
        rec = srv.engine.trace.request_records()[got["uid"]]
        assert rec.received < released <= rec.added
        assert rec.added - rec.received >= 200_000_000
    finally:
        srv.shutdown()
