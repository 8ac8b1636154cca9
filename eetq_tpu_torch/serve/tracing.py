"""The serving trace: what the engine and its HTTP server did, and when.

One `Trace` per `serve.engine.Engine` (`engine.trace`, always kept),
written where the work happens: `Engine` stamps
requests, steps and the phases of admissions and decode windows;
`serve.api.EngineServer` stamps when a handler has a request in hand. Every
stamp is `time.monotonic_ns()`, the clock onto which a benchmark maps the
`torch.profiler` device timeline, so a gap on the card can be put down to
the phase the host was in.

Records, all in memory, in rings of fixed size (the oldest dropped):

- `RequestRecord`, per uid: `received` (the handler parsed the body, before
  it waits for the server's lock; None for a direct `add_request`) and
  `added` (`add_request` called). Kept in `live` while in flight, then pushed
  to `requests`.
- `Step`, one per `Engine.step()` in `steps`: `t0`, `t1`, the scheduler
  thread's CPU time between them (`time.thread_time_ns()`; the rest is time
  off the CPU: waits for the interpreter lock, preemption, a blocking device
  sync) on a step that begins `CPU_GAP_NS` or more after the last step whose
  CPU time was read (None on the others), the path it took ("admit",
  "chunk", "decode", "spec", joined by "+"), and its `Admission` and
  `Decode` records.
- `Admission` (`_prefill_group`): stamps start, launched (forward, sample
  and inserts issued), fetched (the first tokens on the host), committed;
  the (uid, prompt tokens) admitted, the bucket and the rows, so that the
  padded tokens are rows x bucket - the prompt tokens.
- `Decode` (`_decode`, or a speculative window's `_spec_decode`): stamps
  start, uploaded (the state on the card), launched (the graph replays
  issued; a speculative window's rounds run, each ending in a fetch of the
  loop's condition), fetched (the tokens on the host), committed (the
  step's commit loop done); window, chain, and each busy slot's (length,
  remaining budget) as the call begins.
- GC records (start, end, generation) of every cyclic collection on any
  thread, from one `gc.callbacks` hook installed with the first `Trace`,
  in one process-wide ring (`gc_records()`).

Recording launches no device work, syncs nothing and, while no profiler
records, calls no torch function. While one does, a step asks whether its
thread is recorded, and if so each step and phase is also a
`torch.profiler.record_function` range
(`eetq.step`, `eetq.admission.launch`, `eetq.decode.fetch`, ...) on the
profiler's clock, above the kernels it launched. The profiler's callbacks
are per thread: a profiler started on another thread than the one calling
`Engine.step()` records none of these ranges.

`current()` is the trace of the engine built most recently in the process,
held by a weak reference.
"""

from __future__ import annotations

import gc
import time
import weakref
from collections import deque

import torch.autograd
from torch.autograd import profiler as _autograd_profiler

REQUESTS = 16384  # finished request records kept
STEPS = 16384  # step records kept
GCS = 65536  # collections kept
# The thread's CPU clock is a system call, not served from user space like
# the monotonic clock. On an H100 host (PERF.md §6), reading it at both ends
# of every step slowed the served tokens: by up to 40% on the decode cell,
# and by 8.5% on the prefill cell where a 300 ms gap read it on every step.
# So it is read on a step that begins this long after the last step whose
# CPU time was read: about one step in 14 of that decode cell's 215 ms chains,
# one in 8 of its prefill cell's 400 ms admissions. That host's clock ticks in
# 10 ms steps.
CPU_GAP_NS = 3_000_000_000

_now = time.monotonic_ns
_cpu = time.thread_time_ns

_gcs: deque = deque(maxlen=GCS)
_gc_start = 0
_latest = None  # weakref.ref to the latest engine's Trace, or None


class RequestRecord:
    """One request's stamps (monotonic ns; `received` None until given)."""

    __slots__ = ("uid", "received", "added")

    def __init__(self, uid: int, added: int):
        self.uid, self.added = uid, added
        self.received = None


class Admission:
    """One grouped prefill (`_prefill_group`): its phase stamps, the
    (uid, prompt tokens) it admitted, its bucket and rows."""

    __slots__ = ("start", "launched", "fetched", "committed", "requests", "bucket", "rows")
    # the range of the phase each stamp begins
    RANGES = {"start": "eetq.admission.launch", "launched": "eetq.admission.fetch",
              "fetched": "eetq.admission.commit"}

    def __init__(self, start: int, requests: tuple, bucket: int, rows: int):
        self.start, self.requests, self.bucket, self.rows = start, requests, bucket, rows
        self.launched = self.fetched = self.committed = None

    @property
    def padded(self) -> int:
        """Token positions run for padding: rows x bucket - prompt tokens."""
        return self.rows * self.bucket - sum(n for _, n in self.requests)


class Decode:
    """One decode call (a chain of windows, or a speculative window): its
    phase stamps, window, chain and each busy slot's (length, remaining
    budget) as it begins."""

    __slots__ = ("start", "uploaded", "launched", "fetched", "committed", "window", "chain",
                 "busy")
    RANGES = {"start": "eetq.decode.upload", "uploaded": "eetq.decode.launch",
              "launched": "eetq.decode.fetch", "fetched": "eetq.decode.commit"}

    def __init__(self, start: int, window: int, chain: int, busy: tuple):
        self.start, self.window, self.chain, self.busy = start, window, chain, busy
        self.uploaded = self.launched = self.fetched = self.committed = None

    @property
    def busy_rows(self) -> int:
        """Σ over the call's steps j < window x chain of the rows busy at
        j (a row busy while its remaining budget > j)."""
        steps = self.window * self.chain
        return sum(min(left, steps) for _, left in self.busy)


class Step:
    """One `Engine.step()`; `cpu_ns` None where its CPU time was not read."""

    __slots__ = ("t0", "t1", "cpu_ns", "path", "admission", "decode")

    def __init__(self, t0: int, cpu0: int | None):
        self.t0, self.cpu_ns = t0, cpu0
        self.t1 = None
        self.path = ""
        self.admission = self.decode = None


def _enter(name: str):
    rf = _autograd_profiler.record_function(name)
    rf.__enter__()
    return rf


def _on_gc(phase: str, info: dict) -> None:
    global _gc_start
    if phase == "start":
        _gc_start = _now()
    else:
        _gcs.append((_gc_start, _now(), info["generation"]))


def gc_records() -> list[tuple[int, int, int]]:
    """(start, end, generation) of the collections kept, oldest first."""
    return list(_gcs)


def current() -> Trace | None:
    """The trace of the engine built most recently in the process."""
    return None if _latest is None else _latest()


def register(trace: Trace) -> None:
    """Make `trace` (an engine's) `current()`."""
    global _latest
    _latest = weakref.ref(trace)


class Trace:
    """An engine's records (module docstring). The engine calls the
    recording methods from its scheduler's thread, and `add` and `receive`
    under whatever lock serializes its callers."""

    def __init__(self):
        self.live: dict[int, RequestRecord] = {}
        self.requests: deque[RequestRecord] = deque(maxlen=REQUESTS)
        self.steps: deque[Step] = deque(maxlen=STEPS)
        self._step: Step | None = None
        self._call = None  # the Admission or Decode being stamped
        self._ranges: list | None = None  # open profiler ranges, while mirrored
        self._cpu_t0 = None  # t0 of the last step whose CPU time was read
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)

    # ---- requests ----

    def add(self, uid: int, t: int) -> None:
        """Request uid was added (`add_request` called) at t."""
        self.live[uid] = RequestRecord(uid, t)

    def receive(self, uid: int, t: int) -> None:
        """The front end had request uid in hand at t."""
        rec = self.live.get(uid)
        if rec is not None:
            rec.received = t

    def finish(self, uid: int) -> None:
        """Request uid is done: its record leaves `live` for `requests`."""
        rec = self.live.pop(uid, None)
        if rec is not None:
            self.requests.append(rec)

    def request_records(self) -> dict[int, RequestRecord]:
        """Every request kept, finished or in flight, by uid."""
        out = {r.uid: r for r in list(self.requests)}
        out.update(list(self.live.items()))
        return out

    # ---- steps and their phases ----

    def begin_step(self) -> None:
        # the module's flag is any thread's profiler; then ask whether this
        # thread's calls are recorded
        mirror = _autograd_profiler._is_profiler_enabled and torch.autograd._profiler_enabled()
        t = _now()
        read = self._cpu_t0 is None or t - self._cpu_t0 >= CPU_GAP_NS
        if read:
            self._cpu_t0 = t
        self._step = Step(t, _cpu() if read else None)
        self._ranges = [_enter("eetq.step")] if mirror else None

    def end_step(self) -> None:
        step, ranges = self._step, self._ranges
        if step is None:
            return
        if ranges:
            for rf in reversed(ranges):
                rf.__exit__(None, None, None)
        if step.cpu_ns is not None:
            step.cpu_ns = _cpu() - step.cpu_ns
        step.t1 = _now()
        self.steps.append(step)
        self._step = self._call = self._ranges = None

    def path(self, part: str) -> None:
        """Add a part ("admit", "chunk", ...) to the open step's path."""
        step = self._step
        if step is not None:
            step.path = f"{step.path}+{part}" if step.path else part

    def begin_admission(self, requests, bucket: int, rows: int) -> None:
        """An admission of `requests` (engine `Request`s) begins."""
        call = Admission(_now(), tuple((r.uid, len(r.prompt)) for r in requests), bucket, rows)
        if self._step is not None:
            self._step.admission = call
            self.path("admit")
        self._begin(call)

    def begin_decode(self, window: int, chain: int, busy: tuple, spec: bool = False) -> None:
        call = Decode(_now(), window, chain, busy)
        if self._step is not None:
            self._step.decode = call
            self.path("spec" if spec else "decode")
        self._begin(call)

    def _begin(self, call) -> None:
        self._call = call
        ranges = self._ranges
        if ranges is not None:
            if len(ranges) > 1:  # a phase of an earlier call left open
                ranges.pop().__exit__(None, None, None)
            ranges.append(_enter(call.RANGES["start"]))

    def mark(self, stamp: str) -> None:
        """Stamp the open admission or decode call's `stamp` (the end of a
        phase, and the start of the next)."""
        t = _now()
        call = self._call
        if call is None:
            return
        setattr(call, stamp, t)
        ranges = self._ranges
        if ranges is not None and len(ranges) > 1:
            ranges.pop().__exit__(None, None, None)
            name = call.RANGES.get(stamp)
            if name is not None:
                ranges.append(_enter(name))
