"""The traced run's device timeline, read from `torch.profiler`.

The profiler records every operation the card ran (kernels, copies,
memsets) with its start and length, on the host's wall clock; the engine's
spans are on `time.monotonic_ns()`. `device_ops` reads the profiler's raw
results (no per-event objects are built for the hundreds of thousands of
events a few seconds of serving make) and moves them onto the monotonic
clock by the offset the engine took when it started the profiler.

Busy time is the union of the intervals, never their sum: kernels of two
streams may overlap. A kernel belongs to the span in whose host interval it
started: `_prefill_group` and `_decode` each end in a host fetch, so every
kernel they launch has started (and ended) before they return.
"""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def kernel_classes() -> list[tuple[str, re.Pattern]]:
    table = json.loads((HERE / "kernel_classes.json").read_text())["classes"]
    return [(cls, re.compile(pat)) for cls, pat in table]


def classify(name: str, classes) -> str:
    for cls, pat in classes:
        if pat.search(name):
            return cls
    return "other"


def short_name(name: str) -> str:
    """A kernel's function name without its namespace, template arguments
    and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name.replace("void ", "", 1), maxsplit=1)[0].strip()
    return base.rsplit("::", 1)[-1] or name[:60]


def device_ops(prof, offset_ns: int) -> list[tuple[str, int, int]]:
    """(name, start, end) in monotonic ns of every operation on the device."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        t0 = ev.start_ns() - offset_ns
        out.append((ev.name(), t0, t0 + ev.duration_ns()))
    out.sort(key=lambda e: e[1])
    return out


class Timeline:
    """Device operations sorted by start, searchable by time."""

    def __init__(self, ops: list[tuple[str, int, int]]):
        self.ops = sorted(ops, key=lambda e: e[1])
        self.starts = [op[1] for op in self.ops]
        self.longest = max((b - a for _, a, b in self.ops), default=0)

    def started(self, lo: int, hi: int) -> list:
        """The operations that started in [lo, hi)."""
        return self.ops[bisect.bisect_left(self.starts, lo):bisect.bisect_left(self.starts, hi)]

    def overlapping(self, lo: int, hi: int) -> list:
        """The operations that may overlap [lo, hi)."""
        return self.started(lo - self.longest, hi)

    def busy_ns(self, lo: int, hi: int) -> int:
        return sum(b - a for a, b in union(self.overlapping(lo, hi), lo, hi))

    def idle_share(self, spans) -> float | None:
        """The share of the spans' time with no operation running, or None
        where there is no span."""
        total = sum(b - a for a, b in spans)
        if total <= 0:
            return None
        return 1.0 - sum(self.busy_ns(a, b) for a, b in spans) / total

    def breakdown(self, lo: int, hi: int, labelled_spans) -> dict:
        """The ten device operations that took most time (seconds, summed
        by short name) and the ten longest idle gaps of [lo, hi), each
        named by the host span it fell in ("admission", "decode", or
        "host": between the engine's calls, where the scheduler commits
        tokens and the HTTP threads run)."""
        by_name: dict[str, int] = {}
        for name, a, b in self.started(lo, hi):
            key = short_name(name)
            by_name[key] = by_name.get(key, 0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        spans = sorted(labelled_spans, key=lambda s: s[1])
        span_starts = [s[1] for s in spans]
        gaps, prev = [], lo
        for a, b in union(self.overlapping(lo, hi), lo, hi) + [(hi, hi)]:
            if a > prev:
                mid = (prev + a) // 2
                j = bisect.bisect_right(span_starts, mid) - 1
                label = spans[j][0] if j >= 0 and spans[j][2] > mid else "host"
                gaps.append((label, a - prev))
            prev = max(prev, b)
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[k, v / 1e9] for k, v in top],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps[:10]]}


def union(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the intervals (name, start, end) clipped to [lo, hi],
    sorted."""
    out: list[list[int]] = []
    for _, a, b in sorted(intervals, key=lambda e: e[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
