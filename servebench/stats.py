"""Percentiles and latencies over a run's requests. Standard library only."""

from __future__ import annotations

import math


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def latencies(records: list[dict], end_ns: int) -> dict:
    """The time per output token (ms) of each window request. A request
    that failed counts as missing every limit: its time per output token
    runs from when it was sent to end_ns, when the run stopped waiting for
    it."""
    tpot = []
    for r in records:
        if not r["ok"]:
            tpot.append((end_ns - r["sent"]) / 1e6)
        elif r["n"] > 1:
            tpot.append((r["last"] - r["first"]) / 1e6 / (r["n"] - 1))
    return {"tpot": tpot}
