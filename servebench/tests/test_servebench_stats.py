"""Percentiles, time per output token and rates are taken over every
request, and a failed request counts as missing every latency."""

import pytest

from servebench import stats


def _rec(sent, events, ok=True, n=None):
    n = sum(k for _, k in events) if n is None else n
    return {"sent": sent, "ok": ok, "n": n,
            "first": events[0][0] if events else None, "last": events[-1][0] if events else None}


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([4, 1, 3, 2], 50) == 2.5
    assert stats.percentile([1, 2, 3, 4], 90) == pytest.approx(3.7)
    assert stats.percentile([7], 90) == 7
    assert stats.percentile(list(range(101)), 90) == 90


def test_latencies_over_all_requests():
    ms = 1_000_000
    recs = [
        _rec(1 * ms, [(100 * ms, 1), (190 * ms, 9), (280 * ms, 1)]),
        _rec(50 * ms, [(80 * ms, 1), (80 * ms, 1)]),  # all in one instant
        _rec(70 * ms, [(90 * ms, 1)]),  # one token: no time per output token
        _rec(12 * ms, [], ok=False, n=0),  # failed: missing
    ]
    lat = stats.latencies(recs, end_ns=1000 * ms)
    assert lat["tpot"] == [pytest.approx(180.0 / 10), 0.0, 988.0]
    assert stats.percentile(lat["tpot"], 90) > 500  # the failed one is in the tail
