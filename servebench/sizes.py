"""Request sizes, drawn so that every seed gets the same set.

A run draws its prompt lengths and budgets from stratified quantiles of the
mix's distribution: n draws are the quantiles at (j + 0.5) / n,
j = 0 .. n - 1, put in an order the seed chooses. So two seeds send the same amount of work in another order, and the spread between
runs is the system's, not the draw's. Standard library only: the client
process imports it.

A distribution is a dict: {"dist": "uniform", "min": a, "max": b} (integers,
both ends included) or {"dist": "lognormal", "median": m, "sigma": s,
"min": a, "max": b} (rounded, then clipped to [a, b]).
"""

from __future__ import annotations

import math
import random
from statistics import NormalDist

_NORMAL = NormalDist()


def quantile(dist: dict, u: float) -> int:
    """The distribution's value at probability u in (0, 1)."""
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "uniform":
        return min(hi, lo + int(u * (hi - lo + 1)))
    if dist["dist"] == "lognormal":
        x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(u))
        return max(lo, min(hi, round(x)))
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def pool(dist: dict, n: int, rng: random.Random) -> list[int]:
    """n stratified draws of `dist`, shuffled by rng."""
    out = [quantile(dist, (j + 0.5) / n) for j in range(n)]
    rng.shuffle(out)
    return out

