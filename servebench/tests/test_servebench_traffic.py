"""The traffic is a function of the seed, and every seed gets the same set
of sizes in another order."""

import importlib.util
import json
import random
from pathlib import Path

import pytest

from servebench import sizes

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"


def _kind(name):
    spec = importlib.util.spec_from_file_location(f"kind_{name}", TRAFFIC / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan(mix, seed):
    return {"mix": json.loads((TRAFFIC / f"{mix}.json").read_text()), "cell": {}, "seed": seed,
            "seconds": 50.0, "warm_in_s": 15.0, "vocab": 32000}


@pytest.mark.parametrize("mix, clients, prompts, budgets", [
    ("decode", 32, (64, 256), (256, 1024)),
    ("prefill", 8, (1024, 2048), (8, 32)),
])
def test_closed_loop_is_the_seeds_and_the_same_set(mix, clients, prompts, budgets):
    kind = _kind("closed")
    a = kind.prepare(_plan(mix, 5), sizes)["clients"]
    b = kind.prepare(_plan(mix, 5), sizes)["clients"]
    c = kind.prepare(_plan(mix, 2**31 + 6), sizes)["clients"]
    assert len(a) == clients
    assert [x[1:] for x in a] == [x[1:] for x in b]
    assert [x[1:] for x in a] != [x[1:] for x in c]
    assert [x[0].random() for x in a] == [x[0].random() for x in b]
    assert sorted(a[0][1]) == sorted(c[0][1]) and sorted(a[0][2]) == sorted(c[0][2])
    assert all(prompts[0] <= n <= prompts[1] for _, lens, _ in a for n in lens)
    assert all(budgets[0] <= n <= budgets[1] for _, _, buds in a for n in buds)


@pytest.mark.parametrize("dist", [
    {"dist": "uniform", "min": 8, "max": 32},
    {"dist": "lognormal", "median": 640, "sigma": 0.8, "min": 32, "max": 2048},
])
def test_stratified_pools(dist):
    n = 1000
    pool = sizes.pool(dist, n, random.Random(1))
    assert sorted(pool) == sorted(sizes.pool(dist, n, random.Random(2)))
    assert dist["min"] <= min(pool) and max(pool) <= dist["max"]
    median = sorted(pool)[n // 2]
    want = dist.get("median", (dist["min"] + dist["max"]) / 2)
    assert abs(median - want) <= 0.02 * want + 1

