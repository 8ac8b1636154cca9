"""`EngineServer` over the ranks of a sharded engine (`serve/api.py`) on the
CPU: gloo ranks spawned for the module (`dist/launch.py::RankPool`, tasks in
`tests/torch_dp_tasks.py`), 2 ranks at tp 2 and 4 at dp 2 x tp 2, each
holding its shard of a seeded toy model's `quantize_params_tp(tp=2)`
artifact, made in each rank (`tasks.build_random_tp`). Rank 0 serves HTTP;
the other ranks `follow`. Held: plain and streamed completions and
`/health` answered by rank 0, each answer and every rank's engine output
equal to the same requests through the same engine driven directly on
every rank, token for token; the followers
surviving an idle gap of several heartbeat intervals (and counting the
heartbeats); `shutdown()` ending every rank's loop."""

import pytest

import torch_dp_tasks as tasks
from eetq_tpu_torch.models.config import PRESETS

ENGINE = dict(max_batch=4, max_len=64, prompt_buckets=(16,))
PROMPTS = [[5, 6, 7], [11] * 10, [1, 2], [9, 9], [3, 17, 42, 9], [40] * 12]
BUDGETS = [6, 4, 7, 5, 6, 3]
HEARTBEAT_S, IDLE_S = 0.15, 0.6
CFG = PRESETS["toy"]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Rank pools of 2, 4 ranks, started together, closed with the module."""
    made = tasks.start_pools((2, 4), tmp_path_factory)
    yield made.__getitem__
    tasks.close_pools(made)


@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2)])
def test_server_over_ranks_equals_the_engine(pools, tp, dp):
    """Rank 0's EngineServer and the followers over tp x dp ranks: every
    answer, plain or streamed, and every rank's outputs equal the engine
    driven directly on the same ranks; /health answers before and after;
    the followers received heartbeats through the idle gap and stepped as
    rank 0 did; shutdown() returned every rank."""
    pool = pools(tp * dp)
    pool.run(tasks.build_random_tp, tp, dp, CFG, 0)
    bodies = [{"prompt": p, "max_new_tokens": n, "stream": i % 2 == 1}
              for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS))]
    got = pool.run(tasks.serve_http, tp, dp, bodies, HEARTBEAT_S, IDLE_S, ENGINE)
    direct = pool.run(tasks.dp_serve, [(p, n, {}) for p, n in zip(PROMPTS, BUDGETS)], ENGINE)
    want = direct[0]["outputs"]
    assert all(d["outputs"] == want for d in direct)
    rank0 = got[0]
    assert [h["status"] for h in rank0["health"]] == [200, 200]
    assert rank0["health"][-1] == {"status": 200, "ok": True, "queued": 0, "active": 0}
    by_prompt = {}
    for i, answer in enumerate(rank0["answers"]):
        assert answer["status"] == 200, answer
        assert answer["tokens"] == want[i], (i, answer, want[i])
        if bodies[i]["stream"]:
            assert answer["done"]
        else:
            by_prompt[answer["uid"]] = answer["tokens"]
    for r in got:
        assert r["outputs"] == rank0["outputs"]
        assert sorted(r["outputs"].values()) == sorted(want)
    for uid, toks in by_prompt.items():
        assert rank0["outputs"][uid] == toks
    for r in got[1:]:
        assert r["follow"]["idle"] >= 2 and r["follow"]["steps"] > 0, r["follow"]
        assert r["follow"] == got[1]["follow"]
