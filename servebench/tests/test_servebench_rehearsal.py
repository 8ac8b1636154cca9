"""A CPU rehearsal of whole runs at a toy size: the server, the client
process, the spans and the profiler, the metrics, the check against the
reference and the result line; and the check seen failing when the served
path is broken underneath."""

import json

import pytest
import torch

from servebench import harness


def _run(capsys, root, cell, *extra, seconds=2.0, trace=0, seed=2**33 + 5):
    code = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace), *extra], device=torch.device("cpu"), root=root)
    out, err = capsys.readouterr()
    return code, (json.loads(out.strip().splitlines()[-1]) if code == 0 else None), err


@pytest.mark.parametrize("cell", ["toy.chat", "toy-moe.closed"])
@pytest.mark.parametrize("trace", [0, 1])
def test_whole_run_on_the_cpu(capsys, toy_root, cell, trace):
    code, res, err = _run(capsys, toy_root, cell, trace=trace)
    assert code == 0, err
    assert res["correct"] is True, err
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check mean_")
    names = set(res["metrics"])
    if trace:
        assert "busy_s" in res["device"] and "window_s" in res["device"]
        assert {"step.decode_ms"} <= names
    else:
        assert {"setup_s", "out_tok_s", "tpot_p90_ms"} <= names
