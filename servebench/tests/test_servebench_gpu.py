"""On the card (marker `gpu`; each test skips without one): the toy cells
run whole on the card with `correct` true, and the kernel-name map sorts
the port's kernels of a served step into their classes.

    python -m pytest servebench/tests -m gpu
"""

import json

import pytest
import torch

from servebench import harness, trace


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["toy.chat", "toy-moe.closed"])
def test_toy_cells_on_the_card(capsys, toy_root, card, cell):
    code = harness.run(["--workload", cell, "--seed", "77", "--seconds", "3", "--trace", "1"],
                       device=card, root=toy_root)
    out, err = capsys.readouterr()
    assert code == 0, err
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, err
    assert res["device"]["busy_s"] > 0
    classes = trace.kernel_classes()
    # the toy's admissions at 4 slots run W8A8, its decode steps the GEMV
    # (m <= 8) and the flash-decode; an MoE toy its expert kernels
    seen = {trace.classify(name, classes) for name, _ in res["breakdown"]["device_ops"]}
    assert "attention_decode" in seen or "w8a16" in seen, res["breakdown"]
