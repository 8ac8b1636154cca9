"""Whole toy runs with the served path broken underneath: each fault a
served deployment can have must turn `correct` false. (One card: there is
no exchange between chips to leave out.) And the control, judged in the
program's place, must turn it false too."""

import json
import re

import numpy as np
import pytest
import torch

from eetq_tpu_torch.serve.engine import Engine
from servebench import harness


def _token_altered(monkeypatch):
    """A token altered where it is produced: every committed token moved
    by one, streamed as committed."""
    real = Engine._commit

    def commit(self, slot, tok):
        real(self, slot, (tok + 1) % self.cfg.vocab_size)

    monkeypatch.setattr(Engine, "_commit", commit)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: every step of the
    window hands back the token it was given."""
    real = Engine._decode

    def decode(self, window, chain, temps, topks):
        real(self, window, chain, temps, topks)
        return np.repeat(self.next_token[:, None], window * chain, axis=1)

    monkeypatch.setattr(Engine, "_decode", decode)


def _half_batch(monkeypatch):
    """Half of the batch left out: the upper half of the busy slots never get
    their step's tokens (their rows read zeros)."""
    real = Engine._decode

    def decode(self, window, chain, temps, topks):
        busy = [i for i, r in enumerate(self.slot_req) if r is not None and self.lengths[i] > 0]
        out = real(self, window, chain, temps, topks).copy()
        out[busy[len(busy) // 2:]] = 0
        return out

    monkeypatch.setattr(Engine, "_decode", decode)


def _answer_altered(monkeypatch):
    """An answer altered where the server produces it: the stream drops the
    last token of every event that carries more than one."""
    real = Engine.poll

    def poll(self, uid):
        toks, done = real(self, uid)
        return (toks[:-1] if len(toks) > 1 else toks), done

    monkeypatch.setattr(Engine, "poll", poll)


@pytest.mark.parametrize("cell, fault", [
    ("toy.chat", _token_altered), ("toy.chat", _state_unchanged), ("toy.chat", _answer_altered),
    # four closed clients keep all four slots busy, the upper half included
    ("toy-moe.closed", _token_altered), ("toy-moe.closed", _state_unchanged),
    ("toy-moe.closed", _half_batch), ("toy-moe.closed", _answer_altered),
])
def test_a_broken_path_is_not_correct(capsys, monkeypatch, toy_root, cell, fault):
    fault(monkeypatch)
    code = harness.run(["--workload", cell, "--seed", "987654321987", "--seconds", "2",
                        "--trace", "0"], device=torch.device("cpu"), root=toy_root)
    out, err = capsys.readouterr()
    assert code == 0, err
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False, err


@pytest.mark.parametrize("cell", ["toy.chat", "toy-moe.closed"])
def test_the_control_is_not_correct(capsys, toy_root, cell):
    """`--control`: the fp8 control's numbers stand in the program's place
    against the cell's own limits and fail them, while the program's own,
    printed beside, pass."""
    code = harness.run(["--workload", cell, "--seed", "2718281828459", "--seconds", "2",
                        "--trace", "0", "--control"], device=torch.device("cpu"), root=toy_root)
    out, err = capsys.readouterr()
    assert code == 0, err
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False, err
    gap = res["checks"]["mean_logit_gap"]
    assert gap["value"] > gap["limit"], err
    program = float(re.search(r"the program's mean_logit_gap (\S+)", err).group(1))
    assert program <= gap["limit"], err
    assert res["failed"] == 0 and res["checks"]["stream_mismatch"]["value"] == 0
