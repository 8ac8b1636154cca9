"""Model step, prefill (`models/transformer.py`, `modules/`, `ops/`): the
mean wall ms of one admission (`_prefill_group`, which ends in a host fetch)
begun inside the window. Moves out_tok_s."""


def read(run):
    d = [(t1 - t0) / 1e6 for t0, t1, _ in run.in_window("admission")]
    return sum(d) / len(d) if d else None
