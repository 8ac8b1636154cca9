"""Model step, decode (`serve/graph.py` replays): the wall ms of every
`_decode` call begun inside the window (each ends in a host fetch) over
the decode steps they ran (window x chain each). Moves tpot_p90_ms."""


def read(run):
    spans = run.in_window("decode")
    steps = sum(w * c for _, _, (w, c, _) in spans)
    return sum(t1 - t0 for t0, t1, _ in spans) / 1e6 / steps if steps else None
