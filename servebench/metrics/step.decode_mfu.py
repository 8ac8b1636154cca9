"""The whole decode step against the chip's bf16 peak (%): the model FLOPs
of the busy rows' useful steps (every projection, the two routed experts
and the router, attention over each row's context, the lm_head;
`costs.token_flops`) over the wall time of the `_decode` calls begun inside
the window, over 989 TFLOP/s. Moves tpot_p90_ms."""

from servebench import costs


def read(run):
    if run.peaks is None:
        return None
    spans = run.in_window("decode")
    wall = sum(t1 - t0 for t0, t1, _ in spans) / 1e9
    if wall <= 0:
        return None
    flops = sum(costs.rows_flops(run.cfg, length, min(w * c, left))
                for _, _, (w, c, busy) in spans for length, left in busy)
    return 100.0 * flops / wall / run.peaks["bf16_flops"]
