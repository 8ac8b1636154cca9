"""The whole admission against the chip's peaks (%): the least time of the
real prompt tokens' work, each product at the peak of the arithmetic it
runs in (int8 for the W8A8 projections, bf16 for the experts, the router,
attention and the lm_head; `costs.admission_least_s`), over the wall time
of the admissions begun inside the window. Moves out_tok_s."""

from servebench import costs


def read(run):
    if run.peaks is None:
        return None
    spans = run.in_window("admission")
    wall = sum(t1 - t0 for t0, t1, _ in spans) / 1e9
    if wall <= 0:
        return None
    least = sum(costs.admission_least_s(run.cfg, n, run.peaks)["all"]
                for _, _, info in spans for _, n in info)
    return 100.0 * least / wall
