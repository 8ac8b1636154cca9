"""Kernels (`kernels/w8a8.py`, `kernels/w8a16.py`): the admissions' W8A8
projections and grouped expert GEMMs against their roofline (%), over the
profiled admission spans: the least time of the real prompt tokens' work
(not the bucket's padding), each product at its own peak
(`costs.admission_least_s`, "linear"), over those kernels' device time.
Moves out_tok_s."""

from servebench import costs

CLASSES = ("w8a8", "moe_grouped")


def read(run):
    if run.timeline is None or run.peaks is None:
        return None
    least, device = 0.0, 0
    for t0, t1, info in run.profiled_spans("admission"):
        least += sum(costs.admission_least_s(run.cfg, n, run.peaks)["linear"] for _, n in info)
        device += sum(b - a for name, a, b in run.timeline.started(t0, t1)
                      if run.kernel_class(name) in CLASSES)
    return 100.0 * least / (device / 1e9) if device else None
