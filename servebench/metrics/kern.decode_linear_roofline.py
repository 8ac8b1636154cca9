"""Kernels (`kernels/w8a16.py` over `csrc/`): the decode steps' W8A16
products (the GEMM and GEMV over the dense projections, the grouped expert
GEMM) against their roofline (%), over the profiled decode spans: the
least time of the bytes and operations the busy rows need
(`costs.decode_linear_least_s`: each weight byte once a step, the experts
the busy rows select expected under uniform top-2 routing) over those
kernels' device time. The bf16 lm_head and router are PyTorch's and left
out. Moves tpot_p90_ms."""

from servebench import costs

CLASSES = ("w8a16", "moe_grouped")


def read(run):
    if run.timeline is None or run.peaks is None:
        return None
    least, device = 0.0, 0
    for t0, t1, (w, c, busy) in run.profiled_spans("decode"):
        for j in range(w * c):
            rows = sum(left > j for _, left in busy)
            if rows:
                least += costs.decode_linear_least_s(run.cfg, rows, run.peaks)
        device += sum(b - a for name, a, b in run.timeline.started(t0, t1)
                      if run.kernel_class(name) in CLASSES)
    return 100.0 * least / (device / 1e9) if device else None
