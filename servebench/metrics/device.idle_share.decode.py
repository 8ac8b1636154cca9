"""Device: the share (%) of the profiled decode spans' time in which no
operation ran on the card, from the union of the device's operation
intervals. Moves tpot_p90_ms."""


def read(run):
    if run.timeline is None:
        return None
    share = run.timeline.idle_share([(t0, t1) for t0, t1, _ in run.profiled_spans("decode")])
    return None if share is None else 100.0 * share
