"""Device: the share (%) of the profiled admission spans' time in which no
operation ran on the card, from the union of the device's operation
intervals. Moves out_tok_s."""


def read(run):
    if run.timeline is None:
        return None
    share = run.timeline.idle_share([(t0, t1) for t0, t1, _ in run.profiled_spans("admission")])
    return None if share is None else 100.0 * share
