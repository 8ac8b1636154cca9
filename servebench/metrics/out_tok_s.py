"""Output tokens per second: the tokens every client received inside the
window (from any request, whenever it was sent), over the window's
seconds."""


def read(run):
    return sum(r["in_window"] for r in run.all_records) / run.seconds
