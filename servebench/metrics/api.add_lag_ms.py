"""HTTP front end (`serve/api.py`): the median ms from the client sending a
request to the engine's `add_request` for it (the handler's wait for the
server's one lock, which the scheduler holds through every engine step).
Moves out_tok_s."""

import statistics


def read(run):
    lags = [(run.added[r["uid"]] - r["sent"]) / 1e6 for r in run.requests
            if r.get("uid") in run.added]
    return statistics.median(lags) if lags else None
