"""HTTP front end (`serve/api.py`): the median ms from the engine
committing a request's first token (`_commit`) to the client receiving the
event that carries it. Moves out_tok_s."""

import statistics


def read(run):
    lags = [(r["first"] - run.first_commit[r["uid"]]) / 1e6 for r in run.requests
            if r["ok"] and r.get("uid") in run.first_commit]
    return statistics.median(lags) if lags else None
