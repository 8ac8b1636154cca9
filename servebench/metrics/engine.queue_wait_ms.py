"""Scheduler (`serve/engine.py`): the mean ms from `add_request` to the start
of the admission (`_prefill_group`) that took the request. Moves
out_tok_s."""


def read(run):
    start = {uid: t0 for kind, t0, _, info in run.spans if kind == "admission"
             for uid, _ in info}
    waits = [(start[r["uid"]] - run.added[r["uid"]]) / 1e6 for r in run.requests
             if r.get("uid") in start and r["uid"] in run.added]
    return sum(waits) / len(waits) if waits else None
