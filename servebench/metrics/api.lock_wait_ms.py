"""HTTP front end (`serve/api.py`), read from the program's trace
(`serve/tracing.py`): the median ms, over the window's requests, from the
handler having the request in hand (`received`, before it takes
`EngineServer.cond`) to `add_request` (`added`): the handler's wait for the
server's lock. None where the program keeps no trace. Moves out_tok_s."""

import statistics


def read(run):
    try:
        from eetq_tpu_torch.serve import tracing
    except ImportError:  # a program without the trace
        return None
    trace = tracing.current()
    if trace is None:
        return None
    records = trace.request_records()
    waits = [(rec.added - rec.received) / 1e6 for r in run.requests
             if (rec := records.get(r.get("uid"))) is not None and rec.received is not None]
    return statistics.median(waits) if waits else None
