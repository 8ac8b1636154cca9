"""Scheduler (`serve/engine.py`), read from the program's trace
(`serve/tracing.py`): the mean number of busy slots a decode step, over the
decode calls begun in the window: Σ over the calls of Σ over their steps
j < window x chain of the rows busy at j (a row busy while its remaining
budget > j), over Σ window x chain. None where the program keeps no trace.
Moves out_tok_s."""


def read(run):
    try:
        from eetq_tpu_torch.serve import tracing
    except ImportError:  # a program without the trace
        return None
    trace = tracing.current()
    if trace is None:
        return None
    ws, we = run.window
    calls = [s.decode for s in list(trace.steps)
             if s.decode is not None and ws <= s.decode.start < we]
    steps = sum(d.window * d.chain for d in calls)
    return sum(d.busy_rows for d in calls) / steps if steps else None
