"""Model step, prefill, read from the program's trace (`serve/tracing.py`):
the share (%) of the token positions that the admissions begun in the
window ran for padding: Σ(rows x bucket - prompt tokens) / Σ rows x bucket.
None where the program keeps no trace. Moves out_tok_s."""


def read(run):
    try:
        from eetq_tpu_torch.serve import tracing
    except ImportError:  # a program without the trace
        return None
    trace = tracing.current()
    if trace is None:
        return None
    ws, we = run.window
    calls = [s.admission for s in list(trace.steps)
             if s.admission is not None and ws <= s.admission.start < we]
    run_tokens = sum(a.rows * a.bucket for a in calls)
    return 100.0 * sum(a.padded for a in calls) / run_tokens if run_tokens else None
