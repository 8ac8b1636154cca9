"""Host runtime (CPython's collector), read from the program's trace
(`serve/tracing.py`): the share (%) of the window covered by cyclic
garbage collections, on any thread of the serving process. None where the
program keeps no trace. Moves out_tok_s."""


def read(run):
    try:
        from eetq_tpu_torch.serve import tracing
    except ImportError:  # a program without the trace
        return None
    if tracing.current() is None:
        return None
    ws, we = run.window
    covered = sum(max(0, min(b, we) - max(a, ws)) for a, b, _ in tracing.gc_records())
    return 100.0 * covered / (we - ws)
