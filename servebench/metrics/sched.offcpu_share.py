"""Scheduler (`serve/engine.py`), read from the program's trace
(`serve/tracing.py`): the share (%) of the wall time of the engine steps
begun in the window in which the scheduler's thread was off the CPU (wall
less the thread's CPU time: waits for the interpreter lock, preemption),
over the steps whose CPU time the trace read (a step that begins
`tracing.CPU_GAP_NS` or more after the last one read). None where the
program keeps no trace. Moves out_tok_s."""


def read(run):
    try:
        from eetq_tpu_torch.serve import tracing
    except ImportError:  # a program without the trace
        return None
    trace = tracing.current()
    if trace is None:
        return None
    ws, we = run.window
    steps = [s for s in list(trace.steps) if ws <= s.t0 < we and s.cpu_ns is not None]
    wall = sum(s.t1 - s.t0 for s in steps)
    return 100.0 * (wall - sum(s.cpu_ns for s in steps)) / wall if wall > 0 else None
