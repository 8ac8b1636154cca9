#!/usr/bin/env python3
"""Host time the serving trace (`eetq_tpu_torch/serve/tracing.py`) adds to
one engine step, on this machine's CPU, with no profiler recording.

    python3 scripts/torch_trace_cost.py [--slots 32] [--reps 20000]

Builds the toy preset's engine on the CPU with `--slots` slots, all busy,
and times the trace's calls exactly as `Engine` makes them in two kinds of
step: a decode step (the step record, the busy slots' (length, remaining
budget), four phase stamps, the step's end) and an admission step (one
request added, the admission's record and three stamps, then a decode
call, the request finished). Prints the median over
rounds of the host µs a step of each kind.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from eetq_tpu_torch.models.config import PRESETS  # noqa: E402
from eetq_tpu_torch.models.init import quantize_params, random_dense_params  # noqa: E402
from eetq_tpu_torch.serve.engine import Engine  # noqa: E402


def decode_step(eng, tr):
    tr.begin_step()
    tr.begin_decode(8, 8, eng._busy())
    for stamp in ("uploaded", "launched", "fetched", "committed"):
        tr.mark(stamp)
    tr.end_step()


def admission_step(eng, tr):
    req = eng.slot_req[0]
    tr.add(req.uid, time.monotonic_ns())
    tr.begin_step()
    tr.begin_admission([req], 2048, 1)
    tr.mark("launched")
    tr.mark("fetched")
    tr.mark("committed")
    tr.begin_decode(1, 1, eng._busy())
    for stamp in ("uploaded", "launched", "fetched", "committed"):
        tr.mark(stamp)
    tr.finish(req.uid)
    tr.end_step()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--slots", type=int, default=32)
    p.add_argument("--reps", type=int, default=20000)
    p.add_argument("--rounds", type=int, default=9)
    args = p.parse_args()
    cfg = PRESETS["toy"]
    params = quantize_params(random_dense_params(cfg, torch.Generator().manual_seed(0)))
    eng = Engine(params, cfg, max_batch=args.slots, max_len=4096)
    for i in range(args.slots):  # every slot busy, lengths and budgets spread
        uid = eng.add_request([1] * (64 + 7 * i), 1024)
        eng.slot_req[i] = eng.queue.popleft()
        eng.lengths[i] = 64 + 7 * i + 1 + i
        eng.slot_req[i].out_tokens.extend([1] * (1 + i))
        assert eng.slot_req[i].uid == uid
    tr = eng.trace
    for name, fn in (("decode step", decode_step), ("admission step", admission_step)):
        times = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn(eng, tr)
            times.append((time.perf_counter() - t0) / args.reps * 1e6)
        print(f"{name}, {args.slots} busy slots: {statistics.median(times):.2f} us a step "
              f"(rounds {min(times):.2f}-{max(times):.2f})")


if __name__ == "__main__":
    main()
