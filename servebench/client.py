"""The load generator: a child process of its own, standard library only.

The server's process starts it (`harness.py`) so that its threads never hold
the server's interpreter lock. Protocol, one JSON object a line:

1. stdin: the plan {"host", "port", "kind", "mix", "cell", "seed",
   "seconds", "warm_in_s", "drain_s", "vocab"}.
2. stdout: {"ready": true} once the plan is made (prompts drawn).
3. stdin: {"t0": ns}, the `time.monotonic_ns()` at which the warm-in
   begins; the window is [t0 + warm_in_s, t0 + warm_in_s + seconds).
4. stdout: {"records": [...]}, when every request of the window has
   finished or the drain's deadline (window end + drain_s) has passed.

`traffic/<kind>.py` decides when each request goes out (`drive`); this
module sends it: POST /v1/completions with "stream": true, greedy, a budget
of `max_new_tokens` and no eos, and stamps every server-sent event with
`time.monotonic_ns()`, the clock the server stamps its spans with. A
record: phase ("warm", "window" or "after"), budget, prompt length, due
(open loop) and sent times, first and last event times, tokens received,
tokens received inside the window, ok and error ("unfinished" while in
flight); a window request also keeps its prompt, its tokens and its events
[[ns, tokens], ...].
"""

from __future__ import annotations

import http.client
import importlib.util
import json
import os
import random
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TIMEOUT_S = 600.0


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sizes = load_module(HERE / "sizes.py", "servebench_sizes")


class Context:
    """What a traffic kind's `drive` works with: the plan, the window, the
    request sender and the count of window requests still in flight."""

    def __init__(self, plan: dict, t0: int):
        self.plan = plan
        self.host, self.port = plan["host"], int(plan["port"])
        self.seed = int(plan["seed"])
        self.vocab = int(plan["vocab"])
        self.t0 = t0
        self.ws = t0 + int(plan["warm_in_s"] * 1e9)
        self.we = self.ws + int(plan["seconds"] * 1e9)
        self.deadline = self.we + int(plan["drain_s"] * 1e9)
        self.records: list[dict] = []
        self._lock = threading.Lock()
        self._pending = 0  # window requests sent and not finished

    def prompt(self, rng: random.Random, n: int) -> list[int]:
        return [rng.randrange(self.vocab) for _ in range(n)]

    def phase(self, t: int) -> str:
        return "warm" if t < self.ws else "window" if t < self.we else "after"

    def finished(self) -> bool:
        """The window has closed and its every request has finished, or the
        drain's deadline has passed."""
        now = time.monotonic_ns()
        with self._lock:
            return (now >= self.we and self._pending == 0) or now >= self.deadline

    def send(self, prompt: list[int], budget: int, phase: str, due: int | None = None) -> None:
        """Send one streamed request and record it (blocks until it ends)."""
        if phase == "window":
            with self._lock:
                self._pending += 1
        rec = {"phase": phase, "budget": budget, "prompt_len": len(prompt), "due": due,
               "sent": time.monotonic_ns(), "first": None, "last": None, "n": 0,
               "in_window": 0, "ok": False, "error": "unfinished"}
        if phase == "window":
            rec["prompt"] = prompt
        with self._lock:  # recorded from the start: one still in flight shows as unfinished
            self.records.append(rec)
        events, tokens = [], []
        try:
            conn = http.client.HTTPConnection(self.host, self.port, timeout=TIMEOUT_S)
            try:
                body = json.dumps({"prompt": prompt, "max_new_tokens": budget, "stream": True})
                conn.request("POST", "/v1/completions", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:200]!r}")
                done = False
                while not done:
                    line = resp.readline()
                    if not line:
                        break
                    if not line.startswith(b"data: "):
                        continue
                    t = time.monotonic_ns()
                    ev = json.loads(line[6:])
                    if ev["tokens"]:
                        events.append([t, len(ev["tokens"])])
                        tokens.extend(ev["tokens"])
                    done = bool(ev["done"])
            finally:
                conn.close()
            rec["ok"] = done and len(tokens) == budget
            rec["error"] = None if rec["ok"] else f"{len(tokens)} tokens of {budget}, done {done}"
        except (OSError, http.client.HTTPException, RuntimeError, ValueError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        with self._lock:
            rec["n"] = len(tokens)
            if events:
                rec["first"], rec["last"] = events[0][0], events[-1][0]
            rec["in_window"] = sum(n for t, n in events if self.ws <= t < self.we)
            if phase == "window":
                rec.update(tokens=tokens, events=events)
                self._pending -= 1

    def spawn(self, *args) -> None:
        """Send a request from a thread of its own."""
        threading.Thread(target=self.send, args=args, daemon=True).start()

    def sleep_until(self, t: int) -> None:
        while True:
            left = t - time.monotonic_ns()
            if left <= 0:
                return
            time.sleep(min(left / 1e9, 0.05))


def main() -> None:
    plan = json.loads(sys.stdin.readline())
    kind = load_module(HERE / "traffic" / f"{plan['kind']}.py", f"servebench_{plan['kind']}")
    state = kind.prepare(plan, sizes)
    print(json.dumps({"ready": True}), flush=True)
    t0 = int(json.loads(sys.stdin.readline())["t0"])
    ctx = Context(plan, t0)
    kind.drive(ctx, state, sizes)
    while not ctx.finished():
        time.sleep(0.02)
    with ctx._lock:
        out = json.dumps({"records": ctx.records})
    sys.stdout.write(out + "\n")
    sys.stdout.flush()
    # requests sent after the window may still be in flight: they are not
    # measured, and the process ends without waiting for them
    os._exit(0)


if __name__ == "__main__":
    main()
