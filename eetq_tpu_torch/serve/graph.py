"""The captured decode step: the port's counterpart of a jitted program.

JAX compiles a decode step, or a window of steps, into one program that the
host dispatches with a single call: `decode_loop` is one `lax.scan`
(`eetq_tpu/serve/generate.py:163-205`) and the engine's window is another
(`eetq_tpu/serve/engine.py::_decode_multi`). PyTorch runs eagerly, so every
op of a step is a launch issued from Python: over a thousand a step on a
32-layer model. `StepGraph` records a step function once into a CUDA graph
and replays it, one host call a step or a window.

The step function takes no argument and returns nothing: it reads its
inputs from tensors that outlive it (static buffers, the caches, the
weights) and writes its results into them in place, advancing its carry
(next token, lengths, the sampler's counter). A replay then does what a
call would have done.

- CPU tensors: every call runs the function eagerly (the plain path).
- The card: the first call runs it eagerly on a side stream, as a real step
  and as the warm-up: it loads the kernels' library, makes their one-time
  settings, sizes their scratch (`kernels/_build.py::scratch`) and builds
  the rope table. The second call captures it and replays the capture; every
  later call replays. A capture that fails raises: nothing falls back to
  the eager function.
- Launch counts: the kernel wrappers count in Python, and a replay runs no
  Python. A graph records what its capture counted, takes it back (a
  capture launches nothing), and adds it on every replay.
- Lifetime: a graph holds the addresses of every tensor its step touched.
  It keeps the kernels' scratch buffers of its capture alive itself (a
  later, larger request replaces them in `_build`); the caller keeps the
  rest alive while the graph lives, and drops the graph with them.
- Timing: `warm_ms` and `capture_ms` are the host milliseconds of the eager
  warm-up step (synchronized) and of the capture (from a synchronized start
  to the instantiated graph).
"""

from __future__ import annotations

import time
from collections.abc import Callable

import torch

from eetq_tpu_torch.kernels import _build, add_launch_counts, launch_counts

class StepGraph:
    """A step function, run eagerly on the CPU and replayed from a CUDA
    graph on the card (module docstring)."""

    def __init__(self, fn: Callable[[], None], device: torch.device | str):
        self.fn = fn
        self.device = torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.counts: dict[str, int] = {}  # the launches of one replay
        self.calls = 0
        self._stream = None
        self._scratch: list[torch.Tensor] = []
        self.warm_ms = self.capture_ms = 0.0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
        elif self.calls == 0:
            self._warm()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            add_launch_counts(self.counts)
        self.calls += 1

    def prepare(self) -> None:
        """Warm and capture on the card without replaying: the warm-up runs
        one real step, the capture none. Nothing on the CPU."""
        if self.device.type != "cuda":
            return
        if self.calls == 0:
            self._warm()
            self.calls += 1
        if self.graph is None:
            self._capture()

    def _warm(self) -> None:
        cur = torch.cuda.current_stream(self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(self._stream):
            self.fn()
        cur.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        self.warm_ms = 1e3 * (time.perf_counter() - t0)

    def _capture(self) -> None:
        torch.cuda.synchronize(self.device)
        before = launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end, not torch.cuda.graph, which first empties the
        # allocator's cache: every capture would free the cached blocks of
        # the prefills, and the next admission allocate them anew.
        # thread_local: the HTTP front end's threads may call the CUDA API
        # while the scheduler thread captures.
        with torch.cuda.stream(self._stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.fn()
            finally:
                graph.capture_end()
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        after = launch_counts()
        self.counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        add_launch_counts({k: -n for k, n in self.counts.items()})
        self._scratch = _build.live_scratch()
        self.graph = graph
