"""Ranks spawned on one machine, each a process holding its shard.

`RankPool(world, init_method)` starts `world` processes with the `spawn`
method (the parent may already have initialised CUDA); each joins the
process group as its rank (`multihost.initialize`), builds its mesh
(`sharding.make_mesh`) and then runs the tasks it is sent:
`pool.run(fn, *args)` calls `fn(mesh, *args)` on every rank and returns the
ranks' results in rank order. fn must be importable by name in a fresh
process (a module-level function of a module that the ranks can import),
and its arguments and result are pickled: return numpy arrays or CPU
tensors. The ranks keep what a task leaves in `state`, a dict of their own
that tasks take with `fn(mesh, *args, state=...)` where they ask for it.

Failures surface: a task that raises on any rank raises here with that
rank's traceback, and one that has not answered within `timeout_s` (the
collectives' own timeout, given to the process group, and the parent's wait
for the results) raises TimeoutError; either way the pool is shut down,
its processes terminated. Nothing is retried and no rank goes on alone.

A CPU test of a sharded path runs its ranks on device="cpu" over gloo:

    with RankPool(2, f"file://{tmp}/rdv", device="cpu") as pool:
        logits = pool.run(my_module.forward_task, tokens)
"""

from __future__ import annotations

import inspect
import multiprocessing as mp
import queue
import time
import traceback

_POLL_S = 1.0


def _rank_main(rank: int, world: int, init_method: str, backend: str | None, device,
               timeout_s: float, threads: int | None, tasks, results) -> None:
    """The entry point of a spawned rank: join, build the mesh, run tasks
    until the parent sends None or goes away."""
    import torch
    import torch.distributed as dist

    from eetq_tpu_torch.dist.multihost import initialize
    from eetq_tpu_torch.dist.sharding import make_mesh

    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(rank, world, init_method, backend, timeout_s)
        mesh = make_mesh(device=device)
        results.put((rank, True, None))
    except BaseException:  # the parent raises it
        results.put((rank, False, traceback.format_exc()))
        return
    state: dict = {}
    parent = mp.parent_process()
    try:
        while True:
            try:
                item = tasks.get(timeout=_POLL_S)
            except queue.Empty:
                if parent is not None and not parent.is_alive():
                    return
                continue
            if item is None:
                return
            fn, args = item
            try:
                kw = {"state": state} if "state" in inspect.signature(fn).parameters else {}
                results.put((rank, True, fn(mesh, *args, **kw)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """`world` spawned ranks over one process group (module docstring)."""

    def __init__(self, world: int, init_method: str, backend: str | None = None,
                 device=None, timeout_s: float = 300.0, threads: int | None = None):
        self.world, self.timeout_s = world, timeout_s
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, name=f"rank{r}",
                        args=(r, world, init_method, backend, device, timeout_s, threads,
                              self._tasks[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()
        self._collect("start")

    def _collect(self, what: str) -> list:
        """One answer from every rank, in rank order; raises on a failure,
        a rank that died or the deadline."""
        out: dict[int, object] = {}
        deadline = time.monotonic() + self.timeout_s
        while len(out) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=_POLL_S)
            except queue.Empty:
                dead = [p.name for p in self._procs if not p.is_alive()]
                if dead:
                    self.close(wait_s=0)
                    raise RuntimeError(f"{what}: {', '.join(dead)} exited without answering")
                if time.monotonic() > deadline:
                    self.close(wait_s=0)
                    raise TimeoutError(f"{what}: ranks {sorted(set(range(self.world)) - set(out))}"
                                       f" gave no answer within {self.timeout_s:.0f} s")
                continue
            if not ok:
                self.close(wait_s=0)
                raise RuntimeError(f"{what}: rank {rank} failed:\n{value}")
            out[rank] = value
        return [out[r] for r in range(self.world)]

    def run(self, fn, *args) -> list:
        """fn(mesh, *args) on every rank; the results in rank order."""
        if self._procs is None:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", str(fn)))

    def close(self, wait_s: float = 10.0) -> None:
        """Stop the ranks: each is asked to leave, then terminated if it has
        not within wait_s (at once after a failure: the others may be stuck
        in a collective)."""
        procs, self._procs = getattr(self, "_procs", None), None
        if not procs:
            return
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in procs:
            p.join(timeout=wait_s)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
