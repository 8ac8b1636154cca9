"""Joining the ranks of a `torch.distributed` world.

Port of `eetq_tpu/dist/multihost.py:30-55`. The same program runs on every
rank (one process per rank, `torchrun` or a caller's own spawn); each calls
`initialize` first, then builds its mesh (`dist.sharding.make_mesh`) and its
shard of the model:

    from eetq_tpu_torch.dist import multihost
    multihost.initialize()                  # from torchrun's environment
    mesh = make_mesh()                      # tp = the world size
    model = AutoEETQForCausalLM.from_quantized(path).shard(mesh=mesh)

Unlike the JAX version, a world of more than one rank that cannot meet
raises: a rank never goes on alone as a single process. The backend is
NCCL when every rank has a card of its own, else gloo (ranks that share one
card, or the CPU); the choice is logged on every rank. A pipeline's mesh is
`dist.pipeline.make_pp_mesh(pp, tp, dp)`. Across hosts, `make_hybrid_mesh`
keeps each model group on one host and spans hosts with the data axis:

    mesh = multihost.make_hybrid_mesh()     # tp = the ranks of a host
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from eetq_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_TIMEOUT_S = 300.0


def choose_backend(world_size: int) -> str:
    """"nccl" when this machine has a card for every rank, else "gloo"."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def initialize(rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None, backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of `world_size` ranks as `rank`, meeting at
    `init_method` ("tcp://host:port" or "file:///path"). What is not given
    comes from the environment `torchrun` sets (RANK, WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT). A no-op when the group already exists or the
    world is one rank. A rendezvous that fails, or does not complete within
    `timeout_s`, raises. Returns whether a group of more than one rank is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if world_size <= 1:
        return False
    if rank is None:
        if "RANK" not in env:
            raise RuntimeError(f"a world of {world_size} ranks needs this process's rank "
                               f"(pass rank= or set RANK)")
        rank = int(env["RANK"])
    if init_method is None and not ("MASTER_ADDR" in env and "MASTER_PORT" in env):
        raise RuntimeError(f"rank {rank} of {world_size}: no rendezvous (pass init_method= or "
                           f"set MASTER_ADDR and MASTER_PORT)")
    backend = backend or choose_backend(world_size)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed: rank %d of %d, backend %s", rank, world_size, backend)
    return True


def control_group():
    """A gloo group over the world, made once for each process group (None:
    the default group, where that is gloo already): host objects travel
    there whatever the data backend (`serve/api.py`'s admissions,
    `make_hybrid_mesh`'s host names). Collective: every rank makes it, in
    the same place of its program."""
    world = dist.group.WORLD
    if _CONTROL.get("world") is not world:
        _CONTROL.update(world=world, group=None if dist.get_backend() == "gloo" else dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)))
    return _CONTROL["group"]


_CONTROL: dict = {}


def _host_name() -> str:
    return socket.gethostname()


def make_hybrid_mesh(tp: int | None = None, dp: int | None = None,
                     device: torch.device | str | None = None):
    """The (data, model) mesh with each model group on one host and the data
    axis across hosts (`eetq_tpu/dist/multihost.py:57-100`). Defaults: tp =
    the ranks on this rank's host (torchrun's LOCAL_WORLD_SIZE, else the
    count of ranks whose host name is this rank's), dp = world / tp. Raises
    ValueError where dp tp is not the world size, or where a model group
    (tp consecutive ranks) would span hosts: the ranks are never reordered.
    On one machine it is `make_mesh(tp, dp)`."""
    from eetq_tpu_torch.dist.sharding import make_mesh

    up = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if up else 1
    hosts = [_host_name()] * n
    if up and n > 1:
        dist.all_gather_object(hosts, _host_name(), group=control_group())
    if tp is None:
        local = os.environ.get("LOCAL_WORLD_SIZE")
        me = dist.get_rank() if up else 0
        tp = int(local) if local else hosts.count(hosts[me])
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    for d in range(dp):
        group = hosts[d * tp:(d + 1) * tp]
        if len(set(group)) > 1:
            raise ValueError(f"model group {d} (ranks {d * tp}..{(d + 1) * tp - 1}) spans hosts "
                             f"{sorted(set(group))}: a host's ranks must be consecutive and "
                             f"tp={tp} must divide them")
    return make_mesh(tp=tp, dp=dp, device=device)
