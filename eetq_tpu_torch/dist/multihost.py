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
`dist.pipeline.make_pp_mesh(pp, tp)`. `make_hybrid_mesh` (dp over hosts) is
not ported: ROADMAP.md queue 1 item 3.
"""

from __future__ import annotations

import datetime
import os

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
