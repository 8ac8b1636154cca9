"""Port of `eetq_tpu.dist`: tensor and expert parallelism across
`torch.distributed` ranks (`sharding.py`), joining the ranks
(`multihost.py`) and spawning them on one machine (`launch.py`). Data
parallelism, pipeline parallelism, ring attention and long-context prefill
are ROADMAP.md queue 1 item 9."""

from eetq_tpu_torch.dist import multihost
from eetq_tpu_torch.dist.sharding import (
    Mesh,
    ShardedModel,
    make_mesh,
    shard_model,
    split_gateup_columns,
    split_qkv_columns,
    split_rows,
)

__all__ = [
    "multihost",
    "Mesh",
    "make_mesh",
    "ShardedModel",
    "shard_model",
    "split_qkv_columns",
    "split_gateup_columns",
    "split_rows",
]
