"""Port of `eetq_tpu.dist`: tensor and expert parallelism across
`torch.distributed` ranks (`sharding.py`), pipeline parallelism
(`pipeline.py`), ring attention and sequence-parallel long-context prefill
(`ring_attention.py`, `long_context.py`), data parallelism over a mesh's
`data` axis (`make_mesh(tp, dp)`, `multihost.make_hybrid_mesh`), joining the
ranks (`multihost.py`) and spawning them on one machine (`launch.py`)."""

from eetq_tpu_torch.dist import multihost
from eetq_tpu_torch.dist.long_context import generate_long, long_prefill
from eetq_tpu_torch.dist.pipeline import (
    PipelinedModel,
    init_pp_caches,
    make_pp_mesh,
    pp_decode_loop,
    pp_generate,
    pp_prefill,
    shard_model_pp,
)
from eetq_tpu_torch.dist.ring_attention import ring_attention, ring_attention_sharded
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
    "generate_long",
    "long_prefill",
    "make_pp_mesh",
    "PipelinedModel",
    "init_pp_caches",
    "pp_decode_loop",
    "pp_generate",
    "pp_prefill",
    "shard_model_pp",
    "ring_attention",
    "ring_attention_sharded",
    "Mesh",
    "make_mesh",
    "ShardedModel",
    "shard_model",
    "split_qkv_columns",
    "split_gateup_columns",
    "split_rows",
]
