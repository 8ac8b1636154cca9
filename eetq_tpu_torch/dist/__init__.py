"""Port of `eetq_tpu.dist`: the pure tensor-parallel splits only. Meshes,
sharded models, collectives and expert parallelism are ROADMAP.md queue 1
item 9."""

from eetq_tpu_torch.dist.sharding import split_gateup_columns, split_qkv_columns, split_rows

__all__ = ["split_qkv_columns", "split_gateup_columns", "split_rows"]
