"""Tensor and expert parallelism across `torch.distributed` ranks.

Port of `eetq_tpu/dist/sharding.py`. Each rank is one process that holds its
shard of the model and runs the port's kernels on it; where the JAX package
calls `psum` or `all_gather` inside `shard_map`, the rank calls its mesh's
`all_reduce_` or `all_gather_last`:

- qkv and gate|up are column-parallel (Megatron grouping: a rank holds its
  q heads with their kv heads, and its gate slice with its up slice);
  o_proj and down are row-parallel, their partial outputs all-reduced in
  bf16 (the decoder, `models/transformer.py`, 2 a layer);
- the MoE banks are split on the expert axis, E / tp experts a rank; the
  router, the norms and the embedding are replicated, and the MoE block's
  partial sum is all-reduced like down's (`modules/moe.py::moe_apply`);
- the dense lm_head is split over the vocabulary and its logits gathered
  along the last axis (one all-gather a forward); a tied head stays
  replicated;
- the KV cache holds the rank's kv heads (`ShardedModel.init_caches`).

Each shard is quantized on its own after the split (`shard_model`):
column shards own whole output channels, so their scales are the slices of
the global ones; a row shard's scales cover its own K rows, which equals
group-wise quantization with group = K / tp (`surgery/tp_reshard.py`).

The mesh (`make_mesh`) is tp ranks of one data-parallel row: dp > 1 and the
hybrid mesh are ROADMAP.md queue 1 item 9. Its backend is the process
group's: NCCL on `cuda:rank` when every rank has a card, gloo where ranks
share one card or run on the CPU (a gloo collective on a CUDA tensor is
staged through the host here, so a sharded step cannot be captured into a
CUDA graph and runs eagerly). Every collective counts its calls and the
bytes of its input (`collective_counts`; `utils/profiling.py::
count_collectives` reads them), under torch's names.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_DP_NOT_PORTED = ("dp > 1 (data parallelism and the hybrid mesh) is not ported yet: "
                  "ROADMAP.md queue 1 item 9")

_COUNTS: dict[str, int] = {}


def collective_counts() -> dict[str, int]:
    """{op: bytes, op + "_count": calls} of this process's collectives since
    the last reset (op "all_reduce" or "all_gather"; bytes of the inputs)."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(op: str, x: torch.Tensor) -> None:
    _COUNTS[op] = _COUNTS.get(op, 0) + x.numel() * x.element_size()
    _COUNTS[f"{op}_count"] = _COUNTS.get(f"{op}_count", 0) + 1


@dataclasses.dataclass
class Mesh:
    """tp ranks of one data-parallel row over the default process group:
    this rank's index, its device and the group's backend."""

    tp: int
    rank: int
    device: torch.device
    backend: str | None = None

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks, in x's dtype (bf16 partials summed in
        bf16, as the JAX psum), in place where x is contiguous; returns it."""
        if self.tp == 1:
            return x
        x = x.contiguous()
        _count("all_reduce", x)
        if self._staged(x):
            host = x.cpu()
            dist.all_reduce(host)
            x.copy_(host)
        else:
            dist.all_reduce(x)
        return x

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x [..., n] side by side on the last axis: [..., tp n]
        (`jax.lax.all_gather(x, axis=-1, tiled=True)`)."""
        if self.tp == 1:
            return x
        _count("all_gather", x)
        src = (x.cpu() if self._staged(x) else x).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.tp)]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=-1).to(x.device)


def make_mesh(tp: int | None = None, dp: int = 1, device: torch.device | str | None = None) -> Mesh:
    """This rank's mesh over the initialised process group
    (`dist.multihost.initialize`), or a mesh of one rank where there is
    none. tp defaults to the world size and must equal it. device: this
    rank's, by default `cuda:rank` over the machine's cards (ranks share a
    card where there are fewer cards than ranks); the CPU where asked."""
    if dp != 1:
        raise NotImplementedError(_DP_NOT_PORTED)
    up = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    tp = world if tp is None else int(tp)
    if tp != world:
        raise ValueError(f"tp={tp} must equal the world size {world} (dp = 1)")
    if device is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    device = torch.device(device)
    backend = dist.get_backend() if up else None
    if backend == "nccl":
        torch.cuda.set_device(device)
    log.info("mesh: rank %d of tp %d on %s, collectives over %s", rank, tp, device,
             backend or "none")
    return Mesh(tp=tp, rank=rank, device=device, backend=backend)


# ---- column and row splits (the runtime counterparts of the reference's
# offline split_tp_column / split_tp_row, `utils/base.py:132-186`) ----


def split_qkv_columns(w: torch.Tensor, cfg: ModelConfig, tp: int) -> list[torch.Tensor]:
    """Split a fused qkv weight [K, (Hq + 2 Hkv) D] into tp column shards,
    each holding its own q, k and v heads (Megatron grouping: shard i gets q
    heads [i Hq / tp, (i + 1) Hq / tp) and the matching kv heads, so GQA
    groups stay together). Works on weights, biases and scales alike (the
    last axis is split)."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hq % tp or hkv % tp:
        raise ValueError(f"heads ({hq}, {hkv}) not divisible by tp={tp}")
    q, k, v = w[..., : hq * d], w[..., hq * d: (hq + hkv) * d], w[..., (hq + hkv) * d:]
    qs, ks, vs = (torch.chunk(t, tp, dim=-1) for t in (q, k, v))
    return [torch.cat([qs[i], ks[i], vs[i]], dim=-1) for i in range(tp)]


def split_gateup_columns(w: torch.Tensor, tp: int) -> list[torch.Tensor]:
    """Split a fused gate|up weight [K, 2I] into tp shards [K, 2I / tp], each
    holding its gate slice and its up slice."""
    if w.shape[-1] % (2 * tp):
        raise ValueError(f"gate|up width {w.shape[-1]} not divisible by 2 tp = {2 * tp}")
    gate, up = torch.chunk(w, 2, dim=-1)
    gs, us = torch.chunk(gate, tp, dim=-1), torch.chunk(up, tp, dim=-1)
    return [torch.cat([gs[i], us[i]], dim=-1) for i in range(tp)]


def split_rows(w: torch.Tensor, tp: int) -> list[torch.Tensor]:
    """Row split of o_proj / down [K, N] into tp shards [K / tp, N]."""
    if w.shape[-2] % tp:
        raise ValueError(f"K={w.shape[-2]} not divisible by tp={tp}")
    return list(torch.chunk(w, tp, dim=-2))


def split_vocab(w: torch.Tensor, tp: int) -> list[torch.Tensor]:
    """Column split of an lm_head [H, V] (or its scales and bias) over the
    vocabulary."""
    if w.shape[-1] % tp:
        raise ValueError(f"vocab {w.shape[-1]} not divisible by tp={tp}")
    return list(torch.chunk(w, tp, dim=-1))


# ---- the sharded model ----


@dataclasses.dataclass
class ShardedModel:
    """This rank's shard of a model (`params`: a ModelParams of local heads,
    columns, rows and experts), the global config and the mesh."""

    cfg: ModelConfig
    mesh: Mesh
    params: object  # models.transformer.ModelParams

    @property
    def tp(self) -> int:
        return self.mesh.tp

    def init_caches(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16):
        """This rank's KV caches: its kv heads, on its device."""
        from eetq_tpu_torch.models.transformer import init_caches

        return init_caches(cache_spec(self.cfg, self.mesh), batch, max_len, self.mesh.device,
                           dtype)


def cache_spec(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """The config a rank's KV caches are made from: its Hq / tp and Hkv / tp
    heads (`cache_spec`, heads over the model axis)."""
    if cfg.num_heads % mesh.tp or cfg.num_kv_heads % mesh.tp:
        raise ValueError(f"heads ({cfg.num_heads}, {cfg.num_kv_heads}) not divisible by "
                         f"tp={mesh.tp}")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // mesh.tp,
                               num_kv_heads=cfg.num_kv_heads // mesh.tp)


def shard_model(dense_params, cfg: ModelConfig, mesh: Mesh, quantize: bool = True,
                bits: int = 8, layers=None) -> ShardedModel:
    """This rank's shard of a dense model: split, then (quantize=True) each
    shard quantized on its own, per output channel, and placed on the mesh's
    device (`eetq_tpu/dist/sharding.py:119-331`). Layer by layer: `layers`,
    an iterable of dense LayerParams consumed one at a time, takes the place
    of dense_params.layers (a model whose bf16 layers would not fit at once
    is drawn layer by layer from its seed); a rank keeps only its shard.

    Refuses what the JAX package refuses: a row-parallel bias (o_proj,
    down), heads, the vocabulary or the experts not divisible by tp. LoRA
    adapters are not carried into the shard, as in the JAX package."""
    from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
    from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear, quantize_linear
    from eetq_tpu_torch.modules.moe import MoEMLP, _quantize_bank

    tp, r, dev = mesh.tp, mesh.rank, mesh.device

    def mine(shards: list[torch.Tensor]) -> torch.Tensor:
        return shards[r].to(dev).contiguous()

    def linear(w: torch.Tensor, b: torch.Tensor | None = None):
        if quantize:
            return quantize_linear(w, bias=b, bits=bits)
        return DenseLinear(w, b)

    def moe_shard(moe: MoEMLP) -> MoEMLP:
        e = moe.num_experts
        if e % tp:
            raise ValueError(f"num_experts {e} not divisible by tp={tp}")
        el = e // tp

        def bank(lin: DenseLinear):
            local = DenseLinear(lin.weight[r * el:(r + 1) * el].to(dev).contiguous())
            return _quantize_bank(local, bits) if quantize else local

        return MoEMLP(DenseLinear(moe.router.weight.to(dev)), bank(moe.gateup), bank(moe.down))

    out = []
    for lp in (dense_params.layers if layers is None else layers):
        if isinstance(lp.qkv, QuantLinear):
            raise ValueError("shard_model takes a dense model; shard a quantized one with "
                             "surgery.tp_reshard.shard_quantized")
        if lp.o_proj.bias is not None or (lp.down is not None and lp.down.bias is not None):
            raise NotImplementedError("row-parallel bias sharding not supported")
        qkv_b = None if lp.qkv.bias is None else mine(split_qkv_columns(lp.qkv.bias, cfg, tp))
        qkv = linear(mine(split_qkv_columns(lp.qkv.weight, cfg, tp)), qkv_b)
        o = linear(mine(split_rows(lp.o_proj.weight, tp)))
        mlp = {}
        if lp.moe is not None:
            mlp["moe"] = moe_shard(lp.moe)
        else:
            gu_b = (None if lp.gateup.bias is None
                    else mine(split_gateup_columns(lp.gateup.bias, tp)))
            mlp["gateup"] = linear(mine(split_gateup_columns(lp.gateup.weight, tp)), gu_b)
            mlp["down"] = linear(mine(split_rows(lp.down.weight, tp)))
        out.append(LayerParams(lp.input_norm.to(dev), qkv, o, lp.post_norm.to(dev), **mlp))
        del lp

    lm_head = dense_params.lm_head
    if lm_head is not None:
        if isinstance(lm_head, QuantLinear):
            raise ValueError("shard_model keeps the lm_head dense; shard a quantized head with "
                             "surgery.tp_reshard.shard_quantized")
        lm_head = DenseLinear(mine(split_vocab(lm_head.weight, tp)))
    params = ModelParams(dense_params.embed.to(dev), out, dense_params.final_norm.to(dev),
                         lm_head)
    return ShardedModel(cfg=cfg, mesh=mesh, params=params)


def make_forward_fn(model: ShardedModel):
    """fwd(params, tokens, positions, caches, offset, **kw) -> (logits,
    caches): the sharded decoder with its collectives, logits [B, S, V] f32
    of the whole vocabulary, equal on every rank
    (`eetq_tpu/dist/sharding.py:426-476`). offset is an int or [B], each
    row's cache position (JAX's per_row_offset); kw are `forward_inner`'s
    (last_pos [B]: each row's position gathered before the lm_head, so the
    head and its vocab gather see one row a sequence, JAX's last_pos)."""
    from eetq_tpu_torch.models.transformer import forward_inner

    def fwd(params, tokens, positions, caches, offset, **kw):
        return forward_inner(params, model.cfg, tokens, positions, caches, offset,
                             mesh=model.mesh, **kw)

    return fwd
