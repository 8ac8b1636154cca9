"""Tensor and expert parallelism across `torch.distributed` ranks.

Port of `eetq_tpu/dist/sharding.py`. Each rank is one process that holds its
shard of the model and runs the port's kernels on it; where the JAX package
calls `psum`, `all_gather` or `ppermute` inside `shard_map`, the rank
calls its mesh's `all_reduce_`, `all_gather` or `ppermute` on that axis:

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

The mesh (`make_mesh(tp, dp, pp=)`, `dist/pipeline.py::make_pp_mesh`,
`dist/multihost.py::make_hybrid_mesh`) is dp data shards of pp stages of tp
ranks, laid out as JAX's (data, pipe, model) mesh with `model` innermost;
each axis has its process group, and `Mesh.tp_rank` is a rank's index on
the model axis (its shard). A data shard's ranks hold the same weights and
run their own rows of the batch: rows [d B / dp, (d + 1) B / dp) of a global
batch B (`Mesh.data_rows`), their KV caches B / dp rows
(`ShardedModel.init_caches`); the collectives of a forward stay on the model
axis, and what every rank needs of the other shards' rows is gathered over
`data` outside the forward (`Mesh.gather_rows`, JAX's `process_allgather`
of a data-sharded result). Its backend is the process group's: NCCL on
`cuda:rank` when every rank has a card, gloo where ranks share one card or
run on the CPU (a gloo collective or exchange on a CUDA tensor is staged
through the host here, so a sharded step cannot be captured into a CUDA
graph and runs eagerly). Every
collective counts its calls and the bytes of its input
(`collective_counts`; `utils/profiling.py::count_collectives` reads them):
"all_reduce" (JAX's psum), "all_gather" and "ppermute" (`Mesh.ppermute`,
the neighbour exchange of the pipeline and of ring attention).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DATA_AXIS, MODEL_AXIS, PIPE_AXIS = "data", "model", "pipe"

_COUNTS: dict[str, int] = {}


def collective_counts() -> dict[str, int]:
    """{op: bytes, op + "_count": calls} of this process's collectives since
    the last reset (op "all_reduce", "all_gather" or "ppermute"; bytes of
    the inputs)."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(op: str, x: torch.Tensor) -> None:
    _COUNTS[op] = _COUNTS.get(op, 0) + x.numel() * x.element_size()
    _COUNTS[f"{op}_count"] = _COUNTS.get(f"{op}_count", 0) + 1


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, pipe, model) mesh of the process group,
    laid out as JAX's `devices.reshape(dp, pp, tp)` with `model` innermost:
    global rank = (d pp + p) tp + t. It holds the axis sizes, this rank's
    global index, its device, the backend and a process group for each axis
    of more than one rank (None: the default group, where the axis spans the
    world). `make_mesh(tp)` is the mesh of tp ranks, dp = pp = 1."""

    tp: int
    rank: int
    device: torch.device
    backend: str | None = None
    pp: int = 1
    model_group: object = None  # dist.ProcessGroup of this rank's model axis
    pipe_group: object = None  # ... of its pipe axis
    dp: int = 1
    data_group: object = None  # ... and of its data axis

    @property
    def tp_rank(self) -> int:
        """This rank's index on the model axis (its tensor-parallel shard)."""
        return self.rank % self.tp

    @property
    def pp_rank(self) -> int:
        """This rank's index on the pipe axis (its stage)."""
        return self.rank // self.tp % self.pp

    @property
    def dp_rank(self) -> int:
        """This rank's index on the data axis (its rows of the batch)."""
        return self.rank // (self.tp * self.pp)

    def axis_size(self, axis: str) -> int:
        return {MODEL_AXIS: self.tp, PIPE_AXIS: self.pp, DATA_AXIS: self.dp}[axis]

    def axis_index(self, axis: str) -> int:
        return {MODEL_AXIS: self.tp_rank, PIPE_AXIS: self.pp_rank, DATA_AXIS: self.dp_rank}[axis]

    def _group(self, axis: str):
        return {MODEL_AXIS: self.model_group, PIPE_AXIS: self.pipe_group,
                DATA_AXIS: self.data_group}[axis]

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at `index` on `axis`, this rank's other indices kept."""
        step = {MODEL_AXIS: 1, PIPE_AXIS: self.tp, DATA_AXIS: self.tp * self.pp}[axis]
        return self.rank + (index - self.axis_index(axis)) * step

    def data_rows(self, batch: int) -> slice:
        """This data shard's rows of a global batch: [d b, (d + 1) b), b =
        batch / dp. Raises where dp does not divide the batch (JAX's
        sharding of a batch over `data` refuses it too)."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} not divisible by data shards {self.dp}")
        b = batch // self.dp
        return slice(self.dp_rank * b, (self.dp_rank + 1) * b)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data shards' x side by side on dim 0, in shard order: a
        data-sharded result made whole on every rank (JAX's
        `process_allgather(x, tiled=True)`); counted as an all_gather."""
        return self.all_gather(x, 0, DATA_AXIS)

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def all_reduce_(self, x: torch.Tensor, axis: str = MODEL_AXIS,
                    op: str = "sum") -> torch.Tensor:
        """The sum (op "sum"; or the "max") of x over the ranks of `axis`
        (the model axis: JAX's psum over `model`), in x's dtype (bf16
        partials summed in bf16, as the JAX psum), in place where x is
        contiguous; returns it."""
        if self.axis_size(axis) == 1:
            return x
        x = x.contiguous()
        _count("all_reduce", x)
        group = self._group(axis)
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._staged(x):
            host = x.cpu()
            dist.all_reduce(host, op=red, group=group)
            x.copy_(host)
        else:
            dist.all_reduce(x, op=red, group=group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int, axis: str = MODEL_AXIS,
                   tiled: bool = True) -> torch.Tensor:
        """The ranks' x along `axis`, in index order: side by side on `dim`
        (tiled, `jax.lax.all_gather(x, axis, axis=dim, tiled=True)`) or
        stacked on a new `dim` (tiled=False)."""
        n = self.axis_size(axis)
        if n == 1:
            return x if tiled else x.unsqueeze(dim)
        _count("all_gather", x)
        src = (x.cpu() if self._staged(x) else x).contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self._group(axis))
        return (torch.cat if tiled else torch.stack)(parts, dim=dim).to(x.device)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """The model axis' x [..., n] side by side on the last axis:
        [..., tp n] (`jax.lax.all_gather(x, axis=-1, tiled=True)`)."""
        return self.all_gather(x, -1)

    def ppermute(self, x, axis: str, perm):
        """`jax.lax.ppermute` along `axis`: x (a tensor, or a tuple of them)
        goes from each source index to its target in `perm`, a list of
        (source, target) pairs; returns what this rank received (zeros where
        no pair targets it), in x's structure. Every receive and send of the
        call is posted before any is waited on (`dist.batch_isend_irecv`),
        so a ring does not deadlock; under gloo CUDA tensors go through the
        host, under NCCL device to device. Counted once for each tensor, with
        its bytes, as JAX binds one ppermute a leaf."""
        xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
        n, me = self.axis_size(axis), self.axis_index(axis)
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or not all(0 <= i < n for i in srcs + dsts)):
            raise ValueError(f"ppermute: {perm} is not a permutation of {n} indices")
        for t in xs:
            _count("ppermute", t)
        src = next((s for s, d in perm if d == me), None)
        dst = next((d for s, d in perm if s == me), None)
        if src == me:  # a one-rank ring: this rank is its own neighbour
            out = [t.clone() for t in xs]
        else:
            staged = self._staged(xs[0])
            sends = [(t.cpu() if staged else t).contiguous() for t in xs]
            recvs = [torch.empty_like(t) for t in sends] if src is not None else []
            group, ops = self._group(axis), []
            for i, (t, r) in enumerate(zip(sends, recvs or [None] * len(sends))):
                if r is not None:
                    ops.append(dist.P2POp(dist.irecv, r, self.global_rank(axis, src), group,
                                          tag=i))
                if dst is not None:
                    ops.append(dist.P2POp(dist.isend, t, self.global_rank(axis, dst), group,
                                          tag=i))
            for work in (dist.batch_isend_irecv(ops) if ops else []):
                work.wait()
            out = ([r.to(t.device) for r, t in zip(recvs, xs)] if recvs
                   else [torch.zeros_like(t) for t in xs])
        return out[0] if isinstance(x, torch.Tensor) else tuple(out)


def make_mesh(tp: int | None = None, dp: int = 1, device: torch.device | str | None = None,
              pp: int = 1) -> Mesh:
    """This rank's mesh over the initialised process group
    (`dist.multihost.initialize`), or a mesh of one rank where there is
    none: dp data shards of pp stages of tp ranks
    (`eetq_tpu/dist/sharding.py:52-60`, `dist/pipeline.py::make_pp_mesh`),
    model innermost. tp defaults to the world size over dp pp, and dp pp tp
    must equal the world size. Every rank makes every axis group, in one
    order (model, pipe, data; `dist.new_group` is collective over the world,
    even for the groups a rank is not in); an axis of one rank has none, one
    that spans the world the default group. device: this rank's, by default
    `cuda:rank` over the machine's cards (ranks share a card where there are
    fewer cards than ranks); the CPU where asked."""
    up = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if up else (1, 0)
    dp, pp = int(dp), int(pp)
    tp = world // (dp * pp) if tp is None else int(tp)
    if min(dp, pp, tp) < 1 or dp * pp * tp != world:
        raise ValueError(f"dp={dp} x pp={pp} x tp={tp} must equal the world size {world}")

    def at(d: int, p: int, t: int) -> int:
        return (d * pp + p) * tp + t

    def axis_group(members: list[list[int]]):
        mine = None
        for ranks in members:
            if 1 < len(ranks) < world:
                group = dist.new_group(ranks)
                mine = group if rank in ranks else mine
        return mine

    model_group = axis_group([[at(d, p, t) for t in range(tp)]
                              for d in range(dp) for p in range(pp)])
    pipe_group = axis_group([[at(d, p, t) for p in range(pp)]
                             for d in range(dp) for t in range(tp)])
    data_group = axis_group([[at(d, p, t) for d in range(dp)]
                             for p in range(pp) for t in range(tp)])
    if device is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    device = torch.device(device)
    backend = dist.get_backend() if up else None
    if backend == "nccl":
        torch.cuda.set_device(device)
    mesh = Mesh(tp=tp, rank=rank, device=device, backend=backend, pp=pp,
                model_group=model_group, pipe_group=pipe_group, dp=dp, data_group=data_group)
    log.info("mesh: rank %d (data shard %d of dp %d, stage %d of pp %d, shard %d of tp %d) on "
             "%s, collectives over %s", rank, mesh.dp_rank, dp, mesh.pp_rank, pp, mesh.tp_rank,
             tp, device, backend or "none")
    return mesh


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
        """This rank's KV caches of a global batch: its data shard's batch / dp
        rows of its kv heads, on its device (JAX's cache spec (data, model))."""
        from eetq_tpu_torch.models.transformer import init_caches

        rows = self.mesh.data_rows(batch)
        return init_caches(cache_spec(self.cfg, self.mesh), rows.stop - rows.start, max_len,
                           self.mesh.device, dtype)


def cache_spec(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """The config a rank's KV caches are made from: its Hq / tp and Hkv / tp
    heads (`cache_spec`, heads over the model axis)."""
    if cfg.num_heads % mesh.tp or cfg.num_kv_heads % mesh.tp:
        raise ValueError(f"heads ({cfg.num_heads}, {cfg.num_kv_heads}) not divisible by "
                         f"tp={mesh.tp}")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // mesh.tp,
                               num_kv_heads=cfg.num_kv_heads // mesh.tp)


def shard_layer(lp, cfg: ModelConfig, mesh: Mesh, quantize: bool = True, bits: int = 8):
    """This rank's shard of one dense layer (LayerParams) on the mesh's
    device: qkv and gate|up split by columns, o_proj and down by rows, the
    experts E / tp a rank, each shard quantized on its own where quantize
    (`shard_model`, `dist/pipeline.py::shard_model_pp`). Refuses a
    row-parallel bias, heads or experts not divisible by tp, and a
    quantized layer."""
    from eetq_tpu_torch.models.transformer import LayerParams
    from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear, quantize_linear
    from eetq_tpu_torch.modules.moe import MoEMLP, _quantize_bank

    tp, r, dev = mesh.tp, mesh.tp_rank, mesh.device

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
        gu_b = None if lp.gateup.bias is None else mine(split_gateup_columns(lp.gateup.bias, tp))
        mlp["gateup"] = linear(mine(split_gateup_columns(lp.gateup.weight, tp)), gu_b)
        mlp["down"] = linear(mine(split_rows(lp.down.weight, tp)))
    return LayerParams(lp.input_norm.to(dev), qkv, o, lp.post_norm.to(dev), **mlp)


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
    from eetq_tpu_torch.models.transformer import ModelParams
    from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear

    out = []
    for lp in (dense_params.layers if layers is None else layers):
        out.append(shard_layer(lp, cfg, mesh, quantize, bits))
        del lp

    lm_head = dense_params.lm_head
    if lm_head is not None:
        if isinstance(lm_head, QuantLinear):
            raise ValueError("shard_model keeps the lm_head dense; shard a quantized head with "
                             "surgery.tp_reshard.shard_quantized")
        lm_head = DenseLinear(split_vocab(lm_head.weight, mesh.tp)[mesh.tp_rank].to(mesh.device)
                              .contiguous())
    dev = mesh.device
    params = ModelParams(dense_params.embed.to(dev), out, dense_params.final_norm.to(dev),
                         lm_head)
    return ShardedModel(cfg=cfg, mesh=mesh, params=params)


def make_forward_fn(model: ShardedModel):
    """fwd(params, tokens, positions, caches, offset, **kw) -> (logits,
    caches): the sharded decoder with its collectives
    (`eetq_tpu/dist/sharding.py:426-476`). tokens and positions [B, S] are
    the global batch, given alike to every rank; a data shard runs its rows
    (`Mesh.data_rows`) over its caches (`ShardedModel.init_caches`), and its
    logits [B / dp, S, V] f32 are those rows' over the whole vocabulary,
    equal on the shard's ranks (`Mesh.gather_rows` gathers all B). offset is
    an int or [B], each row's cache position (JAX's per_row_offset); kw are
    `forward_inner`'s, a [B] tensor among them (last_pos: each row's position
    gathered before the lm_head, so the head and its vocab gather see one
    row a sequence, JAX's last_pos) cut to the shard's rows too."""
    from eetq_tpu_torch.models.transformer import forward_inner

    mesh = model.mesh

    def fwd(params, tokens, positions, caches, offset, **kw):
        rows = mesh.data_rows(tokens.shape[0])
        if mesh.dp > 1:
            tokens, positions = tokens[rows], positions[rows]
            if isinstance(offset, torch.Tensor) and offset.dim():
                offset = offset[rows]
            kw = {k: v[rows] if isinstance(v, torch.Tensor) and v.dim() else v
                  for k, v in kw.items()}
        return forward_inner(params, model.cfg, tokens, positions, caches, offset,
                             mesh=mesh, **kw)

    return fwd
