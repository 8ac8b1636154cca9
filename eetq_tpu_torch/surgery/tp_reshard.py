"""Offline tensor-parallel resharding of quantized checkpoints.

Port of `eetq_tpu/surgery/tp_reshard.py:42-161`. The reference's
`quantize(save_dir, tp)` flow (`models/base.py:74-102`,
`utils/base.py:132-250`) splits fused projections into tp shards before
quantization, so that each shard gets its own per-channel scales, then
merges the shards into one checkpoint. Two facts make that a quantization
mode here:

1. Column-parallel layers (qkv, gate|up): scales are per output channel, so
   quantizing each shard equals quantizing the whole (GQA included).
2. Row-parallel layers (o_proj, down): each rank's K slice quantized on its
   own equals group-wise quantization with group = K / tp. The merged
   artifact is a group-wise QuantLinear, which the int8 and int4 kernels
   run directly on one card, and which splits back into the ranks' shards
   without requantization (`split_quant_rows`).

`shard_quantized` slices such a model into a rank's shard for runtime
tensor parallelism (`dist/sharding.py`), without requantizing.
"""

from __future__ import annotations

from eetq_tpu_torch.dist.sharding import split_gateup_columns, split_qkv_columns
from eetq_tpu_torch.layout.tiling import PackedWeight, pack_weights, unpack_weights
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear, quantize_linear


def quantize_params_tp(params: ModelParams, cfg: ModelConfig, tp: int,
                       bits: int = 8) -> ModelParams:
    """Quantize a dense model so that the artifact is what independent
    per-shard quantization at tensor parallelism `tp` would give.

    tp == 1 is plain per-channel quantization. Row-parallel layers (o_proj,
    down) come out with group-wise scales [tp, N] (group = K / tp), every
    other projection per-channel. The lm_head stays dense (the reference's
    exclusion, `utils/base.py:273-274`). Quantizes where the weights lie;
    the result shares the embedding and the norms with `params`."""
    if any(lp.moe is not None for lp in params.layers):
        raise NotImplementedError(
            "MoE layers are not supported by the offline tp reshard; quantize with tp=1, "
            "or shard the dense model with dist.sharding.shard_model (expert parallelism)")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(
            f"model dims (heads={cfg.num_heads}/{cfg.num_kv_heads}, "
            f"intermediate={cfg.intermediate_size}) not divisible by tp={tp}")

    def col(lin):
        if isinstance(lin, QuantLinear):
            return lin
        return quantize_linear(lin.weight, bias=lin.bias, bits=bits)

    def row(lin):
        if isinstance(lin, QuantLinear):
            return lin
        kdim = lin.weight.shape[0]
        if kdim % tp:
            raise ValueError(f"K={kdim} not divisible by tp={tp}")
        return quantize_linear(lin.weight, bias=lin.bias, bits=bits,
                               group_size=None if tp == 1 else kdim // tp)

    layers = [LayerParams(lp.input_norm, col(lp.qkv), row(lp.o_proj), lp.post_norm,
                          gateup=col(lp.gateup), down=row(lp.down), qkv_lora=lp.qkv_lora,
                          o_lora=lp.o_lora)
              for lp in params.layers]
    return ModelParams(params.embed, layers, params.final_norm, params.lm_head)


# ---- lossless slicing of a quantized model into the ranks' shards ----


def _split_quant_columns_grouped(ql: QuantLinear, cfg: ModelConfig, tp: int,
                                 kind: str) -> list[QuantLinear]:
    """Column-split a quantized fused linear by projection group (Megatron
    grouping of qkv, or of gate|up): bit-exact, the scales being per output
    channel."""
    q = unpack_weights(ql.packed)
    if kind == "qkv":
        split = lambda t: split_qkv_columns(t, cfg, tp)  # noqa: E731
    else:
        split = lambda t: split_gateup_columns(t, tp)  # noqa: E731
    q_shards, s_shards = split(q), split(ql.scales)
    b_shards = None if ql.bias is None else split(ql.bias)
    return [QuantLinear(pack_weights(q_shards[i], bits=ql.bits), s_shards[i].contiguous(),
                        None if b_shards is None else b_shards[i].contiguous())
            for i in range(tp)]


def split_quant_rows(ql: QuantLinear, tp: int) -> list[QuantLinear]:
    """Row-split a quantized linear into tp shards, slicing group scales.

    Group-wise scales whose rows tp divides give each shard its block of
    scale rows (one row becomes per-channel scales): bit-exact with
    independent per-shard quantization. Per-channel scales are replicated
    (the same dequantized weight). The bias goes to rank 0 only: a
    row-parallel bias is added once, after the ranks' partial sums."""
    q = unpack_weights(ql.packed)
    kdim = q.shape[0]
    if kdim % tp:
        raise ValueError(f"K={kdim} not divisible by tp={tp}")
    rows_k = kdim // tp
    out = []
    for i in range(tp):
        s = ql.scales
        if s.dim() == 2 and s.shape[0] % tp == 0:
            rows = s.shape[0] // tp
            s = s[i * rows:(i + 1) * rows]
            if rows == 1:
                s = s[0]
        out.append(QuantLinear(pack_weights(q[i * rows_k:(i + 1) * rows_k], bits=ql.bits),
                               s.contiguous(), ql.bias if i == 0 else None))
    return out


def shard_quantized(params: ModelParams, cfg: ModelConfig, mesh=None):
    """This rank's shard of an already quantized model (say, loaded from a
    `quantize(save_dir, tp=N)` checkpoint), sliced without requantization
    (`eetq_tpu/surgery/tp_reshard.py:164-`): bit-exact to the stored
    integers. Where the checkpoint's tp equals the mesh's, each rank's
    o_proj and down group is one row of scales, that is per-channel scales.
    A quantized lm_head splits over the vocabulary with its scales, a dense
    one as it is; a tied head stays replicated. LoRA adapters are not
    carried into the shard. mesh: `dist.make_mesh()` when None. MoE layers
    raise, as in the JAX package."""
    from eetq_tpu_torch.dist.sharding import ShardedModel, make_mesh, split_vocab

    if any(lp.moe is not None for lp in params.layers):
        raise NotImplementedError(
            "shard_quantized doesn't support MoE layers yet; shard the dense model with "
            "dist.sharding.shard_model(quantize=True) (EP)")
    mesh = make_mesh() if mesh is None else mesh
    tp, r, dev = mesh.tp, mesh.tp_rank, mesh.device

    def on(ql: QuantLinear) -> QuantLinear:
        p = ql.packed
        return QuantLinear(PackedWeight(p.data.to(dev), p.k, p.n, p.bits), ql.scales.to(dev),
                           None if ql.bias is None else ql.bias.to(dev))

    layers = []
    for lp in params.layers:
        layers.append(LayerParams(
            lp.input_norm.to(dev),
            on(_split_quant_columns_grouped(lp.qkv, cfg, tp, "qkv")[r]),
            on(split_quant_rows(lp.o_proj, tp)[r]),
            lp.post_norm.to(dev),
            gateup=on(_split_quant_columns_grouped(lp.gateup, cfg, tp, "gateup")[r]),
            down=on(split_quant_rows(lp.down, tp)[r])))
    head = params.lm_head
    if isinstance(head, QuantLinear):
        q = unpack_weights(head.packed)
        bias = None if head.bias is None else split_vocab(head.bias, tp)[r].to(dev)
        head = QuantLinear(pack_weights(split_vocab(q, tp)[r].to(dev).contiguous(), bits=head.bits),
                           split_vocab(head.scales, tp)[r].to(dev).contiguous(), bias)
    elif head is not None:
        head = DenseLinear(split_vocab(head.weight, tp)[r].to(dev).contiguous())
    local = ModelParams(params.embed.to(dev), layers, params.final_norm.to(dev), head)
    return ShardedModel(cfg=cfg, mesh=mesh, params=local)
