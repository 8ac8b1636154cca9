"""Random-weight model construction and its quantization to W8A16 or W4A16.

Port of `eetq_tpu/models/init.py`, plus a layer-by-layer quantized
constructor (the counterpart of `bench.py::build_params` and
`scripts/bench_moe.py::build_moe_params`). Weights come from a `torch.Generator` on the given
device, one layer at a time, in the JAX package's draw order (an MoE layer:
router, gate|up bank, down bank, qkv, o_proj; a dense layer: qkv, o_proj,
gate|up, down; then the embedding and the lm_head). The values differ from
the JAX package's (another generator), so cross-package tests carry JAX's
weights over with `models/convert.py` instead.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
from eetq_tpu_torch.modules.linear import DenseLinear, quantize_linear
from eetq_tpu_torch.modules.moe import MoEMLP, quantize_moe


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32).mul_(std)


def _dense(gen, k: int, n: int, with_bias: bool = False) -> DenseLinear:
    w = _normal(gen, (k, n), k ** -0.5).to(torch.bfloat16)
    b = _normal(gen, (n,), 0.02).to(torch.bfloat16) if with_bias else None
    return DenseLinear(w, b)


def _dense_experts(gen, e: int, k: int, n: int) -> DenseLinear:
    return DenseLinear(_normal(gen, (e, k, n), k ** -0.5).to(torch.bfloat16))


def _dense_layer(cfg: ModelConfig, gen: torch.Generator) -> LayerParams:
    h, i = cfg.hidden_size, cfg.intermediate_size
    ones = torch.ones(h, dtype=torch.float32, device=gen.device)
    if cfg.num_experts:
        e = cfg.num_experts
        moe = MoEMLP(_dense(gen, h, e), _dense_experts(gen, e, h, 2 * i),
                     _dense_experts(gen, e, i, h))
        return LayerParams(ones, _dense(gen, h, cfg.qkv_out, with_bias=cfg.qkv_bias),
                           _dense(gen, cfg.num_heads * cfg.head_dim, h), ones.clone(), moe=moe)
    return LayerParams(
        input_norm=ones,
        qkv=_dense(gen, h, cfg.qkv_out, with_bias=cfg.qkv_bias),
        o_proj=_dense(gen, cfg.num_heads * cfg.head_dim, h),
        post_norm=ones.clone(),
        gateup=_dense(gen, h, 2 * i),
        down=_dense(gen, i, h),
    )


def _embed_and_head(cfg: ModelConfig, gen: torch.Generator):
    embed = _normal(gen, (cfg.vocab_size, cfg.hidden_size), 0.02).to(torch.bfloat16)
    lm_head = None if cfg.tie_word_embeddings else _dense(gen, cfg.hidden_size, cfg.vocab_size)
    return embed, lm_head


def random_dense_layers(cfg: ModelConfig, generator: torch.Generator):
    """The layers of `random_dense_params`, each drawn as the caller takes
    it: a model whose bf16 layers would not fit at once is consumed layer
    by layer (`dist.sharding.shard_model(layers=...)`)."""
    for _ in range(cfg.num_layers):
        yield _dense_layer(cfg, generator)


def random_dense_params(cfg: ModelConfig, generator: torch.Generator) -> ModelParams:
    """Unquantized bf16 model with fused qkv / gateup linears (stacked expert
    banks and a router on MoE layers), made on the generator's device. Linear
    weights ~ N(0, 1/K), embedding ~ N(0, 0.02^2), norms 1."""
    layers = list(random_dense_layers(cfg, generator))
    embed, lm_head = _embed_and_head(cfg, generator)
    final_norm = torch.ones(cfg.hidden_size, dtype=torch.float32, device=generator.device)
    return ModelParams(embed, layers, final_norm, lm_head)


def _q(lin: DenseLinear, bits: int, group_size: int | None):
    return quantize_linear(lin.weight, bias=lin.bias, bits=bits, group_size=group_size)


def _quantize_layer(lp: LayerParams, bits: int, group_size: int | None) -> LayerParams:
    def q(lin):
        return _q(lin, bits, group_size)

    adapters = dict(qkv_lora=lp.qkv_lora, o_lora=lp.o_lora)
    if lp.moe is not None:
        return LayerParams(lp.input_norm, q(lp.qkv), q(lp.o_proj), lp.post_norm,
                           moe=quantize_moe(lp.moe, bits=bits, group_size=group_size), **adapters)
    return LayerParams(lp.input_norm, q(lp.qkv), q(lp.o_proj), lp.post_norm,
                       q(lp.gateup), q(lp.down), **adapters)


def quantize_params(params: ModelParams, bits: int = 8, quantize_lm_head: bool = False,
                    group_size: int | None = None) -> ModelParams:
    """Every dense decoder linear and expert bank becomes symmetric int8 or
    int4 (`bits`), per-channel or group-wise (`group_size`, the usual int4
    setting), one layer at a time; the routers stay bf16. The lm_head is
    quantized the same way with quantize_lm_head=True (it stays dense by
    default, as in the reference). Returns a new ModelParams that shares the
    embedding and norms with `params` (`eetq_tpu/models/init.py:95-136`)."""
    layers = [_quantize_layer(lp, bits, group_size) for lp in params.layers]
    lm_head = params.lm_head
    if quantize_lm_head and isinstance(lm_head, DenseLinear):
        lm_head = _q(lm_head, bits, group_size)
    return ModelParams(params.embed, layers, params.final_norm, lm_head)


def random_quantized_params(cfg: ModelConfig, generator: torch.Generator,
                            quantize_lm_head: bool = False, bits: int = 8,
                            group_size: int | None = None) -> ModelParams:
    """`quantize_params(random_dense_params(cfg, generator), bits,
    quantize_lm_head, group_size)` without the whole bf16 model: each layer
    is drawn in bf16, quantized at once and dropped, so the peak is the
    quantized model plus one bf16 layer. Mixtral-8x7B is about 93 GB in
    bf16, more than an H100 holds, and about 47 GB at W8A16. The draws are
    the same, so the result is equal."""
    layers = [_quantize_layer(_dense_layer(cfg, generator), bits, group_size)
              for _ in range(cfg.num_layers)]
    embed, lm_head = _embed_and_head(cfg, generator)
    if quantize_lm_head and lm_head is not None:
        lm_head = _q(lm_head, bits, group_size)
    final_norm = torch.ones(cfg.hidden_size, dtype=torch.float32, device=generator.device)
    return ModelParams(embed, layers, final_norm, lm_head)
