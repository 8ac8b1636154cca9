"""HuggingFace checkpoint interop: load fp16 checkpoints, convert live torch
models, save and load W8A16/W4A16 checkpoints in the transformers-eetq
format.

Port of `eetq_tpu/models/hf.py`. A saved projection is its UNPACKED
[out, in] int8 weight (int4 values one per int8) with fp16 `weight_scales`
([out] per channel, the group rows concatenated to [G*out] group-wise), so
checkpoints move between the two packages and across kernel layouts. The
port writes what the JAX package writes, tensor for tensor: the same names,
dtypes and shapes, the same split into shards at `max_shard_bytes` (in the
same order, by the same running sum of bytes), the same index and the same
`config.json` and `quant_config.json`.

What differs is where the work runs. Files are read and written by
`models/safetensors_io.py` (the `safetensors` package is not a dependency):
a tensor is read from the file's mapping and moved to the target device
(`device=None` is the card), where it is transposed, quantized and packed;
a quantized dense projection is quantized there by `quant/quantizer.py::
symmetric_quantize` on the card, or by the native host quantizer
(`native/`) on the CPU (both bit-identical to the JAX package's host
quantizer, on the same f32, f16 or bf16 values) and freed, so the peak is
one dense layer. A
save streams: each tensor is made on its device when the writer reaches it
and crosses to the host through one pinned buffer.
"""

from __future__ import annotations

import json
import os

import torch

from eetq_tpu_torch.layout.tiling import PackedWeight, pack_weights, unpack_weights
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.safetensors_io import Pending, SafetensorsFile, save_file
from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear
from eetq_tpu_torch.modules.moe import MoEMLP
from eetq_tpu_torch.quant.quantizer import symmetric_quantize
from eetq_tpu_torch.utils.device import resolve
from eetq_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# Weight-name scheme per model family. Baichuan ships a pre-fused qkv
# ("W_pack", rows q|k|v), which transposes directly into the fused layout;
# chatglm2/3 fuses BOTH qkv ("query_key_value", rows q|k|v with MQA-sized
# k/v) and gate/up ("dense_h_to_4h", rows gate|up) and roots everything under
# "transformer.encoder". Families without explicit name keys use the llama
# scheme.
_LLAMA_NAMES = dict(
    layer="model.layers.{i}",
    attn="self_attn",
    o="o_proj",
    gateup=("mlp.gate_proj", "mlp.up_proj"),
    down="mlp.down_proj",
    embed="model.embed_tokens.weight",
    final_norm="model.norm.weight",
    lm_head="lm_head.weight",
)
_FAMILY = {
    "llama": dict(qkv=("q_proj", "k_proj", "v_proj")),
    "mistral": dict(qkv=("q_proj", "k_proj", "v_proj")),
    # mixtral: llama attention + routed MoE MLP under block_sparse_moe: gate =
    # the [E, H] router, experts.{j}.w1/w3 = expert j's gate/up projections
    # (fused into the stacked [E, H, 2I] bank), w2 = down ([E, I, H])
    "mixtral": dict(
        qkv=("q_proj", "k_proj", "v_proj"),
        moe_router="block_sparse_moe.gate",
        moe_expert="block_sparse_moe.experts.{j}",
    ),
    "gemma": dict(qkv=("q_proj", "k_proj", "v_proj")),
    "baichuan": dict(qkv=("W_pack",)),
    "qwen2": dict(qkv=("q_proj", "k_proj", "v_proj")),  # with qkv biases
    "chatglm": dict(
        qkv=("query_key_value",),
        layer="transformer.encoder.layers.{i}",
        attn="self_attention",
        o="dense",
        gateup=("mlp.dense_h_to_4h",),
        down="mlp.dense_4h_to_h",
        embed="transformer.embedding.word_embeddings.weight",
        final_norm="transformer.encoder.final_layernorm.weight",
        lm_head="transformer.output_layer.weight",
    ),
}


def _family(model_type: str) -> dict:
    if model_type not in _FAMILY:
        raise ValueError(
            f"unsupported model_type {model_type!r}; supported: {list(_FAMILY)}"
        )
    return {**_LLAMA_NAMES, **_FAMILY[model_type]}


class _TensorSource:
    """Uniform name -> tensor access over a safetensors directory or a torch
    state_dict."""

    def __init__(self, get, names):
        self.get = get
        self.names = set(names)

    def __contains__(self, name):
        return name in self.names

    def __call__(self, name) -> torch.Tensor:
        if name not in self.names:
            raise KeyError(name)
        return self.get(name)


def _source_from_dir(path: str) -> _TensorSource:
    idx_file = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx_file):
        with open(idx_file) as f:
            weight_map = json.load(f)["weight_map"]
        return _TensorSource(_one_handle_getter(path, weight_map), weight_map.keys())
    st_files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if not st_files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    names = {}
    for f in st_files:
        with SafetensorsFile(os.path.join(path, f)) as h:
            for n in h.keys():
                names[n] = f
    return _TensorSource(_one_handle_getter(path, names), names.keys())


def _one_handle_getter(path: str, weight_map: dict):
    """name -> CPU tensor over the file's mapping, keeping ONE shard open at
    a time (reads cluster per file)."""
    current: dict = {}

    def get(name):
        fn = os.path.join(path, weight_map[name])
        if current.get("fn") != fn:
            if "h" in current:
                current["h"].close()
            current["fn"] = fn
            current["h"] = SafetensorsFile(fn)
        return current["h"].get_tensor(name)

    return get


def _source_from_torch(model) -> _TensorSource:
    """A live torch model's state_dict, floats widened to f32 (as the JAX
    package reads them), on the model's own device."""
    sd = model.state_dict()

    def get(name):
        t = sd[name].detach()
        return t.float() if t.dtype.is_floating_point else t

    return _TensorSource(get, sd.keys())


def _transposed(w_t: torch.Tensor, dtype, device) -> torch.Tensor:
    """A torch [out, in] weight as [in, out] in `dtype`, on `device`."""
    return w_t.to(device).T.to(dtype).contiguous()


def _quantize(w: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel quantization where w lies: on the CPU by the native host
    quantizer (`native/`, as the JAX package's `_to_linear` and `_to_moe`),
    on the card by `symmetric_quantize` there; the same values either way."""
    if w.device.type == "cpu":
        from eetq_tpu_torch.native import host_symmetric_quantize

        return host_symmetric_quantize(w, bits=bits)
    return symmetric_quantize(w, bits=bits)


def _to_linear(w_t: torch.Tensor, quantize: bool, bits: int, dtype, device,
               bias: torch.Tensor | None = None):
    """torch [out, in] -> the port's [in, out], on `device`; optionally
    quantized there from the source's own values (f16 or bf16, or f32 from a
    torch model), as the JAX package's host quantizer does."""
    b = None if bias is None else bias.to(device=device, dtype=dtype)
    w = w_t.to(device).T
    if quantize:
        q, s = _quantize(w, bits)
        return QuantLinear(pack_weights(q, bits=bits), s, b)
    return DenseLinear(w.to(dtype).contiguous(), b)


def _to_moe(src, pfx: str, fam: dict, cfg: ModelConfig, quantize: bool,
            bits: int, dtype, device) -> MoEMLP:
    """A stacked-expert MoEMLP from HF mixtral weights: expert j's w1|w3
    become row j of the [E, H, 2I] gate|up bank, its w2 row j of the
    [E, I, H] down bank, the gate the [H, E] router (kept in `dtype`). A
    quantized bank is quantized one expert at a time on `device` (its scales
    are per expert)."""
    router = DenseLinear(_transposed(src(f"{pfx}.{fam['moe_router']}.weight"), dtype, device))
    gus, dns = [], []
    for j in range(cfg.num_experts):
        ex = f"{pfx}.{fam['moe_expert'].format(j=j)}"
        gu = torch.cat([src(f"{ex}.w1.weight").to(device),
                        src(f"{ex}.w3.weight").to(device)]).T  # [H, 2I]
        dn = src(f"{ex}.w2.weight").to(device).T  # [I, H]
        if quantize:
            gu, dn = _quantize(gu, bits), _quantize(dn, bits)
        else:
            gu, dn = gu.to(dtype), dn.to(dtype)
        gus.append(gu)
        dns.append(dn)

    def bank(parts):
        if quantize:
            return QuantLinear(pack_weights(torch.stack([q for q, _ in parts]), bits=bits),
                               torch.stack([s for _, s in parts]))
        return DenseLinear(torch.stack(parts))

    return MoEMLP(router, bank(gus), bank(dns))


def _build_params(src: _TensorSource, cfg: ModelConfig, quantize: bool, bits: int = 8,
                  dtype=torch.bfloat16, device=None) -> ModelParams:
    fam = _family(cfg.model_type)
    device = resolve(device)

    def cat_wb(names):
        """Stack (concat rows of) one or more [out, in] projections, on
        `device`; returns (weight, bias|None). A single name = pre-fused
        (baichuan W_pack / chatglm query_key_value & dense_h_to_4h)."""
        w = torch.cat([src(f"{n}.weight").to(device) for n in names])
        bias = None
        if f"{names[0]}.bias" in src:
            bias = torch.cat([src(f"{n}.bias").to(device) for n in names])
        return w, bias

    def opt_bias(name):  # attention_bias=True also puts one on o_proj
        return src(name) if name in src else None

    def norm(name):
        return src(name).to(device=device, dtype=torch.float32)

    layers = []
    for i in range(cfg.num_layers):
        pfx = fam["layer"].format(i=i)
        attn = f"{pfx}.{fam['attn']}"
        qkv_t, qkv_bias = cat_wb([f"{attn}.{p}" for p in fam["qkv"]])
        qkv = _to_linear(qkv_t, quantize, bits, dtype, device, bias=qkv_bias)
        del qkv_t
        o_name = f"{attn}.{fam['o']}"
        o_proj = _to_linear(src(f"{o_name}.weight"), quantize, bits, dtype, device,
                            bias=opt_bias(f"{o_name}.bias"))
        if cfg.num_experts:
            mlp = dict(moe=_to_moe(src, pfx, fam, cfg, quantize, bits, dtype, device))
        else:
            gateup_t, gu_bias = cat_wb([f"{pfx}.{p}" for p in fam["gateup"]])
            down_name = f"{pfx}.{fam['down']}"
            mlp = dict(
                gateup=_to_linear(gateup_t, quantize, bits, dtype, device, bias=gu_bias),
                down=_to_linear(src(f"{down_name}.weight"), quantize, bits, dtype, device,
                                bias=opt_bias(f"{down_name}.bias")))
            del gateup_t
        layers.append(LayerParams(norm(f"{pfx}.input_layernorm.weight"), qkv, o_proj,
                                  norm(f"{pfx}.post_attention_layernorm.weight"), **mlp))
        log.debug("loaded layer %d/%d", i + 1, cfg.num_layers)
    embed = src(fam["embed"]).to(device=device, dtype=dtype)  # [V, H]
    lm_head = None
    if not cfg.tie_word_embeddings and fam["lm_head"] in src:
        # the lm_head stays dense (the reference excludes it from quantization)
        lm_head = DenseLinear(_transposed(src(fam["lm_head"]), dtype, device))
    return ModelParams(embed, layers, norm(fam["final_norm"]), lm_head)


def load_config(path: str) -> tuple[ModelConfig, dict]:
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    return ModelConfig.from_hf_config(hf), hf


def load_hf_dense(path: str, dtype=torch.bfloat16,
                  device: torch.device | str | None = None) -> tuple[ModelConfig, ModelParams]:
    """An fp16 HF checkpoint directory as dense params in `dtype`, on the
    card unless `device` says otherwise."""
    cfg, _ = load_config(path)
    src = _source_from_dir(path)
    return cfg, _build_params(src, cfg, quantize=False, dtype=dtype, device=device)


def convert_torch_model(model, quantize: bool = True, bits: int = 8, dtype=torch.bfloat16,
                        device: torch.device | str | None = None
                        ) -> tuple[ModelConfig, ModelParams]:
    """A live HF PyTorch *ForCausalLM as the port's params on `device` (the
    card when None), quantized one projection at a time from its f32 values."""
    cfg = ModelConfig.from_hf_config(model.config.to_dict())
    src = _source_from_torch(model)
    return cfg, _build_params(src, cfg, quantize=quantize, bits=bits, dtype=dtype,
                              device=device)


# ---- quantized checkpoint save/load (transformers-eetq format) ----


def _unfuse_layer(lp: LayerParams, cfg: ModelConfig) -> dict[str, tuple[QuantLinear, slice]]:
    """The HF projections of a layer's fused qkv and gate|up, each as (the
    fused QuantLinear, its columns): `split_quant_columns` without the
    copies (slicing along N is bit-exact). Keys are the HF projection names;
    MoE layers give their attention projections only (the expert banks are
    `save_quantized`'s put_moe)."""
    fam = _family(cfg.model_type)
    d = {}

    def split(names, ql, sizes):
        start = 0
        for name, n in zip(names, sizes):
            d[name] = (ql, slice(start, start + n))
            start += n

    attn = fam["attn"]
    if len(fam["qkv"]) == 3:
        nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        split([f"{attn}.{p}" for p in fam["qkv"]], lp.qkv, [nq, nkv, nkv])
    else:  # pre-fused in the HF layout (W_pack / query_key_value)
        d[f"{attn}.{fam['qkv'][0]}"] = (lp.qkv, slice(None))
    d[f"{attn}.{fam['o']}"] = (lp.o_proj, slice(None))
    if lp.moe is not None:
        return d
    if len(fam["gateup"]) == 2:
        split(fam["gateup"], lp.gateup, [cfg.intermediate_size] * 2)
    else:  # chatglm dense_h_to_4h stays fused (rows gate|up)
        d[fam["gateup"][0]] = (lp.gateup, slice(None))
    d[fam["down"]] = (lp.down, slice(None))
    return d


def _f16(t: torch.Tensor) -> Pending:
    """t as fp16, made when the writer reaches it."""
    return Pending(torch.float16, tuple(t.shape), lambda: t.to(torch.float16))


def _f16_t(w: torch.Tensor) -> Pending:
    """A [K, N] weight as the fp16 [N, K] of the HF layout."""
    return Pending(torch.float16, tuple(w.shape[::-1]), lambda: w.to(torch.float16).T)


def _config_json(cfg: ModelConfig, hf_config: dict | None, quant_cfg: dict) -> dict:
    """config.json: the caller's HF dict, completed with cfg's values under
    the family's key names (chatglm's own, so that the round trip through
    `from_hf_config`'s chatglm branch gives back the same cfg), and the
    quantization_config."""
    hf = dict(hf_config or {})
    hf.setdefault("model_type", cfg.model_type)
    if cfg.model_type == "chatglm":
        keys = dict(
            padded_vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            ffn_hidden_size=cfg.intermediate_size, num_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads,
            multi_query_attention=cfg.num_kv_heads != cfg.num_heads,
            multi_query_group_num=cfg.num_kv_heads, kv_channels=cfg.head_dim,
            seq_length=cfg.max_position, rope_ratio=cfg.rope_theta / 10000.0,
            layernorm_epsilon=cfg.rms_eps, add_qkv_bias=cfg.qkv_bias,
            tie_word_embeddings=cfg.tie_word_embeddings)
    else:
        keys = dict(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, max_position_embeddings=cfg.max_position,
            rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps, hidden_act=cfg.activation,
            tie_word_embeddings=cfg.tie_word_embeddings)
        if cfg.sliding_window:
            keys["sliding_window"] = cfg.sliding_window
        if cfg.num_experts:
            keys.update(num_local_experts=cfg.num_experts,
                        num_experts_per_tok=cfg.num_experts_per_tok)
    for key, value in keys.items():
        hf.setdefault(key, value)
    hf["quantization_config"] = quant_cfg
    return hf


def save_quantized(
    params: ModelParams,
    cfg: ModelConfig,
    save_dir: str,
    hf_config: dict | None = None,
    max_shard_bytes: int = 4 * 1024**3,
    tp: int = 1,
) -> None:
    """Write an HF-format quantized checkpoint: config.json with its
    quantization_config, quant_config.json, and safetensors of UNPACKED int8
    weights [out, in] with fp16 scales, norms, biases, embedding and router,
    split into shards of at most `max_shard_bytes` with an index. Group-wise
    scales [G, out] are stored concatenated to [G*out]. `tp` is recorded in
    quantization_config. Each tensor is made on the params' device when the
    writer reaches it, so the host holds one tensor at a time."""
    os.makedirs(save_dir, exist_ok=True)
    tensors: dict[str, Pending] = {}
    fam = _family(cfg.model_type)

    def put_quant(name: str, ql: QuantLinear, cols: slice = slice(None)):
        n = len(range(ql.n)[cols])
        groups = ql.scales.shape[0] if ql.scales.dim() == 2 else 1
        tensors[f"{name}.weight"] = Pending(
            torch.int8, (n, ql.k), lambda: unpack_weights(ql.packed)[:, cols].T)
        tensors[f"{name}.weight_scales"] = Pending(
            torch.float16, (groups * n,),
            lambda: ql.scales[..., cols].to(torch.float16).reshape(-1))
        if ql.bias is not None:
            tensors[f"{name}.bias"] = _f16(ql.bias[cols])

    def put_moe(pfx: str, moe: MoEMLP) -> None:
        """Per-expert w1/w3/w2 int8 [out, in] + scales (HF mixtral names),
        the router as fp16: the portable unpacked form of the 3-D banks."""
        tensors[f"{pfx}.{fam['moe_router']}.weight"] = _f16_t(moe.router.weight)
        isz = moe.gateup.n // 2

        def expert(bank: QuantLinear, j: int, cols: slice, name: str):
            one = PackedWeight(bank.qweight[j], bank.k, bank.n, bank.bits)
            n = len(range(bank.n)[cols])
            groups = bank.scales.shape[1] if bank.scales.dim() == 3 else 1
            tensors[f"{name}.weight"] = Pending(
                torch.int8, (n, bank.k), lambda: unpack_weights(one)[:, cols].T)
            tensors[f"{name}.weight_scales"] = Pending(
                torch.float16, (groups * n,),
                lambda: bank.scales[j, ..., cols].to(torch.float16).reshape(-1))

        for j in range(moe.num_experts):
            ex = f"{pfx}.{fam['moe_expert'].format(j=j)}"
            expert(moe.gateup, j, slice(None, isz), f"{ex}.w1")
            expert(moe.gateup, j, slice(isz, None), f"{ex}.w3")
            expert(moe.down, j, slice(None), f"{ex}.w2")

    for i, lp in enumerate(params.layers):
        pfx = fam["layer"].format(i=i)
        for proj, (ql, cols) in _unfuse_layer(lp, cfg).items():
            put_quant(f"{pfx}.{proj}", ql, cols)
        if lp.moe is not None:
            put_moe(pfx, lp.moe)
        tensors[f"{pfx}.input_layernorm.weight"] = _f16(lp.input_norm)
        tensors[f"{pfx}.post_attention_layernorm.weight"] = _f16(lp.post_norm)
    tensors[fam["embed"]] = _f16(params.embed)
    tensors[fam["final_norm"]] = _f16(params.final_norm)
    if params.lm_head is not None:
        if isinstance(params.lm_head, QuantLinear):  # quantize_lm_head=True
            put_quant(fam["lm_head"][: -len(".weight")], params.lm_head)
        else:
            tensors[fam["lm_head"]] = _f16_t(params.lm_head.weight)

    # shard by size with an index, like save_torch_state_dict
    shards: list[dict] = [{}]
    sizes = [0]
    for name, entry in tensors.items():
        if sizes[-1] + entry.nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = entry
        sizes[-1] += entry.nbytes
    if len(shards) == 1:
        save_file(shards[0], os.path.join(save_dir, "model.safetensors"))
    else:
        weight_map = {}
        for j, shard in enumerate(shards):
            fn = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
            save_file(shard, os.path.join(save_dir, fn))
            for n in shard:
                weight_map[n] = fn
        with open(os.path.join(save_dir, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}, f)

    bits = next((lp.qkv.bits for lp in params.layers if isinstance(lp.qkv, QuantLinear)), 8)
    quant_cfg = {"quant_method": "eetq", "zero_point": False, "bits": bits, "tp": tp}
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(_config_json(cfg, hf_config, quant_cfg), f, indent=2)
    # legacy side file, like the reference's EETQConfig (models/_config.py)
    with open(os.path.join(save_dir, "quant_config.json"), "w") as f:
        json.dump(quant_cfg, f, indent=2)
    log.info("saved quantized checkpoint to %s (%d shards)", save_dir, len(shards))


def load_quantized(path: str, dtype=torch.bfloat16,
                   device: torch.device | str | None = None) -> tuple[ModelConfig, ModelParams]:
    """Load a quantized checkpoint saved by `save_quantized` (either
    package's, or transformers' with quant_method="eetq") onto the card
    unless `device` says otherwise. Each [out, in] int8 weight and its
    scales move to the device as read, and are transposed, fused and packed
    there."""
    device = resolve(device)
    cfg, hf = load_config(path)
    qc = hf.get("quantization_config")
    if not qc or qc.get("quant_method") != "eetq":
        raise ValueError(f"{path} is not an eetq quantized checkpoint: {qc}")
    bits = int(qc.get("bits", 8))
    src = _source_from_dir(path)
    fam = _family(cfg.model_type)

    def raw(name: str):
        """(int8 [in, out], f32 scales [out] or [G, out]) on the device."""
        q = src(f"{name}.weight").to(device)  # [out, in] int8
        s = src(f"{name}.weight_scales").reshape(-1).to(device=device, dtype=torch.float32)
        if s.numel() != q.shape[0]:  # group-wise rows stored concatenated
            s = s.reshape(-1, q.shape[0])
        return q.T, s

    def get_quant(names: list[str]) -> QuantLinear:
        """One projection, or several fused along N (HF q|k|v, gate|up)."""
        parts = [raw(n) for n in names]
        bias = None
        if any(f"{n}.bias" in src for n in names):
            bias = torch.cat([
                src(f"{n}.bias").to(device=device, dtype=dtype) if f"{n}.bias" in src
                else torch.zeros(q.shape[1], dtype=dtype, device=device)
                for n, (q, _) in zip(names, parts)])
        return QuantLinear(pack_weights(torch.cat([q for q, _ in parts], dim=-1), bits=bits),
                           torch.cat([s for _, s in parts], dim=-1), bias)

    def get_moe(pfx: str) -> MoEMLP:
        """The stacked 3-D expert banks from per-expert w1/w3/w2 (the inverse
        of save_quantized's put_moe)."""
        router = DenseLinear(_transposed(src(f"{pfx}.{fam['moe_router']}.weight"), dtype, device))
        gus, dns = [], []
        for j in range(cfg.num_experts):
            ex = f"{pfx}.{fam['moe_expert'].format(j=j)}"
            (w1, s1), (w3, s3) = raw(f"{ex}.w1"), raw(f"{ex}.w3")
            gus.append((torch.cat([w1, w3], dim=-1), torch.cat([s1, s3], dim=-1)))  # [H, 2I]
            dns.append(raw(f"{ex}.w2"))

        def bank(parts):
            return QuantLinear(pack_weights(torch.stack([q for q, _ in parts]), bits=bits),
                               torch.stack([s for _, s in parts]))

        return MoEMLP(router, bank(gus), bank(dns))

    def norm(name):
        return src(name).to(device=device, dtype=torch.float32)

    layers = []
    for i in range(cfg.num_layers):
        pfx = fam["layer"].format(i=i)
        attn = f"{pfx}.{fam['attn']}"
        qkv = get_quant([f"{attn}.{p}" for p in fam["qkv"]])
        if cfg.num_experts:
            mlp = dict(moe=get_moe(pfx))
        else:
            mlp = dict(gateup=get_quant([f"{pfx}.{p}" for p in fam["gateup"]]),
                       down=get_quant([f"{pfx}.{fam['down']}"]))
        layers.append(LayerParams(norm(f"{pfx}.input_layernorm.weight"), qkv,
                                  get_quant([f"{attn}.{fam['o']}"]),
                                  norm(f"{pfx}.post_attention_layernorm.weight"), **mlp))
    lm_head = None
    head_name = fam["lm_head"][: -len(".weight")]
    if not cfg.tie_word_embeddings and fam["lm_head"] in src:
        if f"{head_name}.weight_scales" in src:  # saved with quantize_lm_head
            lm_head = get_quant([head_name])
        else:
            lm_head = DenseLinear(_transposed(src(fam["lm_head"]), dtype, device))
    embed = src(fam["embed"]).to(device=device, dtype=dtype)
    return cfg, ModelParams(embed, layers, norm(fam["final_norm"]), lm_head)
