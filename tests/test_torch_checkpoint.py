"""Checkpoints between the port and the JAX package on the CPU, at toy size.

- `ModelConfig.from_hf_config` equal to JAX's on every preset's HF dict and
  on the key variants the parser handles.
- The quantized round trip in both directions, for all 7 model_types
  (llama, mistral, baichuan with ALiBi, qwen2 at group 7, chatglm at group
  16, gemma with a tied head, mixtral), at int8 per-channel (int8 lm_head),
  int4 g = 64 (int4 lm_head) and int4 g = 128 (dense lm_head), with random
  norms and qkv biases: the port's `save_quantized` -> JAX's
  `load_quantized`, equal to the port's own reading (unpacked values,
  scales, biases, norms, embedding, router) and to the port's params as
  fp16 stores them; JAX's `save_quantized` of those params -> the port's
  `load_quantized`, equal to them; and the two packages' files of the same
  params equal (names, dtypes, shapes, values, the index and the shard
  split, config.json, quant_config.json). The format stores scales, norms,
  biases, the embedding and the router in fp16, so a round trip is held
  against JAX's round trip of the same params, not against the params.
- `load_hf_dense` and `from_pretrained(quantize=True)` over an fp16
  directory written by `safetensors.numpy.save_file`, bit-equal to JAX's.
- `EETQCausalLM.generate`'s greedy tokens equal JAX's on a loaded model.
- A BF16 checkpoint, which JAX's loader reads (importing JAX teaches numpy
  ml_dtypes' bfloat16), loads bit-equal to JAX's, dense and quantized.
- The refusals: a plain checkpoint, an unsupported model_type, `tp > 1`
  with a group size, an F8 tensor, a hub id, and `device=None`
  without a card.
- `models/safetensors_io.py` against the `safetensors` library: files the
  library wrote (numpy and torch) read equal, files the port wrote load in
  the library equal, 64-bit offsets past 4 GiB, a misaligned tensor.
"""

import dataclasses
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.models import ModelConfig as JaxModelConfig
from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import hf as jax_hf
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.auto import AutoEETQForCausalLM as JaxAuto
from eetq_tpu.modules.linear import QuantLinear as JaxQuantLinear
from eetq_tpu_torch.dist.sharding import ShardedModel, make_mesh
from eetq_tpu_torch.layout.tiling import unpack_weights
from eetq_tpu_torch.models import hf
from eetq_tpu_torch.models import safetensors_io as sio
from eetq_tpu_torch.models.auto import AutoEETQForCausalLM, resolve_checkpoint
from eetq_tpu_torch.models.config import PRESETS, ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import random_quantized_params
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear
from test_torch_families import BASE, FAMILIES
from test_torch_head256 import GEMMA
from test_torch_model import jax_params_to_numpy

# the seven model_types at toy size; qwen2 (group 7) and baichuan (ALiBi over
# 5 heads) at head dim 128, so that every K divides by 64 and 128
MODELS = {
    "llama": dataclasses.asdict(JAX_PRESETS["toy"]),
    "mistral": {**BASE, **FAMILIES["window"]},
    "baichuan": {**BASE, **FAMILIES["alibi"], "head_dim": 128},
    "qwen2": {**BASE, **FAMILIES["group7"], "head_dim": 128},
    "chatglm": {**BASE, **FAMILIES["group16"]},
    "gemma": GEMMA,
    "mixtral": dataclasses.asdict(JAX_PRESETS["toy-moe"]),
}
# (bits, group_size, quantize_lm_head)
MODES = {"int8": (8, None, True), "int4-g64": (4, 64, True), "int4-g128": (4, 128, False)}
SHARD_BYTES = 96 * 1024  # 3 or more shards for every toy
CASES = [(m, q) for m in MODELS for q in MODES]
IDS = [f"{m}-{q}" for m, q in CASES]


def hf_dict(cfg: dict) -> dict:
    """A HuggingFace config.json dict for a config's fields, in the
    family's own key names."""
    c = ModelConfig(**cfg)
    if c.model_type == "chatglm":
        return dict(model_type="chatglm", padded_vocab_size=c.vocab_size,
                    hidden_size=c.hidden_size, ffn_hidden_size=c.intermediate_size,
                    num_layers=c.num_layers, num_attention_heads=c.num_heads,
                    multi_query_attention=c.num_kv_heads != c.num_heads,
                    multi_query_group_num=c.num_kv_heads, kv_channels=c.head_dim,
                    seq_length=c.max_position, rope_ratio=c.rope_theta / 1e4,
                    layernorm_epsilon=c.rms_eps, add_qkv_bias=c.qkv_bias)
    d = dict(model_type=c.model_type, vocab_size=c.vocab_size, hidden_size=c.hidden_size,
             intermediate_size=c.intermediate_size, num_hidden_layers=c.num_layers,
             num_attention_heads=c.num_heads, num_key_value_heads=c.num_kv_heads,
             head_dim=c.head_dim, max_position_embeddings=c.max_position,
             rope_theta=c.rope_theta, rms_norm_eps=c.rms_eps,
             hidden_act="gelu_pytorch_tanh" if c.activation == "gelu" else c.activation,
             tie_word_embeddings=c.tie_word_embeddings)
    if c.sliding_window:
        d["sliding_window"] = c.sliding_window
    if c.alibi:
        d["alibi"] = True
    if c.num_experts:
        d.update(num_local_experts=c.num_experts, num_experts_per_tok=c.num_experts_per_tok)
    return d


HF_VARIANTS = {
    "gemma-tie-absent": {k: v for k, v in hf_dict(GEMMA).items() if k != "tie_word_embeddings"},
    "llama-defaults": dict(model_type="llama", vocab_size=64, hidden_size=64,
                           intermediate_size=96, num_hidden_layers=1, num_attention_heads=4),
    "llama-attention-bias": dict(hf_dict(MODELS["llama"]), attention_bias=True),
    "baichuan2-position-embedding": dict(
        {k: v for k, v in hf_dict(MODELS["baichuan"]).items() if k != "alibi"},
        position_embedding="ALIBI"),
    "baichuan-40-heads": dict(model_type="baichuan", vocab_size=64, hidden_size=5120,
                              intermediate_size=64, num_hidden_layers=1, num_attention_heads=40),
    "chatglm-mha": {k: v for k, v in hf_dict(MODELS["chatglm"]).items()
                    if k != "multi_query_attention"},
    "chatglm2-vocab": dict({k: v for k, v in hf_dict(MODELS["chatglm"]).items()
                            if k != "padded_vocab_size"}, vocab_size=300, rope_ratio=50.0),
    "gelu-new": dict(hf_dict(MODELS["llama"]), hidden_act="gelu_new"),
}


@pytest.mark.parametrize("hf_config", [hf_dict(dataclasses.asdict(c)) for c in PRESETS.values()]
                         + list(HF_VARIANTS.values()),
                         ids=list(PRESETS) + list(HF_VARIANTS))
def test_from_hf_config_matches_jax(hf_config):
    got = ModelConfig.from_hf_config(hf_config)
    assert dataclasses.asdict(got) == dataclasses.asdict(JaxModelConfig.from_hf_config(hf_config))


# ---- the quantized round trip between the packages ----


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)) if jnp.issubdtype(x.dtype, jnp.floating) \
        else np.asarray(x)


def assert_linear_equal(j, t, what: str):
    if j is None or t is None:
        assert j is None and t is None, what
        return
    if isinstance(j, JaxQuantLinear):
        assert isinstance(t, QuantLinear) and t.bits == j.qweight.bits, what
        np.testing.assert_array_equal(unpack_weights(t.packed).numpy(),
                                      np.asarray(jax_unpack(j.qweight)), err_msg=what)
        np.testing.assert_array_equal(_np(t.scales), _np(j.scales), err_msg=what)
        assert t.scales.dtype == torch.float32, what
    else:
        assert isinstance(t, DenseLinear), what
        np.testing.assert_array_equal(_np(t.weight), _np(j.weight), err_msg=what)
        assert t.weight.dtype == torch.bfloat16, what
    assert (j.bias is None) == (t.bias is None), what
    if j.bias is not None:
        np.testing.assert_array_equal(_np(t.bias), _np(j.bias), err_msg=what)


def assert_params_equal(jp, tp):
    """The port's params equal to JAX's, bit for bit (int4 compared unpacked)."""
    np.testing.assert_array_equal(_np(tp.embed), _np(jp.embed))
    assert tp.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tp.final_norm), _np(jp.final_norm))
    assert len(tp.layers) == len(jp.layers)
    for i, (lj, lt) in enumerate(zip(jp.layers, tp.layers)):
        for name in ("input_norm", "post_norm"):
            np.testing.assert_array_equal(_np(getattr(lt, name)), _np(getattr(lj, name)))
        for name in ("qkv", "o_proj", "gateup", "down"):
            assert_linear_equal(getattr(lj, name), getattr(lt, name), f"layer {i} {name}")
        assert (lj.moe is None) == (lt.moe is None)
        if lj.moe is not None:
            for name in ("router", "gateup", "down"):
                assert_linear_equal(getattr(lj.moe, name), getattr(lt.moe, name),
                                    f"layer {i} moe.{name}")
    assert_linear_equal(jp.lm_head, tp.lm_head, "lm_head")


def _random_norms(params, gen: torch.Generator) -> None:
    """Norms drawn around 1 (f32), so that their fp16 storage rounds."""
    for t in [params.final_norm] + [getattr(lp, n) for lp in params.layers
                                    for n in ("input_norm", "post_norm")]:
        t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen))


def assert_as_stored(src, got):
    """Every tensor of `got` equal to `src`'s: int8 as it is, the rest as
    the checkpoint's fp16 holds it. Group-wise scales of one group (g = K)
    are stored as [out], as per-channel ones are, and load per channel (in
    JAX too): the same products."""
    have = dict(got.named_buffers())
    assert have.keys() == dict(src.named_buffers()).keys()
    for name, t in src.named_buffers():
        want = t if t.dtype == torch.int8 else t.to(torch.float16).to(t.dtype)
        if name.endswith("scales") and have[name].dim() < t.dim():
            want = want.squeeze(-2)
        assert have[name].dtype == t.dtype and torch.equal(have[name], want), name


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(model, mode) -> the port's params, the directory the port saved them
    to, JAX's load of it (JAX's params: the same, as stored), and the
    directory JAX saved those to; made once per case."""
    cache = {}

    def get(model: str, mode: str):
        if (model, mode) not in cache:
            bits, group, head = MODES[mode]
            cfg = ModelConfig(**MODELS[model])
            gen = torch.Generator().manual_seed(len(cache))
            tp = random_quantized_params(cfg, gen, quantize_lm_head=head, bits=bits,
                                         group_size=group)
            _random_norms(tp, gen)
            root = tmp_path_factory.mktemp(f"{model}-{mode}")
            tdir, jdir = str(root / "port"), str(root / "jax")
            hf.save_quantized(tp, cfg, tdir, max_shard_bytes=SHARD_BYTES)
            jcfg, jp = jax_hf.load_quantized(tdir)
            jax_hf.save_quantized(jp, JaxModelConfig(**MODELS[model]), jdir,
                                  max_shard_bytes=SHARD_BYTES)
            cache[model, mode] = (tp, tdir, jcfg, jp, jdir)
        return cache[model, mode]

    return get


@pytest.mark.parametrize("model,mode", CASES, ids=IDS)
def test_jax_checkpoint_loads_in_the_port(saved, model, mode):
    """JAX's file read by the port equals JAX's params (rounding to fp16 is
    idempotent, so they are also JAX's round trip of them)."""
    _, _, jcfg, jp, jdir = saved(model, mode)
    cfg, loaded = hf.load_quantized(jdir, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_params_equal(jp, loaded)


@pytest.mark.parametrize("model,mode", CASES, ids=IDS)
def test_port_checkpoint_loads_in_jax(saved, model, mode):
    """The port's file read by JAX equals the port's own reading of it, and
    that is the port's params as fp16 stores them."""
    tp, tdir, jcfg, jp, _ = saved(model, mode)
    cfg, loaded = hf.load_quantized(tdir, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_params_equal(jp, loaded)
    assert_as_stored(tp, loaded)


def _safetensors(path: str) -> dict:
    from safetensors import safe_open

    with safe_open(path, framework="numpy") as h:
        return {name: h.get_tensor(name) for name in h.keys()}


@pytest.mark.parametrize("model,mode", CASES, ids=IDS)
def test_saved_files_match_jax(saved, model, mode):
    """The same files: shards, index, every tensor's dtype, shape and bytes,
    config.json and quant_config.json."""
    pytest.importorskip("safetensors")
    _, tdir, _, _, jdir = saved(model, mode)
    files = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == files
    shards = [f for f in files if f.endswith(".safetensors")]
    assert len(shards) >= 3 and "model.safetensors.index.json" in files
    for name in ("model.safetensors.index.json", "config.json", "quant_config.json"):
        with open(os.path.join(jdir, name)) as a, open(os.path.join(tdir, name)) as b:
            assert json.load(b) == json.load(a), name
    for f in shards:
        want, got = _safetensors(os.path.join(jdir, f)), _safetensors(os.path.join(tdir, f))
        assert sorted(got) == sorted(want), f
        for name, a in want.items():
            assert got[name].dtype == a.dtype and got[name].shape == a.shape, name
            np.testing.assert_array_equal(got[name], a, err_msg=name)


# ---- fp16 HF checkpoints, dense import ----


def _hf_dense_tensors(cfg: ModelConfig, rng) -> dict:
    """An fp16 HF-layout state dict of cfg's shapes ([out, in] weights)."""
    fam = jax_hf._family(cfg.model_type)
    h, i, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(np.float16)

    out = {}
    for layer in range(cfg.num_layers):
        pfx = fam["layer"].format(i=layer)
        attn = f"{pfx}.{fam['attn']}"
        if len(fam["qkv"]) == 3:
            sizes = dict(zip(fam["qkv"], (nq, nkv, nkv)))
        else:
            sizes = {fam["qkv"][0]: nq + 2 * nkv}
        for name, n in sizes.items():
            out[f"{attn}.{name}.weight"] = w(n, h)
            if cfg.qkv_bias:
                out[f"{attn}.{name}.bias"] = w(n) * 0.1
        out[f"{attn}.{fam['o']}.weight"] = w(h, nq)
        if e:
            out[f"{pfx}.{fam['moe_router']}.weight"] = w(e, h)
            for j in range(e):
                ex = f"{pfx}.{fam['moe_expert'].format(j=j)}"
                out.update({f"{ex}.w1.weight": w(i, h), f"{ex}.w3.weight": w(i, h),
                            f"{ex}.w2.weight": w(h, i)})
        else:
            rows = i if len(fam["gateup"]) == 2 else 2 * i
            for name in fam["gateup"]:
                out[f"{pfx}.{name}.weight"] = w(rows, h)
            out[f"{pfx}.{fam['down']}.weight"] = w(h, i)
        for name in ("input_layernorm", "post_attention_layernorm"):
            out[f"{pfx}.{name}.weight"] = (1 + 0.1 * rng.standard_normal(h)).astype(np.float16)
    out[fam["embed"]] = (0.02 * rng.standard_normal((cfg.vocab_size, h))).astype(np.float16)
    out[fam["final_norm"]] = (1 + 0.1 * rng.standard_normal(h)).astype(np.float16)
    if not cfg.tie_word_embeddings:
        out[fam["lm_head"]] = w(cfg.vocab_size, h)
    return out


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """model -> an fp16 HF checkpoint directory written by the safetensors
    library (two files and an index for mixtral, one file otherwise)."""
    sn = pytest.importorskip("safetensors.numpy")
    dirs = {}
    for k, (model, fields) in enumerate(MODELS.items()):
        d = tmp_path_factory.mktemp(f"hf-{model}")
        tensors = _hf_dense_tensors(ModelConfig(**fields), np.random.default_rng(k))
        if model == "mixtral":
            names = list(tensors)
            halves = {"model-00001-of-00002.safetensors": names[:len(names) // 2],
                      "model-00002-of-00002.safetensors": names[len(names) // 2:]}
            for fn, part in halves.items():
                sn.save_file({n: tensors[n] for n in part}, str(d / fn))
            index = {"metadata": {}, "weight_map": {n: fn for fn, p in halves.items() for n in p}}
            (d / "model.safetensors.index.json").write_text(json.dumps(index))
        else:
            sn.save_file(tensors, str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps(hf_dict(fields)))
        dirs[model] = str(d)
    return dirs


@pytest.mark.parametrize("model", MODELS)
def test_load_hf_dense_matches_jax(hf_dirs, model):
    jcfg, jp = jax_hf.load_hf_dense(hf_dirs[model])
    cfg, tp = hf.load_hf_dense(hf_dirs[model], device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_params_equal(jp, tp)


@pytest.mark.parametrize("model", ["llama", "mixtral", "chatglm", "qwen2"])
def test_from_pretrained_quantize_matches_jax(hf_dirs, model):
    """Rounded to bf16 first, then quantized by eet_quantize (lm_head
    dense), as JAX's from_pretrained(quantize=True) does."""
    want = JaxAuto.from_pretrained(hf_dirs[model], quantize=True)
    got = AutoEETQForCausalLM.from_pretrained(hf_dirs[model], quantize=True, device="cpu")
    assert got.quantized and got.hf_config == want.hf_config
    assert_params_equal(want.params, got.params)


# ---- generation through the auto API ----


def test_generate_from_quantized_matches_jax(tmp_path):
    """The TOY model of tests/test_torch_model.py (int8 lm_head), saved by
    JAX and loaded by each package: EETQCausalLM.generate's greedy tokens
    equal JAX's (that file's prompt, seed 1)."""
    jp = jax_quantize_params(jax_random_dense_params(JAX_PRESETS["toy"], jax.random.PRNGKey(0)),
                             quantize_lm_head=True)
    jax_hf.save_quantized(jp, JAX_PRESETS["toy"], str(tmp_path))
    prompt = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)
    want = JaxAuto.from_quantized(str(tmp_path)).generate(jnp.asarray(prompt), 8)
    model = AutoEETQForCausalLM.from_quantized(str(tmp_path), device="cpu")
    got = model.generate(torch.from_numpy(prompt).long(), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    caches = model.init_caches(2, 20, device="cpu")
    pos = torch.arange(12).expand(2, 12)
    logits, _ = model.forward(torch.from_numpy(prompt).long(), pos, caches)
    assert logits.shape == (2, 12, 256) and bool(torch.isfinite(logits).all())


# ---- refusals ----


def test_load_quantized_refuses_a_plain_checkpoint(hf_dirs):
    with pytest.raises(ValueError, match="not an eetq quantized"):
        hf.load_quantized(hf_dirs["llama"], device="cpu")
    with pytest.raises(ValueError, match="not an eetq quantized"):
        AutoEETQForCausalLM.from_quantized(hf_dirs["llama"], device="cpu")


def test_unsupported_model_type(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "gpt_bigcode", "vocab_size": 8, "hidden_size": 8,
        "intermediate_size": 8, "num_hidden_layers": 1, "num_attention_heads": 1}))
    with pytest.raises(ValueError, match="isn't supported"):
        AutoEETQForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="unsupported model_type"):
        hf._family("gpt_bigcode")


def test_tp_and_shard_are_not_ported(hf_dirs, tmp_path):
    model = AutoEETQForCausalLM.from_pretrained(hf_dirs["llama"], device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        model.save_quantized(str(tmp_path))
    with pytest.raises(ValueError, match="either tp or group_size"):
        model.quantize(tp=2, group_size=64)
    assert not model.quantized
    one = model.shard(mesh=make_mesh(device="cpu"))  # ported: a dense model, quantized per shard
    assert isinstance(one, ShardedModel) and isinstance(one.params.layers[0].qkv, QuantLinear)
    assert not model.quantized
    model.quantize(save_dir=str(tmp_path / "q"), bits=4, group_size=64, quantize_lm_head=True)
    assert model.quantized and isinstance(model.params.lm_head, QuantLinear)
    with open(tmp_path / "q" / "quant_config.json") as f:
        assert json.load(f) == {"quant_method": "eetq", "zero_point": False, "bits": 4, "tp": 1}


def test_a_bf16_checkpoint_loads_as_in_jax(tmp_path):
    """JAX's loader reads BF16 (importing JAX teaches numpy ml_dtypes'
    bfloat16), so the port's does too: dense and quantized, bit-equal."""
    st = pytest.importorskip("safetensors.torch")
    (tmp_path / "config.json").write_text(json.dumps(hf_dict(MODELS["llama"])))
    tensors = _hf_dense_tensors(ModelConfig(**MODELS["llama"]), np.random.default_rng(0))
    st.save_file({name: torch.from_numpy(a).to(torch.bfloat16) for name, a in tensors.items()},
                 str(tmp_path / "model.safetensors"))
    assert_params_equal(jax_hf.load_hf_dense(str(tmp_path))[1],
                        hf.load_hf_dense(str(tmp_path), device="cpu")[1])
    assert_params_equal(JaxAuto.from_pretrained(str(tmp_path), quantize=True).params,
                        AutoEETQForCausalLM.from_pretrained(str(tmp_path), quantize=True,
                                                            device="cpu").params)


def test_an_f8_tensor_is_refused_as_by_jax(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    (tmp_path / "config.json").write_text(json.dumps(hf_dict(MODELS["llama"])))
    tensors = _hf_dense_tensors(ModelConfig(**MODELS["llama"]), np.random.default_rng(0))
    st.save_file({name: torch.from_numpy(a).to(torch.float8_e4m3fn) for name, a in tensors.items()},
                 str(tmp_path / "model.safetensors"))
    with pytest.raises(TypeError, match="F8_E4M3"):
        hf.load_hf_dense(str(tmp_path), device="cpu")
    with pytest.raises(AttributeError, match="float8"):
        jax_hf.load_hf_dense(str(tmp_path))


def test_only_local_directories(tmp_path):
    assert resolve_checkpoint(str(tmp_path)) == str(tmp_path)
    with pytest.raises(FileNotFoundError, match="local"):
        resolve_checkpoint("org/some-model")
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        hf._source_from_dir(str(tmp_path))


def test_device_none_is_the_card(saved):
    """No fallback: without a card, an entry point given device=None fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_gpu.py holds this case")
    with pytest.raises((AssertionError, RuntimeError)):
        hf.load_quantized(saved("llama", "int8")[1])


# ---- models/safetensors_io.py against the library ----

NUMPY_ARRAYS = {
    "i8": np.arange(-6, 6, dtype=np.int8).reshape(3, 4), "u8": np.arange(5, dtype=np.uint8),
    "f16": np.linspace(-2, 2, 7).astype(np.float16), "f32": np.ones((2, 3, 4), np.float32) / 3,
    "f64": np.arange(3.0), "i16": np.arange(4, dtype=np.int16),
    "u16": np.arange(4, dtype=np.uint16),
    "i32": np.arange(4, dtype=np.int32), "u32": np.arange(4, dtype=np.uint32),
    "i64": np.arange(4, dtype=np.int64), "u64": np.arange(4, dtype=np.uint64),
    "bool": np.array([True, False, True]), "c64": np.array([1 + 2j], np.complex64),
    "scalar": np.array(2.5, np.float32), "empty": np.zeros((0, 4), np.float16),
}


def test_reader_reads_the_numpy_librarys_files(tmp_path):
    sn = pytest.importorskip("safetensors.numpy")
    sn.save_file(NUMPY_ARRAYS, str(tmp_path / "a.safetensors"), metadata={"k": "v"})
    with sio.SafetensorsFile(str(tmp_path / "a.safetensors")) as f:
        assert f.metadata == {"k": "v"} and sorted(f.keys()) == sorted(NUMPY_ARRAYS)
        for name, want in NUMPY_ARRAYS.items():
            got = f.get_tensor(name).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want)


def test_reader_reads_the_torch_librarys_files(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = {"w": torch.randn(5, 7).half(),
               "q": torch.randint(-128, 127, (3, 9), dtype=torch.int8),
               "s": torch.randn(9), "n": torch.arange(3)}
    st.save_file(tensors, str(tmp_path / "t.safetensors"))
    with sio.SafetensorsFile(str(tmp_path / "t.safetensors")) as f:
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and torch.equal(got, t), name


def test_writer_files_load_in_the_library(tmp_path):
    pytest.importorskip("safetensors")
    from safetensors import safe_open

    made = []
    q = torch.randint(-128, 127, (4, 6), dtype=torch.int8)
    entries = {"z.f32": torch.randn(2, 3), "a.f16": torch.randn(5).half(),
               "q": sio.Pending(torch.int8, (6, 4), lambda: made.append("q") or q.T),
               "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 3, dtype=torch.float16)}
    path = str(tmp_path / "w.safetensors")
    sio.save_file(entries, path)
    assert made == ["q"]
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
    assert (8 + n) % 8 == 0
    with safe_open(path, framework="numpy") as h:
        assert h.metadata() is None
        assert sorted(h.keys()) == sorted(entries)
        want = {name: (e.make() if isinstance(e, sio.Pending) else e).numpy()
                for name, e in entries.items()}
        for name, a in want.items():
            got = h.get_tensor(name)
            assert got.dtype == a.dtype and got.shape == a.shape, name
            np.testing.assert_array_equal(got, a)
    with sio.SafetensorsFile(path) as f:
        assert torch.equal(f.get_tensor("q"), q.T)


def test_writer_refuses_what_it_does_not_write(tmp_path):
    with pytest.raises(TypeError, match="writes"):
        sio.save_file({"b": torch.zeros(2, dtype=torch.bfloat16)}, str(tmp_path / "b"))
    wrong = sio.Pending(torch.int8, (2, 2), lambda: torch.zeros(2, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match="declared"):
        sio.save_file({"w": wrong}, str(tmp_path / "w"))


def test_offsets_past_4_gib():
    """A shard over 4 GiB: 64-bit offsets, exact, in the header (nothing is
    made or written)."""
    big = sio.Pending(torch.int8, (3 << 30,), lambda: None)
    head = sio.header_bytes({"a": big, "b": big, "c": sio.Pending(torch.float16, (8,), None)})
    (n,) = struct.unpack("<Q", head[:8])
    header = json.loads(head[8:8 + n])
    assert header["b"]["data_offsets"] == [3 << 30, 6 << 30]
    assert header["c"]["data_offsets"] == [6 << 30, (6 << 30) + 16]


def test_reader_copies_a_misaligned_tensor(tmp_path):
    header = json.dumps({"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
                         "b": {"dtype": "F32", "shape": [2], "data_offsets": [3, 11]}}).encode()
    header += b" " * (-(8 + len(header)) % 8)
    data = bytes([1, 2, 3]) + np.array([1.5, -2.0], np.float32).tobytes()
    (tmp_path / "m.safetensors").write_bytes(struct.pack("<Q", len(header)) + header + data)
    with sio.SafetensorsFile(str(tmp_path / "m.safetensors")) as f:
        assert f.get_tensor("a").tolist() == [1, 2, 3]
        assert f.get_tensor("b").tolist() == [1.5, -2.0]
