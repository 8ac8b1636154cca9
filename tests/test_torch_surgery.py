"""Surgery and live-model conversion against the JAX package on the CPU, at
toy size.

- `fuse_columns`, `fuse_qkv`, `fuse_gateup` and `split_quant_columns` (int8
  and int4, per-channel and g = 64/128, with and without a bias) bit-equal
  to JAX's.
- `eet_quantize` with the default exclusion (the lm_head), none, path
  regexes (`\\.layers\\[1\\]\\.o_proj`, `down`: the same layers stay dense in
  both packages), int4 group-wise, a qkv bias, a tied head and MoE layers
  (banks quantized whatever `exclude` says, the router dense): bit-equal to
  JAX's. `eet_accelerator` on params.
- `convert_torch_model`, `AutoEETQForCausalLM.from_torch` and
  `eet_accelerator` on tiny `transformers` llama and mixtral models
  (quantized from their f32 weights, and dense), bit-equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu import surgery as jax_surgery
from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.models import ModelConfig as JaxModelConfig
from eetq_tpu.models import hf as jax_hf
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.auto import AutoEETQForCausalLM as JaxAuto
from eetq_tpu.modules.linear import quantize_linear as jax_quantize_linear
from eetq_tpu_torch import surgery
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.models import hf
from eetq_tpu_torch.models.auto import AutoEETQForCausalLM
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear
from test_torch_checkpoint import MODELS, assert_linear_equal, assert_params_equal
from test_torch_model import jax_params_to_numpy


def _both(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def test_fusion_matches_jax():
    rng = np.random.default_rng(0)
    parts = [rng.standard_normal((64, n)).astype(np.float32) for n in (96, 32, 32, 40)]
    j, t = zip(*(_both(a) for a in parts))
    for fn in ("fuse_qkv", "fuse_gateup", "fuse_columns"):
        args = {"fuse_qkv": (j[:3], t[:3]), "fuse_gateup": (j[:2], t[:2]),
                "fuse_columns": ((list(j),), (list(t),))}[fn]
        want = getattr(jax_surgery, fn)(*args[0])
        got = getattr(surgery, fn)(*args[1])
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    with pytest.raises(ValueError):
        surgery.fuse_columns([t[0], t[0][:32]])
    with pytest.raises(ValueError):
        jax_surgery.fuse_columns([j[0], j[0][:32]])


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("group", [None, 64, 128], ids=["per-channel", "g64", "g128"])
@pytest.mark.parametrize("bits", [8, 4])
def test_split_quant_columns_matches_jax(bits, group, bias):
    """A fused [256, 100 | 60 | 96] linear, quantized by JAX and carried
    across unpacked, split along N by each package."""
    rng = np.random.default_rng(bits + (group or 0))
    sizes = [100, 60, 96]
    w = rng.standard_normal((256, sum(sizes))).astype(np.float32) * 0.05
    b = _both(rng.standard_normal(sum(sizes)).astype(np.float32)) if bias else (None, None)
    jq = jax_quantize_linear(jnp.asarray(w), bias=b[0], bits=bits, group_size=group)
    tq = QuantLinear(pack_weights(torch.from_numpy(np.array(jax_unpack(jq.qweight))), bits=bits),
                     torch.from_numpy(np.array(jq.scales)), b[1])
    for k, (jp, tp) in enumerate(zip(jax_surgery.split_quant_columns(jq, sizes),
                                     surgery.split_quant_columns(tq, sizes))):
        assert tp.k == 256 and tp.n == sizes[k]
        assert_linear_equal(jp, tp, f"part {k}")
    with pytest.raises(ValueError, match="out_features"):
        surgery.split_quant_columns(tq, [100, 60])


# (model, bits, group_size, exclude)
QUANTIZE_CASES = {
    "llama-default": ("llama", 8, None, ("lm_head",)),
    "llama-everything": ("llama", 8, None, ()),
    "llama-exclude-paths": ("llama", 8, None, (r"\.layers\[1\]\.o_proj", r"down")),
    "llama-int4-g64": ("llama", 4, 64, ("lm_head",)),
    "qwen2-bias-int4-g128": ("qwen2", 4, 128, ()),
    "gemma-tied": ("gemma", 8, None, ("lm_head",)),
    "mixtral-default": ("mixtral", 8, None, ("lm_head",)),
    "mixtral-int4-g64-exclude-moe": ("mixtral", 4, 64, ("moe", "qkv")),
}


@pytest.fixture(scope="module")
def dense_models():
    """model -> (JAX's dense params, the port's copy of them)."""
    cache = {}

    def get(model):
        if model not in cache:
            jp = jax_random_dense_params(JaxModelConfig(**MODELS[model]),
                                         jax.random.PRNGKey(len(cache)))
            cache[model] = jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")
        return cache[model]

    return get


@pytest.mark.parametrize("case", QUANTIZE_CASES)
def test_eet_quantize_matches_jax(dense_models, case):
    model, bits, group, exclude = QUANTIZE_CASES[case]
    jd, td = dense_models(model)
    want = jax_surgery.eet_quantize(jd, bits=bits, group_size=group, exclude=exclude)
    got = surgery.eet_quantize(td, bits=bits, group_size=group, exclude=exclude)
    assert_params_equal(want, got)
    if case == "llama-exclude-paths":
        dense = [(i, name) for i, lp in enumerate(got.layers)
                 for name in ("qkv", "o_proj", "gateup", "down")
                 if isinstance(getattr(lp, name), DenseLinear)]
        assert dense == [(0, "down"), (1, "o_proj"), (1, "down")]
        assert isinstance(got.lm_head, QuantLinear)
    if model == "mixtral":
        assert all(isinstance(lp.moe.gateup, QuantLinear) and isinstance(lp.moe.router, DenseLinear)
                   for lp in got.layers)
    # the source stays dense; quantizing again changes nothing
    assert isinstance(td.layers[0].qkv, DenseLinear)
    again = surgery.eet_quantize(got, bits=bits, group_size=group, exclude=exclude)
    assert all(a is b for a, b in zip(again.modules(), got.modules()) if isinstance(a, QuantLinear))


def test_eet_accelerator_on_params(dense_models):
    _, td = dense_models("llama")
    assert surgery.eet_accelerator(td, quantize=False) is td
    assert_params_equal(jax_surgery.eet_quantize(dense_models("llama")[0]),
                        surgery.eet_accelerator(td))


# ---- live HuggingFace torch models ----


@pytest.fixture(scope="module")
def torch_models():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5)).eval()
    mixtral = transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        num_local_experts=4, num_experts_per_tok=2)).eval()
    return {"llama": llama, "mixtral": mixtral}


@pytest.mark.parametrize("quantize", [True, False], ids=["quantized", "dense"])
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_convert_torch_model_matches_jax(torch_models, family, quantize):
    jcfg, jp = jax_hf.convert_torch_model(torch_models[family], quantize=quantize)
    cfg, tp = hf.convert_torch_model(torch_models[family], quantize=quantize, device="cpu")
    assert cfg.__dict__ == jcfg.__dict__
    assert_params_equal(jp, tp)


def test_from_torch_and_eet_accelerator_match_jax(torch_models):
    model = torch_models["llama"]
    want = JaxAuto.from_torch(model)
    got = AutoEETQForCausalLM.from_torch(model, device="cpu")
    assert got.quantized and got.hf_config == want.hf_config
    assert_params_equal(want.params, got.params)
    jcfg, jp = jax_surgery.eet_accelerator(model, quantize=True, fused_attn=True)
    cfg, tp = surgery.eet_accelerator(model, quantize=True, fused_attn=True, dev="cpu")
    assert cfg.__dict__ == jcfg.__dict__
    assert_params_equal(jp, tp)
