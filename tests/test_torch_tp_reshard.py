"""The offline tensor-parallel reshard (`surgery/tp_reshard.py`,
`dist/sharding.py`, `EETQCausalLM.quantize(tp=N)`) against the JAX package
on the CPU, on the same numpy weights: `quantize_params_tp` at tp 1, 2 and
4 gives bit-equal int8 (and int4) values and f32 scales, the split
functions give JAX's shards, the tp artifact's forward logits stay within
5e-2 of the largest of JAX's forward of its artifact, a tp = 2 checkpoint
written by either package loads in the other bit-equal, and every refusal
holds (MoE, dims tp does not divide, tp with a group size); over a mesh
of one rank, shard_quantized and shard() give the whole quantized model."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.dist import sharding as jax_sharding
from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.models import ModelConfig as JaxConfig
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.hf import load_quantized as jax_load_quantized
from eetq_tpu.models.hf import save_quantized as jax_save_quantized
from eetq_tpu.models.transformer import forward as jax_forward
from eetq_tpu.surgery import tp_reshard as jax_tp
from eetq_tpu_torch.dist import make_mesh, split_gateup_columns, split_qkv_columns, split_rows
from eetq_tpu_torch.layout.tiling import unpack_weights
from eetq_tpu_torch.models.auto import EETQCausalLM
from eetq_tpu_torch.models.config import PRESETS, ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.hf import load_quantized, save_quantized
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.models.transformer import forward_inner
from eetq_tpu_torch.modules.linear import QuantLinear
from eetq_tpu_torch.surgery import tp_reshard
from test_torch_model import jax_params_to_numpy

# tests/test_tp_reshard.py's CFG, twice as wide, so that tp = 4 divides its
# 4 kv heads (GQA 8/4)
DIMS = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=8,
            num_kv_heads=4, head_dim=16, max_position=64)
CFG, JCFG = ModelConfig(**DIMS), JaxConfig(**DIMS)
PROJ = ("qkv", "o_proj", "gateup", "down")


@pytest.fixture(scope="module")
def dense():
    """The same bf16 dense model in both packages."""
    jp = jax_random_dense_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    return jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


def _same_linear(ql: QuantLinear, jl, what: str) -> None:
    np.testing.assert_array_equal(unpack_weights(ql.packed).numpy(),
                                  np.asarray(jax_unpack(jl.qweight)), err_msg=what)
    np.testing.assert_array_equal(ql.scales.numpy(), np.asarray(jl.scales), err_msg=what)
    assert (ql.bias is None) == (jl.bias is None), what
    assert ql.bits == jl.qweight.bits, what


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_quantize_params_tp_matches_jax(dense, tp, bits):
    jp, pp = dense
    got = tp_reshard.quantize_params_tp(pp, CFG, tp, bits=bits)
    want = jax_tp.quantize_params_tp(jp, JCFG, tp=tp, bits=bits)
    for i, (lt, lj) in enumerate(zip(got.layers, want.layers)):
        for name in PROJ:
            _same_linear(getattr(lt, name), getattr(lj, name), f"layer {i} {name}")
    lp = got.layers[0]
    rows = () if tp == 1 else (tp,)
    assert tuple(lp.o_proj.scales.shape) == rows + (CFG.hidden_size,)
    assert tuple(lp.down.scales.shape) == rows + (CFG.hidden_size,)
    assert lp.qkv.scales.dim() == 1 and lp.gateup.scales.dim() == 1
    assert not isinstance(got.lm_head, QuantLinear)  # the reference's exclusion
    assert got.embed is pp.embed and got.layers[0].input_norm is pp.layers[0].input_norm


@pytest.mark.parametrize("tp", [2, 4])
def test_split_functions_match_jax(dense, tp):
    """The tensor splits on a dense weight and the quantized splits of the
    tp artifact give JAX's shards, values and scales bit-equal."""
    jp, pp = dense
    lt, lj = pp.layers[0], jp.layers[0]
    for got, want in ((split_qkv_columns(lt.qkv.weight, CFG, tp),
                       jax_sharding.split_qkv_columns(lj.qkv.weight, JCFG, tp)),
                      (split_gateup_columns(lt.gateup.weight, tp),
                       jax_sharding.split_gateup_columns(lj.gateup.weight, tp)),
                      (split_rows(lt.down.weight, tp), jax_sharding.split_rows(lj.down.weight, tp))):
        assert len(got) == len(want) == tp
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    qt = tp_reshard.quantize_params_tp(pp, CFG, tp).layers[0]
    qj = jax_tp.quantize_params_tp(jp, JCFG, tp=tp).layers[0]
    for kind in ("qkv", "gateup"):
        for a, b in zip(tp_reshard._split_quant_columns_grouped(getattr(qt, kind), CFG, tp, kind),
                        jax_tp._split_quant_columns_grouped(getattr(qj, kind), JCFG, tp, kind)):
            _same_linear(a, b, kind)
    for kind in ("o_proj", "down"):
        shards = tp_reshard.split_quant_rows(getattr(qt, kind), tp)
        for a, b in zip(shards, jax_tp.split_quant_rows(getattr(qj, kind), tp)):
            _same_linear(a, b, kind)
            assert a.scales.dim() == 1  # one scale row a rank: per-channel


def test_row_shards_equal_independent_quantization(dense):
    """Each rank's K slice quantized on its own is the artifact's shard."""
    _, pp = dense
    merged = tp_reshard.quantize_params_tp(pp, CFG, 2).layers[0].down
    for shard, w in zip(tp_reshard.split_quant_rows(merged, 2),
                        split_rows(pp.layers[0].down.weight, 2)):
        ref = quantize_params(_one_linear_model(w), quantize_lm_head=False).layers[0].down
        assert torch.equal(unpack_weights(shard.packed), unpack_weights(ref.packed))
        assert torch.equal(shard.scales, ref.scales)


def _one_linear_model(w):
    """A one-layer shell whose down projection is w (for quantize_params)."""
    from eetq_tpu_torch.models.transformer import LayerParams, ModelParams
    from eetq_tpu_torch.modules.linear import DenseLinear

    lin = DenseLinear(w)
    layer = LayerParams(torch.ones(1), lin, lin, torch.ones(1), gateup=lin, down=lin)
    return ModelParams(torch.zeros(1, 1), [layer], torch.ones(1), None)


def test_tp_artifact_forward_matches_jax(dense):
    """The merged tp = 2 artifact serves on one device: the port's logits
    (group-wise plain kernels) against JAX's forward of its artifact, and
    close to the tp = 1 model's, as `tests/test_tp_reshard.py` holds JAX's."""
    jp, pp = dense
    toks = np.arange(8, dtype=np.int32)[None] % CFG.vocab_size
    pos = np.arange(8, dtype=np.int32)[None]
    want, _ = jax_forward(jax_tp.quantize_params_tp(jp, JCFG, tp=2), JCFG, jnp.asarray(toks),
                          jnp.asarray(pos), None, jnp.int32(0))
    want = np.asarray(want, np.float32)

    def port(params):
        with torch.no_grad():
            lg, _ = forward_inner(params, CFG, torch.from_numpy(toks).long(),
                                  torch.from_numpy(pos).long(), None, 0)
        return lg.float().numpy()

    got = port(tp_reshard.quantize_params_tp(pp, CFG, 2))
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    plain = port(tp_reshard.quantize_params_tp(pp, CFG, 1))
    np.testing.assert_allclose(got, plain, atol=0.1, rtol=0.1)


def _both_ways(jax_params, port_params, tmp_path):
    """(the port's load of JAX's tp = 2 files, JAX's load of the port's)."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_save_quantized(jax_params, JCFG, str(jdir), tp=2)
    save_quantized(port_params, CFG, str(pdir), tp=2)
    for d in (jdir, pdir):
        with open(d / "config.json") as f:
            assert json.load(f)["quantization_config"]["tp"] == 2
    return load_quantized(str(jdir), device="cpu"), jax_load_quantized(str(pdir))


def test_tp_checkpoint_crosses_between_the_packages(dense, tmp_path):
    jp, pp = dense
    qj = jax_tp.quantize_params_tp(jp, JCFG, tp=2)
    qt = tp_reshard.quantize_params_tp(pp, CFG, 2)
    (cfg_t, from_jax), (cfg_j, from_port) = _both_ways(qj, qt, tmp_path)
    assert cfg_t == CFG and dataclasses.asdict(cfg_j) == dataclasses.asdict(JCFG)
    for lt, lj, src_t, src_j in zip(from_jax.layers, from_port.layers, qt.layers, qj.layers):
        for name in PROJ:
            # int8 values bit-equal; the scales as fp16 stores them, which
            # keeps these (bf16 absmax / 128 in fp16's normal range) exactly
            _same_linear(getattr(lt, name), getattr(src_j, name), f"JAX's file: {name}")
            _same_linear(getattr(src_t, name), getattr(lj, name), f"the port's file: {name}")


def test_auto_quantize_tp_records_tp(dense, tmp_path):
    _, pp = dense
    model = EETQCausalLM(CFG, pp).quantize(save_dir=str(tmp_path), tp=2)
    assert model.tp == 2 and model.quantized
    assert tuple(model.params.layers[0].o_proj.scales.shape) == (2, CFG.hidden_size)
    with open(tmp_path / "quant_config.json") as f:
        assert json.load(f) == {"quant_method": "eetq", "zero_point": False, "bits": 8, "tp": 2}
    from eetq_tpu_torch.models.auto import AutoEETQForCausalLM

    assert AutoEETQForCausalLM.from_quantized(str(tmp_path), device="cpu").tp == 2


def test_refusals(dense):
    _, pp = dense
    with pytest.raises(ValueError, match="either tp or group_size"):
        EETQCausalLM(CFG, pp).quantize(tp=2, group_size=32)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        tp_reshard.quantize_params_tp(pp, CFG, 3)
    with pytest.raises(ValueError, match="not divisible"):
        split_qkv_columns(pp.layers[0].qkv.weight, CFG, 3)
    with pytest.raises(ValueError, match="not divisible"):
        split_rows(pp.layers[0].down.weight, 3)
    with pytest.raises(ValueError, match="not divisible"):
        split_gateup_columns(pp.layers[0].gateup.weight, 3)
    # shard_quantized and shard() are ported (tests/test_torch_sharding.py):
    # over a mesh of one rank, the shard is the whole quantized model
    one = make_mesh(device="cpu")
    art = tp_reshard.quantize_params_tp(pp, CFG, 2)
    shard = tp_reshard.shard_quantized(art, CFG, one)
    for lt, la in zip(shard.params.layers, art.layers):
        for name in PROJ:
            assert torch.equal(unpack_weights(getattr(lt, name).packed),
                               unpack_weights(getattr(la, name).packed))
    shard = EETQCausalLM(CFG, pp).shard(mesh=one)
    want = quantize_params(pp)
    for lt, lw in zip(shard.params.layers, want.layers):
        for name in PROJ:
            assert torch.equal(unpack_weights(getattr(lt, name).packed),
                               unpack_weights(getattr(lw, name).packed))
            assert torch.equal(getattr(lt, name).scales, getattr(lw, name).scales)
    moe_cfg = PRESETS["toy-moe"]
    moe = random_dense_params(moe_cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="MoE"):
        tp_reshard.quantize_params_tp(moe, moe_cfg, 2)
    with pytest.raises(NotImplementedError, match="MoE"):
        EETQCausalLM(moe_cfg, moe).quantize(tp=2)
