"""LoRA inference and multi-adapter serving of the port against the JAX
package: the side path of `linear_apply` (one adapter and a bank with
`lora_idx`), its ValueErrors, `surgery/lora.py` (init, attach, merge,
stack), `forward_inner(lora_idx=)`, and the engine serving a bank of
adapters (dense, paged, speculative and chunked) against `JaxEngine` and the
port's own single-adapter models, over HTTP too.

The adapters are made once with numpy from a seed and carried to both
packages (`models/convert.py::params_from_numpy` takes them as numpy);
adapter 0 keeps B = 0 (an exact no-op), the others a random B ~ N(0, 0.1^2)
(with scaling 4 the side path is about as large as the base projection:
`tests/test_multi_lora.py`'s 0.4 makes it ten times larger, and the two
packages' logits then part by up to 6% of the largest one after 2 layers,
the ulps of qkv values up to 55 amplified, while each layer's qkv with its
adapter stays bit-equal across the packages).

Tolerances: the side path rounds x A and (x A) B to bf16 on both sides, the
products summed in f32 in another order, so a value may sit one or two
bf16 ulps apart: rtol 2^-6 plus 2e-3 of the output scale. Logits after the
toy's 2 layers, within the port: the JAX test's own 2e-2
(`test_banked_forward_matches_single`); across the packages two bf16 ulps of
the largest logit (LOGIT_ATOL, |logit| < 8), one more than the base model's
cross-package bound (`tests/test_torch_model.py`): x A, (x A) B, its scaling
and the sum each round to bf16 beside the base's roundings. Greedy tokens
are compared exactly within the port; against the JAX engine a request may
part only where the JAX model's next-token logits hold both tokens within
LOGIT_ATOL of the top one (a near tie, `_equal_or_near_tie`).
"""

import dataclasses
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.transformer import forward as jax_forward
from eetq_tpu.modules.linear import LoraAdapter as JaxLora
from eetq_tpu.modules.linear import linear_apply as jax_linear_apply
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu.surgery import merge_lora as jax_merge_lora
from eetq_tpu.surgery import stack_adapters as jax_stack_adapters
from eetq_tpu_torch.layout.tiling import unpack_weights
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.models.transformer import forward_inner
from eetq_tpu_torch.modules.linear import LoraAdapter, QuantLinear, linear_apply
from eetq_tpu_torch.serve.api import EngineServer
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.serve.generate import greedy_generate
from eetq_tpu_torch.surgery import attach_lora, init_lora, merge_lora, stack_adapters
from test_torch_model import jax_params_to_numpy

CFG = ModelConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=8, num_kv_heads=4, head_dim=16, max_position=128)
N_ADAPTERS, RANK, ALPHA = 3, 4, 16.0
LOGIT_ATOL = 2 * 2.0**-5  # two bf16 ulps of a logit in [4, 8)
PROMPTS = [[3, 17, 42, 9, 3, 17], [11] * 8, [5, 6, 7, 8, 5, 6]]


def _adapter_arrays(rng, k: int, n: int, zero_b: bool) -> dict:
    a = rng.standard_normal((k, RANK)) / np.sqrt(RANK)
    b = np.zeros((RANK, n)) if zero_b else 0.1 * rng.standard_normal((RANK, n))
    return {"lora_a": np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32),
            "lora_b": np.asarray(jnp.asarray(b, jnp.bfloat16), np.float32),
            "scaling": ALPHA / RANK}


def _jax_adapter(d: dict) -> JaxLora:
    return JaxLora(lora_a=jnp.asarray(d["lora_a"], jnp.bfloat16),
                   lora_b=jnp.asarray(d["lora_b"], jnp.bfloat16), scaling=d["scaling"])


def _with_adapters(jax_base, tree: dict, adapters: list[dict]):
    """The same adapters on the JAX base and in the port's numpy tree."""
    layers = [dataclasses.replace(lp, qkv_lora=_jax_adapter(ad["qkv"]),
                                  o_lora=_jax_adapter(ad["o"]))
              for lp, ad in zip(jax_base.layers, adapters)]
    t = dict(tree, layers=[dict(lt, qkv_lora=ad["qkv"], o_lora=ad["o"])
                           for lt, ad in zip(tree["layers"], adapters)])
    return dataclasses.replace(jax_base, layers=layers), t


def _make(jax_base, seed: int):
    """N_ADAPTERS adapted copies of one base, JAX and port, and their banks."""
    tree = jax_params_to_numpy(jax_base)
    rng = np.random.default_rng(seed)
    h, qkv_out = CFG.hidden_size, CFG.num_heads * CFG.head_dim + 2 * CFG.num_kv_heads * CFG.head_dim
    singles_j, singles_t, trees = [], [], []
    for i in range(N_ADAPTERS):
        ads = [dict(qkv=_adapter_arrays(rng, h, qkv_out, i == 0),
                    o=_adapter_arrays(rng, CFG.num_heads * CFG.head_dim, h, i == 0))
               for _ in range(CFG.num_layers)]
        pj, t = _with_adapters(jax_base, tree, ads)
        singles_j.append(pj)
        singles_t.append(params_from_numpy(t, device="cpu"))
        trees.append(t)
    return dict(base_j=jax_base, base_t=params_from_numpy(tree, device="cpu"),
                singles_j=singles_j, singles_t=singles_t, trees=trees,
                bank_j=jax_stack_adapters(singles_j), bank_t=stack_adapters(singles_t))


@pytest.fixture(scope="module")
def models():
    jax_base = jax_quantize_params(
        jax_random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32))
    return _make(jax_base, 1)


def _close(t: torch.Tensor, j, rtol=2**-6, atol=2e-3) -> None:
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), j, rtol=rtol, atol=atol * np.abs(j).max())


def _greedy(params, prompt, n, kv=torch.bfloat16) -> list[int]:
    return greedy_generate(params, CFG, torch.tensor([prompt]), n, kv_dtype=kv)[0].tolist()


# ---- the side path ----

@pytest.mark.parametrize("banked", [False, True])
def test_side_path_matches_jax(models, banked):
    lj, lt = models["bank_j"].layers[0], models["bank_t"].layers[0]
    if not banked:
        lj, lt = models["singles_j"][2].layers[0], models["singles_t"][2].layers[0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, CFG.hidden_size)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    idx = np.array([2, 0, 1], np.int32)
    kw_j = dict(lora=lj.qkv_lora, lora_idx=jnp.asarray(idx) if banked else None)
    kw_t = dict(lora=lt.qkv_lora, lora_idx=torch.from_numpy(idx) if banked else None)
    out_j = jax_linear_apply(lj.qkv, xj, **kw_j)
    out_t = linear_apply(lt.qkv, xt, **kw_t)
    assert out_t.dtype == torch.bfloat16 and out_t.shape == tuple(out_j.shape)
    _close(out_t, out_j)
    # a8 beside the side path (the engine's W8A8 admission)
    _close(linear_apply(lt.qkv, xt, a8=True, **kw_t),
           jax_linear_apply(lj.qkv, xj, a8=True, **kw_j), rtol=2**-5, atol=5e-3)
    if banked:  # row b through adapter idx[b] == the single adapter's side path
        for b, i in enumerate(idx):
            single = models["singles_t"][i].layers[0]
            torch.testing.assert_close(out_t[b], linear_apply(single.qkv, xt[b:b + 1],
                                                              lora=single.qkv_lora)[0],
                                       rtol=2**-6, atol=2e-3 * out_t.abs().max().item())


def test_side_path_value_errors(models):
    """The JAX package's four refusals (`modules/linear.py:149-152, 199-203`)."""
    lp = models["bank_t"].layers[0]
    single = models["singles_t"][1].layers[0]
    x = torch.ones(1, 2, CFG.hidden_size, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="residual"):
        linear_apply(single.qkv, x, lora=single.qkv_lora, residual=torch.ones(1, 2, 128))
    with pytest.raises(ValueError, match="prenorm"):
        linear_apply(single.qkv, x, lora=single.qkv_lora,
                     prenorm=(torch.ones(CFG.hidden_size), 1e-5))
    with pytest.raises(ValueError, match="activation"):
        linear_apply(single.qkv, x, lora=single.qkv_lora, activation="relu")
    with pytest.raises(ValueError, match="lora_idx"):
        linear_apply(lp.qkv, x, lora=lp.qkv_lora)


# ---- surgery ----

def test_init_and_attach_lora_are_noops():
    gen = torch.Generator().manual_seed(0)
    ad = init_lora(gen, 64, 96, 8, alpha=32.0)
    assert ad.lora_a.shape == (64, 8) and ad.lora_b.shape == (8, 96)
    assert ad.lora_a.dtype == torch.bfloat16 and not ad.lora_b.any() and ad.scaling == 4.0
    assert abs(ad.lora_a.float().std().item() - 8 ** -0.5) < 0.05
    base = quantize_params(random_dense_params(CFG, torch.Generator().manual_seed(3)))
    adapted = attach_lora(base, rank=4, generator=torch.Generator().manual_seed(1),
                          targets=("qkv",))
    assert all(lp.qkv_lora is not None and lp.o_lora is None for lp in adapted.layers)
    assert adapted.layers[0].qkv is base.layers[0].qkv  # the base is shared, not copied
    assert _greedy(adapted, [3, 5, 7], 6) == _greedy(base, [3, 5, 7], 6)


@pytest.mark.parametrize("bits,g", [(8, None), (8, 32), (4, 32)])
def test_merge_lora_matches_jax(bits, g):
    """Dequantize, add A B scaling in f32, requantize at the base's bits and
    groups: the port's merged int values and scales equal JAX's up to a
    quantization step where the two f32 products of A B round a value across
    a step boundary."""
    jax_base = jax_quantize_params(
        jax_random_dense_params(CFG, jax.random.PRNGKey(4), dtype=jnp.bfloat16),
        bits=bits, group_size=g)
    m = _make(jax_base, 5)
    merged_j, merged_t = jax_merge_lora(m["singles_j"][1]), merge_lora(m["singles_t"][1])
    for lj, lt in zip(merged_j.layers, merged_t.layers):
        assert lt.qkv_lora is None and lt.o_lora is None
        for name in ("qkv", "o_proj"):
            qj, qt = getattr(lj, name), getattr(lt, name)
            assert isinstance(qt, QuantLinear) and qt.bits == bits
            assert qt.scales.shape == tuple(qj.scales.shape)
            np.testing.assert_allclose(qt.scales.numpy(), np.asarray(qj.scales), rtol=1e-6)
            diff = np.abs(unpack_weights(qt.packed).numpy().astype(np.int32)
                          - np.asarray(jax_unpack(qj.qweight), np.int32))
            assert diff.max() <= 1 and diff.mean() < 1e-3, (name, diff.max(), diff.mean())
    toks = np.array([[3, 5, 7, 11, 2]], np.int32)
    pos = np.arange(5)[None]
    lj, _ = jax_forward(merged_j, CFG, jnp.asarray(toks), jnp.asarray(pos), None, 0)
    lm, _ = forward_inner(merged_t, CFG, torch.from_numpy(toks).long(),
                          torch.from_numpy(pos), None, 0)
    np.testing.assert_allclose(lm.numpy(), np.asarray(lj), rtol=2e-2, atol=2e-2)


def test_merge_lora_dense_base():
    base = random_dense_params(CFG, torch.Generator().manual_seed(6))
    adapted = attach_lora(base, 4, torch.Generator().manual_seed(7))
    lp = adapted.layers[0]
    lp.qkv_lora.lora_b.normal_(0, 0.2, generator=torch.Generator().manual_seed(8))
    merged = merge_lora(adapted)
    want = (lp.qkv.weight.float() + lp.qkv_lora.lora_a.float() @ lp.qkv_lora.lora_b.float()
            * lp.qkv_lora.scaling).to(torch.bfloat16)
    assert torch.equal(merged.layers[0].qkv.weight, want)
    with pytest.raises(ValueError, match="bank"):
        merge_lora(stack_adapters([adapted, adapted]))


def test_stack_adapters_shapes_and_errors(models):
    bank = models["bank_t"]
    lp, single = bank.layers[0], models["singles_t"][1].layers[0]
    assert lp.qkv_lora.lora_a.shape == (N_ADAPTERS, CFG.hidden_size, RANK)
    assert lp.o_lora.lora_b.shape == (N_ADAPTERS, RANK, CFG.hidden_size)
    assert lp.qkv is models["singles_t"][0].layers[0].qkv
    assert torch.equal(lp.qkv_lora.lora_b[1], single.qkv_lora.lora_b)
    # the bank carried from numpy equals the one stacked in the port
    banked_tree = dict(models["trees"][0], layers=[
        dict(lt, **{name: {"lora_a": np.stack([t["layers"][i][name]["lora_a"]
                                               for t in models["trees"]]),
                           "lora_b": np.stack([t["layers"][i][name]["lora_b"]
                                               for t in models["trees"]]),
                           "scaling": ALPHA / RANK} for name in ("qkv_lora", "o_lora")})
        for i, lt in enumerate(models["trees"][0]["layers"])])
    carried = params_from_numpy(banked_tree, device="cpu").layers[1]
    assert torch.equal(carried.o_lora.lora_a, bank.layers[1].o_lora.lora_a)
    with pytest.raises(ValueError, match="at least one"):
        stack_adapters([])
    with pytest.raises(ValueError, match="same projections"):
        stack_adapters([models["singles_t"][0], models["base_t"]])
    other = models["singles_t"][1]
    rescaled = stack_adapters([other])
    for layer in rescaled.layers:
        layer.qkv_lora = LoraAdapter(layer.qkv_lora.lora_a[0], layer.qkv_lora.lora_b[0], 1.0)
        layer.o_lora = LoraAdapter(layer.o_lora.lora_a[0], layer.o_lora.lora_b[0], 1.0)
    with pytest.raises(ValueError, match="one scaling"):
        stack_adapters([other, rescaled])


# ---- the model ----

def test_forward_lora_idx_matches_singles_and_jax(models):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, CFG.vocab_size, (N_ADAPTERS, 8))
    pos = np.broadcast_to(np.arange(8), (N_ADAPTERS, 8))
    idx = np.array([1, 2, 0])
    got, _ = forward_inner(models["bank_t"], CFG, torch.from_numpy(toks),
                           torch.from_numpy(pos.copy()), None, 0, lora_idx=torch.from_numpy(idx))
    want_j, _ = jax_forward(models["bank_j"], CFG, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(pos, jnp.int32), None, 0,
                            lora_idx=jnp.asarray(idx, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j), rtol=0, atol=LOGIT_ATOL)
    for b, i in enumerate(idx):
        single, _ = forward_inner(models["singles_t"][i], CFG, torch.from_numpy(toks[b:b + 1]),
                                  torch.from_numpy(pos[b:b + 1].copy()), None, 0)
        np.testing.assert_allclose(got[b].numpy(), single[0].numpy(), rtol=2e-2, atol=2e-2)
    base, _ = forward_inner(models["base_t"], CFG, torch.from_numpy(toks),
                            torch.from_numpy(pos.copy()), None, 0)
    assert np.abs(got[2].numpy() - base[2].numpy()).max() < 1e-6  # adapter 0: B = 0
    assert np.abs(got[0].numpy() - base[0].numpy()).max() > 0.1  # the side path is live


# ---- serving ----

def _serve(eng, ids, prompts=PROMPTS, new=8) -> list[list[int]]:
    uids = [eng.add_request(p, new, lora_id=i) for p, i in zip(prompts, ids)]
    eng.run()
    return [eng.result(u) for u in uids]


@pytest.fixture(scope="module")
def singles_greedy(models):
    return {(i, j): _greedy(models["singles_t"][i], p, 8)
            for j, p in enumerate(PROMPTS) for i in range(N_ADAPTERS)}


def _equal_or_near_tie(got: list[int], want: list[int], single_j, prompt: list[int]) -> None:
    """got equals want, or first parts from it where the JAX model's logits
    after prompt + want[:j] hold both tokens within LOGIT_ATOL of the top."""
    j = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        return
    ids = jnp.asarray([prompt + want[:j]], jnp.int32)
    logits, _ = jax_forward(single_j, CFG, ids, jnp.arange(ids.shape[1])[None], None, 0)
    row = np.asarray(logits, np.float32)[0, -1]
    gaps = row.max() - row[[got[j], want[j]]]
    assert (gaps <= LOGIT_ATOL).all(), (j, got, want, gaps)


def test_engine_mixed_adapters_match_jax_engine(models, singles_greedy):
    ids = [0, 1, 2]
    je = JaxEngine(models["bank_j"], CFG, max_batch=4, max_len=64, prompt_buckets=(8,),
                   decode_window=4)
    uids = [je.add_request(p, 8, lora_id=i) for p, i in zip(PROMPTS, ids)]
    je.run()
    want = [[int(t) for t in je.result(u)] for u in uids]
    got = _serve(Engine(models["bank_t"], CFG, max_batch=4, max_len=64, prompt_buckets=(8,),
                        decode_window=4), ids)
    for g, w, i, p in zip(got, want, ids, PROMPTS):
        _equal_or_near_tie(g, w, models["singles_j"][i], p)
    assert got == [singles_greedy[i, j] for j, i in enumerate(ids)]


@pytest.mark.parametrize("kw", [dict(), dict(paged_blocks=6, paged_block_size=128),
                                dict(spec_ngram=3), dict(spec_ngram=3, paged_blocks=6,
                                                         paged_block_size=128)],
                         ids=["dense", "paged", "spec", "spec-paged"])
def test_engine_banks_match_single_adapter_models(models, singles_greedy, kw):
    ids = [2, 0, 1]
    eng = Engine(models["bank_t"], CFG, max_batch=4, max_len=64, prompt_buckets=(8,),
                 decode_window=4, **kw)
    got = _serve(eng, ids)
    assert got == [singles_greedy[i, j] for j, i in enumerate(ids)]
    if "paged_blocks" in kw:
        assert not any(eng._slot_blocks)


def test_chunked_engine_with_banks(models):
    """Prompts past the chunk run one chunk a step through their adapter."""
    prompts = [list(np.random.default_rng(3).integers(1, CFG.vocab_size, 13)), PROMPTS[1]]
    ids = [2, 1]
    eng = Engine(models["bank_t"], CFG, max_batch=2, max_len=64, prompt_buckets=(8, 16),
                 prefill_chunk=8, decode_window=4)
    got = _serve(eng, ids, prompts, new=6)
    assert got == [_greedy(models["singles_t"][i], p, 6) for p, i in zip(prompts, ids)]


def test_engine_slot_recycling_takes_the_new_adapter(models, singles_greedy):
    """More requests than slots: a recycled slot decodes with its new
    request's adapter, the ids' buffer rewritten in place."""
    ids = [1, 2, 0, 1]
    prompts = PROMPTS + [PROMPTS[0]]
    eng = Engine(models["bank_t"], CFG, max_batch=2, max_len=64, prompt_buckets=(8,),
                 decode_window=4)
    buf = eng._lora_ids
    got = _serve(eng, ids, prompts)
    assert eng._lora_ids is buf
    assert got == [singles_greedy[i, j % len(PROMPTS)] for j, i in enumerate(ids)]


def test_lora_id_validation(models):
    eng = Engine(models["bank_t"], CFG, max_batch=2, max_len=64, prompt_buckets=(8,))
    with pytest.raises(ValueError, match="out of range"):
        eng.add_request([1, 2], 4, lora_id=N_ADAPTERS)
    with pytest.raises(ValueError, match="out of range"):
        eng.add_request([1, 2], 4, lora_id=-1)
    base = Engine(models["base_t"], CFG, max_batch=2, max_len=64, prompt_buckets=(8,))
    with pytest.raises(ValueError, match="adapter banks"):
        base.add_request([1, 2], 4, lora_id=1)
    base.add_request([1, 2], 4, lora_id=0)  # 0 is the base itself, as in JAX


def test_http_lora_id(models, singles_greedy):
    srv = EngineServer(Engine(models["bank_t"], CFG, max_batch=2, max_len=64,
                              prompt_buckets=(8,), decode_window=4), port=0)
    srv.start()
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)

        def post(body):
            conn.request("POST", "/generate", json.dumps(body),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())

        status, body = post({"prompt": PROMPTS[1], "max_new_tokens": 8, "lora_id": 2})
        assert status == 200 and body["tokens"] == singles_greedy[2, 1]
        status, body = post({"prompt": PROMPTS[1], "max_new_tokens": 8, "lora_id": 9})
        assert status == 400 and "out of range" in body["error"]
    finally:
        srv.shutdown()
