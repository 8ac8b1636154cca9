"""The port's whole generate slice against the JAX package on the TOY preset
(2 layers, hidden 128, GQA 4/2): JAX's W8A16 parameters (int8 lm_head) are
carried across with `params_from_numpy`, then prefill logits, teacher-forced
decode logits and greedy tokens are compared. The JAX side runs its Pallas
kernels in interpret mode and decode attention through its einsum oracle."""

import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.layout import unpack_weights as jax_unpack
from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.ops.rope import make_cos_sin_cache as jax_make_cos_sin_cache
from eetq_tpu.modules.linear import QuantLinear as JaxQuantLinear
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.modules.linear import QuantLinear
from eetq_tpu_torch.ops import rope as port_rope
from eetq_tpu_torch.serve import sampling

jax_gen = importlib.import_module("eetq_tpu.serve.generate")
port_gen = importlib.import_module("eetq_tpu_torch.serve.generate")

CFG = PRESETS["toy"]
B, S, STEPS = 2, 12, 8
# Logits are bf16 outputs of the int8 lm_head (|logit| < 4 here, so one
# bf16 ulp is at most 2^-6) cast to f32. Both packages round at the same bf16
# boundaries and sum in other orders: about one ulp of the largest logit.
LOGIT_ATOL = 2e-2


def _linear_to_numpy(lin) -> dict:
    if isinstance(lin, JaxQuantLinear):
        d = {"qweight": np.asarray(jax_unpack(lin.qweight)), "scales": np.asarray(lin.scales),
             "bits": lin.qweight.bits}
    else:
        d = {"weight": np.asarray(lin.weight, np.float32)}
    if lin.bias is not None:
        d["bias"] = np.asarray(lin.bias, np.float32)
    return d


def _layer_to_numpy(lp) -> dict:
    d = {"input_norm": np.asarray(lp.input_norm), "post_norm": np.asarray(lp.post_norm),
         "qkv": _linear_to_numpy(lp.qkv), "o_proj": _linear_to_numpy(lp.o_proj)}
    if lp.moe is not None:
        d["moe"] = {name: _linear_to_numpy(getattr(lp.moe, name))
                    for name in ("router", "gateup", "down")}
    else:
        d.update(gateup=_linear_to_numpy(lp.gateup), down=_linear_to_numpy(lp.down))
    return d


def jax_params_to_numpy(params) -> dict:
    """JAX ModelParams -> the numpy tree `params_from_numpy` takes."""
    return {
        "embed": np.asarray(params.embed, np.float32),
        "final_norm": np.asarray(params.final_norm),
        "lm_head": None if params.lm_head is None else _linear_to_numpy(params.lm_head),
        "layers": [_layer_to_numpy(lp) for lp in params.layers],
    }


@pytest.fixture(scope="module")
def models():
    jp = jax_quantize_params(
        jax_random_dense_params(JAX_PRESETS["toy"], jax.random.PRNGKey(0)), quantize_lm_head=True
    )
    return jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    # Seed 1: along JAX's greedy path every top-1/top-2 logit gap is at least
    # 0.0625, more than twice LOGIT_ATOL, so equal greedy tokens are expected
    # (other seeds hit gaps of one bf16 ulp, where either token is right).
    return np.random.default_rng(1).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def test_config_matches_jax():
    for name, cfg in PRESETS.items():
        assert cfg.__dict__ == JAX_PRESETS[name].__dict__, name


def test_params_carried_across_exactly(models):
    jp, tp = models
    assert isinstance(tp.lm_head, QuantLinear)
    for lj, lt in zip(jp.layers, tp.layers):
        for name in ("qkv", "o_proj", "gateup", "down"):
            np.testing.assert_array_equal(
                lt.get_submodule(name).packed.data[: lt.get_submodule(name).k,
                                                   : lt.get_submodule(name).n].numpy(),
                np.asarray(jax_unpack(getattr(lj, name).qweight)),
            )
    np.testing.assert_array_equal(tp.embed.float().numpy(), np.asarray(jp.embed, np.float32))


def test_prefill_and_teacher_forced_decode_logits_match_jax(models, prompt):
    jp, tp = models
    logits_j, caches_j = jax_gen.prefill(jp, JAX_PRESETS["toy"], jnp.asarray(prompt),
                                         jax_init_caches(JAX_PRESETS["toy"], B, S + STEPS))
    logits_t, caches_t = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                                          init_caches(CFG, B, S + STEPS, device="cpu"))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0, atol=LOGIT_ATOL)
    token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        # both packages get JAX's greedy token, so one near-tie cannot cascade
        logits_j, caches_j = jax_gen.decode_step(jp, JAX_PRESETS["toy"], token[:, None],
                                                 jnp.int32(S + i), caches_j)
        logits_t, caches_t = port_gen.decode_step(
            tp, CFG, torch.from_numpy(np.array(token)).long()[:, None], S + i, caches_t)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"decode step {i}")
        token = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)


def test_greedy_generate_matches_jax(models, prompt):
    jp, tp = models
    toks_j = np.asarray(jax_gen.generate(jp, JAX_PRESETS["toy"], jnp.asarray(prompt), STEPS))
    toks_t = port_gen.generate(tp, CFG, torch.from_numpy(prompt).long(), STEPS)
    assert toks_t.shape == (B, STEPS)
    np.testing.assert_array_equal(toks_t.numpy(), toks_j)


def test_decode_loop_returns_tokens_and_caches_equal_to_jax(models, prompt):
    """decode_loop returns (tokens, caches) as the JAX package's does. The
    greedy tokens are equal (the prompt's logit gaps, see `prompt`), so both
    caches hold the keys and values of the same S + STEPS - 1 positions: bf16
    values of magnitude below 8 here, rounded at the same places and summed
    in other orders, agree within two bf16 ulps of 4..8 (2^-5 each), and the
    slot past the last written position is still zero in both."""
    jp, tp = models
    jcfg = JAX_PRESETS["toy"]
    logits_j, caches_j = jax_gen.prefill(jp, jcfg, jnp.asarray(prompt),
                                         jax_init_caches(jcfg, B, S + STEPS))
    first_j = jnp.argmax(logits_j, axis=-1).astype(jnp.int32)
    toks_j, caches_j = jax_gen.decode_loop(jp, jcfg, first_j, jnp.int32(S), caches_j, STEPS)
    logits_t, caches_t = port_gen.prefill(tp, CFG, torch.from_numpy(prompt).long(),
                                          init_caches(CFG, B, S + STEPS, device="cpu"))
    out = port_gen.decode_loop(tp, CFG, torch.argmax(logits_t, -1), S, caches_t, STEPS)
    assert isinstance(out, tuple) and len(out) == 2
    toks_t, caches_out = out
    assert toks_t.shape == (B, STEPS)
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    assert len(caches_out) == CFG.num_layers == len(caches_j)
    for layer, (ct, cj) in enumerate(zip(caches_out, caches_j)):
        assert ct is caches_t[layer]  # updated in place
        for name in ("k", "v"):
            got = getattr(ct, name).float().numpy()
            want = np.asarray(getattr(cj, name), np.float32)
            assert got.shape == want.shape
            assert np.abs(want[:, :, :S + STEPS - 1]).max() > 0
            np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -4,
                                       err_msg=f"layer {layer} {name}")
            assert not got[:, :, S + STEPS - 1:].any() and not want[:, :, S + STEPS - 1:].any()


@pytest.mark.parametrize("max_position,rot_dim,base", [(64, 32, 10000.0), (48, 16, 500000.0)])
def test_cos_sin_cache_equals_jax_and_is_built_once_per_key(max_position, rot_dim, base):
    """The shared rope table holds the values of eetq_tpu/ops/rope.py's (f32
    cos and sin of the same f32 angles: 1e-6 covers the two libraries'
    implementations of cos, sin and pow) and is built once per
    (max_position, rot_dim, base, device)."""
    port_rope._shared_cos_sin_cache.cache_clear()
    a = port_rope.cos_sin_cache(max_position, rot_dim, base=base, device="cpu")
    want = np.asarray(jax_make_cos_sin_cache(max_position, rot_dim, base=base))
    assert a.shape == want.shape and a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(a, port_rope.make_cos_sin_cache(max_position, rot_dim, base=base,
                                                       device="cpu"))
    assert port_rope.cos_sin_cache(max_position, rot_dim, base=base, device="cpu") is a
    assert port_rope.cos_sin_cache(max_position, rot_dim, base, torch.device("cpu")) is a
    info = port_rope._shared_cos_sin_cache.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    assert port_rope.cos_sin_cache(max_position, rot_dim * 2, base=base, device="cpu") is not a


def test_forward_builds_the_cos_sin_cache_once(models, prompt):
    _, tp = models
    port_rope._shared_cos_sin_cache.cache_clear()
    p = torch.from_numpy(prompt).long()
    port_gen.generate(tp, CFG, p, 4)
    port_gen.generate(tp, CFG, p, 4)
    assert port_rope._shared_cos_sin_cache.cache_info().misses == 1


def test_generate_eos_and_sampling(models, prompt):
    _, tp = models
    p = torch.from_numpy(prompt).long()
    greedy = port_gen.generate(tp, CFG, p, STEPS)
    eos = int(greedy[0, 2])
    out = port_gen.generate(tp, CFG, p, STEPS, eos_token_id=eos)
    first = int((out[0] == eos).nonzero()[0])
    assert (out[0, first:] == eos).all()
    a = port_gen.generate(tp, CFG, p, STEPS, temperature=0.8, top_k=5,
                          generator=torch.Generator().manual_seed(1))
    b = port_gen.generate(tp, CFG, p, STEPS, temperature=0.8, top_k=5,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and ((a >= 0) & (a < CFG.vocab_size)).all()
    with pytest.raises(ValueError):
        port_gen.generate(tp, CFG, p, 0)


def test_top_k_sampling_stays_in_top_k():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 3.0]])
    rng = sampling.rng_state(0, "cpu")
    draws = {int(sampling.sample(logits, 1.0, 2, rng)) for _ in range(50)}
    assert draws == {1, 2} and sampling.sample(logits).item() == 1
    # at gemma's vocabulary: 16 rows x 16 draws over 256,000 logits, each
    # draw among its row's top 2 (a noise value of +inf on a masked logit
    # makes a NaN whose index argmax returns: at 2^-24 a value, once in 66
    # draws here)
    big = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 256_000))
                           .astype(np.float32))
    top2 = torch.topk(big, 2, dim=-1).indices
    for _ in range(16):
        got = sampling.sample(big, 1.0, 2, rng)
        assert (top2 == got[:, None]).any(dim=-1).all()


def test_gumbel_noise_is_finite():
    """Every 32-bit hash maps to a uniform strictly inside (0, 1), so its
    Gumbel noise is finite: checked at both ends of each of the 2^23 hash
    ranges that give distinct uniforms."""
    top = torch.arange(1 << 23, dtype=torch.int64) << 9
    for h in (top, top | 511):
        u = sampling._uniform(h)
        assert (u > 0).all() and (u < 1).all()
        assert torch.isfinite(-torch.log(-torch.log(u))).all()


def test_port_random_init_and_quantize():
    gen = torch.Generator().manual_seed(0)
    dense = random_dense_params(CFG, gen)
    q = quantize_params(dense, quantize_lm_head=True)
    assert isinstance(q.layers[0].qkv, QuantLinear) and isinstance(q.lm_head, QuantLinear)
    assert q.layers[0].qkv.out_features == CFG.qkv_out
    assert quantize_params(dense).lm_head is dense.lm_head  # stays dense by default
    logits, _ = port_gen.prefill(q, CFG, torch.zeros(1, 4, dtype=torch.long),
                                 init_caches(CFG, 1, 8, device="cpu"))
    assert logits.shape == (1, CFG.vocab_size) and torch.isfinite(logits).all()
    moe = quantize_params(random_dense_params(PRESETS["toy-moe"], gen)).layers[0]
    assert moe.gateup is None and moe.moe.gateup.qweight.dim() == 3


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import eetq_tpu_torch\n"
        "for m in pkgutil.walk_packages(eetq_tpu_torch.__path__, 'eetq_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import eetq_tpu_torch.serve.generate\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'eetq_tpu.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_streaming_generate_with_eos_matches_jax_and_stops_early(models, prompt, monkeypatch):
    """generate(use_scan=False) streams through decode_step as JAX's does
    (eetq_tpu/serve/generate.py:207-228): a row that meets eos emits it from
    then on, and the loop stops once every row has met it, the rest padded
    with eos. One row whose eos is its third greedy token: two decode steps,
    not STEPS - 1."""
    jp, tp = models
    row = prompt[:1]
    greedy = np.asarray(jax_gen.generate(jp, JAX_PRESETS["toy"], jnp.asarray(row), STEPS))
    eos = int(greedy[0, 2])
    want = np.asarray(jax_gen.generate(jp, JAX_PRESETS["toy"], jnp.asarray(row), STEPS,
                                       eos_token_id=eos, use_scan=False))
    calls = []
    step = port_gen.decode_step
    monkeypatch.setattr(port_gen, "decode_step", lambda *a, **k: calls.append(1) or step(*a, **k))
    got = port_gen.generate(tp, CFG, torch.from_numpy(row).long(), STEPS, eos_token_id=eos,
                            use_scan=False)
    np.testing.assert_array_equal(got.numpy(), want)
    first = int(np.flatnonzero(greedy[0] == eos)[0])
    assert (got[0, first:] == eos).all() and len(calls) == first < STEPS - 1
    scan = port_gen.generate(tp, CFG, torch.from_numpy(row).long(), STEPS, eos_token_id=eos)
    assert torch.equal(scan, got)


def test_greedy_generate_entry_point_matches_jax(models, prompt):
    """`greedy_generate`, the reference's shorthand for generate at
    temperature 0 (eetq_tpu/serve/generate.py:231)."""
    jp, tp = models
    want = np.asarray(jax_gen.greedy_generate(jp, JAX_PRESETS["toy"], jnp.asarray(prompt), STEPS))
    got = port_gen.greedy_generate(tp, CFG, torch.from_numpy(prompt).long(), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tied_head_logits_match_jax():
    """A gemma-style toy (tied head, unit-offset norms, embedding multiplier,
    gelu), bf16 weights: the port's head multiplies by the bf16 table a
    vocabulary chunk at a time, the reference takes one bf16 dot with f32
    accumulation (eetq_tpu/models/transformer.py:259-261). Both sum exact
    products in f32, so the logits differ by what the body's bf16 roundings
    at other places leave in the hidden states: up to two bf16 ulps of the
    largest logit (|logit| < 2 here, an ulp 2^-7; measured 1.5). Every chunk
    width gives the same logits."""
    import dataclasses

    from eetq_tpu_torch.models import transformer

    tied = dict(tie_word_embeddings=True, rmsnorm_unit_offset=True, activation="gelu",
                embedding_multiplier=128 ** 0.5)
    jcfg = dataclasses.replace(JAX_PRESETS["toy"], **tied)
    cfg = dataclasses.replace(CFG, **tied)
    jp = jax_random_dense_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    assert jp.lm_head is None and tp.lm_head is None
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jax_gen.prefill(jp, jcfg, jnp.asarray(toks), jax_init_caches(jcfg, B, S))
    got, _ = port_gen.prefill(tp, cfg, torch.from_numpy(toks).long(),
                              init_caches(cfg, B, S, device="cpu"))
    assert got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() < 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2 * 2 ** -7)
    wide = transformer._TIED_CHUNK_BYTES
    try:  # 7 vocabulary rows a chunk: chunks that do not divide the vocabulary
        transformer._TIED_CHUNK_BYTES = 7 * cfg.hidden_size * 4
        again, _ = port_gen.prefill(tp, cfg, torch.from_numpy(toks).long(),
                                    init_caches(cfg, B, S, device="cpu"))
    finally:
        transformer._TIED_CHUNK_BYTES = wide
    assert torch.equal(again, got)
