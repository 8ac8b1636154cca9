"""Chunked prefill in the port against the JAX package on the CPU, at toy
size, the same numpy inputs through both:

- `modules.attention.attention` at an int offset > 0 (a prefill chunk over
  its cached prefix, bf16 and int8 caches, a window, ALiBi) against JAX's.
- `serve.generate.prefill_chunked` against JAX's `prefill_chunked`: the
  last-token logits and the caches (bf16 and int8 KV, GQA, a sliding
  window, ALiBi), decode after a chunked prefill, and a prompt that is not a
  multiple of the chunk refused.
- `Engine(prefill_chunk=8)`, dense and paged: greedy outputs equal to
  `JaxEngine(prefill_chunk=8)`'s and to the unchunked engine's, and the
  reference's three scheduling tests (`tests/test_engine.py:352-440`): a
  running slot decodes during every chunk step, a long prompt behind a short
  one still takes the chunked path, and a prompt longer than the largest
  bucket works.

Tolerances are those of the reference test (`tests/test_chunked_prefill.py`):
logits and cached K/V within 0.05 (the int8 cache's requantized chunks
within 0.15 of unchunked prefill). The engines' chunks run W8A16 both sides,
so the unchunked twins admit with W8A16 too.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.models import ModelConfig as JaxModelConfig
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.modules.attention import attention, init_kv_cache
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.serve.generate import (
    decode_loop,
    greedy_generate,
    prefill,
    prefill_chunked,
)
from test_torch_model import jax_params_to_numpy

jax_attn = importlib.import_module("eetq_tpu.modules.attention")
jax_generate = importlib.import_module("eetq_tpu.serve.generate")

ATOL = 0.05
INT8_ATOL = 0.15  # int8 requantization compounds chunk to chunk (the reference's bound)
BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, max_position=256)
# (config keywords, KV dtype name, chunk): GQA 4/2 bf16 at two chunks, int8
# KV, a window shorter than a chunk pair, ALiBi over 4 heads
CASES = {
    "gqa-16": ({}, "bf16", 16),
    "gqa-32": ({}, "bf16", 32),
    "int8": ({}, "int8", 32),
    "window": (dict(sliding_window=24), "bf16", 16),
    "alibi": (dict(alibi=True, num_kv_heads=4, model_type="baichuan"), "bf16", 16),
}
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _kv_values(cache, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The first n positions of a cache's K and V as f32 (int8 dequantized)."""
    out = []
    for name in ("k", "v"):
        x = _np(getattr(cache, name)[:, :, :n])
        if cache.k_scale is not None:
            x = x * _np(getattr(cache, f"{name}_scale")[:, :, :n])[..., None]
        out.append(x)
    return tuple(out)


@pytest.fixture(scope="module", params=list(CASES))
def model(request):
    """(case, port config, JAX config, JAX W8A16 params, the same in the
    port, KV dtypes (JAX, port), chunk)."""
    kw, kv, chunk = CASES[request.param]
    dims = dict(BASE, **kw)
    cfg, jcfg = ModelConfig(**dims), JaxModelConfig(**dims)
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(2)))
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return request.param, cfg, jcfg, jp, tp, KV[kv], chunk


def test_prefill_chunked_matches_jax(model):
    """Logits and the cached prefix of the port's chunked prefill against
    JAX's, and against the port's own unchunked prefill."""
    name, cfg, jcfg, jp, tp, (jkv, tkv), chunk = model
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, size=(2, 64))
    lg_j, c_j = jax_generate.prefill_chunked(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                             jax_init_caches(jcfg, 2, 128, dtype=jkv), chunk=chunk)
    lg_t, c_t = prefill_chunked(tp, cfg, torch.from_numpy(toks),
                                init_caches(cfg, 2, 128, device="cpu", dtype=tkv), chunk=chunk)
    assert lg_t.shape == (2, cfg.vocab_size) and lg_t.dtype == torch.float32
    np.testing.assert_allclose(_np(lg_t), _np(lg_j), rtol=0, atol=ATOL)
    for a, b in zip(c_t, c_j):
        for x, y in zip(_kv_values(a, 64), _kv_values(b, 64)):
            np.testing.assert_allclose(x, y, rtol=0, atol=ATOL)
    lg_full, _ = prefill(tp, cfg, torch.from_numpy(toks),
                         init_caches(cfg, 2, 128, device="cpu", dtype=tkv))
    np.testing.assert_allclose(_np(lg_t), _np(lg_full), rtol=0,
                               atol=INT8_ATOL if tkv == torch.int8 else ATOL)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("variant", ["causal", "window", "alibi"])
def test_attention_chunk_at_an_offset_matches_jax(kv, variant):
    """A chunk of 8 tokens at offset 16, after a first chunk at offset 0,
    through `attention` on both sides: the cache and each chunk's output."""
    jkv, tkv = KV[kv]
    b, hq, hkv, d, c = 2, 4, 2, 32, 8
    window = 12 if variant == "window" else None
    slopes_j = slopes_t = None
    if variant == "alibi":
        from eetq_tpu.ops.alibi import alibi_slopes as jax_alibi_slopes
        from eetq_tpu_torch.ops.alibi import alibi_slopes_cache

        slopes_j, slopes_t = jnp.asarray(jax_alibi_slopes(hq)), alibi_slopes_cache(hq, "cpu")
    rng = np.random.default_rng(7)
    cache_j = jax_attn.init_kv_cache(b, 64, hkv, d, dtype=jkv)
    cache_t = init_kv_cache(b, 64, hkv, d, device="cpu", dtype=tkv)
    for off, s in ((0, 16), (16, c)):
        xs = [rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv)]
        (q_j, k_j, v_j) = (jnp.asarray(x, jnp.bfloat16) for x in xs)
        (q_t, k_t, v_t) = (torch.from_numpy(x).to(torch.bfloat16) for x in xs)
        o_j, cache_j = jax_attn.attention(q_j, k_j, v_j, cache_j, off, window=window,
                                          slopes=slopes_j)
        o_t, cache_t = attention(q_t, k_t, v_t, cache_t, off, window=window, slopes=slopes_t)
        assert o_t.shape == (b, s, hq, d)
        np.testing.assert_allclose(_np(o_t), _np(o_j), rtol=0, atol=2 ** -6)
    for x, y in zip(_kv_values(cache_t, 24), _kv_values(cache_j, 24)):
        np.testing.assert_allclose(x, y, rtol=0, atol=2 ** -6)


def test_decode_after_chunked_prefill():
    """Chunked prefill then decode_loop: the greedy tokens of the port's
    greedy_generate and of JAX's."""
    cfg, jcfg = ModelConfig(**BASE), JaxModelConfig(**BASE)
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    s, n = 32, 8
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, size=(1, s))
    want = greedy_generate(tp, cfg, torch.from_numpy(toks), n)
    logits, caches = prefill_chunked(tp, cfg, torch.from_numpy(toks),
                                     init_caches(cfg, 1, s + n, device="cpu"), chunk=16)
    got, _ = decode_loop(tp, cfg, torch.argmax(logits, -1), s, caches, n)
    assert got.tolist() == want.tolist()
    assert got.tolist() == np.asarray(jax_generate.greedy_generate(
        jp, jcfg, jnp.asarray(toks, jnp.int32), n)).tolist()
    with pytest.raises(ValueError, match="divide"):
        prefill_chunked(tp, cfg, torch.from_numpy(toks[:, :30]),
                        init_caches(cfg, 1, 64, device="cpu"), chunk=16)


# ---- the engine ----

TOY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=32, max_position=2048)
PAGED = dict(paged_blocks=9, paged_block_size=128)
ENGINES = {"dense": {}, "paged": PAGED}
ENGINE = dict(max_batch=2, max_len=96, prompt_buckets=(8, 32), a8_prefill=False)


@pytest.fixture(scope="module")
def engine_model():
    cfg, jcfg = ModelConfig(**TOY), JaxModelConfig(**TOY)
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0)),
                             quantize_lm_head=True)
    return cfg, jcfg, jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


def _prompt(seed: int, n: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(seed).integers(1, TOY["vocab_size"], size=n)]


def _unchunked(tp, cfg, prompt, n, kind) -> list[int]:
    """The same request through the unchunked engine of the same kind."""
    eng = Engine(tp, cfg, **ENGINE, **ENGINES[kind])
    uid = eng.add_request(prompt, n)
    eng.run()
    return eng.result(uid)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_chunked_engine_matches_jax_and_the_unchunked_engine(engine_model, kind):
    """A short request decoding, then a 30-token prompt (bucket 32: four
    chunks of 8) through the chunked engine: the greedy tokens of
    `JaxEngine(prefill_chunk=8)` and of the unchunked engine."""
    cfg, jcfg, jp, tp = engine_model
    long_prompt, short = _prompt(3, 30), [5, 6, 7]
    outs = []
    for eng in (JaxEngine(jp, jcfg, **{k: v for k, v in ENGINE.items() if k != "a8_prefill"},
                          prefill_chunk=8, **ENGINES[kind]),
                Engine(tp, cfg, **ENGINE, prefill_chunk=8, **ENGINES[kind])):
        u_short = eng.add_request(short, 8)
        for _ in range(3):  # the short one decodes before the long prompt arrives
            eng.step()
        u_long = eng.add_request(long_prompt, 6)
        eng.run()
        outs.append((eng.result(u_short), eng.result(u_long)))
    assert outs[1] == outs[0]
    assert outs[1] == (_unchunked(tp, cfg, short, 8, kind), _unchunked(tp, cfg, long_prompt, 6,
                                                                       kind))
    if kind == "paged":
        assert sorted(eng._free_blocks) == list(range(1, PAGED["paged_blocks"]))


@pytest.mark.parametrize("kind", list(ENGINES))
def test_chunked_engine_interleaves(engine_model, kind):
    """The running slot's decode advances during every chunk step of a
    31-token prompt."""
    cfg, _, _, tp = engine_model
    long_prompt = _prompt(4, 31)
    eng = Engine(tp, cfg, **ENGINE, prefill_chunk=8, decode_window=1, **ENGINES[kind])
    u_short = eng.add_request([5, 6, 7], 12)
    eng.step()  # the short one's admission
    u_long = eng.add_request(long_prompt, 4)
    progressed = []
    for _ in range(4):  # the long prompt's four chunks
        before = len(eng.requests[u_short].out_tokens)
        eng.step()
        progressed.append(len(eng.requests[u_short].out_tokens) > before)
    assert all(progressed), progressed
    # the last chunk's step sampled the first token and decoded the slot on
    assert eng._chunking is None and len(eng.requests[u_long].out_tokens) == 2
    eng.run()
    assert eng.result(u_long) == _unchunked(tp, cfg, long_prompt, 4, kind)
    assert eng.result(u_short) == _unchunked(tp, cfg, [5, 6, 7], 12, kind)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_chunked_prompt_behind_a_short_one_takes_the_chunked_path(engine_model, kind):
    """A chunk-eligible prompt queued behind a short one stays at the head
    for the chunked path: the grouped admission never takes it."""
    cfg, _, _, tp = engine_model
    long_prompt, short = _prompt(5, 30), [5, 6, 7]
    eng = Engine(tp, cfg, **dict(ENGINE, max_batch=4), prefill_chunk=8, decode_window=2,
                 prefill_rows=2, **ENGINES[kind])
    u1, u2 = eng.add_request(short, 5), eng.add_request(long_prompt, 6)
    started = []
    orig = eng._start_chunked
    eng._start_chunked = lambda slot, req: (started.append(req), orig(slot, req))[1]
    eng.run()
    assert [r.prompt for r in started] == [long_prompt]
    assert eng.result(u1) == _unchunked(tp, cfg, short, 5, kind)
    assert eng.result(u2) == _unchunked(tp, cfg, long_prompt, 6, kind)


@pytest.mark.parametrize("kind", list(ENGINES))
def test_prompt_longer_than_the_largest_bucket(engine_model, kind):
    """A 40-token prompt past the largest bucket (16) takes the bucket
    max_len = 96: the scratch grows to it, unchunked and chunked (96 % 8 =
    0), with the same greedy tokens."""
    cfg, _, _, tp = engine_model
    long_prompt = _prompt(7, 40)
    outs = []
    for chunk in (None, 8):
        eng = Engine(tp, cfg, **dict(ENGINE, prompt_buckets=(8, 16)), prefill_chunk=chunk,
                     **ENGINES[kind])
        short_uid = eng.add_request([3, 4, 5], 4)
        eng.step()
        uid = eng.add_request(long_prompt, 5)
        eng.run()
        assert eng._scratch_len == 96
        outs.append((eng.result(short_uid), eng.result(uid)))
    assert outs[0] == outs[1]


def test_engine_checks_the_chunk(engine_model):
    """A chunk of no token is refused; a prompt is chunk-eligible when its
    bucket is larger than the chunk and a multiple of it."""
    cfg, _, _, tp = engine_model
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(tp, cfg, **ENGINE, prefill_chunk=0)
    eng = Engine(tp, cfg, **ENGINE, prefill_chunk=8)
    short, long_ = (eng.requests[eng.add_request([1] * n, 1)] for n in (5, 20))
    assert not eng._chunk_eligible(short) and eng._chunk_eligible(long_)  # buckets 8 and 32
    eng = Engine(tp, cfg, **dict(ENGINE, prompt_buckets=(8, 28)), prefill_chunk=8)
    assert not eng._chunk_eligible(eng.requests[eng.add_request([1] * 20, 1)])  # 28 % 8
