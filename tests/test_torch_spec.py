"""Speculative decoding in the port on the CPU (`eetq_tpu_torch/serve/spec.py`
and `Engine(spec_ngram=k)`), on the TOY preset with JAX's W8A16 parameters
carried across, against the JAX package (`eetq_tpu/serve/spec.py`, its
engine) and against the port's own sequential decode.

Greedy speculation must equal greedy decode token for token; sampled
speculation must equal `positional_generate` at the same seed. Against JAX
the tokens are compared on prompts whose greedy paths agree between the two
packages (on others a top-2 gap of one bf16 ulp lets either token be right,
as `tests/test_torch_model.py::prompt` notes). The sampled streams of the
port differ from JAX's (another generator): only their properties are
compared. On the card each round is a replayed CUDA graph
(`tests/test_torch_gpu.py`, `chip_smoke.py`); here it runs eagerly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.serve import spec as jax_spec
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.serve import spec
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.serve.generate import decode_loop, greedy_generate, prefill
from test_torch_engine import KW, PROMPTS, _ref_greedy, models, params  # noqa: F401  (fixtures)
from test_torch_engine_paged import PAGED

CFG, JCFG = PRESETS["toy"], JAX_PRESETS["toy"]
JKW = dict(a8_prefill=True, kv_dtype=jnp.int8)
N = 12
# prompts on which the two packages' greedy paths agree: random tokens (seed
# 0), and a repetitive one whose continuation loops, so drafts are accepted
RANDOM = np.random.default_rng(0).integers(1, CFG.vocab_size, (2, 8))
REPETITIVE = np.tile([[7, 3]], (1, 8))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("prompt", [RANDOM, REPETITIVE], ids=["random", "repetitive"])
def test_ngram_spec_equals_greedy_and_jax(models, prompt):
    """Greedy tokens equal the port's greedy_generate and JAX's
    ngram_spec_generate, with the same rounds and accepted drafts."""
    jp, tp = models
    toks, stats = spec.ngram_spec_generate(tp, CFG, _t(prompt), N, k=3, return_stats=True)
    jtoks, jstats = jax_spec.ngram_spec_generate(jp, JCFG, jnp.asarray(prompt, jnp.int32), N,
                                                 k=3, return_stats=True)
    assert torch.equal(toks, greedy_generate(tp, CFG, _t(prompt), N))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert stats == jstats


def test_repetitive_prompt_accepts_drafts(params):
    toks, stats = spec.ngram_spec_generate(params, CFG, _t(REPETITIVE), 20, k=3,
                                           return_stats=True)
    assert torch.equal(toks, greedy_generate(params, CFG, _t(REPETITIVE), 20))
    assert stats["accepted_drafts"] > 0 and stats["rounds"] < 19


@pytest.mark.parametrize("k", [1, 7])
def test_ngram_spec_int8_kv_and_fused_mlp(params, k):
    """bench.py's decode configuration (int8 KV, fused MLP): the tokens of
    prefill + decode_loop(fused_mlp=True) over an int8 cache."""
    p = _t(REPETITIVE)
    caches = init_caches(CFG, 1, p.shape[1] + N, device="cpu", dtype=torch.int8)
    logits, caches = prefill(params, CFG, p, caches)
    want, _ = decode_loop(params, CFG, torch.argmax(logits, -1), p.shape[1], caches, N,
                          fused_mlp=True)
    got = spec.ngram_spec_generate(params, CFG, p, N, k=k, kv_dtype=torch.int8, fused_mlp=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("top_k", [0, 5])
def test_sampled_ngram_spec_equals_positional_generate(params, top_k):
    """The positional sampler keys each draw by (row, emission index): the
    speculative stream equals the sequential one at the same seed, and
    another seed gives another stream."""
    for prompt in (RANDOM, REPETITIVE):
        want = spec.positional_generate(params, CFG, _t(prompt), N, temperature=0.8,
                                        top_k=top_k, seed=42)
        got = spec.ngram_spec_generate(params, CFG, _t(prompt), N, k=3, temperature=0.8,
                                       top_k=top_k, seed=42)
        assert torch.equal(got, want)
    other = spec.ngram_spec_generate(params, CFG, _t(RANDOM), N, k=3, temperature=0.8,
                                     top_k=top_k, seed=7)
    assert not torch.equal(other, spec.ngram_spec_generate(
        params, CFG, _t(RANDOM), N, k=3, temperature=0.8, top_k=top_k, seed=42))


def test_positional_generate_at_temperature_zero_is_greedy(params):
    assert torch.equal(spec.positional_generate(params, CFG, _t(RANDOM), N),
                       greedy_generate(params, CFG, _t(RANDOM), N))


@pytest.mark.parametrize("layers,k", [(1, 3), (2, 1), (2, 3)], ids=["truncated", "self-k1",
                                                                    "self-k3"])
def test_spec_generate_with_a_draft_model(params, layers, k):
    """A draft of the target's first layers: greedy output equals the
    target's; the target drafting for itself accepts every draft, k + 1
    tokens a round."""
    draft, dcfg = spec.truncated_draft(params, CFG, layers)
    toks, stats = spec.spec_generate(params, CFG, draft, dcfg, _t(RANDOM), N, k=k,
                                     return_stats=True)
    assert torch.equal(toks, greedy_generate(params, CFG, _t(RANDOM), N))
    if layers == CFG.num_layers:
        assert stats["rounds"] == -(-(N - 1) // (k + 1))
        assert stats["accepted_drafts"] == 2 * stats["rounds"] * k  # both rows, every round


def test_sampled_spec_generate_equals_positional_generate(params):
    draft, dcfg = spec.truncated_draft(params, CFG, 1)
    got = spec.spec_generate(params, CFG, draft, dcfg, _t(REPETITIVE), N, k=3, temperature=0.8,
                             top_k=5, seed=1)
    assert torch.equal(got, spec.positional_generate(params, CFG, _t(REPETITIVE), N,
                                                     temperature=0.8, top_k=5, seed=1))


# ---- the engine's speculative windows ----

SPEC = dict(decode_window=4, spec_ngram=3)


def test_spec_engine_equals_jax_engine_and_greedy(models):
    """Engine(spec_ngram=3, decode_window=4) against JaxEngine with the same
    options, W8A8 prefill and an int8 cache (`tests/test_torch_engine.py`'s
    prompts), and against prefill + decode_loop."""
    jp, tp = models
    budgets = [6, 3, 9, 5]
    eng = Engine(tp, CFG, max_batch=2, max_len=64, prompt_buckets=(4, 16), **SPEC, **KW)
    je = JaxEngine(jp, JCFG, max_batch=2, max_len=64, prompt_buckets=(4, 16), **SPEC, **JKW)
    outs = [eng.add_request(p, n) for p, n in zip(PROMPTS, budgets)]
    juids = [je.add_request(p, n) for p, n in zip(PROMPTS, budgets)]
    eng.run()
    je.run()
    for u, ju, p, n in zip(outs, juids, PROMPTS, budgets):
        assert eng.result(u) == je.result(ju) == _ref_greedy(tp, p, n), (p, n)
    assert set(eng._spec_programs) == {(4, False)}


def test_spec_engine_mixed_lengths_recycle(params):
    """Mixed prompts and budgets through fewer slots than requests."""
    prompts = PROMPTS + [[2, 4, 6, 8], [13, 13, 13]]
    budgets = [6, 3, 9, 5, 7, 4]
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(4, 16), **SPEC, **KW)
    uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
    eng.run()
    for uid, p, n in zip(uids, prompts, budgets):
        assert eng.result(uid) == _ref_greedy(params, p, n), (p, n)


def test_spec_engine_eos_mid_window(params):
    prompt = [3, 17, 42]
    full = _ref_greedy(params, prompt, 12)
    stop = next(i for i in range(3, 12) if full[i] not in full[:i])  # inside the 2nd window
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,), **SPEC, **KW)
    uid = eng.add_request(prompt, max_new_tokens=12, eos_token_id=full[stop])
    eng.run()
    assert eng.result(uid) == full[:stop + 1] and stop + 1 < 12


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_engine_exact_at_the_cache_brim(params, paged):
    """A request that fills max_len = 128 (prompt + budget) at window 8,
    k = 7: the verify writes reach 2k + window past a row's length, which
    the caches' slack (`_kv_len`; paged, the blocks of `_max_seq_blocks`)
    holds; clamped onto committed KV they would change the tokens
    (`tests/test_engine.py:526-554`)."""
    prompt = [3, 17, 42, 9, 3, 17, 42, 11]
    kw = dict(PAGED, paged_blocks=8) if paged else {}
    eng = Engine(params, CFG, max_batch=1, max_len=128, prompt_buckets=(8,), decode_window=8,
                 spec_ngram=7, **kw)
    assert eng._kv_len == 128 + 8 + 15
    uid = eng.add_request(prompt, max_new_tokens=120)
    eng.run()
    assert eng.result(uid) == greedy_generate(params, CFG, torch.tensor([prompt]), 120)[0].tolist()
    if paged:
        assert eng._max_seq_blocks == 2 and sorted(eng._free_blocks) == list(range(1, 8))


def test_spec_engine_paged_equals_dense(params):
    prompts = PROMPTS + [[2, 4, 6, 8]]
    budgets = [6, 3, 9, 5, 7]
    outs = []
    for kw in ({}, PAGED):
        eng = Engine(params, CFG, max_batch=2, max_len=256, prompt_buckets=(16,), **SPEC, **kw)
        outs.append(eng.generate_all(prompts, 7))
        if kw:
            assert sorted(eng._free_blocks) == list(range(1, PAGED["paged_blocks"]))
    assert outs[0] == outs[1]


def test_spec_engine_sampled_output_does_not_depend_on_the_window(params):
    """Sampled requests draw from the positional sampler, keyed by request
    and emission index: the same tokens at window 2 and 4, and equal to the
    greedy request's at top_k = 1."""
    prompts = [[5, 6, 7], [11] * 10]
    outs = []
    for window in (2, 4):
        eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,),
                     decode_window=window, spec_ngram=3, seed=3, **KW)
        us = eng.add_request(prompts[0], 9, temperature=0.9, top_k=8)
        u1 = eng.add_request(prompts[1], 9, temperature=0.9, top_k=1)
        eng.run()
        outs.append((eng.result(us), eng.result(u1)))
        assert (window, True) in eng._spec_programs
    assert outs[0] == outs[1]
    assert outs[0][1] == _ref_greedy(params, prompts[1], 9)


def test_spec_engine_validates_k(params):
    for k in (0, 8, 9):
        with pytest.raises(ValueError, match="spec_ngram"):
            Engine(params, CFG, max_batch=1, max_len=64, spec_ngram=k)
    eng = Engine(params, CFG, max_batch=1, max_len=64, spec_ngram=3, topk_cap=4)
    with pytest.raises(ValueError):  # the top-k cap still applies
        eng.add_request([1, 2], 4, temperature=0.7, top_k=5)


def test_spec_engine_streaming_poll(params):
    prompt = [3, 17, 42, 9]
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,), **SPEC, **KW)
    uid = eng.add_request(prompt, 10)
    got = []
    while eng.has_work:
        eng.step()
        new, done = eng.poll(uid)
        got += new
    assert got == _ref_greedy(params, prompt, 10) and done


def test_spec_engine_warmup_makes_its_programs(params):
    """warmup() makes the programs the serving loop runs: the greedy
    window-1 step and the spec window; sampled, the spec windows of both
    sizes."""
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,), **SPEC, **KW)
    eng.warmup()
    eng.warmup(temperature=0.8)
    assert set(eng._programs) == {(1, False)}
    assert set(eng._spec_programs) == {(4, False), (1, True), (4, True)}
    uid = eng.add_request([3, 17, 42], 6)
    eng.run()
    assert eng.result(uid) == _ref_greedy(params, [3, 17, 42], 6)
