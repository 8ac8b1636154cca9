"""The port's continuous-batching engine on the TOY preset, with W8A8
prefill and an int8 KV cache passed explicitly (the defaults it takes on a
CUDA device). It mirrors `tests/test_engine.py`: on the CPU the engine's
greedy outputs equal the port's own `prefill(..., a8=True)` followed by
`decode_loop` over a cache of the same dtype (the property the JAX engine
states at `eetq_tpu/serve/engine.py:21-22`), and equal the JAX engine's
token for token at the fixed seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.models.config import PRESETS, ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.init import quantize_params, random_dense_params
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.serve.generate import decode_loop, prefill
from eetq_tpu_torch.serve.sampling import rng_state, sample_rows
from test_torch_model import jax_params_to_numpy

CFG = PRESETS["toy"]
KW = dict(a8_prefill=True, kv_dtype=torch.int8)
PROMPTS = [[5, 6, 7], [11] * 10, [1, 2], [99, 42, 7, 7, 7, 7]]
BUDGETS = [6, 3, 9, 5]


@pytest.fixture(scope="module")
def models():
    jp = jax_quantize_params(
        jax_random_dense_params(JAX_PRESETS["toy"], jax.random.PRNGKey(0)), quantize_lm_head=True
    )
    return jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def params(models):
    return models[1]


def _ref_greedy(params, prompt, n, cfg=CFG, kv=torch.int8):
    """prefill(a8=True) + decode_loop over a cache of the engine's dtype."""
    caches = init_caches(cfg, 1, len(prompt) + n, dtype=kv, device="cpu")
    logits, caches = prefill(params, cfg, torch.tensor([prompt]), caches, a8=True)
    return decode_loop(params, cfg, torch.argmax(logits, -1), len(prompt), caches, n)[0][0].tolist()


def test_single_request_matches_prefill_and_decode_loop(params):
    prompt = [3, 17, 42, 9]
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(8, 16), **KW)
    uid = eng.add_request(prompt, max_new_tokens=8)
    eng.run()
    assert eng.result(uid) == _ref_greedy(params, prompt, 8)
    assert eng.caches[0].quantized and not eng.has_work


def test_mixed_lengths_and_budgets(params):
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(4, 16), **KW)
    uids = [eng.add_request(p, n) for p, n in zip(PROMPTS, BUDGETS)]
    eng.run()
    for uid, p, n in zip(uids, PROMPTS, BUDGETS):
        assert eng.result(uid) == _ref_greedy(params, p, n), (p, n)


def test_greedy_matches_jax_engine(models):
    """The same requests through the JAX engine (its Pallas kernels in
    interpret mode) and the port's, both W8A8 prefill and int8 KV."""
    jp, tp = models
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, CFG.vocab_size, size=rng.integers(2, 14))]
               for _ in range(6)]
    budgets = [6, 3, 9, 5, 7, 4]
    je = JaxEngine(jp, JAX_PRESETS["toy"], max_batch=4, max_len=64, prompt_buckets=(8, 16),
                   a8_prefill=True, kv_dtype=jnp.int8)
    te = Engine(tp, CFG, max_batch=4, max_len=64, prompt_buckets=(8, 16), **KW)
    for eng in (je, te):
        for p, n in zip(prompts, budgets):
            eng.add_request(p, n)
        eng.run()
    for uid in range(len(prompts)):
        assert te.result(uid) == je.result(uid), prompts[uid]


def test_more_requests_than_slots_recycles(params):
    """8 requests through 2 slots: admitted as slots free up, exact outputs."""
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, CFG.vocab_size, size=rng.integers(2, 12))) for _ in range(8)]
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,), **KW)
    uids = [eng.add_request(p, 5) for p in prompts]
    assert eng.free_slots == 2
    eng.run()
    for uid, p in zip(uids, prompts):
        assert eng.result(uid) == _ref_greedy(params, [int(t) for t in p], 5)
    assert eng.free_slots == 2


def test_late_arrival(params):
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(8,), **KW)
    u1 = eng.add_request([4, 8, 15], max_new_tokens=10)
    for _ in range(4):
        eng.step()
    u2 = eng.add_request([16, 23, 42], max_new_tokens=6)
    eng.run()
    assert eng.result(u1) == _ref_greedy(params, [4, 8, 15], 10)
    assert eng.result(u2) == _ref_greedy(params, [16, 23, 42], 6)


def test_eos_frees_slot(params):
    prompt = [3, 17, 42, 9]
    full = _ref_greedy(params, prompt, 8)
    eos = full[3]
    stop = full.index(eos) + 1
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,), **KW)
    uid = eng.add_request(prompt, max_new_tokens=8, eos_token_id=eos)
    eng.run()
    assert eng.result(uid) == full[:stop]
    assert not eng.has_work and eng.free_slots == 1


def test_many_kv_heads_small_bucket():
    """The slot insert copies the sequence axis of [B, H, L, D] (and of the
    int8 scales [B, H, L]): 8 kv heads against a prompt bucket of 4."""
    cfg = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=8, num_kv_heads=8, head_dim=8, max_position=128)
    p = quantize_params(random_dense_params(cfg, torch.Generator().manual_seed(1)))
    eng = Engine(p, cfg, max_batch=2, max_len=64, prompt_buckets=(4, 16), **KW)
    uid = eng.add_request([3, 17, 42], max_new_tokens=6)
    eng.run()
    assert eng.result(uid) == _ref_greedy(p, [3, 17, 42], 6, cfg=cfg)


def test_overflow_and_unported_options_rejected(params):
    eng = Engine(params, CFG, max_batch=1, max_len=32, **KW)
    with pytest.raises(ValueError):
        eng.add_request(list(range(1, 30)), max_new_tokens=10)
    with pytest.raises(ValueError):
        eng.add_request([], max_new_tokens=1)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError):  # top_k above the engine's cap
        eng.add_request([1, 2], 4, temperature=0.7, top_k=eng.topk_cap + 1)
    with pytest.raises(ValueError, match="adapter banks"):  # no LoRA banks on this model
        eng.add_request([1, 2], 4, lora_id=1)
    for kw in (dict(prefill_chunk=8),):  # chunked prefill is served (test_torch_chunked_prefill.py)
        assert Engine(params, CFG, max_batch=2, max_len=64, **kw).prefill_chunk == 8
    with pytest.raises(ValueError):  # a chunk of no token
        Engine(params, CFG, max_batch=2, max_len=64, prefill_chunk=0)
    with pytest.raises(TypeError, match="ShardedModel"):  # no cfg: a sharded model only
        Engine(params)
    with pytest.raises(ValueError):
        Engine(params, CFG, max_batch=3, prefill_rows=2)


def test_defaults_follow_the_device(params):
    """On the CPU both accelerator defaults stay off (as JAX's off the TPU);
    a caller may pass either."""
    eng = Engine(params, CFG, max_batch=2, max_len=1024)
    assert not eng.a8_prefill and eng.kv_dtype == torch.bfloat16
    assert not eng.caches[0].quantized
    eng = Engine(params, CFG, max_batch=2, max_len=64, a8_prefill=True)
    assert eng.a8_prefill and eng.kv_dtype == torch.bfloat16


def test_sampled_top_k1_equals_greedy(params):
    """top_k=1 keeps only the argmax, so a sampled request reproduces the
    greedy output, next to a greedy request in the same batch."""
    prompts = [[5, 6, 7], [11] * 10]
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,), **KW)
    us = eng.add_request(prompts[0], 8, temperature=0.9, top_k=1)
    ug = eng.add_request(prompts[1], 8)
    eng.run()
    assert eng.result(us) == _ref_greedy(params, prompts[0], 8)
    assert eng.result(ug) == _ref_greedy(params, prompts[1], 8)


def test_sampled_run_reproducible(params):
    outs = []
    for seed in (7, 7, 8):
        eng = Engine(params, CFG, max_batch=2, max_len=64, seed=seed, **KW)
        us = eng.add_request([5, 6, 7], 12, temperature=0.8, top_k=20)
        ug = eng.add_request([1, 2], 6)
        eng.run()
        assert eng.result(ug) == _ref_greedy(params, [1, 2], 6)
        assert all(0 <= t < CFG.vocab_size for t in eng.result(us))
        outs.append(eng.result(us))
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_sample_rows_top_k():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 3.0]] * 3)
    rng = rng_state(0, "cpu")
    temps, topks = torch.tensor([0.0, 1.0, 1.0]), torch.tensor([0, 2, 0])
    seen = set()
    for _ in range(50):
        t = sample_rows(logits, temps, topks, 4, rng)
        assert t[0] == 1 and int(t[1]) in (1, 2)
        seen.add(int(t[2]))
    assert len(seen) > 2  # the unfiltered row draws beyond the top 2


def test_batched_prefill_rows(params):
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(16,), prefill_rows=4, **KW)
    outs = eng.generate_all(PROMPTS, max_new_tokens=6)
    for p, got in zip(PROMPTS, outs):
        assert got == _ref_greedy(params, p, 6), p


def test_prompt_longer_than_largest_bucket(params):
    """A prompt past the largest bucket prefills at max_len: the scratch
    grows to it."""
    long_prompt = [int(t) for t in np.random.default_rng(7).integers(1, CFG.vocab_size, size=40)]
    eng = Engine(params, CFG, max_batch=2, max_len=96, prompt_buckets=(8, 16), **KW)
    short = eng.add_request([3, 4, 5], 4)
    eng.step()
    uid = eng.add_request(long_prompt, 5)
    eng.run()
    assert eng.result(uid) == _ref_greedy(params, long_prompt, 5)
    assert eng.result(short) == _ref_greedy(params, [3, 4, 5], 4)


def test_warmup_then_serve(params):
    kw = dict(max_batch=2, max_len=64, prompt_buckets=(8, 16), **KW)
    cold = Engine(params, CFG, **kw)
    u0 = cold.add_request([3, 17, 42], 7)
    cold.run()
    warm = Engine(params, CFG, **kw)
    warm.warmup()
    assert not warm.has_work and not warm.requests
    u1 = warm.add_request([3, 17, 42], 7)
    warm.run()
    assert warm.result(u1) == cold.result(u0)
    warm.warmup(temperature=0.7)


def test_on_token_and_poll(params):
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(8,), **KW)
    got = []
    uid = eng.add_request([3, 17, 42], 6, on_token=lambda u, t: got.append((u, t)))
    uid2 = eng.add_request([5, 6, 7, 8], 4)
    polled, done = [], False
    while eng.has_work:
        eng.step()
        new, done = eng.poll(uid2)
        polled.extend(new)
    assert [t for _, t in got] == eng.result(uid) and all(u == uid for u, _ in got)
    assert done and polled == eng.result(uid2)
    assert eng.poll(uid2) == ([], True)
    with pytest.raises(ValueError):  # not finished
        eng.result(eng.add_request([1], 2))
