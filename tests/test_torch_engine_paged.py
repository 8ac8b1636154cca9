"""The port's engine over a paged KV cache on a toy model, the counterparts
of `tests/test_paged.py`'s engine tests: greedy outputs of the paged engine
equal the dense engine's, the port's own `prefill` + `decode_loop`, and the
JAX paged engine's token for token; blocks are granted as sequences grow,
recycled between requests and all back on the free list after `run()`.
JAX's weights are carried across with `params_from_numpy`.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.models import ModelConfig as JaxModelConfig
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import init_caches
from eetq_tpu_torch.modules.paged import PagedKVCache
from eetq_tpu_torch.serve.api import EngineServer
from eetq_tpu_torch.serve.engine import Engine
from eetq_tpu_torch.serve.generate import decode_loop, prefill
from test_torch_model import jax_params_to_numpy

# the toy model of tests/test_paged.py
DIMS = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, max_position=512)
CFG, JCFG = ModelConfig(**DIMS), JaxModelConfig(**DIMS)
PAGED = dict(paged_blocks=7, paged_block_size=128)  # ~2 sequences of 3 blocks, and the trash


@pytest.fixture(scope="module")
def models():
    jp = jax_quantize_params(
        jax_random_dense_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    return jp, params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def params(models):
    return models[1]


def _prompts(seed: int, n: int, lo: int = 2, hi: int = 20) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, CFG.vocab_size, size=rng.integers(lo, hi))]
            for _ in range(n)]


def _ref_greedy(params, prompt, n, kv=torch.bfloat16, a8=False):
    caches = init_caches(CFG, 1, len(prompt) + n, device="cpu", dtype=kv)
    logits, caches = prefill(params, CFG, torch.tensor([prompt]), caches, a8=a8)
    return decode_loop(params, CFG, torch.argmax(logits, -1), len(prompt), caches, n)[0][0].tolist()


def _whole(eng: Engine, blocks: int) -> bool:
    """Every block but the trash block is free, no slot holds one, and the
    host table points every row at the trash block."""
    return (sorted(eng._free_blocks) == list(range(1, blocks))
            and not any(eng._slot_blocks) and not eng._table_np.any())


def test_paged_engine_matches_dense_generate_and_jax(models):
    """Six requests through two slots and a pool of six blocks (recycled):
    the paged engine, the dense engine, prefill + decode_loop and the JAX
    paged engine all give the same greedy tokens."""
    jp, tp = models
    prompts = _prompts(0, 6)
    kw = dict(max_batch=2, max_len=256, prompt_buckets=(32,))
    je = JaxEngine(jp, JCFG, **kw, **PAGED)
    pe = Engine(tp, CFG, **kw, **PAGED)
    de = Engine(tp, CFG, **kw)
    assert pe.paged and isinstance(pe.caches[0], PagedKVCache) and not de.paged
    assert all(c.table is pe.caches[0].table for c in pe.caches)  # one table for all layers
    for eng in (je, pe, de):
        for p in prompts:
            eng.add_request(p, 6)
        eng.run()
    for uid, p in enumerate(prompts):
        assert pe.result(uid) == de.result(uid) == _ref_greedy(tp, p, 6), p
        assert pe.result(uid) == je.result(uid), p
    assert _whole(pe, 7) and sorted(je._free_blocks) == sorted(pe._free_blocks)
    pe._sync_tables()
    assert not pe.caches[0].table.any()


def test_paged_engine_multiblock_growth(models):
    """A sequence that crosses a block edge while decoding is granted a new
    block on the fly (120 + 16 tokens over 128-token blocks)."""
    jp, tp = models
    prompt = _prompts(1, 1, 120, 121)[0]
    kw = dict(max_batch=1, max_len=384, prompt_buckets=(128,), paged_blocks=6,
              paged_block_size=128)
    pe = Engine(tp, CFG, **kw)
    uid = pe.add_request(prompt, 16)
    pe.step()
    assert len(pe._slot_blocks[0]) == 1
    while pe.has_work:
        pe.step()
        assert len(pe._slot_blocks[0]) in (0, 1, 2)
    assert pe.result(uid) == _ref_greedy(tp, prompt, 16)
    je = JaxEngine(jp, JCFG, **kw)
    ju = je.add_request(prompt, 16)
    je.run()
    assert pe.result(uid) == je.result(ju)
    assert _whole(pe, 6)


def test_paged_engine_pool_exhaustion(params):
    eng = Engine(params, CFG, max_batch=2, max_len=384, prompt_buckets=(128,), paged_blocks=3,
                 paged_block_size=128)
    eng.add_request(list(range(1, 100)), 250)  # needs 3 blocks; the pool grants 2
    with pytest.raises(RuntimeError, match="pool exhausted"):
        eng.run()


def test_paged_engine_rejects_bad_pool_shapes(params):
    with pytest.raises(ValueError, match="paged_blocks"):
        Engine(params, CFG, max_batch=2, max_len=256, paged_blocks=1, paged_block_size=128)
    with pytest.raises(ValueError, match="exceeds"):  # a block longer than the rounded max_len
        Engine(params, CFG, max_batch=2, max_len=100, paged_blocks=4, paged_block_size=256)
    with pytest.raises(ValueError, match="multiple of 128"):
        Engine(params, CFG, max_batch=2, max_len=256, paged_blocks=4, paged_block_size=64)
    for kw in (dict(prefill_chunk=8),):  # chunked prefill is served, paged or not
        eng = Engine(params, CFG, max_batch=2, max_len=256, **PAGED, **kw)
        assert eng.paged and eng.prefill_chunk == 8


def test_paged_engine_default_kv_is_bf16(params):
    eng = Engine(params, CFG, max_batch=2, max_len=256, **PAGED)
    assert eng.kv_dtype == torch.bfloat16 and not eng.caches[0].quantized
    assert eng.caches[0].k.shape == (7, CFG.num_kv_heads, 128, CFG.head_dim)
    assert eng._max_seq_blocks == 2 and eng.caches[0].table.shape == (2, 2)


def test_paged_engine_int8_pool(models):
    """An int8 pool takes an int8 scratch; with W8A8 prefill the outputs
    equal the dense int8 engine's, prefill + decode_loop's and JAX's."""
    jp, tp = models
    prompts = _prompts(2, 4)
    kw = dict(max_batch=2, max_len=256, prompt_buckets=(32,), a8_prefill=True)
    pe = Engine(tp, CFG, kv_dtype=torch.int8, **kw, **PAGED)
    de = Engine(tp, CFG, kv_dtype=torch.int8, **kw)
    je = JaxEngine(jp, JCFG, kv_dtype=jnp.int8, **kw, **PAGED)
    assert pe.caches[0].quantized and pe.caches[0].k.dtype == torch.int8
    for eng in (pe, de, je):
        for p in prompts:
            eng.add_request(p, 5)
        eng.run()
    for uid, p in enumerate(prompts):
        assert pe.result(uid) == de.result(uid) == _ref_greedy(tp, p, 5, torch.int8, True), p
        assert pe.result(uid) == je.result(uid), p
    assert pe._scratch[0].quantized and _whole(pe, 7)


def test_paged_engine_batched_prefill_rows(params):
    """Four prompts admitted in one forward: every scratch row is cut into
    blocks and scattered at once, rows padded with the trash block."""
    prompts = _prompts(3, 4)
    eng = Engine(params, CFG, max_batch=4, max_len=256, prompt_buckets=(32,), prefill_rows=4,
                 paged_blocks=9, paged_block_size=128)
    outs = eng.generate_all(prompts, max_new_tokens=6)
    for p, got in zip(prompts, outs):
        assert got == _ref_greedy(params, p, 6), p
    assert _whole(eng, 9)


def test_paged_engine_late_arrival_and_eos(params):
    prompt = [3, 17, 42, 9]
    full = _ref_greedy(params, prompt, 8)
    eng = Engine(params, CFG, max_batch=2, max_len=256, prompt_buckets=(32,), **PAGED)
    u1 = eng.add_request(prompt, 8, eos_token_id=full[3])
    for _ in range(2):
        eng.step()
    u2 = eng.add_request([16, 23, 42], 6)
    eng.run()
    assert eng.result(u1) == full[:full.index(full[3]) + 1]
    assert eng.result(u2) == _ref_greedy(params, [16, 23, 42], 6)
    assert _whole(eng, 7)


def test_paged_engine_warmup_then_serve(params):
    kw = dict(max_batch=2, max_len=256, prompt_buckets=(32, 128), **PAGED)
    cold = Engine(params, CFG, **kw)
    u0 = cold.add_request([3, 17, 42], 7)
    cold.run()
    warm = Engine(params, CFG, **kw)
    warm.warmup()
    assert not warm.has_work and not warm.requests and _whole(warm, 7)
    u1 = warm.add_request([3, 17, 42], 7)
    warm.run()
    assert warm.result(u1) == cold.result(u0)


def test_paged_engine_sampled_run_reproducible(params):
    outs = []
    for seed in (7, 7):
        eng = Engine(params, CFG, max_batch=2, max_len=256, seed=seed, **PAGED)
        us = eng.add_request([5, 6, 7], 12, temperature=0.8, top_k=20)
        ug = eng.add_request([1, 2], 6)
        eng.run()
        assert eng.result(ug) == _ref_greedy(params, [1, 2], 6)
        outs.append(eng.result(us))
    assert outs[0] == outs[1] and all(0 <= t < CFG.vocab_size for t in outs[0])


def test_engine_server_over_a_paged_engine(params):
    eng = Engine(params, CFG, max_batch=2, max_len=256, prompt_buckets=(32,), **PAGED)
    srv = EngineServer(eng, host="127.0.0.1", port=0)
    srv.start()
    try:
        answers = []
        for prompt, n in (([3, 17, 42, 9], 6), ([5, 6], 4)):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps({"prompt": prompt, "max_new_tokens": n}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append((prompt, n, json.loads(r.read())["tokens"]))
    finally:
        srv.shutdown()
    for prompt, n, got in answers:
        assert got == _ref_greedy(params, prompt, n)
    assert _whole(eng, 7)
