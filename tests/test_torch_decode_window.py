"""The engine's decode windows and their chaining on the CPU, against the
port's own window-1 engine and the JAX engine at the same window and chain
(`tests/test_engine.py::test_multi_step_decode_window`,
`test_decode_window_chaining`). On the CPU a window's steps run eagerly
(`serve/graph.py`); on the card the same program is a replayed CUDA graph
(`tests/test_torch_gpu.py`, `chip_smoke.py`).

The toy preset with W8A8 prefill and an int8 cache, as in
`tests/test_torch_engine.py`, whose prompts give JAX and the port the same
greedy tokens; the paged case uses the toy model of
`tests/test_torch_engine_paged.py` (blocks of 128 tokens).
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
from eetq_tpu_torch.models.config import PRESETS
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.serve.engine import Engine
from test_torch_engine import KW, _ref_greedy, models, params  # noqa: F401  (fixtures)
from test_torch_engine_paged import CFG as PCFG
from test_torch_engine_paged import JCFG as PJCFG
from test_torch_engine_paged import PAGED
from test_torch_model import jax_params_to_numpy

CFG, JCFG = PRESETS["toy"], JAX_PRESETS["toy"]
JKW = dict(a8_prefill=True, kv_dtype=jnp.int8)


def _prompts(seed: int, n: int, lo: int = 2, hi: int = 14) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, CFG.vocab_size, size=rng.integers(lo, hi))]
            for _ in range(n)]


def _serve(eng, prompts, budgets, **kw) -> tuple[list[list[int]], int]:
    """Every request through `eng`; (outputs in order, step() calls)."""
    uids = [eng.add_request(p, n, **kw) for p, n in zip(prompts, budgets)]
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
    return [eng.result(u) for u in uids], steps


def test_window_equals_window_one_and_jax(models):
    """Six requests through four slots (window 1 while a queued request can
    be admitted, window 4 and chains otherwise): the windowed engine's greedy
    tokens equal the port's window-1 engine's and the JAX engine's at the
    same window and chain."""
    jp, tp = models
    prompts, budgets = _prompts(0, 6), [6, 3, 9, 5, 13, 4]
    kw = dict(max_batch=4, max_len=64, prompt_buckets=(8, 16))
    one, _ = _serve(Engine(tp, CFG, decode_window=1, **kw, **KW), prompts, budgets)
    win, _ = _serve(Engine(tp, CFG, decode_window=4, max_chain=8, **kw, **KW), prompts, budgets)
    jax_out, _ = _serve(JaxEngine(jp, JCFG, decode_window=4, max_chain=8, **kw, **JKW),
                        prompts, budgets)
    assert win == one == jax_out
    assert [len(t) for t in win] == budgets


def test_chaining_engages(params):
    """A full batch, an empty queue and no eos: windows chain, the tokens are
    the unchained engine's, in strictly fewer step() calls."""
    prompts, budgets = [[5, 6, 7], [11] * 10], [33, 40]

    def run(max_chain):
        eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,),
                     decode_window=4, max_chain=max_chain, **KW)
        return _serve(eng, prompts, budgets)

    (ref, steps1), (out, steps8) = run(1), run(8)
    assert out == ref == [_ref_greedy(params, p, n) for p, n in zip(prompts, budgets)]
    assert steps8 < steps1, (steps8, steps1)


def test_eos_mid_window(params):
    """An eos met inside a window ends the request at that token; a request
    queued behind the one slot keeps chaining off and is served exactly."""
    prompt = [3, 17, 42, 9]
    full = _ref_greedy(params, prompt, 12)
    eos = full[5]
    stop = full.index(eos) + 1
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,), decode_window=8,
                 max_chain=8, **KW)
    uid = eng.add_request(prompt, 12, eos_token_id=eos)
    uid2 = eng.add_request([1, 2, 3], 5)
    eng.run()
    assert eng.result(uid) == full[:stop] and stop < 12
    assert eng.result(uid2) == _ref_greedy(params, [1, 2, 3], 5)
    assert not eng.has_work and eng.free_slots == 1


def test_overshoot_at_max_len_is_clamped(models):
    """len(prompt) + max_new_tokens == max_len at window 8: the last chain
    runs the row up to seven steps past the cache's last slot. Those writes
    are clamped (as JAX's dynamic_update_slice clamps them) and never
    committed: the tokens equal the window-1 engine's and JAX's."""
    jp, tp = models
    prompt = _prompts(3, 1, lo=100, hi=101)[0]
    budget = 128 - len(prompt)
    kw = dict(max_batch=1, max_len=128, prompt_buckets=(128,))
    win = Engine(tp, CFG, decode_window=8, max_chain=8, **kw, **KW)
    assert win.caches[0].max_len == 128
    got, _ = _serve(win, [prompt], [budget])
    one, _ = _serve(Engine(tp, CFG, decode_window=1, **kw, **KW), [prompt], [budget])
    jax_out, _ = _serve(JaxEngine(jp, JCFG, decode_window=8, max_chain=8, **kw, **JKW),
                        [prompt], [budget])
    assert got == one == jax_out and len(got[0]) == budget


@pytest.fixture(scope="module")
def paged_params():
    """The toy model of tests/test_torch_engine_paged.py."""
    jp = jax_quantize_params(jax_random_dense_params(PJCFG, jax.random.PRNGKey(0),
                                                     dtype=jnp.bfloat16))
    return params_from_numpy(jax_params_to_numpy(jp), device="cpu")


def test_paged_window_equals_dense_and_frees_every_block(paged_params):
    """A paged engine at window 4 with chains gives the dense windowed
    engine's greedy tokens and frees every block. Alone in a one-slot
    engine, a request of 202 + 54 = max_len tokens runs three steps past the
    table's last slot (53 steps in windows of 4): the writes are clamped,
    and paged and dense still agree."""
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, PCFG.vocab_size, size=n)] for n in (3, 17, 30)]
    budgets = [40, 25, 30]
    kw = dict(max_len=256, prompt_buckets=(32, 256), decode_window=4, max_chain=8)
    for batch, ps, bs in ((2, prompts, budgets), (1, [prompts[0] * 67 + [5]], [54])):
        assert batch == 2 or len(ps[0]) + bs[0] == 256
        pe = Engine(paged_params, PCFG, max_batch=batch, **PAGED, **kw)
        paged, _ = _serve(pe, ps, bs)
        dense, _ = _serve(Engine(paged_params, PCFG, max_batch=batch, **kw), ps, bs)
        assert paged == dense and [len(t) for t in paged] == bs
        assert sorted(pe._free_blocks) == list(range(1, PAGED["paged_blocks"]))
        assert not any(pe._slot_blocks) and not pe._table_np.any()


def test_sampled_windows_reproducible(params):
    """Sampled requests ride the same windows (the sampler runs inside the
    program): right lengths, tokens in range, the same tokens run to run at
    one seed and others at another; a greedy request beside them is exact."""
    outs = []
    for seed in (7, 7, 8):
        eng = Engine(params, CFG, max_batch=2, max_len=64, seed=seed, decode_window=4,
                     max_chain=8, **KW)
        us = eng.add_request([5, 6, 7], 21, temperature=0.8, top_k=20)
        ug = eng.add_request([1, 2], 13)
        eng.run()
        assert eng.result(ug) == _ref_greedy(params, [1, 2], 13)
        got = eng.result(us)
        assert len(got) == 21 and all(0 <= t < CFG.vocab_size for t in got)
        outs.append(got)
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_window_defaults_and_warmup(params):
    """The window defaults to 1 on the CPU (8 on a CUDA device); warmup()
    with a window leaves no visible state."""
    assert Engine(params, CFG, max_batch=2, max_len=64).decode_window == 1
    kw = dict(max_batch=2, max_len=64, prompt_buckets=(8, 16), decode_window=4, **KW)
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
    assert set(warm._programs) == {(1, False), (4, False), (1, True), (4, True)}
