"""The five presets that `chip_smoke.py`'s presets phase first runs at full
width on the card (llama2-13b, llama3-8b, baichuan-7b, tinyllama-1.1b and
llama2-70b at W4A16 g = 128), at toy size against the JAX package on the
CPU.

Each toy is `dataclasses.replace` on the preset, in both packages: 2 layers
and narrow widths, keeping what makes the preset distinct (TOYS): its head
dim (64 for tinyllama), its q/kv head ratio (G = 1, 4, 8), its rope_theta
and max_position, baichuan-7b's model_type with rope and no ALiBi, its
vocabulary cut by 32 (none a power of two), and llama2-70b's int4 g = 128
quantization throughout (an intermediate width of 4 groups). JAX's
quantized parameters (int8 or int4 lm_head) are carried across with
`models/convert.py::params_from_numpy`. Compared:

- every prefill position's logits and teacher-forced decode steps against
  JAX's `forward` (its Pallas kernels in interpret mode), over the KV
  dtypes of the preset's paths on the card, with the fused MLP where its
  decode path fuses it (DECODE);
- the engine's greedy tokens, in the preset's mode on the card (dense or
  paged, the KV dtype, W8A8 or W4A8 admission; ENGINES), against JAX's
  engine in the same mode;
- llama3-8b's rope table at theta 500,000 out to max_position 8192, and
  rope applied with it, against JAX's;
- baichuan-7b's model_type with alibi False runs rope and no slopes.

Tolerances, in bf16 ulps of the largest |logit| of JAX's output (these
toys' logits reach 4-5, where an ulp is 2^-5; the toy model tests'
absolute LOGIT_ATOL of 2e-2 is about an ulp below 4): prefill and
bf16-KV decode two ulps (the bf16 outputs of the quantized lm_head, rounded
at the same bf16 boundaries and summed in other orders, part by up to 1.5
ulps here; the int4 kernels of the two packages also round apart by an ulp
here and there, tests/test_torch_model_int4.py); an int8 cache four (an
ulp that reaches the cache's quantizer comes out as a whole int8 step, two
ulps; tests/test_torch_model_int8.py and _int4.py allow 2^-4 and 2^-3 on
logits of about 4). Engines: the same greedy tokens, or parting where both
tokens lie within TIE_ULPS = 8 bf16 ulps of the top logit of the port's
forward over the common prefix (a near tie: the engines admit with W8A8 or
W4A8, whose int8 activations turn an ulp into a whole step; as
`chip_smoke.py`'s SPEC_TIE_ULPS).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.models import PRESETS as JAX_PRESETS
from eetq_tpu.models import init_caches as jax_init_caches
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.transformer import forward as jax_forward
from eetq_tpu.ops.rope import make_cos_sin_cache as jax_make_cos_sin_cache
from eetq_tpu.ops.rope import rope as jax_rope
from eetq_tpu.serve.engine import Engine as JaxEngine
from eetq_tpu_torch.models.config import PRESETS, ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import forward_inner, init_caches
from eetq_tpu_torch.ops import rope as port_rope
from eetq_tpu_torch.serve.engine import Engine
from test_torch_model import LOGIT_ATOL, jax_params_to_numpy

B, S, STEPS = 2, 12, 4
LOGIT_ULPS, KV8_ULPS, TIE_ULPS = 2, 4, 8
BS = 128  # a paged engine's block

# the toy of each preset: 2 layers and narrow widths; the head dim, the
# group, rope_theta, max_position and model_type stay the preset's
# (llama2-13b's 40 heads of MHA as 5); the vocabulary is the preset's cut by
# 32, still not a power of two (the JAX engine's programs over the real
# 128,256 columns take 35 s to compile and run in interpret mode, 5 s at
# 4,008; the card runs the real heads)
TOYS = {
    "llama2-13b": dict(vocab_size=1000, hidden_size=256, intermediate_size=512, num_heads=5,
                       num_kv_heads=5),
    "llama3-8b": dict(vocab_size=4008, hidden_size=256, intermediate_size=512, num_heads=4,
                      num_kv_heads=1),
    "baichuan-7b": dict(vocab_size=3928, hidden_size=256, intermediate_size=512, num_heads=2,
                        num_kv_heads=2),
    "tinyllama-1.1b": dict(vocab_size=1000, hidden_size=256, intermediate_size=512,
                           num_heads=8, num_kv_heads=1),
    "llama2-70b": dict(vocab_size=1000, hidden_size=256, intermediate_size=512, num_heads=8,
                       num_kv_heads=1),
}
# the quantization of each preset's model on the card: (bits, group size)
QUANT = {name: (8, None) for name in TOYS} | {"llama2-70b": (4, 128)}
# each preset's decode paths on the card: (KV dtype, fused MLP); the engine's
# KV dtype too where it differs from the b=1 path's (tinyllama's int8 pool)
DECODE = {
    "llama2-13b": [("int8", True)],
    "llama3-8b": [("bf16", False)],
    "baichuan-7b": [("int8", True)],
    "tinyllama-1.1b": [("bf16", False), ("int8", False)],
    "llama2-70b": [("int8", False)],
}
# the engine of each preset's path on the card: paged or dense, its KV, and
# W8A8 (W4A8 at int4) admission, the card's default
ENGINES = {
    "llama2-13b": dict(kv="int8", paged=False),
    "llama3-8b": dict(kv="bf16", paged=True),
    "baichuan-7b": dict(kv="int8", paged=False),
    "tinyllama-1.1b": dict(kv="int8", paged=True),
    "llama2-70b": dict(kv="int8", paged=True),
}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "int8": (torch.int8, jnp.int8)}
DECODE_CASES = [(name, kv, fused) for name, runs in DECODE.items() for kv, fused in runs]


def _ulp(x) -> float:
    """One bf16 ulp of the largest |value| of x."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(x)).max())) - 7)


def _close(got: torch.Tensor, want, ulps: int, what: str) -> None:
    """got within `ulps` bf16 ulps of the largest |value| of want."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ulps * _ulp(want),
                               err_msg=what)


def _equal_or_near_tie(tp, cfg, prompt: list, got: list, want: list) -> bool:
    """got == want, or at the first token where they part both lie within
    TIE_ULPS of the top logit of the port's forward over the prompt and the
    common tokens before it. Returns whether they were equal."""
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if first is None:
        assert len(got) == len(want)
        return True
    ids = torch.tensor([prompt + want[:first]])
    with torch.inference_mode():
        logits, _ = forward_inner(tp, cfg, ids, torch.arange(ids.shape[1])[None], None, 0,
                                  last_only=True)
    row = logits[0, -1].numpy()
    gaps = [(row.max() - row[t]) / _ulp(row) for t in (got[first], want[first])]
    assert max(gaps) <= TIE_ULPS, (first, got[first], want[first], gaps)
    return False


def _configs(name: str) -> tuple[ModelConfig, object]:
    kw = dict(TOYS[name], num_layers=2)
    return dataclasses.replace(PRESETS[name], **kw), dataclasses.replace(JAX_PRESETS[name], **kw)


def _prompt(cfg) -> np.ndarray:
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _requests(cfg) -> list[list[int]]:
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, size=n)] for n in (9, 20, 14, 3)]


def _engine_kw(name: str) -> dict:
    kw = dict(max_batch=2, max_len=256, prompt_buckets=(32,), a8_prefill=True)
    if ENGINES[name]["paged"]:
        kw.update(paged_blocks=7, paged_block_size=BS)
    return kw


def _jax_preset(name: str) -> dict:
    """JAX's side of a preset: its quantized toy, the logits of every
    prefill position and of STEPS teacher-forced decode steps on its own
    greedy tokens for each of DECODE's runs (with those tokens), and its
    engine's greedy outputs on _requests in ENGINES' mode."""
    _, jcfg = _configs(name)
    bits, group = QUANT[name]
    jp = jax_quantize_params(jax_random_dense_params(jcfg, jax.random.PRNGKey(0)), bits=bits,
                             quantize_lm_head=True, group_size=group)
    fwd = jax.jit(jax_forward, static_argnums=1, static_argnames=("fused_mlp",))
    prompt = _prompt(jcfg)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    runs = {}
    for kv, fused in DECODE[name]:
        caches = jax_init_caches(jcfg, B, S + STEPS, dtype=DTYPES[kv][1])
        logits, caches = fwd(jp, jcfg, jnp.asarray(prompt), jnp.asarray(pos), caches, 0)
        steps, tokens = [np.asarray(logits)], []
        for i in range(STEPS):
            tokens.append(np.asarray(jnp.argmax(logits[:, -1], -1)).astype(np.int32))
            logits, caches = fwd(jp, jcfg, jnp.asarray(tokens[-1][:, None]),
                                 jnp.full((B, 1), S + i, jnp.int32), caches, jnp.int32(S + i),
                                 fused_mlp=fused)
            steps.append(np.asarray(logits))
        runs[kv] = steps, tokens
    eng = JaxEngine(jp, jcfg, kv_dtype=DTYPES[ENGINES[name]["kv"]][1], **_engine_kw(name))
    for p in _requests(jcfg):
        eng.add_request(p, 10)
    eng.run()
    return dict(params=jp, runs=runs, engine=[eng.result(u) for u in range(4)])


@pytest.fixture(scope="module")
def models():
    """{preset: (port config, JAX's side (`_jax_preset`), the port's
    params carried across)}. JAX's sides run one thread a preset: XLA
    compiles its programs outside the GIL, and JAX's side of a preset does
    not depend on the port's."""
    with ThreadPoolExecutor(len(TOYS)) as pool:
        sides = dict(zip(TOYS, pool.map(_jax_preset, TOYS)))
    return {name: (_configs(name)[0], side,
                   params_from_numpy(jax_params_to_numpy(side["params"]), device="cpu"))
            for name, side in sides.items()}


@pytest.mark.parametrize("name", list(TOYS))
def test_toy_keeps_what_makes_the_preset_distinct(name):
    """The toy is the preset but for depth and widths, the same config in
    both packages, and the real preset is what the card runs."""
    cfg, jcfg = _configs(name)
    real = PRESETS[name]
    assert cfg.__dict__ == jcfg.__dict__
    for field in ("head_dim", "rope_theta", "max_position", "model_type", "alibi",
                  "rms_eps", "activation", "sliding_window"):
        assert getattr(cfg, field) == getattr(real, field), field
    assert cfg.num_heads // cfg.num_kv_heads == real.num_heads // real.num_kv_heads
    assert cfg.vocab_size == real.vocab_size // 32
    assert cfg.vocab_size & (cfg.vocab_size - 1) and real.vocab_size & (real.vocab_size - 1)
    bits, group = QUANT[name]
    if group:  # every K a whole number of groups: hidden, Hq D and I
        assert not (cfg.hidden_size % group or cfg.num_heads * cfg.head_dim % group
                    or cfg.intermediate_size % group)


@pytest.mark.parametrize("name,kv,fused", DECODE_CASES,
                         ids=[f"{n}-{kv}{'-fused' if f else ''}" for n, kv, f in DECODE_CASES])
def test_prefill_and_decode_logits_match_jax(models, name, kv, fused):
    """Every position's prefill logits over the preset's KV dtype, then
    teacher-forced decode steps on JAX's greedy tokens (fused MLP where the
    preset's decode path fuses it), against JAX's forward."""
    cfg, side, tp = models[name]
    want, tokens = side["runs"][kv]
    caches = init_caches(cfg, B, S + STEPS, device="cpu", dtype=DTYPES[kv][0])
    with torch.inference_mode():
        logits, _ = forward_inner(tp, cfg, torch.from_numpy(_prompt(cfg)).long(),
                                  torch.arange(S).expand(B, S), caches, 0)
        assert logits.shape == (B, S, cfg.vocab_size)
        _close(logits, want[0], LOGIT_ULPS, f"{name} prefill")
        for i, token in enumerate(tokens):
            logits, _ = forward_inner(tp, cfg, torch.from_numpy(token[:, None]).long(),
                                      torch.full((B, 1), S + i), caches, torch.full((B,), S + i),
                                      fused_mlp=fused)
            _close(logits, want[i + 1], KV8_ULPS if kv == "int8" else LOGIT_ULPS,
                   f"{name} decode step {i}")


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_greedy_tokens_match_jax_engine(models, name):
    """Four requests through two slots of the engine in the preset's mode
    on the card (dense int8 cache or a paged pool; W8A8 admission, W4A8 at
    int4), slots and blocks recycled: the port's greedy tokens are JAX's
    engine's in the same mode, or part from them at a near tie."""
    cfg, side, tp = models[name]
    e = ENGINES[name]
    eng = Engine(tp, cfg, kv_dtype=DTYPES[e["kv"]][0], **_engine_kw(name))
    assert eng.a8_prefill and eng.paged == e["paged"]
    assert eng.caches[0].quantized == (e["kv"] == "int8")
    prompts = _requests(cfg)
    for p in prompts:
        eng.add_request(p, 10)
    eng.run()
    for uid, p in enumerate(prompts):
        _equal_or_near_tie(tp, cfg, p, eng.result(uid), side["engine"][uid])
    if e["paged"]:
        assert sorted(eng._free_blocks) == list(range(1, 7))


def test_llama3_rope_table_matches_jax_at_theta_500000():
    """llama3-8b's cos/sin table at rope_theta 500,000 over its 8192
    positions against JAX's (both in f32: the angles t * inv_freq of the
    last positions reach 8191 rad, where one ulp of the angle is 2^-11 and
    the two libraries' cos/sin and pow may part by an ulp or two of it), and
    rope applied at positions up to 8191 against JAX's rope."""
    cfg = PRESETS["llama3-8b"]
    assert cfg.rope_theta == 500000.0 and cfg.max_position == 8192
    got = port_rope.make_cos_sin_cache(cfg.max_position, cfg.rot_dim, base=cfg.rope_theta,
                                       device="cpu")
    want = np.asarray(jax_make_cos_sin_cache(cfg.max_position, cfg.rot_dim, base=cfg.rope_theta))
    assert got.shape == want.shape == (8192, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[:2048].numpy(), want[:2048], rtol=0, atol=5e-4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 4, 128)).astype(np.float32)
    positions = np.array([[0, 1, 4095, 4096, 8190, 8191], [7, 100, 2047, 5000, 6000, 8000]])
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    out_t = port_rope.rope(xt, torch.from_numpy(positions), got)
    out_j = jax_rope(xj, jnp.asarray(positions, jnp.int32), jnp.asarray(want))
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32), rtol=0,
                               atol=2.0 ** -6 * 4)


def test_baichuan_7b_runs_rope_and_no_alibi(models):
    """model_type "baichuan" with alibi False (baichuan-7b) is a rope model:
    its config (also from its HF config.json keys) carries no ALiBi, and its
    logits are not those of the same weights under ALiBi."""
    cfg, _, tp = models["baichuan-7b"]
    assert cfg.model_type == "baichuan" and not cfg.alibi
    hf = dict(model_type="baichuan", vocab_size=125696, hidden_size=4096,
              intermediate_size=11008, num_hidden_layers=32, num_attention_heads=32,
              max_position_embeddings=4096, rms_norm_eps=1e-6)
    assert not ModelConfig.from_hf_config(hf).alibi
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, S))).long()
    pos = torch.arange(S)[None]
    with torch.inference_mode():
        rope_logits, _ = forward_inner(tp, cfg, prompt, pos, None, 0)
        alibi_logits, _ = forward_inner(tp, dataclasses.replace(cfg, alibi=True), prompt, pos,
                                        None, 0)
    assert torch.equal(rope_logits[:, 0], alibi_logits[:, 0])  # position 0: neither moves it
    assert not torch.allclose(rope_logits[:, 1:], alibi_logits[:, 1:], atol=LOGIT_ATOL)
