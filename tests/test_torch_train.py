"""LoRA finetuning's backward passes of the port against the JAX package:
the dequantizing linear (`ops/linear.py::DequantMatmul` against `jax.grad`
through `eetq_tpu.ops.linear.w8a16_matmul`), the flash-attention
(`kernels/flash_attention.py::FlashAttention` and
`flash_attention_bwd_ref` against `jax.grad` through the JAX package's
Pallas kernel in interpret mode, and against its `_bwd_chunked`), the
model's LoRA gradients through `forward_inner` against `jax.grad` of JAX's
`forward` (as `tests/test_flash_attention.py::test_lora_backward_flash_s1024`
does, at S = 96), and the entry points without a backward, which raise
under grad.

The inputs are numpy arrays from seeded generators, bf16 values on both
sides. XLA's CPU backend has no bf16 batched dot to f32, so JAX takes the
exact bf16 values of x in f32 where scales are group-wise, and its dx then
skips the final rounding to bf16.

Tolerances, each the largest error over the largest reference value (a
bf16 ulp of the largest is at most 2^-7 of it):
- dx and dgamma: 2^-6, two bf16 ulps of the largest at least. The port's dx
  is one bf16 product of the rounded cotangent and a bf16 copy of
  dequant(W) with f32 accumulation; JAX's is f32 throughout, rounded once.
- dscales, dbias, dresidual: 2^-7, one bf16 ulp of the largest (dbias and
  dresidual are bf16 roundings of f32 sums taken in another order; dscales
  are f32 sums of the same products).
- the attention's dq, dk, dv against `jax.grad`: 2^-6; the plain backward
  against `_bwd_chunked` on the same inputs: 2^-7 (the same f32 math, each
  rounded once to bf16).
- the model's LoRA gradients: 5e-2, the JAX test's own bound
  (`tests/test_flash_attention.py:194-197`), against JAX and against the
  port's plain path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eetq_tpu.kernels.flash_attention import _bwd_chunked
from eetq_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from eetq_tpu.layout import pack_weights as jax_pack_weights
from eetq_tpu.models import quantize_params as jax_quantize_params
from eetq_tpu.models import random_dense_params as jax_random_dense_params
from eetq_tpu.models.transformer import forward as jax_forward
from eetq_tpu.modules.linear import LoraAdapter as JaxLora
from eetq_tpu.ops.linear import w8a16_matmul as jax_w8a16_matmul
from eetq_tpu.quant.quantizer import symmetric_quantize as jax_symmetric_quantize
from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_bwd_ref
from eetq_tpu_torch.kernels.flash_decode import (
    flash_decode,
    flash_decode_int8,
    paged_flash_decode,
    paged_flash_decode_int8,
)
from eetq_tpu_torch.kernels.mlp_fused import fused_mlp_gemv, fused_mlp_gemv_i4
from eetq_tpu_torch.kernels.w8a8 import w4a8_gemm, w8a8_gemm
from eetq_tpu_torch.kernels.w8a16 import (
    w4a16_expert_gemv,
    w4a16_grouped_gemm,
    w8a16_expert_gemv,
    w8a16_gemm,
    w8a16_grouped_gemm,
)
from eetq_tpu_torch.layout.tiling import pack_weights
from eetq_tpu_torch.models.config import ModelConfig
from eetq_tpu_torch.models.convert import params_from_numpy
from eetq_tpu_torch.models.transformer import forward_inner
from eetq_tpu_torch.ops.linear import w8a16_matmul
from test_torch_model import jax_params_to_numpy

K, N = 256, 192
WEIGHTS = [(8, None), (8, 64), (4, None), (4, 64)]  # (bits, group size)
# (activation, residual mode, prenorm): each activation, add and mul, with
# and without the norm
EPILOGUES = [(None, None, True), ("relu", "add", False), ("gelu", "mul", True),
             ("silu", "mul", False), ("silu", "add", True)]
ROWS = [3, 40]  # the GEMV regime (m <= 8) and the GEMM's
TOL_DX, TOL_EXACT = 2.0**-6, 2.0**-7


def _bf16(a) -> np.ndarray:
    """a's values rounded to bf16, held in f32."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _close(got, want, tol: float, what: str) -> None:
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0, f"{what}: the reference gradient is zero"
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: error {err:.3e} of {scale:.3e} (tol {tol})"


# ---- the dequantizing linear ----

@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("act,mode,prenorm", EPILOGUES)
@pytest.mark.parametrize("bits,group", WEIGHTS)
def test_linear_grads_match_jax(bits, group, act, mode, prenorm, m):
    rng = np.random.default_rng(bits * 1000 + (group or 0) * 10 + m)
    q, s = jax_symmetric_quantize(jnp.asarray(rng.standard_normal((K, N)) / 16, jnp.float32),
                                  bits=bits, group_size=group)
    q, s = np.asarray(q), np.asarray(s)
    leaves = {"x": _bf16(rng.standard_normal((m, K))), "scales": s,
              "bias": _bf16(rng.standard_normal(N))}
    if mode is not None:
        leaves["residual"] = _bf16(rng.standard_normal((m, N)))
    if prenorm:
        leaves["gamma"] = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    gout = rng.standard_normal((m, N)).astype(np.float32)
    names = list(leaves)
    kw = dict(activation=act, residual_mode=mode or "add")

    def jax_loss(*vals):
        v = dict(zip(names, vals))
        out = jax_w8a16_matmul(v["x"], jax_pack_weights(jnp.asarray(q), bits=bits), v["scales"],
                               bias=v["bias"], residual=v.get("residual"),
                               prenorm_gamma=v.get("gamma"), **kw)
        return jnp.sum(out.astype(jnp.float32) * gout)

    x_dtype = jnp.bfloat16 if group is None else jnp.float32
    dtypes = {"x": x_dtype, "scales": jnp.float32, "bias": jnp.bfloat16,
              "residual": jnp.bfloat16, "gamma": jnp.float32}
    want = jax.grad(jax_loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(leaves[n], dtypes[n]) for n in names))

    t_dtypes = dict(dtypes, x=jnp.bfloat16)
    t = {n: torch.tensor(leaves[n]).to(torch.bfloat16 if t_dtypes[n] == jnp.bfloat16
                                            else torch.float32).requires_grad_()
         for n in names}
    out = w8a16_matmul(t["x"], pack_weights(torch.tensor(q), bits=bits), t["scales"],
                       bias=t["bias"], residual=t.get("residual"), prenorm_gamma=t.get("gamma"),
                       **kw)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "DequantMatmulBackward"
    out.float().backward(torch.from_numpy(gout))
    for n, w in zip(names, want):
        assert t[n].grad.dtype == t[n].dtype
        _close(t[n].grad, w, TOL_DX if n in ("x", "gamma") else TOL_EXACT, n)


def test_linear_without_grad_is_the_kernel_call():
    """Under no_grad, inference_mode, or with no input requiring grad, the call
    is the kernel's alone: no autograd node."""
    q = torch.randint(-127, 128, (K, N), dtype=torch.int8)
    pw, s = pack_weights(q), torch.rand(N) / 100
    x = torch.randn(4, K).bfloat16()
    assert w8a16_matmul(x, pw, s).grad_fn is None
    with torch.no_grad():
        assert w8a16_matmul(x.requires_grad_(), pw, s).grad_fn is None
    with torch.inference_mode():
        assert w8a16_matmul(x, pw, s).grad_fn is None


# ---- the flash-attention ----

# (batch, Sq, Skv, Hq, Hkv, D, window, ALiBi)
FLASH_CASES = [
    (1, 96, 96, 4, 4, 64, None, False),  # causal, group 1
    (2, 64, 64, 8, 2, 128, None, False),  # group 4, D 128
    (1, 40, 300, 4, 1, 64, None, False),  # the last query on the last key: delta 260, two chunks
    (1, 96, 96, 4, 4, 64, 32, False),  # a sliding window
    (1, 80, 80, 4, 1, 64, None, True),  # ALiBi, group 4
    (1, 64, 320, 2, 2, 128, 100, True),  # window and ALiBi over two chunks
]


def _flash_inputs(case, seed: int):
    b, sq, skv, hq, hkv, d, _, alibi = case
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((b, sq, hq, d)))
    k = _bf16(rng.standard_normal((b, skv, hkv, d)))
    v = _bf16(rng.standard_normal((b, skv, hkv, d)))
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    slopes = (2.0 ** -np.arange(1, hq + 1)).astype(np.float32) if alibi else None
    return q, k, v, do, slopes


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_bwd_ref_matches_bwd_chunked(case):
    """The plain backward against the JAX package's `_bwd_chunked` on the
    same q, k, v, output (the port's plain forward's) and output gradient."""
    window = case[6]
    q, k, v, do, slopes = _flash_inputs(case, 1)
    out = flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), window=window,
                          slopes=None if slopes is None else torch.from_numpy(slopes))
    out = out.float().numpy()
    scale = q.shape[-1] ** -0.5
    want = _bwd_chunked(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                        None if slopes is None else jnp.asarray(slopes),
                        jnp.asarray(out, jnp.bfloat16), jnp.asarray(do, jnp.bfloat16), True,
                        window, scale)
    got = flash_attention_bwd_ref(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v, out, do)), causal=True, scale=scale,
        window=window, slopes=None if slopes is None else torch.from_numpy(slopes))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        _close(g, np.asarray(w.astype(jnp.float32)), TOL_EXACT, name)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_grads_match_jax(case):
    """`FlashAttention` (the plain forward on the CPU, the backward the card
    runs) against `jax.grad` through the Pallas kernel in interpret mode and
    its custom VJP; the ALiBi slopes get a zero gradient in both."""
    window = case[6]
    q, k, v, do, slopes = _flash_inputs(case, 2)
    args = [q, k, v] + ([] if slopes is None else [slopes])

    def jax_loss(*a):
        out = jax_flash_attention(*a[:3], window=window, slopes=a[3] if len(a) > 3 else None,
                                  block_q=64, block_kv=64)
        return jnp.sum(out.astype(jnp.float32) * do)

    want = jax.grad(jax_loss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a, jnp.bfloat16) for a in args[:3]), *map(jnp.asarray, args[3:]))
    t = [torch.from_numpy(a).bfloat16().requires_grad_() for a in args[:3]]
    t += [torch.from_numpy(a).requires_grad_() for a in args[3:]]
    out = flash_attention(*t[:3], window=window, slopes=t[3] if len(t) > 3 else None)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.float().backward(torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), t, want):
        _close(g.grad, np.asarray(w.astype(jnp.float32)), TOL_DX, name)
    if slopes is not None:
        assert not np.asarray(want[3]).any() and not t[3].grad.any()


# ---- the model: LoRA gradients through forward_inner ----

CFG = ModelConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=2, head_dim=16, max_position=128)
RANK, SEQ = 4, 96
MODEL_TOL = 5e-2


def _adapter(rng, k: int, n: int) -> dict:
    return {"lora_a": _bf16(0.02 * rng.standard_normal((k, RANK))),
            "lora_b": _bf16(0.02 * rng.standard_normal((RANK, n))), "scaling": 1.0}


@pytest.fixture(scope="module")
def lora_models():
    jp = jax_quantize_params(jax_random_dense_params(CFG, jax.random.PRNGKey(0),
                                                     dtype=jnp.float32))
    rng = np.random.default_rng(3)
    qkv_out = (CFG.num_heads + 2 * CFG.num_kv_heads) * CFG.head_dim
    ads = [dict(qkv=_adapter(rng, CFG.hidden_size, qkv_out),
                o=_adapter(rng, CFG.num_heads * CFG.head_dim, CFG.hidden_size))
           for _ in range(CFG.num_layers)]
    tree = jax_params_to_numpy(jp)
    tree["layers"] = [dict(lt, qkv_lora=ad["qkv"], o_lora=ad["o"])
                      for lt, ad in zip(tree["layers"], ads)]
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (1, SEQ))
    return jp, ads, tree, toks


def _jax_lora_grads(jp, ads, toks) -> list[np.ndarray]:
    """jax.grad of mean(logits^2) w.r.t. every adapter's A and B, as the JAX
    test takes it, with the Pallas kernels in interpret mode."""
    def jlora(d):
        return JaxLora(lora_a=jnp.asarray(d["lora_a"], jnp.bfloat16),
                       lora_b=jnp.asarray(d["lora_b"], jnp.bfloat16), scaling=d["scaling"])

    loras = [(jlora(ad["qkv"]), jlora(ad["o"])) for ad in ads]
    pos = jnp.arange(SEQ, dtype=jnp.int32)[None]

    def loss(loras):
        layers = [dataclasses.replace(lp, qkv_lora=a, o_lora=b)
                  for lp, (a, b) in zip(jp.layers, loras)]
        logits, _ = jax_forward(dataclasses.replace(jp, layers=layers), CFG,
                                jnp.asarray(toks, jnp.int32), pos, None, jnp.int32(0))
        return jnp.mean(logits.astype(jnp.float32) ** 2)

    grads = jax.grad(loss)(loras)
    return [np.asarray(getattr(ad, name).astype(jnp.float32))
            for pair in grads for ad in pair for name in ("lora_a", "lora_b")]


def _port_lora_grads(params, toks, use_kernels: bool) -> list[torch.Tensor]:
    leaves = [getattr(ad, name).requires_grad_() for lp in params.layers
              for ad in (lp.qkv_lora, lp.o_lora) for name in ("lora_a", "lora_b")]
    logits, _ = forward_inner(params, CFG, torch.from_numpy(toks), torch.arange(SEQ)[None], None,
                              0, use_kernels=use_kernels)
    return torch.autograd.grad(logits.pow(2).mean(), leaves)


def test_lora_grads_match_jax(lora_models):
    """Every adapter tensor of both layers: nonzero, within MODEL_TOL of
    jax.grad of JAX's forward, and of the port's plain path."""
    jp, ads, tree, toks = lora_models
    want = _jax_lora_grads(jp, ads, toks)
    got = _port_lora_grads(params_from_numpy(tree, device="cpu"), toks, True)
    plain = _port_lora_grads(params_from_numpy(tree, device="cpu"), toks, False)
    assert len(got) == len(want) == 4 * CFG.num_layers
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        assert g.dtype == torch.bfloat16 and g.abs().sum() > 0, i
        _close(g, w, MODEL_TOL, f"adapter tensor {i} against JAX")
        _close(g, p.float().numpy(), MODEL_TOL, f"adapter tensor {i} against the plain path")


def test_lora_sgd_step_lowers_the_loss(lora_models):
    """A few plain SGD steps on the adapters through the kernel path lower
    the next-token cross-entropy of the batch they train on."""
    _, _, tree, toks = lora_models
    params = params_from_numpy(tree, device="cpu")
    leaves = [getattr(ad, name).requires_grad_() for lp in params.layers
              for ad in (lp.qkv_lora, lp.o_lora) for name in ("lora_a", "lora_b")]
    tt = torch.from_numpy(toks)
    losses = []
    for _ in range(4):
        logits, _ = forward_inner(params, CFG, tt, torch.arange(SEQ)[None], None, 0)
        loss = torch.nn.functional.cross_entropy(logits[0, :-1], tt[0, 1:])
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t -= 2.0 * g
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses


# ---- the entry points without a backward ----

def _refusals():
    """(name, call) of every kernel entry point without a backward, each
    called with an input that requires grad (the plain versions run here)."""
    x = torch.randn(2, 128).bfloat16().requires_grad_()
    q8 = torch.randint(-127, 128, (128, 128), dtype=torch.int8)
    s = torch.rand(128) / 100
    xq, sx = torch.randint(-127, 128, (2, 128), dtype=torch.int8), torch.rand(2).requires_grad_()
    bank = torch.randint(-8, 8, (2, 128, 128), dtype=torch.int8)
    bank4 = pack_weights(bank, bits=4).data
    bs = torch.rand(2, 128) / 100
    ids = torch.tensor([1, 0], dtype=torch.int32)
    gamma = torch.ones(128)
    q = torch.randn(2, 1, 4, 64).bfloat16().requires_grad_()
    kc = torch.randn(2, 2, 128, 64).bfloat16()
    k8 = torch.randint(-127, 128, (2, 2, 128, 64), dtype=torch.int8)
    ks = torch.rand(2, 2, 128)
    lens = torch.tensor([5, 9], dtype=torch.int32)
    table = torch.tensor([[0], [1]], dtype=torch.int32)
    return [
        ("w8a8_gemm", lambda: w8a8_gemm(xq, sx, q8, s, 128)),
        ("w4a8_gemm", lambda: w4a8_gemm(xq, sx, pack_weights(q8 >> 4, bits=4).data, s, 128)),
        ("w8a16_expert_gemv", lambda: w8a16_expert_gemv(x, bank, bs, ids, 128)),
        ("w4a16_expert_gemv", lambda: w4a16_expert_gemv(x, bank4, bs, ids, 128)),
        ("w8a16_grouped_gemm", lambda: w8a16_grouped_gemm(x, bank, bs, ids[:1], 128)),
        ("w4a16_grouped_gemm", lambda: w4a16_grouped_gemm(x, bank4, bs, ids[:1], 128)),
        ("fused_mlp_gemv", lambda: fused_mlp_gemv(x, gamma, 1e-6, q8, s, q8[:64], s, 128)),
        ("fused_mlp_gemv_i4", lambda: fused_mlp_gemv_i4(
            x, gamma, 1e-6, pack_weights(torch.cat([q8, q8], 1) >> 4, bits=4).data,
            torch.cat([s, s]), pack_weights(q8 >> 4, bits=4).data, s, 128)),
        ("flash_decode", lambda: flash_decode(q, kc, kc, lens)),
        ("flash_decode_int8", lambda: flash_decode_int8(q, k8, k8, ks, ks, lens)),
        ("paged_flash_decode", lambda: paged_flash_decode(q, kc[:, 0:2], kc[:, 0:2], table, lens)),
        ("paged_flash_decode_int8", lambda: paged_flash_decode_int8(q, k8, k8, ks, ks, table,
                                                                    lens)),
        ("w8a16_gemm", lambda: w8a16_gemm(x, q8, s, 128)),
    ]


NO_BACKWARD = ("w8a8_gemm", "w4a8_gemm", "w8a16_expert_gemv", "w4a16_expert_gemv",
               "w8a16_grouped_gemm", "w4a16_grouped_gemm", "fused_mlp_gemv", "fused_mlp_gemv_i4",
               "flash_decode", "flash_decode_int8", "paged_flash_decode",
               "paged_flash_decode_int8", "w8a16_gemm")


@pytest.mark.parametrize("name", NO_BACKWARD)
def test_entry_without_backward_raises_under_grad(name):
    """A kernel entry point whose output would carry no gradient raises under
    grad, naming itself, and runs under no_grad (w8a16_gemm called directly:
    `DequantMatmul` carries its backward)."""
    call = dict(_refusals())[name]
    with pytest.raises(NotImplementedError, match=name):
        call()
    with torch.no_grad():
        assert call().grad_fn is None


def test_a8_model_raises_under_grad(lora_models):
    """a8=True under grad: the W8A8 GEMM's guard, not a silently cut graph."""
    _, _, tree, toks = lora_models
    params = params_from_numpy(tree, device="cpu")
    params.layers[0].qkv_lora.lora_a.requires_grad_()
    with pytest.raises(NotImplementedError, match="w8a8_gemm"):
        forward_inner(params, CFG, torch.from_numpy(toks), torch.arange(SEQ)[None], None, 0,
                      a8=True)


def test_refuse_grad_ignores_frozen_inputs():
    x = torch.randn(2, 3)
    _build.refuse_grad("entry", x, None)  # nothing requires grad
    with torch.no_grad():
        _build.refuse_grad("entry", x.requires_grad_())
