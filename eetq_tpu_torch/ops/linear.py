"""`w8a16_matmul`: the quantized matmul entry of the port.

Port of `eetq_tpu/ops/linear.py::w8a16_matmul` (`ops/linear.py:150-243`):
flatten the leading dims to m x K, then m <= MAX_DECODE_M goes to the
GEMV kernel (with the RMSNorm prologue fused) and larger m to the GEMM
kernel (after a plain RMSNorm), the int8 or the int4 one by the weight's
`bits`, with per-channel or group-wise scales, and the fused epilogue
(activation, then a residual added or multiplied; a prenorm still fuses
into the GEMV's prologue beside it). The JAX package fuses the
norm for int8 per-channel only (`ops/linear.py:223-228`); the port's GEMV
fuses it for every variant, which computes the same function.

Under grad (grad mode on and a float input that requires grad) the kernel
call runs inside `DequantMatmul`, a `torch.autograd.Function`: the
forward is the same kernel launch, and the backward is the dequantizing
one of `_core_bwd` / `_prenorm_bwd` (`eetq_tpu/ops/linear.py:108-125,
295-303`), the gradient of the plain composition rmsnorm -> x @
dequant(W) -> bias -> act -> residual (see `DequantMatmul.backward`).
Elsewhere (decode graphs, `inference_mode`, the engine) the call is the
kernel's alone.
"""

from __future__ import annotations

import math

import torch

from eetq_tpu_torch.kernels.autotune import MAX_DECODE_M
from eetq_tpu_torch.kernels.mlp_fused import ACTIVATIONS
from eetq_tpu_torch.kernels.w8a16 import (
    w4a16_gemm,
    w4a16_gemv,
    w8a16_gemm,
    w8a16_gemv,
    check_epilogue,
    w8a16_matmul_ref,
)
from eetq_tpu_torch.layout.tiling import PackedWeight, unpack_weights
from eetq_tpu_torch.ops.rmsnorm import rmsnorm


def w8a16_matmul(
    x: torch.Tensor,
    qweight: PackedWeight,
    scales: torch.Tensor,
    bias: torch.Tensor | None = None,
    activation: str | None = None,
    residual: torch.Tensor | None = None,
    residual_mode: str = "add",
    prenorm_gamma: torch.Tensor | None = None,
    prenorm_eps: float = 1e-6,
    use_kernel: bool = True,
) -> torch.Tensor:
    """``act(rmsnorm(x) @ dequant(qweight, scales) + bias) [+|*] residual``
    in x.dtype (`eetq_tpu/ops/linear.py:150-175`).

    x: [..., K]; qweight: PackedWeight (int8 or int4); scales: [N]
    per-channel or [K/g, N] group-wise; bias: optional [N]; activation:
    None, "relu", "gelu" (tanh) or "silu", fused in the epilogue; residual:
    optional [..., N], added (residual_mode "add") or multiplied ("mul")
    after the activation; prenorm_gamma: optional [K] RMSNorm gain applied
    to x first. use_kernel=False runs the plain version on any device (the
    reference the kernels are checked against).
    """
    check_epilogue(activation, residual_mode)
    k, n = qweight.k, qweight.n
    *lead, xk = x.shape
    if xk != k:
        raise ValueError(f"x feature dim {xk} != weight K {k}")
    if scales.dim() == 2 and k % scales.shape[0]:
        raise ValueError(f"scale rows {scales.shape[0]} must divide K {k}")
    m = math.prod(lead)
    x2 = x.reshape(m, k).contiguous()
    res2 = None if residual is None else residual.reshape(m, n).contiguous()
    if not use_kernel:
        if prenorm_gamma is not None:
            x2 = rmsnorm(x2, prenorm_gamma, eps=prenorm_eps)
        out = w8a16_matmul_ref(x2, unpack_weights(qweight), scales, bias, activation, res2,
                               residual_mode)
    elif torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (
            x2, scales, bias, res2, prenorm_gamma)):
        out = DequantMatmul.apply(x2, scales, bias, res2, prenorm_gamma, qweight, prenorm_eps,
                                  activation, residual_mode)
    else:
        out = _kernel_call(x2, qweight, scales, bias, res2, prenorm_gamma, prenorm_eps,
                           activation, residual_mode)
    return out.reshape(*lead, n)


def _kernel_call(x2, qweight: PackedWeight, scales, bias, res2, gamma, eps, activation,
                 residual_mode):
    """The kernel of the regime: the GEMV (norm fused) for m <= MAX_DECODE_M,
    else a plain RMSNorm and the GEMM; int8 or int4 by the weight's bits."""
    gemv, gemm = (w4a16_gemv, w4a16_gemm) if qweight.bits == 4 else (w8a16_gemv, w8a16_gemm)
    epi = dict(activation=activation, residual=res2, residual_mode=residual_mode)
    if x2.shape[0] <= MAX_DECODE_M:
        return gemv(x2, qweight.data, scales, qweight.n, bias, gamma, eps, **epi)
    if gamma is not None:
        x2 = rmsnorm(x2, gamma, eps=eps)
    return gemm(x2, qweight.data, scales, qweight.n, bias, **epi)


def _products(y: torch.Tensor, w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The unscaled f32 products of y [m, K] and the logical weight [K, N]:
    [m, N] for per-channel scales, each group's partial sums [m, G, N] for
    group-wise ones [G, N] (what the scales multiply)."""
    yf, wf = y.float(), w.float()
    if scales.dim() == 1:
        return yf @ wf
    g = scales.shape[0]
    return torch.einsum("mgk,gkn->mgn", yf.reshape(y.shape[0], g, -1),
                        wf.reshape(g, -1, w.shape[1]))


def _dequantized(w: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dequant(W) [K, N] in `dtype`: each int value times its scale in f32,
    rounded once."""
    s = scales.float()
    if s.dim() == 2:
        s = s.repeat_interleave(w.shape[0] // s.shape[0], dim=0)
    return (w.float() * s).to(dtype)


class DequantMatmul(torch.autograd.Function):
    """``act(rmsnorm(x2) @ dequant(W) + bias) [+|*] residual`` through the
    kernel of the regime, with the dequantizing backward.

    Saves x2 (before the norm), the scales, bias, residual and gamma, and
    never a dequantized weight. The backward is the gradient of the plain
    composition, as `jax.vjp` of `_ref_forward` gives it: the epilogue's
    derivative first (on the recomputed f32 pre-activation where an
    activation or a multiplied residual needs it), then dy = g @ dequant(W)^T
    as one product in x's dtype with f32 accumulation over a dequantized
    copy of W made for the call, then the RMSNorm's derivative by autograd
    on its recomputation. The int weights get no gradient; x2, scales, bias,
    residual and gamma get theirs where they require one.
    """

    @staticmethod
    def forward(ctx, x2, scales, bias, res2, gamma, qweight: PackedWeight, eps: float,
                activation, residual_mode):
        ctx.save_for_backward(x2, scales, bias, res2, gamma)
        ctx.qweight, ctx.eps = qweight, eps
        ctx.activation, ctx.residual_mode = activation, residual_mode
        return _kernel_call(x2, qweight, scales, bias, res2, gamma, eps, activation,
                            residual_mode)

    @staticmethod
    def backward(ctx, g):
        x2, scales, bias, res2, gamma = ctx.saved_tensors
        need_x, need_s, need_b, need_r, need_g = ctx.needs_input_grad[:5]
        act, mode = ctx.activation, ctx.residual_mode
        w = unpack_weights(ctx.qweight)
        with torch.enable_grad():
            x_ = x2.detach().requires_grad_(need_x)
            gamma_ = None if gamma is None else gamma.detach().requires_grad_(need_g)
            y = x_ if gamma is None else rmsnorm(x_, gamma_, eps=ctx.eps)
        gr = g.float()  # the cotangent of the f32 result before the rounding
        parts = r = None
        if act is not None or (res2 is not None and mode == "mul") or need_s:
            parts = _products(y.detach(), w, scales)
            r = parts * scales.float() if scales.dim() == 1 else (
                parts * scales.float()).sum(dim=-2)
            if bias is not None:
                r = r + bias.float()
        d_res = None
        if res2 is not None:
            if mode == "add":
                d_res = gr
            else:
                d_res = gr * (r if act is None else ACTIVATIONS[act](r))
                gr = gr * res2.float()
        if act is not None:
            with torch.enable_grad():
                r_ = r.detach().requires_grad_()
                (gr,) = torch.autograd.grad(ACTIVATIONS[act](r_), r_, gr)
        d_s = None
        if need_s:
            d_s = (gr * parts).sum(0) if scales.dim() == 1 else (gr[:, None] * parts).sum(0)
            d_s = d_s.to(scales.dtype)
        d_x = d_g = None
        if need_x or need_g:
            dy = gr.to(y.dtype) @ _dequantized(w, scales, y.dtype).T
            if gamma is None:
                d_x = dy
            else:
                wrt = [t for t, need in ((x_, need_x), (gamma_, need_g)) if need]
                grads = iter(torch.autograd.grad(y, wrt, dy))
                d_x = next(grads) if need_x else None
                d_g = next(grads) if need_g else None
        d_b = gr.sum(0).to(bias.dtype) if need_b else None
        d_r = d_res.to(res2.dtype) if need_r else None
        return d_x, d_s, d_b, d_r, d_g, None, None, None, None
