"""W8A8 matmul: per-token int8 activations x int8 per-channel weights.

`w8a8_gemm` replaces `eetq_tpu/kernels/w8a8.py::w8a8_matmul_kernel_call`
(`pallas_call` at w8a8.py:125) with the CUDA kernel `csrc/w8a8_gemm.cu`.
It is the prefill regime's path (the engine's `a8_prefill`): bound by
tensor-core operations, and Hopper's int8 rate is twice its bf16 rate. An
m = 1024 llama2-7b prompt does about 13.8 TOP through it per forward. The
kernel runs `mma.sync` m16n8k32 s8 x s8 -> s32 over 128 x 128 output tiles;
the row-major [Kp, Np] weight is transposed byte-wise on its way into
shared memory, since the B operand wants K contiguous (see the source).

`quantize_activations` and the plain product are bit-identical to the JAX
package's on the CPU: the activation quantizer scales as XLA compiles it
and rounds half to even as `jnp.round` does, and the plain product sums
int8 x int8 exactly (in float64, exact far past the 1.8e8 a K = 11008 sum
can reach; f32 would not be).
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.layout.tiling import TILE


# 1/127 rounded to f32. JAX runs its quantizers under jit, where XLA folds
# `absmax / 127.0` into `absmax * f32(1/127)` (one ulp off the true quotient
# for some inputs); the element-wise `x / scale` stays a true division.
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token (last-axis) symmetric int8: x [..., K] float -> (q int8
    [..., K], scales f32 [...]), as `eetq_tpu/kernels/w8a8.py:31-43` computes
    it under jit; values round half to even, as `jnp.round` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) * _INV_127
    safe = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product as f32: the sums are exact in float64 and
    rounded once to f32, as JAX's int32 accumulator cast to f32 is."""
    return (a.double() @ b.double()).float()


def w8a8_matmul_ref(
    x: torch.Tensor,
    qweight: torch.Tensor,
    w_scales: torch.Tensor,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: quantize x per token, integer matmul, then
    ``acc * sx * sw + bias`` in f32 and one rounding to x.dtype
    (`eetq_tpu/kernels/w8a8.py::w8a8_matmul_ref`, per-channel). x [m, K];
    qweight the logical int8 [K, N]; w_scales [N]."""
    xq, sx = quantize_activations(x)
    return w8a8_gemm_ref(xq, sx, qweight, w_scales, qweight.shape[1], bias, x.dtype)


def w8a8_gemm_ref(xq, x_scales, qdata, w_scales, n, bias=None,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`w8a8_gemm` on its own operands: xq [m, K]
    against qdata [K, >= n], the epilogue in f32, one rounding to dtype."""
    r = int_matmul(xq, qdata[:, :n]) * x_scales[..., None] * w_scales.float()
    if bias is not None:
        r = r + bias.float()
    return r.to(dtype)


def w8a8_gemm(
    xq: torch.Tensor,
    x_scales: torch.Tensor,
    qdata: torch.Tensor,
    w_scales: torch.Tensor,
    n: int,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """xq [m, Kp] int8 (zero past the logical K); x_scales f32 [m]; qdata the
    packed int8 [Kp, Np]; w_scales f32 [N] per-channel; bias [N]. Returns
    ``bf16((f32(xq @ W) * sx) * sw + bias)`` [m, N]."""
    if not xq.is_cuda:
        return w8a8_gemm_ref(xq, x_scales, qdata, w_scales, n, bias)
    m, kx = xq.shape
    kp, np_ = qdata.shape
    if xq.dtype != torch.int8 or not xq.is_contiguous():
        raise TypeError(f"activations must be contiguous int8, got {xq.dtype}")
    if qdata.dtype != torch.int8 or not qdata.is_contiguous() or qdata.device != xq.device:
        raise TypeError("weight must be contiguous int8 on the activations' device")
    if kp % TILE or np_ % TILE or kx != kp or n > np_:
        raise ValueError(f"weight {tuple(qdata.shape)} / activations {tuple(xq.shape)} "
                         f"are not a packed [Kp, Np] and an [m, Kp] for N={n}")
    if xq.data_ptr() % 16 or qdata.data_ptr() % 16:
        raise ValueError("activations and the weight must be 16-byte aligned")
    if w_scales.dim() != 1:
        raise NotImplementedError("group-wise W8A8 has no kernel (it stays on the W8A16 path)")
    for name, t, size in (("x_scales", x_scales, m), ("w_scales", w_scales, n)):
        if (t.dtype != torch.float32 or t.shape != (size,) or not t.is_contiguous()
                or t.device != xq.device):
            raise TypeError(f"{name} must be contiguous f32 [{size}] on the activations' device")
    if bias is not None:
        if bias.shape != (n,) or bias.device != xq.device:
            raise TypeError("bias must be [N] on the activations' device")
        bias = bias.float().contiguous()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    _build.launch(
        "eetq_w8a8_gemm", xq.data_ptr(), m, kp, qdata.data_ptr(), np_,
        x_scales.data_ptr(), w_scales.data_ptr(), _build.ptr(bias), out.data_ptr(), n,
        _build.stream_of(xq),
    )
    w8a8_gemm.launches += 1
    return out


w8a8_gemm.launches = 0
