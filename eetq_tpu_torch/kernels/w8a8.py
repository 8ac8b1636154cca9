"""W8A8 and W4A8 matmul: per-token int8 activations x int8 per-channel
weights, or x int4 weights with per-channel or group-wise scales.

`w8a8_gemm` replaces `eetq_tpu/kernels/w8a8.py::w8a8_matmul_kernel_call`
(`pallas_call` at w8a8.py:125) with the CUDA kernel `csrc/w8a8_gemm.cu`.
It is the prefill regime's path (the engine's `a8_prefill`): bound by
tensor-core operations, and Hopper's int8 rate is twice its bf16 rate. An
m = 1024 llama2-7b prompt does about 13.8 TOP through it per forward. The
kernel runs the int8 `wgmma` (m64n128k32 s8 x s8 -> s32) over 256 x 128
output tiles (128 x 128 where m <= 128) fed by a `cp.async` ring; `wgmma`
takes 8-bit operands only K-major, so producer warpgroups transpose each
row-major [Kp, Np] weight tile byte-wise into shared memory once per block
(see `csrc/a8_gemm.cuh`).

`w4a8_gemm` replaces `w4a8_matmul_kernel_call` (`pallas_call` at
w8a8.py:325) with `csrc/w4a8_gemm.cu`, the same tile with the int4 bytes
(two neighbouring K rows each, `layout/tiling.py`) sign-extended to int8
operands in the pass that transposes them; it is what gives an int4 model
the engine's `a8_prefill`. The operands are the exact values in [-8, 7], so
with per-channel scales the s32 sum and the epilogue are those of W8A8 and
the output is bit-identical to the plain version; the TPU kernel's biased
nibbles and x16 / 1/16 folding (w8a8.py:219-235) are not carried over. With
group-wise scales [K/g, N] each group's s32 sum is converted to f32 and
scaled by its row (w8a8.py:236-253), the groups added in order; the plain
version's f32 sum over groups may run in another order.

Both take the TPU kernels' fused epilogue (`Epilogue`, w8a8.py:71-84,
256-270): after ``(acc * sx) * sw + bias`` an activation and a residual
added or multiplied, in f32 before the one rounding, in a kernel of their
own beside the bias-only one; a launch with either counts as the variant
"epilogue".

`quantize_activations` and the plain product are bit-identical to the JAX
package's on the CPU: the activation quantizer scales as XLA compiles it
and rounds half to even as `jnp.round` does, and the plain product sums
int8 x int8 exactly (in float64, exact far past the 1.8e8 a K = 11008 sum
can reach; f32 would not be).
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.kernels.autotune import group_size_of
from eetq_tpu_torch.kernels.w8a16 import (
    apply_epilogue,
    check_epilogue,
    count_launch,
    epilogue_args,
)
from eetq_tpu_torch.layout.tiling import TILE, unpack_int4_rows


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
    activation: str | None = None,
) -> torch.Tensor:
    """Plain version: quantize x per token, integer matmul, then
    ``act(acc * sx * sw + bias)`` in f32 and one rounding to x.dtype
    (`eetq_tpu/kernels/w8a8.py::w8a8_matmul_ref`). x [m, K]; qweight the
    logical int8 [K, N] (int4 values one per int8); w_scales [N], or [G, N]
    group-wise: each group's integer sum is scaled by its row, the groups
    summed in f32, then ``* sx``."""
    xq, sx = quantize_activations(x)
    group_size = None if w_scales.dim() == 1 else qweight.shape[0] // w_scales.shape[0]
    return w8a8_gemm_ref(xq, sx, qweight, w_scales, qweight.shape[1], bias, x.dtype, group_size,
                         activation)


def w8a8_gemm_ref(xq, x_scales, qdata, w_scales, n, bias=None, dtype=torch.bfloat16,
                  group_size: int | None = None, activation: str | None = None,
                  residual: torch.Tensor | None = None,
                  residual_mode: str = "add") -> torch.Tensor:
    """Plain version of :func:`w8a8_gemm` and :func:`w4a8_gemm` on their own
    operands: xq [m, Kp] against the logical values qdata [Kp, >= n], the
    epilogue in f32, one rounding to dtype. Group-wise scales [G, n] cover
    the first G * group_size rows; the rows past them are zero padding."""
    q = qdata[:, :n]
    if w_scales.dim() == 1:
        r = int_matmul(xq, q) * x_scales[..., None] * w_scales.float()
    else:
        gcount = w_scales.shape[0]
        k = gcount * group_size
        part = torch.einsum("mgk,gkn->mgn",
                            xq[:, :k].reshape(-1, gcount, group_size).double(),
                            q[:k].reshape(gcount, group_size, n).double()).float()
        r = torch.einsum("mgn,gn->mn", part, w_scales.float()) * x_scales[..., None]
    if bias is not None:
        r = r + bias.float()
    return apply_epilogue(r, activation, residual, residual_mode).to(dtype)


def _a8_gemm(counter, entry: str, bits: int, xq, x_scales, qdata, w_scales, n, bias, group_size,
             activation, residual, residual_mode):
    _build.refuse_grad(entry[len("eetq_"):], x_scales, w_scales, bias, residual)
    check_epilogue(activation, residual_mode)
    if not xq.is_cuda:
        logical = unpack_int4_rows(qdata) if bits == 4 else qdata
        return w8a8_gemm_ref(xq, x_scales, logical, w_scales, n, bias, group_size=group_size,
                             activation=activation, residual=residual,
                             residual_mode=residual_mode)
    m, kx = xq.shape
    rows, np_ = qdata.shape
    kp = rows * 2 if bits == 4 else rows
    if xq.dtype != torch.int8 or not xq.is_contiguous():
        raise TypeError(f"activations must be contiguous int8, got {xq.dtype}")
    if qdata.dtype != torch.int8 or not qdata.is_contiguous() or qdata.device != xq.device:
        raise TypeError("weight must be contiguous int8 on the activations' device")
    if kp % TILE or np_ % TILE or kx != kp or n > np_:
        raise ValueError(f"weight {tuple(qdata.shape)} / activations {tuple(xq.shape)} "
                         f"are not a packed int{bits} weight and an [m, Kp] for N={n}")
    if xq.data_ptr() % 16 or qdata.data_ptr() % 16:
        raise ValueError("activations and the weight must be 16-byte aligned")
    w_shape = (n,)
    if w_scales.dim() != 1:
        if bits == 8:
            raise NotImplementedError(
                "group-wise W8A8 has no kernel (it stays on the W8A16 path)")
        groups = w_scales.shape[0]
        if not group_size or groups * group_size > kp:
            raise ValueError(f"{groups} groups of {group_size} rows do not fit Kp {kp}")
        group_size_of(groups * group_size, w_scales)  # a whole multiple of the granule
        w_shape = (groups, n)
    else:
        groups = group_size = 0
    for name, t, shape in (("x_scales", x_scales, (m,)), ("w_scales", w_scales, w_shape)):
        if (t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous()
                or t.device != xq.device):
            raise TypeError(f"{name} must be contiguous f32 {list(shape)} on the activations' "
                            "device")
    if bias is not None:
        if bias.shape != (n,) or bias.device != xq.device:
            raise TypeError("bias must be [N] on the activations' device")
        bias = bias.float().contiguous()
    act, residual, res_mul = epilogue_args(xq, n, activation, residual, residual_mode)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    group_args = (groups, group_size) if bits == 4 else ()
    _build.launch(
        entry, xq.data_ptr(), m, kp, qdata.data_ptr(), np_, x_scales.data_ptr(),
        w_scales.data_ptr(), *group_args, _build.ptr(bias), act, _build.ptr(residual), res_mul,
        out.data_ptr(), n, _build.stream_of(xq),
    )
    count_launch(counter, activation, residual)
    return out


def w8a8_gemm(
    xq: torch.Tensor,
    x_scales: torch.Tensor,
    qdata: torch.Tensor,
    w_scales: torch.Tensor,
    n: int,
    bias: torch.Tensor | None = None,
    activation: str | None = None,
    residual: torch.Tensor | None = None,
    residual_mode: str = "add",
) -> torch.Tensor:
    """xq [m, Kp] int8 (zero past the logical K); x_scales f32 [m]; qdata the
    packed int8 [Kp, Np]; w_scales f32 [N] per-channel; bias [N]; activation
    None, "relu", "gelu" (tanh) or "silu"; residual bf16 [m, N], added or,
    with residual_mode "mul", multiplied. Returns
    ``bf16(act((f32(xq @ W) * sx) * sw + bias) [+|*] residual)`` [m, N]."""
    return _a8_gemm(w8a8_gemm, "eetq_w8a8_gemm", 8, xq, x_scales, qdata, w_scales, n, bias, None,
                    activation, residual, residual_mode)


def w4a8_gemm(
    xq: torch.Tensor,
    x_scales: torch.Tensor,
    qdata: torch.Tensor,
    w_scales: torch.Tensor,
    n: int,
    bias: torch.Tensor | None = None,
    group_size: int | None = None,
    activation: str | None = None,
    residual: torch.Tensor | None = None,
    residual_mode: str = "add",
) -> torch.Tensor:
    """:func:`w8a8_gemm` on int4 weights: qdata the packed int4 pairs
    [Kp/2, Np]; w_scales f32 [N], or [G, N] with `group_size` logical rows a
    group (G * group_size is the logical K), each group's s32 sum scaled by
    its row and the groups summed in f32 before ``* sx``."""
    return _a8_gemm(w4a8_gemm, "eetq_w4a8_gemm", 4, xq, x_scales, qdata, w_scales, n, bias,
                    group_size, activation, residual, residual_mode)


for _fn in (w8a8_gemm, w4a8_gemm):
    _fn.launches = 0
    _fn.variant_launches = {"epilogue": 0}
