"""Fused decode MLP: RMSNorm -> gate/up GEMV -> act * up -> down GEMV
(-> + residual) for m <= 8 rows.

`fused_mlp_gemv` replaces `eetq_tpu/kernels/mlp_fused.py::
fused_mlp_gemv_call` (`pallas_call` at mlp_fused.py:140) for int8
per-channel weights, with the CUDA kernels of `csrc/fused_mlp.cu`. Bound by
weight bytes: 135 MB of int8 per llama2-7b layer at 2m FLOPs per byte. The
TPU kernel carries an [m, N] f32 accumulator across a sequential walk over
the intermediate dim; GPU blocks run in parallel, so the kernel splits at
h: a gate/up launch of the tensor-core GEMV of `csrc/gemv.cuh` (one block
per 64 intermediate columns, the gate and the up columns in one K loop,
activation in the epilogue, h rounded to bf16 where the TPU rounds it) and
a down launch with the residual in its epilogue, each with its own K split
(`autotune.gemv_splits`). Two launches instead of the unfused path's
eight, every weight byte read once, no float atomics.

`fused_mlp_gemv_i4` replaces `fused_mlp_gemv_i4_call` (`pallas_call` at
mlp_fused.py:290) for int4 per-channel weights, with `csrc/fused_mlp_i4.cu`:
the same two launches on the GEMV's int4 mode, 67.6 MB per llama2-7b layer.
The TPU kernel computes four gate/up column blocks per step because it
keeps h in fast memory and its split-half nibbles make the down product
consume h at i and at I/2 + i; with h in device memory (L2) and neighbouring
rows in a byte (`layout/tiling.py`) the down GEMV reads h in order and none
of that is needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eetq_tpu_torch.kernels import _build
from eetq_tpu_torch.kernels.autotune import (
    FUSED_MLP_SLICE,
    GEMV_BLOCK_N,
    MAX_DECODE_M,
    gemv_scratch_size,
    gemv_splits,
    sm_count,
)
from eetq_tpu_torch.layout.tiling import TILE, unpack_int4_rows
from eetq_tpu_torch.ops.rmsnorm import rmsnorm

ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
}
ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2}


def fused_mlp_ref(x, gamma, gu_int, gu_scales, d_int, d_scales, eps, activation="silu",
                  residual=None):
    """Plain version on the logical int8 weights (`eetq_tpu/kernels/
    mlp_fused.py::fused_mlp_ref`): y = rmsnorm(x) in x.dtype; gate/up in f32
    and scaled; h = act(gate) * up rounded to x.dtype; down in f32, scaled,
    plus the residual in f32; one rounding to x.dtype."""
    y = rmsnorm(x, gamma, eps=eps)
    gu = (y.float() @ gu_int.float()) * gu_scales.float()
    gate, up = torch.chunk(gu, 2, dim=-1)
    h = (ACTIVATIONS[activation](gate) * up).to(x.dtype)
    out = (h.float() @ d_int.float()) * d_scales.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def _fused(counter, entry: str, bits: int, x, gamma, eps, gu_data, gu_scales, d_data, d_scales,
           n, residual, activation):
    k = x.shape[-1]
    pack = 2 if bits == 4 else 1
    ip = d_data.shape[0] * pack
    if not x.is_cuda:
        if bits == 4:
            gu_data, d_data = unpack_int4_rows(gu_data), unpack_int4_rows(d_data)
        return fused_mlp_ref(x, gamma, gu_data[:k], gu_scales, d_data[:, :n], d_scales, eps,
                             activation, residual)
    m = x.shape[0]
    kp, ip2 = gu_data.shape[0] * pack, gu_data.shape[1]
    np_ = d_data.shape[1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"x must be contiguous bf16, got {x.dtype}")
    for name, t in (("gate/up weight", gu_data), ("down weight", d_data)):
        if t.dtype != torch.int8 or not t.is_contiguous() or t.device != x.device:
            raise TypeError(f"{name} must be contiguous int8 on x's device")
    if ip2 != 2 * ip or ip % TILE or kp % TILE or np_ % TILE or k > kp or n > np_:
        raise ValueError(f"weights {tuple(gu_data.shape)}, {tuple(d_data.shape)} are not a "
                         f"packed int{bits} [Kp, 2I] gate|up and [I, Np] down for K={k}, N={n}")
    if k % 8:
        raise NotImplementedError("the CUDA kernels take K % 8 == 0 (16-byte x loads)")
    if not 1 <= m <= MAX_DECODE_M:
        raise ValueError(f"the fused MLP kernel takes 1..{MAX_DECODE_M} rows, got {m}")
    for name, t, size in (("gu_scales", gu_scales, ip2), ("d_scales", d_scales, n)):
        if (t.dtype != torch.float32 or t.shape != (size,) or not t.is_contiguous()
                or t.device != x.device):
            raise NotImplementedError(
                f"{name} must be contiguous per-channel f32 [{size}] on x's device "
                "(group-wise scales have no fused kernel)")
    if gamma.shape != (k,) or gamma.device != x.device:
        raise TypeError("gamma must be [K] on x's device")
    gamma = gamma.float().contiguous()
    if gamma.data_ptr() % 16:  # copied 16 bytes at a time
        gamma = gamma.clone()
    if residual is not None:
        if residual.shape != (m, n) or residual.device != x.device:
            raise TypeError("residual must be [m, N] on x's device")
        residual = residual.to(torch.bfloat16).contiguous()
    if activation not in ACT_CODES:
        raise NotImplementedError(f"activation {activation!r} has no fused kernel")
    if x.data_ptr() % 16 or gu_data.data_ptr() % 16 or d_data.data_ptr() % 16:
        raise ValueError("x and the weights must be 16-byte aligned")
    h = torch.empty((m, ip), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    sms = sm_count(x.device.index)
    plans = [(gemv_splits(rows, strips, 1, bits, m, 0, sms), strips) for rows, strips in (
        (kp // pack, ip // FUSED_MLP_SLICE), (ip // pack, np_ // GEMV_BLOCK_N))]
    sizes = [gemv_scratch_size(splits, strips, 1) for splits, strips in plans]
    partials, counters = _build.gemv_scratch(x.device, *map(max, zip(*sizes)))
    _build.launch(
        entry, x.data_ptr(), m, k, gamma.data_ptr(), eps,
        gu_data.data_ptr(), kp, ip, gu_scales.data_ptr(), d_data.data_ptr(), np_,
        d_scales.data_ptr(), _build.ptr(residual), h.data_ptr(), out.data_ptr(), n,
        ACT_CODES[activation], partials, counters, plans[0][0], plans[1][0],
        _build.stream_of(x),
    )
    counter.launches += 1
    return out


def fused_mlp_gemv(
    x: torch.Tensor,
    gamma: torch.Tensor,
    eps: float,
    gu_data: torch.Tensor,
    gu_scales: torch.Tensor,
    d_data: torch.Tensor,
    d_scales: torch.Tensor,
    n: int,
    residual: torch.Tensor | None = None,
    activation: str = "silu",
) -> torch.Tensor:
    """x [m, K] bf16 (m <= 8); gamma [K]; gu_data the packed int8 [Kp, 2I]
    fused gate|up weight with the up half at column I (I % 128 == 0);
    gu_scales f32 [2I]; d_data the packed int8 [I, Np] down weight; d_scales
    f32 [N]; residual [m, N]. Returns [m, N] bf16."""
    return _fused(fused_mlp_gemv, "eetq_fused_mlp_gemv", 8, x, gamma, eps, gu_data, gu_scales,
                  d_data, d_scales, n, residual, activation)


def fused_mlp_gemv_i4(
    x: torch.Tensor,
    gamma: torch.Tensor,
    eps: float,
    gu_data: torch.Tensor,
    gu_scales: torch.Tensor,
    d_data: torch.Tensor,
    d_scales: torch.Tensor,
    n: int,
    residual: torch.Tensor | None = None,
    activation: str = "silu",
) -> torch.Tensor:
    """:func:`fused_mlp_gemv` on int4 weights: gu_data the packed int4 pairs
    [Kp/2, 2I], d_data [I/2, Np]."""
    return _fused(fused_mlp_gemv_i4, "eetq_fused_mlp_gemv_i4", 4, x, gamma, eps, gu_data,
                  gu_scales, d_data, d_scales, n, residual, activation)


fused_mlp_gemv.launches = 0
fused_mlp_gemv_i4.launches = 0
