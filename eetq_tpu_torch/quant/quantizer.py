"""Per-channel (and group-wise) symmetric weight-only quantizer.

Port of `eetq_tpu/quant/quantizer.py`, bit-identical to it:

- weight layout is [K, N] (in-features x out-features); scales are per
  output channel (last axis), or per (K-group, channel) with `group_size`;
- ``scale[n] = max_k |w[k, n]| / 2^(bits-1)``;
- ``q[k, n] = clip(round_half_away(w[k, n] / scale[n]), -2^(b-1), 2^(b-1)-1)``.

Plain torch ops on whatever device the weight lies on; no kernel.
"""

from __future__ import annotations

import torch


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C `round()`: half away from zero. `torch.round` rounds half to even,
    which would break bit-identity with the JAX quantizer and the reference
    checkpoints."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def symmetric_quantize(
    weight: torch.Tensor,
    bits: int = 8,
    scale_dtype: torch.dtype = torch.float32,
    group_size: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a [K, N] (or [E, K, N]) weight to int8 values + absmax scales.

    bits: 8 or 4 (int4 values are held one per int8, in [-8, 7]).
    group_size: None for per-channel scales [..., N]; g (dividing K) for
      group-wise scales [..., K/g, N].
    Returns (qweight int8 of weight's shape, scales).
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if weight.dim() not in (2, 3):
        raise ValueError(f"weight must be 2-D or 3-D, got shape {tuple(weight.shape)}")
    w = weight.float()
    kdim, n = w.shape[-2], w.shape[-1]
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    if group_size is not None:
        if kdim % group_size:
            raise ValueError(f"group_size {group_size} must divide K {kdim}")
        wg = w.reshape(*w.shape[:-2], kdim // group_size, group_size, n)
        absmax = wg.abs().amax(dim=-2)  # [..., G, N]
    else:
        absmax = w.abs().amax(dim=-2)  # [..., N]
    scale = absmax * (1.0 / float(2 ** (bits - 1)))
    # avoid 0/0 for all-zero columns; q is 0 there anyway
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    if group_size is not None:
        q = _round_half_away(wg / safe[..., None, :]).reshape(w.shape)
    else:
        q = _round_half_away(w / safe[..., None, :])
    q = q.clamp(qmin, qmax).to(torch.int8)
    return q, scale.to(scale_dtype)


def int4_pack(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (held in int8, range [-8, 7]) two per byte along N:
    element 2j in the low nibble, 2j + 1 in the high nibble
    (`eetq_tpu/quant/quantizer.py::int4_pack`, the reference checkpoints'
    format; the kernels' own layout is `layout/tiling.py`'s). N must be even."""
    if q.shape[-1] % 2:
        raise ValueError("last axis must be even to int4-pack")
    lo = q[..., 0::2] & 0x0F
    hi = q[..., 1::2] << 4  # int8 wraps: the low four bits, moved up
    return lo | hi


def int4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`int4_pack`: int8 values in [-8, 7]."""
    lo = (packed << 4) >> 4  # arithmetic shifts on int8 sign-extend
    hi = packed >> 4
    return torch.stack((lo, hi), dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def quantize_and_pack(weight: torch.Tensor, bits: int = 8,
                      scale_dtype: torch.dtype = torch.float32):
    """Quantize per channel, then pack to the kernel layout: (PackedWeight,
    scales). The JAX function of this name packs an int4 result as int8
    (`eetq_tpu/quant/quantizer.py:139-140` calls `pack_weights(q)` without
    the bit width); here the packing follows `bits`."""
    from eetq_tpu_torch.layout.tiling import pack_weights

    q, s = symmetric_quantize(weight, bits=bits, scale_dtype=scale_dtype)
    return pack_weights(q, bits=bits), s


def dequantize(qweight: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``w ≈ q * scale`` broadcast over K; returns float32.

    qweight int8 [..., K, N]; scales [..., N] (per-channel) or [..., G, N]
    (group-wise, K % G == 0)."""
    q = qweight.float()
    s = scales.float()
    if s.dim() == q.dim():  # group-wise
        kdim, n = q.shape[-2], q.shape[-1]
        gcount = s.shape[-2]
        qg = q.reshape(*q.shape[:-2], gcount, kdim // gcount, n)
        return (qg * s[..., None, :]).reshape(q.shape)
    return q * s[..., None, :]
