"""Packed int8 weight layout: defined once, imported by the packer and the
kernel wrappers.

Port of `eetq_tpu/layout/tiling.py` for int8. The layout stays row-major
[Kp, Np] int8 (in-features x out-features), zero-padded so K and N are
multiples of `TILE`:

- the GEMM kernel (`csrc/w8a16_gemm.cu`) reads 128 x 32 weight tiles of
  whole 128-column groups, and the GEMV kernel (`csrc/w8a16_gemv.cu`)
  walks K in sweeps of 128 rows over 32-column strips, so a padding of 128
  keeps every kernel tile full and every 16-byte load in bounds without
  masking. (The TPU layout pads to 256 for its Mosaic blocks; the real
  llama dims are multiples of both.)
- padded rows and columns are zero, so products over the padded range are
  exact; the kernels write only the logical N output columns.

An expert bank is a stacked [E, K, N] int8 weight, packed per expert to
[E, Kp, Np] (the MoE kernels offset into it by e * Kp * Np). Checkpoints
and `models/convert.py` carry the unpacked [K, N] or [E, K, N] int8.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

TILE = 128


def padded(dim: int) -> int:
    """`dim` rounded up to the layout granule."""
    return -(-dim // TILE) * TILE


@dataclasses.dataclass
class PackedWeight:
    """A kernel-ready int8 weight: data [Kp, Np] (or a bank [E, Kp, Np])
    plus the logical K, N."""

    data: torch.Tensor
    k: int
    n: int

    @property
    def kp(self) -> int:
        return self.data.shape[-2]

    @property
    def np(self) -> int:
        return self.data.shape[-1]


def pack_weights(qweight: torch.Tensor) -> PackedWeight:
    """Zero-pad an unpacked int8 [K, N] weight (or [E, K, N] bank, each
    expert on its own) to the kernel layout."""
    if qweight.dtype != torch.int8:
        raise TypeError(f"pack_weights expects int8, got {qweight.dtype}")
    if qweight.dim() not in (2, 3):
        raise ValueError(f"weight must be 2-D or 3-D, got {tuple(qweight.shape)}")
    k, n = qweight.shape[-2:]
    data = F.pad(qweight, (0, padded(n) - n, 0, padded(k) - k)).contiguous()
    return PackedWeight(data=data, k=k, n=n)


def unpack_weights(packed: PackedWeight) -> torch.Tensor:
    """Exact inverse of :func:`pack_weights`: the logical [K, N] (or
    [E, K, N]) int8."""
    return packed.data[..., : packed.k, : packed.n]
