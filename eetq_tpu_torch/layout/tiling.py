"""Packed weight layout, int8 and int4: defined once, imported by the packer
and the kernel wrappers.

Port of `eetq_tpu/layout/tiling.py`. The contract between the two packages
is the unpacked [K, N] weight (int4 values held one per int8, in [-8, 7])
plus its scales, which is what checkpoints and `models/convert.py` carry;
the packed bytes are each package's own.

**int8** stays row-major [Kp, Np] int8 (in-features x out-features),
zero-padded so K and N are multiples of `TILE`:

- the GEMM kernels read 128-column groups of 32 K rows (W8A16) or 64
  (W8A8), and the GEMV kernel walks K in sweeps of 128 rows over 32-column
  strips, so a padding of 128 keeps every kernel tile full and every 16-byte
  load in bounds without masking. (The TPU layout pads to 256 for its Mosaic
  blocks; the real llama dims are multiples of both.)
- padded rows and columns are zero, so products over the padded range are
  exact; the kernels write only the logical N output columns.

**int4** (`bits=4`) pads the same way and then packs neighbouring K rows
into one byte: data [Kp/2, Np] int8, byte (i, n) holding logical row 2i in
its low nibble and row 2i + 1 in its high nibble, both two's complement.
`PackedWeight.kp` counts logical rows. The JAX package packs split halves
(row i with row i + Kp/2), which suits a kernel that slices whole blocks of
a VMEM tile; on CUDA a thread unpacks the bytes it loaded itself, and with
neighbouring rows the two nibbles of a byte meet two neighbouring elements
of x (the fused MLP's down product reads h in order), one K tile of packed
rows is one contiguous K tile of x, and both nibbles lie in the same scale
group. llama2-7b needs no padding at this tile: K = 4096 and 11008 (= 86 x
128), N = 12288, 4096, 22016 and 32000 are multiples of 128, so the int4
data has 2048 and 5504 rows.

**Group-wise scales** [K/g, N] (`kernels.autotune.group_size_of`): g divides K and is a
multiple of `kernels.autotune.GROUP_GRANULE` (32: the K depth of one GEMM
step and of one int8 MMA, so no step straddles two groups; it is even, so
neither does a byte). Rows K..Kp are zero and belong to no group: the
kernels give them the last group's scales.

An expert bank is a stacked [E, K, N] weight, packed per expert to
[E, Kp, Np] (int4: [E, Kp/2, Np]); the MoE kernels offset into it by whole
experts.
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
    """A kernel-ready weight: data [Kp, Np] int8, or [Kp/2, Np] int4 pairs
    (or a bank with a leading expert axis), plus the logical K, N and the
    bit width."""

    data: torch.Tensor
    k: int
    n: int
    bits: int = 8

    @property
    def kp(self) -> int:
        """Logical padded K (an int4 data row holds two logical rows)."""
        rows = self.data.shape[-2]
        return rows * 2 if self.bits == 4 else rows

    @property
    def np(self) -> int:
        return self.data.shape[-1]


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """int4 values held one per int8 [..., 2R, N] -> [..., R, N] bytes: row
    2i in the low nibble, row 2i + 1 in the high nibble."""
    lo = q[..., 0::2, :] & 0x0F
    hi = q[..., 1::2, :] << 4  # int8 wraps: the low four bits, moved up
    return (lo | hi).contiguous()


def unpack_int4_rows(data: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: [..., R, N] bytes -> the int4
    values [..., 2R, N], sign-extended, one per int8."""
    lo = (data << 4) >> 4  # arithmetic shifts on int8
    hi = data >> 4
    return torch.stack((lo, hi), dim=-2).reshape(*data.shape[:-2], 2 * data.shape[-2],
                                                 data.shape[-1])


def pack_weights(qweight: torch.Tensor, bits: int = 8) -> PackedWeight:
    """Zero-pad an unpacked int8 [K, N] weight (or [E, K, N] bank, each
    expert on its own) to the kernel layout; with bits=4 the values lie in
    [-8, 7] and neighbouring rows are packed into one byte."""
    if qweight.dtype != torch.int8:
        raise TypeError(f"pack_weights expects int8, got {qweight.dtype}")
    if qweight.dim() not in (2, 3):
        raise ValueError(f"weight must be 2-D or 3-D, got {tuple(qweight.shape)}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k, n = qweight.shape[-2:]
    data = F.pad(qweight, (0, padded(n) - n, 0, padded(k) - k)).contiguous()
    if bits == 4:
        data = pack_int4_rows(data)
    return PackedWeight(data=data, k=k, n=n, bits=bits)


def unpack_weights(packed: PackedWeight) -> torch.Tensor:
    """Exact inverse of :func:`pack_weights`: the logical [K, N] (or
    [E, K, N]) int8 (int4 values sign-extended, one per int8)."""
    data = unpack_int4_rows(packed.data) if packed.bits == 4 else packed.data
    return data[..., : packed.k, : packed.n]
