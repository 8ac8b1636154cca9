"""QKV / gate-up fusion and exact splitting of quantized linears.

Port of `eetq_tpu/surgery/fusion.py`. q/k/v (and gate/up) are fused along N
so that they share one quantized GEMM; the quantized weight and its scales
are sliced back along N after quantization. Scales are per output channel
(or per (K-group, channel)), so slicing along N is scale-exact.
"""

from __future__ import annotations

import torch

from eetq_tpu_torch.layout.tiling import pack_weights, unpack_weights
from eetq_tpu_torch.modules.linear import QuantLinear


def fuse_columns(weights: list[torch.Tensor]) -> torch.Tensor:
    """Concatenate [K, Ni] float weights along N (shared-K fusion)."""
    k = weights[0].shape[0]
    if any(w.shape[0] != k for w in weights):
        raise ValueError([tuple(w.shape) for w in weights])
    return torch.cat(weights, dim=-1)


def fuse_qkv(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """[K, Nq|Nk|Nv] fused qkv."""
    return fuse_columns([wq, wk, wv])


def fuse_gateup(w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    return fuse_columns([w_gate, w_up])


def split_quant_columns(ql: QuantLinear, sizes: list[int]) -> list[QuantLinear]:
    """Split a quantized fused linear into per-projection QuantLinears by
    slicing the unpacked qweight, the scales and the bias along N, then
    packing each slice again: bit-exact, the inverse of fusing before
    quantization."""
    if sum(sizes) != ql.out_features:
        raise ValueError(f"sizes {sizes} != out_features {ql.out_features}")
    q = unpack_weights(ql.packed)
    outs = []
    start = 0
    for n in sizes:
        sl = slice(start, start + n)
        outs.append(QuantLinear(
            # scales sliced on the channel axis: exact for per-channel [N]
            # and group-wise [G, N] alike
            pack_weights(q[..., sl], bits=ql.bits),
            ql.scales[..., sl].contiguous(),
            None if ql.bias is None else ql.bias[sl].contiguous(),
        ))
        start += n
    return outs
