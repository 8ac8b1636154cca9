"""`fused_mlp`: the whole gated-MLP block (RMSNorm + gate/up GEMV + act * up
+ down GEMV + optional residual) in one kernel dispatch, for the decode
regime.

Port of `eetq_tpu/ops/mlp.py` for int8 per-channel weights; see
`kernels/mlp_fused.py` for the kernel. int4 weights have no packed layout
in the port yet, so the int4 variant cannot be reached.
"""

from __future__ import annotations

import math

import torch

from eetq_tpu_torch.kernels.autotune import MAX_DECODE_M
from eetq_tpu_torch.kernels.mlp_fused import fused_mlp_gemv, fused_mlp_ref
from eetq_tpu_torch.layout.tiling import TILE, unpack_weights
from eetq_tpu_torch.modules.linear import QuantLinear


def can_fuse_mlp(gateup, down, m: int) -> bool:
    """Fused-path preconditions (`eetq_tpu/ops/mlp.py:30-59`): decode-regime
    rows, int8 per-channel QuantLinears without bias, and the gate|up halves
    of the packed [Kp, 2I] weight at exact column I, which holds when I is a
    multiple of the port's layout tile (128; the TPU layout's is 256).
    llama2-7b's I = 11008 = 86 * 128 passes."""
    if m > MAX_DECODE_M:
        return False
    for lin in (gateup, down):
        if not isinstance(lin, QuantLinear) or lin.scales.dim() != 1 or lin.bias is not None:
            return False
    i = down.k
    return (gateup.n == 2 * i and gateup.qweight.shape[1] == 2 * i
            and down.qweight.shape[0] == i and i % TILE == 0)


def fused_mlp(
    gateup: QuantLinear,
    down: QuantLinear,
    x: torch.Tensor,  # [..., K]
    gamma: torch.Tensor,  # [K] RMSNorm gain (already unit-offset if any)
    eps: float,
    activation: str = "silu",
    residual: torch.Tensor | None = None,  # [..., N], added in the epilogue
    use_kernel: bool = True,
) -> torch.Tensor:
    """``act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu) @ Wd (+ residual)``.
    use_kernel=False runs the plain version on any device."""
    *lead, k = x.shape
    m = math.prod(lead)
    n = down.n
    x2 = x.reshape(m, k).contiguous()
    res = None if residual is None else residual.reshape(m, n)
    if use_kernel:
        out = fused_mlp_gemv(x2, gamma, eps, gateup.qweight, gateup.scales, down.qweight,
                             down.scales, n, res, activation)
    else:
        out = fused_mlp_ref(x2, gamma, unpack_weights(gateup.packed), gateup.scales,
                            unpack_weights(down.packed), down.scales, eps, activation, res)
    return out.reshape(*lead, n)
