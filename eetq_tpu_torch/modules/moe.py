"""Mixture-of-Experts MLP over quantized expert banks (Mixtral-style).

Port of `eetq_tpu/modules/moe.py` for one device. The experts live as one
stacked bank per projection (gate|up [E, H, 2I] and down [E, I, H], each a
3-D QuantLinear or DenseLinear); routing is a top-k softmax over a bf16
router [H, E]. `moe_apply` has the JAX package's three regimes and
thresholds:

- **gather** (n_sel = tokens x top_k <= min(MAX_DECODE_M, E)): one
  expert-gather GEMV per projection streams exactly the selected experts'
  bytes;
- **grouped** (n_sel > MAX_DECODE_M): the selections are sorted by expert
  into bm-row blocks and each projection is one token-grouped GEMM, the
  routed fraction of the FLOPs plus at most one partial block per expert;
- **masked scan** otherwise, and for ``use_kernel=False`` (the plain path):
  every expert over every token, weighted by its routing coefficient (0
  where not picked).

On CUDA the routing and grouping glue keeps static shapes and never reads
a value back to the host (no `.item()`, `nonzero`, boolean indexing or
`bincount`), so the ids never leave the card, as on the TPU. The masked
scan's kernel path runs each expert's slice of the bank through the dense
kernels (`ops/linear.py::w8a16_matmul`: the GEMV up to MAX_DECODE_M tokens,
the GEMM above), where JAX calls its expert kernel with one id; the same
function.

Expert parallelism (`mesh`, `eetq_tpu/modules/moe.py:129-160, 216-300`):
a rank's banks hold its E / tp experts, and `moe_apply` returns the rank's
partial combine, which the decoder all-reduces. A selection of another
rank's expert parks on local expert 0 with zero weight, so the kernels see
local ids only: the grouped GEMM does so in JAX too, and the masked scan's
coefficients over the local experts are the slice JAX takes at the rank's
offset. The decode shapes take the expert gather with parked selections
(JAX runs its masked scan there under EP): the same two products a token,
summed in f32 in the same order, while the gather streams only the selected
local experts' bytes. The grouped GEMM runs under EP only where top_k is
below the local expert count, as in JAX.

The JAX package's A/B knobs (`eetq_tpu/modules/moe.py:113-119, 238-263`)
take the same branches here: `EETQ_MOE_NO_GATHER=1` sends the decode
shapes, and the prompts too, to the masked scan; `EETQ_MOE_NO_GROUPED=1`
sends the prompts there; `EETQ_MOE_GROUPED_BM` sets the grouped GEMM's rows
per block (a multiple of 8 in 8..128; at most `GROUPED_SKINNY_BM` takes the
skinny tile, more the wide one). They are read on every call; a captured
CUDA graph keeps the branch they chose at capture (where JAX reads them when
a jitted function is traced).
"""

from __future__ import annotations

import os

import torch
from torch import nn

from eetq_tpu_torch.kernels.autotune import GROUPED_BM_MAX, GROUPED_BM_MIN, MAX_DECODE_M
from eetq_tpu_torch.kernels.mlp_fused import ACTIVATIONS
from eetq_tpu_torch.kernels.w8a16 import w8a16_matmul_ref
from eetq_tpu_torch.layout.tiling import PackedWeight, pack_weights, unpack_weights
from eetq_tpu_torch.modules.linear import DenseLinear, QuantLinear
from eetq_tpu_torch.ops.linear import w8a16_matmul
from eetq_tpu_torch.ops.moe import w8a16_expert_matmul, w8a16_grouped_matmul
from eetq_tpu_torch.quant.quantizer import symmetric_quantize

class MoEMLP(nn.Module):
    """Routed MLP block: router [H, E] + stacked expert gate|up and down.

    gateup/down are QuantLinear (data [E, Kp, Np] or int4 pairs
    [E, Kp/2, Np], scales [E, N] or [E, K/g, N]) or DenseLinear (weight
    [E, K, N] bf16)."""

    def __init__(self, router: DenseLinear, gateup: QuantLinear | DenseLinear,
                 down: QuantLinear | DenseLinear):
        super().__init__()
        self.router, self.gateup, self.down = router, gateup, down

    @property
    def num_experts(self) -> int:
        return self.router.weight.shape[-1]

    @property
    def num_local_experts(self) -> int:
        """The experts of the banks: E, or E / tp on a rank under expert
        parallelism."""
        bank = self.gateup
        return (bank.qweight if isinstance(bank, QuantLinear) else bank.weight).shape[0]


def _quantize_bank(lin: DenseLinear, bits: int = 8, group_size: int | None = None) -> QuantLinear:
    """A [E, K, N] bank quantized one expert at a time (the scales are per
    expert, so this equals quantizing the whole bank, and the f32
    temporaries stay one expert wide)."""
    if lin.bias is not None:
        raise NotImplementedError("expert biases are not supported")
    parts = [symmetric_quantize(w, bits=bits, group_size=group_size) for w in lin.weight]
    q = torch.stack([p[0] for p in parts])
    s = torch.stack([p[1] for p in parts])
    return QuantLinear(pack_weights(q, bits=bits), s)


def quantize_moe(moe: MoEMLP, bits: int = 8, group_size: int | None = None) -> MoEMLP:
    """Quantize a dense MoEMLP's expert banks (`eetq_tpu/modules/moe.py::
    quantize_moe`): per-channel int8 by default, or int4 and group-wise
    scales (`bits`, `group_size`). The router stays bf16: a [H, E] sliver
    whose logits decide the routing."""
    return MoEMLP(moe.router, _quantize_bank(moe.gateup, bits, group_size),
                  _quantize_bank(moe.down, bits, group_size))


def route(router: DenseLinear, x2: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing, softmax over the selected logits (the Mixtral
    convention). The logits are f32 sums of the exact bf16 products, as
    `preferred_element_type=f32` gives in JAX. x2 [T, H] -> (weights [T, k]
    f32, ids [T, k] int64)."""
    logits = x2.float() @ router.weight.to(x2.dtype).float()
    topv, topi = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(topv, dim=-1), topi


def _gated(gu_out: torch.Tensor, activation: str, dtype: torch.dtype) -> torch.Tensor:
    gate, up = torch.chunk(gu_out, 2, dim=-1)
    return (ACTIVATIONS[activation](gate.float()) * up.float()).to(dtype)


def _grouped_bm(n_sel: int, e: int) -> int:
    """Rows per block of the grouped GEMM (`eetq_tpu/modules/moe.py:106`):
    128 keeps the weight stream compute-bound; small prompts shrink it
    toward the balanced per-expert count, a multiple of 8, so the padding
    stays bounded (at most n_sel / bm + E blocks). EETQ_MOE_GROUPED_BM
    overrides it for A/B runs; a value that is not a multiple of 8 in
    GROUPED_BM_MIN..GROUPED_BM_MAX raises."""
    env = os.environ.get("EETQ_MOE_GROUPED_BM")
    if env:
        bm = int(env)
        if bm % 8 or not GROUPED_BM_MIN <= bm <= GROUPED_BM_MAX:
            raise ValueError(f"EETQ_MOE_GROUPED_BM={env}: the grouped GEMM takes a multiple of 8 "
                             f"in {GROUPED_BM_MIN}..{GROUPED_BM_MAX}")
        return bm
    per = n_sel // max(e, 1)
    return max(GROUPED_BM_MIN, min(GROUPED_BM_MAX, 8 * (per // 8) or 8))


def _expert(bank: PackedWeight, ei: int) -> PackedWeight:
    """Expert `ei`'s slice of a packed bank, as a dense packed weight."""
    return PackedWeight(bank.data[ei], bank.k, bank.n, bank.bits)


def _one_hot(ids: torch.Tensor, e: int) -> torch.Tensor:
    """[..., E] bool; a comparison, so nothing is read back to the host."""
    return ids[..., None] == torch.arange(e, device=ids.device)


def group_selections(topi: torch.Tensor, e: int, bm: int):
    """Sort the (token, expert) selections of topi [T, k] by expert into
    bm-row blocks (`eetq_tpu/modules/moe.py:122-160`). Static shapes: nb =
    n_sel // bm + E blocks, an expert's blocks contiguous, the padding blocks
    after the last real one clamped to a valid id. Returns (order: sorted
    selection -> selection, dest: the row of each sorted selection,
    block_expert int32 [nb], real_blocks int32 [1]: the number of blocks
    that hold a selection), all on topi's device."""
    n_sel = topi.numel()
    nb = n_sel // bm + e
    dev = topi.device
    eids = topi.reshape(-1)
    order = torch.argsort(eids, stable=True)
    e_sorted = eids[order]
    counts = _one_hot(eids, e).sum(0)  # [E]
    group_start = torch.cumsum(counts, 0) - counts
    nb_e = (counts + bm - 1) // bm  # blocks per expert
    cum_nb = torch.cumsum(nb_e, 0)
    block_start = cum_nb - nb_e
    block_expert = torch.searchsorted(
        cum_nb, torch.arange(nb, device=dev), right=True).clamp_(max=e - 1).to(torch.int32)
    pos = torch.arange(n_sel, device=dev) - group_start[e_sorted]
    dest = block_start[e_sorted] * bm + pos
    return order, dest, block_expert, cum_nb[-1:].to(torch.int32)


def moe_grouped_combine(
    moe: MoEMLP,
    x2: torch.Tensor,  # [T, H]
    topw: torch.Tensor,  # [T, k] f32
    topi: torch.Tensor,  # [T, k]
    activation: str,
) -> torch.Tensor:
    """Routed prefill (`eetq_tpu/modules/moe.py:122-208`): sort the (token,
    expert) selections by expert into bm-row blocks (`group_selections`),
    run one grouped GEMM per projection, then un-sort and combine with the
    routing weights. The GEMMs get the number of real blocks on the device
    and skip the padding blocks. Returns [T, H] f32."""
    t, h = x2.shape
    top_k = topi.shape[-1]
    e = moe.num_local_experts
    n_sel = t * top_k
    bm = _grouped_bm(n_sel, e)
    nb = n_sel // bm + e
    order, dest, block_expert, real_blocks = group_selections(topi, e, bm)

    xg = x2.new_zeros((nb * bm, h)).index_copy_(0, dest, x2[order // top_k])
    gu = w8a16_grouped_matmul(xg, moe.gateup.packed, moe.gateup.scales, block_expert,
                              real_blocks)
    hidden = _gated(gu, activation, x2.dtype)
    dn = w8a16_grouped_matmul(hidden, moe.down.packed, moe.down.scales, block_expert,
                              real_blocks)
    # un-sort, then the weighted sum over k in the original top-k order
    contrib = torch.empty((n_sel, h), dtype=dn.dtype, device=x2.device).index_copy_(
        0, order, dn[dest]).float()
    return (contrib.reshape(t, top_k, h) * topw.reshape(t, top_k, 1).float()).sum(1)


def moe_apply(
    moe: MoEMLP,
    x: torch.Tensor,
    top_k: int,
    activation: str = "silu",
    use_kernel: bool = True,
    mesh=None,
) -> torch.Tensor:
    """Routed MLP forward. x [B, S, H] (already normed) -> [B, S, H].
    use_kernel=False runs the masked scan with the plain products (the
    reference the kernel regimes are checked against). The A/B knobs
    (module docstring) are read here, on every call. mesh: the banks are
    this rank's experts, and the result its partial sum (module
    docstring)."""
    b, s, h = x.shape
    t = b * s
    x2 = x.reshape(t, h)
    quantized = isinstance(moe.gateup, QuantLinear)
    topw, topi = route(moe.router, x2, top_k)
    e = moe.num_local_experts
    n_sel = t * top_k
    ep = mesh is not None and e != moe.num_experts
    if ep:  # another rank's selections park on local expert 0 with zero weight
        off = mesh.tp_rank * e
        local = (topi >= off) & (topi < off + e)
        topi = torch.where(local, topi - off, 0)
        topw = torch.where(local, topw, 0.0)

    no_gather = os.environ.get("EETQ_MOE_NO_GATHER", "0") == "1"
    no_grouped = os.environ.get("EETQ_MOE_NO_GROUPED", "0") == "1"
    if (quantized and use_kernel and n_sel > MAX_DECODE_M and not (no_grouped or no_gather)
            and (not ep or top_k < e)):
        out2 = moe_grouped_combine(moe, x2, topw, topi, activation)
        return out2.to(x.dtype).reshape(b, s, h)
    if quantized and use_kernel and n_sel <= min(MAX_DECODE_M, e) and not no_gather:
        # one gather per projection over the selected experts only
        eids = topi.reshape(-1).to(torch.int32)
        sel = torch.arange(n_sel, device=x.device)
        gu_sel = w8a16_expert_matmul(x2, moe.gateup.packed, moe.gateup.scales, eids)
        hidden = _gated(gu_sel[sel, sel // top_k], activation, x2.dtype)  # [n_sel, I]
        dn_sel = w8a16_expert_matmul(hidden, moe.down.packed, moe.down.scales, eids)
        dn_rows = dn_sel[sel, sel].float()  # [n_sel, H]
        out2 = (dn_rows.reshape(t, top_k, h) * topw[..., None]).sum(1)
        return out2.to(x.dtype).reshape(b, s, h)

    # Masked scan: coeff[t, e] is the routing weight if expert e was picked
    # for token t, else 0. Exact for any T.
    coeff = (_one_hot(topi, e) * topw[..., None]).sum(-2)  # [T, E] f32
    if quantized and not use_kernel:
        gu_w, dn_w = unpack_weights(moe.gateup.packed), unpack_weights(moe.down.packed)
    acc = torch.zeros((t, h), dtype=torch.float32, device=x.device)
    for ei in range(e):
        if quantized and use_kernel:
            g_out = w8a16_matmul(x2, _expert(moe.gateup.packed, ei), moe.gateup.scales[ei])
            hidden = _gated(g_out, activation, x2.dtype)
            d_out = w8a16_matmul(hidden, _expert(moe.down.packed, ei), moe.down.scales[ei])
        elif quantized:
            g_out = w8a16_matmul_ref(x2, gu_w[ei], moe.gateup.scales[ei])
            hidden = _gated(g_out, activation, x2.dtype)
            d_out = w8a16_matmul_ref(hidden, dn_w[ei], moe.down.scales[ei])
        else:
            g_out = x2 @ moe.gateup.weight[ei].to(x2.dtype)
            hidden = _gated(g_out, activation, x2.dtype)
            d_out = hidden @ moe.down.weight[ei].to(hidden.dtype)
        acc = acc + coeff[:, ei, None] * d_out.float()
    return acc.to(x.dtype).reshape(b, s, h)
