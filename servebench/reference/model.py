"""The plain reference: the deployment's model in float32, layer by layer.

Written from the published architecture (Mistral-7B and Mixtral-8x7B: a
llama-style decoder with grouped-query attention, rotary positions in the
NeoX half split, RMSNorm, a SiLU-gated MLP, and in Mixtral a top-2 router
over 8 experts whose two weights are a softmax over the selected logits)
and from EETQ's weight quantizer (per output channel, scale = max |w| /
128, values rounded half away from zero and clipped to [-128, 127]). It
imports torch and the benchmark's weight maker, nothing of the program:
it makes every layer's bf16 weights again from the seed
(`servebench/weights.py`), quantizes them with its own code, and runs the
sequences it is given through one layer at a time, so only one layer's
weights are held at once.

Every product is float32 with TF32 off. `precision="fp8"` is the control:
the input of every product (each projection, the router, every expert and
the lm_head) is first rounded per token to float8 e4m3 with its scale
absmax / 448, the next precision below the bf16 activations the
deployment states.

On an MoE model `logits(routes=...)` replays a given choice of experts
(the program's, for the check: `reference/check.py` says why) with the
weights of this model's own router logits at them, and measures how far
each replayed choice lies below this router's own top k.

Departures from the published model: none in the mathematics; weights are
random, and the KV cache, W8A8 admissions and bf16 activations of the
deployment are the program's precision, which this reference does not
copy (it states the model the deployment approximates).
"""

from __future__ import annotations

import torch

from servebench import weights

FP8_MAX = 448.0


def quantize(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """EETQ's symmetric int8 quantizer over the K axis of w [..., K, N]:
    (q int8, scale f32 [..., N])."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / 128.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    x = wf / safe.unsqueeze(-2)
    q = torch.trunc(x + torch.where(x >= 0, 0.5, -0.5)).clamp_(-128, 127)
    return q.to(torch.int8), scale


def dequantized(w: torch.Tensor) -> torch.Tensor:
    """The f32 weight the deployment's int8 values and scales stand for."""
    q, s = quantize(w)
    return q.float() * s.unsqueeze(-2)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded per row (last axis) to float8 e4m3 at scale absmax / 448."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    """The f32 model of `cfg` (the configuration file's dict) at `seed`."""

    def __init__(self, cfg: dict, seed: int, device, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 (the reference) or fp8 (the control)")
        self.cfg, self.seed, self.device, self.precision = cfg, seed, torch.device(device), precision
        self.h = cfg["hidden_size"]
        self.hq, self.hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.d = cfg.get("head_dim") or self.h // self.hq
        self.eps = cfg["rms_norm_eps"]
        self.window = cfg.get("sliding_window")
        self.top_k = cfg.get("num_experts_per_tok", 2)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = _round_fp8(x)
        return x @ w

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [T, heads, D] at positions pos [T], the NeoX half split."""
        d = self.d
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
        ang = pos.float()[:, None] * inv[None]
        cos, sin = ang.cos()[:, None], ang.sin()[:, None]
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal attention of q [T, Hq, D] over k, v [T, Hkv, D] with the
        sliding window: position p sees keys p - window + 1 .. p."""
        t = q.shape[0]
        g = self.hq // self.hkv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) * self.d ** -0.5
        i = torch.arange(t, device=q.device)
        allowed = i[None, :] <= i[:, None]
        if self.window:
            allowed &= i[None, :] > i[:, None] - self.window
        scores = scores.masked_fill(~allowed, float("-inf"))
        return torch.einsum("hqk,khd->qhd", scores.softmax(dim=-1), v)

    def _layer(self, x: torch.Tensor, w: dict, route: torch.Tensor | None = None,
               chosen: list | None = None) -> torch.Tensor:
        """One decoder layer over x [T, H]. On an MoE layer `route` [T, k],
        where given, is the experts to run (the program's choice, replayed;
        the weights are the softmax of this model's router logits at them),
        and the choice made is appended to `chosen`."""
        t = x.shape[0]
        hq, hkv, d = self.hq, self.hkv, self.d
        qkv = self._mm(self._norm(x), w["qkv"])
        q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
        pos = torch.arange(t, device=x.device)
        q = self._rope(q.reshape(t, hq, d), pos)
        k = self._rope(k.reshape(t, hkv, d), pos)
        attn = self._attention(q, k, v.reshape(t, hkv, d))
        x = x + self._mm(attn.reshape(t, hq * d), w["o"])
        y = self._norm(x)
        if "router" not in w:
            return x + self._mm(self._mlp(y, w["gateup"]), w["down"])
        logits = self._mm(y, w["router"])
        if route is None:
            top, ids = logits.topk(self.top_k, dim=-1)
        else:
            ids = route.to(x.device).long()
            top = logits.gather(1, ids)
            # how far the replayed choice lies below this router's own top-k
            kth = logits.topk(self.top_k, dim=-1).values[:, -1]
            short = kth - top.min(dim=1).values
            self.route_gap = max(self.route_gap, float(short.max()))
            self._route_sum += float(short.sum())
            self._route_count += short.numel()
        if chosen is not None:
            chosen.append(ids.to(torch.int8).cpu())
        coef = top.softmax(dim=-1)
        out = torch.zeros_like(x)
        for e in range(w["router"].shape[1]):
            rows, slot = (ids == e).nonzero(as_tuple=True)
            if rows.numel():
                ye = self._mm(self._mlp(y[rows], w["gateup"][e]), w["down"][e])
                out.index_add_(0, rows, ye * coef[rows, slot][:, None])
        return x + out

    def _mlp(self, y: torch.Tensor, gateup: torch.Tensor) -> torch.Tensor:
        gate, up = self._mm(y, gateup).chunk(2, dim=-1)
        return torch.nn.functional.silu(gate) * up

    def _weights(self, layer: int) -> dict:
        w = weights.layer_weights(self.cfg, self.seed, layer, self.device)
        out = {"qkv": dequantized(w["qkv"]), "o": dequantized(w["o"])}
        if "router" in w:
            out["router"] = w["router"].float()
            # one expert at a time: the scales are per expert either way
            out["gateup"] = torch.stack([dequantized(b) for b in w["gateup"]])
            out["down"] = torch.stack([dequantized(b) for b in w["down"]])
        else:
            out["gateup"], out["down"] = dequantized(w["gateup"]), dequantized(w["down"])
        return out

    @torch.no_grad()
    def logits(self, seqs: list[torch.Tensor], at: list[torch.Tensor],
               routes: list | None = None) -> list[torch.Tensor]:
        """f32 logits [len(at[i]), V] of sequence i (token ids [T_i]) at its
        positions at[i], each sequence from position 0. On an MoE model,
        routes[i] [layers, T_i, k] replays a choice of experts (then
        `route_gap` and `route_gap_mean` are the widest and the mean
        shortfall of a replayed choice's weaker router logit below this
        model's k-th best), and `chosen[i]` holds the choice this run made,
        [layers, T_i, k]."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        self.route_gap = 0.0
        self._route_sum, self._route_count = 0.0, 0
        chosen = [[] for _ in seqs]
        try:
            embed = weights.embedding(self.cfg, self.seed, self.device)
            xs = [embed[s.to(self.device)].float() for s in seqs]
            del embed
            for layer in range(self.cfg["num_hidden_layers"]):
                w = self._weights(layer)
                xs = [self._layer(x, w, None if routes is None else torch.as_tensor(routes[i][layer]),
                                  chosen[i]) for i, x in enumerate(xs)]
                del w
            self.chosen = [torch.stack(c) if c else None for c in chosen]
            self.route_gap_mean = self._route_sum / max(self._route_count, 1)
            head = weights.lm_head(self.cfg, self.seed, self.device).float()
            return [self._mm(self._norm(x[p.to(self.device)]), head) for x, p in zip(xs, at)]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
