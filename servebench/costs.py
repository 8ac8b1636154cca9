"""Operations and bytes of the deployments' work, from shapes alone.

`linear_cost` and `decode_cost` are frozen copies of `chip_smoke.py`'s
functions of the same names; the rest counts a whole model step from the
configuration file's dict (the published config.json keys). Each input
byte is counted read once and each output byte written once, whatever a
kernel reads again.
"""

from __future__ import annotations


def linear_cost(m: int, k: int, n: int, w_bytes: float, scale_rows: int = 1, x_bytes: int = 2,
                extra: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one quantized linear: the weight at w_bytes a
    value, scale_rows rows of f32 scales, x read and the bf16 output written
    once, `extra` bytes of gamma, per-token scales and the like."""
    return k * n * w_bytes + scale_rows * n * 4 + m * k * x_bytes + m * n * 2 + extra, 2.0 * m * k * n


def decode_cost(lens, hq: int, hkv: int, kv_bytes: int, scale_bytes: int,
                d: int = 128, s: int = 1, window: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of one flash-decode call of S query tokens a row
    over rows of `lens` keys: only the keys below each row's length are
    needed (K and V at kv_bytes a value and scale_bytes a key), under a
    window only those some token's window holds, q read and the output
    written once; token i of a row scores the len - S + i + 1 keys it sees,
    at most `window` of them."""
    w = window or 1 << 62
    keys = sum(min(n, w + s - 1) for n in lens)
    scored = sum(min(max(n - s + i + 1, 0), w) for n in lens for i in range(s))
    return (keys * hkv * 2 * (d * kv_bytes + scale_bytes) + len(lens) * (2 * s * hq * d * 2 + 4),
            4.0 * hq * d * scored)


def shape(cfg: dict) -> dict:
    h, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    d = cfg.get("head_dim") or h // hq
    return dict(h=h, i=cfg["intermediate_size"], hq=hq, hkv=cfg["num_key_value_heads"], d=d,
                v=cfg["vocab_size"], layers=cfg["num_hidden_layers"],
                e=cfg.get("num_local_experts") or 0, k=cfg.get("num_experts_per_tok", 2),
                window=cfg.get("sliding_window"))


def projections(cfg: dict) -> list[tuple[int, int]]:
    """(K, N) of a layer's dense projections: qkv and o, then gate|up and
    down where the MLP is dense."""
    s = shape(cfg)
    out = [(s["h"], (s["hq"] + 2 * s["hkv"]) * s["d"]), (s["hq"] * s["d"], s["h"])]
    if not s["e"]:
        out += [(s["h"], 2 * s["i"]), (s["i"], s["h"])]
    return out


def expert_banks(cfg: dict) -> list[tuple[int, int]]:
    """(K, N) of one expert's gate|up and down; none on a dense model."""
    s = shape(cfg)
    return [(s["h"], 2 * s["i"]), (s["i"], s["h"])] if s["e"] else []


def distinct_experts(cfg: dict, rows: int) -> float:
    """Expected experts that `rows` tokens select under uniform top-k
    routing: E (1 - (1 - k/E)^rows)."""
    s = shape(cfg)
    if not s["e"] or rows <= 0:
        return 0.0
    return s["e"] * (1.0 - (1.0 - s["k"] / s["e"]) ** rows)


def token_flops(cfg: dict, keys: int) -> float:
    """Model FLOPs of one token that attends over `keys` keys (itself
    included), the window applied: every projection it runs, its routed
    experts and the router, attention (q.k and p.v), and the lm_head."""
    s = shape(cfg)
    per_layer = sum(2.0 * k * n for k, n in projections(cfg))
    if s["e"]:
        per_layer += 2.0 * s["h"] * s["e"] + s["k"] * sum(2.0 * k * n for k, n in expert_banks(cfg))
    seen = min(keys, s["window"]) if s["window"] else keys
    per_layer += 4.0 * s["hq"] * s["d"] * seen
    return s["layers"] * per_layer + 2.0 * s["h"] * s["v"]


def decode_linear_least_s(cfg: dict, rows: int, peaks: dict) -> float:
    """The least time of one decode step's W8A16 products (the dense
    projections and the expert banks; not the bf16 router and lm_head) for
    `rows` busy rows: each product at the larger of its bytes at the HBM
    rate and its operations at the bf16 peak, each weight byte read once a
    step, the experts those rows select expected under uniform routing."""
    s = shape(cfg)
    bw, fl = peaks["hbm_bytes_s"], peaks["bf16_flops"]
    t = 0.0
    for k, n in projections(cfg):
        b, ops = linear_cost(rows, k, n, 1)
        t += max(b / bw, ops / fl)
    picks = rows * s["k"]
    for k, n in expert_banks(cfg):
        b = distinct_experts(cfg, rows) * (k * n + n * 4) + picks * (k + n) * 2
        t += max(b / bw, 2.0 * picks * k * n / fl)
    return s["layers"] * t


def admission_least_s(cfg: dict, tokens: int, peaks: dict) -> dict:
    """The least time of one admission of `tokens` real prompt tokens, by
    the arithmetic each product runs in: {"linear": the W8A8 projections
    (int8 peak) and the grouped expert products (bf16), "all": those plus
    the router, the causal attention (bf16) and the lm_head on the last
    token}."""
    s = shape(cfg)
    bw, fl, i8 = peaks["hbm_bytes_s"], peaks["bf16_flops"], peaks["int8_ops"]
    lin = 0.0
    for k, n in projections(cfg):
        b, ops = linear_cost(tokens, k, n, 1, x_bytes=1, extra=tokens * 4)
        lin += max(b / bw, ops / i8)
    picks = tokens * s["k"]
    for k, n in expert_banks(cfg):
        b = distinct_experts(cfg, tokens) * (k * n + n * 4) + picks * (k + n) * 2
        lin += max(b / bw, 2.0 * picks * k * n / fl)
    w = s["window"] or tokens
    pairs = sum(min(p, w) for p in range(1, tokens + 1))
    other = (4.0 * s["hq"] * s["d"] * pairs + 2.0 * tokens * s["h"] * s["e"]) / fl
    lin, other = s["layers"] * lin, s["layers"] * other
    return {"linear": lin, "all": lin + other + 2.0 * s["h"] * s["v"] / fl}


def rows_flops(cfg: dict, length: int, steps: int) -> float:
    """Model FLOPs of one busy row's `steps` decode steps from `length`
    committed positions: step j attends over length + j + 1 keys."""
    if steps <= 0:
        return 0.0
    s = shape(cfg)
    fixed = token_flops(cfg, 0)
    w = s["window"] or 1 << 62
    seen = sum(min(length + j + 1, w) for j in range(steps))
    return steps * fixed + s["layers"] * 4.0 * s["hq"] * s["d"] * seen
