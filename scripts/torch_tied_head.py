#!/usr/bin/env python3
"""A tied head's cost on a CUDA card (the PyTorch port): the bf16 embedding
table as the lm_head, two ways, at full width and depth.

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_tied_head.py [--preset gemma-7b] [--rounds 2]

- chunked: `models/transformer.py::_tied_head`, the table widened to f32
  one 64 MB chunk at a time, each chunk multiplied in f32 (exact bf16
  products summed in f32);
- product: one bf16 product with an f32 output (`torch.mm(..., out_dtype=
  torch.float32)`: the same exact products, summed in f32 in another order).

Printed: each form's device time alone at 1 and 8 rows (CUDA events, median
of 20), their largest difference over the largest logit, and bench decode
(b=1, a 1024-token prompt, int8 KV, fused MLP, 50 greedy tokens) through
`decode_loop` with each form in turns: ms a replayed step and ms/step over
the 49 steps, with the greedy tokens of the two compared.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def product(x, embed):
    import torch

    flat = x.reshape(-1, x.shape[-1])
    return torch.mm(flat, embed.t(), out_dtype=torch.float32).reshape(*x.shape[:-1], -1)


def main() -> int:
    import torch

    from eetq_tpu_torch.models import transformer as tr
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="gemma-7b")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_tied_head: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    cfg = PRESETS[args.preset]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = random_quantized_params(cfg, gen, quantize_lm_head=True)
    if params.lm_head is not None:
        print(f"{args.preset} has no tied head", file=sys.stderr)
        return 1
    head = tr._tied_head
    forms = {"chunked": head, "product": product}
    with torch.inference_mode():
        for m in (1, 8):
            x = torch.randn(m, 1, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
            a, b = head(x, params.embed), product(x, params.embed)
            diff = (a - b).abs().max().item() / a.abs().max().item()
            times = {name: cs.time_ms(lambda f=f: f(x, params.embed)) for name, f in forms.items()}
            print(f"{args.preset} tied head, {m} row(s): chunked {times['chunked']:.4f} ms, "
                  f"product {times['product']:.4f} ms; largest difference {diff:.3e} of the "
                  f"largest logit")
    p, n = 1024, cs.FAMILY_NEW_TOKENS
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=gen, device=dev)
    runs = {name: dict(replay=[], step=[]) for name in forms}
    tokens = {}
    order = [name for _ in range(args.rounds) for name in ("chunked", "product", "product",
                                                           "chunked")]
    try:
        for name in order:
            tr._tied_head = forms[name]
            caches = tr.init_caches(cfg, 1, p + n, device=dev, dtype=torch.int8)
            lp, caches = prefill(params, cfg, prompt, caches)
            torch.cuda.synchronize()
            rec = {}
            t0 = time.perf_counter()
            toks, _ = decode_loop(params, cfg, torch.argmax(lp, -1), p, caches, n,
                                  fused_mlp=True, stats=rec)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            runs[name]["step"].append(wall / (n - 1))
            runs[name]["replay"].append((wall - rec["warm_ms"] - rec["capture_ms"]) / (n - 2))
            tokens.setdefault(name, toks)
            del caches
    finally:
        tr._tied_head = head
    for name, r in runs.items():
        print(f"{args.preset} bench decode b=1 p={p}, {name} head: "
              f"{statistics.median(r['replay']):.3f} ms a replayed step "
              f"({['%.3f' % v for v in r['replay']]}), {statistics.median(r['step']):.3f} "
              f"ms/step over {n - 1} steps")
    same = torch.equal(tokens["chunked"], tokens["product"])
    print(f"greedy tokens of the two heads equal: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
