#!/usr/bin/env python3
"""Serve the same HTTP requests from llama2-7b at W8A16, W4A16 g=128 and
W4A16 per-channel, in turns, on one CUDA card (the PyTorch port).

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_server_ab.py [--rounds N]

Served tokens/s of one run spreads by tens of percent on a shared host, so
two weight formats are compared only within one process, in turns: each
round drives `chip_smoke.server_path` (the default `Engine` behind
`EngineServer`, 12 requests from 4 threads, the same seeded prompts and
budgets for every model) once per model. All three models stay on the card
(about 15 GB). Prints the card's name and power limit, one line per run and
the per-model medians.
"""

from __future__ import annotations

import argparse
import gc
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import (
        quantize_params,
        random_dense_params,
        random_quantized_params,
    )

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_server_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = PRESETS[cs.MODEL]
    print(cs.card_line())

    def seeded():
        return torch.Generator(device=dev).manual_seed(cs.SEED)

    models = {"W8A16": (quantize_params(random_dense_params(cfg, seeded()),
                                        quantize_lm_head=True), "server")}
    gc.collect()
    torch.cuda.empty_cache()
    models[f"W4A16 g={cs.INT4_GROUP}"] = (random_quantized_params(
        cfg, seeded(), quantize_lm_head=True, bits=4, group_size=cs.INT4_GROUP), "int4_server")
    models["W4A16 per-channel"] = (random_quantized_params(
        cfg, seeded(), quantize_lm_head=True, bits=4), "int4_server")
    runs = {name: [] for name in models}
    for rnd in range(args.rounds):
        for name, (params, path) in models.items():
            r = cs.server_path(params, cfg, dev, torch.Generator(device=dev).manual_seed(1), path)
            runs[name].append(r["served_tok_s"])
            print(f"round {rnd} {name}: {r['tokens']} tokens in {r['wall_s']:.2f} s = "
                  f"{r['served_tok_s']:.2f} tok/s served", flush=True)
    for name, vals in runs.items():
        print(f"{name}: median {statistics.median(vals):.2f} tok/s served, runs "
              f"{['%.2f' % v for v in vals]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
