#!/usr/bin/env python3
"""Tune the dense W8A16 / W4A16 matmul's launch choices for one preset on a
CUDA card (the PyTorch port) and persist the winners.

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_autotune.py --preset llama2-7b --batch 8 [--bits 4]
        [--rows 256,512] [--cache PATH]

`kernels/autotune.py::autotune_shapes` sweeps the preset's four projections
(qkv, o_proj, gate|up, down) at m = batch (the decode GEMV's K split) and m =
1024 (the per-channel GEMM's 128- or 256-row tile), and at each m of --rows;
each sweep times its candidates in turns over distinct weight copies of
128 MB in all. The winners go to the cache file (`--cache`, else
EETQ_AUTOTUNE_CACHE, else ~/.cache/eetq_tpu_torch/autotune.json), keyed by
the card's name, which every later launch on that card reads. Printed: each
shape's winner, its time and the rule's time (ms a call), and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="llama2-7b")
    parser.add_argument("--batch", type=int, default=1, help="decode rows (the GEMV's m)")
    parser.add_argument("--bits", type=int, default=8, choices=(8, 4))
    parser.add_argument("--rows", default="", help="more GEMM rows to tune, comma-separated")
    parser.add_argument("--cache", help="the cache file (sets EETQ_AUTOTUNE_CACHE)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_autotune: no CUDA device; nothing was tuned", file=sys.stderr)
        return 1
    if args.cache:
        os.environ["EETQ_AUTOTUNE_CACHE"] = args.cache
    from eetq_tpu_torch.kernels import autotune
    from eetq_tpu_torch.models.config import PRESETS

    autotune.clear_caches()
    cfg = PRESETS[args.preset]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    tuned = autotune.autotune_shapes(cfg=cfg, bits=args.bits, batch=args.batch, verbose=False)
    h, i = cfg.hidden_size, cfg.intermediate_size
    proj = [(h, cfg.qkv_out), (cfg.num_heads * cfg.head_dim, h), (h, 2 * i), (i, h)]
    extra = [int(m) for m in args.rows.split(",") if m]
    if extra:
        tuned.update(autotune.autotune_shapes([(m, k, n) for m in extra for k, n in proj],
                                              bits=args.bits, verbose=False))
    for key, t in tuned.items():
        print(f"{key}: {t.what}={t.choice} {t.ms[t.choice]:.4f} ms; the rule's {t.what}="
              f"{t.rule} {t.ms[t.rule]:.4f} ms ({100 * t.gain:+.1f}%)")
    print(f"cache: {autotune.cache_path()} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
