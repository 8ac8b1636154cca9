#!/usr/bin/env python3
"""Comparisons in turns within one process, on one CUDA card (the PyTorch
port): three weight formats behind the server, or two trees' kernels.

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_server_ab.py [--rounds N]
    python3 scripts/torch_server_ab.py --kernels-of DIR [--rounds N]

The first form serves the same HTTP requests from llama2-7b at W8A16, W4A16
g=128 and W4A16 per-channel.

Served tokens/s of one run spreads by tens of percent on a shared host, so
two weight formats are compared only within one process, in turns: each
round drives `chip_smoke.server_path` (the default `Engine` behind
`EngineServer`, 12 requests from 4 threads, the same seeded prompts and
budgets for every model) once per model. All three models stay on the card
(about 15 GB). Prints the card's name and power limit, one line per run and
the per-model medians.

The second form compares this tree's prefill kernels with those of another
checkout of the repository in DIR (`git archive <commit> | tar -x -C DIR`):
DIR's kernel library is built by DIR's own `_build.py` in a child process
and loaded beside this tree's; `eetq_flash_attention_fwd` and
`eetq_w8a16_gemm` (the same C signatures in both trees) are timed in the
order DIR, here, here, DIR per round at llama2-7b's prefill shapes (one
event pair per launch after an L2 flush, and many launches back to back:
`chip_smoke.time_ms` and `time_many_ms`), and llama2-7b W8A16 runs its
b=1, 1024-token prefill with this tree's Python through either library's
two kernels in the same order.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


AB_ENTRIES = ("eetq_flash_attention_fwd", "eetq_w8a16_gemm")


def kernels_ab(other_dir: str, rounds: int) -> int:
    """This tree's prefill kernels against those of the checkout in
    `other_dir`, in turns."""
    import torch

    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.kernels.flash_attention import flash_attention
    from eetq_tpu_torch.kernels.w8a16 import w8a16_gemm
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import prefill

    dev = torch.device("cuda", 0)
    print(cs.card_line())
    built = subprocess.run(
        [sys.executable, "-c", "from eetq_tpu_torch.kernels import _build; "
                               "i = _build.build(); print(i['seconds']); print(i['path'])"],
        cwd=other_dir, capture_output=True, text=True, check=True, timeout=900)
    other_s, other_path = built.stdout.strip().splitlines()[-2:]
    other = ctypes.CDLL(other_path)
    for name in AB_ENTRIES:
        fn = getattr(other, name)
        fn.argtypes, fn.restype = list(_build.SIGNATURES[name]), ctypes.c_int
    here = _build.build()
    print(f"kernels of {other_dir} built in {float(other_s):.1f} s, of this tree in "
          f"{here['seconds']:.1f} s (cached: {here['cached']})")
    launch_here = _build.launch

    def launch_other(name, *args):
        if name not in AB_ENTRIES:
            return launch_here(name, *args)
        rc = getattr(other, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} of {other_dir} failed: CUDA error {rc}")

    trees = {"other": launch_other, "here": launch_here}
    order = ("other", "here", "here", "other")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    cases = {}
    b, sq, skv, hq, hkv, d = cs.ATTENTION_CASES[0]
    q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn(b, skv, 2 * hkv, d, generator=gen, device=dev).to(torch.bfloat16)
    cases[f"flash_attention_fwd B={b} S={sq} H={hq} D={d}"] = (
        lambda: flash_attention(q, kv[:, :, :hkv], kv[:, :, hkv:]))
    for k, n in cs.LLAMA_SHAPES:
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        sc = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
        x = torch.randn(1024, k, generator=gen, device=dev).to(torch.bfloat16)
        cases[f"w8a16_gemm m=1024 K={k} N={n}"] = (
            lambda x=x, qw=qw, sc=sc, n=n: w8a16_gemm(x, qw, sc, n))
    with torch.inference_mode():
        for case, fn in cases.items():
            _build.launch = launch_other
            ref = fn()
            _build.launch = launch_here
            err = (fn().float() - ref.float()).abs().max().item()
            single = {t: [] for t in trees}
            many = {t: [] for t in trees}
            for _ in range(rounds):
                for tree in order:
                    _build.launch = trees[tree]
                    single[tree].append(cs.time_ms(fn, flush=flush))
                    many[tree].append(cs.time_many_ms(fn, single[tree][-1], flush))
            _build.launch = launch_here
            print(f"{case}: max |here - other| {err:.3e}; " + "; ".join(
                f"{t} {statistics.median(single[t]):.4f} ms (back to back "
                f"{statistics.median(many[t]):.4f})" for t in trees), flush=True)
    del cases, flush
    gc.collect()
    torch.cuda.empty_cache()

    cfg = PRESETS[cs.MODEL]
    params = quantize_params(random_dense_params(cfg, gen), quantize_lm_head=True)
    _, p1, n1 = cs.REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p1), generator=gen, device=dev)
    runs = {t: [] for t in trees}
    for rnd in range(rounds + 1):  # the first round warms up
        for tree in order:
            _build.launch = trees[tree]
            caches = init_caches(cfg, 1, p1 + n1, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, cfg, prompt, caches)
            torch.cuda.synchronize()
            if rnd:
                runs[tree].append(1e3 * (time.perf_counter() - t0))
    _build.launch = launch_here
    for t, vals in runs.items():
        print(f"{cs.MODEL} W8A16 prefill b=1 p={p1}, kernels of {t}: median "
              f"{statistics.median(vals):.2f} ms, runs {['%.2f' % v for v in vals]}")
    return 0


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
    parser.add_argument("--kernels-of", metavar="DIR",
                        help="compare this tree's prefill kernels with the checkout in DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_server_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.kernels_of:
        return kernels_ab(args.kernels_of, args.rounds)
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
