#!/usr/bin/env python3
"""Comparisons in turns within one process, on one CUDA card (the PyTorch
port): three weight formats behind the server, two trees' kernels, the
grouped GEMM's two designs, or the two Mixtral models' decode.

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_server_ab.py [--rounds N]
    python3 scripts/torch_server_ab.py --kernels-of DIR [--rounds N] [--kernels-only]
    python3 scripts/torch_server_ab.py --grouped-sweep [--rounds N]
    python3 scripts/torch_server_ab.py --mixtral-decode [--rounds N]

The first form serves the same HTTP requests from llama2-7b at W8A16, W4A16
g=128 and W4A16 per-channel.

Served tokens/s of one run spreads by tens of percent on a shared host, so
two weight formats are compared only within one process, in turns: each
round drives `chip_smoke.server_path` (the default `Engine` behind
`EngineServer`, 12 requests from 4 threads, the same seeded prompts and
budgets for every model) once per model. All three models stay on the card
(about 15 GB). Prints the card's name and power limit, one line per run and
the per-model medians.

The second form compares this tree's kernels with those of another
checkout of the repository in DIR (`git archive <commit> | tar -x -C DIR`):
DIR's kernel library is built by DIR's own `_build.py` in a child process
and loaded beside this tree's, with DIR's own argument types
(`_build.SIGNATURES`; where this tree's entry point takes one more
argument, the count of real blocks before the stream, it is dropped for
DIR). Timed in the order DIR, here, here, DIR per round (one event pair per
launch after an L2 flush, and many launches back to back:
`chip_smoke.time_ms` and `time_many_ms`): `eetq_flash_attention_fwd`; the
dense GEMMs at llama2-7b's four prefill shapes, summed over them
(`AB_DENSE`: `eetq_w8a16_gemm` per-channel at m=1024 and m=9 and g=128,
`eetq_w4a16_gemm` g=128, `eetq_w8a8_gemm` and `eetq_w4a8_gemm` per-channel
and g=128 at m=1024 and at a short admission's m=128); and the grouped GEMMs
(`eetq_w8a16_grouped_gemm` per-channel, `eetq_w4a16_grouped_gemm` g=128) on
Mixtral-8x7B's banks at bm=128 nb=24 (a 1024-token prompt) and bm=8 nb=10
(an 8-slot engine step), this tree also without the count of real blocks
(every padding block computed, as DIR does). Then, with this tree's Python
through either library: the b=1, 1024-token prefill of llama2-7b W8A16 and
W4A16 g=128 (`int4_generate`'s model) and of both Mixtral-8x7B models; one
admission of a 1024-token prompt through each llama2-7b model's default
`Engine` (W8A8, W4A8 g=128: an engine step that admits it and asks for one
token); and the W4A16 g=128 Mixtral's paged int8 engine: ms per 8-slot
decode step and served tok/s (`chip_smoke.server_path`). `--kernels-only`
stops after the kernel cases.

`--grouped-sweep` times the grouped GEMM's skinny tile against its
128-row tile on Mixtral's banks at bm in {8, 16, 32} (and the 128-row tile
at 48, 64, 128), 8 real blocks of one expert each, to place
`GROUPED_SKINNY_BM`: a second library with `GROUPED_SKINNY_BM = 0` (the
wide tile only) is built in a child process.

`--mixtral-decode` builds Mixtral-8x7B W8A16 and W4A16 g=128 side by side
(71.9 GB) and times b=1 decode (a 1024-token prompt, 50 greedy tokens,
ms per step) in the order int8, int4, int4, int8 per round.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

AB_ENTRIES = ("eetq_flash_attention_fwd", "eetq_w8a16_gemm", "eetq_w4a16_gemm",
              "eetq_w8a8_gemm", "eetq_w4a8_gemm", "eetq_w8a16_grouped_gemm",
              "eetq_w4a16_grouped_gemm")
# dense GEMM cases of the A/B at llama2-7b's four prefill shapes, each summed
# over them: (kernel, bits, group, rows); m=9 leaves most of a row block
# dead, m=128 is a short admission
AB_DENSE = [("w8a16_gemm", 8, None, 1024), ("w8a16_gemm", 8, None, 9),
            ("w8a16_gemm", 8, cs.INT4_GROUP, 1024), ("w4a16_gemm", 4, cs.INT4_GROUP, 1024),
            ("w8a8_gemm", 8, None, 1024), ("w8a8_gemm", 8, None, 128),
            ("w4a8_gemm", 4, None, 1024), ("w4a8_gemm", 4, None, 128),
            ("w4a8_gemm", 4, cs.INT4_GROUP, 1024), ("w4a8_gemm", 4, cs.INT4_GROUP, 128)]
ORDER = ("other", "here", "here", "other")
# grouped GEMM cases of the A/B: (bits, group, bm, nb, experts of the real blocks)
AB_GROUPED = [(bits, group, bm, nb, real)
              for bits, group in ((8, None), (4, cs.INT4_GROUP))
              for bm, nb, real, regime in cs.GROUPED_CASES if regime is not None]
SWEEP_BM = (8, 16, 32, 48, 64, 128)


def _child_library(cwd: str, prelude: str = ""):
    """Build the kernel library of the tree in `cwd` in a child process
    (after running `prelude` there) and load it: (CDLL, build seconds)."""
    code = (prelude + "from eetq_tpu_torch.kernels import _build; import json; i = _build.build(); "
            "print(json.dumps(dict(s=i['seconds'], path=i['path'], sig={n: [t.__name__ for t in a] "
            "for n, a in _build.SIGNATURES.items()})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         check=True, timeout=900)
    info = json.loads(out.stdout.strip().splitlines()[-1])
    lib = ctypes.CDLL(info["path"])
    for name, types in info["sig"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [getattr(ctypes, t) for t in types], ctypes.c_int
    return lib, info["s"], {name: len(types) for name, types in info["sig"].items()}


def _launcher(lib, arity: dict, entries, what: str):
    """A stand-in for `_build.launch` that sends `entries` to `lib`."""
    from eetq_tpu_torch.kernels import _build

    launch_here = _build.launch

    def launch(name, *args):
        if name not in entries:
            return launch_here(name, *args)
        if len(args) == arity[name] + 1:  # this tree's count of real blocks: not taken there
            args = args[:-2] + args[-1:]
        rc = getattr(lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} of {what} failed: CUDA error {rc}")

    return launch


def _in_turns(trees: dict, order, rounds: int, fn):
    """fn() under each tree's launcher in `order`, `rounds` times; returns
    {tree: [fn() results]}."""
    from eetq_tpu_torch.kernels import _build

    here = _build.launch
    out = {t: [] for t in trees}
    try:
        for _ in range(rounds):
            for tree in order:
                _build.launch = trees[tree]
                out[tree].append(fn(tree))
    finally:
        _build.launch = here
    return out


def _time_cases(cases: dict, trees: dict, order, rounds: int, flush) -> dict:
    """Each case fn(tree) -> a callable, timed in turns; prints and returns
    {case: {tree: (median ms, median back-to-back ms)}}; the outputs of the
    trees are compared with the first tree's."""
    import torch

    from eetq_tpu_torch.kernels import _build

    here = _build.launch
    res = {}
    for case, make in cases.items():
        outs = {}
        for tree in trees:
            _build.launch = trees[tree]
            outs[tree] = make(tree)()
        _build.launch = here
        first = next(iter(outs.values()))
        diff = {t: (o.float() - first.float()).abs().max().item() for t, o in outs.items()}

        def one(tree):
            fn = make(tree)
            single = cs.time_ms(fn, flush=flush)
            return single, cs.time_many_ms(fn, single, flush)

        runs = _in_turns(trees, order, rounds, one)
        res[case] = {t: (statistics.median(r[0] for r in v), statistics.median(r[1] for r in v))
                     for t, v in runs.items()}
        print(f"{case}: max |tree - {next(iter(trees))}| "
              f"{', '.join(f'{t} {d:.3e}' for t, d in diff.items())}; " + "; ".join(
                  f"{t} {ms:.4f} ms (back to back {b2b:.4f})" for t, (ms, b2b) in res[case].items()),
              flush=True)
        del outs
        torch.cuda.synchronize()
    return res


def _bank(gen, dev, bits, group, k, n):
    import torch

    from eetq_tpu_torch.layout.tiling import pack_weights

    lo, hi = (-127, 128) if bits == 8 else (-8, 8)
    q = torch.randint(lo, hi, (8, k, n), generator=gen, device=dev, dtype=torch.int8)
    data = pack_weights(q, bits=bits).data
    shape = (8, n) if group is None else (8, k // group, n)
    return data, torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4


def _grouped_cases(gen, dev, specs, count_for) -> dict:
    """{case: make(tree) -> callable} of the grouped GEMM on Mixtral's two
    banks per spec (bits, group, bm, nb, real experts); count_for(tree):
    whether that tree passes the count of real blocks."""
    import torch

    from eetq_tpu_torch.kernels.w8a16 import w4a16_grouped_gemm, w8a16_grouped_gemm

    cases = {}
    for bits, group, bm, nb, real in specs:
        gemm = w8a16_grouped_gemm if bits == 8 else w4a16_grouped_gemm
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'}"
        for k, n in cs.MIXTRAL_BANKS:
            data, scales = _bank(gen, dev, bits, group, k, n)
            be = real + (7,) * (nb - len(real))
            x = torch.randn(nb * bm, k, generator=gen, device=dev).to(torch.bfloat16)
            x[len(real) * bm:] = 0
            blocks = torch.tensor(be, dtype=torch.int32, device=dev)
            count = torch.tensor([len(real)], dtype=torch.int32, device=dev)
            cases[f"{gemm.__name__} {tag} bm={bm} nb={nb} K={k} N={n}"] = (
                lambda tree, gemm=gemm, x=x, data=data, scales=scales, blocks=blocks, n=n,
                count=count: (lambda: gemm(x, data, scales, blocks, n,
                                           count if count_for(tree) else None)))
    return cases


def _dense_cases(gen, dev, specs) -> tuple[dict, dict]:
    """({case: make(tree) -> callable}, {case: bound ms}) of the dense GEMMs
    on llama2-7b's four prefill shapes per spec (kernel, bits, group, rows):
    the W8A16/W4A16 GEMMs on bf16 x, W8A8/W4A8 on per-token int8 x; the
    bound as `chip_smoke.py` computes it."""
    import torch

    from eetq_tpu_torch.kernels import w8a8, w8a16
    from eetq_tpu_torch.layout.tiling import pack_weights

    cases, bounds = {}, {}
    for name, bits, group, m in specs:
        gemm = getattr(w8a8 if "a8" in name else w8a16, name)
        a8 = "a8" in name
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'} m={m}"
        for k, n in cs.W8A8_SHAPES:
            lo, hi = (-127, 128) if bits == 8 else (-8, 8)
            q = torch.randint(lo, hi, (k, n), generator=gen, device=dev, dtype=torch.int8)
            data = pack_weights(q, bits=bits).data
            shape = (n,) if group is None else (k // group, n)
            sc = torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            if "a8" in name:
                xq, sx = w8a8.quantize_activations(x)
                kw = {} if bits == 8 else {"group_size": group}
                call = (lambda gemm=gemm, xq=xq, sx=sx, data=data, sc=sc, n=n, kw=kw:
                        gemm(xq, sx, data, sc, n, **kw))
            else:
                call = lambda gemm=gemm, x=x, data=data, sc=sc, n=n: gemm(x, data, sc, n)
            case = f"{name} {tag} K={k} N={n}"
            cases[case] = lambda tree, call=call: call
            size, ops = cs.linear_cost(m, k, n, bits / 8, 1 if group is None else k // group,
                                       x_bytes=1 if a8 else 2, extra=4 * m if a8 else 0)
            bounds[case] = 1e3 * max(size / cs.HBM_BYTES_PER_S,
                                     ops / cs.PEAK_OPS_PER_S["int8" if a8 else "bf16"])
    return cases, bounds


def _sum_pairs(res: dict, what: str = "gate|up + down", bounds: dict | None = None) -> None:
    """Print the sum over shapes ("K=..." in the case name) per kernel and
    mode: gate|up + down of grouped results, the four layer shapes of dense
    ones (with the sum of their bounds, where given)."""
    sums = {}
    for case, per in res.items():
        key = case.split(" K=")[0]
        for t, (ms, b2b) in per.items():
            a = sums.setdefault(key, {}).setdefault(t, [0.0, 0.0])
            a[0] += ms
            a[1] += b2b
    for key, per in sums.items():
        bound = "" if bounds is None else "; bound {:.4f} ms".format(
            sum(b for case, b in bounds.items() if case.split(" K=")[0] == key))
        print(f"{key}, {what}: " + "; ".join(
            f"{t} {ms:.4f} ms (back to back {b2b:.4f})" for t, (ms, b2b) in per.items()) + bound)


def _prefill_ms(params, cfg, dev, prompt, n_new):
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import prefill

    caches = init_caches(cfg, 1, prompt.shape[1] + n_new, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, cfg, prompt, caches)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _engine_step_ms(params, cfg, dev, gen, engine_kw, steps: int = 10) -> float:
    """ms per decode step of an engine with its 8 slots busy."""
    import torch

    from eetq_tpu_torch.serve.engine import Engine

    eng = Engine(params, cfg, max_batch=8, max_len=2048, **engine_kw)
    for _ in range(8):
        ids = torch.randint(0, cfg.vocab_size, (100,), generator=gen, device=dev).tolist()
        eng.add_request(ids, max_new_tokens=steps + 16)
    while eng.queue:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    eng.run()
    return ms


def _admission_ms(eng, cfg, dev, gen, prompt_len: int) -> float:
    """ms of one engine step that admits a single prompt of prompt_len
    tokens asking for one token: the prefill forward and the first token,
    no decode step."""
    import torch

    ids = torch.randint(0, cfg.vocab_size, (prompt_len,), generator=gen, device=dev).tolist()
    eng.add_request(ids, max_new_tokens=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _profile_admission(eng, cfg, dev, gen, prompt_len: int, tree: str, top: int = 8) -> None:
    """One admission (as `_admission_ms`) under torch.profiler: wall ms,
    device-busy ms, kernel launches, idle share and the kernels that take
    the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ids = torch.randint(0, cfg.vocab_size, (prompt_len,), generator=gen, device=dev).tolist()
    eng.add_request(ids, max_new_tokens=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, launches = cs._device_events(prof)
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name] = per.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    print(f"    {tree}, profiled: wall {wall:.2f} ms, device busy {busy:.2f} ms, {launches} launches, "
          f"idle share {1 - busy / wall:.3f}; most device time: " + "; ".join(
              f"{name[:60]} {ms:.2f}" for name, ms in sorted(per.items(), key=lambda kv: -kv[1])[:top]),
          flush=True)


def _report(label: str, runs: dict, unit: str = "ms") -> None:
    for t, vals in runs.items():
        print(f"{label}, {t}: median {statistics.median(vals):.2f} {unit}, runs "
              f"{['%.2f' % v for v in vals]}", flush=True)


def kernels_ab(other_dir: str, rounds: int, models: bool = True) -> int:
    """This tree's kernels and prefill against those of the checkout in
    `other_dir`, in turns; models=False times the kernel cases only."""
    import torch

    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.kernels.flash_attention import flash_attention
    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.serve.engine import Engine
    from eetq_tpu_torch.models.init import (
        quantize_params,
        random_dense_params,
        random_quantized_params,
    )

    dev = torch.device("cuda", 0)
    print(cs.card_line())
    other, other_s, arity = _child_library(other_dir)
    here = _build.build()
    print(f"kernels of {other_dir} built in {other_s:.1f} s, of this tree in "
          f"{here['seconds']:.1f} s (cached: {here['cached']})")
    trees = {"other": _launcher(other, arity, AB_ENTRIES, other_dir), "here": _build.launch}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    cases = {}
    b, sq, skv, hq, hkv, d = cs.ATTENTION_CASES[0]
    q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn(b, skv, 2 * hkv, d, generator=gen, device=dev).to(torch.bfloat16)
    cases[f"flash_attention_fwd B={b} S={sq} H={hq} D={d}"] = (
        lambda tree: lambda: flash_attention(q, kv[:, :, :hkv], kv[:, :, hkv:]))
    with torch.inference_mode():
        _time_cases(cases, trees, ORDER, rounds, flush)
        cases.clear()
        for spec in AB_DENSE:  # one spec's weights on the card at a time
            dense, bounds = _dense_cases(gen, dev, [spec])
            _sum_pairs(_time_cases(dense, trees, ORDER, rounds, flush), "four shapes", bounds)
            del dense
        # the grouped GEMMs, this tree also without the count of real blocks
        trees3 = dict(trees, here_all_blocks=_build.launch)
        res = _time_cases(_grouped_cases(gen, dev, AB_GROUPED, lambda t: t == "here"), trees3,
                          ORDER + ("here_all_blocks", "here_all_blocks"), rounds, flush)
        _sum_pairs(res)
    del cases, flush, q, kv
    gc.collect()
    torch.cuda.empty_cache()
    if not models:
        return 0

    _, p1, n1 = cs.REQUESTS[0]

    def seeded():
        return torch.Generator(device=dev).manual_seed(cs.SEED)

    for name, make in (
            (f"{cs.MODEL} W8A16", lambda: quantize_params(
                random_dense_params(PRESETS[cs.MODEL], seeded()), quantize_lm_head=True)),
            (f"{cs.MODEL} W4A16 g={cs.INT4_GROUP}", lambda: random_quantized_params(
                PRESETS[cs.MODEL], seeded(), quantize_lm_head=True, bits=4,
                group_size=cs.INT4_GROUP)),
            (f"{cs.MIXTRAL} W8A16", lambda: random_quantized_params(
                PRESETS[cs.MIXTRAL], seeded(), quantize_lm_head=True)),
            (f"{cs.MIXTRAL} W4A16 g={cs.INT4_GROUP}", lambda: random_quantized_params(
                PRESETS[cs.MIXTRAL], seeded(), quantize_lm_head=True, bits=4,
                group_size=cs.INT4_GROUP))):
        cfg = PRESETS[cs.MODEL if name.startswith(cs.MODEL) else cs.MIXTRAL]
        t0 = time.perf_counter()
        params = make()
        torch.cuda.synchronize()
        print(f"{name} built in {time.perf_counter() - t0:.1f} s", flush=True)
        prompt = torch.randint(0, cfg.vocab_size, (1, p1), generator=gen, device=dev)
        _prefill_ms(params, cfg, dev, prompt, n1)  # warm
        _report(f"{name} prefill b=1 p={p1}", _in_turns(
            trees, ORDER, rounds, lambda t: _prefill_ms(params, cfg, dev, prompt, n1)))
        if name.startswith(cs.MODEL):  # the default engine: W8A8 / W4A8 at admission
            eng = Engine(params, cfg, max_batch=8, max_len=2048)
            _admission_ms(eng, cfg, dev, gen, p1)  # warm
            _report(f"{name} engine admission of one {p1}-token prompt "
                    f"({'W8A8' if 'W8A16' in name else 'W4A8'})", _in_turns(
                        trees, ORDER, rounds, lambda t: _admission_ms(eng, cfg, dev, gen, p1)))
            _in_turns(trees, ("other", "here"), 1, lambda t: _profile_admission(
                eng, cfg, dev, gen, p1, t))
            del eng
        elif "W4A16" in name:
            kw = dict(paged_blocks=cs.PAGED_BLOCKS, paged_block_size=cs.PAGED_BLOCK_SIZE,
                      kv_dtype=torch.int8)
            _report(f"{name} paged int8 engine, ms per 8-slot decode step", _in_turns(
                trees, ORDER, rounds, lambda t: _engine_step_ms(params, cfg, dev, gen, kw)))
            _report(f"{name} paged int8 engine behind the server", _in_turns(
                trees, ORDER, rounds, lambda t: cs.server_path(
                    params, cfg, dev, torch.Generator(device=dev).manual_seed(1),
                    "mixtral_int4_paged_server", kw)["served_tok_s"]), "tok/s served")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def grouped_sweep(rounds: int) -> int:
    """The skinny tile against the 128-row tile over bm."""
    import torch

    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.kernels.autotune import GROUPED_SKINNY_BM

    dev = torch.device("cuda", 0)
    print(cs.card_line())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wide, wide_s, arity = _child_library(
        root, "import importlib, eetq_tpu_torch.kernels.autotune as a, "
              "eetq_tpu_torch.kernels._build as b; a.GROUPED_SKINNY_BM = 0; importlib.reload(b); ")
    print(f"wide-only library built in {wide_s:.1f} s; this tree's skinny tile up to "
          f"{GROUPED_SKINNY_BM} rows")
    entries = ("eetq_w8a16_grouped_gemm", "eetq_w4a16_grouped_gemm")
    trees = {"wide": _launcher(wide, arity, entries, "the wide-only library"),
             "here": _build.launch}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    specs = [(bits, group, bm, 16, tuple(range(8))) for bits, group in ((8, None), (4, cs.INT4_GROUP))
             for bm in SWEEP_BM]
    with torch.inference_mode():
        for spec in specs:
            order = ("wide", "here", "here", "wide") if spec[2] <= GROUPED_SKINNY_BM else ("here",)
            res = _time_cases(_grouped_cases(gen, dev, [spec], lambda t: True),
                              {t: trees[t] for t in dict.fromkeys(order)}, order, rounds, flush)
            _sum_pairs(res)
    return 0


def mixtral_decode(rounds: int) -> int:
    """Mixtral-8x7B W8A16 against W4A16 g=128, b=1 decode, in turns."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    dev = torch.device("cuda", 0)
    print(cs.card_line())
    cfg = PRESETS[cs.MIXTRAL]
    models = {}
    for name, kw in (("W8A16", {}), (f"W4A16 g={cs.INT4_GROUP}",
                                      dict(bits=4, group_size=cs.INT4_GROUP))):
        t0 = time.perf_counter()
        models[name] = random_quantized_params(
            cfg, torch.Generator(device=dev).manual_seed(cs.SEED), quantize_lm_head=True, **kw)
        torch.cuda.synchronize()
        print(f"{cs.MIXTRAL} {name} built in {time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card", flush=True)
    _, p1, n1 = cs.REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p1),
                           generator=torch.Generator(device=dev).manual_seed(2), device=dev)

    def decode_ms(name):
        params = models[name]
        caches = init_caches(cfg, 1, p1 + n1, device=dev)
        lp, caches = prefill(params, cfg, prompt, caches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_loop(params, cfg, torch.argmax(lp, -1), p1, caches, n1)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (n1 - 1)

    names = list(models)
    decode_ms(names[0])  # warm
    decode_ms(names[1])
    runs = {n: [] for n in names}
    for _ in range(rounds):
        for name in (names[0], names[1], names[1], names[0]):
            runs[name].append(decode_ms(name))
            print(f"  {name}: {runs[name][-1]:.3f} ms/step", flush=True)
    _report(f"{cs.MIXTRAL} decode b=1 p={p1} n={n1}, ms per step", runs)
    print(f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
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
                        help="compare this tree's kernels with the checkout in DIR")
    parser.add_argument("--kernels-only", action="store_true",
                        help="with --kernels-of: the kernel cases only, no model")
    parser.add_argument("--grouped-sweep", action="store_true",
                        help="time the grouped GEMM's skinny tile against its wide one over bm")
    parser.add_argument("--mixtral-decode", action="store_true",
                        help="Mixtral-8x7B W8A16 against W4A16 g=128 decode, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_server_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.kernels_of:
        return kernels_ab(args.kernels_of, args.rounds, not args.kernels_only)
    if args.grouped_sweep:
        return grouped_sweep(args.rounds)
    if args.mixtral_decode:
        return mixtral_decode(args.rounds)
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
