#!/usr/bin/env python3
"""Comparisons in turns within one process, on one CUDA card (the PyTorch
port): three weight formats behind the server, two trees' kernels, the
grouped GEMM's two designs, or the two Mixtral models' decode.

Run from the repository root, on a machine with an H100:

    python3 scripts/torch_server_ab.py [--rounds N]
    python3 scripts/torch_server_ab.py --kernels-of DIR [--rounds N] [--kernels-only]
    python3 scripts/torch_server_ab.py --kernels-of DIR --decode-only [--families] [--rounds N]
    python3 scripts/torch_server_ab.py --grouped-sweep [--rounds N]
    python3 scripts/torch_server_ab.py --decode-sweep [--rounds N]
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
(`_build.SIGNATURES`; where this tree's entry point takes more arguments
before the stream, they are dropped for DIR: the count of real blocks, the
GEMV's K split, the attention kernels' ALiBi slopes and window, which must
then be unset). Timed in the order DIR, here, here, DIR per round (one event pair per
launch after an L2 flush, and many launches back to back:
`chip_smoke.time_ms` and `time_many_ms`): `eetq_flash_attention_fwd`; the
dense GEMMs at llama2-7b's four prefill shapes, summed over them
(`AB_DENSE`: `eetq_w8a16_gemm` per-channel at m=1024 and m=9 and g=128,
`eetq_w4a16_gemm` g=128, `eetq_w8a8_gemm` and `eetq_w4a8_gemm` per-channel
and g=128 at m=1024 and at a short admission's m=128); and the grouped GEMMs
(`eetq_w8a16_grouped_gemm` per-channel, `eetq_w4a16_grouped_gemm` g=128) on
Mixtral-8x7B's banks at bm=128 nb=24 (a 1024-token prompt) and bm=8 nb=10
(an 8-slot engine step), this tree also without the count of real blocks
(every padding block computed, as DIR does); and the decode GEMV's six entry
points (`AB_GEMV`: `eetq_w8a16_gemv` per-channel and `eetq_w4a16_gemv` g=128
and per-channel at m = 1, 2, 4, 8, each summed over llama2-7b's four layer
shapes with the RMSNorm prologue on qkv and gate/up, the int8 lm_head apart;
`AB_FUSED`: both fused MLPs at m = 1 and 8; `AB_GATHER`: both expert
gathers at Mixtral's b=1 step), each beside its byte bound, and this tree's
m=8 GEMV against the grouped GEMM's skinny `wgmma` tile called as a bank of
one expert (design (b)). Then, with this tree's Python
through either library: the b=1, 1024-token prefill of llama2-7b W8A16 and
W4A16 g=128 (`int4_generate`'s model) and of both Mixtral-8x7B models; one
admission of a 1024-token prompt through each llama2-7b model's default
`Engine` (W8A8, W4A8 g=128: an engine step that admits it and asks for one
token); the W4A16 g=128 Mixtral's paged int8 engine: ms per 8-slot
decode step and served tok/s (`chip_smoke.server_path`); and through the
GEMV of either tree, bench decode (llama2-7b W8A16, and W4A16 per-channel
under an int8 lm_head) in ms per step and one 8-slot step of the default
llama2-7b W8A16 engine (wall ms in turns; device busy from one profiled run
per tree). `--kernels-only` stops after the kernel cases; `--gemv-only`
runs the GEMV's cases and readings alone. DIR may be a copy of this tree
with one constant changed: the kernels of `csrc/gemv.cuh` have internal
linkage, so each library keeps its own state.

`--decode-only` (with `--kernels-of DIR`) times the attention kernels
alone: `eetq_flash_attention_fwd` at llama2-7b's and Mixtral's b=1
1024-token prefill and at D = 64 (`AB_ATTENTION`), then the flash-decode's four entry
points at the main paths' shapes (the two paged engines'
8-slot steps, then `DECODE_DENSE_CASES`: b=1 decode in bf16 and int8 and
Mixtral's, generate's b=4 request, the default engine's 8-slot step over a
2048-key int8 cache; with `--families` also `DECODE_GROUP_CASES`, the decode
steps of GQA groups 7 and 16, which DIR must take too), each beside its
byte bound, in the order DIR, here, here, DIR, where DIR's kernels take
this tree's ABI (a copy with one change), the ABI before the window and
ALiBi arguments, or the one-token ABI before the multi-query mode (the
launcher drops the count of query tokens); then (not with `--kernels-only`) one 8-slot
step of llama2-7b W8A16's paged and default engines and of the W4A16 g=128
Mixtral's paged int8 engine through either tree's flash-decode: wall ms in
turns, device busy and launches profiled once per tree.

`--decode-sweep` times the flash-decode at the same shapes with the plan's
chunk and with the chunk forced to each of SWEEP_CHUNKS, in turns (the
source of `DECODE_CHUNK`).

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
              "eetq_w4a16_grouped_gemm", "eetq_w8a16_gemv", "eetq_w4a16_gemv",
              "eetq_w8a16_expert_gemv", "eetq_w4a16_expert_gemv", "eetq_fused_mlp_gemv",
              "eetq_fused_mlp_gemv_i4")
# decode GEMV cases of the A/B: (kernel, bits, group, rows), each summed over
# llama2-7b's four layer shapes with the RMSNorm prologue where the path takes
# it (qkv, gate/up); the int8 lm_head is summed apart
AB_GEMV = ([("w8a16_gemv", 8, None, m) for m in (1, 2, 4, 8)]
           + [("w4a16_gemv", 4, group, m) for group in (cs.INT4_GROUP, None) for m in (1, 2, 4, 8)])
# the fused MLP of one llama2-7b layer (K 4096, I 11008, N 4096, + residual):
# (bits, rows)
AB_FUSED = [(8, 1), (8, 8), (4, 1), (4, 8)]
# the expert gather of a Mixtral-8x7B b=1 decode step (gate|up m=1 and down
# m=2, two selections): (bits, group)
AB_GATHER = [(8, None), (4, cs.INT4_GROUP)]
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
# The flash-decode's C entry points, and the chunks `--decode-sweep` forces
DECODE_ENTRIES = ("eetq_flash_decode", "eetq_flash_decode_int8", "eetq_paged_flash_decode",
                  "eetq_paged_flash_decode_int8")
SWEEP_CHUNKS = (64, 128, 192, 256, 384, 512)
# The dense flash-decode at the main paths' shapes, Hq = 32, D = 128: (int8,
# Hkv, L, lengths). b=1 decode after a 1024-token prompt (llama2-7b bf16 and
# int8, Mixtral GQA 32/8 bf16), generate's b=4 request (128-token prompts,
# 32 new tokens: llama2-7b and Mixtral) and the default engine's 8-slot step
# over its 2048-key int8 cache.
DECODE_DENSE_CASES = [
    (False, 32, 1152, [1074]), (True, 32, 1152, [1074]), (False, 8, 1152, [1074]),
    (False, 32, 160, [150] * 4), (False, 8, 160, [150] * 4),
    (True, 32, 2048, [1074, 1, 640, 2048, 17, 1500, 300, 1024]),
]
# The decode step of GQA groups 7 (qwen2-7b, Hq = 28) and 16 (chatglm3-6b):
# (int8, Hq, Hkv, L, lengths) at b=1 after a 1024-token prompt and at an
# 8-slot engine step (`--families`: the source of DECODE_STEP_GROUPS)
DECODE_GROUP_CASES = [
    (int8, hq, hkv, l, lens) for hq, hkv in ((28, 4), (32, 2)) for int8 in (False, True)
    for l, lens in ((1152, [1074]), (2048, [1074, 1, 640, 2048, 17, 1500, 300, 1024]))]
# Prefill attention, (batch, S, Hq, Hkv, D): llama2-7b's and Mixtral's, and
# D = 64 over 1000 tokens
AB_ATTENTION = [(1, 1024, 32, 32, 128), (1, 1024, 32, 8, 128), (1, 1000, 32, 8, 64)]
ATTENTION_ENTRIES = DECODE_ENTRIES + ("eetq_flash_attention_fwd",)


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
        if len(args) > arity[name]:  # this tree's arguments before the stream that DIR does
            # not take (the grouped GEMM's count of real blocks, the GEMV's K split, the
            # attention kernels' slopes and window: unset)
            if name in ATTENTION_ENTRIES and any(args[arity[name] - 1:-1]):
                raise ValueError(f"{what}'s {name} takes no window or ALiBi slopes")
            args = args[:arity[name] - 1] + args[-1:]
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
            bounds[case] = 1e3 * max(size / cs.hbm_bytes_per_s(),
                                     ops / cs.peak_ops_per_s("int8" if a8 else "bf16"))
    return cases, bounds


def _bytes_ms(size: float) -> float:
    return 1e3 * size / cs.hbm_bytes_per_s()


def _gemv_cases(gen, dev, specs, prenorm: bool = True, label: str = "") -> tuple[dict, dict]:
    """({case: make(tree) -> callable}, {case: byte bound ms}) of the decode
    GEMVs per spec (kernel, bits, group, rows) on llama2-7b's four layer
    shapes (the RMSNorm prologue on qkv and gate/up where `prenorm`) and, for
    int8, the lm_head."""
    import torch

    from eetq_tpu_torch.kernels import w8a16
    from eetq_tpu_torch.layout.tiling import pack_weights

    cases, bounds = {}, {}
    for name, bits, group, m in specs:
        gemv = getattr(w8a16, name)
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'} m={m}"
        for k, n in cs.LLAMA_SHAPES if bits == 8 else cs.W8A8_SHAPES:
            lo, hi = (-127, 128) if bits == 8 else (-8, 8)
            q = torch.randint(lo, hi, (k, n), generator=gen, device=dev, dtype=torch.int8)
            data = pack_weights(q, bits=bits).data
            shape = (n,) if group is None else (k // group, n)
            sc = torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            norm = prenorm and (k, n) in cs.PRENORM_SHAPES
            gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev) if norm else None
            head = " lm_head" if (k, n) not in cs.W8A8_SHAPES else ""
            case = f"{label}{name}{head} {tag} K={k} N={n}{' prenorm' if norm else ''}"
            cases[case] = (lambda tree, gemv=gemv, x=x, data=data, sc=sc, n=n, gamma=gamma:
                           lambda: gemv(x, data, sc, n, gamma=gamma, eps=1e-5))
            bounds[case] = _bytes_ms(cs.linear_cost(
                m, k, n, bits / 8, 1 if group is None else k // group,
                extra=4 * k if norm else 0)[0])
    return cases, bounds


def _skinny_cases(gen, dev) -> tuple[dict, dict]:
    """Design (b) of the m=8 GEMV: the grouped GEMM's skinny `wgmma` tile
    (`csrc/wgmma_grouped.cuh`, bm = 8) called as a bank of one expert with one
    row block, on llama2-7b's four layer shapes without the prologue, int8
    per-channel and int4 g=128."""
    import torch

    from eetq_tpu_torch.kernels.w8a16 import w4a16_grouped_gemm, w8a16_grouped_gemm
    from eetq_tpu_torch.layout.tiling import pack_weights

    cases, bounds = {}, {}
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    count = torch.ones(1, dtype=torch.int32, device=dev)
    for bits, group in ((8, None), (4, cs.INT4_GROUP)):
        gemm = w8a16_grouped_gemm if bits == 8 else w4a16_grouped_gemm
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'} m=8"
        for k, n in cs.W8A8_SHAPES:
            lo, hi = (-127, 128) if bits == 8 else (-8, 8)
            q = torch.randint(lo, hi, (1, k, n), generator=gen, device=dev, dtype=torch.int8)
            data = pack_weights(q, bits=bits).data
            shape = (1, n) if group is None else (1, k // group, n)
            sc = torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4
            x = torch.randn(8, k, generator=gen, device=dev).to(torch.bfloat16)
            case = f"design (b) skinny wgmma tile {tag} K={k} N={n}"
            cases[case] = (lambda tree, gemm=gemm, x=x, data=data, sc=sc, n=n:
                           lambda: gemm(x, data, sc, one, n, count))
            bounds[case] = _bytes_ms(cs.linear_cost(
                8, k, n, bits / 8, 1 if group is None else k // group)[0])
    return cases, bounds


def _fused_cases(gen, dev, specs) -> tuple[dict, dict]:
    """The fused MLP of one llama2-7b layer per spec (bits, rows)."""
    import torch

    from eetq_tpu_torch.kernels.mlp_fused import fused_mlp_gemv, fused_mlp_gemv_i4
    from eetq_tpu_torch.layout.tiling import pack_weights

    cases, bounds = {}, {}
    k, i, n = 4096, 11008, 4096
    for bits, m in specs:
        kernel = fused_mlp_gemv if bits == 8 else fused_mlp_gemv_i4
        lo, hi = (-127, 128) if bits == 8 else (-8, 8)
        gu = pack_weights(torch.randint(lo, hi, (k, 2 * i), generator=gen, device=dev,
                                        dtype=torch.int8), bits=bits).data
        dn = pack_weights(torch.randint(lo, hi, (i, n), generator=gen, device=dev,
                                        dtype=torch.int8), bits=bits).data
        gu_s = torch.rand(2 * i, generator=gen, device=dev) * 2e-3 + 1e-4
        dn_s = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        res = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        case = f"{kernel.__name__} int{bits} m={m} K={k} I={i} N={n} +residual"
        cases[case] = (lambda tree, kernel=kernel, x=x, gamma=gamma, gu=gu, gu_s=gu_s, dn=dn,
                       dn_s=dn_s, res=res: lambda: kernel(x, gamma, 1e-5, gu, gu_s, dn, dn_s, n,
                                                          res))
        bounds[case] = _bytes_ms(bits / 8 * (k * 2 * i + i * n) + 4 * (2 * i + n + k)
                                 + 2 * m * (k + 2 * n))
    return cases, bounds


def _gather_cases(gen, dev, specs) -> tuple[dict, dict]:
    """The expert gather of a Mixtral-8x7B b=1 decode step per spec (bits,
    group): gate|up (m=1) and down (m=2) of two selections."""
    import torch

    from eetq_tpu_torch.kernels.w8a16 import w4a16_expert_gemv, w8a16_expert_gemv

    cases, bounds = {}, {}
    (m_gu, m_dn, ids), _ = cs.GATHER_CASES
    eids = torch.tensor(ids, dtype=torch.int32, device=dev)
    for bits, group in specs:
        gemv = w8a16_expert_gemv if bits == 8 else w4a16_expert_gemv
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'} n_sel={len(ids)}"
        for (k, n), m in zip(cs.MIXTRAL_BANKS, (m_gu, m_dn)):
            data, sc = _bank(gen, dev, bits, group, k, n)
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            case = f"{gemv.__name__} {tag} K={k} N={n} m={m}"
            cases[case] = (lambda tree, gemv=gemv, x=x, data=data, sc=sc, n=n:
                           lambda: gemv(x, data, sc, eids, n))
            srows = 1 if group is None else k // group
            bounds[case] = _bytes_ms(len(set(ids)) * (k * n * bits / 8 + 4 * srows * n)
                                     + m * k * 2 + len(ids) * (m * n * 2 + 4))
    return cases, bounds


def _sum_pairs(res: dict, what: str = "gate|up + down", bounds: dict | None = None) -> None:
    """Print the sum over shapes ("K=..." in the case name) per kernel and
    mode: gate|up + down of grouped results, the four layer shapes of dense
    ones (with the sum of their bounds and the back-to-back share of it,
    where given)."""
    sums = {}
    for case, per in res.items():
        key = case.split(" K=")[0]
        for t, (ms, b2b) in per.items():
            a = sums.setdefault(key, {}).setdefault(t, [0.0, 0.0])
            a[0] += ms
            a[1] += b2b
    for key, per in sums.items():
        bound = None if bounds is None else sum(
            b for case, b in bounds.items() if case.split(" K=")[0] == key)
        print(f"{key}, {what}: " + "; ".join(
            f"{t} {ms:.4f} ms (back to back {b2b:.4f}"
            + ("" if bound is None else f", {100 * bound / b2b:.0f}% of the bound") + ")"
            for t, (ms, b2b) in per.items())
            + ("" if bound is None else f"; bound {bound:.4f} ms (bytes)"), flush=True)


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

    # window 1: one lock-step decode step a scheduler step, the unit timed here
    eng = Engine(params, cfg, max_batch=8, max_len=2048, decode_window=1, **engine_kw)
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
    busy, launches, _, _ = cs._device_events(prof)
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


def _gemv_kernel_ab(gen, dev, trees, rounds: int, flush) -> None:
    """The decode GEMV's entry points in turns, each case summed over its
    shapes beside its byte bound; then this tree's m=8 GEMV without the
    prologue against design (b), the skinny `wgmma` tile, in turns."""
    from eetq_tpu_torch.kernels import _build

    for spec in AB_GEMV:
        cases, bounds = _gemv_cases(gen, dev, [spec])
        _sum_pairs(_time_cases(cases, trees, ORDER, rounds, flush), "four shapes", bounds)
    for make, specs in ((_fused_cases, AB_FUSED), (_gather_cases, AB_GATHER)):
        for spec in specs:
            cases, bounds = make(gen, dev, [spec])
            _sum_pairs(_time_cases(cases, trees, ORDER, rounds, flush), "one call", bounds)
    a, a_bounds = _gemv_cases(gen, dev, [("w8a16_gemv", 8, None, 8),
                                         ("w4a16_gemv", 4, cs.INT4_GROUP, 8)],
                              prenorm=False, label="design (a) mma.sync GEMV ")
    a = {case: make for case, make in a.items() if " lm_head" not in case}
    b, b_bounds = _skinny_cases(gen, dev)
    cases = {}
    for (ca, ma), (cb, mb) in zip(a.items(), b.items()):  # the same shapes in turns
        cases[ca], cases[cb] = ma, mb
    here = {"here": _build.launch}
    _sum_pairs(_time_cases(cases, here, ("here", "here"), rounds, flush), "four shapes",
               {**a_bounds, **b_bounds})


def _s_less_launcher(lib, what: str):
    """A stand-in for `_build.launch` that sends the flash-decode entry
    points to `lib`, a library whose flash-decode takes no count of query
    tokens (the one-token ABI before the multi-query mode: S = 1 calls
    only), and everything else to this tree's library."""
    from eetq_tpu_torch.kernels import _build

    launch_here = _build.launch

    def launch(name, *args):
        if name not in DECODE_ENTRIES:
            return launch_here(name, *args)
        at, ints = _decode_ints(name, args)
        if ints[1] != 1 or any(args[-3:-1]):
            raise ValueError(f"{what}'s flash-decode takes one query token a row, no window "
                             "and no ALiBi slopes")
        # without S (after b), the slopes and the window (before the stream)
        rc = getattr(lib, name)(*args[:at + 3], *args[at + 4:-3], args[-1])
        if rc != 0:
            raise RuntimeError(f"{name} of {what} failed: CUDA error {rc}")

    return launch


def _decode_ints(name: str, args) -> tuple[int, tuple]:
    """(index of the partials pointer, the int arguments b, s, hq, hkv, l
    (or max_blocks, bs), d, chunk) of a flash-decode C call (after them:
    scale, slopes, window, stream)."""
    at = 5 + 2 * ("int8" in name) + ("paged" in name)
    return at, args[at + 2:-4]


def _chunk_launcher(chunk: int):
    """A stand-in for `_build.launch` that runs this tree's flash-decode with
    `chunk` keys a chunk (and scratch for it) in place of the plan's."""
    import torch

    from eetq_tpu_torch.kernels import _build

    launch_here = _build.launch

    def launch(name, *args):
        if name not in DECODE_ENTRIES:
            return launch_here(name, *args)
        at, ints = _decode_ints(name, args)
        b, s, hq, hkv, d = ints[0], ints[1], ints[2], ints[3], ints[-2]
        cap = ints[4] * ints[5] if "paged" in name else ints[4]
        chunks = -(-cap // chunk)
        floats = b * hkv * chunks * (hq // hkv) * s * (d + 2) if chunks > 1 else 0
        part, ctr = _build.scratch("decode", torch.device("cuda", torch.cuda.current_device()),
                                   floats, b * hkv)
        return launch_here(name, *args[:at], part, ctr, *ints[:-1], chunk, *args[-4:])

    return launch


def _attention_cases(gen, dev) -> tuple[dict, dict]:
    """({case: make(tree) -> callable}, {case: operation bound ms}) of the
    prefill flash-attention at AB_ATTENTION's shapes (q, k, v strided views
    of one tensor, as the model passes them)."""
    import torch

    from eetq_tpu_torch.kernels.flash_attention import flash_attention

    cases, bounds = {}, {}
    for b, sq, hq, hkv, d in AB_ATTENTION:
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(b, sq, 2 * hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        case = f"flash_attention_fwd B={b} S={sq} Hq={hq} Hkv={hkv} D={d}"
        cases[case] = (lambda tree, q=q, kv=kv, hkv=hkv:
                       lambda: flash_attention(q, kv[:, :, :hkv], kv[:, :, hkv:]))
        ops = 4.0 * b * hq * d * sq * (sq + 1) / 2
        bounds[case] = 1e3 * ops / cs.peak_ops_per_s("bf16")
    return cases, bounds


def _decode_cases(gen, dev, families: bool = False) -> tuple[dict, dict]:
    """({case: make(tree) -> callable}, {case: byte bound ms}) of the
    flash-decode at the main paths' shapes: the two paged engines' 8-slot
    steps (`chip_smoke.py`'s rows of lengths 1..1088 over 256-key blocks
    behind a permuted table: bf16 MHA, int8 GQA 32/8), then
    DECODE_DENSE_CASES (and with `families` DECODE_GROUP_CASES)."""
    import torch

    from eetq_tpu_torch.kernels.flash_decode import (
        flash_decode,
        flash_decode_int8,
        paged_flash_decode,
        paged_flash_decode_int8,
    )
    from eetq_tpu_torch.kernels.w8a8 import quantize_activations

    cases, bounds = {}, {}

    def caches(shape, int8):
        pair = [torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
        if int8:
            (k, ks), (v, vs) = (quantize_activations(t) for t in pair)
            return k, v, ks, vs
        return tuple(t.to(torch.bfloat16) for t in pair)

    lens = list(cs.PAGED_LENGTHS)
    b, bs, nblocks = len(lens), cs.PAGED_BLOCK_SIZE, cs.PAGED_POOL_BLOCKS
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    table = torch.randperm(nblocks, generator=gen, device=dev)[:b * 2048 // bs].reshape(
        b, 2048 // bs).to(torch.int32).contiguous()
    for int8, hkv in ((False, 32), (True, 8)):
        q = torch.randn(b, 1, 32, 128, generator=gen, device=dev).to(torch.bfloat16)
        pools = caches((nblocks, hkv, bs, 128), int8)
        kernel = paged_flash_decode_int8 if int8 else paged_flash_decode
        case = f"{kernel.__name__} B={b} BS={bs} Hq=32 Hkv={hkv}"
        cases[case] = (lambda tree, kernel=kernel, q=q, pools=pools:
                       lambda: kernel(q, *pools, table, lengths))
        bounds[case] = _bytes_ms(cs.decode_cost(lens, 32, hkv, 2 - int8, 4 * int8)[0])
    dense = [(int8, 32, hkv, l, lens) for int8, hkv, l, lens in DECODE_DENSE_CASES]
    for int8, hq, hkv, l, lens in dense + (DECODE_GROUP_CASES if families else []):
        b = len(lens)
        lengths_d = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
        cache = caches((b, hkv, l, 128), int8)
        kernel = flash_decode_int8 if int8 else flash_decode
        case = f"{kernel.__name__} B={b} L={l} Hq={hq} Hkv={hkv}"
        cases[case] = (lambda tree, kernel=kernel, q=q, cache=cache, lengths=lengths_d:
                       lambda: kernel(q, *cache, lengths))
        bounds[case] = _bytes_ms(cs.decode_cost(lens, hq, hkv, 2 - int8, 4 * int8)[0])
    return cases, bounds


def _plan_chunk(case: str) -> int:
    """The plan's chunk for a case of `_decode_cases` on this card."""
    from eetq_tpu_torch.kernels.autotune import decode_plan

    f = {k: int(v) for k, v in (field.split("=") for field in case.split()[1:])}
    cap = 2048 if "BS" in f else f["L"]
    return decode_plan(f["B"], f["Hkv"], f["Hq"] // f["Hkv"], cap, 128).chunk


def _decode_report(res: dict, bounds: dict, by: str = "bytes") -> None:
    for case, per in res.items():
        print(f"{case}: " + "; ".join(
            f"{t} {ms:.4f} ms (back to back {b2b:.4f}, {100 * bounds[case] / b2b:.0f}% of the "
            f"bound)" for t, (ms, b2b) in per.items()) + f"; bound {bounds[case]:.4f} ms ({by})",
            flush=True)


def decode_ab(other_dir: str, rounds: int, models: bool = True, families: bool = False) -> int:
    """`--kernels-of DIR --decode-only`: the attention kernels of this tree
    against those of the checkout in DIR (this tree's ABI, or an older one)
    in turns: the prefill flash-attention, then the flash-decode at the main
    paths' shapes (with `families` also the decode steps of groups 7 and
    16); then (unless models=False), through
    either tree's flash-decode, one 8-slot step of llama2-7b W8A16's paged
    (bf16 pool) and default (dense int8 cache) engines and of Mixtral-8x7B
    W4A16 g=128's paged int8 engine: wall ms in turns, and device busy and
    launches from one profiled run per tree."""
    import torch

    from eetq_tpu_torch.kernels import _build
    from eetq_tpu_torch.models.config import PRESETS
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
    # the ABI from the multi-query mode on takes S: 16 arguments at least
    multi_query = arity["eetq_flash_decode"] >= 16
    launcher = _launcher(other, arity, ATTENTION_ENTRIES, other_dir)
    trees = {"other": (launcher if multi_query else _s_less_launcher(other, other_dir)),
             "here": _build.launch}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        cases, bounds = _attention_cases(gen, dev)
        attn_trees = dict(trees, other=launcher)
        _decode_report(_time_cases(cases, attn_trees, ORDER, rounds, flush), bounds,
                       "operations")
        cases, bounds = _decode_cases(gen, dev, families)
        _decode_report(_time_cases(cases, trees, ORDER, rounds, flush), bounds)
    del cases, flush
    gc.collect()
    torch.cuda.empty_cache()
    if not models:
        return 0
    paged = dict(paged_blocks=cs.PAGED_BLOCKS, paged_block_size=cs.PAGED_BLOCK_SIZE)
    for name, make, engines in (
            (f"{cs.MODEL} W8A16", lambda g: quantize_params(
                random_dense_params(PRESETS[cs.MODEL], g), quantize_lm_head=True),
             {"paged (bf16 pool)": paged, "default (dense int8 cache)": {}}),
            (f"{cs.MIXTRAL} W4A16 g={cs.INT4_GROUP}", lambda g: random_quantized_params(
                PRESETS[cs.MIXTRAL], g, quantize_lm_head=True, bits=4, group_size=cs.INT4_GROUP),
             {"paged (int8 pool)": dict(paged, kv_dtype=torch.int8)})):
        cfg = PRESETS[cs.MODEL if name.startswith(cs.MODEL) else cs.MIXTRAL]
        t0 = time.perf_counter()
        params = make(torch.Generator(device=dev).manual_seed(cs.SEED))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{name} built in {time.perf_counter() - t0:.1f} s", flush=True)
        for engine, kw in engines.items():
            _engine_step_ms(params, cfg, dev, gen, kw)  # warm
            _report(f"{name} {engine} engine, ms per 8-slot decode step", _in_turns(
                trees, ORDER, rounds, lambda t: _engine_step_ms(params, cfg, dev, gen, kw)))
            _in_turns(trees, ("other", "here"), 1,
                      lambda t: _profile_engine_step(params, cfg, dev, gen, t, engine_kw=kw))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def decode_sweep(rounds: int) -> int:
    """`--decode-sweep`: the flash-decode with the plan's chunk and with the
    chunk forced to each of SWEEP_CHUNKS, in turns, at the main paths' shapes
    (the source of `DECODE_CHUNK`)."""
    import torch

    from eetq_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    print(cs.card_line())
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        cases, bounds = _decode_cases(gen, dev)
        for case in cases:
            print(f"{case}: the plan's chunk {_plan_chunk(case)}")
        chunks = {"plan": _build.launch, **{f"chunk {c}": _chunk_launcher(c) for c in SWEEP_CHUNKS}}
        order = tuple(chunks) + tuple(reversed(tuple(chunks)))
        _decode_report(_time_cases(cases, chunks, order, rounds, flush), bounds)
    return 0


def _decode_ms(params, cfg, dev, prompt, n_new: int, kv, fused: bool) -> float:
    """ms per b=1 decode step after a prefill of `prompt` (`decode_loop`)."""
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    p = prompt.shape[1]
    caches = init_caches(cfg, 1, p + n_new, device=dev, dtype=kv)
    lp, caches = prefill(params, cfg, prompt, caches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_loop(params, cfg, torch.argmax(lp, -1), p, caches, n_new, fused_mlp=fused)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / (n_new - 1)


def _profile_engine_step(params, cfg, dev, gen, tree: str, steps: int = 10,
                         engine_kw: dict | None = None) -> None:
    """Ten decode steps of an engine (the default one, or with `engine_kw`)
    with its 8 slots busy, under torch.profiler: wall and device-busy ms a
    step, launches (and the flash-decode's), idle share."""
    import torch

    from eetq_tpu_torch.serve.engine import Engine

    eng = Engine(params, cfg, max_batch=8, max_len=2048, decode_window=1, **(engine_kw or {}))
    for _ in range(8):
        ids = torch.randint(0, cfg.vocab_size, (100,), generator=gen, device=dev).tolist()
        eng.add_request(ids, max_new_tokens=steps + 16)
    while eng.queue:
        eng.step()
    eng.step()

    def run():
        for _ in range(steps):
            eng.step()

    r = cs._profiled(run, steps)
    eng.run()
    print(f"    {tree}, profiled engine step: wall {r['wall_ms_per_step']:.2f} ms, device busy "
          f"{r['busy_ms_per_step']:.3f} ms, {r['launches_per_step']:.0f} launches "
          f"({r['decode_launches_per_step']:.0f} of the flash-decode), idle share "
          f"{r['idle_share']:.3f}", flush=True)


def _gemv_models_ab(dev, gen, trees, rounds: int) -> None:
    """End to end through either tree's GEMV: bench.py's decode (llama2-7b
    W8A16, int8 KV, fused MLP, b=1 after a 1024-token prompt), the same at
    W4A16 per-channel under an int8 lm_head (EETQ_BENCH_BITS=4), and one
    8-slot step of the default engine (llama2-7b W8A16), wall ms in turns and
    device busy from one profiled run per tree."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import (
        quantize_params,
        random_dense_params,
        random_quantized_params,
    )
    from eetq_tpu_torch.modules.linear import quantize_linear

    cfg = PRESETS[cs.MODEL]
    _, p1, n1 = cs.REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p1), generator=gen, device=dev)

    def int4_bench(g):
        params = random_quantized_params(cfg, g, bits=4)
        params.lm_head = quantize_linear(params.lm_head.weight)
        return params

    for name, make in (
            (f"{cs.MODEL} W8A16", lambda g: quantize_params(random_dense_params(cfg, g),
                                                             quantize_lm_head=True)),
            (f"{cs.MODEL} W4A16 per-channel, int8 lm_head", int4_bench)):
        params = make(torch.Generator(device=dev).manual_seed(cs.SEED))
        gc.collect()
        torch.cuda.empty_cache()
        _decode_ms(params, cfg, dev, prompt, n1, torch.int8, True)  # warm
        _report(f"{name} bench decode b=1 p={p1} (int8 KV, fused MLP), ms per step", _in_turns(
            trees, ORDER, rounds,
            lambda t: _decode_ms(params, cfg, dev, prompt, n1, torch.int8, True)))
        if "W8A16" in name:
            _report(f"{name} default engine, ms per 8-slot decode step", _in_turns(
                trees, ORDER, rounds, lambda t: _engine_step_ms(params, cfg, dev, gen, {})))
            _in_turns(trees, ("other", "here"), 1,
                      lambda t: _profile_engine_step(params, cfg, dev, gen, t))
        del params
        gc.collect()
        torch.cuda.empty_cache()


def kernels_ab(other_dir: str, rounds: int, models: bool = True, gemv_only: bool = False) -> int:
    """This tree's kernels and prefill against those of the checkout in
    `other_dir`, in turns; models=False times the kernel cases only;
    gemv_only: the decode GEMV's cases and end-to-end readings alone."""
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
        if not gemv_only:
            _time_cases(cases, trees, ORDER, rounds, flush)
            cases.clear()
            for spec in AB_DENSE:  # one spec's weights on the card at a time
                dense, bounds = _dense_cases(gen, dev, [spec])
                _sum_pairs(_time_cases(dense, trees, ORDER, rounds, flush), "four shapes",
                           bounds)
                del dense
            # the grouped GEMMs, this tree also without the count of real blocks
            trees3 = dict(trees, here_all_blocks=_build.launch)
            res = _time_cases(_grouped_cases(gen, dev, AB_GROUPED, lambda t: t == "here"),
                              trees3, ORDER + ("here_all_blocks", "here_all_blocks"), rounds,
                              flush)
            _sum_pairs(res)
        _gemv_kernel_ab(gen, dev, trees, rounds, flush)
    del cases, flush, q, kv
    gc.collect()
    torch.cuda.empty_cache()
    if not models:
        return 0
    _gemv_models_ab(dev, gen, trees, rounds)
    if gemv_only:
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
            # window 1: the admission's step decodes one token, not a window
            eng = Engine(params, cfg, max_batch=8, max_len=2048, decode_window=1)
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
    parser.add_argument("--gemv-only", action="store_true",
                        help="with --kernels-of: the decode GEMV's cases and decode and engine "
                             "step readings only")
    parser.add_argument("--decode-only", action="store_true",
                        help="with --kernels-of: the attention kernels' cases and engine steps "
                             "only")
    parser.add_argument("--families", action="store_true",
                        help="with --decode-only: also the decode steps of GQA groups 7 and 16")
    parser.add_argument("--decode-sweep", action="store_true",
                        help="time the flash-decode over its chunk length, in turns")
    parser.add_argument("--grouped-sweep", action="store_true",
                        help="time the grouped GEMM's skinny tile against its wide one over bm")
    parser.add_argument("--mixtral-decode", action="store_true",
                        help="Mixtral-8x7B W8A16 against W4A16 g=128 decode, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_server_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.kernels_of and args.decode_only:
        return decode_ab(args.kernels_of, args.rounds, not args.kernels_only, args.families)
    if args.kernels_of:
        return kernels_ab(args.kernels_of, args.rounds, not args.kernels_only, args.gemv_only)
    if args.grouped_sweep:
        return grouped_sweep(args.rounds)
    if args.decode_sweep:
        return decode_sweep(args.rounds)
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
