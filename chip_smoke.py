#!/usr/bin/env python3
"""Drive the PyTorch port's three paths once on an NVIDIA GPU and check them.

Run from the repository root, on a machine with one CUDA card (an H100):

    python3 chip_smoke.py [--out DIR]

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit;
   builds the kernels of `eetq_tpu_torch/csrc/` with nvcc (one process per
   source, all at once).
2. Kernels: each of the seven kernel entry points against its plain
   PyTorch version on the card at llama2-7b shapes, with its error and its
   time beside the plain time.
3. Model: llama2-7b at full width and depth (32 layers), random weights
   from a seeded `torch.Generator` on the card, W8A16 per-channel with an
   int8 lm_head, built once and driven three ways. Each path runs with the
   launch counters set to 0 just before it and read just after, and every
   kernel it runs must have launched.
   - generate: bf16 KV, unfused MLP, W8A16 prefill; prefill and one decode
     step against the plain path, then batch 1 x 1024-token prompt x 50
     greedy tokens and batch 4 x 128 x 32.
   - bench decode (`bench.py`'s configuration): prefill into an int8 KV
     cache, then `decode_loop(fused_mlp=True)`; the same checks and
     requests, and prefill/decode times beside the generate path's.
   - server: `Engine(params, cfg, max_batch=8, max_len=2048)` with its
     defaults (which must resolve to W8A8 prefill and int8 KV) behind
     `EngineServer` on 127.0.0.1; about 12 HTTP requests of mixed prompt
     lengths and budgets from several threads; one admission's logits
     against the plain path; `w8a16_gemm` must not launch.

Prints one JSON line of per-kernel results, then as its last line
`{"ok": true, "device": {...}}`. Any failed check, build or launch ends the
run with a non-zero exit code and no result line; so does a machine without
a CUDA device. With `--out DIR` the details (every kernel case, the model
timings, nvcc's register report) also go to `DIR/chip_smoke.json`.
"""

from __future__ import annotations

import http.client
import json
import os
import statistics
import subprocess
import sys
import threading
import time

SEED = 0
MODEL = "llama2-7b"
REQUESTS = ((1, 1024, 50), (4, 128, 32))  # (batch, prompt tokens, new tokens)
LLAMA_SHAPES = [  # (K, N) of qkv, o_proj, gate/up, down, lm_head
    (4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
]
PRENORM_SHAPES = {(4096, 12288), (4096, 22016)}  # qkv and gate/up take the fused norm
W8A8_SHAPES = LLAMA_SHAPES[:4]  # the prefill projections (the lm_head stays W8A16)
W8A8_ROWS = (32, 1024)  # the engine's smallest prompt bucket, and a full one
# The server phase: prompt lengths and budgets drawn from a seeded generator
SERVE_REQUESTS = 12
SERVE_LENGTHS = (17, 100, 300, 700, 1024)
SERVE_BUDGETS = (16, 32, 64)
SERVE_THREADS = 4
SERVE_TIMEOUT_S = 600
ADMISSION_PROMPT = 700  # the admission whose logits are checked: 700 tokens in the 1024 bucket
# max |kernel - plain| <= TOL * max |plain|: four bf16 ulps of the largest
# output. Sums run in another order and attention rounds p to bf16 before
# p.v (as the TPU kernel does), both far inside this bound; a wrong tile,
# column or mask is off by the size of the output itself.
TOL = 2.0 ** -6
# Model logits after 32 layers: the two paths round differently at every
# bf16 boundary, so the bound is on the error relative to the largest logit.
MODEL_TOL = 5e-2
# Under W8A8 each projection requantizes its input per token: one int8
# step (absmax/127) is two bf16 ulps (absmax/256), so an ulp-level
# difference from attention can come out of the next projection as a whole
# step. The kernel and plain W8A8 products themselves are bit-identical.
A8_MODEL_TOL = 2 * MODEL_TOL
REPLACES = {
    "w8a16_gemv": ("cuda", "eetq_tpu_torch/csrc/w8a16_gemv.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "w8a16_gemm": ("cuda", "eetq_tpu_torch/csrc/w8a16_gemm.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "flash_attention_fwd": ("cuda", "eetq_tpu_torch/csrc/flash_attention.cu",
                            "eetq_tpu/kernels/flash_attention.py:179"),
    "flash_decode": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                     "eetq_tpu/kernels/flash_decode.py:362"),
    "w8a8_gemm": ("cuda", "eetq_tpu_torch/csrc/w8a8_gemm.cu", "eetq_tpu/kernels/w8a8.py:90"),
    "fused_mlp_gemv": ("cuda", "eetq_tpu_torch/csrc/fused_mlp.cu",
                       "eetq_tpu/kernels/mlp_fused.py:96"),
    "flash_decode_int8": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                          "eetq_tpu/kernels/flash_decode.py:362"),
}
# The kernels each path must launch (and, for the server, must not).
PATH_KERNELS = {
    "generate": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode"),
    "bench_decode": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "fused_mlp_gemv",
                     "flash_decode_int8"),
    "server": ("w8a16_gemv", "flash_attention_fwd", "w8a8_gemm", "flash_decode_int8"),
}
SERVER_IDLE = ("w8a16_gemm",)  # under a8 every prefill projection is W8A8


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, flush=None) -> float:
    """Median device time of fn() over reps launches (CUDA events), each
    after reading `flush` (larger than the 50 MB L2) when it is given: the
    weights of a decode step are never in L2. Reading leaves clean lines, so
    the timed call pays no write-back of the flush."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(out, ref) -> tuple[float, float]:
    import torch

    check(bool(torch.isfinite(out.float()).all()), "kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version at llama2-7b shapes."""
    import torch
    import torch.nn.functional as F

    from eetq_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from eetq_tpu_torch.kernels.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_int8_ref,
        flash_decode_ref,
    )
    from eetq_tpu_torch.kernels.mlp_fused import fused_mlp_gemv, fused_mlp_ref
    from eetq_tpu_torch.kernels.w8a8 import quantize_activations, w8a8_gemm, w8a8_gemm_ref
    from eetq_tpu_torch.kernels.w8a16 import w8a16_gemm, w8a16_gemv, w8a16_matmul_ref
    from eetq_tpu_torch.ops.rmsnorm import rmsnorm

    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB
    rows, summary = [], {}

    def record(name, case, out, ref, fn, plain, path_shape):
        err, ref_max = compare(out, ref)
        n_diff = int((out.float() != ref.float()).sum().item())
        ms, plain_ms = time_ms(fn, flush=flush), time_ms(plain, flush=flush)
        ok = err <= TOL * ref_max
        rows.append(dict(kernel=name, case=case, max_abs_err=err, ref_absmax=ref_max,
                         tol=TOL * ref_max, n_diff=n_diff, numel=out.numel(), ok=ok, ms=ms,
                         plain_ms=plain_ms))
        print(f"  {name:20s} {case:40s} err {err:.3e} (tol {TOL * ref_max:.3e}, "
              f"{n_diff}/{out.numel()} differ) {ms:8.4f} ms, plain {plain_ms:8.4f} ms "
              f"{'ok' if ok else 'FAIL'}")
        s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if path_shape:  # the main path's own shapes make the reported time
            s["ms"] += ms
            s["plain_ms"] += plain_ms

    for k, n in LLAMA_SHAPES:
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        scales = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        for m in (1, 4, 8):
            for norm in ((False, True) if (k, n) in PRENORM_SHAPES else (False,)):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                g = gamma if norm else None
                y = rmsnorm(x, gamma, 1e-5) if norm else x
                record("w8a16_gemv", f"m={m} K={k} N={n}{' prenorm' if norm else ''}",
                       w8a16_gemv(x, qw, scales, n, gamma=g, eps=1e-5),
                       w8a16_matmul_ref(y, qw, scales),
                       lambda: w8a16_gemv(x, qw, scales, n, gamma=g, eps=1e-5),
                       lambda: w8a16_matmul_ref(rmsnorm(x, gamma, 1e-5) if norm else x, qw, scales),
                       m == 1 and norm == ((k, n) in PRENORM_SHAPES))
        x = torch.randn(1024, k, generator=gen, device=dev).to(torch.bfloat16)
        record("w8a16_gemm", f"m=1024 K={k} N={n}", w8a16_gemm(x, qw, scales, n),
               w8a16_matmul_ref(x, qw, scales),
               lambda: w8a16_gemm(x, qw, scales, n), lambda: w8a16_matmul_ref(x, qw, scales), True)
        if (k, n) in W8A8_SHAPES:
            for m in W8A8_ROWS:
                xq, sx = quantize_activations(
                    torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
                xq = xq.contiguous()
                record("w8a8_gemm", f"m={m} K={k} N={n}", w8a8_gemm(xq, sx, qw, scales, n),
                       w8a8_gemm_ref(xq, sx, qw, scales, n),
                       lambda: w8a8_gemm(xq, sx, qw, scales, n),
                       lambda: w8a8_gemm_ref(xq, sx, qw, scales, n), m == 1024)
        del qw

    # the MLP of one llama2-7b layer: gate|up [4096, 22016], down [11008, 4096]
    kh, inter = 4096, 11008
    gu = torch.randint(-127, 128, (kh, 2 * inter), generator=gen, device=dev, dtype=torch.int8)
    dn = torch.randint(-127, 128, (inter, kh), generator=gen, device=dev, dtype=torch.int8)
    gu_s = torch.rand(2 * inter, generator=gen, device=dev) * 2e-3 + 1e-4
    dn_s = torch.rand(kh, generator=gen, device=dev) * 2e-3 + 1e-4
    gamma = 1.0 + 0.1 * torch.randn(kh, generator=gen, device=dev)
    for m in (1, 4, 8):
        x = torch.randn(m, kh, generator=gen, device=dev).to(torch.bfloat16)
        res = torch.randn(m, kh, generator=gen, device=dev).to(torch.bfloat16)
        record("fused_mlp_gemv", f"m={m} K={kh} I={inter} N={kh} +residual",
               fused_mlp_gemv(x, gamma, 1e-5, gu, gu_s, dn, dn_s, kh, res),
               fused_mlp_ref(x, gamma, gu, gu_s, dn, dn_s, 1e-5, residual=res),
               lambda: fused_mlp_gemv(x, gamma, 1e-5, gu, gu_s, dn, dn_s, kh, res),
               lambda: fused_mlp_ref(x, gamma, gu, gu_s, dn, dn_s, 1e-5, residual=res), m == 1)
    del gu, dn

    for hq, hkv in ((32, 32), (32, 8)):
        q = torch.randn(1, 1024, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(1, 1024, 2 * hkv, 128, generator=gen, device=dev).to(torch.bfloat16)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]  # strided views, as the model passes them
        record("flash_attention_fwd", f"B=1 S=1024 Hq={hq} Hkv={hkv} D=128",
               flash_attention(q, k, v), flash_attention_ref(q, k, v),
               lambda: flash_attention(q, k, v), lambda: flash_attention_ref(q, k, v), hq == hkv)

    for b in (1, 4):
        for hq, hkv in ((32, 32), (32, 8)):
            q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
            kc = torch.randn(b, hkv, 1152, 128, generator=gen, device=dev).to(torch.bfloat16)
            vc = torch.randn(b, hkv, 1152, 128, generator=gen, device=dev).to(torch.bfloat16)
            lengths = torch.tensor([1074, 1, 640, 1152][:b], dtype=torch.int32, device=dev)
            record("flash_decode", f"B={b} L=1152 Hq={hq} Hkv={hkv} D=128",
                   flash_decode(q, kc, vc, lengths), flash_decode_ref(q, kc, vc, lengths),
                   lambda: flash_decode(q, kc, vc, lengths),
                   lambda: flash_decode_ref(q, kc, vc, lengths), b == 1 and hq == hkv)

    for b in (1, 8):
        for l in (1152, 2048):
            for hq, hkv in ((32, 32), (32, 8)):
                q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
                kc, ks = quantize_activations(
                    torch.randn(b, hkv, l, 128, generator=gen, device=dev))
                vc, vs = quantize_activations(
                    torch.randn(b, hkv, l, 128, generator=gen, device=dev))
                lens = [1074, 1, 640, l, 17, 1500 % l, 300, 1024][:b]
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                record("flash_decode_int8", f"B={b} L={l} Hq={hq} Hkv={hkv} D=128",
                       flash_decode_int8(q, kc, vc, ks, vs, lengths),
                       flash_decode_int8_ref(q, kc, vc, ks, vs, lengths),
                       lambda: flash_decode_int8(q, kc, vc, ks, vs, lengths),
                       lambda: flash_decode_int8_ref(q, kc, vc, ks, vs, lengths),
                       b == 1 and l == 1152 and hq == hkv)
    del flush
    torch.cuda.synchronize()
    bad = [f"{r['kernel']} {r['case']}" for r in rows if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    return dict(rows=rows, summary=summary)


def counted(path: str, fn):
    """Run fn() with every launch counter at 0; return (its result, the
    counts). Fails if a kernel of the path did not launch."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  launches on the {path} path: {counts}")
    idle = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    check(not idle, f"kernels not launched on the {path} path: {idle}")
    return out, counts


def check_logits(name: str, got, ref, tol: float = MODEL_TOL) -> dict:
    import torch

    check(bool(torch.isfinite(got).all()), f"{name} logits are not finite")
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    print(f"  {name} logits vs plain path: max abs err {err:.4e}, "
          f"relative {rel:.4e} (tol {tol}), argmax equal {same}")
    check(rel <= tol, f"{name} logits differ from the plain path by {rel:.3e}")
    return dict(max_abs_err=err, rel_err=rel, tol=tol, argmax_equal=same)


def generate_paths(params, cfg, dev, gen) -> dict:
    """PR 1's generate path (bf16 KV, unfused MLP) and bench.py's decode
    configuration (int8 KV, fused MLP), each checked against the plain path
    and driven through the same requests, and timed side by side."""
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step, generate, prefill

    configs = {"generate": (torch.bfloat16, False), "bench_decode": (torch.int8, True)}
    prompts = [torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=dev)
               for b, p, _ in REQUESTS]
    (_, p1, n1), prompt1 = REQUESTS[0], prompts[0]
    out = {}
    for path, (kv, fused) in configs.items():
        print(f"  -- {path}: {kv} KV, fused MLP {fused}")
        # kernel path against the plain path: prefill, then one decode step
        logits, first = {}, {}
        for use in (True, False):
            caches = init_caches(cfg, 1, p1 + n1, device=dev, dtype=kv)
            lp, caches = prefill(params, cfg, prompt1, caches, use_kernels=use)
            tok = torch.argmax(lp, -1)
            ld, _ = decode_step(params, cfg, tok[:, None], p1, caches, use_kernels=use,
                                fused_mlp=fused)
            logits[use], first[use] = (lp, ld), tok
            del caches
        checks = {name: check_logits(f"{path} {name}", logits[True][i], logits[False][i])
                  for i, name in enumerate(("prefill", "decode"))}

        def serve(kv=kv, fused=fused):
            outs, ms = [], []
            for (b, p, n), prompt in zip(REQUESTS, prompts):
                t0 = time.perf_counter()
                caches = init_caches(cfg, b, p + n, device=dev, dtype=kv)
                lp, caches = prefill(params, cfg, prompt, caches)
                toks = decode_loop(params, cfg, torch.argmax(lp, -1), p, caches, n,
                                   fused_mlp=fused)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                outs.append(toks)
            return outs, ms

        (outs, gen_ms), counts = counted(path, serve)
        for (b, p, n), toks, ms in zip(REQUESTS, outs, gen_ms):
            print(f"  {path} b={b} p={p} n={n}: {ms:.1f} ms")
            check(tuple(toks.shape) == (b, n), f"{path} returned {tuple(toks.shape)}, want {(b, n)}")
            check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "tokens out of range")
        check(int(outs[0][0, 0]) == int(first[True][0]), f"{path}: first token is not prefill's argmax")
        if path == "generate":  # the entry point itself, once
            g = generate(params, cfg, prompt1, 2)
            check(bool((g[:, 0] == outs[0][:, 0]).all()), "generate disagrees with prefill")
        out[path] = dict(checks=checks, counts=counts, generate_ms=gen_ms)

    # the two stages of the first request, timed apart, the paths in turns
    runs = {path: dict(prefill_ms=[], decode_ms=[]) for path in configs}
    for _ in range(3):
        for path, (kv, fused) in configs.items():
            caches = init_caches(cfg, 1, p1 + n1, device=dev, dtype=kv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lp, caches = prefill(params, cfg, prompt1, caches)
            tok = torch.argmax(lp, -1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            decode_loop(params, cfg, tok, p1, caches, n1, fused_mlp=fused)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            runs[path]["prefill_ms"].append(1e3 * (t1 - t0))
            runs[path]["decode_ms"].append(1e3 * (t2 - t1) / (n1 - 1))
            del caches
    for path, r in runs.items():
        dms = statistics.median(r["decode_ms"])
        out[path]["timing"] = dict(
            prefill_ms=statistics.median(r["prefill_ms"]), decode_ms_per_step=dms,
            decode_tok_s=1e3 / dms, prefill_ms_runs=r["prefill_ms"],
            decode_ms_per_step_runs=r["decode_ms"])
        print(f"  {path} b=1 p={p1}: prefill {out[path]['timing']['prefill_ms']:.2f} ms, "
              f"decode {dms:.3f} ms/step = {1e3 / dms:.2f} tok/s "
              f"(runs {['%.3f' % v for v in r['decode_ms']]})")
    return out


def _post(port: int, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVE_TIMEOUT_S)
    try:
        conn.request("POST", "/generate", json.dumps(body), {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    check(r.status == 200, f"/generate answered {r.status}: {data[:200]!r}")
    if body.get("stream"):
        events = [json.loads(line[len(b"data: "):]) for line in data.split(b"\n\n")
                  if line.startswith(b"data: ")]
        check(bool(events) and events[-1]["done"], "stream did not end with done")
        return [t for ev in events for t in ev["tokens"]]
    return json.loads(data)["tokens"]


def server_path(params, cfg, dev, gen) -> dict:
    """The engine with its accelerator defaults behind its HTTP server."""
    import torch

    from eetq_tpu_torch.models.transformer import forward_inner, init_caches
    from eetq_tpu_torch.serve.api import EngineServer
    from eetq_tpu_torch.serve.engine import Engine

    eng = Engine(params, cfg, max_batch=8, max_len=2048)
    check(eng.a8_prefill and eng.kv_dtype == torch.int8,
          f"engine defaults on CUDA: a8_prefill {eng.a8_prefill}, kv {eng.kv_dtype}")
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    # one admission's forward, with kernels and with the plain versions: a
    # prompt right-padded to its bucket, as _prefill_group runs it
    n = ADMISSION_PROMPT
    bucket = eng._bucket_for(n)
    toks = torch.zeros(1, bucket, dtype=torch.long, device=dev)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev)
    pos = torch.arange(bucket, device=dev)[None]
    last = torch.tensor([n - 1], device=dev)
    logits = {}
    for use in (True, False):
        with torch.inference_mode():
            scratch = init_caches(cfg, 1, bucket, dev, torch.int8)
            lg, _ = forward_inner(params, cfg, toks, pos, scratch, 0, use_kernels=use, a8=True,
                                  last_pos=last)
        logits[use] = lg[:, -1]
        del scratch
    admission = check_logits("server admission (a8)", logits[True], logits[False], A8_MODEL_TOL)

    lengths = [SERVE_LENGTHS[i] for i in torch.randint(
        0, len(SERVE_LENGTHS), (SERVE_REQUESTS,), generator=gen, device=dev).tolist()]
    budgets = [SERVE_BUDGETS[i] for i in torch.randint(
        0, len(SERVE_BUDGETS), (SERVE_REQUESTS,), generator=gen, device=dev).tolist()]
    bodies = []
    for i, (p, b) in enumerate(zip(lengths, budgets)):
        ids = torch.randint(0, cfg.vocab_size, (p,), generator=gen, device=dev).tolist()
        body = {"prompt": ids, "max_new_tokens": b, "stream": i % 5 == 1}
        if i in (3, 8):  # two sampled requests
            body.update(temperature=0.8, top_k=40)
        bodies.append(body)

    srv = EngineServer(eng, host="127.0.0.1", port=0)
    srv.start()
    results, latency, errors = {}, {}, []

    def worker(idx):
        for i in idx:
            t = time.perf_counter()
            try:
                results[i] = _post(srv.port, bodies[i])
            except Exception as e:  # reported below, fails the run
                errors.append(f"request {i}: {e!r}")
                return
            latency[i] = 1e3 * (time.perf_counter() - t)

    def serve():
        threads = [threading.Thread(target=worker, args=(range(j, SERVE_REQUESTS, SERVE_THREADS),))
                   for j in range(SERVE_THREADS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(SERVE_TIMEOUT_S)
        return time.perf_counter() - t

    try:
        wall_s, counts = counted("server", serve)
    finally:
        srv.shutdown()
    check(not errors, f"HTTP requests failed: {errors}")
    check(len(results) == SERVE_REQUESTS, f"{len(results)} of {SERVE_REQUESTS} requests answered")
    busy = [k for k in SERVER_IDLE if counts[k]]
    check(not busy, f"kernels launched on the server path that must not be: {busy}")
    for i, body in enumerate(bodies):
        got = results[i]
        check(len(got) == body["max_new_tokens"],
              f"request {i}: {len(got)} tokens, want {body['max_new_tokens']}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"request {i}: token out of range")
    tokens = sum(budgets)
    lat = [latency[i] for i in range(SERVE_REQUESTS)]
    print(f"  server: {SERVE_REQUESTS} requests, prompts {lengths}, budgets {budgets}; "
          f"{tokens} tokens in {wall_s:.2f} s = {tokens / wall_s:.2f} tok/s served "
          f"(warmup {warmup_s:.1f} s)")
    print(f"  server latencies (ms): {['%.1f' % v for v in lat]}")
    return dict(admission=admission, counts=counts, prompt_lengths=lengths, budgets=budgets,
                tokens=tokens, wall_s=wall_s, served_tok_s=tokens / wall_s,
                latency_ms=lat, warmup_s=warmup_s)


def model_phase(dev) -> dict:
    """MODEL at full width and depth, W8A16, through the three paths."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import quantize_params, random_dense_params

    cfg = PRESETS[MODEL]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    dense = random_dense_params(cfg, gen)
    params = quantize_params(dense, quantize_lm_head=True)
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    weight_gb = sum(b.numel() * b.element_size() for b in params.buffers()) / 1e9
    print(f"  {MODEL} W8A16 built in {init_s:.1f} s, {weight_gb:.2f} GB on the card")
    paths = generate_paths(params, cfg, dev, gen)
    paths["server"] = server_path(params, cfg, dev, gen)
    return dict(paths=paths, init_s=init_s, weight_gb=weight_gb,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="directory for chip_smoke.json (details)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    from eetq_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    info = _build.build()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {info['nvcc_version']}")
    print(card)
    print(f"kernels built in {info['seconds']:.1f} s (cached: {info['cached']})")
    with torch.inference_mode():
        kern = kernel_phase(dev)
    model = model_phase(dev)
    paths = model["paths"]
    kernels = [
        dict(name=name, route=REPLACES[name][0], source=REPLACES[name][1],
             replaces=REPLACES[name][2],
             launches=sum(p["counts"][name] for p in paths.values()),
             max_abs_err=kern["summary"][name]["max_abs_err"],
             ms=kern["summary"][name]["ms"], plain_ms=kern["summary"][name]["plain_ms"])
        for name in REPLACES
    ]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, build_s=info["seconds"], nvcc_log=info["log"],
                           kernels=kern["rows"], model=model), f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
