#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on an NVIDIA GPU and check them.

Run from the repository root, on a machine with one CUDA card (an H100):

    python3 chip_smoke.py [--out DIR] [--profile] [--phases LIST]

1. Environment: torch/CUDA/nvcc versions, the card's name and power limit;
   builds the kernels of `eetq_tpu_torch/csrc/` with nvcc (one process per
   source, all at once). It reads ptxas's `-Xptxas=-v` report and lists the
   kernels whose `wgmma`s ptxas serialized (warning C7520); the run fails if
   any of them is behind `w8a16_gemm`, `w4a16_gemm`, `w8a8_gemm` or
   `w4a8_gemm`. It counts the tensor-core MMAs (`HMMA.16816`) of every
   decode GEMV kernel in the library's SASS (`cuobjdump -sass`) and fails if
   one has none.
2. Kernels: each of the seventeen kernel entry points against its plain
   PyTorch version on the card at llama2-7b shapes (the MoE kernels at
   Mixtral-8x7B's), with its error, its time beside the plain time, the
   least time the card could take for the same bytes and operations (from
   the shapes and the datasheet rates) and, for the two attention kernels,
   the time of `F.scaled_dot_product_attention` on the same inputs (a
   yardstick: the port never calls it). Every kernel and library call is
   timed twice: one launch between two events after an L2 flush (median of
   20; under 0.1 ms this holds the wrapper's host time), and many launches
   back to back, captured in a CUDA graph, between two events. Prefill
   attention also runs GQA 32/8, ragged lengths (77, 1000), D = 64, a query
   block appended to a cache (delta 256) and a batch of four short prompts;
   the per-channel int8 GEMM also runs m = 9, 200 and 512 and an odd (K, N)
   with bias. The decode GEMVs' summaries keep two regimes apart, m = 1 (b=1
   decode) and m = 8 (an 8-slot engine step); the int8 per-channel GEMV and
   GEMM rows are also timed against `torch._weight_int8pack_mm`, the int4
   g=128 rows against `torch._weight_int4pack_mm` (the yardsticks' packed
   weights made outside the timed call; where the card's PyTorch has no CUDA
   kernel for one, the exception is printed and `library_ms` is null). Every
   GEMV, expert-gather, fused-MLP and flash-decode case runs twice and must
   give bit-equal outputs. The int8 flash-decode's summary keeps two regimes
   apart, B=1 over 1152 keys (b=1 decode) and B=8 over 2048 (an 8-slot
   engine step). The int4 kernels run per-channel
   and with 128-row scale groups, the W8A8 and per-channel W4A8 outputs
   must equal their plain versions bit for bit, and one odd shape each
   needs padding in K and N. Paged decode (bf16 and int8 pools) runs 8
   rows of lengths 1..1088 over 256-token blocks behind a permuted table
   whose dead entries point out of the pool, and must be bit-equal to the
   dense kernel on the gathered cache. The two MoE kernels run int8 and
   int4 banks, per-channel and with 128-row scale groups; the grouped GEMM
   at bm = 128 (a prompt: the wide tile), bm = 8 (an 8-slot engine step: the
   skinny tile), 16 and 64, with the padding blocks skipped by their count,
   and its summary keeps the prompt and the engine-step regimes apart.
   Then `moe_apply` on one full-width Mixtral layer (int8 per-channel, and
   int4 g=128) at 2, 8 and 2048 selections, kernels against the plain path
   on identical input (the routing ids must agree), the kernel calls under
   `torch.cuda.set_sync_debug_mode("error")`: any host sync fails.
3. Model: llama2-7b at full width and depth (32 layers), random weights
   from a seeded `torch.Generator` on the card, W8A16 per-channel with an
   int8 lm_head, built once and driven four ways. Each path runs with the
   launch counters set to 0 just before it and read just after, and every
   kernel it runs must have launched.
   - generate: bf16 KV, unfused MLP, W8A16 prefill; prefill and one decode
     step against the plain path (the decode step must make as many GEMV
     launches as before the tensor-core GEMV: 4 a layer + the lm_head, 129),
     then batch 1 x 1024-token prompt x 50 greedy tokens and batch 4 x 128 x
     32. `decode_loop` runs on the card as one captured step replayed
     (`serve/graph.py`): its 50 greedy tokens must be bit-equal to a Python
     loop of eager `decode_step` on a copy of the same caches, and its
     launch counts those of 49 eager steps (a replay adds its capture's).
     The timing prints ms/step over the 49 steps, and apart the eager
     warm-up step, the capture and the ms of a replayed step.
   - bench decode (`bench.py`'s configuration): prefill into an int8 KV
     cache, then `decode_loop(fused_mlp=True)`; the same checks and
     requests, and prefill/decode times beside the generate path's.
   - server: `Engine(params, cfg, max_batch=8, max_len=2048)` with its
     defaults (which must resolve to W8A8 prefill, int8 KV, decode windows
     of 8 chained up to 8; `warmup()` and `warmup(temperature=0.8)` capture
     the greedy and the sampled window-1 and window-8 programs) behind
     `EngineServer` on 127.0.0.1; about 12 HTTP requests of mixed prompt
     lengths and budgets from several threads; one admission's logits
     against the plain path; `w8a16_gemm` must not launch; the greedy
     requests' tokens equal those of an `Engine(decode_window=1)` twin.
   - paged_server: `Engine(..., paged_blocks=41)` (40 blocks of 256 tokens
     and the trash block) behind the same server and requests. It must
     resolve to W8A8 prefill and a bf16 pool; the paged flash-decode kernel
     launches 32 times per decode step and the dense flash-decode entry
     points not at all; the logits of one 8-slot engine step are held
     against the plain path; every block is back on the free list at the
     end; and the greedy requests' tokens equal those of a window-1 engine
     with a dense bf16 cache.
   llama2-7b is freed before the next model is built.
4. llama2-7b again with int4 weights, at full width and depth, built one
   layer at a time (`random_quantized_params`, 3.6-3.9 GB), two models:
   - int4_generate: int4 with 128-row scale groups, the lm_head quantized
     the same way; bf16 KV, unfused MLP; as `generate` in 3. Runs the int4
     GEMV and GEMM; no int8 and no W8A8/W4A8 kernel may launch.
   - int4_server: the same model in the default Engine behind EngineServer,
     as `server` in 3: W4A8 (group-wise) at admission, the int4 GEMV at
     decode; the int4 GEMM and W8A8 must not launch.
   - int4_bench_decode (`EETQ_BENCH_BITS=4 python bench.py`'s model): int4
     per-channel layers under an int8 lm_head; int8 KV,
     `decode_loop(fused_mlp=True)`; as `bench decode` in 3. Runs the int4
     fused MLP, the int4 GEMV (qkv, o) and the int8 GEMV (lm_head).
5. Mixtral-8x7B W8A16 at full width and depth (32 layers, 8 experts of
   4096 x 14336, top-2), built one layer at a time (the bf16 model,
   ~93 GB, never exists), int8 lm_head, driven two ways: generate (as in
   3, the same requests) and the default Engine behind EngineServer (as in
   3). The fused MLP must not launch on either. Top-2 routing is
   discontinuous, so each check of the logits replays the kernel path's
   routing in the plain path (a wrapper of `modules.moe.route` records
   each call's weights and ids, then hands them back in order); how many
   routings the plain path would pick otherwise is printed too.
6. Mixtral-8x7B again at W4A16 with 128-row scale groups throughout (expert
   banks, attention linears, lm_head; 32 layers, built one layer at a
   time): mixtral_int4_generate (the int4 grouped GEMM at prefill, the int4
   expert gather at decode; the int8 bank kernels must not launch) and
   mixtral_int4_paged_server (`Engine(..., paged_blocks=41,
   kv_dtype=torch.int8)`: W4A8 attention linears at admission, the int4
   grouped GEMM at admission and at every 8-slot step, the paged int8
   flash-decode; the bf16 one must not launch), checked as in 5.

With `--profile`, each llama2-7b path, the paged engine and the Mixtral
paths are also run under `torch.profiler` (one prefill, the first request's
whole decode_loop, and one steady-state engine step after `warmup()`: a
chain of 8 windows of 8 with 8 slots busy): per decode step, device-busy
time, kernel events (and those of the flash-decode, which must be one a
layer on every decode and engine step), the host's launch calls (a graph
replay is one) and the idle share go to the output and to
`chip_smoke.json`. `--phases`
runs a subset of `kernels,moe_layer,llama,int4,mixtral,mixtral_int4` (for
debugging: a partial run checks what it runs and prints no result line).

Prints one JSON line of per-kernel results, then as its last line
`{"ok": true, "device": {...}}`. Any failed check, build or launch ends the
run with a non-zero exit code and no result line; so does a machine without
a CUDA device. With `--out DIR` the details (every kernel case, the model
timings, nvcc's register report) also go to `DIR/chip_smoke.json`.
"""

from __future__ import annotations

import contextlib
import gc
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
MIXTRAL = "mixtral-8x7b"
REQUESTS = ((1, 1024, 50), (4, 128, 32))  # (batch, prompt tokens, new tokens)
LLAMA_SHAPES = [  # (K, N) of qkv, o_proj, gate/up, down, lm_head
    (4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
]
PRENORM_SHAPES = {(4096, 12288), (4096, 22016)}  # qkv and gate/up take the fused norm
W8A8_SHAPES = LLAMA_SHAPES[:4]  # the prefill projections (the lm_head stays W8A16)
W8A8_ROWS = (32, 1024)  # the engine's smallest prompt bucket, and a full one
INT4_GROUP = 128  # rows per scale group of the group-wise int4 cases and models
# The decode GEMV's two regimes on the main paths, summed apart: b=1 decode
# (generate, bench decode) and an 8-slot engine step (the servers)
GEMV_REGIMES = {1: "decode m=1", 8: "engine step m=8"}
# One odd shape per int4 kernel, where K and N need padding: (K, N, group size)
INT4_ODD = ((1000, 300, None), (960, 300, 64))
# The per-channel int8 GEMM off its 128 x 128 x 64 tile: rows (one past the
# GEMV's 8, ragged row blocks, full), at the o_proj and down shapes and at an
# odd (K, N) whose output rows are not 16-byte aligned
GEMM_ROWS = (9, 200, 512, 1024)
GEMM_EDGE_SHAPES = {(4096, 4096), (11008, 4096)}
GEMM_ODD = (1000, 300)
# Prefill attention, (batch, sq, skv, q heads, kv heads, head_dim), causal:
# the main path's shape first, then GQA, ragged lengths in one- and
# two-warpgroup tiles, D = 64, a query block appended to a cache of 256 keys
# (delta = skv - sq) and a batch of short prompts
ATTENTION_CASES = (
    (1, 1024, 1024, 32, 32, 128), (1, 1024, 1024, 32, 8, 128), (1, 77, 77, 32, 8, 128),
    (1, 1000, 1000, 32, 32, 128), (1, 1000, 1000, 32, 8, 64), (1, 128, 384, 32, 8, 128),
    (4, 128, 128, 32, 32, 128),
)
# The card's datasheet rates (H100 SXM, dense), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
# Mixtral's expert banks, (K, N) of gate|up and down; 8 experts, top-2
MIXTRAL_BANKS = ((4096, 28672), (14336, 4096))
# Expert gather: (rows of x at gate|up and at down, ids) of a b=1 and a b=4
# decode step; b=4's 8 selections hold a repeated id
GATHER_CASES = ((1, 2, (5, 2)), (4, 8, (1, 6, 6, 3, 0, 2, 7, 6)))
# Grouped GEMM: (bm, blocks, experts of the real blocks, the main path's
# regime or None); padding blocks follow, clamped to expert 7, and are
# skipped by the count of real blocks. A b=1 p=1024 prompt (2048 selections,
# bm 128: 2048 // 128 + 8 = 24 blocks, 19 of them real: the wide tile), the
# engine's 8-slot decode step (16 selections, bm 8: 10 blocks, 7 real,
# expert 5 idle: the skinny tile), and one case on each side of the
# crossover (128 selections at bm 16, 512 at bm 64).
GROUPED_CASES = ((128, 24, (0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 6, 7, 7), "prefill"),
                 (8, 10, (0, 1, 2, 3, 4, 6, 7), "engine step"),
                 (16, 16, (0, 0, 1, 2, 2, 3, 4, 5, 5, 6, 7), None),
                 (64, 16, (0, 0, 1, 1, 2, 3, 3, 4, 5, 5, 6, 7, 7), None))
MOE_TOKENS = (1, 4, 1024)  # moe_apply on one layer: 2, 8 and 2048 selections
# The server phase: prompt lengths and budgets drawn from a seeded generator
SERVE_REQUESTS = 12
SERVE_LENGTHS = (17, 100, 300, 700, 1024)
SERVE_BUDGETS = (16, 32, 64)
SERVE_THREADS = 4
SERVE_TIMEOUT_S = 600
ADMISSION_PROMPT = 700  # the admission whose logits are checked: 700 tokens in the 1024 bucket
# The int8 flash-decode's two regimes on the main paths, summed apart, by
# (batch, cache length): b=1 decode after a 1024-token prompt (bench decode)
# and the default engine's 8-slot step over its 2048-key cache (the server)
DECODE_REGIMES = {(1, 1152): "decode b=1", (8, 2048): "engine step B=8"}
# The paged engines: 8 slots x 5 blocks of 256 tokens (the longest request of
# the server mix is 1024 + 64 tokens) and the trash block
PAGED_BLOCKS, PAGED_BLOCK_SIZE = 41, 256
# Paged decode in the kernel phase: a pool of more blocks than the engine's,
# rows of very different lengths (one token, block edges, the longest request)
PAGED_POOL_BLOCKS = 72  # a distinct block for every table entry (8 x 8)
PAGED_LENGTHS = (1, 17, 130, 300, 555, 777, 1024, 1088)
# The engine step whose decode logits are checked: prompts of these lengths
STEP_PROMPTS = (17, 100, 300, 700, 1024, 33, 257, 512)
STEP_BUDGET = 200  # more than the 8 x 8 tokens of the chain after the last admission
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
# The sources behind w8a16_gemm, w4a16_gemm, w8a8_gemm and w4a8_gemm: a C7520
# warning of ptxas for any of them fails the run (the grouped GEMM's
# per-slice group modes are known to draw it and are listed only).
UNSERIALIZED_SOURCES = ("w8a16_gemm.cu", "w4a16_gemm.cu", "w8a8_gemm.cu", "w4a8_gemm.cu")
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
    "w8a16_expert_gemv": ("cuda", "eetq_tpu_torch/csrc/w8a16_expert_gemv.cu",
                          "eetq_tpu/kernels/w8a16.py:434"),
    "w8a16_grouped_gemm": ("cuda", "eetq_tpu_torch/csrc/w8a16_grouped_gemm.cu",
                           "eetq_tpu/kernels/w8a16.py:537"),
    "w4a16_gemv": ("cuda", "eetq_tpu_torch/csrc/w4a16_gemv.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "w4a16_gemm": ("cuda", "eetq_tpu_torch/csrc/w4a16_gemm.cu", "eetq_tpu/kernels/w8a16.py:239"),
    "fused_mlp_gemv_i4": ("cuda", "eetq_tpu_torch/csrc/fused_mlp_i4.cu",
                          "eetq_tpu/kernels/mlp_fused.py:241"),
    "w4a8_gemm": ("cuda", "eetq_tpu_torch/csrc/w4a8_gemm.cu", "eetq_tpu/kernels/w8a8.py:277"),
    "paged_flash_decode": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                           "eetq_tpu/kernels/flash_decode.py:228"),
    "paged_flash_decode_int8": ("cuda", "eetq_tpu_torch/csrc/flash_decode.cu",
                                "eetq_tpu/kernels/flash_decode.py:228"),
    "w4a16_expert_gemv": ("cuda", "eetq_tpu_torch/csrc/w4a16_expert_gemv.cu",
                          "eetq_tpu/kernels/w8a16.py:434"),
    "w4a16_grouped_gemm": ("cuda", "eetq_tpu_torch/csrc/w4a16_grouped_gemm.cu",
                           "eetq_tpu/kernels/w8a16.py:537"),
}
# The kernels each path must launch, and those it must not.
PATH_KERNELS = {
    "generate": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "flash_decode"),
    "bench_decode": ("w8a16_gemv", "w8a16_gemm", "flash_attention_fwd", "fused_mlp_gemv",
                     "flash_decode_int8"),
    "server": ("w8a16_gemv", "flash_attention_fwd", "w8a8_gemm", "flash_decode_int8"),
    "mixtral_generate": ("w8a16_expert_gemv", "w8a16_grouped_gemm", "w8a16_gemv", "w8a16_gemm",
                         "flash_attention_fwd", "flash_decode"),
    "mixtral_server": ("w8a16_grouped_gemm", "w8a8_gemm", "w8a16_gemv", "flash_attention_fwd",
                       "flash_decode_int8"),
    "int4_generate": ("w4a16_gemv", "w4a16_gemm", "flash_attention_fwd", "flash_decode"),
    # int4 layers under an int8 lm_head: both GEMVs
    "int4_bench_decode": ("fused_mlp_gemv_i4", "w4a16_gemv", "w8a16_gemv", "w4a16_gemm",
                          "flash_attention_fwd", "flash_decode_int8"),
    "int4_server": ("w4a8_gemm", "w4a16_gemv", "flash_attention_fwd", "flash_decode_int8"),
    "paged_server": ("w8a16_gemv", "flash_attention_fwd", "w8a8_gemm", "paged_flash_decode"),
    "mixtral_int4_generate": ("w4a16_expert_gemv", "w4a16_grouped_gemm", "w4a16_gemv",
                              "w4a16_gemm", "flash_attention_fwd", "flash_decode"),
    # the 8-slot step holds 16 selections: always the grouped GEMM
    "mixtral_int4_paged_server": ("w4a16_grouped_gemm", "w4a8_gemm", "w4a16_gemv",
                                  "flash_attention_fwd", "paged_flash_decode_int8"),
}
# The entry points of the decode GEMV (`csrc/gemv.cuh`)
GEMV_FAMILY = ("w8a16_gemv", "w4a16_gemv", "w8a16_expert_gemv", "w4a16_expert_gemv",
               "fused_mlp_gemv", "fused_mlp_gemv_i4")
# ... and of the flash-decode (`csrc/flash_decode.cu`): two launches of each
# must give bit-equal outputs (both sum their blocks' partials in a fixed
# order, with no float atomics)
DECODE_FAMILY = ("flash_decode", "flash_decode_int8", "paged_flash_decode",
                 "paged_flash_decode_int8")
REPEAT_EQUAL = GEMV_FAMILY + DECODE_FAMILY
MOE_KERNELS = ("w8a16_expert_gemv", "w8a16_grouped_gemm")
INT4_MOE_KERNELS = ("w4a16_expert_gemv", "w4a16_grouped_gemm")
PAGED_KERNELS = ("paged_flash_decode", "paged_flash_decode_int8")
DENSE_DECODE = ("flash_decode", "flash_decode_int8")
INT4_KERNELS = ("w4a16_gemv", "w4a16_gemm", "fused_mlp_gemv_i4", "w4a8_gemm")
INT8_DENSE = ("w8a16_gemv", "w8a16_gemm", "fused_mlp_gemv", "w8a8_gemm")
PATH_IDLE = {
    "generate": MOE_KERNELS + INT4_KERNELS,
    "bench_decode": MOE_KERNELS + INT4_KERNELS,
    # under a8 every prefill projection is W8A8
    "server": ("w8a16_gemm",) + MOE_KERNELS + INT4_KERNELS,
    # a MoE layer has no dense MLP to fuse
    "mixtral_generate": ("fused_mlp_gemv",) + INT4_KERNELS,
    "mixtral_server": ("fused_mlp_gemv", "w8a16_gemm") + INT4_KERNELS,
    "int4_generate": INT8_DENSE + MOE_KERNELS + ("fused_mlp_gemv_i4", "w4a8_gemm"),
    "int4_bench_decode": MOE_KERNELS + ("w8a16_gemm", "fused_mlp_gemv", "w8a8_gemm", "w4a8_gemm"),
    # under a8 every prefill projection of an int4 model is W4A8
    "int4_server": INT8_DENSE + MOE_KERNELS + ("w4a16_gemm", "fused_mlp_gemv_i4"),
}
# none of the paths above runs a paged cache or an int4 expert bank
PATH_IDLE = {path: idle + PAGED_KERNELS + INT4_MOE_KERNELS for path, idle in PATH_IDLE.items()}
PATH_IDLE.update({
    # a paged engine never reaches the dense flash-decode entry points
    "paged_server": DENSE_DECODE + ("paged_flash_decode_int8", "w8a16_gemm") + MOE_KERNELS
    + INT4_KERNELS + INT4_MOE_KERNELS,
    "mixtral_int4_generate": INT8_DENSE + MOE_KERNELS + PAGED_KERNELS
    + ("fused_mlp_gemv_i4", "w4a8_gemm", "flash_decode_int8"),
    "mixtral_int4_paged_server": INT8_DENSE + MOE_KERNELS + DENSE_DECODE
    + ("paged_flash_decode", "w4a16_gemm", "fused_mlp_gemv_i4"),
})


PHASES = ("kernels", "moe_layer", "llama", "int4", "mixtral", "mixtral_int4")


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def serialized_wgmma(log: str) -> dict:
    """{source: [function, ...]} of ptxas's C7520 warnings in the build log
    (`_build.py` compiles each source with `-Xptxas=-v` under a "== name"
    line): kernels whose `wgmma`s ptxas serialized because it found one, or a
    read of its accumulators, on a path it could not prove uniform."""
    import re

    found, source = {}, None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "C7520" in line:
            name = re.search(r"function '([^']+)'", line)
            found.setdefault(source, []).append(name.group(1) if name else line.strip())
    return found


def gemv_tensor_core_mmas(lib_path: str) -> dict:
    """{GEMV kernel: m16n8k16 tensor-core MMAs} in the built library's SASS
    (`cuobjdump -sass`, beside nvcc): the decode GEMV's product must run on
    the tensor cores (`mma.sync` bf16 compiles to HMMA.16816.F32.BF16)."""
    import re

    from eetq_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        name = re.search(r"Function : (\S+)", line)
        if name:
            fn = name.group(1) if "gemv_kernel" in name.group(1) else None
            if fn:
                found[fn] = 0
        elif fn and re.search(r"\bHMMA\.16816\b", line):
            found[fn] += 1
    return found


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


def time_many_ms(fn, single_ms: float, flush=None, device_ms: float = 2.0) -> float:
    """Device time of one fn() from a run of launches back to back between
    two CUDA events: enough of them for `device_ms` of device work by the
    single-launch reading `single_ms` (20 to 2,000), captured once into a
    CUDA graph and replayed after one L2 flush. The device never waits for
    the host inside the run, so a kernel of a few microseconds reads its own
    time here; `time_ms` puts one event pair round one Python call and reads
    the wrapper's host time with it. After the first launch the inputs lie
    in L2 where they fit it. fn() must not synchronise with the host."""
    import torch

    n = max(20, min(2000, int(device_ms / max(single_ms, 1e-3)) + 1))
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()  # warm
    if flush is not None:
        flush.sum()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / n


def compare(out, ref) -> tuple[float, float]:
    import torch

    check(bool(torch.isfinite(out.float()).all()), "kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def decode_cost(lens, hq: int, hkv: int, kv_bytes: int, scale_bytes: int,
                d: int = 128) -> tuple[float, float]:
    """(bytes, operations) of one flash-decode call with rows of `lens` keys:
    only the keys below each row's length are needed (K and V at kv_bytes a
    value and scale_bytes a key), q read and the output written once."""
    keys = sum(lens)
    return (keys * hkv * 2 * (d * kv_bytes + scale_bytes) + len(lens) * (2 * hq * d * 2 + 4),
            4.0 * hq * d * keys)


def linear_cost(m: int, k: int, n: int, w_bytes: float, scale_rows: int = 1, x_bytes: int = 2,
                extra: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one quantized linear: the weight at w_bytes a
    value, scale_rows rows of f32 scales, x read and the bf16 output written
    once, `extra` bytes of gamma, per-token scales and the like."""
    return k * n * w_bytes + scale_rows * n * 4 + m * k * x_bytes + m * n * 2 + extra, 2.0 * m * k * n


LIBRARY = {}  # yardstick calls the card's PyTorch build failed: {call: the reason}


def weight_pack_call(x, q, scales, bits: int, group, ref):
    """One PyTorch call computing x @ dequant(q) on the card (q the logical
    [K, N] values), timed beside a kernel as its yardstick and never called
    by the port: torch._weight_int8pack_mm for int8 per-channel weights (the
    [N, K] copy of q made here), torch._weight_int4pack_mm for int4 weights
    with scale groups (packed here from q + 8, even K in the high nibble, by
    torch._convert_weight_to_int4pack; zero points 0). None where nothing
    computes the function, or where the build has no CUDA kernel for the call
    or the call does not reproduce `ref` (printed once, with the reason)."""
    import torch

    if bits == 8 and group is None:
        name = "torch._weight_int8pack_mm"
    elif bits == 4 and group is not None:
        name = "torch._weight_int4pack_mm"
    else:
        return None
    name += " (m <= 8)" if x.shape[0] <= 8 else " (m > 8)"
    if LIBRARY.get(name):  # failed before
        return None
    try:
        if bits == 8:
            w, s = q.t().contiguous(), scales.to(x.dtype)
            fn = lambda: torch._weight_int8pack_mm(x, w, s)  # noqa: E731
        else:
            u = q.t().to(torch.int32) + 8  # [N, K]
            w = torch._convert_weight_to_int4pack(
                ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)
            sz = torch.stack([scales, torch.zeros_like(scales)], -1).to(x.dtype).contiguous()
            fn = lambda: torch._weight_int4pack_mm(x, w, group, sz)  # noqa: E731
        err = (fn().float() - ref.float()).abs().max().item()
        if err > TOL * ref.float().abs().max().item():
            raise RuntimeError(f"differs from the plain version by {err:.3e}")
    except Exception as exc:  # the yardstick is optional: the run goes on without it
        LIBRARY[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
        print(f"  {name} is not timed on this card: {LIBRARY[name]}")
        return None
    return fn


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version at llama2-7b shapes, the MoE
    kernels at Mixtral's."""
    import torch
    import torch.nn.functional as F

    from eetq_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from eetq_tpu_torch.kernels.flash_decode import (
        flash_decode,
        flash_decode_int8,
        flash_decode_int8_ref,
        flash_decode_ref,
        gather_pool,
        paged_flash_decode,
        paged_flash_decode_int8,
        paged_flash_decode_int8_ref,
        paged_flash_decode_ref,
    )
    from eetq_tpu_torch.kernels.mlp_fused import (
        fused_mlp_gemv,
        fused_mlp_gemv_i4,
        fused_mlp_ref,
    )
    from eetq_tpu_torch.kernels.w8a8 import (
        quantize_activations,
        w4a8_gemm,
        w8a8_gemm,
        w8a8_gemm_ref,
    )
    from eetq_tpu_torch.kernels.w8a16 import (
        expert_matmul_ref,
        grouped_matmul_ref,
        w4a16_expert_gemv,
        w4a16_gemm,
        w4a16_gemv,
        w4a16_grouped_gemm,
        w8a16_expert_gemv,
        w8a16_gemm,
        w8a16_gemv,
        w8a16_grouped_gemm,
        w8a16_matmul_ref,
    )
    from eetq_tpu_torch.layout.tiling import pack_weights
    from eetq_tpu_torch.ops.rmsnorm import rmsnorm

    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.ones(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB
    rows, summary = [], {}

    def record(name, case, fn, plain, path_shape, cost, op_type="bf16", library=None,
               equal=False, regime=None, **extra):
        """Run fn() (the kernel) and plain() on the same inputs, compare and
        time both. cost = (bytes, operations) of the function at this case;
        library() is one PyTorch call computing the same function, if any;
        equal: the outputs must not differ in any element; regime: a path
        shape's regime, summed apart in the kernel's summary too; extra:
        further fields of the case's row."""
        out, ref = fn(), plain()
        err, ref_max = compare(out, ref)
        n_diff = int((out.float() != ref.float()).sum().item())
        repeat_equal = bool(torch.equal(out, fn())) if name in REPEAT_EQUAL else None
        ms, plain_ms = time_ms(fn, flush=flush), time_ms(plain, flush=flush)
        library_ms = None if library is None else time_ms(library, flush=flush)
        many_ms = time_many_ms(fn, ms, flush)
        library_many_ms = None if library is None else time_many_ms(library, library_ms, flush)
        bytes_ms = 1e3 * cost[0] / HBM_BYTES_PER_S
        ops_ms = 1e3 * cost[1] / PEAK_OPS_PER_S[op_type]
        ok = err <= TOL * ref_max and not (equal and n_diff) and repeat_equal is not False
        rows.append(dict(kernel=name, case=case, regime=regime, max_abs_err=err,
                         repeat_equal=repeat_equal,
                         ref_absmax=ref_max, tol=0.0 if equal else TOL * ref_max, n_diff=n_diff, numel=out.numel(),
                         ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         many_ms=many_ms, library_many_ms=library_many_ms,
                         bytes=cost[0], ops=cost[1], bytes_ms=bytes_ms, ops_ms=ops_ms,
                         bound_ms=max(bytes_ms, ops_ms), path_shape=bool(path_shape), **extra))
        lib = "" if library_ms is None else (f", library {library_ms:8.4f} ms "
                                             f"(back to back {library_many_ms:.4f})")
        rep = "" if repeat_equal is None else (", repeat bit-equal" if repeat_equal
                                               else ", REPEAT DIFFERS")
        print(f"  {name:20s} {case:44s} err {err:.3e} (tol {rows[-1]['tol']:.3e}, "
              f"{n_diff}/{out.numel()} differ{rep}) {ms:8.4f} ms (back to back {many_ms:.4f}), "
              f"plain {plain_ms:8.4f} ms, bound {max(bytes_ms, ops_ms):7.4f} ms{lib} "
              f"{'ok' if ok else 'FAIL'}")
        s = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes_ms=0.0,
                                          ops_ms=0.0, bound_ms=0.0, library_ms=None,
                                          many_ms=0.0, library_many_ms=None))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if path_shape:  # the main path's own shapes make the reported time
            parts = [s]
            if regime is not None:
                parts.append(s.setdefault("regimes", {}).setdefault(regime, dict(
                    ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0, many_ms=0.0,
                    library_ms=None, library_many_ms=None)))
            for part in parts:
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", bytes_ms),
                                 ("ops_ms", ops_ms), ("bound_ms", max(bytes_ms, ops_ms)),
                                 ("many_ms", many_ms)):
                    part[key] += val
                if library_ms is not None:
                    part["library_ms"] = (part["library_ms"] or 0.0) + library_ms
                    part["library_many_ms"] = (part["library_many_ms"] or 0.0) + library_many_ms
        return out

    def scales_for(k, n, group):
        shape = (n,) if group is None else (k // group, n)
        return torch.rand(shape, generator=gen, device=dev) * 2e-3 + 1e-4

    def int4_linear_cases(k, n, group, gemv_ms, gemm_rows, a8_rows, path_group):
        """The int4 GEMV, GEMM and W4A8 GEMM on one [k, n] weight."""
        q = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
        data = pack_weights(q, bits=4).data
        kp = 2 * data.shape[0]
        sc = scales_for(k, n, group)
        srows = 1 if group is None else k // group
        tag = f"K={k} N={n} {'per-channel' if group is None else f'g={group}'}"
        on_path = group == path_group
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        for m in gemv_ms:
            for norm in ((False, True) if (k, n) in PRENORM_SHAPES else (False,)):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                g = gamma if norm else None
                y = rmsnorm(x, gamma, 1e-5) if norm else x
                ref = w8a16_matmul_ref(y, q, sc)
                record("w4a16_gemv", f"m={m} {tag}{' prenorm' if norm else ''}",
                       lambda: w4a16_gemv(x, data, sc, n, gamma=g, eps=1e-5),
                       lambda: w8a16_matmul_ref(rmsnorm(x, gamma, 1e-5) if norm else x, q, sc),
                       on_path and m in GEMV_REGIMES and (k, n) in W8A8_SHAPES
                       and norm == ((k, n) in PRENORM_SHAPES),
                       linear_cost(m, k, n, 0.5, srows, extra=4 * k if norm else 0),
                       library=weight_pack_call(y, q, sc, 4, group, ref) if on_path else None,
                       regime=GEMV_REGIMES.get(m))
        for m in gemm_rows:
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            ref = w8a16_matmul_ref(x, q, sc)
            record("w4a16_gemm", f"m={m} {tag}", lambda: w4a16_gemm(x, data, sc, n),
                   lambda: w8a16_matmul_ref(x, q, sc), on_path and m == 1024,
                   linear_cost(m, k, n, 0.5, srows),
                   library=weight_pack_call(x, q, sc, 4, group, ref) if on_path else None)
        for m in a8_rows:
            xq, sx = quantize_activations(
                torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
            xq = F.pad(xq, (0, kp - k)).contiguous()
            qp = F.pad(q, (0, 0, 0, kp - k))  # the logical values, zero past K
            record("w4a8_gemm", f"m={m} {tag}",
                   lambda: w4a8_gemm(xq, sx, data, sc, n, group_size=group),
                   lambda: w8a8_gemm_ref(xq, sx, qp, sc, n, group_size=group),
                   on_path and m == 1024,
                   linear_cost(m, k, n, 0.5, srows, x_bytes=1, extra=4 * m), "int8",
                   equal=group is None)

    for k, n in LLAMA_SHAPES:
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
        scales = scales_for(k, n, None)
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        for m in (1, 2, 4, 8):
            for norm in ((False, True) if (k, n) in PRENORM_SHAPES else (False,)):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                g = gamma if norm else None
                y = rmsnorm(x, gamma, 1e-5) if norm else x
                ref = w8a16_matmul_ref(y, qw, scales)
                record("w8a16_gemv", f"m={m} K={k} N={n}{' prenorm' if norm else ''}",
                       lambda: w8a16_gemv(x, qw, scales, n, gamma=g, eps=1e-5),
                       lambda: w8a16_matmul_ref(rmsnorm(x, gamma, 1e-5) if norm else x, qw, scales),
                       m in GEMV_REGIMES and norm == ((k, n) in PRENORM_SHAPES),
                       linear_cost(m, k, n, 1, extra=4 * k if norm else 0),
                       library=weight_pack_call(y, qw, scales, 8, None, ref),
                       regime=GEMV_REGIMES.get(m))
        # prefill runs the four layer shapes at m = 1024 (the path's time); the
        # lm_head sees the last token only, and m = 9, 200 and 512 are edges
        # of the tile (one row past the GEMV, ragged row blocks)
        for m in GEMM_ROWS if (k, n) in GEMM_EDGE_SHAPES else (1024,):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            ref = w8a16_matmul_ref(x, qw, scales)
            record("w8a16_gemm", f"m={m} K={k} N={n}", lambda: w8a16_gemm(x, qw, scales, n),
                   lambda: w8a16_matmul_ref(x, qw, scales), m == 1024 and (k, n) in W8A8_SHAPES,
                   linear_cost(m, k, n, 1), library=weight_pack_call(x, qw, scales, 8, None, ref))
        if (k, n) == LLAMA_SHAPES[0]:  # int8 with group-wise scales: the same kernels' group mode
            gs = scales_for(k, n, INT4_GROUP)
            for m, kern in ((1, w8a16_gemv), (8, w8a16_gemv), (1024, w8a16_gemm)):
                xg = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                record(kern.__name__, f"m={m} K={k} N={n} g={INT4_GROUP}",
                       lambda: kern(xg, qw, gs, n), lambda: w8a16_matmul_ref(xg, qw, gs), False,
                       linear_cost(m, k, n, 1, k // INT4_GROUP))
        if (k, n) in W8A8_SHAPES:
            for m in W8A8_ROWS:
                xq, sx = quantize_activations(
                    torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
                xq = xq.contiguous()
                record("w8a8_gemm", f"m={m} K={k} N={n}",
                       lambda: w8a8_gemm(xq, sx, qw, scales, n),
                       lambda: w8a8_gemm_ref(xq, sx, qw, scales, n), m == 1024,
                       linear_cost(m, k, n, 1, x_bytes=1, extra=4 * m), "int8", equal=True)
        del qw
        prefill = (k, n) in W8A8_SHAPES  # the lm_head sees the last token only
        for group in (None, INT4_GROUP):
            int4_linear_cases(k, n, group, (1, 8), (1024,) if prefill else (),
                              W8A8_ROWS if prefill else (), INT4_GROUP)
    for k, n, group in INT4_ODD:
        int4_linear_cases(k, n, group, (3,), (200,), (37,), "none")
    k, n = GEMM_ODD  # int8 per-channel off the tile in K, N and the rows' alignment, with bias
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    data, scales = pack_weights(qw).data, scales_for(k, n, None)
    bias = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
    for m in GEMM_ROWS:
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        record("w8a16_gemm", f"m={m} K={k} N={n} +bias", lambda: w8a16_gemm(x, data, scales, n, bias),
               lambda: w8a16_matmul_ref(x, qw, scales, bias), False, linear_cost(m, k, n, 1))
    del qw, data

    # the MLP of one llama2-7b layer: gate|up [4096, 22016], down [11008, 4096]
    kh, inter = 4096, 11008
    gamma = 1.0 + 0.1 * torch.randn(kh, generator=gen, device=dev)
    for bits, kernel in ((8, fused_mlp_gemv), (4, fused_mlp_gemv_i4)):
        lo, hi = (-127, 128) if bits == 8 else (-8, 8)
        for k, i, n, ms in ((kh, inter, kh, (1, 4, 8)),) + (((1000, 256, 300, (3,)),)
                                                          if bits == 4 else ()):
            gu = torch.randint(lo, hi, (k, 2 * i), generator=gen, device=dev, dtype=torch.int8)
            dn = torch.randint(lo, hi, (i, n), generator=gen, device=dev, dtype=torch.int8)
            gu_d, dn_d = pack_weights(gu, bits=bits).data, pack_weights(dn, bits=bits).data
            gu_s, dn_s = scales_for(k, 2 * i, None), scales_for(i, n, None)
            gam = gamma if k == kh else 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
            for m in ms:
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                res = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
                cost = (bits / 8 * (k * 2 * i + i * n) + 4 * (2 * i + n + k)
                        + 2 * m * (k + 2 * n), 2.0 * m * (k * 2 * i + i * n))
                record(kernel.__name__, f"m={m} K={k} I={i} N={n} +residual",
                       lambda: kernel(x, gam, 1e-5, gu_d, gu_s, dn_d, dn_s, n, res),
                       lambda: fused_mlp_ref(x, gam, gu, gu_s, dn, dn_s, 1e-5, residual=res),
                       m == 1 and k == kh, cost)
            del gu, dn, gu_d, dn_d

    def sdpa(q, k, v, mask=None):
        """[B, S, H, D] in and out, as the kernels take them."""
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=mask is None).transpose(1, 2)

    for b, sq, skv, hq, hkv, d in ATTENTION_CASES:
        q = torch.randn(b, sq, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(b, skv, 2 * hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]  # strided views, as the model passes them
        # causal, the last query on the last key: row i sees i + 1 + skv - sq
        # keys; 2 D operations a score, twice (q.k and p.v)
        scores = sq * (skv - sq) + sq * (sq + 1) / 2
        cost = (b * (sq * 2 * hq + skv * 2 * hkv) * d * 2, 4.0 * b * hq * d * scores)
        main = (b, sq, skv, hq, hkv, d) == ATTENTION_CASES[0]
        # torch's is_causal aligns the first query with the first key: the
        # library call is timed where the two agree (sq == skv, no GQA)
        record("flash_attention_fwd", f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} D={d}",
               lambda: flash_attention(q, k, v), lambda: flash_attention_ref(q, k, v),
               main, cost, library=(lambda: sdpa(q, k, v)) if hq == hkv and sq == skv else None)

    for b in (1, 4):
        for hq, hkv in ((32, 32), (32, 8)):
            q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
            kc = torch.randn(b, hkv, 1152, 128, generator=gen, device=dev).to(torch.bfloat16)
            vc = torch.randn(b, hkv, 1152, 128, generator=gen, device=dev).to(torch.bfloat16)
            lens = [1074, 1, 640, 1152][:b]
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            # the same function as one masked attention call over the whole cache
            mask = (torch.arange(1152, device=dev)[None] < lengths[:, None])[:, None, None]
            record("flash_decode", f"B={b} L=1152 Hq={hq} Hkv={hkv} D=128",
                   lambda: flash_decode(q, kc, vc, lengths),
                   lambda: flash_decode_ref(q, kc, vc, lengths), b == 1 and hq == hkv,
                   decode_cost(lens, hq, hkv, 2, 0),
                   library=(lambda: sdpa(q, kc.transpose(1, 2), vc.transpose(1, 2), mask))
                   if hq == hkv else None)

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
                regime = DECODE_REGIMES.get((b, l)) if hq == hkv else None
                record("flash_decode_int8", f"B={b} L={l} Hq={hq} Hkv={hkv} D=128",
                       lambda: flash_decode_int8(q, kc, vc, ks, vs, lengths),
                       lambda: flash_decode_int8_ref(q, kc, vc, ks, vs, lengths),
                       regime is not None, decode_cost(lens, hq, hkv, 1, 4), regime=regime)

    # Paged decode at the engines' shapes: 8 rows of very different lengths
    # over pools of 256-token blocks behind a permuted table. The kernel gets
    # a table whose entries past each row's last live block are far out of
    # the pool: it must never read them. Each case is also held against the
    # dense kernel on the cache gathered through the table (the same keys in
    # the same chunks and tiles, merged in the same order: bit-equal), and
    # timed beside it.
    bs, max_blocks, nblocks = PAGED_BLOCK_SIZE, 2048 // PAGED_BLOCK_SIZE, PAGED_POOL_BLOCKS
    lens = list(PAGED_LENGTHS)
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for int8 in (False, True):
        for hq, hkv in ((32, 32), (32, 8)):
            table = torch.randperm(nblocks, generator=gen, device=dev)[:b * max_blocks].reshape(
                b, max_blocks).to(torch.int32).contiguous()
            live = torch.arange(max_blocks, device=dev)[None] * bs < lengths[:, None]
            wild = torch.where(live, table, torch.full_like(table, 10 ** 6 + 12345))
            q = torch.randn(b, 1, hq, 128, generator=gen, device=dev).to(torch.bfloat16)
            pools = [torch.randn(nblocks, hkv, bs, 128, generator=gen, device=dev)
                     for _ in range(2)]
            case = f"B={b} BS={bs} NB={nblocks} Hq={hq} Hkv={hkv} D=128 permuted table"
            if int8:
                (kp_, ksc), (vp_, vsc) = (quantize_activations(t) for t in pools)
                dense = [gather_pool(t, table) for t in (kp_, vp_, ksc, vsc)]
                dense_ms = time_ms(lambda: flash_decode_int8(q, *dense, lengths), flush=flush)
                out = record(
                    "paged_flash_decode_int8", case,
                    lambda: paged_flash_decode_int8(q, kp_, vp_, ksc, vsc, wild, lengths),
                    lambda: paged_flash_decode_int8_ref(q, kp_, vp_, ksc, vsc, table, lengths),
                    hq != hkv, decode_cost(lens, hq, hkv, 1, 4), dense_ms=dense_ms)
                twin = flash_decode_int8(q, *dense, lengths)
            else:
                kp_, vp_ = (t.to(torch.bfloat16) for t in pools)
                dense = [gather_pool(t, table) for t in (kp_, vp_)]
                dense_ms = time_ms(lambda: flash_decode(q, *dense, lengths), flush=flush)
                out = record(
                    "paged_flash_decode", case,
                    lambda: paged_flash_decode(q, kp_, vp_, wild, lengths),
                    lambda: paged_flash_decode_ref(q, kp_, vp_, table, lengths),
                    hq == hkv, decode_cost(lens, hq, hkv, 2, 0), dense_ms=dense_ms)
                twin = flash_decode(q, *dense, lengths)
            err, _ = compare(out, twin)
            equal = bool(torch.equal(out, twin))
            rows[-1].update(dense_kernel_err=err, dense_kernel_equal=equal)
            print(f"  {'':20s} against the dense kernel on the gathered cache: "
                  f"{'bit-equal' if equal else 'DIFFERS'} (err {err:.3e}), "
                  f"dense kernel {dense_ms:.4f} ms")
            check(equal, f"paged decode differs from the dense kernel: {case}")
            del pools, dense, kp_, vp_

    # Mixtral's banks, int8 and int4, per-channel and with 128-row scale
    # groups. The path's time: the gather of a b=1 decode step (gate|up and
    # down), and the grouped GEMMs of a 1024-token prompt and of an 8-slot
    # engine step, per-channel for the int8 kernels (the W8A16 model) and
    # group-wise for the int4 ones (the W4A16 g=128 model). Only the experts
    # that are picked are read, each once, and only the rows of real blocks
    # are read and multiplied.
    for bits, group in ((8, None), (8, INT4_GROUP), (4, None), (4, INT4_GROUP)):
        gemv, gemm = ((w8a16_expert_gemv, w8a16_grouped_gemm) if bits == 8
                      else (w4a16_expert_gemv, w4a16_grouped_gemm))
        on_path = group is None if bits == 8 else group == INT4_GROUP
        lo, hi = (-127, 128) if bits == 8 else (-8, 8)
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'}"
        for j, (k, n) in enumerate(MIXTRAL_BANKS):
            bank = torch.randint(lo, hi, (8, k, n), generator=gen, device=dev, dtype=torch.int8)
            data = pack_weights(bank, bits=bits).data
            srows = 1 if group is None else k // group
            scales = torch.rand((8, n) if group is None else (8, srows, n), generator=gen,
                                device=dev) * 2e-3 + 1e-4
            expert_bytes = k * n * bits / 8 + 4 * srows * n
            for *ms, ids in GATHER_CASES:
                m = ms[j]
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                eids = torch.tensor(ids, dtype=torch.int32, device=dev)
                rep = " repeated id" if len(set(ids)) < len(ids) else ""
                cost = (len(set(ids)) * expert_bytes + m * k * 2 + len(ids) * (m * n * 2 + 4),
                        2.0 * m * k * n * len(ids))
                record(gemv.__name__, f"{tag} n_sel={len(ids)} m={m} K={k} N={n}{rep}",
                       lambda: gemv(x, data, scales, eids, n),
                       lambda: expert_matmul_ref(x, bank, scales, eids),
                       on_path and len(ids) == 2, cost)
            for bm, nb, real, regime in GROUPED_CASES:
                be = real + (7,) * (nb - len(real))
                x = torch.randn(nb * bm, k, generator=gen, device=dev).to(torch.bfloat16)
                x[len(real) * bm:] = 0  # padding blocks hold zero rows
                blocks = torch.tensor(be, dtype=torch.int32, device=dev)
                count = torch.tensor([len(real)], dtype=torch.int32, device=dev)
                real_rows = len(real) * bm
                cost = (len(set(real)) * expert_bytes + real_rows * k * 2 + nb * bm * n * 2
                        + 4 * (nb + 1), 2.0 * real_rows * k * n)
                record(gemm.__name__,
                       f"{tag} bm={bm} nb={nb} ({nb - len(real)} padding) K={k} N={n}",
                       lambda: gemm(x, data, scales, blocks, n, count),
                       lambda: grouped_matmul_ref(x, bank, scales, blocks, bm),
                       on_path and regime is not None, cost, regime=regime)
            del bank, data
    # the bank kernels off the tile: K and N that need padding, groups of 64
    for bits, (k, n, group) in ((4, INT4_ODD[0]), (4, INT4_ODD[1]), (8, INT4_ODD[1])):
        gemv, gemm = ((w8a16_expert_gemv, w8a16_grouped_gemm) if bits == 8
                      else (w4a16_expert_gemv, w4a16_grouped_gemm))
        lo, hi = (-127, 128) if bits == 8 else (-8, 8)
        bank = torch.randint(lo, hi, (3, k, n), generator=gen, device=dev, dtype=torch.int8)
        data = pack_weights(bank, bits=bits).data
        srows = 1 if group is None else k // group
        scales = torch.rand((3, n) if group is None else (3, srows, n), generator=gen,
                            device=dev) * 2e-3 + 1e-4
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'} K={k} N={n}"
        eids = torch.tensor((2, 0, 2), dtype=torch.int32, device=dev)
        x = torch.randn(3, k, generator=gen, device=dev).to(torch.bfloat16)
        cost = (2 * (k * n * bits / 8 + 4 * srows * n) + 3 * k * 2 + 3 * (3 * n * 2 + 4),
                2.0 * 3 * k * n * 3)
        record(gemv.__name__, f"{tag} n_sel=3 m=3", lambda: gemv(x, data, scales, eids, n),
               lambda: expert_matmul_ref(x, bank, scales, eids), False, cost)
        xg = torch.randn(3 * 40, k, generator=gen, device=dev).to(torch.bfloat16)
        cost = (2 * (k * n * bits / 8 + 4 * srows * n) + 120 * (k + n) * 2 + 12,
                2.0 * 120 * k * n)
        record(gemm.__name__, f"{tag} bm=40 nb=3", lambda: gemm(xg, data, scales, eids, n),
               lambda: grouped_matmul_ref(xg, bank, scales, eids, 40), False, cost)
    del flush
    torch.cuda.synchronize()
    bad = [f"{r['kernel']} {r['case']}" for r in rows if not r["ok"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")
    for name, s in summary.items():
        s["bound_by"] = "bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations"
        for regime, r in s.get("regimes", {}).items():
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
            lib = "" if r["library_ms"] is None else (
                f", library {r['library_ms']:.4f} ms (back to back {r['library_many_ms']:.4f})")
            print(f"  {name:20s} {regime}: {r['ms']:.4f} ms (back to back {r['many_ms']:.4f}), "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms"
                  f"{lib}")
    return dict(rows=rows, summary=summary)


@contextlib.contextmanager
def routing(mode: str, log: list):
    """Wrap `modules.moe.route`: "record" appends each call's (weights, ids)
    to `log`; "replay" returns the entries of `log` in order instead of
    routing, and checks at the end that every entry was used."""
    from eetq_tpu_torch.modules import moe

    route, replay = moe.route, iter(log)

    def wrapped(router, x2, top_k):
        if mode == "record":
            log.append(route(router, x2, top_k))
            return log[-1]
        topw, topi = next(replay)
        check(tuple(topi.shape) == (x2.shape[0], top_k), "replayed routing does not fit the call")
        return topw, topi

    moe.route = wrapped
    try:
        yield
    finally:
        moe.route = route
    if mode == "replay":
        check(next(replay, None) is None, "replay left routings unused")


def routing_differences(fn, kernel_log: list) -> dict:
    """Run fn() (the plain path) routing for itself; count the tokens of all
    its route calls whose top-k set differs from the kernel path's."""
    log = []
    with routing("record", log):
        fn()
    check(len(log) == len(kernel_log), "the paths made different numbers of route calls")
    diff = sum(int((a[1].sort(-1).values != b[1].sort(-1).values).any(-1).sum())
               for a, b in zip(kernel_log, log))
    total = sum(a[1].shape[0] for a in kernel_log)
    return dict(differ=diff, routings=total)


def counted(path: str, fn):
    """Run fn() with every launch counter at 0; return (its result, the
    counts). Fails if a kernel of the path did not launch, or if one it
    must not run did."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  launches on the {path} path: {counts}")
    idle = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    check(not idle, f"kernels not launched on the {path} path: {idle}")
    busy = [k for k in PATH_IDLE[path] if counts[k]]
    check(not busy, f"kernels launched on the {path} path that must not be: {busy}")
    return out, counts


def moe_layer_phase(dev) -> dict:
    """`moe_apply` on one full-width Mixtral layer (random banks quantized to
    int8 per channel, then to int4 with INT4_GROUP-row groups), kernel
    regimes against the plain masked scan on the same input, at 2, 8 and 2048
    selections (gather, gather, grouped). Both sides route on identical
    input, so their ids must agree. The kernel calls run under
    torch.cuda.set_sync_debug_mode("error"): a host sync fails."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.modules.linear import DenseLinear
    from eetq_tpu_torch.modules.moe import MoEMLP, quantize_moe

    cfg = PRESETS[MIXTRAL]
    h, inter, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, device=dev) * shape[-2] ** -0.5
        return DenseLinear(w.to(torch.bfloat16))

    bf16 = MoEMLP(dense(h, e), dense(e, h, 2 * inter), dense(e, inter, h))
    out = {}
    for bits, group in ((8, None), (4, INT4_GROUP)):
        moe = quantize_moe(bf16, bits=bits, group_size=group)
        tag = f"int{bits} {'per-channel' if group is None else f'g={group}'}"
        out[tag] = _moe_layer_cases(moe, cfg, gen, dev, tag)
        del moe
    return out


def _moe_layer_cases(moe, cfg, gen, dev, tag: str) -> dict:
    import torch

    from eetq_tpu_torch.modules.moe import moe_apply

    h, out = cfg.hidden_size, {}
    for t in MOE_TOKENS:
        x = torch.randn(1, t, h, generator=gen, device=dev).to(torch.bfloat16)
        ys, logs = {}, {True: [], False: []}
        for use in (True, False):
            torch.cuda.synchronize()
            with routing("record", logs[use]):
                if use:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    ys[use] = moe_apply(moe, x, cfg.num_experts_per_tok, use_kernel=use)
                except RuntimeError as err:
                    raise CheckFailed(f"moe_apply ({tag}) at {t} tokens: {err}") from err
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        check(torch.equal(logs[True][0][1], logs[False][0][1]),
              f"moe_apply at {t} tokens: the two paths routed differently")
        err, ref_max = compare(ys[True], ys[False])
        n_sel = t * cfg.num_experts_per_tok
        print(f"  moe_apply {tag} {n_sel:5d} selections: err {err:.3e} "
              f"(tol {TOL * ref_max:.3e}), same routing, no host sync")
        check(err <= TOL * ref_max, f"moe_apply at {n_sel} selections differs from the plain path")
        out[n_sel] = dict(max_abs_err=err, ref_absmax=ref_max, tol=TOL * ref_max)
    return out


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


def graph_against_eager(params, cfg, dev, prompt, n: int, kv, fused) -> dict:
    """decode_loop (one step captured, replayed n - 2 times) against a Python
    loop of eager decode_step on a copy of the same prefilled caches: the
    greedy tokens must be bit-equal, and the launches of the whole loop those
    of n - 1 eager steps (the warm-up step and the replays; the capture adds
    none)."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.modules.attention import KVCache
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step, prefill

    p = prompt.shape[1]
    caches = init_caches(cfg, prompt.shape[0], p + n, device=dev, dtype=kv)
    lp, caches = prefill(params, cfg, prompt, caches)
    first = torch.argmax(lp, -1)
    twin = [KVCache(*(None if t is None else t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)))
            for c in caches]
    tok, eager = first, [first]
    for i in range(n - 1):
        reset_launch_counts()
        logits, _ = decode_step(params, cfg, tok[:, None], p + i, twin, fused_mlp=fused)
        if i == 0:
            one_step = launch_counts()
        tok = torch.argmax(logits, -1)
        eager.append(tok)
    del twin
    reset_launch_counts()
    toks, caches = decode_loop(params, cfg, first, p, caches, n, fused_mlp=fused)
    counts = launch_counts()
    equal = bool(torch.equal(toks, torch.stack(eager, dim=1)))
    first_diff = None if equal else int((toks != torch.stack(eager, dim=1)).any(0).nonzero()[0])
    check(equal, f"the replayed decode_loop's tokens differ from eager decode_step's from "
                 f"token {first_diff}")
    want = {k: (n - 1) * v for k, v in one_step.items()}
    check(counts == want, f"launches of the replayed decode_loop {counts}, want (n - 1) x one "
                          f"eager step's {want}")
    launches = sum(one_step.values())
    print(f"  decode_loop replayed: {n} greedy tokens bit-equal to eager decode_step's; "
          f"{launches} kernel-wrapper launches a step, replayed and eager alike")
    return dict(tokens=n, equal=equal, wrapper_launches_per_step=launches)


def generate_paths(params, cfg, dev, gen, configs: dict) -> dict:
    """Each path of `configs` ({path: (KV dtype, fused MLP)}), e.g. the
    generate path (bf16 KV, unfused MLP) and bench.py's decode
    configuration (int8 KV, fused MLP), checked against the plain path and
    driven through the same requests, and timed side by side."""
    import torch

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.modules.linear import QuantLinear
    from eetq_tpu_torch.serve.generate import decode_loop, decode_step, generate, prefill

    prompts = [torch.randint(0, cfg.vocab_size, (b, p), generator=gen, device=dev)
               for b, p, _ in REQUESTS]
    (_, p1, n1), prompt1 = REQUESTS[0], prompts[0]
    out = {}
    for path, (kv, fused) in configs.items():
        print(f"  -- {path}: {kv} KV, fused MLP {fused}")
        # kernel path against the plain path: prefill, then one decode step
        # (the decode step takes the kernel path's token); the plain path
        # replays the kernel path's routing
        logits, first, routes, step_counts = {}, {}, [], {}

        def check_run(use, kv=kv, fused=fused):
            caches = init_caches(cfg, 1, p1 + n1, device=dev, dtype=kv)
            lp, caches = prefill(params, cfg, prompt1, caches, use_kernels=use)
            tok = first.get(True, torch.argmax(lp, -1))
            reset_launch_counts()
            ld, _ = decode_step(params, cfg, tok[:, None], p1, caches, use_kernels=use,
                                fused_mlp=fused)
            if use:
                step_counts.update(launch_counts())
            return (lp, ld), torch.argmax(lp, -1)

        for use in (True, False):
            with routing("record" if use else "replay", routes):
                logits[use], first[use] = check_run(use)
        checks = {name: check_logits(f"{path} {name}", logits[True][i], logits[False][i])
                  for i, name in enumerate(("prefill", "decode"))}
        # GEMV launches of one b=1 decode step, as before the tensor-core GEMV:
        # qkv and o per layer, the MLP's two projections (the fused MLP or a MoE
        # layer's expert gathers: one wrapper call each), and the lm_head
        gemv_step = sum(step_counts[k] for k in GEMV_FAMILY)
        want = (cfg.num_layers * (2 + (1 if fused and not cfg.num_experts else 2))
                + isinstance(params.lm_head, QuantLinear))
        print(f"  {path}: {gemv_step} GEMV launches in one decode step (want {want})")
        check(gemv_step == want, f"{path}: {gemv_step} GEMV launches a decode step, want {want}")
        checks["gemv_launches_per_step"] = gemv_step
        checks["graph"] = graph_against_eager(params, cfg, dev, prompt1, n1, kv, fused)
        if routes:
            checks["routing"] = routing_differences(lambda: check_run(False), routes)
            print(f"  {path}: {checks['routing']['differ']} of {checks['routing']['routings']} "
                  "routings differ when the plain path routes for itself (not replayed)")

        def serve(kv=kv, fused=fused):
            outs, ms = [], []
            for (b, p, n), prompt in zip(REQUESTS, prompts):
                t0 = time.perf_counter()
                caches = init_caches(cfg, b, p + n, device=dev, dtype=kv)
                lp, caches = prefill(params, cfg, prompt, caches)
                toks, caches = decode_loop(params, cfg, torch.argmax(lp, -1), p, caches, n,
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
        if path in ("generate", "int4_generate"):  # the entry point itself, once
            g = generate(params, cfg, prompt1, 2)
            check(bool((g[:, 0] == outs[0][:, 0]).all()), "generate disagrees with prefill")
        out[path] = dict(checks=checks, counts=counts, generate_ms=gen_ms)

    # the two stages of the first request, timed apart, the paths in turns;
    # decode_loop's own graph records say what its eager warm-up step and its
    # capture took, and the rest is n1 - 2 replays
    runs = {path: dict(prefill_ms=[], decode_ms=[], replay_ms=[], warm_ms=[], capture_ms=[])
            for path in configs}
    for _ in range(3):
        for path, (kv, fused) in configs.items():
            caches = init_caches(cfg, 1, p1 + n1, device=dev, dtype=kv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lp, caches = prefill(params, cfg, prompt1, caches)
            tok = torch.argmax(lp, -1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec = {}
            decode_loop(params, cfg, tok, p1, caches, n1, fused_mlp=fused, stats=rec)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            r = runs[path]
            r["prefill_ms"].append(1e3 * (t1 - t0))
            r["decode_ms"].append(1e3 * (t2 - t1) / (n1 - 1))
            r["warm_ms"].append(rec["warm_ms"])
            r["capture_ms"].append(rec["capture_ms"])
            r["replay_ms"].append((1e3 * (t2 - t1) - rec["warm_ms"] - rec["capture_ms"])
                                  / (n1 - 2))
            del caches
    for path, r in runs.items():
        med = {key: statistics.median(v) for key, v in r.items()}
        out[path]["timing"] = dict(
            prefill_ms=med["prefill_ms"], decode_ms_per_step=med["decode_ms"],
            decode_tok_s=1e3 / med["decode_ms"], replay_ms_per_step=med["replay_ms"],
            warm_ms=med["warm_ms"], capture_ms=med["capture_ms"], prefill_ms_runs=r["prefill_ms"],
            decode_ms_per_step_runs=r["decode_ms"], replay_ms_per_step_runs=r["replay_ms"])
        print(f"  {path} b=1 p={p1}: prefill {med['prefill_ms']:.2f} ms, decode "
              f"{med['decode_ms']:.3f} ms/step = {1e3 / med['decode_ms']:.2f} tok/s over "
              f"{n1 - 1} steps (runs {['%.3f' % v for v in r['decode_ms']]}); of it the eager "
              f"warm-up step {med['warm_ms']:.2f} ms, the capture {med['capture_ms']:.2f} ms, "
              f"then {med['replay_ms']:.3f} ms a replayed step")
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


def engine_step_check(eng, cfg, dev, gen, path: str) -> dict:
    """Fill the engine's slots with prompts of STEP_PROMPTS' lengths, then
    run the forward of its next decode step twice on the same caches, with
    the kernels and with the plain versions (the step's writes are the same
    both times), and hold the logits of the busy slots against each other.
    The requests are then run to their end."""
    import numpy as np
    import torch

    from eetq_tpu_torch.models.transformer import forward_inner

    for n in STEP_PROMPTS[:eng.max_batch]:
        ids = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev).tolist()
        eng.add_request(ids, max_new_tokens=STEP_BUDGET)
    # one admission each, with a window-1 step while the queue holds more and
    # a chain of windows after the last (shorter than every budget)
    while eng.queue:
        eng.step()
    active = [i for i, r in enumerate(eng.slot_req) if r is not None]
    check(len(active) == eng.max_batch, f"{path}: {len(active)} slots busy before the step check")
    if eng.paged:  # as Engine._decode does before its forward
        for i in active:
            eng._alloc_blocks(i, int(eng.lengths[i]) + 1)
        eng._sync_tables()
    lengths = torch.as_tensor(np.maximum(eng.lengths, 1), device=dev)
    tokens = torch.as_tensor(eng.next_token[:, None], device=dev)
    logits, routes = {}, []
    for use in (True, False):  # the plain path replays the kernel path's routing
        with routing("record" if use else "replay", routes), torch.inference_mode():
            lg, _ = forward_inner(eng.params, cfg, tokens, lengths[:, None], eng.caches, lengths,
                                  use_kernels=use)
        logits[use] = lg[:, -1]
    out = check_logits(f"{path} engine step ({len(active)} slots, lengths "
                       f"{sorted(int(v) for v in eng.lengths)})", logits[True], logits[False])
    eng.run()
    return out


def server_path(params, cfg, dev, gen, path: str = "server", engine_kw: dict | None = None,
                twin_kw: dict | None = None) -> dict:
    """The engine behind its HTTP server: with its accelerator defaults
    (window 8, chained), or with `engine_kw` (a paged pool). twin_kw: the
    greedy requests also go through an engine built with these keywords
    instead (window 1; a dense bf16 cache for a paged engine), whose tokens
    must be equal."""
    import torch

    from eetq_tpu_torch.models.transformer import forward_inner, init_caches
    from eetq_tpu_torch.serve.api import EngineServer
    from eetq_tpu_torch.serve.engine import Engine

    engine_kw = dict(engine_kw or {})
    paged = "paged_blocks" in engine_kw
    held = torch.cuda.memory_allocated()
    eng = Engine(params, cfg, max_batch=8, max_len=2048, **engine_kw)
    cache_gb = (torch.cuda.memory_allocated() - held) / 1e9
    # the CUDA defaults: W8A8 prefill; an int8 dense cache, a bf16 pool
    want_kv = engine_kw.get("kv_dtype", torch.bfloat16 if paged else torch.int8)
    check(eng.a8_prefill and eng.kv_dtype == want_kv and eng.paged == paged
          and eng.decode_window == 8 and eng.max_chain == 8,
          f"{path} engine on CUDA: a8_prefill {eng.a8_prefill}, kv {eng.kv_dtype}, "
          f"paged {eng.paged}, window {eng.decode_window}, chain {eng.max_chain}")
    shape = (f"a pool of {engine_kw['paged_blocks']} blocks of {eng.paged_bs}" if paged
             else "dense 8 x 2048")
    print(f"  {path}: KV cache of the engine {cache_gb:.2f} GB ({eng.kv_dtype}, {shape})")
    # the traffic below has sampled requests: warm the sampled programs too
    t0 = time.perf_counter()
    eng.warmup()
    eng.warmup(temperature=0.8)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    captures = [dict(window=w, sampled=smp, warm_ms=g.warm_ms, capture_ms=g.capture_ms)
                for (w, smp), (g, _) in eng._programs.items()]
    check(all(g.captured for g, _ in eng._programs.values())
          and set(eng._programs) == {(1, False), (8, False), (1, True), (8, True)},
          f"{path}: warmup() left programs uncaptured: {sorted(eng._programs)}")
    print(f"  {path}: warmup {warmup_s:.1f} s; captures of the greedy and sampled window-1 and "
          f"window-8 programs {['%.1f ms' % c['capture_ms'] for c in captures]}")

    # one admission's forward, with kernels and with the plain versions: a
    # prompt right-padded to its bucket, as _prefill_group runs it
    n = ADMISSION_PROMPT
    bucket = eng._bucket_for(n)
    toks = torch.zeros(1, bucket, dtype=torch.long, device=dev)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=dev)
    pos = torch.arange(bucket, device=dev)[None]
    last = torch.tensor([n - 1], device=dev)
    logits, routes = {}, []

    def admit(use):
        with torch.inference_mode():
            scratch = init_caches(cfg, 1, bucket, dev, eng.kv_dtype)
            lg, _ = forward_inner(params, cfg, toks, pos, scratch, 0, use_kernels=use, a8=True,
                                  last_pos=last)
        return lg[:, -1]

    for use in (True, False):  # the plain path replays the kernel path's routing
        with routing("record" if use else "replay", routes):
            logits[use] = admit(use)
    admission = check_logits(f"{path} admission (a8)", logits[True], logits[False],
                             A8_MODEL_TOL)
    if routes:
        admission["routing"] = routing_differences(lambda: admit(False), routes)
        print(f"  {path} admission: {admission['routing']['differ']} of "
              f"{admission['routing']['routings']} routings differ when not replayed")
    step = engine_step_check(eng, cfg, dev, gen, path) if paged else None

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
        wall_s, counts = counted(path, serve)
    finally:
        srv.shutdown()
    check(not errors, f"HTTP requests failed: {errors}")
    check(len(results) == SERVE_REQUESTS, f"{len(results)} of {SERVE_REQUESTS} requests answered")
    for i, body in enumerate(bodies):
        got = results[i]
        check(len(got) == body["max_new_tokens"],
              f"request {i}: {len(got)} tokens, want {body['max_new_tokens']}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"request {i}: token out of range")
    if paged:
        kernel = "paged_flash_decode_int8" if eng.caches[0].quantized else "paged_flash_decode"
        check(counts[kernel] % cfg.num_layers == 0,
              f"{path}: {counts[kernel]} launches of {kernel} are not {cfg.num_layers} a step")
        print(f"  {path}: {counts[kernel] // cfg.num_layers} decode steps, {cfg.num_layers} "
              f"launches of {kernel} each")
        check(sorted(eng._free_blocks) == list(range(1, engine_kw["paged_blocks"]))
              and not any(eng._slot_blocks) and not eng._table_np.any(),
              f"{path}: blocks still held after the run: {eng._slot_blocks}")
    twin = None
    if twin_kw is not None:
        # the same kernels, the same chunks of the key range, rows that do not
        # see each other: the same greedy tokens at any window and chain, and
        # through the paged address map or the dense one
        greedy = [i for i, body in enumerate(bodies) if "temperature" not in body]
        held = torch.cuda.memory_allocated()
        te = Engine(params, cfg, max_batch=8, max_len=2048, **twin_kw)
        twin_gb = (torch.cuda.memory_allocated() - held) / 1e9
        uids = {i: te.add_request(bodies[i]["prompt"], bodies[i]["max_new_tokens"])
                for i in greedy}
        te.run()
        for i in greedy:
            want = te.result(uids[i])
            first = next((j for j, (a, b) in enumerate(zip(results[i], want)) if a != b), None)
            if first is not None:
                print(f"  {path} request {i} (prompt {lengths[i]}): token {first} is "
                      f"{results[i][first]}, the twin's {want[first]}")
            check(results[i] == want, f"{path}: request {i} differs from the twin engine "
                                      f"{twin_kw}")
        twin = dict(requests=len(greedy), equal=True, cache_gb=twin_gb, engine=str(twin_kw))
        print(f"  {path}: {len(greedy)} greedy requests equal the tokens of a twin engine "
              f"{twin_kw} (its cache: {twin_gb:.2f} GB)")
        del te
    tokens = sum(budgets)
    lat = [latency[i] for i in range(SERVE_REQUESTS)]
    print(f"  {path}: {SERVE_REQUESTS} requests, prompts {lengths}, budgets {budgets}; "
          f"{tokens} tokens in {wall_s:.2f} s = {tokens / wall_s:.2f} tok/s served "
          f"(warmup {warmup_s:.1f} s)")
    print(f"  {path} latencies (ms): {['%.1f' % v for v in lat]}")
    return dict(admission=admission, counts=counts, prompt_lengths=lengths, budgets=budgets,
                tokens=tokens, wall_s=wall_s, served_tok_s=tokens / wall_s,
                latency_ms=lat, warmup_s=warmup_s, captures=captures, cache_gb=cache_gb,
                engine_step=step, twin=twin)


PROFILE_ENGINE_BUDGET = 200  # two chains of 8 x 8 after the admissions


def _device_events(prof) -> tuple[float, int, int, int]:
    """(device-busy ms, kernel launches, flash-decode launches, host launch
    calls) of a torch.profiler run: the sum and the count of its kernel
    events (copies and memsets are busy time but no launches of a kernel),
    the count of those of `csrc/flash_decode.cu`, and the host's calls that
    launch a kernel or a graph (a graph replay is one call for all of its
    kernels)."""
    import torch

    busy_us, launches, decode, host = 0.0, 0, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host += "Launch" in ev.name and ev.name.startswith(("cuda", "cu"))
            continue
        busy_us += ev.time_range.elapsed_us()
        launches += not ev.name.startswith(("Memcpy", "Memset"))
        decode += "flash_decode" in ev.name
    return busy_us / 1e3, launches, decode, host


def _profiled(fn, steps: int | None, layers: int = 0) -> dict:
    """fn() under torch.profiler, per decode step: `steps` of them, or with
    steps None the flash-decode calls over `layers` (one call a layer a
    step). `decode_calls_per_step` counts the flash-decode wrappers' calls
    (their launch counters, exact: a replay adds its capture's counts), and
    `decode_launches_per_step` its kernel events (the profiler may drop a few
    events of a run, and never adds one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from eetq_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    calls = sum(launch_counts()[k] for k in DECODE_FAMILY)
    if steps is None:
        check(calls > 0 and calls % layers == 0, f"{calls} flash-decode calls over {layers} layers")
        steps = calls // layers
    busy_ms, launches, decode, host = _device_events(prof)
    check(busy_ms > 0, "the profiler saw no device time")
    return dict(steps=steps, wall_ms_per_step=wall_ms / steps, busy_ms_per_step=busy_ms / steps,
                launches_per_step=launches / steps, decode_launches_per_step=decode / steps,
                decode_calls_per_step=calls / steps, host_launch_calls_per_step=host / steps,
                idle_share=1 - busy_ms / wall_ms)


def profile_paths(params, cfg, dev, gen, configs: dict, engines: dict) -> dict:
    """`--profile`: each path's first request under torch.profiler: one
    prefill, then its whole decode_loop (the eager warm-up step, the capture
    and the replays); and for each engine of `engines` ({path: Engine
    keywords}), after warmup() and the admissions, one scheduler step of the
    steady state with all 8 slots decoding: a chain of 8 windows of 8 steps.
    Every figure is per decode step. The profiler slows the host, so the
    wall time and the idle share are those of a profiled run."""
    import torch

    from eetq_tpu_torch.models.transformer import init_caches
    from eetq_tpu_torch.serve.engine import Engine
    from eetq_tpu_torch.serve.generate import decode_loop, prefill

    _, p1, n1 = REQUESTS[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, p1), generator=gen, device=dev)
    out = {}
    for path, (kv, fused) in configs.items():
        state = {}

        def run_prefill(kv=kv):
            state["caches"] = init_caches(cfg, 1, p1 + n1, device=dev, dtype=kv)
            lp, state["caches"] = prefill(params, cfg, prompt, state["caches"])
            state["tok"] = torch.argmax(lp, -1)

        run_prefill()  # warm
        out[path] = dict(prefill=_profiled(run_prefill, 1))
        # the first request's whole decode_loop: the eager warm-up step, the
        # capture and n1 - 2 replays, per step
        out[path]["decode"] = _profiled(
            lambda: decode_loop(params, cfg, state["tok"], p1, state["caches"], n1,
                                fused_mlp=fused), n1 - 1)
        del state
    for engine_path, engine_kw in engines.items():
        eng = Engine(params, cfg, max_batch=8, max_len=2048, **engine_kw)
        eng.warmup()
        for _ in range(8):
            ids = torch.randint(0, cfg.vocab_size, (100,), generator=gen, device=dev).tolist()
            eng.add_request(ids, max_new_tokens=PROFILE_ENGINE_BUDGET)
        while eng.queue:  # admissions (window 1), then a chain of 8 windows
            eng.step()
        # one scheduler step of the steady state: a chain of 8 windows of 8,
        # per decode step (the flash-decode's calls count them)
        out[engine_path] = dict(engine_step=_profiled(eng.step, None, cfg.num_layers))
        del eng
    for path, stages in out.items():
        for stage, r in stages.items():
            print(f"  profile {path} {stage}: device busy {r['busy_ms_per_step']:.3f} ms, "
                  f"{r['launches_per_step']:.1f} kernel events ({r['decode_launches_per_step']:.1f} "
                  f"of the flash-decode) from {r['host_launch_calls_per_step']:.1f} host launch "
                  f"calls, wall {r['wall_ms_per_step']:.2f} ms, idle share "
                  f"{r['idle_share']:.3f} (per step, {r['steps']} profiled)")
            # a decode step attends once a layer (the wrappers' counters), in
            # one launch a call (the profiler's flash-decode kernel events are
            # no more than the calls; it may drop an event, never add one)
            want = 0 if stage == "prefill" else cfg.num_layers
            seen = r["decode_launches_per_step"]
            check(r["decode_calls_per_step"] == want,
                  f"profile {path} {stage}: {r['decode_calls_per_step']} flash-decode calls "
                  f"a step, want {want} (one a layer)")
            check(seen <= want and (seen > 0) == (want > 0),
                  f"profile {path} {stage}: {seen} flash-decode launches a step for {want} "
                  "calls (one launch a call)")
    return out


def model_phase(dev, profile: bool = False) -> dict:
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
    configs = {"generate": (torch.bfloat16, False), "bench_decode": (torch.int8, True)}
    paths = generate_paths(params, cfg, dev, gen, configs)
    paths["server"] = server_path(params, cfg, dev, gen, twin_kw=dict(decode_window=1))
    paged = dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE)
    paths["paged_server"] = server_path(params, cfg, dev, gen, "paged_server", paged,
                                        twin_kw=dict(kv_dtype=torch.bfloat16, decode_window=1))
    prof = profile_paths(params, cfg, dev, gen, configs,
                         {"server": {}, "paged_server": paged}) if profile else None
    return dict(paths=paths, init_s=init_s, weight_gb=weight_gb, profile=prof,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def int4_phase(dev, profile: bool = False) -> dict:
    """MODEL at full width and depth with int4 weights, two models built
    one layer at a time: group-wise (INT4_GROUP rows, the lm_head too)
    through generate and the server, and `EETQ_BENCH_BITS=4 bench.py`'s
    (per-channel layers under an int8 lm_head) through its decode
    configuration."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params
    from eetq_tpu_torch.modules.linear import quantize_linear

    cfg = PRESETS[MODEL]
    out = dict(paths={}, models={}, profile={})

    def built(name, make):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = make(gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gb = sum(b.numel() * b.element_size() for b in params.buffers()) / 1e9
        print(f"  {MODEL} {name} built layer by layer in {build_s:.1f} s, {gb:.2f} GB on the card")
        out["models"][name] = dict(build_s=build_s, weight_gb=gb)
        return params, gen

    params, gen = built(f"W4A16 g={INT4_GROUP}", lambda g: random_quantized_params(
        cfg, g, quantize_lm_head=True, bits=4, group_size=INT4_GROUP))
    check(params.lm_head.bits == 4 and params.layers[0].down.scales.dim() == 2,
          "the group-wise int4 model is not int4 group-wise throughout")
    configs = {"int4_generate": (torch.bfloat16, False)}
    out["paths"].update(generate_paths(params, cfg, dev, gen, configs))
    out["paths"]["int4_server"] = server_path(params, cfg, dev, gen, "int4_server")
    if profile:
        out["profile"].update(profile_paths(params, cfg, dev, gen, configs, {"int4_server": {}}))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    def bench_model(g):
        p = random_quantized_params(cfg, g, bits=4)  # the lm_head comes out dense
        p.lm_head = quantize_linear(p.lm_head.weight)  # and is quantized at 8 bits
        return p

    params, gen = built("W4A16 per-channel, int8 lm_head", bench_model)
    check(params.lm_head.bits == 8 and params.layers[0].down.bits == 4
          and params.layers[0].down.scales.dim() == 1, "the bench model is not int4 under int8")
    configs = {"int4_bench_decode": (torch.int8, True)}
    out["paths"].update(generate_paths(params, cfg, dev, gen, configs))
    if profile:
        out["profile"].update(profile_paths(params, cfg, dev, gen, configs, {}))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def mixtral_phase(dev, int4: bool = False, profile: bool = False) -> dict:
    """MIXTRAL at full width and depth, built one layer at a time, through
    generate and the server: W8A16 per-channel behind the default engine, or
    (int4) W4A16 with INT4_GROUP-row scale groups throughout (the expert
    banks, the attention linears and the lm_head) behind an engine with a
    paged int8 pool."""
    import torch

    from eetq_tpu_torch.models.config import PRESETS
    from eetq_tpu_torch.models.init import random_quantized_params

    cfg = PRESETS[MIXTRAL]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    if int4:
        name, gen_path, srv_path = f"W4A16 g={INT4_GROUP}", "mixtral_int4_generate", \
            "mixtral_int4_paged_server"
        params = random_quantized_params(cfg, gen, quantize_lm_head=True, bits=4,
                                         group_size=INT4_GROUP)
        bank = params.layers[0].moe.down
        check(bank.bits == 4 and bank.scales.dim() == 3 and params.lm_head.bits == 4
              and params.layers[-1].qkv.scales.dim() == 2,
              "the int4 Mixtral is not int4 group-wise throughout")
        engine_kw = dict(paged_blocks=PAGED_BLOCKS, paged_block_size=PAGED_BLOCK_SIZE,
                         kv_dtype=torch.int8)
    else:
        name, gen_path, srv_path = "W8A16", "mixtral_generate", "mixtral_server"
        params = random_quantized_params(cfg, gen, quantize_lm_head=True)
        engine_kw = {}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weight_gb = sum(b.numel() * b.element_size() for b in params.buffers()) / 1e9
    scale_gb = sum(b.numel() * b.element_size() for b in params.buffers()
                   if b.dtype == torch.float32) / 1e9
    print(f"  {MIXTRAL} {name} built layer by layer in {build_s:.1f} s: {weight_gb:.2f} GB on "
          f"the card ({scale_gb:.2f} GB of it f32 scales and norms), build peak "
          f"{build_peak_gb:.2f} GB ({before_gb:.2f} GB held before)")
    configs = {gen_path: (torch.bfloat16, False)}
    paths = generate_paths(params, cfg, dev, gen, configs)
    paths[srv_path] = server_path(params, cfg, dev, gen, srv_path, engine_kw)
    prof = profile_paths(params, cfg, dev, gen, configs, {srv_path: engine_kw}) if profile else None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = paths[gen_path]["timing"]
    print(f"  {MIXTRAL} {name}: weights {weight_gb:.2f} GB, built in {build_s:.1f} s, peak "
          f"{peak_gb:.2f} GB; prefill {t['prefill_ms']:.2f} ms (b=1 p={REQUESTS[0][1]}), decode "
          f"{t['decode_ms_per_step']:.3f} ms/step; served "
          f"{paths[srv_path]['served_tok_s']:.2f} tok/s")
    return dict(paths=paths, build_s=build_s, build_peak_gb=build_peak_gb, weight_gb=weight_gb,
                scale_gb=scale_gb, peak_gb=peak_gb, profile=prof)


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="directory for chip_smoke.json (details)")
    parser.add_argument("--profile", action="store_true",
                        help="also run the llama2-7b paths, the paged engines and the "
                             "Mixtral paths under torch.profiler")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)} (a partial run "
                             "checks what it runs and prints no result line)")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"--phases takes {PHASES}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    from eetq_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    info = _build.build()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {info['nvcc_version']}")
    print(card)
    print(f"kernels built in {info['seconds']:.1f} s (cached: {info['cached']})")
    serialized = serialized_wgmma(info["log"])
    for source, names in sorted(serialized.items()):
        print(f"ptxas C7520 (wgmma serialized) in {source}: {len(names)} kernel(s): "
              + ", ".join(sorted(set(names))))
    bad = sorted(set(serialized) & set(UNSERIALIZED_SOURCES))
    if bad:
        print(f"chip_smoke: C7520 in {bad}: their wgmma must not be serialized", file=sys.stderr)
        return 1
    mmas = gemv_tensor_core_mmas(info["path"])
    print(f"decode GEMV kernels: {len(mmas)} instances, HMMA.16816 instructions in each: "
          f"{sorted(set(mmas.values()))}")
    if not mmas or not all(mmas.values()):
        print("chip_smoke: a decode GEMV kernel without tensor-core MMAs", file=sys.stderr)
        return 1
    run = {
        "kernels": lambda: kernel_phase(dev),
        "moe_layer": lambda: moe_layer_phase(dev),
        "llama": lambda: model_phase(dev, args.profile),
        "int4": lambda: int4_phase(dev, args.profile),
        "mixtral": lambda: mixtral_phase(dev, profile=args.profile),
        "mixtral_int4": lambda: mixtral_phase(dev, int4=True, profile=args.profile),
    }
    done = {}
    for phase in PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        if phase in ("kernels", "moe_layer"):
            with torch.inference_mode():
                done[phase] = run[phase]()
        else:
            done[phase] = run[phase]()
        gc.collect()  # each model goes before the next is built
        torch.cuda.empty_cache()
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, build_s=info["seconds"], nvcc_log=info["log"],
                           serialized_wgmma=serialized, gemv_hmma=mmas,
                           kernels=done.get("kernels", {}).get("rows"),
                           kernel_summary=done.get("kernels", {}).get("summary"),
                           moe_layer=done.get("moe_layer"), model=done.get("llama"),
                           int4=done.get("int4"), mixtral=done.get("mixtral"),
                           mixtral_int4=done.get("mixtral_int4"),
                           seconds=time.perf_counter() - t_start), f, indent=1, default=str)
    if len(done) < len(PHASES):
        print(f"partial run ({','.join(done)}): every check of these phases passed")
        return 0
    paths = {}
    for phase in ("llama", "int4", "mixtral", "mixtral_int4"):
        paths.update(done[phase]["paths"])
    kern = done["kernels"]
    kernels = [
        dict(name=name, route=REPLACES[name][0], source=REPLACES[name][1],
             replaces=REPLACES[name][2],
             launches=sum(p["counts"][name] for p in paths.values()),
             **{key: kern["summary"][name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "many_ms", "library_many_ms")})
        for name in REPLACES
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
