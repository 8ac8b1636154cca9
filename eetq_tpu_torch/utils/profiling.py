"""Device timing and roofline accounting on the card.

Port of `eetq_tpu/utils/profiling.py` in the port's idiom:

- `device_time(fn, *args)`: seconds a call of fn, on the card: `iters`
  calls captured once into a CUDA graph and replayed between two CUDA
  events, the median of `reps` replays. The device never waits for the host
  inside a replay, so a kernel of a few microseconds reads its own time and
  not the wrapper's. A graph on one stream runs its launches in order, so the
  JAX version's scalar carry between iterations (`:66-97`, which forces the
  order inside one jitted loop) has no counterpart here. On a CPU device the
  caller asked for, the host clock times the calls.
- `roofline(...)`: achieved bytes/s and operations/s against the card's
  datasheet peaks (`chip_peaks`), and which of the two bounds the call.
- `profile_w8a16_matmul(m, k, n, bits)`: `ops/linear.py::w8a16_matmul` at
  one shape, timed and rooflined.
- `tp_decode_scaling` / `pp_decode_scaling`: the JAX package's paper-napkin
  models of a decode step under tensor and pipeline parallelism, on the
  card's NVLink in place of the TPU's ICI.
- `trace(path)`: a `torch.profiler` trace of the card, as a Chrome trace.
- `count_collectives(fn, *args)`: the collectives one call of fn makes on
  this rank, and their bytes. JAX walks the traced program's jaxpr; the
  port runs the call once and reads the mesh's counters
  (`dist/sharding.py`), so the model's "2 all-reduces a layer + 1 gather"
  is checked against what ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable, NamedTuple

import torch

from eetq_tpu_torch.utils.device import resolve


class Peaks(NamedTuple):
    hbm_gbs: float  # device memory, GB/s
    bf16_tflops: float  # tensor cores, dense bf16
    int8_tops: float  # tensor cores, dense int8


# Datasheet peaks by `torch.cuda.get_device_name`. NVIDIA H100 SXM data
# sheet, dense rates without sparsity at the full 700 W limit: 3.35 TB/s of
# HBM3, 989 TFLOP/s bf16, 1,979 TOP/s int8.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3350.0, 989.0, 1979.0),
}

# NVLink bandwidth each way between two cards of one host, by device name.
# NVLink 4 on the H100 SXM: 900 GB/s a card to the others, 450 GB/s each way
# (NVIDIA H100 data sheet).
NVLINK_BW_PER_DIRECTION = {
    "NVIDIA H100 80GB HBM3": 450e9,
}


def _device_name(device=None) -> str:
    device = resolve(device)
    return torch.cuda.get_device_name(device.index if device.index is not None else 0)


def chip_peaks(device=None) -> Peaks:
    """The datasheet peaks of CUDA device `device` (None: the card). A card
    this table does not hold raises and names the card: no default peaks."""
    name = _device_name(device)
    if name not in CHIP_PEAKS:
        raise KeyError(f"no datasheet peaks for {name!r}: add them to "
                       "eetq_tpu_torch/utils/profiling.py::CHIP_PEAKS")
    return CHIP_PEAKS[name]


def nvlink_bw(device=None) -> float:
    """Bytes/s each way over NVLink of CUDA device `device` (None: the
    card); a card this table does not hold raises."""
    name = _device_name(device)
    if name not in NVLINK_BW_PER_DIRECTION:
        raise KeyError(f"no NVLink rate for {name!r}: add it to "
                       "eetq_tpu_torch/utils/profiling.py::NVLINK_BW_PER_DIRECTION")
    return NVLINK_BW_PER_DIRECTION[name]


def host_sync_overhead(reps: int = 5, device=None) -> float:
    """Seconds of the host's round trip of a trivial launch plus
    `torch.cuda.synchronize()` (on a CPU device: of a trivial op), the least
    of `reps`."""
    device = resolve(device)
    x = torch.ones(8, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    (x + 1).sum()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        x + 1
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def device_time(fn: Callable, *args, iters: int = 200, reps: int = 3, flush=None,
                device=None) -> float:
    """Seconds a call of fn(*args): on a CUDA device, `iters` calls captured
    once into a CUDA graph and replayed between two CUDA events, the median
    of `reps` replays, each after reading `flush` (a tensor larger than the
    card's L2) where it is given; on a CPU device, the host clock over
    `iters` calls, the median of `reps`. fn runs once before the capture (its
    scratch sized, lazy work done) and must not synchronise with the host."""
    device = resolve(device)
    fn(*args)
    if device.type != "cuda":
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            ts.append((time.perf_counter() - t0) / iters)
        return statistics.median(ts)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()  # warm
    ts = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3 / iters)
    del graph
    return statistics.median(ts)


@dataclasses.dataclass
class RooflineReport:
    seconds: float
    bytes_moved: int
    flops: int
    achieved_gbs: float
    achieved_tflops: float
    peak_gbs: float
    peak_tflops: float
    bound: str  # "memory" | "compute"
    fraction_of_roof: float

    def __str__(self) -> str:
        return (
            f"{self.seconds*1e6:.1f} us | {self.achieved_gbs:.0f}/{self.peak_gbs:.0f} "
            f"GB/s | {self.achieved_tflops:.1f}/{self.peak_tflops:.0f} TFLOP/s | "
            f"{self.bound}-bound, {self.fraction_of_roof:.0%} of roof"
        )


def roofline(seconds: float, bytes_moved: int, flops: int, device=None) -> RooflineReport:
    """Score a measured time against the card's roofline (bf16 operations;
    the arithmetic of `eetq_tpu/utils/profiling.py::roofline`)."""
    peaks = chip_peaks(device)
    peak_gbs, peak_tflops = peaks.hbm_gbs, peaks.bf16_tflops
    achieved_gbs = bytes_moved / seconds / 1e9
    achieved_tflops = flops / seconds / 1e12
    t_mem = bytes_moved / (peak_gbs * 1e9)
    t_flop = flops / (peak_tflops * 1e12)
    bound = "memory" if t_mem >= t_flop else "compute"
    roof_t = max(t_mem, t_flop)
    return RooflineReport(
        seconds=seconds,
        bytes_moved=bytes_moved,
        flops=flops,
        achieved_gbs=achieved_gbs,
        achieved_tflops=achieved_tflops,
        peak_gbs=peak_gbs,
        peak_tflops=peak_tflops,
        bound=bound,
        fraction_of_roof=roof_t / seconds,
    )


# Distinct weight copies a timed run rotates over, at least this many bytes
# in all: a weight that fits the card's 50 MB L2 (llama2-7b's o_proj) would
# otherwise be read from L2 by launches back to back, not from HBM.
ROTATE_BYTES = 128 * 1024 * 1024


def profile_w8a16_matmul(m: int, k: int, n: int, bits: int = 8, iters: int = 200,
                         device=None, seed: int = 0) -> RooflineReport:
    """Time `ops/linear.py::w8a16_matmul` at (m, k, n) on the card and
    roofline it: x and a weight ~ N(0, 1/k) from a seeded generator there,
    quantized there per channel (int8 or int4) and packed; each timed run
    rotates over distinct copies of ROTATE_BYTES in all. The bytes and
    operations are those of `eetq_tpu/utils/profiling.py:159-161`."""
    from eetq_tpu_torch.layout.tiling import pack_weights
    from eetq_tpu_torch.ops.linear import w8a16_matmul
    from eetq_tpu_torch.quant.quantizer import symmetric_quantize

    device = resolve(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    w_bytes = k * n // (2 if bits == 4 else 1)
    copies = []
    for _ in range(max(1, -(-ROTATE_BYTES // w_bytes))):
        w = torch.randn(k, n, generator=gen, device=device) * k**-0.5
        q, s = symmetric_quantize(w, bits=bits)
        copies.append((pack_weights(q, bits=bits), s))
        del w, q
    turn = iter(range(1 << 62))

    def f():
        pw, s = copies[next(turn) % len(copies)]
        return w8a16_matmul(x, pw, s)

    t = device_time(f, iters=max(iters, len(copies)), device=device)
    bytes_moved = m * k * 2 + w_bytes + m * n * 2 + n * 4
    return roofline(t, bytes_moved, 2 * m * k * n, device=device)


# ---- multi-card scaling estimates (the JAX package's napkin models) ----


def count_collectives(fn: Callable, *args) -> dict[str, int]:
    """Run fn(*args) once and return the collectives it made on this rank:
    {op: bytes of their inputs, op + "_count": calls}, op "all_reduce"
    (JAX's psum), "all_gather" or "ppermute", one a tensor exchanged
    (`eetq_tpu/utils/profiling.py:179-214`). The port counts calls as they
    happen: a loop's collectives count once an iteration, where the JAX
    package counts a `scan` body once in its jaxpr."""
    from eetq_tpu_torch.dist.sharding import collective_counts

    before = collective_counts()
    fn(*args)
    after = collective_counts()
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


@dataclasses.dataclass
class TPScalingEstimate:
    tp: int
    t_single_ms: float
    t_tp_ms: float
    t_hbm_ms: float
    t_link_ms: float
    link_bytes_per_step: int
    speedup: float
    efficiency: float  # speedup / tp: fraction of perfect linear scaling

    def __str__(self) -> str:
        return (
            f"tp={self.tp}: step {self.t_tp_ms:.2f} ms "
            f"(hbm {self.t_hbm_ms:.2f} + nvlink {self.t_link_ms:.3f}; "
            f"{self.link_bytes_per_step/1e6:.2f} MB over NVLink) | "
            f"speedup {self.speedup:.2f}x, efficiency {self.efficiency:.0%}"
        )


def tp_decode_scaling(
    cfg,
    tp: int,
    hop_latency_s: float,
    batch: int = 1,
    seq: int = 1024,
    bits: int = 8,
    kv_bytes_per_elem: int = 2,
    measured_t1_ms: float | None = None,
    device=None,
) -> TPScalingEstimate:
    """Megatron-TP decode-step model of `eetq_tpu/utils/profiling.py::
    tp_decode_scaling`, its arithmetic unchanged, over NVLink.

    Per decode step at batch B, context S: every projection is column- or
    row-split, so weight streaming divides by tp, and the head-sharded KV
    too; the row-parallel o_proj and down each all-reduce a [B, 1, H] bf16
    activation (ring traffic 2 (tp - 1) / tp of the bytes) and the
    column-parallel lm_head all-gathers [B, 1, V] f32 logits ((tp - 1) / tp),
    at NVLink's rate each way (`nvlink_bw`), with 2 (tp - 1) hops of
    `hop_latency_s` (no datasheet figure: the caller's) per collective;
    t_tp = t_hbm + t_link + the single card's non-HBM overhead.
    measured_t1_ms anchors the single-card step to a measurement; otherwise
    the HBM roofline of the card (`chip_peaks`) is used."""
    peak_gbs = chip_peaks(device).hbm_gbs
    link_bw = nvlink_bw(device)
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    wpb = 0.5 if bits == 4 else 1.0  # weight bytes per element
    layer_bytes = wpb * (
        h * cfg.qkv_out
        + cfg.num_heads * cfg.head_dim * h
        + h * 2 * inter
        + inter * h
    )
    head_bytes = wpb * h * v  # quantized lm_head (bench default)
    kv_bytes = (
        2 * batch * seq * cfg.num_kv_heads * cfg.head_dim * kv_bytes_per_elem
    )
    total_bytes = cfg.num_layers * layer_bytes + head_bytes + kv_bytes

    t1 = (
        measured_t1_ms / 1e3
        if measured_t1_ms is not None
        else total_bytes / (peak_gbs * 1e9)
    )
    overhead = max(0.0, t1 - total_bytes / (peak_gbs * 1e9))

    t_hbm = (total_bytes / tp) / (peak_gbs * 1e9)
    ar_bytes = 2 * (tp - 1) / tp * (batch * h * 2)  # one bf16 all-reduce
    ag_bytes = (tp - 1) / tp * (batch * v * 4)  # f32 logits all-gather
    link_bytes = int(2 * cfg.num_layers * ar_bytes + ag_bytes)
    n_collectives = 2 * cfg.num_layers + 1
    t_link = link_bytes / link_bw + n_collectives * 2 * (tp - 1) * hop_latency_s
    t_tp = t_hbm + t_link + overhead
    return TPScalingEstimate(
        tp=tp,
        t_single_ms=t1 * 1e3,
        t_tp_ms=t_tp * 1e3,
        t_hbm_ms=t_hbm * 1e3,
        t_link_ms=t_link * 1e3,
        link_bytes_per_step=link_bytes,
        speedup=t1 / t_tp,
        efficiency=t1 / t_tp / tp,
    )


@dataclasses.dataclass
class PPScalingEstimate:
    pp: int
    t_tick_ms: float  # steady-state ring tick (one microbatch-token)
    t_stage_ms: float  # per-stage compute share of the tick
    t_link_ms: float  # activation transfer + latency per boundary
    link_bytes_per_tick: int
    throughput_speedup: float  # aggregate tokens/s vs one device
    efficiency: float  # throughput_speedup / pp
    latency_x: float  # per-token latency multiplier vs one device

    def __str__(self) -> str:
        return (
            f"pp={self.pp}: tick {self.t_tick_ms:.2f} ms "
            f"(stage {self.t_stage_ms:.2f} + link {self.t_link_ms:.3f}; "
            f"{self.link_bytes_per_tick/1e3:.1f} KB/boundary) | "
            f"throughput {self.throughput_speedup:.2f}x, "
            f"efficiency {self.efficiency:.0%}, "
            f"token latency {self.latency_x:.2f}x"
        )


def pp_decode_scaling(
    cfg,
    pp: int,
    link_gbs: float,
    link_latency_s: float,
    batch: int = 1,
    bits: int = 8,
    measured_t1_ms: float | None = None,
    device=None,
) -> PPScalingEstimate:
    """Token-ring pipeline-parallel decode model of `eetq_tpu/utils/
    profiling.py::pp_decode_scaling`, its arithmetic unchanged: with pp
    microbatches in flight each tick retires one microbatch-token, t_tick =
    t1 / pp + t_link (one [B, H] bf16 activation and the ring's token over
    a link of `link_gbs` GB/s and `link_latency_s`; the JAX defaults model a
    host network, which has no datasheet figure here: the caller gives
    both). measured_t1_ms: the single card's step time; default the HBM
    roofline of the whole weight stream (`chip_peaks`)."""
    peak_gbs = chip_peaks(device).hbm_gbs
    h = cfg.hidden_size
    wpb = 0.5 if bits == 4 else 1.0
    layer_bytes = wpb * (
        h * cfg.qkv_out
        + cfg.num_heads * cfg.head_dim * h
        + h * 2 * cfg.intermediate_size
        + cfg.intermediate_size * h
    )
    total_bytes = cfg.num_layers * layer_bytes + wpb * h * cfg.vocab_size
    t1 = (
        measured_t1_ms / 1e3
        if measured_t1_ms is not None
        else total_bytes / (peak_gbs * 1e9)
    )
    link_bytes = int(batch * h * 2 + batch * 4)
    t_link = link_bytes / (link_gbs * 1e9) + link_latency_s
    t_stage = t1 / pp
    t_tick = t_stage + t_link
    speedup = t1 / t_tick
    return PPScalingEstimate(
        pp=pp,
        t_tick_ms=t_tick * 1e3,
        t_stage_ms=t_stage * 1e3,
        t_link_ms=t_link * 1e3,
        link_bytes_per_tick=link_bytes,
        throughput_speedup=speedup,
        efficiency=speedup / pp,
        latency_x=pp * t_tick / t1,
    )


@contextlib.contextmanager
def trace(path: str):
    """Context manager: a `torch.profiler` trace of the host and the card
    around its body, written to `path` as a Chrome trace. A profiler that
    cannot start raises (the JAX version warns and skips)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
