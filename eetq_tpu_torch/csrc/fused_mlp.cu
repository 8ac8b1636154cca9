// Fused decode MLP: out = (act(y . Wg * sg) * (y . Wu * su)) . Wd * sd + residual
// with y = rmsnorm(x, gamma) rounded to bf16, for 1 <= m <= 8 rows.
//
// Replaces eetq_tpu/kernels/mlp_fused.py::fused_mlp_gemv_call (int8
// per-channel weights). Bound by the weight bytes: a llama2-7b layer's MLP
// streams 135 MB of int8 (gate/up [4096, 22016], down [11008, 4096]) for
// 2m FLOPs per byte. The TPU kernel walks the intermediate dim I in order
// and carries an [m, N] f32 accumulator across grid steps; blocks on the
// GPU run in parallel, so the down product's sum over I is split at h
// instead: two launches of the GEMV of gemv.cuh (tensor cores, K split
// where the strips are too few), no float atomics, so the output is the
// same from run to run.
//
// 1. gate/up: one block per 64 intermediate columns (I/64 = 172 blocks at
//    llama2-7b) with the RMSNorm prologue; half of its lanes stream the 64
//    gate columns and half the matching 64 up columns in one K loop (64
//    contiguous bytes per lane row of each); the epilogue scales both in
//    f32, applies the activation and writes h [m, I] rounded to bf16, where
//    the TPU kernel rounds it (mlp_fused.py:77-80). h is 176 KB at m = 8 and
//    stays in L2.
// 2. down: the plain GEMV over h (one block per 128 output columns, K split
//    across blocks) with the residual added in f32 before the one rounding
//    to bf16.
//
// Every weight byte is read once, as by the TPU kernel; against the
// unfused path this drops the f32 gate/up round trip through memory and
// the split, cast, silu, mul and residual-add launches (8 launches per
// MLP become 2).
#include "gemv.cuh"

// x [m, k] bf16 (k % 8 == 0); gamma f32 [k]; gu int8 [kp, 2i] with the up
// half at column i (i % 128 == 0); gu_scales f32 [2i]; d int8 [i, np];
// d_scales f32 [n]; residual bf16 [m, n] or null; h bf16 [m, i] scratch;
// out bf16 [m, n]; act 0 silu, 1 gelu (tanh), 2 relu; gu_splits and
// d_splits K ranges of the two launches (kernels/autotune.py::gemv_splits),
// partials f32 and counters int32 (zero) for the larger of the two.
extern "C" int eetq_fused_mlp_gemv(const void* x, int m, int k, const void* gamma, float eps,
                                   const void* gu, int kp, int i, const void* gu_scales,
                                   const void* d, int np, const void* d_scales,
                                   const void* residual, void* h, void* out, int n, int act,
                                   void* partials, void* counters, int gu_splits, int d_splits,
                                   void* stream) {
  return eetq::gemv::mlp_entry<8>(x, m, k, gamma, eps, gu, kp, i, gu_scales, d, np, d_scales,
                                  residual, h, out, n, act, partials, counters,
                                  gu_splits, d_splits, stream);
}
