// Fused decode MLP on int4 weights:
// out = (act(y . Wg * sg) * (y . Wu * su)) . Wd * sd + residual with
// y = rmsnorm(x, gamma) rounded to bf16, for 1 <= m <= 8 rows.
//
// Replaces eetq_tpu/kernels/mlp_fused.py::fused_mlp_gemv_i4_call (int4
// per-channel weights, no bias). Bound by the weight bytes: a llama2-7b
// layer's MLP is 67.6 MB of int4 (gate/up [4096, 22016], down [11008, 4096])
// at 4m FLOPs per byte. The TPU kernel keeps h in fast memory and its
// split-half nibbles make the down product consume h at i and at I/2 + i, so
// it computes four gate/up column blocks per step. Here the block is the two
// launches of fused_mlp.cu with the GEMV of gemv.cuh in its int4 mode, h
// [m, I] passing through device memory (176 KB at m = 8: it stays in L2),
// and a weight byte holds two neighbouring rows, so the down GEMV reads h in
// order:
//
// 1. gate/up: one block per 32 intermediate columns, RMSNorm prologue, the
//    gate strip and then the up strip, both scaled in f32, the activation,
//    h rounded to bf16 where the TPU kernel rounds it (mlp_fused.py:214-215).
// 2. down: the int4 GEMV over h with the residual added in f32 before the
//    one rounding to bf16.
#include "gemv.cuh"

// x [m, k] bf16 (k % 8 == 0); gamma f32 [k]; gu int4 pairs [kp / 2, 2i] with
// the up half at column i (i % 128 == 0, kp the logical padded K); gu_scales
// f32 [2i]; d int4 pairs [i / 2, np]; d_scales f32 [n]; residual bf16 [m, n]
// or null; h bf16 [m, i] scratch; out bf16 [m, n]; act 0 silu, 1 gelu
// (tanh), 2 relu.
extern "C" int eetq_fused_mlp_gemv_i4(const void* x, int m, int k, const void* gamma, float eps,
                                      const void* gu, int kp, int i, const void* gu_scales,
                                      const void* d, int np, const void* d_scales,
                                      const void* residual, void* h, void* out, int n, int act,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  eetq::gemv::Args g{};
  g.x = static_cast<const eetq::bf16*>(x);
  g.k = k;
  g.w = static_cast<const int8_t*>(gu);
  g.kp = kp / 2;
  g.np = 2 * i;
  g.scales = static_cast<const float*>(gu_scales);
  g.gamma = static_cast<const float*>(gamma);
  g.eps = eps;
  g.out = static_cast<eetq::bf16*>(h);
  g.n = i;
  g.up = i;
  g.act = act;
  cudaError_t err = eetq::gemv::launch_m<true, 4>(m, g, s);
  if (err != cudaSuccess) return err;

  eetq::gemv::Args dn{};
  dn.x = static_cast<const eetq::bf16*>(h);
  dn.k = i;
  dn.w = static_cast<const int8_t*>(d);
  dn.kp = i / 2;
  dn.np = np;
  dn.scales = static_cast<const float*>(d_scales);
  dn.residual = static_cast<const eetq::bf16*>(residual);
  dn.out = static_cast<eetq::bf16*>(out);
  dn.n = n;
  return eetq::gemv::launch_m<false, 4>(m, dn, s);
}
