// W4A16 decode GEMV: out[m, n] = y[m, :] . dequant(W)[:, n] + bias[n] for
// 1 <= m <= 8 rows, where y = x, or rmsnorm(x, gamma) rounded to bf16; int4
// weights, per-channel scales [n] or group-wise scales [groups, n].
//
// Replaces the decode regime of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call for int4 weights. Bound by the weight bytes, half
// of int8's (4m FLOPs per byte): a llama2-7b layer's four projections are
// 101 MB. The design is the shared GEMV of gemv.cuh in its int4 mode: a
// byte already holds two K-neighbours of one column, which is what one A
// register of the MMA holds, so each byte becomes a bf16 pair with one
// permute, one lop3 and one subtraction (the TPU kernel's biased nibbles, its
// -8 * rowsum(x) correction and the 1/16 folded into x are not needed), and
// the RMSNorm prologue is fused as for int8 (the TPU kernel applies a plain
// rmsnorm first for int4: the same function).
#include "gemv.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int4 pairs [rows, np] with rows =
// Kp / 2 (Kp, np % 128 == 0); scales f32 [n], or [groups, n] with groups > 0
// and group_size logical rows each (even); bias f32 [n] or null; gamma f32
// [k] (16-byte aligned) or null; out bf16 [m, n]; splits, partials and
// counters as for eetq_w8a16_gemv.
// act the epilogue's activation (common.cuh: 0 silu, 1 gelu, 2 relu, 3 none)
// and residual bf16 [m, n] or null, added or multiplied (res_mul), in f32
// before the one rounding.
extern "C" int eetq_w4a16_gemv(const void* x, int m, int k, const void* w, int rows, int np,
                               const void* scales, int groups, int group_size, const void* bias,
                               const void* gamma, float eps, int act, const void* residual,
                               int res_mul, void* out, int n, void* partials, void* counters,
                               int splits, void* stream) {
  return eetq::gemv::dense_entry<4>(x, m, k, w, rows, np, scales, groups, group_size, bias, gamma,
                                    eps, act, residual, res_mul, out, n, partials, counters,
                                    splits, stream);
}
