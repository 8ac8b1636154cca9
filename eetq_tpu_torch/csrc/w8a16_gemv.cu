// W8A16 decode GEMV: out[m, n] = y[m, :] . dequant(W)[:, n] + bias[n] for
// 1 <= m <= 8 rows, where y = x, or rmsnorm(x, gamma) rounded to bf16; int8
// weights, per-channel scales [n] or group-wise scales [groups, n].
//
// Replaces the decode regime of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call. Bound by the int8 weight bytes (2m FLOPs per
// byte); the design (mma.sync over out^T = W^T y^T with A built in registers
// from the weight loads, 128-column blocks, K split across blocks where the
// strips are too few, partials summed in order by the strip's last block) is
// the shared GEMV of gemv.cuh, with its plain epilogue.
#include "gemv.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int8 [kp, np] (kp, np % 128 == 0);
// scales f32 [n], or [groups, n] with groups > 0 and group_size rows each;
// bias f32 [n] or null; gamma f32 [k] (16-byte aligned) or null; out bf16
// [m, n]; splits K ranges (kernels/autotune.py::gemv_splits), and for
// splits > 1 partials f32 [splits, np / 128, 8, 128] and counters int32
// [np / 128], zero.
extern "C" int eetq_w8a16_gemv(const void* x, int m, int k, const void* w, int kp, int np,
                               const void* scales, int groups, int group_size, const void* bias,
                               const void* gamma, float eps, void* out, int n, void* partials,
                               void* counters, int splits, void* stream) {
  return eetq::gemv::dense_entry<8>(x, m, k, w, kp, np, scales, groups, group_size, bias, gamma,
                                    eps, out, n, partials, counters, splits, stream);
}
