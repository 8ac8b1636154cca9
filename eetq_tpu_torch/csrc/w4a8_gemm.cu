// W4A8 GEMM: per-token int8 activations xq times int4 weights W, an exact
// int32 accumulator. Per-channel scales sw [n]:
// out[m, n] = bf16((f32(xq[m, :] . W[:, n]) * sx[m]) * sw[n] + bias[n]),
// bit-identical to a plain version that sums exactly. Group-wise scales sw
// [groups, n]: out[m, n] = bf16((sum over groups of f32(the group's s32 sum)
// * sw[g, n]) * sx[m] + bias[n]).
//
// Replaces eetq_tpu/kernels/w8a8.py::w4a8_matmul_kernel_call. Bound by
// tensor-core operations at prefill sizes (m = 1024 does 4m operations per
// weight byte). The design is a8_gemm.cuh in its int4 mode: the nibbles are
// sign-extended to int8 operands of the int8 wgmma in the pass that
// transposes the weight tile, so the TPU kernel's biased nibbles, its
// -8 * rowsum(x) correction and its x16 / 1/16 folding are not needed.
#include "a8_gemm.cuh"

// xq [m, kp] int8 contiguous (zero past the logical K; kp the logical padded
// K); w int4 pairs [kp / 2, np] (kp, np % 128 == 0); sx f32 [m]; sw f32 [n],
// or [groups, n] with groups > 0 and group_size logical rows each (a
// multiple of 32); bias f32 [n] or null; out bf16 [m, n].
// act the epilogue's activation (common.cuh: 0 silu, 1 gelu, 2 relu, 3 none)
// and residual bf16 [m, n] or null, added or multiplied (res_mul), in f32
// before the one rounding.
extern "C" int eetq_w4a8_gemm(const void* xq, int m, int kp, const void* w, int np,
                              const void* sx, const void* sw, int groups, int group_size,
                              const void* bias, int act, const void* residual, int res_mul,
                              void* out, int n, void* stream) {
  return eetq::a8::launch<4>(xq, m, kp, w, np, sx, sw, groups, group_size, bias, act, residual,
                             res_mul, out, n, stream);
}
