// W8A8 GEMM: out[m, n] = bf16((f32(xq[m, :] . W[:, n]) * sx[m]) * sw[n] + bias[n])
// with per-token int8 activations xq, int8 per-channel weights W and an
// exact int32 accumulator.
//
// Replaces eetq_tpu/kernels/w8a8.py::w8a8_matmul_kernel_call. Bound by
// tensor-core operations at prefill sizes; the design (256 x 128 tiles on
// the int8 wgmma m64n128k32, the weight transposed byte-wise into a K-major
// shared tile once per block, an epilogue that is bit-identical to the plain
// version) is a8_gemm.cuh in its int8 mode.
#include "a8_gemm.cuh"

// xq [m, kp] int8 contiguous (zero past the logical K); w int8 [kp, np]
// (kp, np % 128 == 0); sx f32 [m]; sw f32 [n]; bias f32 [n] or null;
// out bf16 [m, n].
// act the epilogue's activation (common.cuh: 0 silu, 1 gelu, 2 relu, 3 none)
// and residual bf16 [m, n] or null, added or multiplied (res_mul), in f32
// before the one rounding.
extern "C" int eetq_w8a8_gemm(const void* xq, int m, int kp, const void* w, int np,
                              const void* sx, const void* sw, const void* bias, int act,
                              const void* residual, int res_mul, void* out, int n, void* stream) {
  return eetq::a8::launch<8>(xq, m, kp, w, np, sx, sw, 0, 0, bias, act, residual, res_mul, out, n,
                             stream);
}
