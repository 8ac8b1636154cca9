// W8A16 decode GEMV: out[m, n] = (y[m, :] . W[:, n]) * scale[n] + bias[n]
// for 1 <= m <= 8 rows, where y = x, or rmsnorm(x, gamma) rounded to bf16.
//
// Replaces the decode regime of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call. Bound by the int8 weight bytes (2m FLOPs per
// byte); the design (one block per 32-column strip looping over all of K,
// software-pipelined 16-byte loads, a shuffle reduce-scatter) is the shared
// GEMV of gemv.cuh, with its plain epilogue.
#include "gemv.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int8 [kp, np] (kp, np % 128 == 0);
// scales f32 [n]; bias f32 [n] or null; gamma f32 [k] or null; out bf16 [m, n].
extern "C" int eetq_w8a16_gemv(const void* x, int m, int k, const void* w, int kp, int np,
                               const void* scales, const void* bias, const void* gamma,
                               float eps, void* out, int n, void* stream) {
  eetq::gemv::Args a{};
  a.x = static_cast<const eetq::bf16*>(x);
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = kp;
  a.np = np;
  a.scales = static_cast<const float*>(scales);
  a.bias = static_cast<const float*>(bias);
  a.gamma = static_cast<const float*>(gamma);
  a.eps = eps;
  a.out = static_cast<eetq::bf16*>(out);
  a.n = n;
  return eetq::gemv::launch_m<false>(m, a, static_cast<cudaStream_t>(stream));
}
