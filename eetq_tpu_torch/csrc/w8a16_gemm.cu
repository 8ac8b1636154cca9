// W8A16 prefill GEMM: out[m, n] = (x[m, :] . W[:, n]) * scale[n] + bias[n].
//
// Replaces the prefill regime of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call. Bound by tensor-core FLOPs at prefill sizes;
// the design (128 x 128 tiles, int8 converted to bf16 in shared memory,
// wmma bf16 with f32 accumulation, the scale in the epilogue) is the tile
// of gemm_tile.cuh with 128-row blocks.
#include "gemm_tile.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int8 [kp, np] (kp, np % 128 == 0);
// scales f32 [n]; bias f32 [n] or null; out bf16 [m, n].
extern "C" int eetq_w8a16_gemm(const void* x, int m, int k, const void* w, int kp, int np,
                               const void* scales, const void* bias, void* out, int n,
                               void* stream) {
  eetq::gemm::Args a{};
  a.x = static_cast<const eetq::bf16*>(x);
  a.m = m;
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = kp;
  a.np = np;
  a.scales = static_cast<const float*>(scales);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<eetq::bf16*>(out);
  a.n = n;
  a.bm = eetq::gemm::kBM;
  return eetq::gemm::launch(a, (m + eetq::gemm::kBM - 1) / eetq::gemm::kBM,
                            static_cast<cudaStream_t>(stream));
}
