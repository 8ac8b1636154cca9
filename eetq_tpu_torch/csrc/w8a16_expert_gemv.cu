// Expert-gather GEMV (routed MoE decode): out[s] = x . dequant(bank[ids[s]])
// for each selection s, 1 <= m <= 8 rows of x.
//
// Replaces eetq_tpu/kernels/w8a16.py::w8a16_expert_matmul_kernel_call
// (int8 per-channel banks). Bound by the selected experts' weight bytes: a
// Mixtral decode step at batch 1 streams 2 of 8 experts per layer (2 x 176
// MB), never the whole bank. The TPU kernel scalar-prefetches the ids into
// its grid's index map; here gridDim.y is the selection, and each block
// reads its expert id from device memory and offsets the weight and scale
// pointers, so the routing never leaves the card. Ids may repeat: each
// selection streams its expert again, as on the TPU. The GEMV itself is
// gemv.cuh's plain mode, whose chunked staging of x keeps the m = 8 down
// projection (x [8, 14336], 229 KB of bf16) within shared memory.
#include "gemv.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int8 [e, kp, np] (kp, np % 128
// == 0); scales f32 [e, n]; expert_ids int32 [sels] on the device, each in
// [0, e); out bf16 [sels, m, n].
extern "C" int eetq_w8a16_expert_gemv(const void* x, int m, int k, const void* w, int kp,
                                      int np, const void* scales, const void* expert_ids,
                                      int sels, void* out, int n, void* stream) {
  eetq::gemv::Args a{};
  a.x = static_cast<const eetq::bf16*>(x);
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = kp;
  a.np = np;
  a.scales = static_cast<const float*>(scales);
  a.out = static_cast<eetq::bf16*>(out);
  a.n = n;
  a.expert_ids = static_cast<const int*>(expert_ids);
  a.w_stride = (long long)kp * np;
  a.s_stride = n;
  a.out_stride = (long long)m * n;
  return eetq::gemv::launch_m<false>(m, a, static_cast<cudaStream_t>(stream), sels);
}
