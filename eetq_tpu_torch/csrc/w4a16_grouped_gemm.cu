// Token-grouped expert GEMM over an int4 bank (routed MoE prefill and the
// engine's decode step): row block b of x, bm rows that all belong to one
// expert, times dequant(bank[block_expert[b]]).
//
// Replaces eetq_tpu/kernels/w8a16.py::w8a16_grouped_matmul_kernel_call for
// int4 banks, per-channel or group-wise. Bound as w8a16_grouped_gemm.cu: by
// tensor-core operations at bm = 128, by the experts' weight bytes (half of
// int8's, plus the f32 scale rows) at bm = 8. The designs are that file's
// (wgmma_grouped.cuh); only the producers' widening differs: the nibbles of
// a byte (K rows 2i and 2i + 1) are sign-extended into two bf16 rows, and
// the skinny tile keeps nine K steps of packed weights in flight, not five.
#include "wgmma_grouped.cuh"

// x [nb * bm, k] bf16 contiguous (k % 8 == 0); w int4 pairs [e, kp / 2, np]
// (kp, np % 128 == 0; kp the logical padded depth); scales f32 [e, n], or
// [e, groups, n] with groups > 0 and group_size logical rows each;
// block_expert int32 [nb] on the device, each in [0, e); out bf16
// [nb * bm, n]; real_blocks int32 [1] on the device or null.
extern "C" int eetq_w4a16_grouped_gemm(const void* x, int bm, int nb, int k, const void* w,
                                       int kp, int np, const void* scales, int groups,
                                       int group_size, const void* block_expert, void* out,
                                       int n, const void* real_blocks, void* stream) {
  return eetq::wgmma_grouped::bank_entry<4>(x, bm, nb, k, w, kp, np, scales, groups, group_size,
                                            block_expert, out, n, real_blocks, stream);
}
