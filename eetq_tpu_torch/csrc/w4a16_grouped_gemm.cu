// Token-grouped expert GEMM over an int4 bank (routed MoE prefill): row
// block b of x, bm rows that all belong to one expert, times
// dequant(bank[block_expert[b]]).
//
// Replaces eetq_tpu/kernels/w8a16.py::w8a16_grouped_matmul_kernel_call for
// int4 banks, per-channel or group-wise. Bound as w8a16_grouped_gemm.cu: by
// tensor-core FLOPs at bm = 128, by the experts' weight bytes (half of
// int8's, plus the f32 scale rows) at bm = 8. The design is that file's (one
// grid row per row block, the id read on the device) over gemm_tile.cuh's
// int4 mode: 16 packed rows per 32-deep K step, the nibbles sign-extended on
// the way into the bf16 tile; group-wise scales fold each group's fragments
// into the accumulator.
#include "gemm_tile.cuh"

// x [nb * bm, k] bf16 contiguous (k % 8 == 0); w int4 pairs [e, kp / 2, np]
// (kp, np % 128 == 0; kp the logical padded depth); scales f32 [e, n], or
// [e, groups, n] with groups > 0 and group_size logical rows each;
// block_expert int32 [nb] on the device, each in [0, e); out bf16
// [nb * bm, n].
extern "C" int eetq_w4a16_grouped_gemm(const void* x, int bm, int nb, int k, const void* w,
                                       int kp, int np, const void* scales, int groups,
                                       int group_size, const void* block_expert, void* out,
                                       int n, void* stream) {
  return eetq::gemm::bank_entry<4>(x, bm, nb, k, w, kp, np, scales, groups, group_size,
                                   block_expert, out, n, stream);
}
