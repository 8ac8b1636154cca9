// Expert-gather GEMV (routed MoE decode): out[s] = x . dequant(bank[ids[s]])
// for each selection s, 1 <= m <= 8 rows of x; int8 banks.
//
// Replaces eetq_tpu/kernels/w8a16.py::w8a16_expert_matmul_kernel_call for
// int8 banks, per-channel or group-wise. Bound by the selected experts'
// weight bytes: a Mixtral decode step at batch 1 streams 2 of 8 experts per
// layer (2 x 176 MB), never the whole bank. The TPU kernel scalar-prefetches
// the ids into its grid's index map; here gridDim.y is the selection, and
// each block reads its expert id from device memory and offsets the weight
// and scale pointers, so the routing never leaves the card. Ids may repeat:
// each selection streams its expert again, as on the TPU. The GEMV itself is
// gemv.cuh's plain mode, whose chunked staging of x keeps the m = 8 down
// projection (x [8, 14336], 229 KB of bf16) within shared memory.
#include "gemv.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int8 [e, kp, np] (kp, np % 128
// == 0); scales f32 [e, n], or [e, groups, n] with groups > 0 and group_size
// rows each; expert_ids int32 [sels] on the device, each in [0, e); out bf16
// [sels, m, n].
extern "C" int eetq_w8a16_expert_gemv(const void* x, int m, int k, const void* w, int kp,
                                      int np, const void* scales, int groups, int group_size,
                                      const void* expert_ids, int sels, void* out, int n,
                                      void* stream) {
  return eetq::gemv::bank_entry<8>(x, m, k, w, kp, np, scales, groups, group_size, expert_ids,
                                   sels, out, n, stream);
}
