// Expert-gather GEMV over an int4 bank (routed MoE decode): out[s] = x .
// dequant(bank[ids[s]]) for each selection s, 1 <= m <= 8 rows of x.
//
// Replaces eetq_tpu/kernels/w8a16.py::w8a16_expert_matmul_kernel_call for
// int4 banks, per-channel or group-wise (the usual 4-bit setting). Bound by
// the selected experts' weight bytes, half of int8's: a Mixtral decode step
// at batch 1 streams 2 x 88 MB of nibbles per layer plus, at 128-row groups,
// 2 x 5.5 MB of f32 scales. The design is w8a16_expert_gemv.cu's (one grid
// row per selection, the id read on the device) over gemv.cuh's int4 mode:
// a weight byte holds two neighbouring K rows, one MMA A register.
#include "gemv.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int4 pairs [e, rows, np] with
// rows = Kp / 2 (Kp, np % 128 == 0); scales f32 [e, n], or [e, groups, n]
// with groups > 0 and group_size logical rows each; expert_ids int32 [sels]
// on the device, each in [0, e); out bf16 [sels, m, n]; splits, partials and
// counters as for eetq_w8a16_expert_gemv.
extern "C" int eetq_w4a16_expert_gemv(const void* x, int m, int k, const void* w, int rows,
                                      int np, const void* scales, int groups, int group_size,
                                      const void* expert_ids, int sels, void* out, int n,
                                      void* partials, void* counters, int splits,
                                      void* stream) {
  return eetq::gemv::bank_entry<4>(x, m, k, w, rows, np, scales, groups, group_size, expert_ids,
                                   sels, out, n, partials, counters, splits, stream);
}
