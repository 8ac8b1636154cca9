// Token-grouped expert GEMM (routed MoE prefill): row block b of x, bm rows
// that all belong to one expert, times dequant(bank[block_expert[b]]); int8
// banks.
//
// Replaces eetq_tpu/kernels/w8a16.py::w8a16_grouped_matmul_kernel_call for
// int8 banks, per-channel or group-wise. The caller sorts the (token,
// expert) selections by expert into bm-row blocks, MegaBlocks-style, with
// static shapes: at most one partial block per expert, and padding blocks
// that carry a valid id and are computed, their rows dropped by the caller.
// Each block reads its expert from device memory (the TPU's scalar-prefetched
// index map), so the routing never leaves the card.
//
// Bound by tensor-core FLOPs at bm = 128 (a Mixtral prompt of 1024 tokens:
// 2048 selections in 24 blocks, ~23 TFLOP of routed expert work over the 32
// layers); at bm = 8 (the engine's 8-slot decode, 10 blocks) by the weight
// bytes, each block streaming its expert's whole [Kp, Np] strip. The tile is
// the W8A16 GEMM's (gemm_tile.cuh): bm < 128 masks the rows past bm of the
// 128-row tile and skips the MMAs of the 16-row fragments that hold none.
#include "gemm_tile.cuh"

// x [nb * bm, k] bf16 contiguous (k % 8 == 0); w int8 [e, kp, np] (kp, np %
// 128 == 0); scales f32 [e, n], or [e, groups, n] with groups > 0 and
// group_size rows each; block_expert int32 [nb] on the device, each in
// [0, e); out bf16 [nb * bm, n].
extern "C" int eetq_w8a16_grouped_gemm(const void* x, int bm, int nb, int k, const void* w,
                                       int kp, int np, const void* scales, int groups,
                                       int group_size, const void* block_expert, void* out,
                                       int n, void* stream) {
  return eetq::gemm::bank_entry<8>(x, bm, nb, k, w, kp, np, scales, groups, group_size,
                                   block_expert, out, n, stream);
}
