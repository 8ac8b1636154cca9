// Token-grouped expert GEMM (routed MoE prefill and the engine's decode
// step): row block b of x, bm rows that all belong to one expert, times
// dequant(bank[block_expert[b]]); int8 banks.
//
// Replaces eetq_tpu/kernels/w8a16.py::w8a16_grouped_matmul_kernel_call for
// int8 banks, per-channel or group-wise. The caller sorts the (token,
// expert) selections by expert into bm-row blocks, MegaBlocks-style, with
// static shapes: at most one partial block per expert, then padding blocks
// that carry a valid id. Each block reads its expert from device memory (the
// TPU's scalar-prefetched index map), so the routing never leaves the card;
// the number of real blocks comes on the device too, and padding blocks
// write zeros without reading the bank.
//
// Bound by tensor-core operations at bm = 128 (a Mixtral prompt of 1024
// tokens: 2048 selections in 24 blocks, 19 of them real) and by the weight
// bytes at bm = 8 (the engine's 8-slot decode: 10 blocks, 7 real, each
// streaming its expert's [Kp, Np] strip). wgmma_grouped.cuh holds both
// designs, picked by bm: a 128-row wgmma tile, and a skinny tile that
// computes out^T = W^T x^T with the row block as wgmma's N.
#include "wgmma_grouped.cuh"

// x [nb * bm, k] bf16 contiguous (k % 8 == 0); w int8 [e, kp, np] (kp, np %
// 128 == 0); scales f32 [e, n], or [e, groups, n] with groups > 0 and
// group_size rows each; block_expert int32 [nb] on the device, each in
// [0, e); out bf16 [nb * bm, n]; real_blocks int32 [1] on the device (blocks
// at or past it are padding) or null.
extern "C" int eetq_w8a16_grouped_gemm(const void* x, int bm, int nb, int k, const void* w,
                                       int kp, int np, const void* scales, int groups,
                                       int group_size, const void* block_expert, void* out,
                                       int n, const void* real_blocks, void* stream) {
  return eetq::wgmma_grouped::bank_entry<8>(x, bm, nb, k, w, kp, np, scales, groups, group_size,
                                            block_expert, out, n, real_blocks, stream);
}
