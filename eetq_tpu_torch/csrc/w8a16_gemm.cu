// W8A16 prefill GEMM: out[m, n] = x[m, :] . dequant(W)[:, n] + bias[n] with
// int8 weights, per-channel scales [n] or group-wise scales [groups, n].
//
// Replaces the prefill regime of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call. Bound by tensor-core operations at prefill
// sizes. Runs the Hopper tile of wgmma_gemm.cuh: cp.async into rings of
// shared memory, the int8 tile widened to bf16 once per block by two
// producer warpgroups, wgmma in two consumer warpgroups; per-channel scales
// and bias on the accumulators, or each group's scale on that group's f32
// partial sum (a second register set, on a tile of half the columns).
#include "wgmma_gemm.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int8 [kp, np] (kp, np % 128 == 0);
// scales f32 [n], or [groups, n] with groups > 0 and group_size rows each (a
// multiple of 32); bias f32 [n] or null; out bf16 [m, n].
// act the epilogue's activation (common.cuh: 0 silu, 1 gelu, 2 relu, 3 none)
// and residual bf16 [m, n] or null, added or multiplied (res_mul), in f32
// before the one rounding.
// tile_m the rows of the output tile: 0 the rule (128 where m <= 128, else
// 256), or 128 or 256 as given (kernels/autotune.py's measured choice);
// group-wise scales take 0 or 256 only (cudaErrorInvalidValue otherwise).
extern "C" int eetq_w8a16_gemm(const void* x, int m, int k, const void* w, int kp, int np,
                               const void* scales, int groups, int group_size, const void* bias,
                               int act, const void* residual, int res_mul, void* out, int n,
                               int tile_m, void* stream) {
  return eetq::wgmma_gemm::dense_entry<8>(x, m, k, w, kp, np, scales, groups, group_size, bias,
                                          act, residual, res_mul, out, n, tile_m, stream);
}
