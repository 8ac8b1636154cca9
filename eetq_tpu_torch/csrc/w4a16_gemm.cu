// W4A16 prefill GEMM: out[m, n] = x[m, :] . dequant(W)[:, n] + bias[n] with
// int4 weights, per-channel scales [n] or group-wise scales [groups, n].
//
// Replaces the prefill regime of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call for int4 weights. Bound by tensor-core operations
// at prefill sizes (m = 1024 does 4m operations per weight byte). The nibbles
// are widened to exact bf16 on the way into shared memory (the TPU kernel's
// biased nibbles and its -8 * rowsum(x) correction are not needed). Runs the
// Hopper tile of wgmma_gemm.cuh in its int4 mode (the same rings and wgmma
// as int8; only the producers' conversion differs), per-channel or with each
// group's scale on that group's f32 partial sum.
#include "wgmma_gemm.cuh"

// x [m, k] bf16 contiguous (k % 8 == 0); w int4 pairs [kp / 2, np] (kp the
// logical padded K; kp, np % 128 == 0); scales f32 [n], or [groups, n] with
// groups > 0 and group_size logical rows each (a multiple of 32); bias f32
// [n] or null; out bf16 [m, n].
// act the epilogue's activation (common.cuh: 0 silu, 1 gelu, 2 relu, 3 none)
// and residual bf16 [m, n] or null, added or multiplied (res_mul), in f32
// before the one rounding.
// tile_m the rows of the output tile: 0 the rule (128 where m <= 128, else
// 256), or 128 or 256 as given (kernels/autotune.py's measured choice);
// group-wise scales take 0 or 256 only (cudaErrorInvalidValue otherwise).
extern "C" int eetq_w4a16_gemm(const void* x, int m, int k, const void* w, int kp, int np,
                               const void* scales, int groups, int group_size, const void* bias,
                               int act, const void* residual, int res_mul, void* out, int n,
                               int tile_m, void* stream) {
  return eetq::wgmma_gemm::dense_entry<4>(x, m, k, w, kp, np, scales, groups, group_size, bias,
                                          act, residual, res_mul, out, n, tile_m, stream);
}
