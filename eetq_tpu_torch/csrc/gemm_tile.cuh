// The W8A16 / W4A16 GEMM tile of the dense GEMM with group-wise scales
// (w8a16_gemm.cu and w4a16_gemm.cu with groups > 0). Per-channel scales run
// wgmma_gemm.cuh, the grouped expert GEMMs wgmma_grouped.cuh; this wmma tile
// is left to the dense group-wise mode until it moves onto the latter.
//
// out[m, n] = sum over groups of (x[m, group] . W[group, n]) * scale[g, n]
// + bias[n]. Bound by tensor-core FLOPs at prefill sizes. Each 256-thread
// block computes a
// 128 x 128 output tile: per 32-deep K step it stages the x tile (bf16) and
// the int8 weight tile, converted to bf16 on the way into shared memory
// (exact: |q| <= 128), and 8 warps each multiply a 64 x 32 sub-tile with
// wmma bf16 fragments into f32 accumulators. The next K step's tiles are
// loaded into registers while the current one is multiplied (two
// shared-memory buffers, one barrier per step). The bias is applied in the
// epilogue.
//
// int4 (kBits = 4): a weight byte holds logical row 2r in its low nibble and
// row 2r + 1 in its high one (layout/tiling.py), so a 32-deep K step reads
// 16 weight rows (8 bytes per thread) and each thread writes its 8 columns of
// the two logical rows, nibbles sign-extended in place, into the same bf16
// tile; the x tile is the contiguous one of int8.
//
// Group-wise scales (scales [G, n], group_size a multiple of the 32-deep K
// step): the steps of one group accumulate into a second set of
// fragments, and at the group's last step acc += part * scale, element by
// element, the group's scale row having been loaded as an accumulator
// fragment from a 16 x 16 tile of 16 equal rows (fragments of one type share
// their element layout), so each group's scale multiplies its f32 partial
// sum as the TPU kernel's does (w8a16.py::_dot_scaled).
//
// Rows of a 128-row tile past m load as zero, are not multiplied where a
// whole 16-row fragment lies past them, and are not written.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace eetq {
namespace gemm {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32, kThreads = 256;
// a scale group is whole K steps (kernels/autotune.py::GROUP_GRANULE)
static_assert(EETQ_GROUP_GRANULE % kBK == 0, "a K step must not straddle two scale groups");
constexpr int kALd = kBK + 8;  // padded smem rows (elements): fewer bank conflicts
constexpr int kBLd = kBN + 8;
constexpr int kWM = 64, kWN = 32;  // warp tile; warps form a 2 x 4 grid
constexpr int kFM = kWM / 16, kFN = kWN / 16;
static_assert((kBM / kWM) * (kBN / kWN) == kThreads / 32, "one warp tile per warp");

struct Args {
  const bf16* x;  // [m, k], k % 8 == 0
  int m, k;
  const int8_t* w;  // [kp, np] (int4: [kp / 2, np]); kp, np % 128 == 0
  int kp, np;           // kp: logical padded K
  const float* scales;  // [groups, n]
  int groups;           // rows of scales
  int group_size;       // logical K rows per group, % kBK == 0
  const float* bias;    // [n] or null
  bf16* out;            // [m, n]
  int n;
};

// Internal linkage: two sources include this file, and a __global__
// function has a host-side stub symbol.
namespace {

template <int kBits>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const Args a) {
  static_assert(kBits == 8 || kBits == 4, "int8 or int4 weights");
  __shared__ __align__(128) bf16 as[2][kBM * kALd];
  __shared__ __align__(128) bf16 bs[2][kBK * kBLd];
  __shared__ __align__(128) float cs[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = min(kBM, a.m - m0);  // valid rows of this block
  const int k = a.k, np = a.np;
  const int8_t* w = a.w;
  const float* scales = a.scales;

  using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  AccFrag acc[kFM][kFN];
  AccFrag part[kFM][kFN];  // the open group's sum
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      wmma::fill_fragment(part[i][j], 0.f);
    }

  // x tile: 128 rows x 4 vectors of 8 bf16 (2 per thread); W tile: 32 rows
  // x 8 vectors of 16 int8 (1 per thread), or 16 rows x 16 vectors of 8
  // bytes of int4. x past row `rows` or column k is 0.
  int4 a_reg[2], b_reg;
  uint2 b4_reg;
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 2, gk = k0 + (idx & 3) * 8;
      a_reg[i] = (row < rows && gk < k)
                     ? *reinterpret_cast<const int4*>(a.x + (size_t)(m0 + row) * k + gk)
                     : make_int4(0, 0, 0, 0);
    }
    if constexpr (kBits == 8) {
      const int row = tid >> 3, col = n0 + (tid & 7) * 16;
      b_reg = __ldg(reinterpret_cast<const int4*>(w + (size_t)(k0 + row) * np + col));
    } else {
      const int row = tid >> 4, col = n0 + (tid & 15) * 8;
      b4_reg = __ldg(reinterpret_cast<const uint2*>(w + (size_t)(k0 / 2 + row) * np + col));
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<int4*>(&as[buf][(idx >> 2) * kALd + (idx & 3) * 8]) = a_reg[i];
    }
    if constexpr (kBits == 4) {  // weight row r: logical rows 2r (low) and 2r + 1 (high)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float f[8];
        int8x4_to_float(p ? nibbles_to_int8x4<true>(b4_reg.x) : nibbles_to_int8x4<false>(b4_reg.x),
                        f);
        int8x4_to_float(p ? nibbles_to_int8x4<true>(b4_reg.y) : nibbles_to_int8x4<false>(b4_reg.y),
                        f + 4);
        uint4 v;
        v.x = pack_bf16x2(f[0], f[1]);
        v.y = pack_bf16x2(f[2], f[3]);
        v.z = pack_bf16x2(f[4], f[5]);
        v.w = pack_bf16x2(f[6], f[7]);
        *reinterpret_cast<uint4*>(&bs[buf][(2 * (tid >> 4) + p) * kBLd + (tid & 15) * 8]) = v;
      }
      return;
    }
    float f[16];
    int8x4_to_float(static_cast<uint32_t>(b_reg.x), f);
    int8x4_to_float(static_cast<uint32_t>(b_reg.y), f + 4);
    int8x4_to_float(static_cast<uint32_t>(b_reg.z), f + 8);
    int8x4_to_float(static_cast<uint32_t>(b_reg.w), f + 12);
    uint4 lo, hi;
    lo.x = pack_bf16x2(f[0], f[1]);
    lo.y = pack_bf16x2(f[2], f[3]);
    lo.z = pack_bf16x2(f[4], f[5]);
    lo.w = pack_bf16x2(f[6], f[7]);
    hi.x = pack_bf16x2(f[8], f[9]);
    hi.y = pack_bf16x2(f[10], f[11]);
    hi.z = pack_bf16x2(f[12], f[13]);
    hi.w = pack_bf16x2(f[14], f[15]);
    uint4* dst = reinterpret_cast<uint4*>(&bs[buf][(tid >> 3) * kBLd + (tid & 7) * 16]);
    dst[0] = lo;
    dst[1] = hi;
  };

  // 16-row fragments of this warp that hold a valid row (warp-uniform)
  const int frags = min(kFM, max(0, (rows - wm * kWM + 15) / 16));
  // a lane's 8 consecutive columns of one row of the warp's 16 x 16 scratch
  float* c = cs[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  // Close group gi: acc += part * scales[gi, columns].
  auto fold = [&](int gi) {
    const float* srow = scales + (size_t)gi * a.n;
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      const int gn0 = n0 + wn * kWN + j * 16 + c0;
#pragma unroll
      for (int e = 0; e < 8; ++e) c[r * 16 + c0 + e] = gn0 + e < a.n ? srow[gn0 + e] : 0.f;
      __syncwarp();
      AccFrag sf;
      wmma::load_matrix_sync(sf, c, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
#pragma unroll
        for (int e = 0; e < sf.num_elements; ++e) {
          acc[i][j].x[e] = fmaf(part[i][j].x[e], sf.x[e], acc[i][j].x[e]);
          part[i][j].x[e] = 0.f;
        }
      }
    }
  };
  const int nk = a.kp / kBK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load_tile((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[kFN];
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(bfr[j], &bs[buf][kk * kBLd + wn * kWN + j * 16], kBLd);
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        if (i < frags) {
          wmma::load_matrix_sync(af[i], &as[buf][(wm * kWM + i * 16) * kALd + kk], kALd);
#pragma unroll
          for (int j = 0; j < kFN; ++j) wmma::mma_sync(part[i][j], af[i], bfr[j], part[i][j]);
        }
      }
    }
    // rows past the last group are zero padding
    if ((t + 1) * kBK % a.group_size == 0 || t + 1 == nk)
      fold(min(t * kBK / a.group_size, a.groups - 1));
    if (t + 1 < nk) store_tile(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: each warp stages one 16 x 16 fragment at a time; a lane owns
  // 8 consecutive columns of one row.
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
    if (i >= frags) break;
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(c, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = wm * kWM + i * 16 + r;
      const int gn0 = n0 + wn * kWN + j * 16 + c0;
      if (row < rows) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int gn = gn0 + e;
          if (gn < a.n) {
            float v = c[r * 16 + c0 + e];
            if (a.bias != nullptr) v += a.bias[gn];
            a.out[(size_t)(m0 + row) * a.n + gn] = __float2bfloat16(v);
          }
        }
      }
      __syncwarp();
    }
  }
}

// The dense GEMM's C entry points (w8a16_gemm.cu, w4a16_gemm.cu) with
// group-wise scales (groups > 0; per-channel scales run wgmma_gemm.cuh):
// one block per 128 output columns and per 128 rows.
template <int kBits>
int dense_entry(const void* x, int m, int k, const void* w, int kp, int np, const void* scales,
                int groups, int group_size, const void* bias, void* out, int n, void* stream) {
  if (groups < 1 || group_size < EETQ_GROUP_GRANULE || group_size % EETQ_GROUP_GRANULE)
    return cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.m = m;
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = kp;
  a.np = np;
  a.scales = static_cast<const float*>(scales);
  a.groups = groups;
  a.group_size = group_size;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  gemm_kernel<kBits><<<dim3(np / kBN, (m + kBM - 1) / kBM), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gemm
}  // namespace eetq
