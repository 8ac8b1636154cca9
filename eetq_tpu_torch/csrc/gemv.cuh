// The int8-weight decode GEMV shared by w8a16_gemv.cu and fused_mlp.cu.
//
// out[m, c] = epilogue((y[m, :] . W[:, col(c)]) * scale[col(c)]) for
// 1 <= m <= M <= 8 rows, where y = x, or rmsnorm(x, gamma) rounded to bf16.
//
// Bound by the int8 weight bytes (2m FLOPs per byte). One block owns a
// 32-column strip of the row-major [Kp, Np] weight and loops over all of K
// itself: in each warp two lanes sit side by side along N (16 columns each,
// one 16-byte load per row) and 16 lanes take 16 consecutive K rows, the 8
// warps 128 rows per sweep. Loads come in batches of four sweeps,
// software-pipelined: the next batch is in flight while one is multiplied,
// and the first while y is staged in dynamic shared memory (as [Kp][m]
// bf16). The f32 partial sums are reduce-scattered over the 16 K lanes with
// shuffles, summed over the warps in shared memory, and the per-channel
// scale is applied once to the total.
//
// Two modes:
// - plain: out = s * scale (+ bias) (+ residual), summed in f32 and
//   rounded once to bf16.
// - gate/up (the fused MLP's first half): the block makes two passes over
//   K, first over the gate strip [c0, c0 + 32) of the fused [Kp, 2I]
//   weight, then over the matching up strip [up + c0, up + c0 + 32), so
//   each lane pair still reads 32 contiguous bytes per row (a whole
//   32-byte sector), and writes h = act(gate * sg) * (up * su) for its 32
//   intermediate columns, rounded to bf16.
#pragma once

#include "common.cuh"

namespace eetq {
namespace gemv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 16;  // one 16-byte int8 load per lane and row
constexpr int kLanesN = 2;
constexpr int kRowsPerWarp = 32 / kLanesN;
constexpr int kBlockN = kLanesN * kColsPerLane;  // 32 columns per block
// the fused MLP's slice width (kernels/autotune.py::FUSED_MLP_SLICE)
static_assert(EETQ_FUSED_MLP_SLICE == kBlockN, "a gate/up block owns one 32-column strip");
constexpr int kSweep = kWarps * kRowsPerWarp;    // 128 K rows per sweep
constexpr int kUnroll = 4;
static_assert(kLanesN == 2, "the butterfly below reduces over lane bits 1..4");

enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

struct Args {
  const bf16* x;  // [M, k], k % 8 == 0
  int k;
  const int8_t* w;  // [kp, np]
  int kp, np;
  const float* scales;  // [n] (plain) or [2I] (gate/up)
  const float* bias;    // [n] or null (plain only)
  const float* gamma;   // [k] or null: RMSNorm prologue
  float eps;
  const bf16* residual;  // [M, n] or null (plain only)
  bf16* out;             // [M, n]; gate/up: h [M, n] with n = I
  int n;
  int up;   // gate/up: column of the up half (= I)
  int act;  // gate/up: Act
};

// Reduce-scatter step: lanes `offset` apart swap halves of v[0, 2H); the
// upper lane keeps the sum of the upper halves, the lower lane the lower.
template <int H>
__device__ __forceinline__ void butterfly(float* v, int lane, int offset) {
  const bool upper = lane & offset;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float recv = __shfl_xor_sync(0xffffffffu, send, offset);
    v[j] = (upper ? v[j + H] : v[j]) + recv;
  }
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return g / (1.f + expf(-g));
  if (act == kGelu)  // tanh approximation, jax.nn.gelu's default
    return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.f);
}

template <int M, bool kGateUp>
__global__ void __launch_bounds__(kThreads) gemv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);  // [kp][M]
  __shared__ float red[kWarps][M][kBlockN];
  __shared__ float gate_sum[kGateUp ? M : 1][kBlockN];
  __shared__ float part[kWarps][M];
  __shared__ float inv_rms[M];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nl = lane % kLanesN, kr = lane / kLanesN;
  const int kp = a.kp, np = a.np, k = a.k;
  // first column of this lane's 16-column strip (the gate strip's, in
  // gate/up mode: the second pass moves it to the up strip)
  const int8_t* wcol = a.w + blockIdx.x * kBlockN + nl * kColsPerLane;
  // Rows k0, k0 + kSweep, ... of this lane; the first batch of weight
  // loads is in flight while y is staged, and each later batch while the
  // one before it is multiplied.
  int k0 = warp * kRowsPerWarp + kr;
  int4 cur[kUnroll], nxt[kUnroll];
  auto load = [&](int4* dst, int base) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = base + u * kSweep;
      dst[u] = kk < kp ? __ldg(reinterpret_cast<const int4*>(wcol + (size_t)kk * np))
                       : make_int4(0, 0, 0, 0);
    }
  };
  load(cur, k0);

  // Prologue: 1/rms of each row (k % 8 == 0: whole 16-byte vectors).
  if (a.gamma != nullptr) {
    float ss[M];
#pragma unroll
    for (int m = 0; m < M; ++m) ss[m] = 0.f;
    for (int c = tid * 8; c < k; c += kThreads * 8) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float f[8];
        bf16x8_to_float(*reinterpret_cast<const int4*>(a.x + (size_t)m * k + c), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) ss[m] = fmaf(f[i], f[i], ss[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      ss[m] = warp_sum(ss[m]);
      if (lane == 0) part[warp][m] = ss[m];
    }
    __syncthreads();
    if (tid < M) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += part[i][tid];
      inv_rms[tid] = rsqrtf(s / k + a.eps);
    }
    __syncthreads();
  }
  // Stage y as bf16 [kp][M]; rows k..kp are zero.
  for (int c = tid * 8; c < kp; c += kThreads * 8) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c < k) {
        bf16x8_to_float(*reinterpret_cast<const int4*>(a.x + (size_t)m * k + c), f);
        if (a.gamma != nullptr) {
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = f[i] * inv_rms[m] * a.gamma[c + i];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) ys[(c + i) * M + m] = __float2bfloat16(f[i]);
    }
  }
  __syncthreads();

  const int col = nl * kColsPerLane + ((lane >> 1) & 1) * 8 + ((lane >> 2) & 1) * 4 +
                  ((lane >> 3) & 1) * 2 + ((lane >> 4) & 1);
  constexpr int kPasses = kGateUp ? 2 : 1;
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    if (pass > 0) {  // gate/up: the up strip, with the loads primed again
      wcol += a.up;
      k0 = warp * kRowsPerWarp + kr;
      load(cur, k0);
    }
    float acc[M][kColsPerLane];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[m][j] = 0.f;

    for (; k0 < kp; k0 += kSweep * kUnroll) {
      load(nxt, k0 + kSweep * kUnroll);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k0 + u * kSweep;
        if (kk < kp) {
          float yv[M];
#pragma unroll
          for (int m = 0; m < M; ++m) yv[m] = __bfloat162float(ys[kk * M + m]);
          float wf[kColsPerLane];
          int8x4_to_float(static_cast<uint32_t>(cur[u].x), wf);
          int8x4_to_float(static_cast<uint32_t>(cur[u].y), wf + 4);
          int8x4_to_float(static_cast<uint32_t>(cur[u].z), wf + 8);
          int8x4_to_float(static_cast<uint32_t>(cur[u].w), wf + 12);
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j) acc[m][j] = fmaf(yv[m], wf[j], acc[m][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    }

    // Reduce over the 16 K lanes (lane bits 1..4): afterwards each lane holds
    // the warp's sum for one of its 16 columns.
#pragma unroll
    for (int m = 0; m < M; ++m) {
      butterfly<8>(acc[m], lane, 2);
      butterfly<4>(acc[m], lane, 4);
      butterfly<2>(acc[m], lane, 8);
      butterfly<1>(acc[m], lane, 16);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) red[warp][m][col] = acc[m][0];
    __syncthreads();
    if (kGateUp && pass == 0) {  // keep the gate sums; the up pass reuses red
      if (tid < M * kBlockN) {
        const int m = tid / kBlockN, c = tid % kBlockN;
        float g = 0.f;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) g += red[i][m][c];
        gate_sum[m][c] = g;
      }
      __syncthreads();
    }
  }  // pass

  if constexpr (kGateUp) {
    if (tid < M * kBlockN) {
      const int m = tid / kBlockN, c = tid % kBlockN;
      float u = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) u += red[i][m][c];
      const int ic = blockIdx.x * kBlockN + c;
      const float g = gate_sum[m][c] * a.scales[ic];
      u *= a.scales[a.up + ic];
      a.out[(size_t)m * a.n + ic] = __float2bfloat16(activate(g, a.act) * u);
    }
  } else if (tid < M * kBlockN) {
    const int m = tid / kBlockN, c = tid % kBlockN;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][m][c];
    const int nn = blockIdx.x * kBlockN + c;
    if (nn < a.n) {
      float r = s * a.scales[nn];
      if (a.bias != nullptr) r += a.bias[nn];
      if (a.residual != nullptr) r += __bfloat162float(a.residual[(size_t)m * a.n + nn]);
      a.out[(size_t)m * a.n + nn] = __float2bfloat16(r);
    }
  }
}

template <int M, bool kGateUp>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = (size_t)M * a.kp * sizeof(bf16);
  static size_t opted_in = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemv_kernel<M, kGateUp>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  gemv_kernel<M, kGateUp><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dispatch on the row count (1..8): one block per 32 columns of the packed
// weight (plain) or of the intermediate dim (gate/up).
template <bool kGateUp>
cudaError_t launch_m(int m, const Args& a, cudaStream_t stream) {
  const int blocks = (kGateUp ? a.up : a.np) / kBlockN;
  switch (m) {
    case 1: return launch<1, kGateUp>(a, blocks, stream);
    case 2: return launch<2, kGateUp>(a, blocks, stream);
    case 3: return launch<3, kGateUp>(a, blocks, stream);
    case 4: return launch<4, kGateUp>(a, blocks, stream);
    case 5: return launch<5, kGateUp>(a, blocks, stream);
    case 6: return launch<6, kGateUp>(a, blocks, stream);
    case 7: return launch<7, kGateUp>(a, blocks, stream);
    case 8: return launch<8, kGateUp>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gemv
}  // namespace eetq
