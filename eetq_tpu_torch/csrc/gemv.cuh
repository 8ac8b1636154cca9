// The int8- and int4-weight decode GEMV shared by w8a16_gemv.cu,
// w4a16_gemv.cu, w8a16_expert_gemv.cu, w4a16_expert_gemv.cu, fused_mlp.cu
// and fused_mlp_i4.cu.
//
// out[m, c] = epilogue((y[m, :] . W[:, col(c)]) * scale[col(c)]) for
// 1 <= m <= M <= 8 rows, where y = x, or rmsnorm(x, gamma) rounded to bf16.
//
// Bound by the weight bytes (2m FLOPs per int8 byte, 4m per int4 byte). One
// block owns a 32-column strip of the row-major weight and loops over all of
// K itself: in each warp two lanes sit side by side along N (16 columns each,
// one 16-byte load per row) and 16 lanes take 16 consecutive K rows, the 8
// warps 128 rows per sweep. Loads come in batches of four sweeps,
// software-pipelined: the next batch is in flight while one is multiplied,
// and the first while y is staged in dynamic shared memory (as [rows][m]
// bf16). Where all of y does not fit (m = 8 at K = 14336 needs 229,376
// bytes besides the reduction buffers), it is staged in chunks of whole
// load batches, each after the block has finished with the one before. The
// f32 partial sums are reduce-scattered over the 16 K lanes with shuffles,
// summed over the warps in shared memory, and the per-channel scale is
// applied once to the total.
//
// int4 (kBits = 4): a weight byte holds logical row 2r in its low nibble and
// row 2r + 1 in its high one (layout/tiling.py), so the same 16-byte load
// carries 32 weights of 16 columns and the lane multiplies them by the two
// neighbouring rows of y. A nibble is sign-extended in place (no bias, no
// 1/16): four low or four high nibbles of a word become four int8 with one
// mask, one multiply and one or.
//
// Group-wise scales (kGroup, scales [G, n], group_size logical rows each):
// the block stages its [G][32] strip of the scales in shared memory, and a
// lane multiplies each weight row by its group's 16 scales before the dot
// (16 multiplies a row whatever M is; a partial sum per group would cost M
// x 16 more registers, which M = 8 does not have). Both nibbles of a byte
// lie in one group, since group_size is even.
//
// Expert gather (expert_ids set): block (x, s) takes the weight and scales
// of expert expert_ids[s] out of a stacked bank and writes output s. The
// id is read from device memory, so the routing never leaves the card. The
// bank is int8 or int4, its scales per-channel [E, n] or group-wise
// [E, G, n]: the gather only moves the two base pointers.
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
// both nibbles of an int4 byte lie in one scale group
static_assert(EETQ_GROUP_GRANULE % 2 == 0, "a scale group holds whole int4 bytes");
static_assert(kLanesN == 2, "the butterfly below reduces over lane bits 1..4");

enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

struct Args {
  const bf16* x;  // [M, k], k % 8 == 0
  int k;
  const int8_t* w;  // [kp, np]; kp counts weight rows: Kp (int8) or Kp / 2 (int4)
  int kp, np;
  const float* scales;  // [n] (plain), [2I] (gate/up) or [groups, n] (group-wise)
  int groups;           // group-wise: rows of scales
  int group_size;       // group-wise: logical K rows per group
  const float* bias;    // [n] or null (plain only)
  const float* gamma;   // [k] or null: RMSNorm prologue
  float eps;
  const bf16* residual;  // [M, n] or null (plain only)
  bf16* out;             // [M, n]; gate/up: h [M, n] with n = I
  int n;
  int up;   // gate/up: column of the up half (= I)
  int act;  // gate/up: Act
  // Expert gather (plain mode), or null: block (x, s) reads expert
  // e = expert_ids[s] (0 <= e < the bank's size) at w + e * w_stride and
  // scales + e * s_stride, and writes out + s * out_stride.
  const int* expert_ids;
  long long w_stride;
  int s_stride;
  long long out_stride;
  int kc;  // rows of y staged at a time (set by launch)
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

template <int M, bool kGateUp, int kBits, bool kGroup>
__global__ void __launch_bounds__(kThreads) gemv_kernel(const Args a) {
  static_assert(kBits == 8 || kBits == 4, "int8 or int4 weights");
  static_assert(!(kGateUp && kGroup), "the fused MLP takes per-channel scales");
  constexpr int kPack = kBits == 4 ? 2 : 1;  // logical K rows per weight row
  extern __shared__ __align__(16) unsigned char smem[];
  // group-wise: this block's [groups][kBlockN] strip of the scales, then y
  float* gs = reinterpret_cast<float*>(smem);
  bf16* ys = reinterpret_cast<bf16*>(  // [kc * kPack][M]
      smem + (kGroup ? (size_t)a.groups * kBlockN * sizeof(float) : 0));
  __shared__ float red[kWarps][M][kBlockN];
  __shared__ float gate_sum[kGateUp ? M : 1][kBlockN];
  __shared__ float part[kWarps][M];
  __shared__ float inv_rms[M];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nl = lane % kLanesN, kr = lane / kLanesN;
  const int kp = a.kp, np = a.np, k = a.k;
  const int8_t* w = a.w;
  const float* scales = a.scales;
  bf16* out = a.out;
  if (a.expert_ids != nullptr) {
    const int e = a.expert_ids[blockIdx.y];
    w += (size_t)e * a.w_stride;
    scales += (size_t)e * a.s_stride;
    out += (size_t)blockIdx.y * a.out_stride;
  }
  // first column of this lane's 16-column strip (the gate strip's, in
  // gate/up mode: the second pass moves it to the up strip)
  const int8_t* wcol = w + blockIdx.x * kBlockN + nl * kColsPerLane;
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

  if constexpr (kGroup) {  // read after the barriers that follow the staging of y
    const int cb = blockIdx.x * kBlockN;
    for (int i = tid; i < a.groups * kBlockN; i += kThreads) {
      const int c = cb + i % kBlockN;
      gs[i] = c < a.n ? scales[(size_t)(i / kBlockN) * a.n + c] : 0.f;
    }
  }

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
  // Stage logical rows [c0, c1) of y as bf16 [c1 - c0][M]; rows from k on
  // are zero.
  auto stage = [&](int c0, int c1) {
    for (int c = c0 + tid * 8; c < c1; c += kThreads * 8) {
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
        for (int i = 0; i < 8; ++i) ys[(c - c0 + i) * M + m] = __float2bfloat16(f[i]);
      }
    }
  };
  // kc (weight rows) is a multiple of a load batch (kSweep * kUnroll rows)
  // unless it is kp, so a batch never straddles two chunks.
  const int kc = a.kc;
  const bool chunked = kc < kp;
  if (!chunked) {
    stage(0, kp * kPack);
    __syncthreads();
  }

  // Group of logical row r: floor((r + 0.5) / group_size) in f32, exact for
  // r < 2^21 (the half keeps the quotient off the integers), without an
  // integer division per row.
  const float inv_group = kGroup ? 1.f / a.group_size : 0.f;
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

#pragma unroll 1
    for (int c0 = 0; c0 < kp; c0 += kc) {
      const int c1 = min(c0 + kc, kp);
      if (chunked) {  // every warp is done with the previous chunk
        __syncthreads();
        stage(c0 * kPack, c1 * kPack);
        __syncthreads();
      }
      for (; k0 < c1; k0 += kSweep * kUnroll) {
        load(nxt, k0 + kSweep * kUnroll);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = k0 + u * kSweep;
          if (kk < kp) {
            const uint32_t wd[4] = {
                static_cast<uint32_t>(cur[u].x), static_cast<uint32_t>(cur[u].y),
                static_cast<uint32_t>(cur[u].z), static_cast<uint32_t>(cur[u].w)};
            const float* sg = nullptr;
            if constexpr (kGroup)  // rows past the last group are zero padding
              sg = gs + nl * kColsPerLane +
                   min(__float2int_rd((kk * kPack + 0.5f) * inv_group), a.groups - 1) * kBlockN;
#pragma unroll
            for (int p = 0; p < kPack; ++p) {  // the logical row kk * kPack + p
              float wf[kColsPerLane];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t b = kBits == 8 ? wd[i]
                                   : p == 0   ? nibbles_to_int8x4<false>(wd[i])
                                              : nibbles_to_int8x4<true>(wd[i]);
                int8x4_to_float(b, wf + 4 * i);
              }
              if constexpr (kGroup) {
#pragma unroll
                for (int j = 0; j < kColsPerLane; ++j) wf[j] *= sg[j];
              }
              const bf16* yr = ys + ((size_t)(kk - c0) * kPack + p) * M;
#pragma unroll
              for (int m = 0; m < M; ++m) {
                const float yv = __bfloat162float(yr[m]);
#pragma unroll
                for (int j = 0; j < kColsPerLane; ++j) acc[m][j] = fmaf(yv, wf[j], acc[m][j]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
      }
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
      const float g = gate_sum[m][c] * scales[ic];
      u *= scales[a.up + ic];
      out[(size_t)m * a.n + ic] = __float2bfloat16(activate(g, a.act) * u);
    }
  } else if (tid < M * kBlockN) {
    const int m = tid / kBlockN, c = tid % kBlockN;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][m][c];
    const int nn = blockIdx.x * kBlockN + c;
    if (nn < a.n) {
      float r = kGroup ? s : s * scales[nn];  // group-wise: scaled row by row
      if (a.bias != nullptr) r += a.bias[nn];
      if (a.residual != nullptr) r += __bfloat162float(a.residual[(size_t)m * a.n + nn]);
      out[(size_t)m * a.n + nn] = __float2bfloat16(r);
    }
  }
}

template <int M, bool kGateUp, int kBits, bool kGroup>
cudaError_t launch(Args a, dim3 grid, cudaStream_t stream) {
  void (*kernel)(const Args) = gemv_kernel<M, kGateUp, kBits, kGroup>;
  // Dynamic shared memory a block may take besides the kernel's static
  // buffers, asked of the device once; and how much of it a launch may use
  // so far (48 KB of static and dynamic together without an opt-in).
  static size_t budget = 0, opted_in = 0;
  if (budget == 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    budget = (size_t)optin - attr.sharedSizeBytes;
    opted_in = 48 * 1024 > attr.sharedSizeBytes ? 48 * 1024 - attr.sharedSizeBytes : 0;
  }
  // The scale strip (group-wise), then all of y if it fits, else the fewest
  // chunks of whole load batches.
  constexpr int kBatch = kSweep * kUnroll;
  constexpr size_t kRowBytes = (size_t)M * (kBits == 4 ? 2 : 1) * sizeof(bf16);  // per weight row
  const size_t fixed = kGroup ? (size_t)a.groups * kBlockN * sizeof(float) : 0;
  if (kGroup && (a.groups < 1 || a.group_size % EETQ_GROUP_GRANULE || fixed >= budget))
    return cudaErrorInvalidValue;
  a.kc = a.kp;
  for (int chunks = 2; fixed + kRowBytes * a.kc > budget; ++chunks) {
    a.kc = (a.kp + chunks - 1) / chunks;
    a.kc = (a.kc + kBatch - 1) / kBatch * kBatch;
    if (a.kc <= kBatch && fixed + kRowBytes * a.kc > budget) return cudaErrorInvalidValue;
  }
  const size_t smem = fixed + kRowBytes * a.kc;
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dispatch on the row count (1..8): one block per 32 columns of the packed
// weight (plain) or of the intermediate dim (gate/up), times `sels` expert
// selections (plain mode with expert_ids).
template <bool kGateUp, int kBits = 8, bool kGroup = false>
cudaError_t launch_m(int m, const Args& a, cudaStream_t stream, int sels = 1) {
  const dim3 grid((kGateUp ? a.up : a.np) / kBlockN, sels);
  switch (m) {
    case 1: return launch<1, kGateUp, kBits, kGroup>(a, grid, stream);
    case 2: return launch<2, kGateUp, kBits, kGroup>(a, grid, stream);
    case 3: return launch<3, kGateUp, kBits, kGroup>(a, grid, stream);
    case 4: return launch<4, kGateUp, kBits, kGroup>(a, grid, stream);
    case 5: return launch<5, kGateUp, kBits, kGroup>(a, grid, stream);
    case 6: return launch<6, kGateUp, kBits, kGroup>(a, grid, stream);
    case 7: return launch<7, kGateUp, kBits, kGroup>(a, grid, stream);
    case 8: return launch<8, kGateUp, kBits, kGroup>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The dense GEMV's C entry points (w8a16_gemv.cu, w4a16_gemv.cu): `rows`
// weight rows (Kp for int8, Kp / 2 for int4), group-wise when groups > 0.
template <int kBits>
int dense_entry(const void* x, int m, int k, const void* w, int rows, int np, const void* scales,
                int groups, int group_size, const void* bias, const void* gamma, float eps,
                void* out, int n, void* stream) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = rows;
  a.np = np;
  a.scales = static_cast<const float*>(scales);
  a.groups = groups;
  a.group_size = group_size;
  a.bias = static_cast<const float*>(bias);
  a.gamma = static_cast<const float*>(gamma);
  a.eps = eps;
  a.out = static_cast<bf16*>(out);
  a.n = n;
  auto s = static_cast<cudaStream_t>(stream);
  return groups > 0 ? launch_m<false, kBits, true>(m, a, s) : launch_m<false, kBits, false>(m, a, s);
}

// The expert gather's C entry points (w8a16_expert_gemv.cu,
// w4a16_expert_gemv.cu): a bank of `rows` weight rows per expert (Kp for
// int8, Kp / 2 for int4), scales [e, n], or [e, groups, n] when groups > 0.
template <int kBits>
int bank_entry(const void* x, int m, int k, const void* w, int rows, int np, const void* scales,
               int groups, int group_size, const void* expert_ids, int sels, void* out, int n,
               void* stream) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = rows;
  a.np = np;
  a.scales = static_cast<const float*>(scales);
  a.groups = groups;
  a.group_size = group_size;
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.expert_ids = static_cast<const int*>(expert_ids);
  a.w_stride = (long long)rows * np;
  a.s_stride = (groups > 0 ? groups : 1) * n;
  a.out_stride = (long long)m * n;
  auto s = static_cast<cudaStream_t>(stream);
  return groups > 0 ? launch_m<false, kBits, true>(m, a, s, sels)
                    : launch_m<false, kBits, false>(m, a, s, sels);
}

}  // namespace gemv
}  // namespace eetq
