// The int8- and int4-weight decode GEMV shared by w8a16_gemv.cu,
// w4a16_gemv.cu, w8a16_expert_gemv.cu, w4a16_expert_gemv.cu, fused_mlp.cu
// and fused_mlp_i4.cu.
//
// out[r, c] = epilogue(sum_k y[r, k] W[k, c] * scale) for 1 <= r < m <= 8
// rows, where y = x, or rmsnorm(x, gamma) rounded to bf16.
//
// Replaces the decode regime (m <= 8) of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call, w8a16_expert_matmul_kernel_call and both
// fused MLP kernels of eetq_tpu/kernels/mlp_fused.py. Bound by the weight
// bytes: 2m operations per int8 byte, 4m per int4 byte, far below the card's
// ratio. Two things kept such a kernel from its bound: multiplying each
// converted weight by every row on the CUDA cores (the time then grows with
// m), and too few bytes in flight where N is small (one block per column
// strip looping over all of K leaves SMs idle at N = 4096). The design:
//
// Tensor cores, one conversion per weight whatever m. The product is
// out^T = W^T y^T on mma.sync m16n8k16 (bf16 in, f32 sums): weight columns
// are the MMA's 16 rows, the (at most 8) rows of y its N = 8; rows of y past
// m are zero and multiplied anyway, so one body serves every m. A register
// of the A operand holds two K-neighbours of one weight column, and it is
// built straight from the coalesced 16-byte weight loads, with no shared
// memory for weights:
//   - lane (g, t) of a warp (g = lane / 4, t = lane % 4) loads four weight
//     rows of a 16-row step, 4t .. 4t + 3, at its 16 columns 16g .. 16g + 15:
//     each load instruction covers four rows of 128 bytes;
//   - the MMA's K order inside a step is permuted so that lane t's four K
//     slots (2t, 2t + 1, 2t + 8, 2t + 9) are rows 4t .. 4t + 3, which makes
//     its B fragment four consecutive values of y, one 8-byte shared load;
//   - MMA j of a step takes the lane's columns 2j and 2j + 1 as its rows g
//     and g + 8, so each lane ends holding the sums of its own 16 columns
//     for rows 2t and 2t + 1 of y, and no permutation is left to undo.
// int8: a byte permute picks the same byte of two rows into one word and two
// lop3 and a packed bf16 subtraction widen it exactly (|q| <= 128): the
// "byte transpose" costs nothing over the widening itself. int4: a byte
// already holds two K-neighbours (rows 2i and 2i + 1, layout/tiling.py), so
// a step takes 16 packed rows (32 logical) in two MMA sub-steps, and a byte
// permute, one lop3 and one packed subtraction make each A register.
//
// A grid that fills the card. A block is 8 warps on 128 weight columns; its
// warps take the 16-row steps of its K range in turns, each issuing the
// loads of its next step (2 KB a warp, 32 KB an SM at two blocks an SM) as
// soon as it has handed one to the tensor cores (two steps kept in flight
// in registers ran 2-11% slower in turns). Where the column strips alone are
// too few for the card, K is split across blocks (gridDim.y, planned by
// kernels/autotune.py::gemv_splits): each block writes its f32 sums to a
// scratch buffer and bumps a per-strip counter; the last block of the strip
// to arrive adds the partials in split order and runs the epilogue, then
// resets the counter for the next launch. One launch, no float atomics: the
// output is the same from run to run. (Tried and dropped: a thread block
// cluster per strip, summed through distributed shared memory, was slower on
// the split shapes.)
//
// Prologue: before its weight loads a block starts cp.async copies of what
// it reads besides the weights, so that they do not queue behind them: the
// rows of x it needs (all of K for the RMSNorm prologue, else its own K
// range) into shared memory as [m][ld] bf16 (ld padded so the 8- or 16-byte
// B loads of a warp hit distinct banks), gamma over its K range and, group-
// wise, the scale rows of its groups. With gamma it then sums each row's
// squares from shared memory and normalizes its K range in place.
//
// Group-wise scales (kGroup, scales [groups, n], group_size a multiple of 32
// logical rows): a step never straddles two groups; its products go into a
// zeroed f32 partial that is folded into the accumulators times the
// column's scale of the step's group, as _dot_scaled (w8a16.py:79-126) sums
// each group's f32 partial times its scale. The scales are never folded
// into the bf16 weights.
//
// Expert gather (expert_ids set): gridDim.z is the selection; block (., ., s)
// reads expert e = expert_ids[s] of a stacked bank and writes output s. The
// id is read on the device, so routing never leaves the card; the gather
// only moves the base pointers (64-bit offsets).
//
// Two modes:
// - plain: out = sum * scale (+ bias) (+ residual), rounded once to bf16.
// - gate/up (the fused MLP's first half): lane groups 0-3 take 64 columns of
//   the gate half of the fused [Kp, 2I] weight and groups 4-7 the matching
//   64 of the up half, in one K loop; the epilogue writes
//   h = act(gate * sg) * (up * su) for 64 intermediate columns, rounded to
//   bf16 where the TPU kernel rounds it (mlp_fused.py:77-80).
#pragma once

#include "hopper.cuh"

namespace eetq {
namespace gemv {
// Internal linkage: six sources include this file, and two builds of it may
// be loaded into one process (a comparison of trees), each with its own
// shared-memory opt-in state.
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;    // weight columns of a block: 8 lane groups x 16
constexpr int kStepRows = 16;   // weight rows of a warp's step: 4 lanes x 4 rows
constexpr int kMaxRows = 8;     // rows of y: the MMA's N
constexpr int kRedLd = kBlockN + 4;  // padded rows of the cross-warp sums
// the fused MLP's slice width (kernels/autotune.py::FUSED_MLP_SLICE): a
// gate/up block owns 64 gate and 64 up columns
static_assert(2 * EETQ_FUSED_MLP_SLICE == kBlockN, "a gate/up block owns 64 + 64 columns");
static_assert(EETQ_GEMV_STEP_ROWS == kStepRows && EETQ_GEMV_BLOCK_N == kBlockN,
              "kernels/autotune.py plans the split in these units");
// a 16-deep (int8) or 32-deep (int4) step lies in one scale group
static_assert(EETQ_GROUP_GRANULE % (2 * kStepRows) == 0, "a step never straddles two groups");

enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

struct Args {
  const bf16* x;  // [m, k], k % 8 == 0
  int m, k;
  const int8_t* w;  // [kp, np]; kp counts weight rows: Kp (int8) or Kp / 2 (int4)
  int kp, np;
  const float* scales;  // [n] (plain), [2I] (gate/up) or [groups, n] (group-wise)
  int groups;           // group-wise: rows of scales
  int group_size;       // group-wise: logical K rows per group
  const float* bias;    // [n] or null (plain only)
  const float* gamma;   // [k] or null: RMSNorm prologue
  float eps;
  const bf16* residual;  // [m, n] or null (plain only)
  bf16* out;             // [m, n]; gate/up: h [m, n] with n = I
  int n;
  int up;   // gate/up: column of the up half (= I)
  int act;  // gate/up: Act
  // Expert gather (plain mode), or null: blocks (., ., s) read expert
  // e = expert_ids[s] (0 <= e < the bank's size) at w + e * w_stride and
  // scales + e * s_stride, and write out + s * out_stride.
  const int* expert_ids;
  long long w_stride;
  long long s_stride;
  long long out_stride;
  // K split (splits > 1): partials f32 [sels, splits, strips, 8, 128],
  // counters int32 [sels, strips], zero before the launch and after it.
  float* partials;
  int* counters;
  int splits;
  // set by launch: shared-memory offsets of gamma's range and of x
  int gam_off, xs_off;
};

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return g / (1.f + expf(-g));
  if (act == kGelu)  // tanh approximation, jax.nn.gelu's default
    return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.f);
}

// 16 bytes of weights, read once: not kept in L1.
__device__ __forceinline__ int4 load_stream(const int8_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// d += A B on the tensor cores (A 16 x 16 and B 16 x 8 bf16, d f32).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Byte `i` of two int8 words (lo: the even K row, hi: the odd one) to an
// exact bf16 pair: under the high byte 0x43 the low seven bits of b read as
// 128 + (b & 127), and the sign bit alone as 128 (b >= 0) or 256 (b < 0).
template <int i>
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi) {
  const uint32_t t = __byte_perm(lo, hi, i | (i << 4) | ((i + 4) << 8) | ((i + 4) << 12));
  return bf16x2_sub((t & 0x007F007Fu) | 0x43004300u, (t & 0x00800080u) | 0x43004300u);
}

// Byte `i` of a word of int4 pairs (w, and w >> 4 as `w4`) to an exact bf16
// pair (low nibble: the even K row). With u the nibble and n = u - 16 [u > 7]
// its value, 0x4300 | (u ^ 8) reads as 128 + n + 8.
template <int i>
__device__ __forceinline__ uint32_t int4_pair(uint32_t w, uint32_t w4) {
  const uint32_t t = __byte_perm(w, w4, i | ((i + 4) << 8));
  return bf16x2_sub((t & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
}

__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

// One step of a lane: the 8 MMAs (int8) or 16 (int4) over its 16 columns.
// Per-channel: into acc. Group-wise: each MMA pair's sums go into a zeroed
// partial, folded into acc times the scales of the columns (sg: this lane's
// 16 scales of the step's group).
template <int kBits, bool kGroup>
__device__ __forceinline__ void step_mma(float (&acc)[8][4], const int4 (&b)[4], const uint4& y,
                                         const float* sg) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // columns 2j (MMA row g) and 2j + 1 (row g + 8)
    const int i = j / 2;         // the word of columns 4i .. 4i + 3
    auto run = [&](float(&d)[4]) {
      if constexpr (kBits == 8) {
        const uint32_t r0 = word(b[0], i), r1 = word(b[1], i), r2 = word(b[2], i),
                       r3 = word(b[3], i);
        if (j % 2 == 0)
          mma_bf16(d, int8_pair<0>(r0, r1), int8_pair<1>(r0, r1), int8_pair<0>(r2, r3),
                   int8_pair<1>(r2, r3), y.x, y.y);
        else
          mma_bf16(d, int8_pair<2>(r0, r1), int8_pair<3>(r0, r1), int8_pair<2>(r2, r3),
                   int8_pair<3>(r2, r3), y.x, y.y);
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s) {  // packed rows 2s (K slots 2t..) and 2s + 1 (2t + 8..)
          const uint32_t p0 = word(b[2 * s], i), p1 = word(b[2 * s + 1], i);
          const uint32_t q0 = p0 >> 4, q1 = p1 >> 4;
          const uint32_t y0 = s == 0 ? y.x : y.z, y1 = s == 0 ? y.y : y.w;
          if (j % 2 == 0)
            mma_bf16(d, int4_pair<0>(p0, q0), int4_pair<1>(p0, q0), int4_pair<0>(p1, q1),
                     int4_pair<1>(p1, q1), y0, y1);
          else
            mma_bf16(d, int4_pair<2>(p0, q0), int4_pair<3>(p0, q0), int4_pair<2>(p1, q1),
                     int4_pair<3>(p1, q1), y0, y1);
        }
      }
    };
    if constexpr (kGroup) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      run(part);
      const float2 s = *reinterpret_cast<const float2*>(sg + 2 * j);
      acc[j][0] = fmaf(part[0], s.x, acc[j][0]);
      acc[j][1] = fmaf(part[1], s.x, acc[j][1]);
      acc[j][2] = fmaf(part[2], s.y, acc[j][2]);
      acc[j][3] = fmaf(part[3], s.y, acc[j][3]);
    } else {
      run(acc[j]);
    }
  }
}

template <int kBits, bool kGateUp, bool kGroup>
__global__ void __launch_bounds__(kThreads, 2) gemv_kernel(const Args a) {
  static_assert(kBits == 8 || kBits == 4, "int8 or int4 weights");
  static_assert(!(kGateUp && kGroup), "the fused MLP takes per-channel scales");
  constexpr int kPack = kBits == 4 ? 2 : 1;
  constexpr int kStepK = kStepRows * kPack;   // logical K rows of a step
  constexpr int kPad = kBits == 8 ? 16 : 32;  // bf16 past each staged row of y
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float fin[kMaxRows * kBlockN];  // the block's sums, then the strip's
  __shared__ float part_ss[kWarps][kMaxRows];
  __shared__ float inv_rms[kMaxRows];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m = a.m, k = a.k, np = a.np;
  const int strip = blockIdx.x, split = blockIdx.y, sel = blockIdx.z;
  const int steps = a.kp / kStepRows;
  const int s0 = split * steps / a.splits, s1 = (split + 1) * steps / a.splits;
  const int k0 = s0 * kStepK, klen = (s1 - s0) * kStepK;  // this block's logical K range

  const int8_t* w = a.w;
  const float* scales = a.scales;
  bf16* out = a.out;
  if (a.expert_ids != nullptr) {
    const long long e = a.expert_ids[sel];
    w += e * a.w_stride;
    scales += e * a.s_stride;
    out += sel * a.out_stride;
  }

  // Asynchronous copies first: x rows [xs0, xs0 + xlen) as bf16 [m][ld]
  // (zeros from k on), gamma over the K range, the group scale rows.
  float* gs = reinterpret_cast<float*>(smem);
  float* gam = reinterpret_cast<float*>(smem + a.gam_off);
  bf16* xs = reinterpret_cast<bf16*>(smem + a.xs_off);
  const bool norm = a.gamma != nullptr;
  const int xs0 = norm ? 0 : k0, xlen = norm ? a.kp * kPack : klen;
  const int ld = (xlen + 63) / 64 * 64 + kPad;
#pragma unroll 1
  for (int r = 0; r < m; ++r) {
    for (int c = tid * 8; c < xlen; c += kThreads * 8) {
      const int kk = xs0 + c;
      hopper::cp_async16(hopper::smem_addr(xs + r * ld + c),
                         a.x + (size_t)r * k + (kk < k ? kk : 0), kk < k ? 16 : 0);
    }
  }
  if (norm) {
    for (int c = tid * 4; c < klen; c += kThreads * 4) {
      const int kk = k0 + c;
      hopper::cp_async16(hopper::smem_addr(gam + c), a.gamma + (kk < k ? kk : 0),
                         kk < k ? 16 : 0);
    }
  }
  int grp0 = 0;
  if constexpr (kGroup) {  // [groups][128] of this block's range
    grp0 = min(k0 / a.group_size, a.groups - 1);  // a range past K reads no scale
    const int grp1 = min((k0 + klen - 1) / a.group_size, a.groups - 1);
    for (int i = tid; i < (grp1 - grp0 + 1) * kBlockN; i += kThreads) {
      const int c = strip * kBlockN + i % kBlockN;
      hopper::cp_async4(hopper::smem_addr(gs + i),
                        scales + (size_t)(grp0 + i / kBlockN) * a.n + (c < a.n ? c : 0),
                        c < a.n ? 4 : 0);
    }
  }
  hopper::cp_async_commit();

  // This lane's 16 columns. Warp w takes steps s0 + w, s0 + w + 8, ...; the
  // loads of its first step are in flight during the prologue.
  const int col = kGateUp ? (g < 4 ? 0 : a.up - kBlockN / 2) + strip * (kBlockN / 2) + 16 * g
                          : strip * kBlockN + 16 * g;
  const int nsteps = s1 - s0 > warp ? (s1 - s0 - warp + kWarps - 1) / kWarps : 0;
  const size_t warp_stride = (size_t)kWarps * kStepRows * np;
  const int8_t* wnext = w + (size_t)((s0 + warp) * kStepRows + 4 * t) * np + col;
  int4 buf[4];
  auto load = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r) buf[r] = load_stream(wnext + (size_t)r * np);
    wnext += warp_stride;
  };
  if (nsteps > 0) load();

  hopper::cp_async_wait<0>();
  __syncthreads();
  if (norm) {  // 1/rms of each row over all of x, then y = x / rms * gamma on the range
    float ss[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) ss[r] = 0.f;
    for (int c = tid * 8; c < k; c += kThreads * 8) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < m) {
          float f[8];
          bf16x8_to_float(*reinterpret_cast<const int4*>(xs + r * ld + c), f);
#pragma unroll
          for (int i = 0; i < 8; ++i) ss[r] = fmaf(f[i], f[i], ss[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      ss[r] = warp_sum(ss[r]);
      if (lane == 0) part_ss[warp][r] = ss[r];
    }
    __syncthreads();
    if (tid < m) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += part_ss[i][tid];
      inv_rms[tid] = rsqrtf(s / k + a.eps);
    }
    __syncthreads();
    for (int c = tid * 8; c < klen; c += kThreads * 8) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < m) {
          int4* v = reinterpret_cast<int4*>(xs + r * ld + k0 + c);
          float f[8];
          bf16x8_to_float(*v, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = f[i] * inv_rms[r] * gam[c + i];
          *v = make_int4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                         pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
        }
      }
    }
    __syncthreads();
  }

  // Main loop: lanes of rows g >= m take a zero B fragment.
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  const bool live = g < m;
  const bf16* yl = xs + (live ? g : 0) * ld + (k0 - xs0) + (kBits == 8 ? 4 : 8) * t;
  // Group of step s: floor((s + 0.5) / steps per group) in f32, exact far
  // past any K here, without an integer division per step.
  const float inv_spg = kGroup ? (float)kStepK / a.group_size : 0.f;
#pragma unroll 1
  for (int st = 0; st < nsteps; ++st) {  // the warp's step, block step warp + 8 st
    const int kr = (warp + st * kWarps) * kStepK;  // its first row of y past k0
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (live) {
      if constexpr (kBits == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(yl + kr);
        y.x = v.x;
        y.y = v.y;
      } else {
        y = *reinterpret_cast<const uint4*>(yl + kr);
      }
    }
    const float* sg = nullptr;
    if constexpr (kGroup) {
      const int grp = __float2int_rd((s0 + warp + st * kWarps + 0.5f) * inv_spg);
      sg = gs + (min(grp, a.groups - 1) - grp0) * kBlockN + 16 * g;
    }
    step_mma<kBits, kGroup>(acc, buf, y, sg);
    if (st + 1 < nsteps) load();
  }

  // The warps' sums to shared memory (over x), then summed in warp order:
  // lane (g, t) holds columns 16g + 2j (acc[j][0, 1]) and 16g + 2j + 1
  // (acc[j][2, 3]) of rows 2t and 2t + 1.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + a.xs_off);  // [kWarps][m][kRedLd]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 16 * g + 2 * j;
    if (2 * t < m)
      *reinterpret_cast<float2*>(red + (warp * m + 2 * t) * kRedLd + c) =
          make_float2(acc[j][0], acc[j][2]);
    if (2 * t + 1 < m)
      *reinterpret_cast<float2*>(red + (warp * m + 2 * t + 1) * kRedLd + c) =
          make_float2(acc[j][1], acc[j][3]);
  }
  __syncthreads();
  for (int i = tid; i < m * kBlockN; i += kThreads) {
    const int r = i / kBlockN, c = i % kBlockN;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[(v * m + r) * kRedLd + c];
    fin[i] = s;
  }

  if (a.splits > 1) {  // the last block of the strip adds the partials in split order
    const size_t slot = kMaxRows * kBlockN;
    const size_t strip_base = ((size_t)sel * a.splits * gridDim.x + strip) * slot;
    float* mine = a.partials + strip_base + (size_t)split * gridDim.x * slot;
    for (int i = tid; i < m * kBlockN; i += kThreads) mine[i] = fin[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* ctr = a.counters + (size_t)sel * gridDim.x + strip;
      is_last = atomicAdd(ctr, 1) == a.splits - 1;
      if (is_last) *ctr = 0;  // for the next launch
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int i = tid; i < m * kBlockN; i += kThreads) {
      float s = 0.f;
      for (int sp = 0; sp < a.splits; ++sp)
        s += __ldcg(a.partials + strip_base + (size_t)sp * gridDim.x * slot + i);
      fin[i] = s;
    }
  }
  __syncthreads();

  if constexpr (kGateUp) {
    constexpr int kHalf = kBlockN / 2;
    for (int i = tid; i < m * kHalf; i += kThreads) {
      const int r = i / kHalf, c = i % kHalf;
      const int ic = strip * kHalf + c;
      const float gate = fin[r * kBlockN + c] * scales[ic];
      const float upv = fin[r * kBlockN + kHalf + c] * scales[a.up + ic];
      out[(size_t)r * a.n + ic] = __float2bfloat16(activate(gate, a.act) * upv);
    }
  } else {
    for (int i = tid; i < m * kBlockN; i += kThreads) {
      const int r = i / kBlockN, nn = strip * kBlockN + i % kBlockN;
      if (nn < a.n) {
        float v = kGroup ? fin[i] : fin[i] * scales[nn];  // group-wise: scaled step by step
        if (a.bias != nullptr) v += a.bias[nn];
        if (a.residual != nullptr) v += __bfloat162float(a.residual[(size_t)r * a.n + nn]);
        out[(size_t)r * a.n + nn] = __float2bfloat16(v);
      }
    }
  }
}

// One launch over `strips` column strips x a.splits K ranges x `sels`
// expert selections.
template <int kBits, bool kGateUp, bool kGroup>
cudaError_t launch(Args a, int strips, int sels, cudaStream_t stream) {
  void (*kernel)(const Args) = gemv_kernel<kBits, kGateUp, kGroup>;
  constexpr int kPack = kBits == 4 ? 2 : 1;
  constexpr int kStepK = kStepRows * kPack;
  constexpr int kPad = kBits == 8 ? 16 : 32;
  const int steps = a.kp / kStepRows;
  if (a.m < 1 || a.m > kMaxRows || a.kp % kStepRows || a.np % kBlockN || a.splits < 1 ||
      a.splits > steps || a.splits > 65535 || sels < 1 || sels > 65535 ||
      (a.splits > 1 && (a.partials == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  if (kGroup && (a.groups < 1 || a.group_size % EETQ_GROUP_GRANULE)) return cudaErrorInvalidValue;
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
  // The longest K range of a block: its scale rows (group-wise: at most
  // klen / g + 2 groups), gamma over it, then x (all of K with gamma), or
  // later the warps' sums, over x.
  const int klen = (steps + a.splits - 1) / a.splits * kStepK;
  const int xlen = a.gamma != nullptr ? a.kp * kPack : klen;
  const size_t scale_bytes =
      kGroup ? (size_t)(klen / a.group_size + 2) * kBlockN * sizeof(float) : 0;
  const size_t gam_bytes = a.gamma != nullptr ? (size_t)klen * sizeof(float) : 0;
  const size_t x_bytes = (size_t)a.m * ((xlen + 63) / 64 * 64 + kPad) * sizeof(bf16);
  const size_t red_bytes = (size_t)kWarps * a.m * kRedLd * sizeof(float);
  const size_t smem = scale_bytes + gam_bytes + (x_bytes > red_bytes ? x_bytes : red_bytes);
  if (smem > budget) return cudaErrorInvalidValue;
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  a.gam_off = (int)scale_bytes;
  a.xs_off = (int)(scale_bytes + gam_bytes);
  kernel<<<dim3(strips, a.splits, sels), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The dense GEMV's C entry points (w8a16_gemv.cu, w4a16_gemv.cu): `rows`
// weight rows (Kp for int8, Kp / 2 for int4), group-wise when groups > 0.
template <int kBits>
int dense_entry(const void* x, int m, int k, const void* w, int rows, int np, const void* scales,
                int groups, int group_size, const void* bias, const void* gamma, float eps,
                void* out, int n, void* partials, void* counters, int splits, void* stream) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.m = m;
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
  a.partials = static_cast<float*>(partials);
  a.counters = static_cast<int*>(counters);
  a.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  return groups > 0 ? launch<kBits, false, true>(a, np / kBlockN, 1, s)
                    : launch<kBits, false, false>(a, np / kBlockN, 1, s);
}

// The expert gather's C entry points (w8a16_expert_gemv.cu,
// w4a16_expert_gemv.cu): a bank of `rows` weight rows per expert (Kp for
// int8, Kp / 2 for int4), scales [e, n], or [e, groups, n] when groups > 0.
template <int kBits>
int bank_entry(const void* x, int m, int k, const void* w, int rows, int np, const void* scales,
               int groups, int group_size, const void* expert_ids, int sels, void* out, int n,
               void* partials, void* counters, int splits, void* stream) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.m = m;
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
  a.s_stride = (long long)(groups > 0 ? groups : 1) * n;
  a.out_stride = (long long)m * n;
  a.partials = static_cast<float*>(partials);
  a.counters = static_cast<int*>(counters);
  a.splits = splits;
  auto s = static_cast<cudaStream_t>(stream);
  return groups > 0 ? launch<kBits, false, true>(a, np / kBlockN, sels, s)
                    : launch<kBits, false, false>(a, np / kBlockN, sels, s);
}

// The fused MLP's C entry points (fused_mlp.cu, fused_mlp_i4.cu): the
// gate/up launch writes h, the plain launch reads it. kp is the logical
// padded K of the gate/up weight, i the intermediate width.
template <int kBits>
int mlp_entry(const void* x, int m, int k, const void* gamma, float eps, const void* gu, int kp,
              int i, const void* gu_scales, const void* d, int np, const void* d_scales,
              const void* residual, void* h, void* out, int n, int act, void* partials,
              void* counters, int gu_splits, int d_splits, void* stream) {
  constexpr int kPack = kBits == 4 ? 2 : 1;
  auto s = static_cast<cudaStream_t>(stream);
  Args g{};
  g.x = static_cast<const bf16*>(x);
  g.m = m;
  g.k = k;
  g.w = static_cast<const int8_t*>(gu);
  g.kp = kp / kPack;
  g.np = 2 * i;
  g.scales = static_cast<const float*>(gu_scales);
  g.gamma = static_cast<const float*>(gamma);
  g.eps = eps;
  g.out = static_cast<bf16*>(h);
  g.n = i;
  g.up = i;
  g.act = act;
  g.partials = static_cast<float*>(partials);
  g.counters = static_cast<int*>(counters);
  g.splits = gu_splits;
  cudaError_t err = launch<kBits, true, false>(g, i / (kBlockN / 2), 1, s);
  if (err != cudaSuccess) return err;

  Args dn{};
  dn.x = static_cast<const bf16*>(h);
  dn.m = m;
  dn.k = i;
  dn.w = static_cast<const int8_t*>(d);
  dn.kp = i / kPack;
  dn.np = np;
  dn.scales = static_cast<const float*>(d_scales);
  dn.residual = static_cast<const bf16*>(residual);
  dn.out = static_cast<bf16*>(out);
  dn.n = n;
  dn.partials = static_cast<float*>(partials);
  dn.counters = static_cast<int*>(counters);
  dn.splits = d_splits;
  return launch<kBits, false, false>(dn, np / kBlockN, 1, s);
}

}  // namespace
}  // namespace gemv
}  // namespace eetq
