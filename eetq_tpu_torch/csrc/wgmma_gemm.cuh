// The dense W8A16 / W4A16 GEMM tile for Hopper, per-channel or group-wise
// scales: out[m, n] = (x[m, :] . W[:, n]) * scale[n] + bias[n], or
// sum over groups of (x[m, group] . W[group, n]) * scale[g, n] + bias[n].
// Used by w8a16_gemm.cu and w4a16_gemm.cu for m > 8.
//
// Replaces the prefill regime of eetq_tpu/kernels/w8a16.py::
// w8a16_matmul_kernel_call. Bound by tensor-core operations at prefill
// sizes (2 m operations per weight byte). What the tile must keep out of
// the multiply's way is the widening of the weights: it costs about two
// operations per weight of a tile whatever the tile's rows, so the tile is
// 256 rows tall (each converted weight tile is multiplied by 256 rows of x,
// not 128; a 128 x 128 and a 128 x 256 tile ran 1.2-1.25 times slower), and
// two warpgroups do nothing else.
//
// Design. A block of four warpgroups (512 threads) computes a 256 x 128
// output tile (128 x 128 where m <= 128) in K steps of 64 through three
// rings in dynamic shared memory: x tiles (four slots), converted weight
// tiles (four) and packed weight tiles (three).
//   - Warpgroups 2 and 3 are the producers. For each K step they copy the x
//     tile (rows x 64 bf16) by cp.async straight into the 128-byte-swizzled
//     K-major layout wgmma reads (hopper.cuh), and the weight tile (64 x 128
//     int8, or 32 x 128 bytes of int4 pairs) by cp.async, still packed, into
//     the staging ring. Two K steps later they convert the weight tile once
//     for the whole block to bf16 (exact: |q| <= 128) into the swizzled rows
//     of a slot of the weight ring, execute fence.proxy.async and arrive on
//     the step's `full` mbarrier, one lane per warp. Each thread converts the
//     bytes it copied itself, so cp.async.wait_group is all the
//     synchronisation the staging ring needs. cp.async and not TMA: the x
//     tile's edges (rows past m, columns past K) are zero-filled by the
//     copy's source size, and no tensor map has to be encoded per call for
//     shapes that change with every prompt bucket.
//   - Warpgroups 0 and 1 are the consumers, 128 (or 64) rows each: per K
//     step four times two (or one) wgmma m64n128k16 (A: 64 of the x rows,
//     K-major; B: the converted weights as they lie in memory, [k][n] with n
//     contiguous, read MN-major through the descriptor's transpose bit), f32
//     accumulators in registers (128 a thread), one group kept in flight; the
//     slots of a step go back to the producers through their `empty`
//     mbarriers when the group that read them has finished. No wgmma, and no
//     read of its registers, sits under a branch: ptxas serializes every
//     wgmma of a kernel in which it finds one it cannot prove uniform
//     (warning C7520), so rows past m are multiplied too (they are zero).
//   - setmaxnreg: a block of 512 threads starts with 128 registers a thread,
//     fewer than the consumers' accumulators and addresses need (without it
//     the accumulators spill and the kernel runs at a tenth of its rate);
//     the producers drop to 88 and the consumers rise to 168.
//   - out = x W was taken, not out^T = W^T x^T with the weights as the
//     register A operand: W is stored n-contiguous, which the MN-major B
//     operand reads after a widening in place, while an A fragment pairs two
//     K rows per register and would need a byte transpose of every tile.
//   - Epilogue: scale[n] and bias[n] on the accumulator registers, bf16
//     through shared memory, 16-byte stores (scalar stores where n is not a
//     multiple of 8 and rows are not 16-byte aligned). With an activation or
//     a residual (kEpi, a kernel of its own: the bias-only kernel is left as
//     it was) the tile goes through shared memory in f32 instead, and the
//     store loop applies act(.) and the residual's add or multiply to each
//     value, the residual read in 16-byte rows beside the output's, then
//     rounds once to bf16, as the TPU kernel's epilogue (w8a16.py:213-230).
//     The activation and the residual mode are kernel parameters, read only
//     there, after the last wgmma and away from any accumulator register.
//
// Group-wise scales ([groups, n], group_size a multiple of 32): each
// consumer's two 64-row halves keep their open group's f32 sum in registers
// beside the accumulators; a group's first 16-deep slice overwrites it
// (wgmma's scale-d = 0), and when the group's products are done the
// consumer adds part * scale[g, n] to the accumulators, group after group,
// as _dot_scaled (w8a16.py:79-126) does. The two halves' products are
// committed apart and their folds alternate (hopper.cuh::staggered_groups),
// so one half's fold runs while the other half's products are in flight and
// the tensor cores do not drain at each group's end. The scales are never
// folded into the bf16 weights (that would round bf16(q * s) where the
// reference sums in f32). Two 128-float sets do not fit beside the addresses
// in 168 registers, so the group-wise tile is 256 x 64: half the columns,
// each converted weight still multiplied by 256 rows (a 128 x 128 tile ran
// 5-15% slower in turns). The producers copy the scale rows of each 32-deep
// half step with the x tile (cp.async, 4 bytes each, zero past n). A group
// of whole K steps (g = 64, 128) is a unit of one step; other multiples of
// 32 (32, 96) take units of half a step, in a kernel of their own.
//
// Row blocks vary fastest over the grid, so the blocks that share a weight
// strip run together and W streams from device memory once.
#pragma once

#include "hopper.cuh"

namespace eetq {
namespace wgmma_gemm {

using namespace eetq::hopper;

constexpr int kBK = 64, kSlices = kBK / 16;
constexpr int kXSlots = 4, kWSlots = 4, kRawSlots = 3;
constexpr int kLookahead = 2;  // K steps between a weight tile's copy and its conversion
static_assert(kRawSlots > kLookahead && kLookahead >= 1, "a packed tile outlives its lookahead");
constexpr int kConsumers = 256, kProducers = 256, kThreads = kConsumers + kProducers;
constexpr int kBarriers = 2 * kXSlots + kWSlots;  // full and empty per x slot, empty per W slot

// The layout of one design's dynamic shared memory: kHalves 64-row halves a
// consumer warpgroup (a tile of 128 kHalves rows) by kBN columns.
template <int kHalves, int kBN, bool kGroup>
struct Tile {
  static constexpr int kBM = 128 * kHalves;
  static constexpr int kXBytes = kBM * kBK * 2;   // x tile, bf16
  static constexpr int kWBytes = kBK * kBN * 2;   // converted weight tile, bf16
  static constexpr int kRawBytes = kBK * kBN;     // packed weight tile as copied (int4 uses half)
  static constexpr int kScaleBytes = kGroup ? kBK / 32 * kBN * 4 : 0;  // rows of each half step
  static constexpr int kWOff = kXSlots * kXBytes;
  static constexpr int kRawOff = kWOff + kWSlots * kWBytes;
  static constexpr int kScaleOff = kRawOff + kRawSlots * kRawBytes;
  static constexpr int kBarOff = kScaleOff + kXSlots * kScaleBytes;
  static constexpr int kSmemBytes = kBarOff + kBarriers * 8 + 1024;
  static constexpr int kOutLd = kBN + 8;  // padded rows of the output staging
  static constexpr int kOutLdF = kBN + 4;  // ... in f32 (kEpi)
  static_assert(kBM * kOutLd * 2 <= kRawOff, "output staging fits the rings");
  static_assert(kBM * kOutLdF * 4 <= kRawOff, "f32 output staging fits the rings");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

struct Args {
  const bf16* x;  // [m, k], k % 8 == 0
  int m, k;
  const int8_t* w;  // [kp, np] (int4: [kp / 2, np]); kp, np % 128 == 0
  int kp, np;
  const float* scales;  // [n], or [groups, n]
  int groups, group_size;
  const float* bias;    // [n] or null
  int act;              // kEpi: the activation (common.cuh)
  const bf16* residual;  // kEpi: [m, n] or null, added or multiplied (res_mul)
  int res_mul;
  bf16* out;            // [m, n]
  int n;
};

// Two int8 of a word (bytes picked by `sel`, one under 0x43 each) to two
// exact bf16 in a word, with no conversion instruction: under the high byte
// 0x43 the low seven bits of b read as the bf16 128 + (b & 127), and the
// sign bit alone as 128 (b >= 0) or 256 (b < 0); their difference is b.
// The bf16 counterpart of int8x4_to_float (common.cuh): one byte permute,
// two masks and one packed subtraction per pair.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0x43434343u, sel);
  const uint32_t a = t & 0xFF7FFF7Fu, c = t & 0xFF80FF80u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Sixteen int8 (one 16-byte vector) to two 16-byte vectors of bf16.
__device__ __forceinline__ void int8x16_to_bf16(const int4& raw, uint4& lo, uint4& hi) {
  const uint32_t w0 = raw.x, w1 = raw.y, w2 = raw.z, w3 = raw.w;
  lo = make_uint4(int8x2_to_bf16x2(w0, 0x4140), int8x2_to_bf16x2(w0, 0x4342),
                  int8x2_to_bf16x2(w1, 0x4140), int8x2_to_bf16x2(w1, 0x4342));
  hi = make_uint4(int8x2_to_bf16x2(w2, 0x4140), int8x2_to_bf16x2(w2, 0x4342),
                  int8x2_to_bf16x2(w3, 0x4140), int8x2_to_bf16x2(w3, 0x4342));
}

// Sixteen bytes of int4 pairs (byte i: K rows 2r and 2r + 1 of column i)
// to the two bf16 rows, eight columns per vector. With u the nibble and
// n = u - 16 [u > 7] its value, 0x4300 | (u ^ 8) reads as the bf16 128 + n + 8
// and 136 is subtracted: a byte permute, a shift, two lop3 and two packed
// subtractions per two columns of both rows.
__device__ __forceinline__ void int4x16_to_bf16(const int4& raw, uint4& lo0, uint4& hi0,
                                                uint4& lo1, uint4& hi1) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
  uint32_t even[8], odd[8];
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t t = __byte_perm(w[i / 2], 0u, (i & 1) ? 0x4342 : 0x4140);
    const uint32_t a = (t & 0x000F000Fu) ^ 0x43084308u, b = ((t >> 4) & 0x000F000Fu) ^ 0x43084308u;
    const __nv_bfloat162 ra = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), bias);
    const __nv_bfloat162 rb = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), bias);
    even[i] = *reinterpret_cast<const uint32_t*>(&ra);
    odd[i] = *reinterpret_cast<const uint32_t*>(&rb);
  }
  lo0 = make_uint4(even[0], even[1], even[2], even[3]);
  hi0 = make_uint4(even[4], even[5], even[6], even[7]);
  lo1 = make_uint4(odd[0], odd[1], odd[2], odd[3]);
  hi1 = make_uint4(odd[4], odd[5], odd[6], odd[7]);
}

__device__ __forceinline__ void store16(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
// Chunks 2c and 2c + 1 (mod 8) of swizzled row `row` of the block at `blk`.
// The eight threads of a row write two blocks whose chunks share their
// banks, so threads c < 4 store the even chunk first and the others the odd
// one: each store instruction then covers eight distinct chunk positions.
__device__ __forceinline__ void store_pair(uint32_t blk, int row, int c, const uint4& lo,
                                           const uint4& hi) {
  const bool even_first = (c & 4) == 0;
  const int e = (2 * c) & 7;
  store16(blk + swizzle128(row, even_first ? e : e + 1), even_first ? lo : hi);
  store16(blk + swizzle128(row, even_first ? e + 1 : e), even_first ? hi : lo);
}
__device__ __forceinline__ int4 load16(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Internal linkage: two sources include this file.
namespace {

// kUnits: 0 for per-channel scales; else the group-wise mode, whose groups
// close after units of kSlices / kUnits slices (1: whole K steps, 2: halves).
// kHalves 64-row halves a consumer warpgroup, kBN columns; kEpi: the
// activation and residual epilogue.
template <int kBits, int kHalves, int kBN, int kUnits, bool kEpi>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Args a) {
  static_assert(kBits == 8 || kBits == 4, "int8 or int4 weights");
  static_assert(kUnits == 0 || kUnits == 1 || kUnits == 2, "a unit is a step or half a step");
  using T = Tile<kHalves, kBN, kUnits != 0>;
  constexpr int kBM = T::kBM;
  constexpr int kChunksPerRow = kBN / 16;  // 16-byte chunks of a packed weight row
  constexpr int kRawChunks = (kBits == 8 ? kBK : kBK / 2) * kChunksPerRow;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const generic = smem_raw + (base - smem_addr(smem_raw));
  auto xs = [&](int step) { return base + (step % kXSlots) * T::kXBytes; };
  auto ws = [&](int step) { return base + T::kWOff + (step % kWSlots) * T::kWBytes; };
  auto raw = [&](int step) { return base + T::kRawOff + (step % kRawSlots) * T::kRawBytes; };
  auto sc = [&](int step) { return base + T::kScaleOff + (step % kXSlots) * T::kScaleBytes; };
  // a step's tiles are ready; its x (and scale) slot, its weight slot are free
  auto full = [&](int step) { return base + T::kBarOff + (step % kXSlots) * 8; };
  auto x_free = [&](int step) { return base + T::kBarOff + (kXSlots + step % kXSlots) * 8; };
  auto w_free = [&](int step) { return base + T::kBarOff + (2 * kXSlots + step % kWSlots) * 8; };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = a.kp / kBK;
  if (tid == 0) {
    for (int i = 0; i < kXSlots; ++i) {
      mbar_init(full(i), kProducers / 32);    // one lane of every producer warp
      mbar_init(x_free(i), kConsumers / 32);  // one lane of every consumer warp
    }
    for (int i = 0; i < kWSlots; ++i) mbar_init(w_free(i), kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producers: copy, convert, hand over ----
    setmaxnreg_dec<88>();
    const int p = tid - kConsumers;
    const int rows = min(kBM, a.m - m0);
    for (int it = 0; it < nk + kLookahead; ++it) {
      const int j = it - kLookahead;  // convert step j, then copy step it
      if (j >= 0) {
        mbar_wait(w_free(j), ((j / kWSlots) & 1) ^ 1);  // passes at once on the first round
        cp_async_wait<kLookahead - 1>();  // this thread's copies of step j have landed
        // chunk c of a packed row holds columns 16c .. 16c + 15: chunks 2c
        // and 2c + 1 (mod 8) of the bf16 row, in 64-column block c >> 2. All
        // loads first, then the arithmetic, then all stores: the shared-memory
        // latencies overlap
        constexpr int kMine = (kRawChunks + kProducers - 1) / kProducers;
        int4 v[kMine];
#pragma unroll
        for (int i = 0; i < kMine; ++i)
          if (p + i * kProducers < kRawChunks) v[i] = load16(raw(j) + (p + i * kProducers) * 16);
        uint4 lo[kMine * (kBits == 8 ? 1 : 2)], hi[kMine * (kBits == 8 ? 1 : 2)];
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          if constexpr (kBits == 8) {
            int8x16_to_bf16(v[i], lo[i], hi[i]);
          } else {  // byte row r: K rows 2r (low nibbles), 2r + 1 (high)
            int4x16_to_bf16(v[i], lo[2 * i], hi[2 * i], lo[2 * i + 1], hi[2 * i + 1]);
          }
        }
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const int idx = p + i * kProducers, row = idx / kChunksPerRow, c = idx % kChunksPerRow;
          if (idx >= kRawChunks) break;
          const uint32_t blk = ws(j) + (c >> 2) * (kBK * 128);
          if constexpr (kBits == 8) {
            store_pair(blk, row, c, lo[i], hi[i]);
          } else {
            store_pair(blk, 2 * row, c, lo[2 * i], hi[2 * i]);
            store_pair(blk, 2 * row + 1, c, lo[2 * i + 1], hi[2 * i + 1]);
          }
        }
        fence_proxy_async();  // the x copies and the stores above, for wgmma
        __syncwarp();         // every lane's, before the warp's one arrival
        if ((tid & 31) == 0) mbar_arrive(full(j));
      }
      if (it < nk) {
        const int k0 = it * kBK;
        mbar_wait(x_free(it), ((it / kXSlots) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < kBM * 8 / kProducers; ++i) {  // x: kBM rows x 8 chunks of 8 bf16
          const int idx = p + i * kProducers, row = idx >> 3, c = idx & 7, gk = k0 + c * 8;
          const bool ok = row < rows && gk < a.k;  // rows past m and columns past K are zero
          const bf16* src = ok ? a.x + (size_t)(m0 + row) * a.k + gk : a.x;
          cp_async16(xs(it) + swizzle128(row, c), src, ok ? 16 : 0);
        }
        const int k0_rows = kBits == 8 ? k0 : k0 / 2;
#pragma unroll
        for (int i = 0; i < (kRawChunks + kProducers - 1) / kProducers; ++i) {  // W, packed
          const int idx = p + i * kProducers, row = idx / kChunksPerRow, c = idx % kChunksPerRow;
          if (idx >= kRawChunks) break;
          cp_async16(raw(it) + idx * 16, a.w + (size_t)(k0_rows + row) * a.np + n0 + c * 16, 16);
        }
        if constexpr (kUnits != 0) {  // the scale row of each 32-deep half of the step
          for (int idx = p; idx < kBK / 32 * kBN; idx += kProducers) {
            const int h = idx / kBN, gn = n0 + idx % kBN;
            const int gi = min((k0 + 32 * h) / a.group_size, a.groups - 1);
            const bool ok = gn < a.n;
            cp_async4(sc(it) + idx * 4, ok ? a.scales + (size_t)gi * a.n + gn : a.scales,
                      ok ? 4 : 0);
          }
        }
      }
      cp_async_commit();  // one group per step, empty past the end
    }
    return;
  }

  // ---- consumers: 64 kHalves rows x kBN columns each ----
  setmaxnreg_inc<168>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // half h: element 4j + e at row 64 (kHalves wg + h) + 16 warp + g (+ 8 for
  // e >= 2), column 8j + 2t + (e & 1)
  constexpr int kAcc = kBN / 2;
  float acc[kHalves][kAcc], part[kUnits != 0 ? kHalves : 1][kUnits != 0 ? kAcc : 1];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[h][i] = 0.f;
  // one 16-deep slice s of step kt for half h into d; scale_d = 0 starts a new sum
  auto mma = [&](float(&d)[kAcc], int kt, int h, int s, int scale_d) {
    const uint64_t da = smem_desc(xs(kt) + (64 * (kHalves * wg + h)) * 128 + s * 32, 16, 1024);
    const uint64_t db = smem_desc(ws(kt) + s * 2048, kBK * 128, 1024);
    if constexpr (kBN == 128) wgmma_ss_n128<0, 1>(d, da, db, scale_d);
    else wgmma_ss_n64<0, 1>(d, da, db, scale_d);
  };
  // step kt - 1 has been multiplied: its slots go back to the producers
  auto release = [&](int kt) {
    if (kt > 0 && lane == 0) {
      mbar_arrive(x_free(kt - 1));
      mbar_arrive(w_free(kt - 1));
    }
  };
  if constexpr (kUnits == 0) {
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full(kt), (kt / kXSlots) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSlices; ++s)
#pragma unroll
        for (int h = 0; h < kHalves; ++h) mma(acc[h], kt, h, s, 1);
      wgmma_commit();
      wgmma_wait<1>();  // at most this step's group pending
      release(kt);
    }
    wgmma_wait<0>();
  } else {
    static_assert(kHalves == 2, "the group folds of the two halves alternate");
    constexpr int kUnitSlices = kSlices / kUnits;
    auto issue = [&](auto half, int u, int first) {
      constexpr int h = decltype(half)::value;
      const int kt = u / kUnits, s0 = (u % kUnits) * kUnitSlices;
      if (h == 0 && s0 == 0) mbar_wait(full(kt), (kt / kXSlots) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kUnitSlices; ++s) mma(part[h], kt, h, s0 + s, !first || s != 0);
      wgmma_commit();
    };
    // acc += part * the scale row of unit u's last 32-deep half step
    auto fold = [&](auto half, int u) {
      constexpr int h = decltype(half)::value;
      fence_registers(part[h]);
      const int row = (u % kUnits + 1) * (kBK / 32 / kUnits) - 1;
      const float* sr =
          reinterpret_cast<const float*>(generic + (sc(u / kUnits) - base)) + row * kBN;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sr + 8 * j + 2 * t);
        acc[h][4 * j] = fmaf(part[h][4 * j], s2.x, acc[h][4 * j]);
        acc[h][4 * j + 1] = fmaf(part[h][4 * j + 1], s2.y, acc[h][4 * j + 1]);
        acc[h][4 * j + 2] = fmaf(part[h][4 * j + 2], s2.x, acc[h][4 * j + 2]);
        acc[h][4 * j + 3] = fmaf(part[h][4 * j + 3], s2.y, acc[h][4 * j + 3]);
      }
    };
    auto after = [&](int u) {
      if (u % kUnits == 0) release(u / kUnits);
    };
    staggered_groups(nk * kUnits, a.group_size / (16 * kUnitSlices), issue, fold, after);
  }
#pragma unroll
  for (int h = 0; h < kHalves; ++h) fence_registers(acc[h]);

  // epilogue: per-channel scale (group-wise: already applied) and bias
  const int r0 = 64 * kHalves * wg + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + j * 8 + 2 * t + e;
      const float s = kUnits != 0 ? 1.f : (gn < a.n ? a.scales[gn] : 0.f);
      const float bi = (a.bias != nullptr && gn < a.n) ? a.bias[gn] : 0.f;
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        acc[h][4 * j + e] = fmaf(acc[h][4 * j + e], s, bi);
        acc[h][4 * j + 2 + e] = fmaf(acc[h][4 * j + 2 + e], s, bi);
      }
    }
  }
  if (a.n % 8) {  // rows of out are not 16-byte aligned
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + r0 + 64 * h + 8 * (e >> 1), gn = n0 + j * 8 + 2 * t + (e & 1);
          if (row < a.m && gn < a.n) {
            const size_t i = (size_t)row * a.n + gn;
            float v = acc[h][4 * j + e];
            if constexpr (kEpi) {
              v = activate(v, a.act);
              if (a.residual != nullptr) v = combine(v, __bfloat162float(a.residual[i]), a.res_mul);
            }
            a.out[i] = __float2bfloat16(v);
          }
        }
      }
    }
    return;
  }
  named_barrier(1, kConsumers);  // both warpgroups have read their last slots
  if constexpr (kEpi) {  // f32 through shared memory, the epilogue in the store loop
    float* stage = reinterpret_cast<float*>(generic);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(stage + (r0 + 64 * h + 8 * r) * T::kOutLdF + j * 8 + 2 * t) =
              make_float2(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
      }
    }
    named_barrier(1, kConsumers);
    for (int idx = tid; idx < kBM * (kBN / 8); idx += kConsumers) {
      const int r = idx / (kBN / 8), c = idx % (kBN / 8);
      if (m0 + r < a.m && n0 + c * 8 < a.n) {
        const size_t o = (size_t)(m0 + r) * a.n + n0 + c * 8;
        float f[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = activate(stage[r * T::kOutLdF + c * 8 + i], a.act);
        if (a.residual != nullptr) {
          float res[8];
          bf16x8_to_float(*reinterpret_cast<const int4*>(a.residual + o), res);
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = combine(f[i], res[i], a.res_mul);
        }
        *reinterpret_cast<int4*>(a.out + o) = make_int4(
            pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
            pack_bf16x2(f[6], f[7]));
      }
    }
    return;
  }
  bf16* stage = reinterpret_cast<bf16*>(generic);
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 64 * h + 8 * r) * T::kOutLd + j * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
    }
  }
  named_barrier(1, kConsumers);
  for (int idx = tid; idx < kBM * (kBN / 8); idx += kConsumers) {
    const int r = idx / (kBN / 8), c = idx % (kBN / 8);
    if (m0 + r < a.m && n0 + c * 8 < a.n)
      *reinterpret_cast<int4*>(a.out + (size_t)(m0 + r) * a.n + n0 + c * 8) =
          *reinterpret_cast<const int4*>(stage + r * T::kOutLd + c * 8);
  }
}

// One block per kBM rows (fastest) and per kBN output columns.
template <int kBits, int kHalves, int kBN, int kUnits, bool kEpi>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  using T = Tile<kHalves, kBN, kUnits != 0>;
  auto kernel = gemm_kernel<kBits, kHalves, kBN, kUnits, kEpi>;
  static bool opted_in = false;  // above 48 KB of dynamic shared memory
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int strips = a.np / kBN;
  if (a.m < 1 || strips < 1 || strips > 65535 || a.np % kBN || a.kp % kBK)
    return cudaErrorInvalidValue;
  kernel<<<dim3((a.m + T::kBM - 1) / T::kBM, strips), kThreads, T::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// The design for the call: per-channel scales on the 256 x 128 tile (128 x
// 128 where one 128-row block holds m), group-wise on the 256 x 64 one.
// tile_m 0 keeps that rule; 128 or 256 picks the per-channel tile's rows
// (kernels/autotune.py's measured choice); the group-wise tile has 256 rows
// only.
template <int kBits, bool kEpi>
cudaError_t launch(const Args& a, int tile_m, cudaStream_t stream) {
  if (a.groups == 0) {
    if (tile_m == 0) tile_m = a.m <= 128 ? 128 : 256;
    if (tile_m == 128) return launch_tile<kBits, 1, 128, 0, kEpi>(a, stream);
    if (tile_m == 256) return launch_tile<kBits, 2, 128, 0, kEpi>(a, stream);
    return cudaErrorInvalidValue;
  }
  if (tile_m != 0 && tile_m != 256) return cudaErrorInvalidValue;
  if (a.group_size < EETQ_GROUP_GRANULE || a.group_size % EETQ_GROUP_GRANULE)
    return cudaErrorInvalidValue;
  return a.group_size % kBK == 0 ? launch_tile<kBits, 2, 64, 1, kEpi>(a, stream)
                                 : launch_tile<kBits, 2, 64, 2, kEpi>(a, stream);
}

// The dense GEMM's C entry points (w8a16_gemm.cu, w4a16_gemm.cu); scales
// [n], or [groups, n] when groups > 0; the epilogue's activation `act` and
// residual (or null), multiplied where res_mul is set; tile_m the tile's
// rows (0: the rule of `launch`).
template <int kBits>
int dense_entry(const void* x, int m, int k, const void* w, int kp, int np, const void* scales,
                int groups, int group_size, const void* bias, int act, const void* residual,
                int res_mul, void* out, int n, int tile_m, void* stream) {
  if (act < kActSilu || act > kActNone) return cudaErrorInvalidValue;
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
  a.act = act;
  a.residual = static_cast<const bf16*>(residual);
  a.res_mul = res_mul;
  a.out = static_cast<bf16*>(out);
  a.n = n;
  auto s = static_cast<cudaStream_t>(stream);
  return act != kActNone || residual != nullptr ? launch<kBits, true>(a, tile_m, s)
                                                : launch<kBits, false>(a, tile_m, s);
}

}  // namespace
}  // namespace wgmma_gemm
}  // namespace eetq
