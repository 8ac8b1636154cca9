// The int8-activation GEMM for Hopper shared by w8a8_gemm.cu and
// w4a8_gemm.cu: out[m, n] = bf16((f32(xq[m, :] . W[:, n]) * sx[m]) * sw[n]
// + bias[n]) with per-token int8 activations xq, int8 or int4 weights W and
// an exact s32 accumulator; or, group-wise (int4, sw [groups, n]),
// out[m, n] = bf16((sum over groups of f32(the group's s32 sum) * sw[g, n])
// * sx[m] + bias[n]).
//
// Replaces eetq_tpu/kernels/w8a8.py::w8a8_matmul_kernel_call (int8) and
// ::w4a8_matmul_kernel_call (int4). Bound by tensor-core operations at
// prefill sizes (m = 1024 does 2m operations per weight byte, int4 4m);
// Hopper's int8 rate is twice its bf16 rate, which is what the path is for.
//
// Design: wgmma_gemm.cuh's pipeline on the int8 wgmma
// (m64nNk32.s32.s8.s8). A block of four warpgroups (512 threads) computes a
// 256 x 128 output tile (128 x 128 where m <= 128; group-wise 256 x 64, as
// wgmma_gemm.cuh's) in K steps of 128 bytes through three rings in
// dynamic shared memory: x tiles (four slots), transposed weight tiles
// (three) and packed weight tiles (three).
//   - For 8-bit types wgmma takes both operands K-major from shared memory:
//     the descriptor's transpose bit exists only for 16-bit types. xq [m, kp]
//     is K-major as stored, so the producers (warpgroups 2 and 3) copy it by
//     cp.async straight into the 128-byte swizzle (hopper.cuh): one K step
//     is one swizzled row of 128 bytes. W [kp, np] is N-contiguous, so the
//     producers copy each packed tile by cp.async into a staging ring and,
//     two steps later, transpose it byte-wise once for the whole block into
//     the swizzled K-major [n][k] layout: a thread takes 16 K rows x 4
//     columns (16 4-byte loads), four 4 x 4 byte transposes (eight byte
//     permutes each) and four 16-byte stores, one per column. The staging
//     ring is itself XOR-swizzled by 16-row band, so that the eight threads
//     of one column group, one per band, load from eight distinct chunks,
//     and each store of eight threads covers the eight chunks of one row.
//     int4: a byte holds K rows 2r (low nibble) and 2r + 1 (high;
//     layout/tiling.py); the nibbles are sign-extended to int8 in the same
//     pass (a band is eight byte rows). The transpose is this kernel's
//     counterpart of wgmma_gemm.cuh's widening, and what the tile's height
//     amortizes; no transposed copy of the weights is kept in the model (it
//     would double the bytes that decode reads).
//   - The consumers (warpgroups 0 and 1, 128 or 64 rows each) run per K
//     step four k32 slices of one or two wgmma m64n128k32 (both operands
//     K-major), exact s32 accumulators in registers, one group in flight,
//     and hand the slots back through mbarriers. No wgmma, and no read of
//     its registers, sits under a branch (ptxas would serialize them all:
//     warning C7520): rows past m are zero and multiplied.
//   - setmaxnreg: producers 88 registers, consumers 168, as wgmma_gemm.cuh.
//
// Group-wise scales (sw [groups, n], group_size a multiple of 32): each
// consumer's two 64-row halves keep their open group's s32 sum in registers
// beside the f32 accumulators (its first slice overwrites it: scale-d = 0);
// when a group is complete its sum is converted to f32 (exact: at most
// group_size * 127 * 8), multiplied by the group's scale row and added to
// the accumulators, group after group. The halves' folds alternate with
// each other's products in flight (hopper.cuh::staggered_groups), as in
// wgmma_gemm.cuh's group mode, on its 256 x 64 tile. A group of whole K
// steps (128) is a unit of one step; 64 and other multiples of 32 take
// units of a half or a quarter step, each in a kernel of its own.
//
// The epilogue rounds in the order of the TPU kernel (w8a8.py:72-84,
// :256-265) with explicitly rounded operations, so no multiply-add is
// contracted: the integer sum is exact, and the per-channel output is
// bit-identical to a plain version that also sums exactly. With an
// activation or a residual (kEpi, a kernel of its own beside the bias-only
// one) the scaled and biased tile goes through shared memory in f32 and the
// store loop applies act(.), then the residual's add or multiply, before the
// one rounding; the mode is a kernel parameter read only there, after the
// last wgmma.
#pragma once

#include "hopper.cuh"

namespace eetq {
namespace a8 {

using namespace eetq::hopper;

// the per-channel tile comes from kernels/autotune.py::W8A8_TILE (nvcc -D
// flags): rows, columns, K bytes per step
static_assert(EETQ_W8A8_BM == 256 && EETQ_W8A8_BN == 128 && EETQ_W8A8_BK == 128,
              "two consumer warpgroups of 128 rows, m64n128k32, one swizzled row a step");
constexpr int kBK = EETQ_W8A8_BK, kSlices = kBK / 32;
constexpr int kXSlots = 4, kWSlots = 3, kRawSlots = 3;
constexpr int kLookahead = 2;  // K steps between a weight tile's copy and its transpose
static_assert(kRawSlots > kLookahead, "a packed tile outlives its lookahead");
constexpr int kConsumers = 256, kProducers = 256, kThreads = kConsumers + kProducers;
constexpr int kBarriers = 2 * kXSlots + kWSlots;
// a scale group is whole 32-deep wgmma slices (kernels/autotune.py::GROUP_GRANULE)
static_assert(EETQ_GROUP_GRANULE % 32 == 0, "a wgmma slice must not straddle two scale groups");

template <int kHalves, int kBN, bool kGroup>
struct Tile {
  static constexpr int kBM = 128 * kHalves;
  static constexpr int kXBytes = kBM * kBK;    // x tile, int8
  static constexpr int kWBytes = kBN * kBK;    // transposed weight tile, [n][k]
  static constexpr int kRawBytes = kBK * kBN;  // packed weight tile as copied (int4 uses half)
  static constexpr int kScaleBytes = kGroup ? kSlices * kBN * 4 : 0;  // a row per slice
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
  const int8_t* xq;  // [m, kp]
  int m, kp;         // kp: the logical padded K
  const int8_t* w;   // [kp, np] (int4: [kp / 2, np]); kp, np % 128 == 0
  int np;
  const float* sx;  // [m]
  const float* sw;  // [n], or [groups, n]
  int groups, group_size;
  const float* bias;  // [n] or null
  int act;              // kEpi: the activation (common.cuh)
  const bf16* residual;  // kEpi: [m, n] or null, added or multiplied (res_mul)
  int res_mul;
  bf16* out;          // [m, n]
  int n;
};

__device__ __forceinline__ uint32_t load4(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void store16(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                        uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

// Byte offset of 16-byte chunk q of packed row r in the staging ring: the
// tile's chunks in order, 128-byte lines of them, chunk position XOR the
// row's 16-deep K band.
template <int kChunksPerRow, int kBandRows>
__device__ __forceinline__ uint32_t staged(int r, int q) {
  const int l = r * kChunksPerRow + q;
  return static_cast<uint32_t>(((l >> 3) << 7) | (((l & 7) ^ ((r / kBandRows) & 7)) << 4));
}

// Internal linkage: two sources include this file.
namespace {

// kUnits: 0 for per-channel scales; else group-wise, groups closing after
// units of kSlices / kUnits slices (1: whole steps; 2: halves; 4: quarters);
// kEpi: the activation and residual epilogue.
template <int kBits, int kHalves, int kBN, int kUnits, bool kEpi>
__global__ void __launch_bounds__(kThreads, 1) a8_gemm_kernel(const Args a) {
  static_assert(kBits == 8 || kBits == 4, "int8 or int4 weights");
  static_assert(kUnits == 0 || kUnits == 1 || kUnits == 2 || kUnits == 4,
                "a unit is a step, a half or a quarter of one");
  using T = Tile<kHalves, kBN, kUnits != 0>;
  constexpr int kBM = T::kBM;
  constexpr int kChunksPerRow = kBN / 16;
  constexpr int kRawRows = kBits == 8 ? kBK : kBK / 2;  // byte rows of a packed tile
  constexpr int kBandRows = kRawRows / 8;               // ... per 16-deep K band
  constexpr int kRawChunks = kRawRows * kChunksPerRow;
  constexpr int kBlocks = 8 * (kBN / 4);  // transpose work: 8 bands x 4-column groups
  static_assert(kBlocks <= kProducers, "one 16 x 4 block a producer thread");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const generic = smem_raw + (base - smem_addr(smem_raw));
  auto xs = [&](int step) { return base + (step % kXSlots) * T::kXBytes; };
  auto ws = [&](int step) { return base + T::kWOff + (step % kWSlots) * T::kWBytes; };
  auto raw = [&](int step) { return base + T::kRawOff + (step % kRawSlots) * T::kRawBytes; };
  auto sc = [&](int step) { return base + T::kScaleOff + (step % kXSlots) * T::kScaleBytes; };
  auto full = [&](int step) { return base + T::kBarOff + (step % kXSlots) * 8; };
  auto x_free = [&](int step) { return base + T::kBarOff + (kXSlots + step % kXSlots) * 8; };
  auto w_free = [&](int step) { return base + T::kBarOff + (2 * kXSlots + step % kWSlots) * 8; };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = a.kp / kBK;
  if (tid == 0) {
    for (int i = 0; i < kXSlots; ++i) {
      mbar_init(full(i), kProducers / 32);
      mbar_init(x_free(i), kConsumers / 32);
    }
    for (int i = 0; i < kWSlots; ++i) mbar_init(w_free(i), kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producers: copy, transpose, hand over ----
    setmaxnreg_dec<88>();
    const int p = tid - kConsumers;
    const int rows = min(kBM, a.m - m0);
    const int band = p & 7, cols = p >> 3;  // this thread's transpose block: 16 K x 4 columns
    for (int it = 0; it < nk + kLookahead; ++it) {
      const int j = it - kLookahead;  // transpose step j, then copy step it
      if (j >= 0) {
        mbar_wait(w_free(j), ((j / kWSlots) & 1) ^ 1);
        cp_async_wait<kLookahead - 1>();  // this thread's copies of step j have landed
        named_barrier(2, kProducers);     // ... and every producer's
        if (p < kBlocks) {
          uint32_t r8[16];  // K rows 16 band + i, columns 4 cols .. + 3
#pragma unroll
          for (int i = 0; i < kBandRows; ++i) {
            const int r = band * kBandRows + i;
            const uint32_t v =
                load4(raw(j) + staged<kChunksPerRow, kBandRows>(r, cols >> 2) + (cols & 3) * 4);
            if constexpr (kBits == 8) {
              r8[i] = v;
            } else {
              r8[2 * i] = nibbles_to_int8x4<false>(v);
              r8[2 * i + 1] = nibbles_to_int8x4<true>(v);
            }
          }
          uint32_t col[4][4];  // column c, K bytes 4q .. 4q + 3 (the smallest K lowest)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t t0 = __byte_perm(r8[4 * q], r8[4 * q + 1], 0x5140);
            const uint32_t t1 = __byte_perm(r8[4 * q], r8[4 * q + 1], 0x7362);
            const uint32_t t2 = __byte_perm(r8[4 * q + 2], r8[4 * q + 3], 0x5140);
            const uint32_t t3 = __byte_perm(r8[4 * q + 2], r8[4 * q + 3], 0x7362);
            col[0][q] = __byte_perm(t0, t2, 0x5410);
            col[1][q] = __byte_perm(t0, t2, 0x7632);
            col[2][q] = __byte_perm(t1, t3, 0x5410);
            col[3][q] = __byte_perm(t1, t3, 0x7632);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            store16(ws(j) + swizzle128(4 * cols + c, band), col[c][0], col[c][1], col[c][2],
                    col[c][3]);
        }
        fence_proxy_async();  // the x copies and the stores above, for wgmma
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(full(j));
      }
      if (it < nk) {
        const int k0 = it * kBK;
        mbar_wait(x_free(it), ((it / kXSlots) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < kBM * 8 / kProducers; ++i) {  // x: kBM rows x 8 chunks of 16 bytes
          const int idx = p + i * kProducers, row = idx >> 3, c = idx & 7;
          const bool ok = row < rows;  // rows past m are zero
          const int8_t* src = ok ? a.xq + (size_t)(m0 + row) * a.kp + k0 + c * 16 : a.xq;
          cp_async16(xs(it) + swizzle128(row, c), src, ok ? 16 : 0);
        }
        const int k0_rows = kBits == 8 ? k0 : k0 / 2;
#pragma unroll
        for (int i = 0; i < (kRawChunks + kProducers - 1) / kProducers; ++i) {  // W, packed
          const int idx = p + i * kProducers, row = idx / kChunksPerRow, c = idx % kChunksPerRow;
          if (idx >= kRawChunks) break;
          cp_async16(raw(it) + staged<kChunksPerRow, kBandRows>(row, c),
                     a.w + (size_t)(k0_rows + row) * a.np + n0 + c * 16, 16);
        }
        if constexpr (kUnits != 0) {  // the scale row of each 32-deep slice of the step
          for (int idx = p; idx < kSlices * kBN; idx += kProducers) {
            const int h = idx / kBN, gn = n0 + idx % kBN;
            const int gi = min((k0 + 32 * h) / a.group_size, a.groups - 1);
            const bool ok = gn < a.n;
            cp_async4(sc(it) + idx * 4, ok ? a.sw + (size_t)gi * a.n + gn : a.sw, ok ? 4 : 0);
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
  constexpr bool kGroup = kUnits != 0;
  int acc[kGroup ? 1 : kHalves][kGroup ? 1 : kAcc];     // per-channel: the exact sum
  int part[kGroup ? kHalves : 1][kGroup ? kAcc : 1];    // group-wise: the open group's
  float accf[kGroup ? kHalves : 1][kGroup ? kAcc : 1];  // ... and the closed groups' scaled sum
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      if constexpr (kGroup) accf[h][i] = 0.f;
      else acc[h][i] = 0;
    }
  }
  auto mma = [&](int(&d)[kAcc], int kt, int h, int s, int scale_d) {
    const uint64_t da = smem_desc(xs(kt) + (64 * (kHalves * wg + h)) * 128 + s * 32, 16, 1024);
    const uint64_t db = smem_desc(ws(kt) + s * 32, 16, 1024);
    if constexpr (kBN == 128) wgmma_s8_n128(d, da, db, scale_d);
    else wgmma_s8_n64(d, da, db, scale_d);
  };
  auto release = [&](int kt) {  // step kt - 1 has been multiplied
    if (kt > 0 && lane == 0) {
      mbar_arrive(x_free(kt - 1));
      mbar_arrive(w_free(kt - 1));
    }
  };
  if constexpr (!kGroup) {
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full(kt), (kt / kXSlots) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSlices; ++s)
#pragma unroll
        for (int h = 0; h < kHalves; ++h) mma(acc[h], kt, h, s, 1);
      wgmma_commit();
      wgmma_wait<1>();
      release(kt);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fence_registers(acc[h]);
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
    // accf += f32(part) * the scale row of unit u's last slice
    auto fold = [&](auto half, int u) {
      constexpr int h = decltype(half)::value;
      fence_registers(part[h]);
      const int row = (u % kUnits + 1) * kUnitSlices - 1;
      const float* sr =
          reinterpret_cast<const float*>(generic + (sc(u / kUnits) - base)) + row * kBN;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sr + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          accf[h][4 * j + e] =
              fmaf(__int2float_rn(part[h][4 * j + e]), (e & 1) ? s2.y : s2.x, accf[h][4 * j + e]);
      }
    };
    auto after = [&](int u) {
      if (u % kUnits == 0) release(u / kUnits);
    };
    staggered_groups(nk * kUnits, a.group_size / (32 * kUnitSlices), issue, fold, after);
  }

  // epilogue: (f32(acc) * sx) * sw, or accf * sx; then + bias; one rounding
  const int r0 = 64 * kHalves * wg + warp * 16 + g;
  auto result = [&](int h, int i) {
    const int row = m0 + r0 + 64 * h + ((i & 2) ? 8 : 0), gn = n0 + 8 * (i / 4) + 2 * t + (i & 1);
    const float rs = row < a.m ? a.sx[row] : 0.f;
    float r;
    if constexpr (kGroup) {
      r = __fmul_rn(accf[h][i], rs);
    } else {
      r = __fmul_rn(__fmul_rn(__int2float_rn(acc[h][i]), rs), gn < a.n ? a.sw[gn] : 0.f);
    }
    if (a.bias != nullptr && gn < a.n) r = __fadd_rn(r, a.bias[gn]);
    return r;
  };
  if (a.n % 8) {  // rows of out are not 16-byte aligned
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int row = m0 + r0 + 64 * h + ((i & 2) ? 8 : 0), gn = n0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (row < a.m && gn < a.n) {
          const size_t o = (size_t)row * a.n + gn;
          float v = result(h, i);
          if constexpr (kEpi) {
            v = activate(v, a.act);
            if (a.residual != nullptr) v = combine(v, __bfloat162float(a.residual[o]), a.res_mul);
          }
          a.out[o] = __float2bfloat16_rn(v);
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
              make_float2(result(h, 4 * j + 2 * r), result(h, 4 * j + 2 * r + 1));
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
            __floats2bfloat162_rn(result(h, 4 * j + 2 * r), result(h, 4 * j + 2 * r + 1));
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
  auto kernel = a8_gemm_kernel<kBits, kHalves, kBN, kUnits, kEpi>;
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

// The design for the call: per-channel on the W8A8_TILE (128 rows where
// m <= 128), group-wise (int4 only) on 256 x 64, with the fold unit the
// largest of a step, a half and a quarter that divides the group.
template <int kBits, bool kEpi>
cudaError_t launch_design(const Args& a, cudaStream_t s) {
  constexpr int kBN = EETQ_W8A8_BN;
  if (a.groups == 0)
    return a.m <= 128 ? launch_tile<kBits, 1, kBN, 0, kEpi>(a, s)
                      : launch_tile<kBits, 2, kBN, 0, kEpi>(a, s);
  if constexpr (kBits == 4) {
    if (a.group_size < EETQ_GROUP_GRANULE || a.group_size % EETQ_GROUP_GRANULE)
      return cudaErrorInvalidValue;
    if (a.group_size % kBK == 0) return launch_tile<kBits, 2, 64, 1, kEpi>(a, s);
    if (a.group_size % (kBK / 2) == 0) return launch_tile<kBits, 2, 64, 2, kEpi>(a, s);
    return launch_tile<kBits, 2, 64, 4, kEpi>(a, s);
  }
  return cudaErrorInvalidValue;  // group-wise W8A8 has no kernel
}

// The C entry points (w8a8_gemm.cu, w4a8_gemm.cu): the epilogue's
// activation `act` and residual (or null), multiplied where res_mul is set,
// pick the kEpi kernels.
template <int kBits>
cudaError_t launch(const void* xq, int m, int kp, const void* w, int np, const void* sx,
                   const void* sw, int groups, int group_size, const void* bias, int act,
                   const void* residual, int res_mul, void* out, int n, void* stream) {
  if (act < kActSilu || act > kActNone) return cudaErrorInvalidValue;
  Args a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.m = m;
  a.kp = kp;
  a.w = static_cast<const int8_t*>(w);
  a.np = np;
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(sw);
  a.groups = groups;
  a.group_size = group_size;
  a.bias = static_cast<const float*>(bias);
  a.act = act;
  a.residual = static_cast<const bf16*>(residual);
  a.res_mul = res_mul;
  a.out = static_cast<bf16*>(out);
  a.n = n;
  auto s = static_cast<cudaStream_t>(stream);
  return act != kActNone || residual != nullptr ? launch_design<kBits, true>(a, s)
                                                : launch_design<kBits, false>(a, s);
}

}  // namespace
}  // namespace a8
}  // namespace eetq
