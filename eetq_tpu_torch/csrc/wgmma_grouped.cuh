// The token-grouped expert GEMM for Hopper, int8 and int4 banks,
// per-channel or group-wise scales: w8a16_grouped_gemm.cu and
// w4a16_grouped_gemm.cu.
//
// out[b * bm + r, n] = x[b * bm + r, :] . dequant(bank[block_expert[b]])[:, n]
// for row block b of nb, r < bm. Replaces
// eetq_tpu/kernels/w8a16.py::w8a16_grouped_matmul_kernel_call; each group's
// scale multiplies that group's f32 partial sum, as _dot_scaled does
// (w8a16.py:79-126).
//
// One block per (row block, output-column strip), row blocks fastest over the
// grid: the sorted blocks of one expert are neighbours and share the weight
// strip in L2. A block reads its expert id from device memory and offsets the
// bank and the scales by it in 64-bit arithmetic. The pipeline is
// wgmma_gemm.cuh's (cp.async of x and of the packed weights into rings of
// shared memory, the weights widened to bf16 once per block by producer
// warps, fence.proxy.async and mbarriers, consumers on wgmma), in two shapes
// picked by bm:
//
//  - Wide (bm > EETQ_GROUPED_SKINNY_BM: a Mixtral prompt, bm = 128). Bound by
//    tensor-core operations. A 128-row x 128-column tile, 512 threads: two
//    producer warpgroups, two consumer warpgroups of 64 rows each (one
//    m64n128k16 per 16-deep slice, x K-major as A, the converted weights
//    MN-major as B); rows past bm are zero and multiplied all the same. The
//    row block is the unit of work, so 128 rows is the ceiling: each converted
//    weight is multiplied by 128 rows, half as many as the dense tile's.
//  - Skinny (bm <= EETQ_GROUPED_SKINNY_BM: the engine's 8-slot step, bm = 8).
//    Bound by the weight bytes: 8 rows do 16 operations per int8 byte. The
//    operands are swapped, out^T = W^T x^T: the converted weights [k][n] are
//    the A operand (M = 64 output columns, MN-major through the descriptor's
//    transpose bit), the row block the B operand (N = 8, 16 or 32 rows,
//    K-major), so no tensor-core work goes to rows that do not exist and the
//    accumulators are 4-16 floats a thread. 64-column strips, 256 threads
//    (one producer and one consumer warpgroup), two blocks an SM, K steps of
//    128 (a step's barriers, fences and widening pass cost what the wide
//    tile's do, for a quarter of its work: 64-deep steps ran 5-10% slower)
//    and a lookahead of 3 steps (int4: 6) between a packed tile's copy and
//    its conversion: 48 KB of weights in flight per SM. 64 columns and not
//    128 so that Mixtral's down projection (N = 4096, 7 real blocks) has 448
//    blocks for 132 SMs instead of 224. wgmma and not mma.sync with A built
//    in registers: the int8 bank lies n-contiguous, and an A fragment pairs
//    two K rows of one column per register, a byte transpose per tile.
//
// Group-wise scales ([E, G, n], group_size a multiple of 32): the open
// group's f32 sum is kept in registers beside the accumulators; its first
// 16-deep slice overwrites it (wgmma's scale-d = 0), and when its products
// are done the consumer adds part * scale[g, n] to the accumulators. The
// producers copy the scale rows of the odd slices (where a group can close)
// with each step's x tile (cp.async, 4 bytes each, zero past n). Where a
// group is whole K steps (g = 64 or 128 on the wide tile, 128 on the skinny
// one) the consumer loops over groups and their steps and folds after each
// group; other sizes (32, 96, ...) fold after any odd slice, in a kernel of
// their own. No wgmma, and no read of its registers, sits under a branch:
// ptxas serializes every wgmma of a kernel in which it finds one it cannot
// prove uniform (warning C7520; the skinny kernels for other group sizes
// still draw it), which cost 6% (wide, per-channel) to 22% (skinny, int4
// g = 128) of this kernel's time. The scales are not folded into the bf16
// weights: that would round bf16(q * s) where the reference sums in f32.
//
// Padding blocks: the caller passes the number of real blocks on the device
// (real_blocks, nullable); a block at or past it reads no weights and writes
// zeros, which is what its zero rows of x give.
#pragma once

#include "wgmma_gemm.cuh"

namespace eetq {
namespace wgmma_grouped {

using namespace eetq::hopper;
using wgmma_gemm::int4x16_to_bf16;
using wgmma_gemm::int8x16_to_bf16;
using wgmma_gemm::load16;
using wgmma_gemm::store_pair;

static_assert(EETQ_GROUPED_SKINNY_BM == 0 || EETQ_GROUPED_SKINNY_BM == 8 ||
                  EETQ_GROUPED_SKINNY_BM == 16 || EETQ_GROUPED_SKINNY_BM == 32,
              "the skinny tile holds 8, 16 or 32 rows");
static_assert(EETQ_GROUP_GRANULE % 32 == 0, "a group closes after an odd 16-deep slice");

constexpr int kMaxBM = 128;
constexpr int kSmemPerSM = 232448;  // what the blocks of one SM may take

// The shape of one design: kRows rows of x per block (128: wide; 8, 16, 32:
// skinny) for kBits-bit weights, and the layout of its dynamic shared memory.
template <int kBits, int kRows>
struct Tile {
  static constexpr bool kSkinny = kRows <= 32;
  static constexpr int kCols = kSkinny ? 64 : 128;
  // K depth of a pipeline step, in 16-deep slices; the skinny tile's steps
  // are twice as deep: its cost per step (barriers, fences, one widening
  // pass) is the same as the wide tile's for a quarter of the work
  static constexpr int kBK = kSkinny ? 128 : 64;
  static constexpr int kSlices = kBK / 16;
  static constexpr int kConsumers = kSkinny ? 128 : 256;
  static constexpr int kProducers = kSkinny ? 128 : 256;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kProducerRegs = 88, kConsumerRegs = 168;  // wide: setmaxnreg
  static constexpr int kLookahead = kSkinny ? (kBits == 8 ? 3 : 6) : 2;
  static constexpr int kRawSlots = kLookahead + 1;
  static constexpr int kXSlots = kSkinny ? kLookahead + 2 : 4;
  static constexpr int kWSlots = kSkinny ? 2 : 4;
  static constexpr int kXBytes = kRows * kBK * 2;  // x tile, bf16: kBK / 64 swizzled blocks
  static constexpr int kWBytes = kBK * kCols * 2;  // converted weights: kCols / 64 blocks
  static constexpr int kRawBytes = (kBits == 8 ? kBK : kBK / 2) * kCols;  // as copied
  static constexpr int kScaleBytes = kBK / 32 * kCols * 4;  // f32 rows of closing groups
  static constexpr int kWOff = kXSlots * kXBytes;
  static constexpr int kRawOff = kWOff + kWSlots * kWBytes;
  static constexpr int kScaleOff = kRawOff + kRawSlots * kRawBytes;
  static constexpr int kBarOff = kScaleOff + kXSlots * kScaleBytes;
  static constexpr int kBarriers = 2 * kXSlots + kWSlots;
  static constexpr int kSmemBytes = kBarOff + kBarriers * 8 + 1024;
  static constexpr int kMinBlocks = kSmemPerSM / kSmemBytes < 3 ? kSmemPerSM / kSmemBytes : 3;
  static constexpr int kOutLd = kCols + 8;  // padded rows of the output staging
  static_assert(kXSlots > kLookahead, "an x slot is freed by a step already converted");
  static_assert(kRows * kOutLd * 2 <= kRawOff, "output staging fits the x and weight rings");
  static_assert(kMinBlocks >= 1, "shared memory of one block");
};

struct Args {
  const bf16* x;  // [nb * bm, k], k % 8 == 0
  int bm, k;
  const int8_t* w;  // [E, kp, np] (int4: [E, kp / 2, np]); kp, np % 128 == 0
  int kp, np;
  long long w_stride;   // bytes from one expert to the next
  const float* scales;  // [E, n] or [E, groups, n]
  int groups, group_size;
  long long s_stride;       // floats from one expert to the next
  const int* block_expert;  // [nb]
  const int* real_blocks;   // [1]: blocks past it are padding; or null
  bf16* out;                // [nb * bm, n]
  int n;
};

// D (+)= A * B over one 16-deep slice, both operands from shared memory: the
// skinny tile's m64nNk16 with A MN-major and B K-major.
template <int kN>
__device__ __forceinline__ void skinny_mma(float (&d)[kN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (kN == 8) wgmma_ss_n8<1, 0>(d, da, db, scale_d);
  else if constexpr (kN == 16) wgmma_ss_n16<1, 0>(d, da, db, scale_d);
  else wgmma_ss_n32<1, 0>(d, da, db, scale_d);
}

// Internal linkage: two sources include this file.
namespace {

// Scale modes: per-channel [E, n]; groups of whole K steps; any multiple of
// 32 rows.
constexpr int kPerChannel = 0, kGroupSteps = 1, kGroupSlices = 2;

template <int kBits, int kRows, int kMode>
__global__ void __launch_bounds__(Tile<kBits, kRows>::kThreads, Tile<kBits, kRows>::kMinBlocks)
    grouped_kernel(const Args a) {
  static_assert(kBits == 8 || kBits == 4, "int8 or int4 weights");
  using T = Tile<kBits, kRows>;
  constexpr int kCols = T::kCols, kXSlots = T::kXSlots, kWSlots = T::kWSlots, kBK = T::kBK;
  constexpr int kLookahead = T::kLookahead, kProducers = T::kProducers;
  constexpr int kRawChunks = T::kRawBytes / 16;  // 16-byte chunks of a packed tile
  constexpr int kChunksPerRow = kCols / 16;      // ... in one of its byte rows
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* const generic = smem_raw + (base - smem_addr(smem_raw));
  auto xs = [&](int step) { return base + (step % kXSlots) * T::kXBytes; };
  auto ws = [&](int step) { return base + T::kWOff + (step % kWSlots) * T::kWBytes; };
  auto raw = [&](int step) { return base + T::kRawOff + (step % T::kRawSlots) * T::kRawBytes; };
  auto sc = [&](int step) { return base + T::kScaleOff + (step % kXSlots) * T::kScaleBytes; };
  // a step's tiles are ready; its x (and scale) slot, its weight slot are free
  auto full = [&](int step) { return base + T::kBarOff + (step % kXSlots) * 8; };
  auto x_free = [&](int step) { return base + T::kBarOff + (kXSlots + step % kXSlots) * 8; };
  auto w_free = [&](int step) { return base + T::kBarOff + (2 * kXSlots + step % kWSlots) * 8; };

  const int tid = threadIdx.x;
  const int blk = blockIdx.x, n0 = blockIdx.y * kCols;
  const size_t m0 = (size_t)blk * a.bm;
  if (a.real_blocks != nullptr && blk >= *a.real_blocks) {
    // a padding block: its rows of x are zero, so are its outputs
    const int cols = min(kCols, a.n - n0);
    for (int idx = tid; idx < a.bm * cols; idx += T::kThreads)
      a.out[(m0 + idx / cols) * a.n + n0 + idx % cols] = __float2bfloat16(0.f);
    return;
  }
  const int e = a.block_expert[blk];
  const int8_t* w = a.w + (size_t)e * a.w_stride;
  const float* scales = a.scales + (size_t)e * a.s_stride;
  const int nk = a.kp / kBK;
  if (tid == 0) {
    for (int i = 0; i < kXSlots; ++i) {
      mbar_init(full(i), kProducers / 32);         // one lane of every producer warp
      mbar_init(x_free(i), T::kConsumers / 32);    // one lane of every consumer warp
    }
    for (int i = 0; i < kWSlots; ++i) mbar_init(w_free(i), T::kConsumers / 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= T::kConsumers) {
    // ---- producers: copy, convert, hand over (wgmma_gemm.cuh's loop) ----
    if constexpr (!T::kSkinny) setmaxnreg_dec<T::kProducerRegs>();
    const int p = tid - T::kConsumers;
    for (int it = 0; it < nk + kLookahead; ++it) {
      const int j = it - kLookahead;  // convert step j, then copy step it
      if (j >= 0) {
        mbar_wait(w_free(j), ((j / kWSlots) & 1) ^ 1);  // passes at once on the first round
        cp_async_wait<kLookahead - 1>();  // this thread's copies of step j have landed
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
          const uint32_t blk64 = ws(j) + (c >> 2) * (kBK * 128);  // 64-column block
          if constexpr (kBits == 8) {
            store_pair(blk64, row, c, lo[i], hi[i]);
          } else {
            store_pair(blk64, 2 * row, c, lo[2 * i], hi[2 * i]);
            store_pair(blk64, 2 * row + 1, c, lo[2 * i + 1], hi[2 * i + 1]);
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
        constexpr int kXChunks = kRows * (kBK / 8);  // 16-byte chunks of the x tile
        for (int i = 0; i < (kXChunks + kProducers - 1) / kProducers; ++i) {
          const int idx = p + i * kProducers, row = idx / (kBK / 8), c = idx % (kBK / 8);
          if (idx >= kXChunks) break;
          const int gk = k0 + c * 8;
          const bool ok = row < a.bm && gk < a.k;  // rows past bm and columns past K are zero
          const bf16* src = ok ? a.x + (m0 + row) * a.k + gk : a.x;
          cp_async16(xs(it) + (c >> 3) * (kRows * 128) + swizzle128(row, c & 7), src, ok ? 16 : 0);
        }
        const int k0_rows = kBits == 8 ? k0 : k0 / 2;
#pragma unroll
        for (int i = 0; i < (kRawChunks + kProducers - 1) / kProducers; ++i) {  // W, packed
          const int idx = p + i * kProducers, row = idx / kChunksPerRow, c = idx % kChunksPerRow;
          if (idx >= kRawChunks) break;
          cp_async16(raw(it) + idx * 16, w + (size_t)(k0_rows + row) * a.np + n0 + c * 16, 16);
        }
        if constexpr (kMode != kPerChannel) {  // the rows of groups that may close after odd slices
          for (int idx = p; idx < kBK / 32 * kCols; idx += kProducers) {
            const int h = idx / kCols, gn = n0 + idx % kCols;
            const int gi = min((k0 + 16 + 32 * h) / a.group_size, a.groups - 1);
            const bool ok = gn < a.n;
            cp_async4(sc(it) + idx * 4, ok ? scales + (size_t)gi * a.n + gn : scales, ok ? 4 : 0);
          }
        }
      }
      cp_async_commit();  // one group per step, empty past the end
    }
    return;
  }

  // ---- consumers ----
  if constexpr (!T::kSkinny) setmaxnreg_inc<T::kConsumerRegs>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // wide: rows 64 wg .. + 63 x 128 columns, element 4j + e at row 16 warp + g
  // (+ 8 for e >= 2), column 8j + 2t + (e & 1); skinny (transposed): element
  // 4j + e at output column 16 warp + g (+ 8 for e >= 2), row 8j + 2t + (e & 1)
  constexpr int kAcc = T::kSkinny ? kRows / 2 : kCols / 2;
  float acc[kAcc], part[kMode == kPerChannel ? 1 : kAcc];  // part: the open group's sum
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  // acc += p * scale row (kCols f32 at shared address srow)
  auto fold = [&](auto& p, uint32_t srow) {
    const float* sr = reinterpret_cast<const float*>(generic + (srow - base));
    if constexpr (T::kSkinny) {
      const float s0 = sr[warp * 16 + g], s8 = sr[warp * 16 + g + 8];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = fmaf(p[i], (i & 2) ? s8 : s0, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const float2 s2 = *reinterpret_cast<const float2*>(sr + 8 * j + 2 * t);
        acc[4 * j] = fmaf(p[4 * j], s2.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(p[4 * j + 1], s2.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(p[4 * j + 2], s2.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(p[4 * j + 3], s2.y, acc[4 * j + 3]);
      }
    }
  };
  // one 16-deep slice of step kt into d; scale_d = 0 starts a new sum
  auto mma = [&](auto& d, int kt, int s, int scale_d) {
    if constexpr (T::kSkinny) {
      skinny_mma<kRows>(d, smem_desc(ws(kt) + s * 2048, kBK * 128, 1024),  // weights, MN-major
                        smem_desc(xs(kt) + (s >> 2) * (kRows * 128) + (s & 3) * 32, 16, 1024),
                        scale_d);  // x, K-major
    } else {
      wgmma_ss_n128<0, 1>(d, smem_desc(xs(kt) + wg * 64 * 128 + s * 32, 16, 1024),
                          smem_desc(ws(kt) + s * 2048, kBK * 128, 1024), scale_d);
    }
  };
  // after step kt's products are issued: step kt - 1 has been multiplied when
  // at most one group is pending, and its slots go back to the producers
  auto release = [&](int kt) {
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) {
      mbar_arrive(x_free(kt - 1));
      mbar_arrive(w_free(kt - 1));
    }
  };
  // No branch around a wgmma or a read of its registers: ptxas serializes
  // every wgmma of a kernel where it finds one it cannot prove uniform
  // (C7520); so rows past bm are multiplied too (they are zero), and the
  // fold positions are either whole steps (kGroupSteps) or per slice in a
  // kernel of their own (kGroupSlices).
  if constexpr (kMode == kPerChannel) {
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full(kt), (kt / kXSlots) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < T::kSlices; ++s) mma(acc, kt, s, 1);
      release(kt);
    }
    wgmma_wait<0>();
  } else if constexpr (kMode == kGroupSteps) {  // a group is whole K steps
    const int steps = a.group_size / kBK;
    for (int kt0 = 0; kt0 < nk; kt0 += steps) {
      const int kt1 = min(nk, kt0 + steps);
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(full(kt), (kt / kXSlots) & 1);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < T::kSlices; ++s) mma(part, kt, s, kt != kt0 || s != 0);
        release(kt);
      }
      wgmma_wait<0>();  // the group's sum is complete
      fence_registers(part);
      fold(part, sc(kt1 - 1) + (T::kSlices / 2 - 1) * kCols * 4);  // its last slice's row
      wgmma_fence();
    }
  } else {  // groups close after any odd slice (g = 32, 96, ...)
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full(kt), (kt / kXSlots) & 1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < T::kSlices; ++s) {
        const int k_lo = kt * kBK + s * 16;
        mma(part, kt, s, k_lo % a.group_size != 0);  // the first slice of a group starts it
        if ((s & 1) && ((k_lo + 16) % a.group_size == 0 || k_lo + 16 == a.kp)) {
          wgmma_commit();
          wgmma_wait<0>();
          fence_registers(part);
          fold(part, sc(kt) + (s >> 1) * kCols * 4);
          wgmma_fence();
        }
      }
      release(kt);
    }
    wgmma_wait<0>();
  }
  fence_registers(acc);

  // epilogue: per-channel scales on the accumulators, then bf16 stores
  auto row_of = [&](int i) {  // within the block
    return T::kSkinny ? 8 * (i / 4) + 2 * t + (i & 1) : wg * 64 + warp * 16 + g + ((i & 2) ? 8 : 0);
  };
  auto col_of = [&](int i) {  // within the strip
    return T::kSkinny ? warp * 16 + g + ((i & 2) ? 8 : 0) : 8 * (i / 4) + 2 * t + (i & 1);
  };
  if constexpr (kMode == kPerChannel) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int gn = n0 + col_of(i);
      acc[i] *= gn < a.n ? scales[gn] : 0.f;
    }
  }
  if (a.n % 8) {  // rows of out are not 16-byte aligned
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = row_of(i), gn = n0 + col_of(i);
      if (r < a.bm && gn < a.n) a.out[(m0 + r) * a.n + gn] = __float2bfloat16(acc[i]);
    }
    return;
  }
  named_barrier(1, T::kConsumers);  // every consumer has read its last slots
  bf16* stage = reinterpret_cast<bf16*>(generic);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) stage[row_of(i) * T::kOutLd + col_of(i)] = __float2bfloat16(acc[i]);
  named_barrier(1, T::kConsumers);
  const int rows = min(kRows, a.bm);
  for (int idx = tid; idx < rows * (kCols / 8); idx += T::kConsumers) {
    const int r = idx / (kCols / 8), c = idx % (kCols / 8);
    if (n0 + c * 8 < a.n)
      *reinterpret_cast<int4*>(a.out + (m0 + r) * a.n + n0 + c * 8) =
          *reinterpret_cast<const int4*>(stage + r * T::kOutLd + c * 8);
  }
}

template <int kBits, int kRows, int kMode>
cudaError_t launch_mode(const Args& a, int nb, cudaStream_t stream) {
  using T = Tile<kBits, kRows>;
  auto kernel = grouped_kernel<kBits, kRows, kMode>;
  static bool opted_in = false;  // above 48 KB of dynamic shared memory
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int strips = a.np / T::kCols;
  if (nb < 1 || nb > 65535 || strips < 1 || strips > 65535 || a.np % T::kCols || a.kp % T::kBK)
    return cudaErrorInvalidValue;
  kernel<<<dim3(nb, strips), T::kThreads, T::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int kBits, int kRows, bool kGroup>
cudaError_t launch(const Args& a, int nb, cudaStream_t stream) {
  if constexpr (!kGroup) {
    return launch_mode<kBits, kRows, kPerChannel>(a, nb, stream);
  } else {
    if (a.group_size % Tile<kBits, kRows>::kBK == 0)
      return launch_mode<kBits, kRows, kGroupSteps>(a, nb, stream);
    return launch_mode<kBits, kRows, kGroupSlices>(a, nb, stream);
  }
}

// The design for bm rows: the skinny tile of the fewest rows that holds
// them, or the wide one.
template <int kBits, bool kGroup>
cudaError_t launch_for_bm(const Args& a, int nb, cudaStream_t stream) {
  if constexpr (EETQ_GROUPED_SKINNY_BM >= 8) {
    if (a.bm <= 8) return launch<kBits, 8, kGroup>(a, nb, stream);
  }
  if constexpr (EETQ_GROUPED_SKINNY_BM >= 16) {
    if (a.bm <= 16) return launch<kBits, 16, kGroup>(a, nb, stream);
  }
  if constexpr (EETQ_GROUPED_SKINNY_BM >= 32) {
    if (a.bm <= 32) return launch<kBits, 32, kGroup>(a, nb, stream);
  }
  return launch<kBits, kMaxBM, kGroup>(a, nb, stream);
}

// The C entry points' body: nb row blocks of bm rows over a bank of logical
// padded depth kp, scales [e, n], or [e, groups, n] when groups > 0.
template <int kBits>
int bank_entry(const void* x, int bm, int nb, int k, const void* w, int kp, int np,
               const void* scales, int groups, int group_size, const void* block_expert,
               void* out, int n, const void* real_blocks, void* stream) {
  if (bm < 1 || bm > kMaxBM) return cudaErrorInvalidValue;
  if (groups > 0 && (group_size < EETQ_GROUP_GRANULE || group_size % EETQ_GROUP_GRANULE))
    return cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.bm = bm;
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = kp;
  a.np = np;
  a.w_stride = (long long)(kBits == 4 ? kp / 2 : kp) * np;
  a.scales = static_cast<const float*>(scales);
  a.groups = groups;
  a.group_size = group_size;
  a.s_stride = (long long)(groups > 0 ? groups : 1) * n;
  a.block_expert = static_cast<const int*>(block_expert);
  a.real_blocks = static_cast<const int*>(real_blocks);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  auto s = static_cast<cudaStream_t>(stream);
  return groups > 0 ? launch_for_bm<kBits, true>(a, nb, s) : launch_for_bm<kBits, false>(a, nb, s);
}

}  // namespace
}  // namespace wgmma_grouped
}  // namespace eetq
