// The dense W8A16 / W4A16 GEMM tile for Hopper, per-channel scales:
// out[m, n] = (x[m, :] . W[:, n]) * scale[n] + bias[n]. Used by w8a16_gemm.cu
// and w4a16_gemm.cu for m > 8; group-wise scales and the expert banks stay
// on gemm_tile.cuh.
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
// output tile in K steps of 64 through three rings in dynamic shared memory:
// x tiles (four slots), converted weight tiles (four) and packed weight
// tiles (three).
//   - Warpgroups 2 and 3 are the producers. For each K step they copy the x
//     tile (256 rows x 64 bf16) by cp.async straight into the
//     128-byte-swizzled K-major layout wgmma reads (hopper.cuh), and the
//     weight tile (64 x 128 int8, or 32 x 128 bytes of int4 pairs) by
//     cp.async, still packed, into the staging ring. Two K steps later they
//     convert the weight tile once for the whole block to bf16 (exact:
//     |q| <= 128) into the swizzled rows of a slot of the weight ring, execute
//     fence.proxy.async and arrive on the step's `full` mbarrier, one lane
//     per warp. Each thread converts the bytes it copied itself, so
//     cp.async.wait_group is all the synchronisation the staging ring needs.
//     cp.async and not TMA: the x tile's edges (rows past m, columns past K)
//     are zero-filled by the copy's source size, and no tensor map has to be
//     encoded per call for shapes that change with every prompt bucket.
//   - Warpgroups 0 and 1 are the consumers, 128 rows each: per K step four
//     times two wgmma m64n128k16 (A: 64 of the x rows, K-major; B: the
//     converted weights as they lie in memory, [k][n] with n contiguous, read
//     MN-major through the descriptor's transpose bit), f32 accumulators in
//     registers (128 a thread), one group kept in flight; the slots of a step
//     go back to the producers through their `empty` mbarriers when the
//     group that read them has finished. 64 rows that all lie past m are
//     not multiplied.
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
//     multiple of 8 and rows are not 16-byte aligned).
// Row blocks vary fastest over the grid, so the blocks that share a weight
// tile run together and W streams from device memory once.
#pragma once

#include "hopper.cuh"

namespace eetq {
namespace wgmma_gemm {

using namespace eetq::hopper;

constexpr int kBM = 256, kBN = 128, kBK = 64;
constexpr int kXSlots = 4, kWSlots = 4, kRawSlots = 3;
constexpr int kLookahead = 2;  // K steps between a weight tile's copy and its conversion
static_assert(kRawSlots > kLookahead && kLookahead >= 1, "a packed tile outlives its lookahead");
constexpr int kConsumers = 256, kProducers = 256, kThreads = kConsumers + kProducers;
constexpr int kXBytes = kBM * kBK * 2;   // x tile, bf16
constexpr int kWBytes = kBK * kBN * 2;   // converted weight tile, bf16
constexpr int kRawBytes = kBK * kBN;     // packed weight tile as copied (int8; int4 uses half)
constexpr int kRingBytes = kXSlots * kXBytes + kWSlots * kWBytes + kRawSlots * kRawBytes;
constexpr int kBarriers = 2 * kXSlots + kWSlots;  // full and empty per x slot, empty per W slot
constexpr int kOutLd = kBN + 8;          // padded rows of the output staging
constexpr int kSmemBytes = kRingBytes + kBarriers * 8 + 1024;
static_assert(kBM * kOutLd * 2 <= kRingBytes, "output staging fits the rings");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

struct Args {
  const bf16* x;  // [m, k], k % 8 == 0
  int m, k;
  const int8_t* w;  // [kp, np] (int4: [kp / 2, np]); kp, np % 128 == 0
  int kp, np;
  const float* scales;  // [n]
  const float* bias;    // [n] or null
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

template <int kBits>
__global__ void __launch_bounds__(kThreads, 1) gemm_kernel(const Args a) {
  static_assert(kBits == 8 || kBits == 4, "int8 or int4 weights");
  // 16-byte chunks of a packed weight tile: kBK (int4: kBK / 2) byte rows of kBN
  constexpr int kRawChunks = (kBits == 8 ? kBK : kBK / 2) * (kBN / 16);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + kRingBytes;
  auto xs = [&](int step) { return ring + (step % kXSlots) * kXBytes; };
  auto ws = [&](int step) { return ring + kXSlots * kXBytes + (step % kWSlots) * kWBytes; };
  auto raw = [&](int step) {
    return ring + kXSlots * kXBytes + kWSlots * kWBytes + (step % kRawSlots) * kRawBytes;
  };
  // a step's x and weights are ready; its x slot, its weight slot are free
  auto full = [&](int step) { return bars + (step % kXSlots) * 8; };
  auto x_free = [&](int step) { return bars + (kXSlots + step % kXSlots) * 8; };
  auto w_free = [&](int step) { return bars + (2 * kXSlots + step % kWSlots) * 8; };

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
          } else {
#pragma unroll
            for (int half = 0; half < 2; ++half) {  // byte row r: K rows 2r (low), 2r + 1 (high)
              int4 q;
              q.x = half ? nibbles_to_int8x4<true>(v[i].x) : nibbles_to_int8x4<false>(v[i].x);
              q.y = half ? nibbles_to_int8x4<true>(v[i].y) : nibbles_to_int8x4<false>(v[i].y);
              q.z = half ? nibbles_to_int8x4<true>(v[i].z) : nibbles_to_int8x4<false>(v[i].z);
              q.w = half ? nibbles_to_int8x4<true>(v[i].w) : nibbles_to_int8x4<false>(v[i].w);
              int8x16_to_bf16(q, lo[2 * i + half], hi[2 * i + half]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const int idx = p + i * kProducers, row = idx / (kBN / 16), c = idx % (kBN / 16);
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
        for (int i = 0; i < kBM * 8 / kProducers; ++i) {  // x: 128 rows x 8 chunks of 8 bf16
          const int idx = p + i * kProducers, row = idx >> 3, c = idx & 7, gk = k0 + c * 8;
          const bool ok = row < rows && gk < a.k;  // rows past m and columns past K are zero
          const bf16* src = ok ? a.x + (size_t)(m0 + row) * a.k + gk : a.x;
          cp_async16(xs(it) + swizzle128(row, c), src, ok ? 16 : 0);
        }
        const int k0_rows = kBits == 8 ? k0 : k0 / 2;
#pragma unroll
        for (int i = 0; i < (kRawChunks + kProducers - 1) / kProducers; ++i) {  // W, packed
          const int idx = p + i * kProducers, row = idx / (kBN / 16), c = idx % (kBN / 16);
          if (idx >= kRawChunks) break;
          cp_async16(raw(it) + idx * 16, a.w + (size_t)(k0_rows + row) * a.np + n0 + c * 16, 16);
        }
      }
      cp_async_commit();  // one group per step, empty past the end
    }
    return;
  }

  // ---- consumers: 128 rows x 128 columns each ----
  setmaxnreg_inc<168>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // rows 0..63 and 64..127 of the warpgroup: two m64n128 products a step; a
  // half whose rows all lie past m is not multiplied
  float acc[2][kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;
  const bool live[2] = {m0 + wg * 128 < a.m, m0 + wg * 128 + 64 < a.m};
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(full(kt), (kt / kXSlots) & 1);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      const uint32_t xa = xs(kt) + wg * 128 * 128 + s * 32;
      const uint64_t db = smem_desc(ws(kt) + s * 2048, kBK * 128, 1024);
      if (live[0]) wgmma_ss_n128<0, 1>(acc[0], smem_desc(xa, 16, 1024), db, 1);
      if (live[1]) wgmma_ss_n128<0, 1>(acc[1], smem_desc(xa + 64 * 128, 16, 1024), db, 1);
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();  // step kt - 1 has been multiplied: its slots are free
      if (lane == 0) {
        mbar_arrive(x_free(kt - 1));
        mbar_arrive(w_free(kt - 1));
      }
    }
  }
  wgmma_wait<0>();
  fence_registers(acc[0]);
  fence_registers(acc[1]);

  // epilogue: per half h, row r0 + 64h (and + 8), columns 8j + 2t, + 1 of the tile
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 128 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gn = n0 + j * 8 + 2 * t + e;
      const float sc = gn < a.n ? a.scales[gn] : 0.f;
      const float bi = (a.bias != nullptr && gn < a.n) ? a.bias[gn] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[h][4 * j + e] = fmaf(acc[h][4 * j + e], sc, bi);
        acc[h][4 * j + 2 + e] = fmaf(acc[h][4 * j + 2 + e], sc, bi);
      }
    }
  }
  if (a.n % 8) {  // rows of out are not 16-byte aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + r0 + 64 * h + 8 * (e >> 1), gn = n0 + j * 8 + 2 * t + (e & 1);
          if (row < a.m && gn < a.n)
            a.out[(size_t)row * a.n + gn] = __float2bfloat16(acc[h][4 * j + e]);
        }
      }
    }
    return;
  }
  named_barrier(1, kConsumers);  // both warpgroups have read their last slots
  bf16* stage = reinterpret_cast<bf16*>(smem_raw + (ring - smem_addr(smem_raw)));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 64 * h + 8 * r) * kOutLd + j * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
    }
  }
  named_barrier(1, kConsumers);
  for (int idx = tid; idx < kBM * (kBN / 8); idx += kConsumers) {
    const int r = idx / (kBN / 8), c = idx % (kBN / 8);
    if (m0 + r < a.m && n0 + c * 8 < a.n)
      *reinterpret_cast<int4*>(a.out + (size_t)(m0 + r) * a.n + n0 + c * 8) =
          *reinterpret_cast<const int4*>(stage + r * kOutLd + c * 8);
  }
}

// One block per 256 rows (fastest) and per 128 output columns.
template <int kBits>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = gemm_kernel<kBits>;
  static bool opted_in = false;  // above 48 KB of dynamic shared memory
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int col_blocks = a.np / kBN;
  if (a.m < 1 || col_blocks < 1 || col_blocks > 65535 || a.np % kBN || a.kp % kBK)
    return cudaErrorInvalidValue;
  kernel<<<dim3((a.m + kBM - 1) / kBM, col_blocks), kThreads, kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// The dense GEMM's C entry points (w8a16_gemm.cu, w4a16_gemm.cu) with
// per-channel scales.
template <int kBits>
int dense_entry(const void* x, int m, int k, const void* w, int kp, int np, const void* scales,
                const void* bias, void* out, int n, void* stream) {
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.m = m;
  a.k = k;
  a.w = static_cast<const int8_t*>(w);
  a.kp = kp;
  a.np = np;
  a.scales = static_cast<const float*>(scales);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  return launch<kBits>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace wgmma_gemm
}  // namespace eetq
