// Flash-decode: one query token per batch row against the dense KV cache
// [B, Hkv, L, D], each row to its own length; the cache is bf16, or int8
// with f32 per-(row, head, position) scales [B, Hkv, L]. In paged mode the
// cache is a pool of blocks [NB, Hkv, BS, D] (scales [NB, Hkv, BS]) shared
// by all rows, and a table [B, max_blocks] names the pool block of each
// logical block of a row.
//
// Replaces eetq_tpu/kernels/flash_decode.py::flash_decode and
// ::paged_flash_decode for S = 1, each in its bf16 and its int8 mode. Bound
// by the bytes of each row's live keys (about 2 operations a byte), so each
// cached key and value is read once: a block takes one kv head of one row
// and scores its whole GQA group against it.
//
// The plan (kernels/autotune.py::decode_plan, a function of the shapes
// only). The key range of every row is cut into chunks of
// `chunk` keys (a multiple of the tile) at multiples of `chunk`, so the
// same cache is cut the same way at any length; block (c, hk, b) takes
// chunk c of row b and kv head hk, and returns at once where the chunk
// starts at or past the row's length (chunk 0 always runs). Only the live
// keys are read, and nothing about the lengths leaves the card.
//
// The body. A chunk is walked in tiles of kTile keys. K, V and (int8) their
// f32 scales go into shared memory by cp.async in a ring of kStages tiles,
// the next tiles in flight while one is scored; keys at or past the row's
// length are zero-filled, never read. Rows are padded by 16 bytes so that
// every read pattern below hits distinct banks. Each warp takes its own keys
// of every tile and keeps its own online softmax (max, sum, output) in f32:
// it scores all its keys at once, then takes one max and one rescale per
// tile and q head, with exp2 and log2 e folded into the softmax scale.
// The arithmetic is on the tensor cores (mma.sync), 16 keys a warp. The GQA
// group's q rows, padded to 16, are the A operand of S = q K^T: in bf16 on
// m16n8k16 with K by ldmatrix; in int8 on the integer m16n8k32, K's bytes
// as they lie against q split into two int8 halves, q ~ s (hi + lo / 256)
// (s = max |q| / 127 per head: about 16 bits, exact int32 sums), so no key
// is widened for its score. The score accumulators are the A operand of
// O = P V on m16n8k16 (the FA2 register layout); V comes by ldmatrix.trans
// in bf16, or as 16 bytes of four keys a lane, byte-permuted and widened as
// csrc/gemv.cuh widens its weights, in int8. (One key a lane on the CUDA
// cores, the full D dot product from shared memory, was as fast or slower
// on every shape of the main paths: PERF.md.)
// int8 (as eetq_tpu/kernels/flash_decode.py:15-20): no dequantised cache is
// formed; the key's scale multiplies its score, the value's scale its
// probability in P V (the softmax sum takes the unscaled p).
//
// One launch. The warps' states merge in shared memory into one (max, sum,
// output) per chunk. A row with one live chunk writes its bf16 output
// there. Otherwise the chunk's state goes to a per-device f32 scratch and
// the block takes a ticket on the (row, kv head)'s int32 counter; the last
// block of the row's live chunks merges their states in chunk order, writes
// the output and resets the counter for the next launch. No float atomics:
// the output is the same from launch to launch, and the dense and paged
// modes, which differ only in the address of a tile, give bit-equal
// outputs on the same keys.
//
// Paged mode (kPaged): the tile starting at key p of row b lies in pool
// block table[b][p / BS] at offset p % BS; BS is a multiple of 128 and the
// tile divides 128, so a tile never straddles two pool blocks. A block reads
// the table entries of all its chunk's tiles at once, beside the row's
// length, but only the pool blocks of live tiles: entries past a row's live
// blocks may hold anything (the TPU kernel clamps its index map instead,
// flash_decode.py:278-289).
#include "hopper.cuh"

namespace {

using eetq::bf16;
namespace hp = eetq::hopper;

constexpr int kTile = EETQ_DECODE_TILE;  // keys of a stage (kernels/autotune.py::DECODE_TILE)
constexpr int kKeysPerWarp = 16;
constexpr int kWarps = kTile / kKeysPerWarp;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
// The most chunks a row may have: the last block keeps (weight, sum) of
// each chunk and q head in the ring (the smallest, int8 at D = 64, holds
// 31.5 KB). The plan lengthens the chunk where a cache would need more
// (kernels/autotune.py::DECODE_MAX_CHUNKS).
constexpr int kMaxChunks = EETQ_DECODE_MAX_CHUNKS;
// The longest chunk, in keys and in tiles (DECODE_MAX_CHUNK).
constexpr int kMaxChunk = EETQ_DECODE_MAX_CHUNK;
constexpr int kMaxTiles = kMaxChunk / kTile;
static_assert(kMaxTiles <= kThreads, "a thread reads the table entry of each tile");
static_assert(128 % kTile == 0 && kTile % 32 == 0, "a tile never straddles a pool block");

// The shared-memory layout of one stage: K rows, V rows (each D elements
// and 16 bytes of padding), then (int8) kTile K scales and kTile V scales.
template <int D, bool kInt8>
struct Layout {
  static constexpr int kElem = kInt8 ? 1 : 2;
  static constexpr int kGranules = D * kElem / 16;  // 16-byte pieces of a row
  static constexpr int kRow = D * kElem + 16;
  static constexpr int kTileBytes = kTile * kRow;
  static constexpr int kStage = 2 * kTileBytes + (kInt8 ? 2 * kTile * 4 : 0);
  static constexpr int kRing = kStages * kStage;
};

// One launch: kscale/vscale are null for bf16, table for a dense cache.
// Dense: the cache holds l keys a row. Paged: l = max_blocks * bs.
struct Params {
  const bf16* q;
  const void* k;
  const void* v;
  const float* kscale;
  const float* vscale;
  const int* table;
  const int* lengths;
  bf16* out;
  float* partials;  // [B, Hkv, chunks, G, D] outputs, then [B, Hkv, chunks, G, 2] (max, sum)
  int* counters;    // [B, Hkv], zero before the launch and after it
  int hq, hkv, l, max_blocks, bs, chunk, chunks;
  float scale_log2;  // the softmax scale times log2 e
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += A B on the integer tensor cores (A 16 x 32 and B 32 x 8 int8, d
// int32, exact), with A's rows 8-15 zero.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Word i of v (i a constant once the caller's loop is unrolled).
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A warp's 16 keys of a tile on the tensor cores. Lane (g, t)
// (g = lane / 4, t = lane % 4) holds q head g of the group (rows g >= G and
// the MMA's rows 8-15 are zero) and, after the score, the keys 2t, 2t + 1,
// 2t + 8 and 2t + 9 of the warp's 16 for that head.
template <int G, int D, bool kInt8>
struct Warp {
  using L = Layout<D, kInt8>;
  static constexpr int kSteps = D / 16;  // k16 steps of the bf16 score
  static constexpr int kSteps8 = D / 32;  // k32 steps of the int8 score
  static constexpr int kN = D / 8;       // n8 tiles of the output
  // A fragments of q (rows g; the rows g + 8 are zero). bf16: [k16 step]
  // (a0, a2). int8: q ~ qscale (hi + lo / 256) in two int8 halves,
  // [k32 step] (a0, a2) of hi, then of lo.
  uint32_t qa[kSteps][2];
  float qscale;
  float o[kN][4];  // [.][0, 1]: output of head g; [.][2, 3]: the zero rows
  float m = -INFINITY, l = 0.f;
  int warp, g, t;

  // q: the group's G heads [G, D].
  __device__ void init(const bf16* q, int tid) {
    warp = tid >> 5;
    g = (tid & 31) >> 2;
    t = tid & 3;
    const bf16* row = q + g * D;
    if constexpr (kInt8) {
      // dims 32s + 4t .. 4t + 3 and 32s + 16 + 4t .. 4t + 3 of step s
      float v[kSteps8][8];
      float mx = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps8; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint2 w = make_uint2(0u, 0u);
          if (g < G) w = *reinterpret_cast<const uint2*>(row + 32 * s + 16 * h + 4 * t);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
          v[s][4 * h] = lo.x;
          v[s][4 * h + 1] = lo.y;
          v[s][4 * h + 2] = hi.x;
          v[s][4 * h + 3] = hi.y;
#pragma unroll
          for (int i = 0; i < 4; ++i) mx = fmaxf(mx, fabsf(v[s][4 * h + i]));
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float inv = mx > 0.f ? 127.f / mx : 0.f;
      qscale = mx / 127.f;
#pragma unroll
      for (int s = 0; s < kSteps8; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi = 0u, lo = 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = v[s][4 * h + i] * inv;
            const int qh = __float2int_rn(x);
            const int ql = min(127, __float2int_rn((x - qh) * 256.f));
            hi |= (static_cast<uint32_t>(qh) & 0xFFu) << (8 * i);
            lo |= (static_cast<uint32_t>(ql) & 0xFFu) << (8 * i);
          }
          qa[s][h] = hi;
          qa[kSteps8 + s][h] = lo;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        qa[s][0] = qa[s][1] = 0u;
        if (g < G) {
          qa[s][0] = *reinterpret_cast<const uint32_t*>(row + 16 * s + 2 * t);
          qa[s][1] = *reinterpret_cast<const uint32_t*>(row + 16 * s + 8 + 2 * t);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  }

  // The tile whose first key is `key0`, staged at `st`; keys >= len masked.
  __device__ void tile(const unsigned char* st, int key0, int len, float scale_log2) {
    const int k0 = key0 + 16 * warp;
    if (k0 >= len) return;  // uniform over the warp
    const unsigned char* ks = st + 16 * warp * L::kRow;
    const unsigned char* vs = ks + L::kTileBytes;
    const int lane = 4 * g + t;
    float s[2][4] = {};  // n-tile 0 (keys 0-7), n-tile 1 (keys 8-15)
    if constexpr (kInt8) {
      // K's bytes are the B operand as they lie: lane (g, t) reads dims
      // 32 step + 4t .. 4t + 3 and + 16 of keys g and 8 + g, one word each
      int acc[2][2][4] = {};  // [hi, lo][n-tile]
#pragma unroll
      for (int step = 0; step < kSteps8; ++step) {
        const unsigned char* kg = ks + g * L::kRow + 32 * step + 4 * t;  // key g
        const uint32_t b00 = *reinterpret_cast<const uint32_t*>(kg);
        const uint32_t b01 = *reinterpret_cast<const uint32_t*>(kg + 16);
        const uint32_t b10 = *reinterpret_cast<const uint32_t*>(kg + 8 * L::kRow);  // key 8 + g
        const uint32_t b11 = *reinterpret_cast<const uint32_t*>(kg + 8 * L::kRow + 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t* a = qa[h * kSteps8 + step];
          mma_s8(acc[h][0], a[0], a[1], b00, b01);
          mma_s8(acc[h][1], a[0], a[1], b10, b11);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          s[n][j] = static_cast<float>(acc[0][n][j]) +
                    static_cast<float>(acc[1][n][j]) * (1.f / 256.f);
      }
    } else {
#pragma unroll
      for (int step = 0; step < kSteps; ++step) {
        uint32_t b[4];  // n-tile 0: b[0], b[1]; n-tile 1: b[2], b[3]
        // matrices (keys 0-7 | 8-15) x (dims 0-7 | 8-15 of the step)
        const int row = (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(b, hp::smem_addr(ks + row * L::kRow + 2 * (16 * step + ((lane >> 3) & 1) * 8)));
        eetq::mma_bf16(s[0], qa[step][0], 0u, qa[step][1], 0u, b[0], b[1]);
        eetq::mma_bf16(s[1], qa[step][0], 0u, qa[step][1], 0u, b[2], b[3]);
      }
    }
    // keys 2t, 2t + 1, 2t + 8, 2t + 9 of the warp's 16, for head g
    const int r = 16 * warp + 2 * t;  // row of key 2t in the tile
    float sc[4] = {s[0][0], s[0][1], s[1][0], s[1][1]};
    constexpr int kOff[4] = {0, 1, 8, 9};
    const float* kscale = reinterpret_cast<const float*>(st + 2 * L::kTileBytes);
    const float* vscale = kscale + kTile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mult = kInt8 ? scale_log2 * qscale * kscale[r + kOff[j]] : scale_log2;
      sc[j] = k0 + 2 * t + kOff[j] < len ? sc[j] * mult : -INFINITY;
    }
    // key k0 is live, so the max of each head is finite
    float mx = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float corr = exp2_approx(m - mn);
    m = mn;
    float p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = exp2_approx(sc[j] - mn);
    l = fmaf(l, corr, (p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      o[j][0] *= corr;
      o[j][1] *= corr;
    }
    if constexpr (kInt8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] *= vscale[r + kOff[j]];
    }
    const uint32_t a0 = eetq::pack_bf16x2(p[0], p[1]), a2 = eetq::pack_bf16x2(p[2], p[3]);
    if constexpr (kInt8) {
      // keys 2t, 2t + 1, 2t + 8, 2t + 9 at dims (D / 8) g .. (D / 8) (g + 1) - 1:
      // output column g of n-tile j is dim (D / 8) g + j
      constexpr int kBytes = D / 8;
      uint4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* src = vs + (2 * t + kOff[j]) * L::kRow + kBytes * g;
        if constexpr (kBytes == 16) {
          w[j] = *reinterpret_cast<const uint4*>(src);
        } else {
          const uint2 h = *reinterpret_cast<const uint2*>(src);
          w[j] = make_uint4(h.x, h.y, 0u, 0u);
        }
      }
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i) {  // n-tiles 4i .. 4i + 3: bytes of word i
        const uint32_t r0 = word(w[0], i), r1 = word(w[1], i);  // keys 2t, 2t + 1
        const uint32_t r2 = word(w[2], i), r3 = word(w[3], i);  // keys 2t + 8, 2t + 9
        eetq::mma_bf16(o[4 * i], a0, 0u, a2, 0u, eetq::int8_pair<0>(r0, r1),
                       eetq::int8_pair<0>(r2, r3));
        eetq::mma_bf16(o[4 * i + 1], a0, 0u, a2, 0u, eetq::int8_pair<1>(r0, r1),
                       eetq::int8_pair<1>(r2, r3));
        eetq::mma_bf16(o[4 * i + 2], a0, 0u, a2, 0u, eetq::int8_pair<2>(r0, r1),
                       eetq::int8_pair<2>(r2, r3));
        eetq::mma_bf16(o[4 * i + 3], a0, 0u, a2, 0u, eetq::int8_pair<3>(r0, r1),
                       eetq::int8_pair<3>(r2, r3));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; j += 2) {  // matrices (keys 0-7 | 8-15) x (dims 8j.. | 8j + 8..)
        uint32_t b[4];
        const int row = ((lane >> 3) & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(b, hp::smem_addr(vs + row * L::kRow + 2 * (8 * j + (lane >> 4) * 8)));
        eetq::mma_bf16(o[j], a0, 0u, a2, 0u, b[0], b[1]);
        eetq::mma_bf16(o[j + 1], a0, 0u, a2, 0u, b[2], b[3]);
      }
    }
  }

  // The warp's state into red_o [kWarps][G][D], red_m and red_l [kWarps][G].
  __device__ void stash(float* red_o, float* red_m, float* red_l) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (g >= G) return;
    float* ro = red_o + (warp * G + g) * D;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 2 * t + c;  // of n-tile j
        ro[kInt8 ? col * (D / 8) + j : 8 * j + col] = o[j][c];
      }
    }
    if (t == 0) {
      red_m[warp * G + g] = m;
      red_l[warp * G + g] = l;
    }
  }
};

// A softmax state: max, sum, output (of one head and dim).
struct State {
  float m = -INFINITY, l = 0.f, o = 0.f;
  __device__ float normalized() const { return l > 0.f ? o / l : 0.f; }  // 0: no live key
};


// The warps' states of a (head, dim) in shared memory, merged in warp order:
// warp i's at m[i * G], l[i * G] and o[i * G * D].
template <int G, int D>
__device__ __forceinline__ State merge_warps(const float* m, const float* l, const float* o) {
  State s;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s.m = fmaxf(s.m, m[i * G]);
  if (s.m == -INFINITY) return s;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const float w = exp2_approx(m[i * G] - s.m);
    s.o = fmaf(w, o[i * G * D], s.o);
    s.l = fmaf(w, l[i * G], s.l);
  }
  return s;
}

template <int G, int D, bool kInt8, bool kPaged>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const Params p) {
  using L = Layout<D, kInt8>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  __shared__ long long tile_base[kMaxTiles];  // paged: the pool index of each tile's first key

  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int start = c * p.chunk;
  if constexpr (kPaged) {
    // The table entries of the chunk's tiles, read beside the row's length,
    // all at once. Reading an entry is always in bounds; only the pool
    // blocks of live tiles are read.
    const int t0 = start + tid * kTile;
    if (tid < kMaxTiles && tid * kTile < p.chunk && t0 < p.l) {
      const int blk = t0 / p.bs;
      const long long pool_block = p.table[(size_t)b * p.max_blocks + blk];
      tile_base[tid] = (pool_block * p.hkv + hk) * p.bs + t0 - blk * p.bs;
    }
  }
  const int len = min(max(p.lengths[b], 0), p.l);
  if (c > 0 && start >= len) return;  // not a live chunk of this row (uniform over the block)
  const int end = min(len, start + p.chunk);
  const int ntiles = (max(end - start, 0) + kTile - 1) / kTile;
  const int nlive = max(1, (len + p.chunk - 1) / p.chunk);

  const char* kc = static_cast<const char*>(p.k);
  const char* vc = static_cast<const char*>(p.v);
  if constexpr (kPaged) __syncthreads();  // tile_base
  // Stage tile i of the chunk: its rows below the row's length, zeros past it.
  auto issue = [&](int i) {
    const int t0 = start + i * kTile;
    unsigned char* st = smem + (i % kStages) * L::kStage;
    // element index (in keys) of key t0
    const size_t base = kPaged ? tile_base[i] : ((size_t)b * p.hkv + hk) * p.l + t0;
    const int valid = end - t0;
    const char* kt = kc + base * D * L::kElem;
    const char* vt = vc + base * D * L::kElem;
    for (int idx = tid; idx < kTile * L::kGranules; idx += kThreads) {
      const int r = idx / L::kGranules, piece = idx % L::kGranules;
      const bool ok = r < valid;
      const size_t off = ok ? (size_t)r * D * L::kElem + 16 * piece : 0;
      const uint32_t dst = hp::smem_addr(st + r * L::kRow + 16 * piece);
      hp::cp_async16(dst, kt + off, ok ? 16 : 0);
      hp::cp_async16(dst + L::kTileBytes, vt + off, ok ? 16 : 0);
    }
    if constexpr (kInt8) {
      float* ss = reinterpret_cast<float*>(st + 2 * L::kTileBytes);
      for (int r = tid; r < kTile; r += kThreads) {
        const bool ok = r < valid;
        hp::cp_async4(hp::smem_addr(ss + r), p.kscale + base + (ok ? r : 0), ok ? 4 : 0);
        hp::cp_async4(hp::smem_addr(ss + kTile + r), p.vscale + base + (ok ? r : 0), ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) issue(i);
    hp::cp_async_commit();
  }
  Warp<G, D, kInt8> w;
  w.init(p.q + ((size_t)b * p.hq + hk * G) * D, tid);
  for (int i = 0; i < ntiles; ++i) {
    hp::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + kStages - 1 < ntiles) issue(i + kStages - 1);
    hp::cp_async_commit();
    w.tile(smem + (i % kStages) * L::kStage, start + i * kTile, len, p.scale_log2);
  }
  hp::cp_async_wait<0>();
  __syncthreads();

  // the warps' states over the ring, merged in warp order
  float* red_o = reinterpret_cast<float*>(smem);
  float* red_m = red_o + kWarps * G * D;
  float* red_l = red_m + kWarps * G;
  static_assert(4 * kWarps * G * (D + 2) <= L::kRing, "the warps' states fit in the ring");
  static_assert(4 * G * (2 * kMaxChunks + 1) <= L::kRing, "the chunks' weights fit in the ring");
  w.stash(red_o, red_m, red_l);
  __syncthreads();
  bf16* out = p.out + ((size_t)b * p.hq + hk * G) * D;
  if (nlive == 1) {
    for (int i = tid; i < G * D; i += kThreads) {
      const int h = i / D;
      out[i] = __float2bfloat16(merge_warps<G, D>(red_m + h, red_l + h, red_o + i).normalized());
    }
    return;
  }

  // the chunk's state into the scratch, then a ticket on the row's counter
  float* part_o = p.partials;
  float* part_ml = p.partials + (size_t)gridDim.z * p.hkv * p.chunks * G * D;
  const size_t row0 = ((size_t)b * p.hkv + hk) * p.chunks * G;  // state (chunk 0, head 0)
  const size_t mine = row0 + (size_t)c * G;
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i % D;
    const State st = merge_warps<G, D>(red_m + h, red_l + h, red_o + i);
    part_o[(mine + h) * D + d] = st.o;
    if (d == 0) {
      part_ml[2 * (mine + h)] = st.m;
      part_ml[2 * (mine + h) + 1] = st.l;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = p.counters + (size_t)b * p.hkv + hk;
    is_last = atomicAdd(ctr, 1) == nlive - 1;
    if (is_last) *ctr = 0;  // for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The row's live chunks in chunk order. The loads of another block's state
  // go through L2; none waits on another: (max, sum) of every (chunk, head)
  // at once into shared memory, then each thread's four dims of every chunk.
  float* wt = red_o;             // [nlive][G]: the chunk's max, then its weight
  float* sum = wt + nlive * G;   // [nlive][G]: the chunk's sum
  float* total = sum + nlive * G;  // [G]
  for (int i = tid; i < nlive * G; i += kThreads) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + row0 + i);
    wt[i] = ml.x;
    sum[i] = ml.y;
  }
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int j = 0; j < nlive; ++j) mx = fmaxf(mx, wt[j * G + tid]);
    float s = 0.f;
    for (int j = 0; j < nlive; ++j) {
      const float w = exp2_approx(wt[j * G + tid] - mx);
      wt[j * G + tid] = w;
      s = fmaf(w, sum[j * G + tid], s);
    }
    total[tid] = s;
  }
  __syncthreads();
  for (int i = 4 * tid; i < G * D; i += 4 * kThreads) {
    const int h = i / D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < nlive; ++j) {
      const float w = wt[j * G + h];
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(part_o + (row0 + (size_t)j * G) * D + i));
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
    const float inv = 1.f / total[h];
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(out + i + 2) =
        __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
}

template <int G, int D, bool kInt8, bool kPaged>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int kSmem = Layout<D, kInt8>::kRing;
  static bool opted_in = false;  // the shared-memory opt-in, once per instantiation
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_decode_kernel<G, D, kInt8, kPaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  flash_decode_kernel<G, D, kInt8, kPaged>
      <<<dim3(p.chunks, p.hkv, b), kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kInt8, bool kPaged>
cudaError_t launch_g(const Params& p, int b, cudaStream_t s) {
  switch (p.hq / p.hkv) {
    case 1: return launch<1, D, kInt8, kPaged>(p, b, s);
    case 2: return launch<2, D, kInt8, kPaged>(p, b, s);
    case 4: return launch<4, D, kInt8, kPaged>(p, b, s);
    case 8: return launch<8, D, kInt8, kPaged>(p, b, s);
    default: return cudaErrorInvalidValue;
  }
}

// Checks what every mode shares, sets the derived fields and dispatches on D.
template <bool kInt8, bool kPaged>
cudaError_t launch_d(Params p, int b, int d, void* stream) {
  if (b < 1 || p.hkv < 1 || p.hq % p.hkv || p.l < 1 || p.chunk < kTile || p.chunk % kTile ||
      p.chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  p.chunks = (p.l + p.chunk - 1) / p.chunk;
  p.scale_log2 *= eetq::kLog2e;
  if (p.chunks > 1 && (p.partials == nullptr || p.counters == nullptr))
    return cudaErrorInvalidValue;
  if (p.chunks > kMaxChunks) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_g<64, kInt8, kPaged>(p, b, s);
  if (d == 128) return launch_g<128, kInt8, kPaged>(p, b, s);
  return cudaErrorInvalidValue;
}

template <bool kInt8>
cudaError_t launch_paged(Params p, int b, int d, int max_blocks, int bs, void* stream) {
  if (bs < kTile || bs % kTile || max_blocks < 1) return cudaErrorInvalidValue;
  p.max_blocks = max_blocks;
  p.bs = bs;
  p.l = max_blocks * bs;
  return launch_d<kInt8, true>(p, b, d, stream);
}

}  // namespace

// q [b, 1, hq, d] bf16 contiguous; k/v cache [b, hkv, l, d] bf16 contiguous;
// lengths int32 [b]; out [b, 1, hq, d] bf16; chunk a multiple of
// EETQ_DECODE_TILE; with chunks = ceil(l / chunk) > 1, partials f32
// [b * hkv * chunks * (hq / hkv) * (d + 2)] and counters int32 [b * hkv],
// all zero (both are scratch, left as they were found).
extern "C" int eetq_flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                                 void* out, void* partials, void* counters, int b, int hq, int hkv,
                                 int l, int d, int chunk, float scale, void* stream) {
  const Params p{static_cast<const bf16*>(q), k, v, nullptr, nullptr, nullptr,
                 static_cast<const int*>(lengths), static_cast<bf16*>(out),
                 static_cast<float*>(partials), static_cast<int*>(counters),
                 hq, hkv, l, 0, 0, chunk, 0, scale};
  return launch_d<false, false>(p, b, d, stream);
}

// The int8 cache: k/v int8 [b, hkv, l, d] contiguous with f32 scales
// k_scale/v_scale [b, hkv, l]; everything else as eetq_flash_decode.
extern "C" int eetq_flash_decode_int8(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, void* out, void* partials,
                                      void* counters, int b, int hq, int hkv, int l, int d,
                                      int chunk, float scale, void* stream) {
  const Params p{static_cast<const bf16*>(q), k, v, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), nullptr, static_cast<const int*>(lengths),
                 static_cast<bf16*>(out), static_cast<float*>(partials),
                 static_cast<int*>(counters), hq, hkv, l, 0, 0, chunk, 0, scale};
  return launch_d<true, false>(p, b, d, stream);
}

// The paged cache: k/v pools bf16 [nb, hkv, bs, d] contiguous (bs a multiple
// of EETQ_DECODE_TILE); table int32 [b, max_blocks], entry (r, i) the pool
// block of keys [i * bs, (i + 1) * bs) of row r, used only for blocks that
// hold a key below lengths[r]; lengths int32 [b], at most max_blocks * bs;
// the chunks and scratch as eetq_flash_decode's with l = max_blocks * bs.
extern "C" int eetq_paged_flash_decode(const void* q, const void* k, const void* v,
                                       const void* table, const void* lengths, void* out,
                                       void* partials, void* counters, int b, int hq, int hkv,
                                       int max_blocks, int bs, int d, int chunk, float scale,
                                       void* stream) {
  const Params p{static_cast<const bf16*>(q), k, v, nullptr, nullptr,
                 static_cast<const int*>(table), static_cast<const int*>(lengths),
                 static_cast<bf16*>(out), static_cast<float*>(partials),
                 static_cast<int*>(counters), hq, hkv, 0, 0, 0, chunk, 0, scale};
  return launch_paged<false>(p, b, d, max_blocks, bs, stream);
}

// The int8 paged cache: pools int8 [nb, hkv, bs, d] with f32 scale pools
// k_scale/v_scale [nb, hkv, bs]; everything else as eetq_paged_flash_decode.
extern "C" int eetq_paged_flash_decode_int8(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* table, const void* lengths, void* out,
                                            void* partials, void* counters, int b, int hq,
                                            int hkv, int max_blocks, int bs, int d, int chunk,
                                            float scale, void* stream) {
  const Params p{static_cast<const bf16*>(q), k, v, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), static_cast<const int*>(table),
                 static_cast<const int*>(lengths), static_cast<bf16*>(out),
                 static_cast<float*>(partials), static_cast<int*>(counters), hq, hkv, 0, 0, 0,
                 chunk, 0, scale};
  return launch_paged<true>(p, b, d, max_blocks, bs, stream);
}
