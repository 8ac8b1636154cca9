// Flash-decode: S query tokens per batch row against the dense KV cache
// [B, Hkv, L, D], each row to its own length; the cache is bf16, or int8
// with f32 per-(row, head, position) scales [B, Hkv, L]. In paged mode the
// cache is a pool of blocks [NB, Hkv, BS, D] (scales [NB, Hkv, BS]) shared
// by all rows, and a table [B, max_blocks] names the pool block of each
// logical block of a row. S = 1 is the decode step; S > 1 the multi-query
// verify of speculative decoding: query token i of a row sits at position
// length - S + i and sees the keys at or before it (per-row causal).
//
// Replaces eetq_tpu/kernels/flash_decode.py::flash_decode and
// ::paged_flash_decode (_fd_kernel, with sq = 1 and sq > 1), each in its
// bf16 and its int8 mode. Bound by the bytes of each row's live keys (about
// 2 operations a byte a query token), so each cached key and value is read
// once: a block takes one kv head of one row and scores all its query rows
// against it, the GQA group's G heads times the S query tokens.
//
// The plan (kernels/autotune.py::decode_plan, a function of the shapes
// only). The key range of every row is cut into chunks of
// `chunk` keys (a multiple of the tile) at multiples of `chunk`, so the
// same cache is cut the same way at any length; block (c, hk, b) takes
// chunk c of row b and kv head hk, and returns at once where the chunk
// starts at or past the row's length (chunk 0 always runs; under a window,
// the first chunk of the earliest row's window, below). Only the live keys
// are read, and nothing about the lengths leaves the card.
//
// The body. A chunk is walked in tiles of kTile keys. K, V and (int8) their
// f32 scales go into shared memory by cp.async in a ring of kStages tiles,
// the next tiles in flight while one is scored; keys at or past the row's
// length are zero-filled, never read. Rows are padded by 16 bytes so that
// every read pattern below hits distinct banks. Each warp takes its own keys
// of every tile and keeps its own online softmax (max, sum, output) in f32:
// it scores all its keys at once, then takes one max and one rescale per
// tile and query row, with exp2 and log2 e folded into the softmax scale.
// The arithmetic is on the tensor cores (mma.sync), 16 keys a warp. The
// query rows of a kv head are the A operand of S = q K^T, 16 rows an M
// tile: in bf16 on m16n8k16 with K by ldmatrix; in int8 on the integer
// m16n8k32, K's bytes as they lie against q split into two int8 halves,
// q ~ s (hi + lo / 256) (s = max |q| / 127 per query row: about 16 bits,
// exact int32 sums), so no key is widened for its score. The score
// accumulators are the A operand of O = P V on m16n8k16 (the FA2 register
// layout); V comes by ldmatrix.trans in bf16, or as 16 bytes of four keys a
// lane, byte-permuted and widened as csrc/gemv.cuh widens its weights, in
// int8. (One key a lane on the CUDA cores, the full D dot product from
// shared memory, was as fast or slower on every shape of the main paths:
// PERF.md.)
// int8 (as eetq_tpu/kernels/flash_decode.py:15-20): no dequantised cache is
// formed; the key's scale multiplies its score, the value's scale its
// probability in P V (the softmax sum takes the unscaled p).
//
// Query rows. Row r = s G + g of a kv head is q head hk G + g of query
// token s; up to 8 rows take the top half of one M tile (rows 8-15 zero:
// a decode step's G <= 8 heads); more take whole M tiles, one warp of
// each M tile per 16 keys, so a block stages each K/V tile once for all
// its rows (kRows = 8, 16, 32 or 64 rows; 128, 128, 256 or 512 threads).
// A row sees what an S = 1 call at its own length len - S + s + 1 sees:
// the same chunks, tiles and warps, its keys past its length masked, and
// where a warp has no live key of a row in a tile (the S = 1 call's warp
// returns there) the row's update is the identity (rescale 1, p 0), so no
// fully masked row ever forms exp2(-inf + inf). Rows merge only their own
// live chunks, and a row with one live chunk writes its output from that
// chunk's block, as the S = 1 call does: row i is bit-equal to that call.
// The decode step itself (S = 1, G in EETQ_DECODE_STEP_GROUPS) is compiled
// apart for each G (template kG): the group a constant, one length for every row, no
// per-row masks or identity updates, so the step every decode path runs a
// layer pays nothing for the verify's mode.
//
// One launch. The warps' states merge in shared memory into one (max, sum,
// output) per chunk and row. A row with one live chunk writes its bf16
// output there. Otherwise the chunk's state goes to a per-device f32 scratch
// and the block takes a ticket on the (row, kv head)'s int32 counter; the
// last block of the row's live chunks merges their states in chunk order (as
// many query rows a pass as shared memory holds the weights of), writes the
// output and resets the counter for the next launch. No float atomics: the
// output is the same from launch to launch, and the dense and paged modes,
// which differ only in the address of a tile, give bit-equal outputs on the
// same keys.
//
// Paged mode (kPaged): the tile starting at key p of row b lies in pool
// block table[b][p / BS] at offset p % BS; BS is a multiple of 128 and the
// tile divides 128, so a tile never straddles two pool blocks. A block reads
// the table entries of all its chunk's tiles at once, beside the row's
// length, but only the pool blocks of live tiles: entries past a row's live
// blocks may hold anything (the TPU kernel clamps its index map instead,
// flash_decode.py:278-289).
//
// Position-dependent variants (flash_decode.py:98-118, :139-181), each a
// template flag compiled apart from the plain body, one source each
// (flash_decode.cu, flash_decode_window.cu, flash_decode_alibi.cu,
// flash_decode_window_alibi.cu, built in parallel):
//   - kWindow (sliding window, mistral): a row at length n sees the keys
//     n - window <= key < n. The row's live chunks are [lo, hi] with lo its
//     window start's chunk, so "chunk 0 always runs" becomes "the earliest
//     row's first live chunk always runs": a block whose chunk ends before
//     that row's window start returns at once, as a dead chunk past the
//     length does; the ticket counts the chunks [lo, hi] of the block's rows,
//     and a row with one live chunk writes from that chunk's block. Inside
//     the first live chunk the tiles wholly before the window are not
//     loaded; a warp whose 16 keys all lie before a row's window takes the
//     identity update for that row (the S = 1 call's warp returns there), so
//     each verify token stays bit-equal to an S = 1 call under a window too.
//   - kAlibi (baichuan-13b): slope_h * log2 e * (key - qpos) is added to a
//     row's score after the scale (and the int8 key scale), qpos = its
//     length - 1; slopes [Hq] f32, read once per row at the block's start.
// Any GQA group and any count of query tokens. A block takes up to 64 query
// rows of its kv head (G * S) at D = 64 and 128, 32 at D = 256, where the
// warps' states of 64 rows (4 kWarps 64 (D + 2) bytes, 258 KB) would not fit
// its shared memory (kMaxRowsOf, kernels/autotune.py::max_query_rows). More
// rows are cut into row blocks of that many: block (c, hk * R + rb, b) takes
// rows [rb kRows, (rb + 1) kRows) of kv head hk, its live chunks those of its
// own rows' tokens, a ticket counter of its own per (row, kv head, row
// block). A row's arithmetic does not depend on the block that holds it (its
// M-tile row, its own length, mask, identity updates and merge), so it stays
// bit-equal to an S = 1 call, and paged to dense; K and V are read once per
// row block. The decode step of
// the groups in EETQ_DECODE_STEP_GROUPS (kernels/autotune.py) is compiled
// apart per G (kG <= 8: the top half of one M tile; kG = 16: one whole M
// tile); any other group takes the multi-query body.
//
// Head dim 256 (gemma-7b) runs the same body: a bf16 stage of 64 keys is
// 67.6 KB (rows of 528 bytes), three stages 198 KB, one block an SM; a lane
// holds 128 f32 of the output accumulator, and in int8 reads 32 bytes of
// each of its four keys' V rows a tile.
#pragma once

#include "hopper.cuh"

namespace eetq_fd {

using eetq::bf16;

// One launch: kscale/vscale are null for bf16, table for a dense cache,
// slopes without ALiBi; window 0 without a window. Dense: the cache holds l
// keys a row. Paged: l = max_blocks * bs.
struct Params {
  const bf16* q;
  const void* k;
  const void* v;
  const float* kscale;
  const float* vscale;
  const int* table;
  const int* lengths;
  const float* slopes;  // [Hq] ALiBi slopes, or null
  bf16* out;
  float* partials;  // [B, Hkv, chunks, rows, D] outputs, then [B, Hkv, chunks, rows, 2] (max, sum)
  int* counters;    // [B, Hkv, row blocks], zero before the launch and after it
  int s, hq, hkv, l, max_blocks, bs, chunk, chunks;
  int group, rows;  // q heads of a kv head; query rows of a kv head (group * s)
  int window;       // keys a row sees under a sliding window (0: all)
  float scale_log2;  // the softmax scale times log2 e
};

// The launches of one variant (window, ALiBi), each defined in its own source
cudaError_t launch_plain(const Params& p, int b, int d, bool int8, bool paged, cudaStream_t s);
cudaError_t launch_window(const Params& p, int b, int d, bool int8, bool paged, cudaStream_t s);
cudaError_t launch_alibi(const Params& p, int b, int d, bool int8, bool paged, cudaStream_t s);
cudaError_t launch_window_alibi(const Params& p, int b, int d, bool int8, bool paged,
                                cudaStream_t s);

}  // namespace eetq_fd

namespace {

using eetq::bf16;
using eetq_fd::Params;
namespace hp = eetq::hopper;

constexpr int kTile = EETQ_DECODE_TILE;  // keys of a stage (kernels/autotune.py::DECODE_TILE)
constexpr int kKeysPerWarp = 16;
constexpr int kWarps = kTile / kKeysPerWarp;  // warps over the keys of a tile (per M tile)
constexpr int kStages = 3;
// The most chunks a row may have: the last block keeps (weight, sum) of
// each chunk and query row of a merge pass in the ring, at least one row
// (the smallest ring, int8 at D = 64, holds 31.5 KB: 8 rows of the most
// chunks, so a decode step of G <= 8 merges in one pass; the D = 256 rings
// are larger, 103.5 KB in int8 and 198 KB in bf16). The plan
// lengthens the chunk where a cache would need more
// (kernels/autotune.py::DECODE_MAX_CHUNKS).
constexpr int kMaxChunks = EETQ_DECODE_MAX_CHUNKS;
// The longest chunk, in keys and in tiles (DECODE_MAX_CHUNK).
constexpr int kMaxChunk = EETQ_DECODE_MAX_CHUNK;
constexpr int kMaxTiles = kMaxChunk / kTile;
constexpr int kMaxRows = 64;  // query rows of a block: q heads times query tokens
// ... at head dim D: the most rows whose warps' states fit the 227 KB of
// shared memory a block may take (64 at D <= 128, 32 at D = 256); a launch of
// more rows cuts them into row blocks of this many
template <int D>
constexpr int kMaxRowsOf =
    4 * kWarps * kMaxRows * (D + 2) <= 227 * 1024 ? kMaxRows : kMaxRows / 2;
// The groups whose decode step (S = 1) is compiled apart
constexpr unsigned kStepGroups = EETQ_DECODE_STEP_GROUPS;
static_assert(kMaxTiles <= 32 * kWarps, "a thread reads the table entry of each tile");
static_assert(128 % kTile == 0 && kTile % 32 == 0, "a tile never straddles a pool block");

// M tiles of 16 rows a block runs for kRows query rows (8 rows: the top half of one)
template <int kRows>
constexpr int kTilesM = kRows <= 16 ? 1 : kRows / 16;
template <int kRows>
constexpr int kThreads = 32 * kWarps * kTilesM<kRows>;

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
// int32, exact); a1 and a3 hold A's rows 8-15.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Word i of v (i a constant once the caller's loop is unrolled).
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A warp's 16 keys of a tile on the tensor cores, for the 16 query rows of
// its M tile (the top 8 where kRows = 8). Lane (g, t) (g = lane / 4,
// t = lane % 4) holds the rows g and g + 8 of the M tile (half 0 and 1)
// and, after the score, the keys 2t, 2t + 1, 2t + 8 and 2t + 9 of the
// warp's 16 for each. kG > 0 is the decode step (S = 1; kRows = 8 for
// kG <= 8, 16 for kG = 16) of a group of kG heads, compiled apart: every row
// sees the row's length and takes every update, with no per-row mask; kG = 0
// is the multi-query mode (S and the group at run time). kWindow: a row sees
// its keys from lo; kAlibi: its scores take slope (key - qpos).
template <int kRows, int kG, int D, bool kInt8, bool kWindow, bool kAlibi>
struct Warp {
  using L = Layout<D, kInt8>;
  static constexpr int kHalves = kRows == 8 ? 1 : 2;
  static constexpr int kSteps = D / 16;  // k16 steps of the bf16 score
  static constexpr int kSteps8 = D / 32;  // k32 steps of the int8 score
  static constexpr int kN = D / 8;       // n8 tiles of the output
  // A fragments of q per half. bf16: [k16 step] (a0, a2) of the half's
  // row. int8: q ~ qscale (hi + lo / 256) in two int8 halves, [k32 step]
  // (a0, a2) of hi, then of lo.
  uint32_t qa[kHalves][kSteps][2];
  float qscale[kHalves];
  float o[kN][4];  // [.][0, 1]: output of row g; [.][2, 3]: of row g + 8
  float m[kHalves], l[kHalves];
  int len[kHalves];  // keys the half's row sees (0: a padding row)
  int lo[kHalves];   // kWindow: the half's row's first key
  float slope[kHalves];  // kAlibi: the half's row's slope times log2 e
  int warp_len;      // the most keys any row of the warp sees (uniform over the warp)
  int warp_lo;       // kWindow: the least first key of the warp's rows (uniform)
  int kw, row0, g, t;  // key warp; the M tile's first row

  // q: query row 0 of the block's kv head (q[b, 0, hk G]); len_max the
  // row's length (query token S - 1's); head0 the kv head's first q head;
  // rbase the block's first query row (its row block's).
  __device__ void init(const bf16* q, const Params& p, int len_max, int head0, int rbase,
                       int tid) {
    const int warp = tid >> 5;
    kw = warp % kWarps;
    row0 = (warp / kWarps) * 16;
    g = (tid & 31) >> 2;
    t = tid & 3;
#pragma unroll
    for (int j = 0; j < kN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    if constexpr (kG > 0) {
      static_assert(kG <= kRows && kRows == (kG <= 8 ? 8 : 16),
                    "the decode step's group is the top half of an M tile, or the tile");
      warp_len = len_max;
      warp_lo = kWindow ? max(len_max - p.window, 0) : 0;
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int r = g + 8 * h;
        const bool valid = r < kG;  // rows r >= G: zero q, masked as the others
        len[h] = len_max;
        lo[h] = warp_lo;
        if constexpr (kAlibi) slope[h] = valid ? p.slopes[head0 + r] * eetq::kLog2e : 0.f;
        load_q(q + (valid ? r : 0) * D, valid, h);
        m[h] = -INFINITY;
        l[h] = 0.f;
      }
      return;
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int r = rbase + row0 + g + 8 * h;
      const bool valid = r < p.rows;
      const int s = valid ? r / p.group : 0;
      len[h] = valid ? max(len_max - p.s + s + 1, 0) : 0;
      if constexpr (kWindow) lo[h] = max(len[h] - p.window, 0);
      if constexpr (kAlibi) slope[h] = valid ? p.slopes[head0 + r % p.group] * eetq::kLog2e : 0.f;
      load_q(q + ((size_t)s * p.hq + (valid ? r % p.group : 0)) * D, valid, h);
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
    // rows grow in s: the warp's last valid row sees the most keys, its first
    // the least first key
    const int first = rbase + row0, last = min(p.rows, first + 8 * kHalves) - 1;
    warp_len = last < first ? 0 : max(len_max - p.s + last / p.group + 1, 0);
    if constexpr (kWindow)
      warp_lo = max(max(len_max - p.s + min(first, p.rows - 1) / p.group + 1, 0) - p.window, 0);
  }

  // The half's row of q [D] (zero where the row is padding).
  __device__ void load_q(const bf16* row, bool valid, int h) {
    if constexpr (kInt8) {
      // dims 32s + 4t .. 4t + 3 and 32s + 16 + 4t .. 4t + 3 of step s
      float v[kSteps8][8];
      float mx = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps8; ++s) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint2 w = make_uint2(0u, 0u);
          if (valid) w = *reinterpret_cast<const uint2*>(row + 32 * s + 16 * i + 4 * t);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
          v[s][4 * i] = lo.x;
          v[s][4 * i + 1] = lo.y;
          v[s][4 * i + 2] = hi.x;
          v[s][4 * i + 3] = hi.y;
#pragma unroll
          for (int e = 0; e < 4; ++e) mx = fmaxf(mx, fabsf(v[s][4 * i + e]));
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float inv = mx > 0.f ? 127.f / mx : 0.f;
      qscale[h] = mx / 127.f;
#pragma unroll
      for (int s = 0; s < kSteps8; ++s) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hi = 0u, lo = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = v[s][4 * i + e] * inv;
            const int qh = __float2int_rn(x);
            const int ql = min(127, __float2int_rn((x - qh) * 256.f));
            hi |= (static_cast<uint32_t>(qh) & 0xFFu) << (8 * e);
            lo |= (static_cast<uint32_t>(ql) & 0xFFu) << (8 * e);
          }
          qa[h][s][i] = hi;
          qa[h][kSteps8 + s][i] = lo;
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        qa[h][s][0] = qa[h][s][1] = 0u;
        if (valid) {
          qa[h][s][0] = *reinterpret_cast<const uint32_t*>(row + 16 * s + 2 * t);
          qa[h][s][1] = *reinterpret_cast<const uint32_t*>(row + 16 * s + 8 + 2 * t);
        }
      }
    }
  }

  // The tile whose first key is `key0`, staged at `st`; each row's keys
  // past its length masked.
  __device__ void tile(const unsigned char* st, int key0, float scale_log2) {
    const int k0 = key0 + 16 * kw;
    if (k0 >= warp_len) return;  // uniform over the warp
    if constexpr (kWindow) {
      if (k0 + 16 <= warp_lo) return;  // before every row's window: uniform too
    }
    const unsigned char* ks = st + 16 * kw * L::kRow;
    const unsigned char* vs = ks + L::kTileBytes;
    const int lane = 4 * g + t;
    float s[2][4] = {};  // n-tile 0 (keys 0-7), n-tile 1 (keys 8-15); [2, 3]: row g + 8
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
        for (int i = 0; i < 2; ++i) {
          const int k = i * kSteps8 + step;
          const uint32_t a0 = qa[0][k][0], a2 = qa[0][k][1];
          uint32_t a1 = 0u, a3 = 0u;
          if constexpr (kHalves == 2) {
            a1 = qa[kHalves - 1][k][0];
            a3 = qa[kHalves - 1][k][1];
          }
          mma_s8(acc[i][0], a0, a1, a2, a3, b00, b01);
          mma_s8(acc[i][1], a0, a1, a2, a3, b10, b11);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int j = 0; j < 2 * kHalves; ++j)
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
        const uint32_t a0 = qa[0][step][0], a2 = qa[0][step][1];
        uint32_t a1 = 0u, a3 = 0u;
        if constexpr (kHalves == 2) {
          a1 = qa[kHalves - 1][step][0];
          a3 = qa[kHalves - 1][step][1];
        }
        eetq::mma_bf16(s[0], a0, a1, a2, a3, b[0], b[1]);
        eetq::mma_bf16(s[1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    // keys 2t, 2t + 1, 2t + 8, 2t + 9 of the warp's 16, for row g (+ 8 h)
    const int r = 16 * kw + 2 * t;  // row of key 2t in the tile
    constexpr int kOff[4] = {0, 1, 8, 9};
    const float* kscale = reinterpret_cast<const float*>(st + 2 * L::kTileBytes);
    const float* vscale = kscale + kTile;
    uint32_t pa[kHalves][2];  // P's A fragments: (a0, a2) of row g, (a1, a3) of row g + 8
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      float sc[4] = {s[0][2 * h], s[0][2 * h + 1], s[1][2 * h], s[1][2 * h + 1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float mult = kInt8 ? scale_log2 * qscale[h] * kscale[r + kOff[j]] : scale_log2;
        const int key = k0 + 2 * t + kOff[j];
        bool seen = key < len[h];
        if constexpr (kWindow) seen = seen && key >= lo[h];
        float v = sc[j] * mult;
        if constexpr (kAlibi) v += slope[h] * static_cast<float>(key - (len[h] - 1));
        sc[j] = seen ? v : -INFINITY;
      }
      // A row with a live key among the warp's 16 takes the S = 1 call's
      // update (its max is then finite); one without keeps its state. The
      // decode step's rows all have one (the warp returned otherwise).
      bool live = kG > 0 || k0 < len[h];  // uniform over the row's four lanes
      if constexpr (kWindow) live = live && (kG > 0 || k0 + 16 > lo[h]);
      float mx = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      const float corr = live ? exp2_approx(m[h] - mn) : 1.f;
      m[h] = mn;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = live ? exp2_approx(sc[j] - mn) : 0.f;
      if (live) l[h] = fmaf(l[h], corr, (p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        o[j][2 * h] *= corr;
        o[j][2 * h + 1] *= corr;
      }
      if constexpr (kInt8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] *= vscale[r + kOff[j]];
      }
      pa[h][0] = eetq::pack_bf16x2(p[0], p[1]);
      pa[h][1] = eetq::pack_bf16x2(p[2], p[3]);
    }
    const uint32_t a0 = pa[0][0], a2 = pa[0][1];
    uint32_t a1 = 0u, a3 = 0u;
    if constexpr (kHalves == 2) {
      a1 = pa[kHalves - 1][0];
      a3 = pa[kHalves - 1][1];
    }
    if constexpr (kInt8) {
      // keys 2t, 2t + 1, 2t + 8, 2t + 9 at dims (D / 8) g .. (D / 8) (g + 1) - 1:
      // output column g of n-tile j is dim (D / 8) g + j. 16 bytes of each
      // key a pass (8 at D = 64; two passes at D = 256, so that a lane holds
      // only one pass's words)
      constexpr int kBytes = D / 8;
      constexpr int kWords = kBytes >= 16 ? 4 : kBytes / 4;  // words of a pass
#pragma unroll
      for (int u = 0; u < kBytes / (4 * kWords); ++u) {
        uint4 w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned char* src = vs + (2 * t + kOff[j]) * L::kRow + kBytes * g + 16 * u;
          if constexpr (kBytes >= 16) {
            w[j] = *reinterpret_cast<const uint4*>(src);
          } else {
            const uint2 h = *reinterpret_cast<const uint2*>(src);
            w[j] = make_uint4(h.x, h.y, 0u, 0u);
          }
        }
#pragma unroll
        for (int i = 0; i < kWords; ++i) {  // n-tiles 4n .. 4n + 3: bytes of word n
          const int n = kWords * u + i;
          const uint32_t r0 = word(w[0], i), r1 = word(w[1], i);  // keys 2t, 2t + 1
          const uint32_t r2 = word(w[2], i), r3 = word(w[3], i);  // keys 2t + 8, 2t + 9
          eetq::mma_bf16(o[4 * n], a0, a1, a2, a3, eetq::int8_pair<0>(r0, r1),
                         eetq::int8_pair<0>(r2, r3));
          eetq::mma_bf16(o[4 * n + 1], a0, a1, a2, a3, eetq::int8_pair<1>(r0, r1),
                         eetq::int8_pair<1>(r2, r3));
          eetq::mma_bf16(o[4 * n + 2], a0, a1, a2, a3, eetq::int8_pair<2>(r0, r1),
                         eetq::int8_pair<2>(r2, r3));
          eetq::mma_bf16(o[4 * n + 3], a0, a1, a2, a3, eetq::int8_pair<3>(r0, r1),
                         eetq::int8_pair<3>(r2, r3));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; j += 2) {  // matrices (keys 0-7 | 8-15) x (dims 8j.. | 8j + 8..)
        uint32_t b[4];
        const int row = ((lane >> 3) & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(b, hp::smem_addr(vs + row * L::kRow + 2 * (8 * j + (lane >> 4) * 8)));
        eetq::mma_bf16(o[j], a0, a1, a2, a3, b[0], b[1]);
        eetq::mma_bf16(o[j + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
  }

  // The warp's states into red_o [kWarps][kRows][D], red_m and red_l
  // [kWarps][kRows], at its key warp and its rows.
  __device__ void stash(float* red_o, float* red_m, float* red_l, int rows) {
    if constexpr (kG > 0) rows = kG;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int row = row0 + g + 8 * h;
      if (row >= rows) continue;
      float* ro = red_o + (kw * kRows + row) * D;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 2 * t + c;  // of n-tile j
          ro[kInt8 ? col * (D / 8) + j : 8 * j + col] = o[j][2 * h + c];
        }
      }
      if (t == 0) {
        red_m[kw * kRows + row] = m[h];
        red_l[kw * kRows + row] = l[h];
      }
    }
  }
};

// A softmax state: max, sum, output (of one head and dim).
struct State {
  float m = -INFINITY, l = 0.f, o = 0.f;
  __device__ float normalized() const { return l > 0.f ? o / l : 0.f; }  // 0: no live key
};


// The key warps' states of a (row, dim) in shared memory, merged in warp
// order: warp i's at m[i * kRows], l[i * kRows] and o[i * kRows * D].
template <int kRows, int D>
__device__ __forceinline__ State merge_warps(const float* m, const float* l, const float* o) {
  State s;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s.m = fmaxf(s.m, m[i * kRows]);
  if (s.m == -INFINITY) return s;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const float w = exp2_approx(m[i * kRows] - s.m);
    s.o = fmaf(w, o[i * kRows * D], s.o);
    s.l = fmaf(w, l[i * kRows], s.l);
  }
  return s;
}

// Dynamic shared memory of a block: the ring, reused for the warps' states.
template <int kRows, int D, bool kInt8>
constexpr int kSmem = Layout<D, kInt8>::kRing > 4 * kWarps * kRows * (D + 2)
                          ? Layout<D, kInt8>::kRing
                          : 4 * kWarps * kRows * (D + 2);

template <int kRows, int kG, int D, bool kInt8, bool kPaged, bool kWindow, bool kAlibi>
__global__ void __launch_bounds__(kThreads<kRows>) flash_decode_kernel(const Params p) {
  using L = Layout<D, kInt8>;
  constexpr int kT = kThreads<kRows>;
  // query rows of the kv head (the stride of the scratch's states), and q
  // heads of a query token: constants in the decode step
  const int kv_rows = kG > 0 ? kG : p.rows;
  const int group = kG > 0 ? kG : p.group;
  const int nq = kG > 0 ? 1 : p.s;
  // row blocks of the kv head: this block's rows [rbase, rbase + rows) and
  // the tokens they hold, [s_first, s_last] (one block in the decode step)
  const int nrb = kG > 0 ? 1 : (kv_rows + kRows - 1) / kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  __shared__ long long tile_base[kMaxTiles];  // paged: the pool index of each tile's first key

  const int c = blockIdx.x, b = blockIdx.z;
  const int hk = kG > 0 ? blockIdx.y : blockIdx.y / nrb, rb = kG > 0 ? 0 : blockIdx.y % nrb;
  const int tid = threadIdx.x;
  const int rbase = rb * kRows, rows = kG > 0 ? kG : min(kRows, kv_rows - rbase);
  const int s_first = kG > 0 ? 0 : rbase / group, s_last = kG > 0 ? 0 : (rbase + rows - 1) / group;
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
  // the row's length: query token S - 1's; token s sees len - S + s + 1 keys
  const int len = min(max(p.lengths[b], 0), p.l);
  // the keys the block's last token sees, the earliest of its rows' first
  // key (token s_first's window start) and the block's live chunks
  // [c_lo, c_hi]: c_lo always runs
  const int blen = max(len - nq + s_last + 1, 0);
  const int lo = kWindow ? max(max(len - nq + s_first + 1, 0) - p.window, 0) : 0;
  const int c_lo = kWindow ? lo / p.chunk : 0;
  // not a live chunk of this block's rows (uniform over the block)
  if (c < c_lo || (c > c_lo && start >= blen)) return;
  const int end = min(blen, start + p.chunk);
  const int ntiles = (max(end - start, 0) + kTile - 1) / kTile;
  const int c_hi = max(1, (blen + p.chunk - 1) / p.chunk) - 1;  // (>= c_lo: lo < blen or 0)
  const int t_first = kWindow ? max(lo - start, 0) / kTile : 0;  // tiles before it: no row's
  // Per query row rbase + r of the block (token s = r / G, head r % G): its
  // live chunks [lo, hi] and the offset of its output, once, for the merges
  // (read after the tile loop's last barrier)
  // (the decode step's rows all have the block's chunks)
  __shared__ int row_lo[kG > 0 ? 1 : kRows], row_hi[kG > 0 ? 1 : kRows];
  __shared__ long long row_out[kG > 0 ? 1 : kRows];
  if constexpr (kG == 0) {
    if (tid < rows) {
      const int r = rbase + tid, s = r / p.group;
      const int n = max(len - p.s + s + 1, 0);
      const int first = kWindow ? max(n - p.window, 0) / p.chunk : 0;
      row_lo[tid] = first;
      row_hi[tid] = max(1, (n + p.chunk - 1) / p.chunk) - 1;
      row_out[tid] = (((long long)b * p.s + s) * p.hq + hk * p.group + r % p.group) * D;
    }
  }
  auto lo_of = [&](int r) { return kG > 0 ? c_lo : row_lo[r]; };
  auto hi_of = [&](int r) { return kG > 0 ? c_hi : row_hi[r]; };
  auto out_of = [&](int r) -> long long {
    return kG > 0 ? ((long long)b * p.hq + hk * kG + r) * D : row_out[r];
  };

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
    for (int idx = tid; idx < kTile * L::kGranules; idx += kT) {
      const int r = idx / L::kGranules, piece = idx % L::kGranules;
      const bool ok = r < valid;
      const size_t off = ok ? (size_t)r * D * L::kElem + 16 * piece : 0;
      const uint32_t dst = hp::smem_addr(st + r * L::kRow + 16 * piece);
      hp::cp_async16(dst, kt + off, ok ? 16 : 0);
      hp::cp_async16(dst + L::kTileBytes, vt + off, ok ? 16 : 0);
    }
    if constexpr (kInt8) {
      float* ss = reinterpret_cast<float*>(st + 2 * L::kTileBytes);
      for (int r = tid; r < kTile; r += kT) {
        const bool ok = r < valid;
        hp::cp_async4(hp::smem_addr(ss + r), p.kscale + base + (ok ? r : 0), ok ? 4 : 0);
        hp::cp_async4(hp::smem_addr(ss + kTile + r), p.vscale + base + (ok ? r : 0), ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_first + i < ntiles) issue(t_first + i);
    hp::cp_async_commit();
  }
  Warp<kRows, kG, D, kInt8, kWindow, kAlibi> w;
  const bf16* q0 = p.q + ((size_t)b * nq * p.hq + hk * group) * D;  // q[b, 0, hk G]
  w.init(q0, p, len, hk * group, rbase, tid);
  for (int i = t_first; i < ntiles; ++i) {
    hp::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + kStages - 1 < ntiles) issue(i + kStages - 1);
    hp::cp_async_commit();
    w.tile(smem + (i % kStages) * L::kStage, start + i * kTile, p.scale_log2);
  }
  hp::cp_async_wait<0>();
  __syncthreads();

  // the warps' states over the ring, merged in warp order
  float* red_o = reinterpret_cast<float*>(smem);
  float* red_m = red_o + kWarps * kRows * D;
  float* red_l = red_m + kWarps * kRows;
  static_assert(4 * kWarps * kRows * (D + 2) <= kSmem<kRows, D, kInt8>,
                "the warps' states fit in shared memory");
  static_assert(4 * (2 * kMaxChunks + 1) <= kSmem<kRows, D, kInt8>,
                "the chunks' weights of a row fit in shared memory");
  w.stash(red_o, red_m, red_l, rows);
  __syncthreads();
  float* part_o = p.partials;
  // state (chunk j, row r of the kv head) at row0 + j kv_rows + r
  float* part_ml = p.partials + (size_t)gridDim.z * p.hkv * p.chunks * kv_rows * D;
  const size_t row0 = ((size_t)b * p.hkv + hk) * p.chunks * kv_rows + rbase;  // (chunk 0, row rbase)
  const size_t mine = row0 + (size_t)c * kv_rows;
  // A row with one live chunk writes its output here; the others put the
  // chunk's state into the scratch, where the chunk is live for them.
  for (int i = tid; i < rows * D; i += kT) {
    const int r = i / D, d = i % D;
    if (kG == 0 && (c < lo_of(r) || c > hi_of(r))) continue;  // a step's block: all live
    const State st = merge_warps<kRows, D>(red_m + r, red_l + r, red_o + i);
    if (lo_of(r) == hi_of(r)) {
      p.out[out_of(r) + d] = __float2bfloat16(st.normalized());
      continue;
    }
    part_o[(mine + r) * D + d] = st.o;
    if (d == 0) {
      part_ml[2 * (mine + r)] = st.m;
      part_ml[2 * (mine + r) + 1] = st.l;
    }
  }
  if (c_hi == c_lo) return;

  // a ticket on the row's counter
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = p.counters + ((size_t)b * p.hkv + hk) * nrb + rb;
    is_last = atomicAdd(ctr, 1) == c_hi - c_lo;
    if (is_last) *ctr = 0;  // for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The rows merge their live chunks in chunk order, as many rows a pass as
  // their (weight, sum) of every chunk fit in shared memory (all of them,
  // unless a row has hundreds of chunks). The loads of another block's state
  // go through L2; none waits on another: (max, sum) of every (chunk, row)
  // of the pass at once into shared memory, then each thread's four dims of
  // every chunk.
  // (a decode step's G rows fit wherever G rows of the most chunks do: one
  // pass, of a constant G rows)
  constexpr bool kOnePass = kG > 0 && 4 * kG * (2 * kMaxChunks + 1) <= kSmem<kRows, D, kInt8>;
  const int per = kOnePass ? kG
                           : min(rows, kSmem<kRows, D, kInt8> / (4 * (2 * (c_hi - c_lo + 1) + 1)));
  for (int r0 = 0; r0 < rows; r0 += per) {
    const int nr = kOnePass ? kG : min(per, rows - r0);
    // a row's chunks move up with its token: the pass spans [first, last]
    const int first = lo_of(r0), span = hi_of(r0 + nr - 1) - first + 1;
    if (span == 1) continue;  // every row of the pass was written by its one chunk's block
    const size_t base = row0 + r0;  // state (chunk 0, row r0)
    float* wt = red_o;            // [span][nr]: the chunk's max, then its weight
    float* sum = wt + span * nr;  // [span][nr]: the chunk's sum
    float* total = sum + span * nr;  // [nr]
    for (int i = tid; i < span * nr; i += kT) {
      const int j = first + i / nr, h = i % nr;
      // (a decode step's rows all have the pass's chunks)
      if (kG == 0 && (j < lo_of(r0 + h) || j > hi_of(r0 + h))) continue;
      const float2 ml =
          __ldcg(reinterpret_cast<const float2*>(part_ml) + base + (size_t)j * kv_rows + h);
      wt[i] = ml.x;
      sum[i] = ml.y;
    }
    __syncthreads();
    if (tid < nr) {
      const int j0 = lo_of(r0 + tid) - first, j1 = hi_of(r0 + tid) - first;
      if (j1 > j0) {
        float mx = -INFINITY;
        for (int j = j0; j <= j1; ++j) mx = fmaxf(mx, wt[j * nr + tid]);
        float sm = 0.f;
        for (int j = j0; j <= j1; ++j) {
          const float wj = exp2_approx(wt[j * nr + tid] - mx);
          wt[j * nr + tid] = wj;
          sm = fmaf(wj, sum[j * nr + tid], sm);
        }
        total[tid] = sm;
      }
    }
    __syncthreads();
    for (int i = 4 * tid; i < nr * D; i += 4 * kT) {
      const int h = i / D;
      const int j0 = lo_of(r0 + h), j1 = hi_of(r0 + h);
      if (j1 == j0) continue;  // written by its one chunk's block
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = j0; j <= j1; ++j) {
        const float wj = wt[(j - first) * nr + h];
        const float4 v = __ldcg(
            reinterpret_cast<const float4*>(part_o + (base + (size_t)j * kv_rows) * D + i));
        acc.x = fmaf(wj, v.x, acc.x);
        acc.y = fmaf(wj, v.y, acc.y);
        acc.z = fmaf(wj, v.z, acc.z);
        acc.w = fmaf(wj, v.w, acc.w);
      }
      const float inv = 1.f / total[h];
      bf16* out = p.out + out_of(r0 + h) + i % D;
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      *reinterpret_cast<__nv_bfloat162*>(out + 2) =
          __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    }
    if (r0 + per < rows) __syncthreads();  // wt and sum are the next pass's
  }
}

template <int kRows, int kG, int D, bool kInt8, bool kPaged, bool kWindow, bool kAlibi>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int kBytes = kSmem<kRows, D, kInt8>;
  auto kernel = flash_decode_kernel<kRows, kG, D, kInt8, kPaged, kWindow, kAlibi>;
  static bool opted_in = false;  // the shared-memory opt-in, once per instantiation
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // row blocks of kRows query rows a kv head (one in the decode step)
  const int nrb = kG > 0 ? 1 : (p.rows + kRows - 1) / kRows;
  if ((long long)p.hkv * nrb > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(p.chunks, p.hkv * nrb, b), kThreads<kRows>, kBytes, stream>>>(p);
  return cudaGetLastError();
}

// The decode step (S = 1) of a group in kStepGroups, compiled apart; the
// multi-query body otherwise, by its query rows a kv head rounded up to 8,
// 16, 32 or 64 (at most kMaxRowsOf<D>), past which the rows are cut into row
// blocks of kMaxRowsOf<D>.
template <int kG, int D, bool kInt8, bool kPaged, bool kWindow, bool kAlibi>
cudaError_t launch_step(const Params& p, int b, cudaStream_t s) {
  if constexpr ((kStepGroups >> kG) & 1u) {
    return launch<kG <= 8 ? 8 : 16, kG, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
  } else {
    return cudaErrorNotSupported;  // not compiled apart: the caller takes the multi-query body
  }
}

template <int D, bool kInt8, bool kPaged, bool kWindow, bool kAlibi>
cudaError_t launch_rows(const Params& p, int b, cudaStream_t s) {
  static_assert(kStepGroups < (1u << 17), "a decode step's group is at most 16");
  if (p.s == 1 && p.group <= 16 && ((kStepGroups >> p.group) & 1u)) {
    switch (p.group) {
      case 1: return launch_step<1, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
      case 2: return launch_step<2, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
      case 4: return launch_step<4, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
      case 7: return launch_step<7, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
      case 8: return launch_step<8, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
      case 16: return launch_step<16, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
      default: break;  // another group takes the multi-query body
    }
  }
  if (p.rows <= 8) return launch<8, 0, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
  if (p.rows <= 16) return launch<16, 0, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
  if (p.rows <= 32) return launch<32, 0, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
  return launch<kMaxRowsOf<D>, 0, D, kInt8, kPaged, kWindow, kAlibi>(p, b, s);
}

// One variant's launch, by head dim, cache dtype and address map
template <bool kWindow, bool kAlibi>
cudaError_t dispatch(const Params& p, int b, int d, bool int8, bool paged, cudaStream_t s) {
#define EETQ_FD_MODES(D)                                                            \
  if (d == D) {                                                                    \
    if (int8) {                                                                    \
      return paged ? launch_rows<D, true, true, kWindow, kAlibi>(p, b, s)          \
                   : launch_rows<D, true, false, kWindow, kAlibi>(p, b, s);        \
    }                                                                              \
    return paged ? launch_rows<D, false, true, kWindow, kAlibi>(p, b, s)           \
                 : launch_rows<D, false, false, kWindow, kAlibi>(p, b, s);         \
  }
  EETQ_FD_MODES(64)
  EETQ_FD_MODES(128)
  EETQ_FD_MODES(256)
#undef EETQ_FD_MODES
  return cudaErrorInvalidValue;
}

}  // namespace
