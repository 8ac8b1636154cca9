// Flash-attention-2 forward for Hopper: causal (or full) attention with GQA.
//
// Replaces eetq_tpu/kernels/flash_attention.py::_flash_forward. Bound by
// tensor-core operations at prefill sizes (S x S x D products per head; q,
// k and v are read once per q tile and stay in L2).
//
// Design. One block per (q head, q tile, batch row). A q tile is 64 rows per
// warpgroup: two warpgroups (128 rows, 256 threads), or one where the grid
// would otherwise leave SMs empty (short prompts). The block loops over
// 64-key tiles up to the diagonal (tiles above it are never visited, with
// delta = skv - sq for a query block appended to a cache) and a warpgroup
// stops at its own diagonal.
//   - K and V tiles travel through a ring of three stages in dynamic shared
//     memory, filled by cp.async 16-byte copies two tiles ahead of the
//     multiply, with a hand-written 128-byte swizzle (hopper.cuh). cp.async
//     and not TMA: q, k and v are strided views of one fused qkv tensor and
//     their shapes change with every prompt bucket, so a tensor map would
//     have to be encoded on the host for each of the 32 calls of a prefill;
//     cp.async takes the strides as they are and zero-fills keys past skv.
//   - S = Q K^T: wgmma m64n64k16, Q as the register A operand (loaded once
//     from global memory, scaled and rounded to bf16 as the TPU kernel does;
//     with n = 64 an A operand in shared memory would take half of the
//     shared-memory bandwidth the instruction has), K K-major from shared
//     memory, f32 accumulators in registers.
//   - the online softmax runs on the accumulator registers (exp2, row max
//     and sum in f32; a row lives in the four lanes of a quad);
//   - O += P V: wgmma m64nDk16 with P, rounded to bf16, as the register A
//     operand (the accumulator layout of S is the A layout per 16 keys) and V
//     read MN-major through the descriptor's transpose bit from the same
//     swizzled rows K uses: V is never transposed or copied.
//   - the output goes through shared memory and leaves in 16-byte stores.
// Blocks of the longest causal rows are scheduled first (blockIdx.y
// reversed), all heads of a q tile side by side. kv head = q head / group.
// Masking uses -0.7 * f32max and a row whose sum is 0 divides by 1
// (flash_attention.py:24-25, :131).
//
// Two position-dependent variants, each a template flag compiled apart from
// the plain causal body (flash_attention.py:51-58, :70-86, :119-125):
//   - kWindow (sliding window, mistral): row p sees keys p - window < key <=
//     p. A block's key loop starts at the first 64-key tile that touches its
//     earliest row's window, and a warpgroup skips the tiles left of its own
//     first row's window: those tiles are never loaded or multiplied. Edge
//     tiles are masked key <= p - window.
//   - kAlibi (baichuan-13b): slope_h * (key - p) is added to the scaled q.k
//     scores of every tile before the mask (the bias is not scaled: the TPU
//     kernel adds it after the scale), slopes [hq] f32, one load a block.
//
// Head dim 256 (gemma-7b). With Q as the register A operand a thread would
// hold 64 registers of Q beside the m64n256 output accumulator (128), S (32)
// and P (16): past what ptxas can keep without spilling. So at D = 256 the
// scaled, rounded Q tile goes to shared memory once (the same swizzled
// K-major layout K uses, 32 KB a warpgroup) and S = Q K^T takes it as the
// shared-memory A operand (wgmma m64n64k16, both operands from shared
// memory); the K/V ring shrinks to two stages (2 x 64 KB) to leave room for
// it, one tile in flight while the other is multiplied, and O += P V runs as
// two m64n128 halves of d. The arithmetic and its rounding are the same as
// at D = 64 and 128.
#include "hopper.cuh"

namespace {

using eetq::bf16;
using namespace eetq::hopper;

constexpr int kKV = 64;  // keys per tile

// Q in shared memory (the SS form of the S = Q K^T wgmma): at D = 256 only
template <int D>
constexpr bool kQSmem = D == 256;
// K/V tiles in the ring: three, or two beside the Q tile in shared memory
template <int D>
constexpr int kStages = kQSmem<D> ? 2 : 3;

template <int D, int kWG>
constexpr int smem_bytes() {
  // the ring, the Q tile of each warpgroup (D = 256), and room to align the
  // ring to 1024
  return kStages<D> * 2 * kKV * D * 2 + (kQSmem<D> ? 64 * kWG * D * 2 : 0) + 1024;
}

// Accumulator layout of wgmma m64nN (g = lane / 4, t = lane % 4, warp w of
// the warpgroup): d[4j], d[4j+1] = (row 16w + g, columns 8j + 2t, +1);
// d[4j+2], d[4j+3] = (row 16w + g + 8, the same columns). The A operand of a
// k16 step in registers: a0 (g, k 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..).
template <int D, int kWG, bool kWindow, bool kAlibi>
__global__ void __launch_bounds__(128 * kWG, 1) flash_attention_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int sq, int skv, int hq, int hkv, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale, int causal, const float* __restrict__ slopes, int window) {
  constexpr int kThreads = 128 * kWG, kBlockQ = 64 * kWG;
  constexpr int kTile = kKV * D * 2;   // bytes of one K or V tile
  constexpr int kBlock = kKV * 128;    // bytes of one 64-column block of it
  constexpr int kChunks = D / 8;       // 16-byte chunks per row
  constexpr int kOutLd = D + 8;        // padded rows of the output staging
  constexpr int kRing = kStages<D>;
  constexpr int kQTile = 64 * D * 2;   // bytes of one warpgroup's Q tile (kQSmem)
  static_assert(kBlockQ * kOutLd * 2 <= kRing * 2 * kTile, "output staging fits the ring");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t qsm = ring + kRing * 2 * kTile;  // the Q tiles (kQSmem), 1024-aligned

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * kBlockQ, delta = skv - sq;
  const int wrow0 = q0 + wg * 64;            // first row of this warpgroup
  const int row0 = wrow0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  // keys the block needs, and the tiles this warpgroup multiplies
  const int last_row = min(q0 + kBlockQ, sq) - 1;
  const int kv_end = causal ? min(skv, last_row + delta + 1) : skv;
  const int n_tiles = max(0, (kv_end + kKV - 1) / kKV);
  const int wg_last = min(wrow0 + 64, sq) - 1;
  const int wg_end = causal ? min(skv, wg_last + delta + 1) : skv;
  const int wg_tiles = max(0, (wg_end + kKV - 1) / kKV);
  // under a window: the first tile of the block (its first row's window)
  // and of this warpgroup
  const int t_lo = kWindow ? max(0, q0 + delta - window + 1) / kKV : 0;
  const int wg_lo = kWindow ? max(0, wrow0 + delta - window + 1) / kKV : 0;

  auto load_tile = [&](int it) {
    const int kv0 = it * kKV;
    const uint32_t kdst = ring + ((it - t_lo) % kRing) * 2 * kTile, vdst = kdst + kTile;
    for (int idx = tid; idx < kKV * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const uint32_t off = (c >> 3) * kBlock + swizzle128(r, c & 7);
      const bool ok = kv0 + r < skv;  // rows past skv are zero
      const int64_t row = ok ? kv0 + r : 0;
      cp_async16(kdst + off, kb + row * k_ss + c * 8, ok ? 16 : 0);
      cp_async16(vdst + off, vb + row * v_ss + c * 8, ok ? 16 : 0);
    }
  };
  // kRing - 1 tiles in flight before the first multiply; one commit per
  // tile, empty past the end, so the group count stays uniform
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (t_lo + i < n_tiles) load_tile(t_lo + i);
    cp_async_commit();
  }
  const float slope = kAlibi ? slopes[h] : 0.f;

  // Q scaled and rounded to bf16: the register A fragments, or (kQSmem) the
  // block's Q tile in shared memory, zero past sq, made visible to wgmma by
  // the fence and barrier at the top of the first tile
  uint32_t qf[kQSmem<D> ? 1 : D / 16][4];
  if constexpr (kQSmem<D>) {
    uint8_t* qgen = smem_raw + (qsm - smem_addr(smem_raw));
    for (int idx = tid; idx < kBlockQ * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks, row = q0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < sq) {
        const uint4 raw = *reinterpret_cast<const uint4*>(qb + row * q_ss + c * 8);
        uint32_t* w = &val.x;
        const uint32_t* in = &raw.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(in + e));
          w[e] = eetq::pack_bf16x2(f.x * scale, f.y * scale);
        }
      }
      *reinterpret_cast<uint4*>(qgen + (r >> 6) * kQTile + (c >> 3) * kBlock +
                                swizzle128(r & 63, c & 7)) = val;
    }
  } else {
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = row0 + 8 * r, col = s * 16 + 2 * t + 8 * c;
          uint32_t val = 0;
          if (row < sq) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(qb + row * q_ss + col));
            val = eetq::pack_bf16x2(f.x * scale, f.y * scale);
          }
          qf[s][r + 2 * c] = val;
        }
      }
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {eetq::kMaskValue, eetq::kMaskValue};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums; the quad adds them at the end

  for (int it = t_lo; it < n_tiles; ++it) {
    const int kv0 = it * kKV;
    cp_async_wait<kRing - 2>();  // this thread's copies of tile `it` have landed
    fence_proxy_async();         // and wgmma may read them (and the Q tile)
    __syncthreads();             // everyone's have; tile it - 1 has been multiplied
    if (it + kRing - 1 < n_tiles) load_tile(it + kRing - 1);  // into the stage of tile it - 1
    cp_async_commit();
    if (it >= wg_tiles) continue;  // above this warpgroup's diagonal
    if (kWindow && it < wg_lo) continue;  // left of this warpgroup's windows

    const uint32_t ks = ring + ((it - t_lo) % kRing) * 2 * kTile, vs = ks + kTile;
    float s[kKV / 2];
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < D / 16; ++st) {
      const uint32_t step = (st >> 2) * kBlock + (st & 3) * 32;
      if constexpr (kQSmem<D>) {
        wgmma_ss_n64<0, 0>(s, smem_desc(qsm + wg * kQTile + step, 16, 1024),
                           smem_desc(ks + step, 16, 1024), st > 0);
      } else {
        wgmma_rs_n64<0>(s, qf[st], smem_desc(ks + step, 16, 1024), st > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(s);

    if constexpr (kAlibi) {
#pragma unroll
      for (int i = 0; i < kKV / 2; ++i) {
        const int key = kv0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const int pos = row0 + 8 * ((i >> 1) & 1) + delta;
        s[i] += slope * static_cast<float>(key - pos);
      }
    }
    // mask keys past skv and, causally, past each row's position; under a
    // window, keys at or left of its row's position - window
    if (kv0 + kKV > skv || (causal && kv0 + kKV - 1 > wrow0 + delta) ||
        (kWindow && kv0 <= wrow0 + 63 + delta - window)) {
#pragma unroll
      for (int i = 0; i < kKV / 2; ++i) {
        const int key = kv0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const int pos = row0 + 8 * ((i >> 1) & 1) + delta;
        if (key >= skv || (causal && key > pos) || (kWindow && key <= pos - window))
          s[i] = eetq::kMaskValue;
      }
    }

    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kKV / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m_run[r] - mx[r]) * eetq::kLog2e);
      m_run[r] = mx[r];
    }

    uint32_t pf[kKV / 16][4];  // P as A operands, one per 16-key step
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kKV / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = exp2f((s[4 * j + e] - mx[e >> 1]) * eetq::kLog2e);
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
      pf[j / 2][(j & 1) * 2 + 0] = eetq::pack_bf16x2(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = eetq::pack_bf16x2(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    fence_registers(o);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kKV / 16; ++st) {
      // V is [key][d]: d contiguous (MN-major), 16 keys a step, the second
      // 64-column block of d one tile block further
      const uint64_t desc = smem_desc(vs + st * 2048, kBlock, 1024);
      if constexpr (D == 256) {  // two halves of d, two 64-column blocks apart
        wgmma_rs_n128<1>(*reinterpret_cast<float(*)[64]>(o), pf[st], desc, 1);
        wgmma_rs_n128<1>(*reinterpret_cast<float(*)[64]>(o + 64), pf[st],
                         smem_desc(vs + 2 * kBlock + st * 2048, kBlock, 1024), 1);
      } else if constexpr (D == 128) {
        wgmma_rs_n128<1>(o, pf[st], desc, 1);
      } else {
        wgmma_rs_n64<1>(o, pf[st], desc, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(o);
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output in it
  bf16* stage = reinterpret_cast<bf16*>(smem_raw + (ring - smem_addr(smem_raw)));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.f ? 1.f : 1.f / l;
    bf16* sp = stage + (wg * 64 + warp * 16 + g + 8 * r) * kOutLd + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(sp + j * 8) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
  __syncthreads();
  for (int idx = tid; idx < kBlockQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks, row = q0 + r;
    if (row < sq)
      *reinterpret_cast<int4*>(out + (((int64_t)b * sq + row) * hq + h) * D + c * 8) =
          *reinterpret_cast<const int4*>(stage + r * kOutLd + c * 8);
  }
}

template <int D, int kWG, bool kWindow, bool kAlibi>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
                   int skv, int hq, int hkv, const int64_t* st, float scale, int causal,
                   const float* slopes, int window, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<D, kWG, kWindow, kAlibi>;
  static bool opted_in = false;  // above 48 KB of dynamic shared memory
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes<D, kWG>());
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid(hq, (sq + 64 * kWG - 1) / (64 * kWG), b);
  kernel<<<grid, 128 * kWG, smem_bytes<D, kWG>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), sq, skv, hq, hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal, slopes, window);
  return cudaGetLastError();
}

// The plain body, or the window and ALiBi variants (window > 0, slopes not
// null), each compiled apart
template <int D, int kWG>
cudaError_t launch_variant(const void* q, const void* k, const void* v, void* out, int b,
                           int sq, int skv, int hq, int hkv, const int64_t* st, float scale,
                           int causal, const float* slopes, int window, cudaStream_t stream) {
  if (window > 0 && slopes)
    return launch<D, kWG, true, true>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal,
                                      slopes, window, stream);
  if (window > 0)
    return launch<D, kWG, true, false>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal,
                                       slopes, window, stream);
  if (slopes)
    return launch<D, kWG, false, true>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal,
                                       slopes, window, stream);
  return launch<D, kWG, false, false>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal,
                                      slopes, window, stream);
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int b, int sq,
                     int skv, int hq, int hkv, const int64_t* st, float scale, int causal,
                     const float* slopes, int window, cudaStream_t stream) {
  // 128-row tiles where they still give every SM of the card a block
  const long long wide = (long long)((sq + 127) / 128) * hq * b;
  if (wide >= 132)
    return launch_variant<D, 2>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal, slopes,
                                window, stream);
  return launch_variant<D, 1>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal, slopes,
                              window, stream);
}

}  // namespace

// q [b, sq, hq, d], k/v [b, skv, hkv, d] bf16 with element strides (batch,
// seq, head) and unit stride in d, rows 16-byte aligned; out [b, sq, hq, d]
// contiguous bf16; sq, skv >= 1. slopes: null, or ALiBi slopes f32 [hq];
// window: 0, or the sliding window (row p sees keys p - window < key <= p).
extern "C" int eetq_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        int b, int sq, int skv, int hq, int hkv, int d,
                                        long long q_sb, long long q_ss, long long q_sh,
                                        long long k_sb, long long k_ss, long long k_sh,
                                        long long v_sb, long long v_ss, long long v_sh,
                                        float scale, int causal, const void* slopes, int window,
                                        void* stream) {
  const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  auto s = static_cast<cudaStream_t>(stream);
  auto sl = static_cast<const float*>(slopes);
  if (sq < 1 || skv < 1 || (sq + 63) / 64 > 65535 || b > 65535 || window < 0)
    return cudaErrorInvalidValue;
  if (d == 64)
    return launch_d<64>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal, sl, window, s);
  if (d == 128)
    return launch_d<128>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal, sl, window, s);
  if (d == 256)
    return launch_d<256>(q, k, v, out, b, sq, skv, hq, hkv, st, scale, causal, sl, window, s);
  return cudaErrorInvalidValue;
}
