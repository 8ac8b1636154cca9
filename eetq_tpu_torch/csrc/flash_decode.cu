// Flash-decode: one query token per batch row against the dense KV cache
// [B, Hkv, L, D], each row to its own length; the cache is bf16, or int8
// with f32 per-(row, head, position) scales [B, Hkv, L]. In paged mode the
// cache is a pool of blocks [NB, Hkv, BS, D] (scales [NB, Hkv, BS]) shared
// by all rows, and a table [B, max_blocks] names the pool block of each
// logical block of a row.
//
// Replaces eetq_tpu/kernels/flash_decode.py::flash_decode and
// ::paged_flash_decode for S = 1, each in its bf16 and its int8 mode. Bound by the cache bytes, so each cached key and
// value is read once: a block takes one kv head of one row and computes its
// whole GQA group of q heads against it, over one split of the key range,
// and stops at the row's length. Within the block every D/8 lanes hold one
// key (8 dims each: one 16-byte load in bf16, one 8-byte load in int8), so
// a warp walks 32/(D/8) keys at a time with four steps of loads in flight;
// each key slot keeps its own online softmax (max, sum, output) in f32
// registers. The slots are merged in shared memory into one (max, sum,
// output) per split, and a second kernel merges the splits and writes bf16.
//
// Paged mode (kPaged) is the same body with another address: key p of row b
// lies at ((table[b][p / BS] * Hkv + hk) * BS + p % BS). A block step covers
// kSlots (16 or 32) consecutive keys from a multiple of kSlots, and BS and
// the split length are multiples of 32, so a step never straddles two pool
// blocks: the block keeps (logical block, offset) of its position and moves
// them along without a division, and each of the four loads in flight reads
// its own table entry, and only for a key below the row's length: entries
// past a row's last live block are arbitrary and are never read (the TPU
// kernel clamps its index map instead, flash_decode.py:278-289).
//
// int8 mode: half the bytes of the bf16 cache. As in the TPU kernel
// (flash_decode.py:15-20) no dequantised cache is formed: the key's scale
// multiplies its score after the dot, and the value's scale multiplies its
// probability in the p.v sum (the softmax sum takes the unscaled p).
#include "common.cuh"

namespace {

using eetq::bf16;

constexpr int kWarps = 4, kThreads = kWarps * 32, kUnroll = 4;
constexpr int kCombineThreads = 256;

// Eight cache elements as one vector load: 16 bytes of bf16, 8 of int8.
template <bool kInt8>
struct Kv8 {
  using Elem = bf16;
  using Vec = int4;
  static __device__ __forceinline__ void to_float(const Vec& v, float* f) {
    eetq::bf16x8_to_float(v, f);
  }
};

template <>
struct Kv8<true> {
  using Elem = int8_t;
  using Vec = uint2;
  static __device__ __forceinline__ void to_float(const Vec& v, float* f) {
    eetq::int8x4_to_float(v.x, f);
    eetq::int8x4_to_float(v.y, f + 4);
  }
};

// The key step of the widest instantiation (D = 64): BS and the split length
// of a paged launch are multiples of it.
constexpr int kMaxSlots = kWarps * (32 / (64 / 8));

template <int G, int D, bool kInt8, bool kPaged>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const bf16* __restrict__ q, const typename Kv8<kInt8>::Elem* __restrict__ kc,
    const typename Kv8<kInt8>::Elem* __restrict__ vc, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ part_o, float* __restrict__ part_ml,
    int hq, int hkv, int l, int max_blocks, int bs, int splits, int split_len, float scale) {
  using KV = Kv8<kInt8>;
  constexpr int kLanesPerKey = D / 8;
  constexpr int kKeysPerWarp = 32 / kLanesPerKey;
  constexpr int kSlots = kWarps * kKeysPerWarp;  // keys per block step
  __shared__ float sm_m[kSlots][G], sm_l[kSlots][G];
  __shared__ float sm_o[kSlots][G][D];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = warp * kKeysPerWarp + lane / kLanesPerKey;
  const int dl = (lane % kLanesPerKey) * 8;
  const int len = min(lengths[b], l);
  const int start = split * split_len, end = min(len, start + split_len);
  // Dense: key j of this (row, head) is element head + j of the cache.
  // Paged: key j of logical block lb at offset o is element
  // (tbl[lb] * hkv + hk) * bs + o of the pool.
  const size_t head = kPaged ? 0 : ((size_t)b * hkv + hk) * l;
  const int* tbl = kPaged ? table + (size_t)b * max_blocks : nullptr;
  int blk = kPaged ? start / bs : 0;  // of the step at `base`
  int off = kPaged ? start - blk * bs : 0;
  const auto* kb = kc + dl;
  const auto* vb = vc + dl;

  float qr[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    eetq::bf16x8_to_float(
        *reinterpret_cast<const int4*>(q + ((size_t)b * hq + hk * G + g) * D + dl), qr[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[g][i] *= scale;
  }
  float m[G], s_l[G], o[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    s_l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[g][i] = 0.f;
  }

  // the trip count is uniform over the block, so every lane reaches the shuffles
  for (int base = start; base < end; base += kSlots * kUnroll) {
    typename KV::Vec kv[kUnroll], vv[kUnroll];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kSlots + slot;
      kv[u] = vv[u] = typename KV::Vec{};
      ks[u] = vs[u] = 0.f;
      if (j < end) {
        size_t idx = head + j;
        if constexpr (kPaged) {  // the step's block: at most one past blk
          const int ou = off + u * kSlots;
          const int wrap = ou >= bs;
          idx = ((size_t)tbl[blk + wrap] * hkv + hk) * bs + (ou - wrap * bs) + slot;
        }
        kv[u] = *reinterpret_cast<const typename KV::Vec*>(kb + idx * D);
        vv[u] = *reinterpret_cast<const typename KV::Vec*>(vb + idx * D);
        if constexpr (kInt8) {
          ks[u] = kscale[idx];
          vs[u] = vscale[idx];
        }
      }
    }
    if constexpr (kPaged) {
      off += kSlots * kUnroll;
      if (off >= bs) {
        off -= bs;
        ++blk;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + u * kSlots + slot < end;
      float kf[8], vf[8];
      KV::to_float(kv[u], kf);
      KV::to_float(vv[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) s = fmaf(qr[g][i], kf[i], s);
#pragma unroll
        for (int sh = kLanesPerKey / 2; sh > 0; sh >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, sh);
        if constexpr (kInt8) s *= ks[u];
        if (valid) {
          const float mn = fmaxf(m[g], s);
          const float c = __expf(m[g] - mn), p = __expf(s - mn);
          s_l[g] = s_l[g] * c + p;
          const float pv = kInt8 ? p * vs[u] : p;
#pragma unroll
          for (int i = 0; i < 8; ++i) o[g][i] = fmaf(o[g][i], c, pv * vf[i]);
          m[g] = mn;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (dl == 0) {
      sm_m[slot][g] = m[g];
      sm_l[slot][g] = s_l[g];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_o[slot][g][dl + i] = o[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
    for (int s = 0; s < kSlots; ++s) mx = fmaxf(mx, sm_m[s][g]);
    float acc = 0.f, sum = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < kSlots; ++s) {
        const float w = __expf(sm_m[s][g] - mx);
        acc = fmaf(w, sm_o[s][g][d], acc);
        sum = fmaf(w, sm_l[s][g], sum);
      }
    }
    const size_t p = (((size_t)b * hkv + hk) * splits + split) * G + g;
    part_o[p * D + d] = acc;
    if (d == 0) {
      part_ml[2 * p] = mx;
      part_ml[2 * p + 1] = sum;
    }
  }
}

template <int G, int D>
__global__ void __launch_bounds__(kCombineThreads) flash_decode_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    bf16* __restrict__ out, int hq, int hkv, int splits) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t p0 = ((size_t)b * hkv + hk) * splits * G;
  for (int idx = threadIdx.x; idx < G * D; idx += kCombineThreads) {
    const int g = idx / D, d = idx % D;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[2 * (p0 + s * G + g)]);
    float acc = 0.f, sum = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < splits; ++s) {
        const size_t p = p0 + s * G + g;
        const float w = __expf(part_ml[2 * p] - mx);
        acc = fmaf(w, part_o[p * D + d], acc);
        sum = fmaf(w, part_ml[2 * p + 1], sum);
      }
    }
    out[((size_t)b * hq + hk * G + g) * D + d] = __float2bfloat16(sum == 0.f ? 0.f : acc / sum);
  }
}

// Pointers and sizes of one launch; kscale/vscale are null for bf16. Paged:
// table is set, the pool's blocks hold bs keys, and l = max_blocks * bs.
struct Args {
  const void *q, *k, *v, *kscale, *vscale, *lengths;
  void *out, *part_o, *part_ml;
  int b, hq, hkv, l, splits, split_len;
  float scale;
  const void* table = nullptr;
  int max_blocks = 0, bs = 0;
};

template <int G, int D, bool kInt8, bool kPaged>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Elem = typename Kv8<kInt8>::Elem;
  flash_decode_split_kernel<G, D, kInt8, kPaged>
      <<<dim3(a.splits, a.hkv, a.b), kThreads, 0, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const Elem*>(a.k),
          static_cast<const Elem*>(a.v), static_cast<const float*>(a.kscale),
          static_cast<const float*>(a.vscale), static_cast<const int*>(a.table),
          static_cast<const int*>(a.lengths), static_cast<float*>(a.part_o),
          static_cast<float*>(a.part_ml), a.hq, a.hkv, a.l, a.max_blocks, a.bs, a.splits,
          a.split_len, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<G, D><<<dim3(a.hkv, a.b), kCombineThreads, 0, stream>>>(
      static_cast<const float*>(a.part_o), static_cast<const float*>(a.part_ml),
      static_cast<bf16*>(a.out), a.hq, a.hkv, a.splits);
  return cudaGetLastError();
}

template <int D, bool kInt8, bool kPaged>
cudaError_t launch_g(const Args& a, cudaStream_t s) {
  switch (a.hq / a.hkv) {
    case 1: return launch<1, D, kInt8, kPaged>(a, s);
    case 2: return launch<2, D, kInt8, kPaged>(a, s);
    case 4: return launch<4, D, kInt8, kPaged>(a, s);
    case 8: return launch<8, D, kInt8, kPaged>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kInt8, bool kPaged = false>
cudaError_t launch_dg(int d, const Args& a, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_g<64, kInt8, kPaged>(a, s);
  if (d == 128) return launch_g<128, kInt8, kPaged>(a, s);
  return cudaErrorInvalidValue;
}

// A paged launch: no key step may straddle two pool blocks or two splits.
template <bool kInt8>
cudaError_t launch_paged(int d, Args a, const void* table, int max_blocks, int bs,
                         void* stream) {
  if (bs < kMaxSlots * kUnroll || bs % kMaxSlots || a.split_len % kMaxSlots || max_blocks < 1)
    return cudaErrorInvalidValue;
  a.table = table;
  a.max_blocks = max_blocks;
  a.bs = bs;
  a.l = max_blocks * bs;
  return launch_dg<kInt8, true>(d, a, stream);
}

}  // namespace

// q [b, 1, hq, d] bf16 contiguous; k/v cache [b, hkv, l, d] bf16 contiguous;
// lengths int32 [b]; out [b, 1, hq, d] bf16; part_o f32 [b*hkv*splits*G*d]
// and part_ml f32 [b*hkv*splits*G*2] scratch; split s covers keys
// [s*split_len, (s+1)*split_len).
extern "C" int eetq_flash_decode(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, void* part_o, void* part_ml,
                                 int b, int hq, int hkv, int l, int d, int splits, int split_len,
                                 float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, lengths, out, part_o, part_ml,
               b, hq, hkv, l, splits, split_len, scale};
  return launch_dg<false>(d, a, stream);
}

// The int8 cache: k/v int8 [b, hkv, l, d] contiguous with f32 scales
// k_scale/v_scale [b, hkv, l]; everything else as eetq_flash_decode.
extern "C" int eetq_flash_decode_int8(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, void* out, void* part_o,
                                      void* part_ml, int b, int hq, int hkv, int l, int d,
                                      int splits, int split_len, float scale, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, lengths, out, part_o, part_ml,
               b, hq, hkv, l, splits, split_len, scale};
  return launch_dg<true>(d, a, stream);
}

// The paged cache: k/v pools bf16 [nb, hkv, bs, d] contiguous (bs % 32 == 0,
// bs >= 128); table int32 [b, max_blocks], entry (r, i) the pool block of
// keys [i * bs, (i + 1) * bs) of row r, read only for blocks that hold a key
// below lengths[r]; lengths int32 [b], at most max_blocks * bs; scratch as
// eetq_flash_decode; split_len % 32 == 0.
extern "C" int eetq_paged_flash_decode(const void* q, const void* k, const void* v,
                                       const void* table, const void* lengths, void* out,
                                       void* part_o, void* part_ml, int b, int hq, int hkv,
                                       int max_blocks, int bs, int d, int splits, int split_len,
                                       float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, lengths, out, part_o, part_ml,
               b, hq, hkv, 0, splits, split_len, scale};
  return launch_paged<false>(d, a, table, max_blocks, bs, stream);
}

// The int8 paged cache: pools int8 [nb, hkv, bs, d] with f32 scale pools
// k_scale/v_scale [nb, hkv, bs]; everything else as eetq_paged_flash_decode.
extern "C" int eetq_paged_flash_decode_int8(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* table, const void* lengths, void* out,
                                            void* part_o, void* part_ml, int b, int hq, int hkv,
                                            int max_blocks, int bs, int d, int splits,
                                            int split_len, float scale, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, lengths, out, part_o, part_ml,
               b, hq, hkv, 0, splits, split_len, scale};
  return launch_paged<true>(d, a, table, max_blocks, bs, stream);
}
