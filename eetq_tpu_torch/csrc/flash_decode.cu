// Flash-decode: the C entry points (dense and paged, bf16 and int8 caches)
// and the plain body's instances. The body and its plan are in
// flash_decode.cuh; its window and ALiBi variants are compiled apart, each
// in its own source (flash_decode_window.cu, flash_decode_alibi.cu,
// flash_decode_window_alibi.cu).
#include "flash_decode.cuh"

cudaError_t eetq_fd::launch_plain(const Params& p, int b, int d, bool int8, bool paged,
                                  cudaStream_t s) {
  return dispatch<false, false>(p, b, d, int8, paged, s);
}

namespace {

// Checks what every mode shares, sets the derived fields and dispatches on
// the variant.
template <bool kInt8, bool kPaged>
cudaError_t launch_d(Params p, int b, int d, void* stream) {
  if (b < 1 || p.s < 1 || p.hkv < 1 || p.hq % p.hkv || p.l < 1 || p.chunk < kTile ||
      p.chunk % kTile || p.chunk > kMaxChunk || p.window < 0)
    return cudaErrorInvalidValue;
  p.group = p.hq / p.hkv;
  p.rows = p.group * p.s;
  p.chunks = (p.l + p.chunk - 1) / p.chunk;
  p.scale_log2 *= eetq::kLog2e;
  if (p.chunks > 1 && (p.partials == nullptr || p.counters == nullptr))
    return cudaErrorInvalidValue;
  if (p.chunks > kMaxChunks) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (p.window > 0)
    return p.slopes ? eetq_fd::launch_window_alibi(p, b, d, kInt8, kPaged, s)
                    : eetq_fd::launch_window(p, b, d, kInt8, kPaged, s);
  return p.slopes ? eetq_fd::launch_alibi(p, b, d, kInt8, kPaged, s)
                  : eetq_fd::launch_plain(p, b, d, kInt8, kPaged, s);
}

template <bool kInt8>
cudaError_t launch_paged(Params p, int b, int d, int max_blocks, int bs, void* stream) {
  if (bs < kTile || bs % kTile || max_blocks < 1) return cudaErrorInvalidValue;
  p.max_blocks = max_blocks;
  p.bs = bs;
  p.l = max_blocks * bs;
  return launch_d<kInt8, true>(p, b, d, stream);
}

Params params(const void* q, const void* k, const void* v, const void* k_scale,
              const void* v_scale, const void* table, const void* lengths, void* out,
              void* partials, void* counters, int s, int hq, int hkv, int l, int chunk,
              float scale, const void* slopes, int window) {
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = k;
  p.v = v;
  p.kscale = static_cast<const float*>(k_scale);
  p.vscale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.slopes = static_cast<const float*>(slopes);
  p.out = static_cast<bf16*>(out);
  p.partials = static_cast<float*>(partials);
  p.counters = static_cast<int*>(counters);
  p.s = s;
  p.hq = hq;
  p.hkv = hkv;
  p.l = l;
  p.chunk = chunk;
  p.scale_log2 = scale;
  p.window = window;
  return p;
}

}  // namespace

// q [b, s, hq, d] bf16 contiguous (s query tokens a row: s = 1 decode,
// s > 1 the per-row causal verify, token i at position lengths[r] - s + i);
// k/v cache [b, hkv, l, d] bf16 contiguous; lengths int32 [b], the keys
// token s - 1 sees; out [b, s, hq, d] bf16; any (hq / hkv) * s query rows a
// kv head, cut into row blocks of 64 (32 at d = 256); chunk a multiple of
// EETQ_DECODE_TILE; with chunks = ceil(l / chunk) > 1, partials f32
// [b * hkv * chunks * (hq / hkv) * s * (d + 2)] and counters int32
// [b * hkv * row blocks], all zero (both are scratch, left as they were
// found). slopes:
// null, or the ALiBi slopes f32 [hq]; window: 0, or the sliding window (a
// token at position p sees the keys p - window < key <= p).
extern "C" int eetq_flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                                 void* out, void* partials, void* counters, int b, int s, int hq,
                                 int hkv, int l, int d, int chunk, float scale,
                                 const void* slopes, int window, void* stream) {
  return launch_d<false, false>(params(q, k, v, nullptr, nullptr, nullptr, lengths, out, partials,
                                       counters, s, hq, hkv, l, chunk, scale, slopes, window),
                                b, d, stream);
}

// The int8 cache: k/v int8 [b, hkv, l, d] contiguous with f32 scales
// k_scale/v_scale [b, hkv, l]; everything else as eetq_flash_decode.
extern "C" int eetq_flash_decode_int8(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* lengths, void* out, void* partials,
                                      void* counters, int b, int s, int hq, int hkv, int l, int d,
                                      int chunk, float scale, const void* slopes, int window,
                                      void* stream) {
  return launch_d<true, false>(params(q, k, v, k_scale, v_scale, nullptr, lengths, out, partials,
                                      counters, s, hq, hkv, l, chunk, scale, slopes, window),
                               b, d, stream);
}

// The paged cache: k/v pools bf16 [nb, hkv, bs, d] contiguous (bs a multiple
// of EETQ_DECODE_TILE); table int32 [b, max_blocks], entry (r, i) the pool
// block of keys [i * bs, (i + 1) * bs) of row r, used only for blocks that
// hold a key below lengths[r]; lengths int32 [b], at most max_blocks * bs;
// q, out, the chunks, scratch, slopes and window as eetq_flash_decode's
// with l = max_blocks * bs.
extern "C" int eetq_paged_flash_decode(const void* q, const void* k, const void* v,
                                       const void* table, const void* lengths, void* out,
                                       void* partials, void* counters, int b, int s, int hq,
                                       int hkv, int max_blocks, int bs, int d, int chunk,
                                       float scale, const void* slopes, int window,
                                       void* stream) {
  return launch_paged<false>(params(q, k, v, nullptr, nullptr, table, lengths, out, partials,
                                    counters, s, hq, hkv, 0, chunk, scale, slopes, window),
                             b, d, max_blocks, bs, stream);
}

// The int8 paged cache: pools int8 [nb, hkv, bs, d] with f32 scale pools
// k_scale/v_scale [nb, hkv, bs]; everything else as eetq_paged_flash_decode.
extern "C" int eetq_paged_flash_decode_int8(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale,
                                            const void* table, const void* lengths, void* out,
                                            void* partials, void* counters, int b, int s, int hq,
                                            int hkv, int max_blocks, int bs, int d, int chunk,
                                            float scale, const void* slopes, int window,
                                            void* stream) {
  return launch_paged<true>(params(q, k, v, k_scale, v_scale, table, lengths, out, partials,
                                   counters, s, hq, hkv, 0, chunk, scale, slopes, window),
                            b, d, max_blocks, bs, stream);
}
