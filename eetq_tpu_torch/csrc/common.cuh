// Helpers shared by the kernels of eetq_tpu_torch (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace eetq {

using bf16 = __nv_bfloat16;

// -0.7 * f32max, not -inf: exp(-inf - (-inf)) would be NaN
// (eetq_tpu/kernels/flash_attention.py:24-25).
constexpr float kMaskValue = -0.7f * 3.40282346638528859812e+38f;
constexpr float kLog2e = 1.4426950408889634f;

// Four int8 in a word to four exact floats: flipping the sign bit turns the
// byte into b + 128; placed under the exponent of 2^23 the word reads as
// 2^23 + b + 128. One byte permute and one add per value, no I2F.
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// The low (kHigh false) or high nibbles of four bytes, each sign-extended to
// an int8 in its byte: v | 0xF0 where the nibble's bit 3 is set (8 * 0x1E =
// 0xF0, and no byte's product carries into the next).
template <bool kHigh>
__device__ __forceinline__ uint32_t nibbles_to_int8x4(uint32_t w) {
  const uint32_t v = (kHigh ? w >> 4 : w) & 0x0F0F0F0Fu;
  return v | ((v & 0x08080808u) * 0x1Eu);
}

// Eight bf16 in a 16-byte vector to floats.
__device__ __forceinline__ void bf16x8_to_float(const int4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Two floats to a bf16 pair in one 32-bit word (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace eetq
