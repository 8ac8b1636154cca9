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

// d += A B on the tensor cores (A 16 x 16 and B 16 x 8 bf16, d f32).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Byte `i` of two int8 words (lo: the even K row, hi: the odd one) to an
// exact bf16 pair: under the high byte 0x43 the low seven bits of b read as
// 128 + (b & 127), and the sign bit alone as 128 (b >= 0) or 256 (b < 0).
template <int i>
__device__ __forceinline__ uint32_t int8_pair(uint32_t lo, uint32_t hi) {
  const uint32_t t = __byte_perm(lo, hi, i | (i << 4) | ((i + 4) << 8) | ((i + 4) << 12));
  return bf16x2_sub((t & 0x007F007Fu) | 0x43004300u, (t & 0x00800080u) | 0x43004300u);
}

// The GEMMs' fused epilogue after the scale and the bias, in f32 before the
// one rounding (eetq_tpu/kernels/w8a16.py:213-230, w8a8.py:71-84): an
// activation, then the residual added or multiplied. The activation codes
// are kernels/mlp_fused.py::ACT_CODES (the fused MLP's), kActNone none.
enum Act { kActSilu = 0, kActGelu = 1, kActRelu = 2, kActNone = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kActSilu) return v / (1.f + expf(-v));
  if (act == kActGelu)  // tanh approximation, jax.nn.gelu's default
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if (act == kActRelu) return fmaxf(v, 0.f);
  return v;
}

// The residual r added to v, or multiplied where res_mul is set.
__device__ __forceinline__ float combine(float v, float r, int res_mul) {
  return res_mul ? __fmul_rn(v, r) : __fadd_rn(v, r);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace eetq
