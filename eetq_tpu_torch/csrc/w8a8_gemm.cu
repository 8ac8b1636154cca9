// W8A8 GEMM: out[m, n] = bf16((f32(xq[m, :] . W[:, n]) * sx[m]) * sw[n] + bias[n])
// with per-token int8 activations xq, int8 per-channel weights W and an
// exact int32 accumulator.
//
// Replaces eetq_tpu/kernels/w8a8.py::w8a8_matmul_kernel_call. Bound by
// tensor-core operations at prefill sizes (m = 1024 does 2m operations per
// weight byte); Hopper's int8 tensor-core rate is twice its bf16 rate, which
// is what the path is for. Each 256-thread block computes a 128 x 128 output
// tile; per 64-deep K step it stages the xq tile and the weight tile in
// shared memory, and 8 warps (2 x 4) each multiply a 64 x 32 sub-tile with
// `mma.sync.m16n8k32` s8 x s8 -> s32 (16 MMAs per 32-deep slice). The next
// step's tiles are loaded into registers while the current one is
// multiplied (two shared-memory buffers, one barrier per step).
//
// The B operand of the MMA (".col") wants four consecutive K values of one
// column in a register, but the packed weight is row-major [Kp, Np] with N
// contiguous, and `ldmatrix.trans` exists only for 16-bit elements. So each
// thread loads a 4 (K) x 8 (N) byte block (four 8-byte loads, coalesced
// along N), transposes it with byte permutes, and stores eight 4-byte words
// into a [BN][BK] (K-contiguous) tile; an XOR swizzle of the word index
// keeps both these stores (2-way) and the fragment reads (conflict-free)
// off each other's banks. A fragments are read from a row-major tile whose
// rows are padded to 80 bytes. Fragment layouts follow the PTX ISA's
// m16n8k32 .s8 figures: A reg r holds row g (+8 for r odd), K bytes
// 4t..4t+3 (+16 for r >= 2); B reg r holds column g, K bytes 4t..4t+3
// (+16 for r = 1); C regs 0,1 row g, columns 2t, 2t+1, regs 2,3 row g+8
// (g = lane / 4, t = lane % 4).
//
// The epilogue rounds in the order of the TPU kernel (w8a8.py:72-84) with
// explicitly rounded operations, so no multiply-add is contracted: the
// integer sum is exact, and the output is bit-identical to a plain version
// that also sums exactly.
#include "common.cuh"

namespace {

using eetq::bf16;

// the tile comes from kernels/autotune.py::W8A8_TILE (nvcc -D flags)
constexpr int kBM = EETQ_W8A8_BM, kBN = EETQ_W8A8_BN, kBK = EETQ_W8A8_BK, kThreads = 256;
static_assert(kBM == 128 && kBN == 128 && kBK == 64,
              "the load mapping below covers a 128 x 64 A tile and a 64 x 128 B tile");
constexpr int kALd = kBK + 16;  // bytes per A row in shared memory: 20 words
constexpr int kBWords = kBK / 4;  // 16 words per B column
constexpr int kWM = 64, kWN = 32;  // warp tile; warps form a 2 x 4 grid
constexpr int kFM = kWM / 16, kFN = kWN / 8;
static_assert((kBM / kWM) * (kBN / kWN) == kThreads / 32, "one warp tile per warp");

// Word index of (column n, K word kw) in the B tile.
__device__ __forceinline__ int b_word(int n, int kw) {
  const int sw = ((((n >> 1) ^ (n >> 3)) & 3) << 2) | (((n >> 5) & 1) << 1);
  return n * kBWords + (kw ^ sw);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads) w8a8_gemm_kernel(
    const int8_t* __restrict__ xq, int m, int kp, const int8_t* __restrict__ w, int np,
    const float* __restrict__ sx, const float* __restrict__ sw, const float* __restrict__ bias,
    bf16* __restrict__ out, int n) {
  __shared__ __align__(16) uint32_t as[2][kBM * kALd / 4];
  __shared__ __align__(16) uint32_t bs[2][kBN * kBWords];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[kFM][kFN][4];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // A tile: 128 rows x 4 vectors of 16 bytes (2 per thread), rows past m
  // are 0. B tile: thread (kg, ng) takes rows 4kg..4kg+3, columns
  // 8ng..8ng+7; lanes run along N so each row's loads are coalesced.
  const int ng = lane & 15, kg = (lane >> 4) + 2 * warp;
  int4 a_reg[2];
  uint2 b_reg[4];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, row = idx >> 2, gm = m0 + row;
      a_reg[i] = gm < m ? *reinterpret_cast<const int4*>(xq + (size_t)gm * kp + k0 + (idx & 3) * 16)
                        : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      b_reg[r] = __ldg(reinterpret_cast<const uint2*>(
          w + (size_t)(k0 + 4 * kg + r) * np + n0 + 8 * ng));
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<int4*>(&as[buf][(idx >> 2) * (kALd / 4) + (idx & 3) * 4]) = a_reg[i];
    }
    // 4 x 4 byte transposes: word j of the output holds column j's bytes of
    // rows 0..3 (row 0 in the low byte: the smallest K first)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r0 = h ? b_reg[0].y : b_reg[0].x, r1 = h ? b_reg[1].y : b_reg[1].x;
      const uint32_t r2 = h ? b_reg[2].y : b_reg[2].x, r3 = h ? b_reg[3].y : b_reg[3].x;
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
      const int nb = 8 * ng + 4 * h;
      bs[buf][b_word(nb + 0, kg)] = __byte_perm(t0, t2, 0x5410);
      bs[buf][b_word(nb + 1, kg)] = __byte_perm(t0, t2, 0x7632);
      bs[buf][b_word(nb + 2, kg)] = __byte_perm(t1, t3, 0x5410);
      bs[buf][b_word(nb + 3, kg)] = __byte_perm(t1, t3, 0x7632);
    }
  };

  const int nk = kp / kBK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int s = 0; s < nk; ++s) {
    const int buf = s & 1;
    if (s + 1 < nk) load_tile((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 4; kk += 8) {  // 32-byte slices, in words
      uint32_t af[kFM][4], bf[kFN][2];
#pragma unroll
      for (int i = 0; i < kFM; ++i) {
        const uint32_t* p = &as[buf][(wm * kWM + i * 16 + g) * (kALd / 4) + kk + t];
        af[i][0] = p[0];
        af[i][1] = p[8 * (kALd / 4)];
        af[i][2] = p[4];
        af[i][3] = p[8 * (kALd / 4) + 4];
      }
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
        const int nc = wn * kWN + j * 8 + g;
        bf[j][0] = bs[buf][b_word(nc, kk + t)];
        bf[j][1] = bs[buf][b_word(nc, kk + 4 + t)];
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (s + 1 < nk) store_tile(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: r = f32(acc) * sx[row], then * sw[col], then + bias[col],
  // then one rounding to bf16.
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gm = m0 + wm * kWM + i * 16 + g + 8 * hr;
      if (gm >= m) continue;
      const float rs = sx[gm];
#pragma unroll
      for (int j = 0; j < kFN; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * kWN + j * 8 + 2 * t + e;
          if (gn < n) {
            float r = __fmul_rn(__int2float_rn(acc[i][j][2 * hr + e]), rs);
            r = __fmul_rn(r, sw[gn]);
            if (bias != nullptr) r = __fadd_rn(r, bias[gn]);
            out[(size_t)gm * n + gn] = __float2bfloat16_rn(r);
          }
        }
      }
    }
  }
}

}  // namespace

// xq [m, kp] int8 contiguous (zero past the logical K); w int8 [kp, np]
// (kp, np % 128 == 0); sx f32 [m]; sw f32 [n]; bias f32 [n] or null;
// out bf16 [m, n].
extern "C" int eetq_w8a8_gemm(const void* xq, int m, int kp, const void* w, int np,
                              const void* sx, const void* sw, const void* bias, void* out, int n,
                              void* stream) {
  const dim3 grid(np / kBN, (m + kBM - 1) / kBM);
  w8a8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), m, kp, static_cast<const int8_t*>(w), np,
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<bf16*>(out), n);
  return cudaGetLastError();
}
