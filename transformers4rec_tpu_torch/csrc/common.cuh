// Pieces shared by the port's vocabulary kernels (ce_rank.cu, ce_fwd.cu,
// ce_bwd.cu): the tile sizes, the bf16 tensor-core product and the base-2
// exponential. Every kernel scores a tile of BN rows of x against a chunk of
// BV rows of the item table with mma.sync.m16n8k16 (bf16 in, f32
// accumulation): 8 warps of 16 rows each, 8 n-tiles of 8 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t4r {

constexpr int BN = 128;       // rows per block: 8 warps x 16 rows
constexpr int BV = 64;        // vocab columns per chunk: 8 mma n-tiles of 8
constexpr int NT = BV / 8;    // n-tiles per chunk
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^v on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A (16x16, row) . B (16x8, col): bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float x_at(const float* __restrict__ x, int N, int E, int row,
                                      int k) {
  return (row < N && k < E) ? x[(size_t)row * E + k] : 0.f;
}

// One warp's 16 rows of x (rows row_lo and row_lo + 8 for this lane), read
// as f32 and rounded to bf16, as the A fragments of KS k-steps of 16;
// columns E..16*KS-1 and rows >= N are zero.
template <int KS>
__device__ __forceinline__ void load_x_fragments(const float* __restrict__ x, int N, int E,
                                                 int row_lo, int t, uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k = ks * 16 + 2 * t;
    a[ks][0] = pack_bf16(x_at(x, N, E, row_lo, k), x_at(x, N, E, row_lo, k + 1));
    a[ks][1] = pack_bf16(x_at(x, N, E, row_lo + 8, k), x_at(x, N, E, row_lo + 8, k + 1));
    a[ks][2] = pack_bf16(x_at(x, N, E, row_lo, k + 8), x_at(x, N, E, row_lo, k + 9));
    a[ks][3] = pack_bf16(x_at(x, N, E, row_lo + 8, k + 8), x_at(x, N, E, row_lo + 8, k + 9));
  }
}

// Logits of a warp's 16 rows against the BV columns of a chunk held in
// shared memory as bf16 rows of WS values (ws32: the same memory as 32-bit
// words). acc[j][2h + q] is row g + 8h, column 8j + 2t + q of the chunk.
template <int KS, int WS>
__device__ __forceinline__ void score_chunk(const uint32_t (&a)[KS][4],
                                            const uint32_t* __restrict__ ws32, int g, int t,
                                            float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int base = (8 * j + g) * (WS / 2) + t;  // B fragment: column 8j + g, k pair 2t
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      mma_bf16(acc[j], a[ks], ws32[base + ks * 8], ws32[base + ks * 8 + 4]);
    }
  }
}

}  // namespace t4r
