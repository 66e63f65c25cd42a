// Pieces shared by the port's vocabulary kernels: the base-2 exponential,
// bf16 packing and the constants for all of them; for the streamed pass of
// ce_rank.cu and rank.cu (vocab_stream.cuh) also the row tile and the vocab
// chunk it splits the table by, and the bf16 tensor-core product with which
// it scores the table's rows by mma.sync.m16n8k16 (bf16 in, f32
// accumulation). ce_fwd.cu and ce_bwd.cu use wgmma (hopper.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t4r {

constexpr int BN = 128;       // rows per block: 8 warps x 16 rows
constexpr int BV = 64;        // vocab columns per chunk of a split
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

}  // namespace t4r
