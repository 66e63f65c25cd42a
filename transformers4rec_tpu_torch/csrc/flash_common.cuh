// Pieces shared by the port's attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile sizes, the one function that scales and masks a logit (so the
// forward and the three backward bodies cannot drift apart), the tile loads
// from the (B, S, H, Dh) float32 layout into bf16 shared memory, and the
// mma.sync.m16n8k16 tile products.
//
// The mma.sync kernels work on tiles of TQ = 64 queries by TK = 64 keys with
// 4 warps; a warp owns 16 rows of the tile it accumulates (queries in the
// forward and the dq body, keys in the dk/dv body). The head dim is padded
// with zeros to DP = 16 * KS in shared memory. (The wgmma kernels' tiles are
// flash_hopper.cuh's.)
//
// Masks are finite numbers, as in the reference (ops/attention.py:
// _tile_logits): causal REPLACES the logit by NEG where key > query, the
// ragged tail (key >= S) REPLACES it by 2 * NEG, padding ADDS NEG, the bias
// is ADDED. A row whose running maximum never rose above NEG / 2 is invalid:
// its output is 0 and its lse the sentinel -2 * NEG, so exp(logit - lse) is
// 0 in the backward.

#pragma once

#include "common.cuh"

namespace t4r {
namespace flash {

constexpr int TQ = 64;             // queries per tile
constexpr int TK = 64;             // keys per tile
constexpr int FTHREADS = 128;      // 4 warps of 16 rows
constexpr int LDT = TK + 8;        // bf16 per row of a transposed tile ([d][row])
constexpr float FNEG = -1e9f;      // the reference's NEG
constexpr float LSE_MASKED = 2e9f; // -2 * NEG: lse of a row with no valid key

// Row stride (bf16) of a row-major tile ([row][d]); the +8 keeps the
// fragment loads of 8 rows x 4 words free of bank conflicts.
template <int KS>
struct Tile {
  static constexpr int DP = 16 * KS;
  static constexpr int LD = DP + 8;
  static constexpr int NTD = DP / 8;  // n-tiles of 8 across the head dim
};

// The scaled and masked logit of (query row, key col). `pad_add` is the
// key's padding term: 0, NEG for a padded key, 2 * NEG beyond the sequence
// when a pad mask is given. `bias_bh` points at this (batch, head)'s (S, S)
// plane of the bias (broadcast axes have stride 0).
template <bool HAS_BIAS>
__device__ __forceinline__ float masked_logit(float raw, float scale, int row, int col, int S,
                                              bool causal, float pad_add,
                                              const float* __restrict__ bias_bh) {
  float l = raw * scale;
  if (causal && col > row) l = FNEG;
  if (col >= S) l = 2.f * FNEG;
  l += pad_add;
  if (HAS_BIAS) {
    if (row < S && col < S) l += __ldg(bias_bh + (size_t)row * S + col);
  }
  return l;
}

// The padding terms of the 64 keys from k0 on, into shared memory.
__device__ __forceinline__ void load_pad_terms(const uint8_t* __restrict__ pad_b, int k0, int S,
                                               float* __restrict__ pad_s, int tid) {
  for (int c = tid; c < TK; c += FTHREADS) {
    const int key = k0 + c;
    float v = 0.f;
    if (pad_b != nullptr) v = key < S ? (pad_b[key] ? 0.f : FNEG) : 2.f * FNEG;
    pad_s[c] = v;
  }
}

// Rows [s0, s0 + 64) of one (batch, head) of a (B, S, H, Dh) float32 tensor,
// rounded to bf16, into shared memory: row-major into `rm` ([row][LD]) when
// ROWMAJOR, transposed into `tr` ([d][LDT]) when TRANSPOSED. `base` points at
// (batch, 0, head, 0) and `row_stride` is H * Dh. Rows at and beyond S and
// columns Dh..DP-1 are zero.
template <int KS, bool ROWMAJOR, bool TRANSPOSED>
__device__ __forceinline__ void load_tile(const float* __restrict__ base, int row_stride, int s0,
                                          int S, int Dh, __nv_bfloat16* __restrict__ rm,
                                          __nv_bfloat16* __restrict__ tr, int tid) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD;
  constexpr int C4 = DP / 4;  // float4 pieces per padded row
  const int d4n = Dh / 4;
  for (int idx = tid; idx < 64 * C4; idx += FTHREADS) {
    const int r = idx / C4, c = idx - r * C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < S && c < d4n) {
      x = __ldg(reinterpret_cast<const float4*>(base + (size_t)(s0 + r) * row_stride) + c);
    }
    if (ROWMAJOR) {
      uint2 w;
      w.x = pack_bf16(x.x, x.y);
      w.y = pack_bf16(x.z, x.w);
      *reinterpret_cast<uint2*>(rm + r * LD + 4 * c) = w;
    }
    if (TRANSPOSED) {
      tr[(4 * c + 0) * LDT + r] = __float2bfloat16(x.x);
      tr[(4 * c + 1) * LDT + r] = __float2bfloat16(x.y);
      tr[(4 * c + 2) * LDT + r] = __float2bfloat16(x.z);
      tr[(4 * c + 3) * LDT + r] = __float2bfloat16(x.w);
    }
  }
}

// The A fragments (16 rows from `row0` on, KSTEPS k-steps of 16) of a bf16
// tile held in shared memory as 32-bit words, `ld32` words a row.
template <int KSTEPS>
__device__ __forceinline__ void load_a_fragments(const uint32_t* __restrict__ A32, int ld32,
                                                 int row0, int g, int t,
                                                 uint32_t (&a)[KSTEPS][4]) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int lo = (row0 + g) * ld32 + ks * 8 + t, hi = lo + 8 * ld32;
    a[ks][0] = A32[lo];
    a[ks][1] = A32[hi];
    a[ks][2] = A32[lo + 4];
    a[ks][3] = A32[hi + 4];
  }
}

// acc[j] += A . B^T for NT n-tiles of 8: A are register fragments (16 rows,
// 16 * KSTEPS deep); B lies in shared memory with row n = 8j + g holding the
// k values contiguously (`ld32` words a row). acc[j][2h + q] is row g + 8h,
// column 8j + 2t + q.
template <int KSTEPS, int NT_>
__device__ __forceinline__ void mma_tile(const uint32_t (&a)[KSTEPS][4],
                                         const uint32_t* __restrict__ B32, int ld32, int g, int t,
                                         float (&acc)[NT_][4]) {
#pragma unroll
  for (int j = 0; j < NT_; ++j) {
    const int base = (8 * j + g) * ld32 + t;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      mma_bf16(acc[j], a[ks], B32[base + ks * 8], B32[base + ks * 8 + 4]);
    }
  }
}

// The same with A read from shared memory one k-step at a time (fewer live
// registers when the accumulators are many).
template <int KSTEPS, int NT_>
__device__ __forceinline__ void mma_tile_smem(const uint32_t* __restrict__ A32, int lda32,
                                              int row0, const uint32_t* __restrict__ B32,
                                              int ldb32, int g, int t, float (&acc)[NT_][4]) {
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t a[4];
    const int lo = (row0 + g) * lda32 + ks * 8 + t, hi = lo + 8 * lda32;
    a[0] = A32[lo];
    a[1] = A32[hi];
    a[2] = A32[lo + 4];
    a[3] = A32[hi + 4];
#pragma unroll
    for (int j = 0; j < NT_; ++j) {
      const int base = (8 * j + g) * ldb32 + t + ks * 8;
      mma_bf16(acc[j], a, B32[base], B32[base + 4]);
    }
  }
}

template <int NT_>
__device__ __forceinline__ void zero_acc(float (&acc)[NT_][4]) {
#pragma unroll
  for (int j = 0; j < NT_; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// A (16 x 64) tile of accumulators, rounded to bf16, as the A fragments of
// the next product: the C layout of n-tiles 2ks and 2ks + 1 is the A layout
// of k-step ks.
__device__ __forceinline__ void pack_a_fragments(const float (&c)[8][4], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
    a[ks][1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
    a[ks][2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

// A warp's 16 x DP accumulators, times `scale`, to rows row0 + g (+ 8) of one
// (batch, head) of a (B, S, H, Dh) float32 tensor; rows >= S and columns >=
// Dh are left out.
template <int NTD>
__device__ __forceinline__ void store_rows(const float (&acc)[NTD][4], float scale,
                                           float* __restrict__ base, int row_stride, int row0,
                                           int S, int Dh, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= S) continue;
    float* dst = base + (size_t)row * row_stride;
#pragma unroll
    for (int j = 0; j < NTD; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < Dh) {
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
      }
    }
  }
}

}  // namespace flash
}  // namespace t4r
