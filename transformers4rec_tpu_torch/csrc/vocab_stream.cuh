// The streamed vocabulary pass that K3 (ce_rank.cu) and K4 (rank.cu) share
// on tables up to E = 256, and the merge of its partials.
//
// For every row n of x (N, E) against the item table W (Vp, E), over the
// columns c < V (the caller's bound; rows V..Vp-1 are padding and are never
// read), the pass computes the logits bf16(x[n]) . bf16(W[c]) with f32
// accumulation and hands each one to an epilogue, which keeps a running
// state per row: K3's is (max, sum, count, zsum), K4's the count alone.
//
// Design. The TPU kernels stream V as a sequential grid axis and keep the
// running state of every row in VMEM across grid steps. Hopper blocks run in
// no order and share nothing, and at N = 128 there is a single row tile, so
// the vocab is split across blocks and a second kernel merges the splits:
//   - stream::kernel: block (split, row tile) of WARPS consumer warps
//     (each holding MT 16-row tiles of x as bf16 mma.sync A fragments in
//     registers; the epilogue sets MT) and one producer warp. The producer
//     copies the split's rows of W, as stored (f32 or bf16) and only those
//     below V, by 1-D bulk copies (TMA without a tensor map) into a ring of
//     `stages` slots, each guarded by a full and an empty mbarrier. The
//     consumers round a slot's rows to bf16 as they build the B fragments (a
//     bf16 table's pairs are B fragment words as stored), score with
//     mma.sync.m16n8k16, let the slot go, and fold the logits into the
//     epilogue's state. Only the slot that holds one of a warp's labels and
//     the vocab's last, partial slot take the checked fold (columns bounded
//     by V, the label's own column left out of the count: the label logit
//     ll comes from another sum order and may differ from its own logit in
//     the last ulp). At the end the epilogue merges each row's lanes and
//     writes one partial per (split, row). The launch plan
//     (ops/vocab.py:ce_plan) gives the splits, the slots and the shared
//     memory: about 128 KB of the table in flight on each SM, for either
//     table form (a bf16 slot has half the bytes, the plan gives twice the
//     slots);
//   - merge_kernel: a block per 32 rows, lane = row (a warp's loads are one
//     128-byte line each), warp w folding splits w, w + 32, ...; then warp 0
//     folds the 32 warps' results of its row in warp order, so the result is
//     the same on every call. K3 merges (m, s) pairs by rescaled sums and
//     counts and sums by addition (SOFTMAX), K4 adds counts only.
// The table is read from device memory once, as stored, with `stages` slots
// in flight: no image pass. So the least time is the table's bytes over the
// card's memory rate (at the evaluation shape, N = 128, E = 64, V = 390,001:
// 99.8 MB f32, 29.8 us; 49.9 MB bf16, 14.9 us), and the design keeps the
// card reading the table; the products (6.39 GFLOP there) run meanwhile on
// the tensor cores. (Measured, the pass is held back by neither alone:
// PERF.md, K4.)

#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace t4r {
namespace stream {

using namespace t4r::hopper;

constexpr int WARPS = 8;  // consumer warps: BN rows of x
constexpr int THREADS = 32 * (WARPS + 1);
constexpr int MIN_STAGES = 4;

// The blocks an SM is to hold of the pass at KS k-steps, its launch bound:
// two up to E = 64, where a ring of MIN_STAGES slots fits twice in either
// table form, which holds a thread to 112 registers (with more, an SM holds
// one block and the ring the plan sized for two keeps half the bytes in
// flight: PERF.md, K3 and K4); one past E = 64, where the x fragments
// alone take 4 KS MT registers. The launch plan (ops/vocab.py:ce_plan)
// reads it through t4r_ce_rank_min_blocks and t4r_rank_min_blocks.
constexpr int min_blocks(int ks) { return ks <= 4 ? 2 : 1; }

// A ring slot for E padded to EK = 16 KS, of table values T (f32 or bf16):
// GROUPS groups of 8 rows of E values, group_words(E) 32-bit words apart
// (the rows, then zeros: at least EK - E values of them, for the last row's
// k-steps past E). A group starts 16 words more than a multiple of 32 after
// the previous one for f32 (a quarter warp's 16-byte reads of two rows from
// neighbouring groups fall on 32 distinct banks), 8 more for bf16 (a half
// warp's 8-byte reads of four groups' rows do). 64 rows, or 32 at the widest
// EK so that 4 f32 slots fit. Lane g of n-tile j takes row
// (g % GROUPS) * 8 + j * (8 / GROUPS) + g / GROUPS of the slot. Within each
// k-step of 16, thread t takes columns 4t .. 4t + 3, in x's fragments as in
// W's.
template <int KS, class T>
struct Slot {
  static constexpr int EK = 16 * KS;
  static constexpr int GROUPS = KS <= 8 ? 8 : 4;
  static constexpr int ROWS = 8 * GROUPS;
  static constexpr int NTS = ROWS / 8;
  static constexpr bool BF16 = sizeof(T) == 2;
  // 32-bit words of one row of E values
  __host__ __device__ static constexpr int row_words(int E) { return BF16 ? E / 2 : E; }
  __host__ __device__ static constexpr int group_words(int E) {
    return BF16 ? (4 * E + (EK - E) / 2 + 23) / 32 * 32 + 8
                : 8 * E + (EK - E + 31) / 32 * 32 + 16;
  }
  __host__ __device__ static constexpr int bytes(int E) { return GROUPS * group_words(E) * 4; }
  // the slot row of lane g of n-tile j
  __device__ static constexpr int row(int j, int g) {
    return (g % GROUPS) * 8 + j * (8 / GROUPS) + g / GROUPS;
  }
  // The B fragment pair of k-step ks from the 32-bit word wr of a row's
  // columns 4t ..: f32 rounded to bf16 pairs, bf16 pairs as they are.
  __device__ static void fragments(const uint32_t* wr, int ks, uint32_t& b0, uint32_t& b1) {
    if constexpr (BF16) {
      const uint2 w = *reinterpret_cast<const uint2*>(wr + 8 * ks);
      b0 = w.x;
      b1 = w.y;
    } else {
      const float4 w = *reinterpret_cast<const float4*>(wr + 16 * ks);
      b0 = pack_bf16(w.x, w.y);
      b1 = pack_bf16(w.z, w.w);
    }
  }
};

// The shared memory of a block with `stages` slots at width E: the ring,
// then a full and an empty barrier per slot.
template <int KS, class T>
__host__ __device__ constexpr int smem(int E, int stages) {
  return stages * (Slot<KS, T>::bytes(E) + 16);
}

// One slot's products of a consumer warp: its MT row tiles against its NTW
// n-tiles of the slot, acc[m][jj][2h + q] of row rows[2m + h].
template <class L, int NTW, int MT, int KS>
__device__ __forceinline__ void products(float (&acc)[MT][NTW][4], const uint32_t* slot,
                                         const uint32_t (&a)[MT][KS][4], int gw, int rw, int g,
                                         int ng, int t) {
#pragma unroll
  for (int jj = 0; jj < NTW; ++jj) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][jj][0] = acc[m][jj][1] = acc[m][jj][2] = acc[m][jj][3] = 0.f;
    }
    const int r = L::row(ng * NTW + jj, g);
    // the word of columns 4t, 4t + 1 of the row
    const uint32_t* wr = slot + (r / 8) * gw + (r % 8) * rw + (L::BF16 ? 2 : 4) * t;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b0, b1;
      L::fragments(wr, ks, b0, b1);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_bf16(acc[m][jj], a[m][ks], b0, b1);
    }
  }
}

// One slot's products, the slot let go, then their fold into the
// epilogue's state, checked or not. With Epi::OVERLAP the branch between
// the checked and the unchecked fold is taken around the whole, so the fold
// of one n-tile may overlap the products of the next (K4); without it the
// products come first and the branch is around the fold alone (K3's order
// before the pass was shared; for K3 the two orders measured alike, within
// the spread between calls: PERF.md).
template <class L, int NTW, class Epi, int MT, int KS, class Col>
__device__ __forceinline__ void score_slot(bool checked, Epi& epi, const uint32_t* slot,
                                           uint64_t* empty, int st,
                                           const uint32_t (&a)[MT][KS][4], int gw, int rw,
                                           int g, int ng, int t, Col col_of, int V,
                                           const int (&lab)[2 * MT],
                                           const float (&llr)[2 * MT]) {
  if constexpr (Epi::OVERLAP) {
    if (checked) {
      float acc[MT][NTW][4];
      products<L, NTW>(acc, slot, a, gw, rw, g, ng, t);
      release(empty, st);
      epi.template update<true, NTW>(acc, col_of, V, lab, llr);
    } else {
      float acc[MT][NTW][4];
      products<L, NTW>(acc, slot, a, gw, rw, g, ng, t);
      release(empty, st);
      epi.template update<false, NTW>(acc, col_of, V, lab, llr);
    }
  } else {
    float acc[MT][NTW][4];
    products<L, NTW>(acc, slot, a, gw, rw, g, ng, t);
    release(empty, st);
    if (checked) {
      epi.template update<true, NTW>(acc, col_of, V, lab, llr);
    } else {
      epi.template update<false, NTW>(acc, col_of, V, lab, llr);
    }
  }
}

// The pass with epilogue Epi, a struct that holds a consumer thread's state
// of its rows and provides
//   MT: the 16-row tiles of x each consumer warp holds. The WARPS warps
//     cover the block's BN rows in WARPS / MT groups, and the MT warps that
//     hold the same rows split each slot's n-tiles between them: every
//     warp reads 1 / MT of a slot from shared memory and uses each B
//     fragment for MT products. A thread has 2 MT rows: rows[2m + h];
//   OVERLAP: where the branch between the checked and the unchecked fold
//     goes (score_slot);
//   prepare(tid): called by every thread before the ring starts;
//   Out: where the partials go (the kernel's last argument);
//   update<CHECKED, NTW>(acc, col_of, V, lab, llr): one slot's logits of
//     the warp's NTW n-tiles, acc[m][jj][2h + q] of row rows[2m + h] at
//     column col_of(jj, q), into the state;
//   finish(rows, N, split, out): each row's lanes and warps merged, one
//     partial per (split, row) written.
template <int KS, class T, class Epi>
__global__ void __launch_bounds__(THREADS, min_blocks(KS))
kernel(const float* __restrict__ x, const T* __restrict__ W, const int* __restrict__ labels,
       const float* __restrict__ ll, int N, int E, int V, int chunks_per_split, int stages,
       typename Epi::Out out) {
  using L = Slot<KS, T>;
  constexpr int MT = Epi::MT, MG = WARPS / MT, NTW = L::NTS / MT;
  static_assert(WARPS % MT == 0 && L::NTS % MT == 0, "MT must divide the warps and n-tiles");
  extern __shared__ __align__(16) uint8_t shared[];
  const int gw = L::group_words(E), slot_words = L::GROUPS * gw, rw = L::row_words(E);
  uint32_t* ring = reinterpret_cast<uint32_t*>(shared);
  uint64_t* full = reinterpret_cast<uint64_t*>(shared + (size_t)stages * slot_words * 4);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the split's rows of W: [row_begin, row_end), in `slots` slots
  const int row_begin = blockIdx.x * chunks_per_split * BV;
  const int row_end = min(row_begin + chunks_per_split * BV, V);
  const int slots = row_end > row_begin ? (row_end - row_begin + L::ROWS - 1) / L::ROWS : 0;

  // the zeros between groups stay (the copies write 8 E values a group), and
  // rows past V hold zeros or an earlier slot's rows: finite
  for (int i = tid; i < stages * slot_words / 4; i += THREADS) {
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  Epi::prepare(tid);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WARPS);
    }
    fence_barrier_init();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, before the copies
  __syncthreads();

  if (warp == WARPS) {  // the producer: lane r copies group r of each slot
    for (int i = 0; i < slots; ++i) {
      const int st = i % stages, r0 = row_begin + i * L::ROWS;
      const int rows = min(L::ROWS, row_end - r0);
      mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
      const int n = min(8, rows - 8 * lane);
      uint32_t* dst = ring + (size_t)st * slot_words + lane * gw;
      const T* src = W + (size_t)(r0 + 8 * lane) * E;
      // A bulk copy moves whole 16-byte pieces. Every group of 8 rows is
      // whole pieces; the vocab's last group of bf16 rows may end in 8 bytes
      // more (an odd count of rows when E is not a multiple of 8), which the
      // lane copies itself before the slot is announced.
      const uint32_t bytes = lane < L::GROUPS && n > 0 ? (uint32_t)(n * E * sizeof(T)) : 0u;
      if constexpr (L::BF16) {
        if (bytes % 16) {
          reinterpret_cast<uint2*>(dst)[bytes / 8 - 1] =
              __ldg(reinterpret_cast<const uint2*>(src) + bytes / 8 - 1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_expect_tx(&full[st], (uint32_t)(rows * E * sizeof(T)) & ~15u);
      __syncwarp();
      if (bytes >= 16) bulk_load(dst, src, bytes & ~15u, &full[st]);
    }
    return;
  }

  // warp = ng * MG + mg: m-tiles mg * MT .. + MT - 1 of the row tile, n-tiles
  // ng * NTW .. + NTW - 1 of each slot
  const int g = lane >> 2, t = lane & 3, mg = warp % MG, ng = warp / MG;
  int rows[2 * MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    rows[2 * m] = (int)blockIdx.y * BN + (mg * MT + m) * 16 + g;
    rows[2 * m + 1] = rows[2 * m] + 8;
  }
  // x as A fragments: a[m][ks][h] holds row rows[2m + h], columns 16 ks +
  // 4t, +1; a[m][ks][2 + h] columns 16 ks + 4t + 2, +3 (zero at and beyond
  // N and E)
  uint32_t a[MT][KS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 16 * ks + 4 * t, row = rows[2 * m + h];
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < N && col < E) {
          v = __ldg(reinterpret_cast<const float4*>(x + (size_t)row * E + col));
        }
        a[m][ks][h] = pack_bf16(v.x, v.y);
        a[m][ks][2 + h] = pack_bf16(v.z, v.w);
      }
    }
  }

  float llr[2 * MT];
  int lab[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    lab[r] = rows[r] < N ? labels[rows[r]] : -1;
    llr[r] = rows[r] < N ? ll[rows[r]] : 0.f;
  }
  Epi epi;

  for (int i = 0; i < slots; ++i) {
    const int st = i % stages;
    // the slot's columns: acc[m][jj][2h + q] is row rows[2m + h], column
    // col_of(jj, q). Only the slot that holds one of the warp's labels and
    // the vocab's last, partial slot take the checked fold; the choice is
    // the warp's, since with Epi::OVERLAP both forms hold its mma.sync and
    // its release (the checked fold gives the unchecked one's result on any
    // other slot).
    const int c0 = row_begin + i * L::ROWS;
    const auto col_of = [=](int jj, int q) { return c0 + L::row(ng * NTW + jj, 2 * t + q); };
    bool checked = c0 + L::ROWS > V;
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) checked |= (unsigned)(lab[r] - c0) < (unsigned)L::ROWS;
    checked = __any_sync(0xffffffffu, checked);
    mbar_wait(&full[st], (i / stages) & 1);
    const uint32_t* slot = ring + (size_t)st * slot_words;
    score_slot<L, NTW>(checked, epi, slot, empty, st, a, gw, rw, g, ng, t, col_of, V, lab, llr);
  }
  epi.finish(rows, N, (int)blockIdx.x, out);
}

// The pass with `stages` ring slots and `smem` bytes of shared memory, which
// must be what the launch plan (ops/vocab.py:ce_plan) gives: at least
// MIN_STAGES slots and smem(E, stages) bytes within the card's limit.
template <int KS, class T, class Epi>
cudaError_t launch(dim3 grid, cudaStream_t st, const float* x, const T* W, const int* labels,
                   const float* ll, int N, int E, int V, int chunks_per_split, int stages,
                   int smem_bytes, typename Epi::Out out) {
  if (stages < MIN_STAGES || smem_bytes != smem<KS, T>(E, stages) || smem_bytes > MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  auto k = kernel<KS, T, Epi>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  k<<<grid, THREADS, smem_bytes, st>>>(x, W, labels, ll, N, E, V, chunks_per_split, stages, out);
  return cudaGetLastError();
}

// How many blocks of the pass with `smem_bytes` of shared memory an SM holds
// at once (0 on an error): the launch plan counts on blocks_per_sm of them.
template <int KS, class T, class Epi>
int resident_blocks(int smem_bytes) {
  auto k = kernel<KS, T, Epi>;
  int blocks = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, THREADS, smem_bytes) !=
          cudaSuccess) {
    return 0;
  }
  return blocks;
}

// E rounded up to 16, 32, 64, 128 or 256 (zero padded) as KS k-steps of 16
template <class F>
cudaError_t with_ks(int E, F f) {
  if (E <= 16) return f(std::integral_constant<int, 1>());
  if (E <= 32) return f(std::integral_constant<int, 2>());
  if (E <= 64) return f(std::integral_constant<int, 4>());
  if (E <= 128) return f(std::integral_constant<int, 8>());
  return f(std::integral_constant<int, 16>());
}

// smem(E, stages) for the KS that holds E
template <class T>
int smem_of(int E, int stages) {
  int bytes = 0;
  with_ks(E, [&](auto ks) {
    bytes = smem<decltype(ks)::value, T>(E, stages);
    return cudaSuccess;
  });
  return bytes;
}

// min_blocks for the KS that holds E
inline int min_blocks_of(int E) {
  int blocks = 1;
  with_ks(E, [&](auto ks) {
    blocks = min_blocks(decltype(ks)::value);
    return cudaSuccess;
  });
  return blocks;
}

// resident_blocks for the KS that holds E, of a bf16 or an f32 table
template <template <int> class Epi>
int resident_blocks_of(int E, int smem_bytes, bool bf16) {
  int blocks = 0;
  with_ks(E, [&](auto ks) {
    constexpr int KS = decltype(ks)::value;
    blocks = bf16 ? resident_blocks<KS, __nv_bfloat16, Epi<KS>>(smem_bytes)
                  : resident_blocks<KS, float, Epi<KS>>(smem_bytes);
    return cudaSuccess;
  });
  return blocks;
}

// ------------------------------------------------------------- the merge
// One thread per row looping over some 250 splits, each load waited on in
// turn, took 38 us in K3 and 5.5-8 us in K4 at 128 rows (PERF.md).
constexpr int MERGE_WARPS = 32;

__device__ __forceinline__ void merge_pair(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// Merges the (splits, N) partials of every row: with SOFTMAX (K3) the
// (m, s) pairs into lse, the counts into rank and, where zsum is given, the
// sums; without (K4) the counts into rank alone.
template <bool SOFTMAX>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
             const int* __restrict__ part_cnt, const double* __restrict__ part_zs, int splits,
             int N, float* __restrict__ lse, int* __restrict__ rank, float* __restrict__ zsum) {
  __shared__ float sm[SOFTMAX ? MERGE_WARPS : 1][32], ss[SOFTMAX ? MERGE_WARPS : 1][32];
  __shared__ int sc[MERGE_WARPS][32];
  __shared__ double sz[SOFTMAX ? MERGE_WARPS : 1][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  float m = NEG, s = 0.f;
  int cnt = 0;
  double zs = 0.0;
  if (n < N) {
#pragma unroll 4
    for (int k = warp; k < splits; k += MERGE_WARPS) {
      const size_t idx = (size_t)k * N + n;
      if (SOFTMAX) merge_pair(m, s, part_m[idx], part_s[idx]);
      cnt += part_cnt[idx];
      if (SOFTMAX && zsum != nullptr) zs += part_zs[idx];
    }
  }
  if (SOFTMAX) {
    sm[warp][lane] = m;
    ss[warp][lane] = s;
    sz[warp][lane] = zs;
  }
  sc[warp][lane] = cnt;
  __syncthreads();
  if (warp != 0 || n >= N) return;
  for (int w = 1; w < MERGE_WARPS; ++w) {
    if (SOFTMAX) {
      merge_pair(m, s, sm[w][lane], ss[w][lane]);
      zs += sz[w][lane];
    }
    cnt += sc[w][lane];
  }
  rank[n] = cnt;
  if (SOFTMAX) {
    // no valid column at all (V == 0): the reference's masked logits give -1e30
    lse[n] = s > 0.f ? m + logf(s) : NEG;
    if (zsum != nullptr) zsum[n] = (float)zs;
  }
}

template <bool SOFTMAX>
cudaError_t launch_merge(cudaStream_t st, const float* part_m, const float* part_s,
                         const int* part_cnt, const double* part_zs, int splits, int N,
                         float* lse, int* rank, float* zsum) {
  merge_kernel<SOFTMAX><<<(N + 31) / 32, 32 * MERGE_WARPS, 0, st>>>(
      part_m, part_s, part_cnt, part_zs, splits, N, lse, rank, zsum);
  return cudaGetLastError();
}

}  // namespace stream
}  // namespace t4r
