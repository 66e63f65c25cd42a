// Fused evaluation pass over the item vocabulary (kernel K3 of the port).
//
// For every row n of x (N, E) against the item table W (Vp, E), over the
// columns c < V (the true vocab; rows V..Vp-1 are padding):
//   lse[n]  = logsumexp_c  bf16(x[n]) . bf16(W[c])          (f32 accumulation)
//   rank[n] = #{c : c != label[n], logit[n, c] > ll[n]}      (int32)
//   zsum[n] = sum_c logit[n, c]                              (label smoothing only)
// ll[n] is the label logit, computed by the caller with an O(N.E) gather-dot.
//
// Replaces: transformers4rec_tpu/ops/vocab.py:_ce_rank_kernel (launched by
// fused_ce_and_rank through pl.pallas_call, vocab.py:859).
//
// Bound on an H100 at the evaluation shape (N=128, E=64, V=390,001, W f32):
// the table read is 390,001 x 64 x 4 B = 99.8 MB, 29.8 us at 3.35 TB/s; the
// product is 2 x 128 x 64 x 390,001 = 6.39 GFLOP, 6.5 us at the 989 TFLOP/s
// bf16 tensor-core rate, plus 50 M exponentials. So the least time is set by
// the bytes: the design keeps the card reading the table and nothing else.
//
// Design. The TPU kernel streams V as a sequential grid axis and keeps the
// running (max, sum, count) of every row in VMEM across grid steps. Hopper
// blocks run in no order and share nothing, and at N=128 there is a single
// row tile, so the vocab is split across blocks instead:
//   - ce_rank_stream_kernel (E <= 256): block (split, row tile) holds
//     128 rows of x as bf16 mma.sync A fragments in registers (8 warps x 16
//     rows) while a producer warp streams its slice of W, as f32, by 1-D bulk
//     copies (TMA) into a ring of slots in shared memory; the consumers round
//     each slot's rows to bf16 as they build the B fragments and score them
//     with mma.sync.m16n8k16 (bf16 in, f32 accumulation). Each thread keeps
//     (max, sum, count, zsum) for its two rows (exponentials on the
//     special-function unit, in base 2); only the slot that holds a row's
//     label and the vocab's last, partial slot pay for the column checks. At
//     the end the thread merges its rows with the three other lanes of each
//     row and writes one partial per (split, row) to a workspace. The launch
//     plan (ops/vocab.py:ce_plan) gives the splits, the slots and the shared
//     memory, about 128 KB of the table in flight on each SM;
//   - ce_rank_merge_kernel: merges the partials per row, a block per 32 rows:
//     (m, s) pairs by rescaled sums, counts and sums by plain addition.
// Reading W as f32 and rounding on the way to the tensor cores gives the
// numerics of the reference's W.astype(bfloat16) without a cast pass over
// the table on every call. A bf16-stored table (t4r_ce_rank_bf16) streams
// its bf16 rows through the same ring: a slot's bytes halve, the launch
// plan gives twice the slots (the same bytes in flight), and each pair of
// values is already a B fragment's word. At the evaluation shape that
// halves the bound: 49.9 MB, 14.9 us. zsum is accumulated in double: it is a sum of ~V
// terms of both signs.

//
// A table wider than 256 takes t4r_ce_rank_wide: K1's wide kernel
// (ce_wide.cuh: bf16 images, E in 64-value slabs, wgmma) with this kernel's
// epilogue and partials, then the same merge kernel.

#include <type_traits>

#include "ce_wide.cuh"

namespace {

using namespace t4r;

// One chunk's logits of the thread's two rows (acc[j][2h + q]: row h,
// column col(j, q)) into their running (max, sum, count, zsum). CHECKED
// bounds the columns by V and leaves each label's own column out of the
// count. Each reduction runs as two chains per row (q = 0, 1), four in all,
// so the warp has independent work while the SFU and the adds are busy.
template <bool CHECKED, bool SMOOTH, int NT_, class Col>
__device__ __forceinline__ void update_rows(const float (&acc)[NT_][4], Col col_of, int V,
                                            const int (&lab)[2], const float (&llr)[2],
                                            float (&m)[2], float (&s)[2], int (&cnt)[2],
                                            double (&zs)[2]) {
  float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
  int gr[2][2] = {{0, 0}, {0, 0}};
  double z[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
  for (int j = 0; j < NT_; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float l = acc[j][2 * h + q];
        const int col = col_of(j, q);
        const bool valid = !CHECKED || col < V;
        if (valid) {
          mx[h][q] = fmaxf(mx[h][q], l);
          if (SMOOTH) z[h][q] += (double)l;
        }
        gr[h][q] += (valid && l > llr[h] && (!CHECKED || col != lab[h])) ? 1 : 0;
      }
    }
  }
  float mn2[2], mn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cnt[h] += gr[h][0] + gr[h][1];
    if (SMOOTH) zs[h] += z[h][0] + z[h][1];
    mn[h] = fmaxf(m[h], fmaxf(mx[h][0], mx[h][1]));
    mn2[h] = mn[h] * LOG2E;
  }
  float add[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NT_; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float p = ex2(fmaf(acc[j][2 * h + q], LOG2E, -mn2[h]));
        add[h][q] += (!CHECKED || col_of(j, q) < V) ? p : 0.f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a row with no valid column in this chunk keeps m == NEG: s stays 0
    s[h] = s[h] * ex2((m[h] - mn[h]) * LOG2E) + (add[h][0] + add[h][1]);
    m[h] = mn[h];
  }
}

// ------------------------------------------------------- the streamed design
// ce_rank_stream_kernel: block (split, row tile) of SC_WARPS consumer warps
// (16 rows of x each, as bf16 mma.sync A fragments in registers) and one
// producer warp. The producer copies the split's rows of W, as stored (f32
// or bf16) and only those below V, by 1-D bulk copies (TMA without a tensor
// map) into a ring
// of `stages` slots, each guarded by a full and an empty mbarrier. A slot
// holds Slot::ROWS rows as groups of 8 consecutive rows, one bulk copy a
// group; the groups are padded apart so that the 16-byte reads of a quarter
// warp (two rows from neighbouring groups, four pieces each) fall on 32
// distinct banks. The consumers round a slot's rows to bf16 as they build
// the B fragments (one 16-byte read a fragment pair, 8 bytes from a bf16
// table: within each k-step of 16, thread t takes columns 4t .. 4t + 3, in
// x's fragments as in W's),
// score with mma.sync.m16n8k16, let the slot go, and fold the logits into
// the running (max, sum, count, zsum) by update_rows. The table is read
// from device memory once, as stored, with `stages` slots in flight: no
// image pass.
constexpr int SC_WARPS = 8;
constexpr int SC_THREADS = 32 * (SC_WARPS + 1);
constexpr int SC_MIN_STAGES = 4;

// A ring slot for E padded to EK = 16 KS, of table values T (f32 or bf16):
// GROUPS groups of 8 rows of E values, group_words(E) 32-bit words apart
// (the rows, then zeros: at least EK - E values of them, for the last row's
// k-steps past E). A group starts 16 words more than a multiple of 32 after
// the previous one for f32 (a quarter warp's 16-byte reads of two rows from
// neighbouring groups fall on 32 distinct banks), 8 more for bf16 (a half
// warp's 8-byte reads of four groups' rows do). 64 rows, or 32 at the widest
// EK so that 4 f32 slots fit. Lane g of n-tile j takes row
// (g % GROUPS) * 8 + j * (8 / GROUPS) + g / GROUPS of the slot.
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
__host__ __device__ constexpr int stream_smem(int E, int stages) {
  return stages * (Slot<KS, T>::bytes(E) + 16);
}

template <int KS, bool SMOOTH, class T>
__global__ void __launch_bounds__(SC_THREADS)
ce_rank_stream_kernel(const float* __restrict__ x, const T* __restrict__ W,
                      const int* __restrict__ labels, const float* __restrict__ ll, int N,
                      int E, int V, int chunks_per_split, int stages,
                      float* __restrict__ part_m, float* __restrict__ part_s,
                      int* __restrict__ part_cnt, double* __restrict__ part_zs) {
  using L = Slot<KS, T>;
  using namespace t4r::hopper;
  extern __shared__ __align__(16) uint8_t smem[];
  const int gw = L::group_words(E), slot_words = L::GROUPS * gw, rw = L::row_words(E);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * slot_words * 4);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the split's rows of W: [row_begin, row_end), in `slots` slots
  const int row_begin = blockIdx.x * chunks_per_split * BV;
  const int row_end = min(row_begin + chunks_per_split * BV, V);
  const int slots = row_end > row_begin ? (row_end - row_begin + L::ROWS - 1) / L::ROWS : 0;

  // the zeros between groups stay (the copies write 8 E values a group), and
  // rows past V hold zeros or an earlier slot's rows: finite
  for (int i = tid; i < stages * slot_words / 4; i += SC_THREADS) {
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SC_WARPS);
    }
    fence_barrier_init();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, before the copies
  __syncthreads();

  if (warp == SC_WARPS) {  // the producer: lane r copies group r of each slot
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

  const int g = lane >> 2, t = lane & 3;
  const int row_lo = (int)blockIdx.y * BN + warp * 16 + g;
  const int rows[2] = {row_lo, row_lo + 8};
  // x as A fragments: a[ks][h] holds row rows[h], columns 16 ks + 4t, +1;
  // a[ks][2 + h] columns 16 ks + 4t + 2, +3 (zero at and beyond N and E)
  uint32_t a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * ks + 4 * t;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rows[h] < N && col < E) {
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)rows[h] * E + col));
      }
      a[ks][h] = pack_bf16(v.x, v.y);
      a[ks][2 + h] = pack_bf16(v.z, v.w);
    }
  }

  float m[2], s[2], llr[2];
  double zs[2];
  int cnt[2], lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = NEG;
    s[h] = 0.f;
    zs[h] = 0.0;
    cnt[h] = 0;
    lab[h] = rows[h] < N ? labels[rows[h]] : -1;
    llr[h] = rows[h] < N ? ll[rows[h]] : 0.f;
  }

  for (int i = 0; i < slots; ++i) {
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const uint32_t* slot = ring + (size_t)st * slot_words;
    float acc[L::NTS][4];
#pragma unroll
    for (int j = 0; j < L::NTS; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const int r = L::row(j, g);
      // the word of columns 4t, 4t + 1 of the row
      const uint32_t* wr = slot + (r / 8) * gw + (r % 8) * rw + (L::BF16 ? 2 : 4) * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b0, b1;
        L::fragments(wr, ks, b0, b1);
        mma_bf16(acc[j], a[ks], b0, b1);
      }
    }
    release(empty, st);

    // acc[j][2h + q]: row rows[h], column c0 + Slot::row(j, 2t + q). The
    // label's own column is excluded from the count: ll comes from another
    // sum order and may differ from its logit in the last ulp. Only a slot
    // that holds one of the thread's labels, and the vocab's last, partial
    // slot, take the checked path.
    const int c0 = row_begin + i * L::ROWS;
    const auto col_of = [=](int j, int q) { return c0 + L::row(j, 2 * t + q); };
    const bool whole = c0 + L::ROWS <= V;
    const bool has_label = (unsigned)(lab[0] - c0) < (unsigned)L::ROWS ||
                           (unsigned)(lab[1] - c0) < (unsigned)L::ROWS;
    if (whole && !has_label) {
      update_rows<false, SMOOTH, L::NTS>(acc, col_of, V, lab, llr, m, s, cnt, zs);
    } else {
      update_rows<true, SMOOTH, L::NTS>(acc, col_of, V, lab, llr, m, s, cnt, zs);
    }
  }
  // merge the 4 lanes (t) that share each row; one partial per (split, row)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[h], off);
      const int c2 = __shfl_xor_sync(0xffffffffu, cnt[h], off);
      const float mn = fmaxf(m[h], m2);
      s[h] = s[h] * ex2((m[h] - mn) * LOG2E) + s2 * ex2((m2 - mn) * LOG2E);
      m[h] = mn;
      cnt[h] += c2;
      if (SMOOTH) zs[h] += __shfl_xor_sync(0xffffffffu, zs[h], off);
    }
    if (t == 0 && rows[h] < N) {
      const size_t idx = (size_t)blockIdx.x * N + rows[h];
      part_m[idx] = m[h];
      part_s[idx] = s[h];
      part_cnt[idx] = cnt[h];
      if (SMOOTH) part_zs[idx] = zs[h];
    }
  }
}

// Merges the partials of every row: a block per 32 rows, lane = row (a
// warp's loads are one 128-byte line each), warp w folding splits w, w + 32,
// ... into a running (m, s) pair, a count and a sum; then warp 0 folds the
// 32 warps' results of its row in warp order (the same bits on every call).
// One thread per row looping over some 250 splits twice, each load waited
// on in turn, took about as long as the partial kernel itself (PERF.md).
constexpr int MERGE_WARPS = 32;

__device__ __forceinline__ void merge_pair(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(32 * MERGE_WARPS)
ce_rank_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
                     const int* __restrict__ part_cnt, const double* __restrict__ part_zs,
                     int splits, int N, float* __restrict__ lse, int* __restrict__ rank,
                     float* __restrict__ zsum) {
  __shared__ float sm[MERGE_WARPS][32], ss[MERGE_WARPS][32];
  __shared__ int sc[MERGE_WARPS][32];
  __shared__ double sz[MERGE_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  float m = NEG, s = 0.f;
  int cnt = 0;
  double zs = 0.0;
  if (n < N) {
#pragma unroll 4
    for (int k = warp; k < splits; k += MERGE_WARPS) {
      const size_t idx = (size_t)k * N + n;
      merge_pair(m, s, part_m[idx], part_s[idx]);
      cnt += part_cnt[idx];
      if (zsum != nullptr) zs += part_zs[idx];
    }
  }
  sm[warp][lane] = m;
  ss[warp][lane] = s;
  sc[warp][lane] = cnt;
  sz[warp][lane] = zs;
  __syncthreads();
  if (warp != 0 || n >= N) return;
  for (int w = 1; w < MERGE_WARPS; ++w) {
    merge_pair(m, s, sm[w][lane], ss[w][lane]);
    cnt += sc[w][lane];
    zs += sz[w][lane];
  }
  // no valid column at all (V == 0): the reference's masked logits give -1e30
  lse[n] = s > 0.f ? m + logf(s) : NEG;
  rank[n] = cnt;
  if (zsum != nullptr) zsum[n] = (float)zs;
}

cudaError_t launch_merge(cudaStream_t st, const float* part_m, const float* part_s,
                         const int* part_cnt, const double* part_zs, int splits, int N,
                         float* lse, int* rank, float* zsum) {
  ce_rank_merge_kernel<<<(N + 31) / 32, 32 * MERGE_WARPS, 0, st>>>(part_m, part_s, part_cnt,
                                                                  part_zs, splits, N, lse, rank,
                                                                  zsum);
  return cudaGetLastError();
}

// The streamed kernel with `stages` ring slots and `smem` bytes of shared
// memory, which must be what the launch plan (ops/vocab.py:ce_plan) gives:
// at least SC_MIN_STAGES slots and stream_smem(E, stages) bytes within the
// card's limit.
template <int KS, bool SMOOTH, class T>
cudaError_t launch_partial(dim3 grid, cudaStream_t st, const float* x, const T* W,
                           const int* labels, const float* ll, int N, int E, int V,
                           int chunks_per_split, int stages, int smem, float* part_m,
                           float* part_s, int* part_cnt, double* part_zs) {
  if (stages < SC_MIN_STAGES || smem != stream_smem<KS, T>(E, stages) ||
      smem > hopper::MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  auto kernel = ce_rank_stream_kernel<KS, SMOOTH, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, SC_THREADS, smem, st>>>(x, W, labels, ll, N, E, V, chunks_per_split, stages,
                                         part_m, part_s, part_cnt, part_zs);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

int t4r_ce_rank_block_rows() { return t4r::BN; }
int t4r_ce_rank_chunk_cols() { return t4r::BV; }

}  // extern "C"

namespace {

template <class T>
int ce_rank_entry(const float* x, const T* W, const int* labels, const float* ll, int N, int E,
                  int V, int splits, int chunks_per_split, int stages, int smem, float* part_m,
                  float* part_s, int* part_cnt, double* part_zs, float* lse, int* rank,
                  float* zsum, int smooth, void* stream) {
  if (E < 4 || E > 256 || E % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, (N + t4r::BN - 1) / t4r::BN);
  cudaError_t err = with_ks(E, [&](auto ks) {
    constexpr int KS = decltype(ks)::value;
    return smooth ? launch_partial<KS, true, T>(grid, st, x, W, labels, ll, N, E, V,
                                                chunks_per_split, stages, smem, part_m, part_s,
                                                part_cnt, part_zs)
                  : launch_partial<KS, false, T>(grid, st, x, W, labels, ll, N, E, V,
                                                 chunks_per_split, stages, smem, part_m, part_s,
                                                 part_cnt, part_zs);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(st, part_m, part_s, part_cnt, part_zs, splits, N, lse, rank,
                           smooth ? zsum : nullptr);
}

template <class T>
int smem_of(int E, int stages) {
  int bytes = 0;
  with_ks(E, [&](auto ks) {
    bytes = stream_smem<decltype(ks)::value, T>(E, stages);
    return cudaSuccess;
  });
  return bytes;
}

}  // namespace

extern "C" {

// Launches the partial and the merge kernel on `stream`, with the splits,
// ring slots (`stages`) and shared memory of the launch plan. The caller
// checks shapes (E a multiple of 4, at most 256: wider tables take the wide
// entry below), dtypes, contiguity and alignment, and allocates every
// buffer: part_* are (splits, N); part_zs and zsum may be unused when
// smooth == 0. Returns the first CUDA error (0 when both launches were
// accepted).
int t4r_ce_rank(const float* x, const float* W, const int* labels, const float* ll,
                int N, int E, int V, int splits, int chunks_per_split, int stages, int smem,
                float* part_m, float* part_s, int* part_cnt, double* part_zs,
                float* lse, int* rank, float* zsum, int smooth, void* stream) {
  return ce_rank_entry(x, W, labels, ll, N, E, V, splits, chunks_per_split, stages, smem,
                       part_m, part_s, part_cnt, part_zs, lse, rank, zsum, smooth, stream);
}

// The same on a bf16-stored table W, with the ring of t4r_ce_rank_smem_bf16.
int t4r_ce_rank_bf16(const float* x, const void* W, const int* labels, const float* ll,
                     int N, int E, int V, int splits, int chunks_per_split, int stages, int smem,
                     float* part_m, float* part_s, int* part_cnt, double* part_zs,
                     float* lse, int* rank, float* zsum, int smooth, void* stream) {
  return ce_rank_entry(x, static_cast<const __nv_bfloat16*>(W), labels, ll, N, E, V, splits,
                       chunks_per_split, stages, smem, part_m, part_s, part_cnt, part_zs, lse,
                       rank, zsum, smooth, stream);
}

// The shared memory of the streamed kernel with `stages` slots at width E
// (what ops/vocab.py:ce_plan computes for it), for an f32 or a bf16 table.
int t4r_ce_rank_smem(int E, int stages) { return smem_of<float>(E, stages); }
int t4r_ce_rank_smem_bf16(int E, int stages) { return smem_of<__nv_bfloat16>(E, stages); }

// The same on the images of x and of W's first V rows (t4r_image, ek a
// multiple of 64 above 256, from the launch plan with resident, row_tiles,
// splits and chunks_per_split): the wide kernel on grid (row_tiles, splits),
// then the merge.
int t4r_ce_rank_wide(const void* ximg, const void* wimg, const int* labels, const float* ll,
                     int N, int V, int ek, int resident, int row_tiles, int splits,
                     int chunks_per_split, float* part_m, float* part_s, int* part_cnt,
                     double* part_zs, float* lse, int* rank, float* zsum, int smooth,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(ximg);
  const uint8_t* wi = static_cast<const uint8_t*>(wimg);
  dim3 grid(row_tiles, splits);
  cudaError_t err =
      smooth ? t4r::wide::launch<t4r::wide::CE_RANK, true>(grid, st, xi, wi, labels, ll, N, V, ek,
                                                           resident, chunks_per_split, part_m,
                                                           part_s, nullptr, part_cnt, part_zs)
             : t4r::wide::launch<t4r::wide::CE_RANK, false>(grid, st, xi, wi, labels, ll, N, V,
                                                            ek, resident, chunks_per_split,
                                                            part_m, part_s, nullptr, part_cnt,
                                                            part_zs);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(st, part_m, part_s, part_cnt, part_zs, splits, N, lse, rank,
                           smooth ? zsum : nullptr);
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
