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
//   - ce_rank_partial_kernel: block (split, row tile) holds 128 rows of x as
//     bf16 mma.sync A fragments in registers (8 warps x 16 rows) and loops
//     over its own slice of 64-column chunks of W. Each chunk is read from
//     device memory as f32 (the table's stored type), rounded to bf16 into
//     shared memory, and scored with mma.sync.m16n8k16 (bf16 in, f32
//     accumulation); the next chunk's loads are issued into registers before
//     the current chunk is scored, so the table stream does not stall on the
//     products. Each thread keeps (max, sum, count, zsum) for its two rows
//     (exponentials on the special-function unit, in base 2); only the
//     chunk that holds a row's label and the vocab's last, partial chunk
//     pay for the column checks. At the end the thread merges its rows with
//     the three other lanes of each row and writes one partial per
//     (split, row) to a workspace;
//   - ce_rank_merge_kernel: merges the partials per row: (m, s) pairs by
//     rescaled sums, counts and sums by plain addition.
// Reading W as f32 and rounding on load gives the numerics of the
// reference's W.astype(bfloat16) without a cast pass over the table on every
// call. zsum is accumulated in double: it is a sum of ~V terms of both signs.
// TMA and wgmma are later work.
//
// A table wider than 256 takes t4r_ce_rank_wide: K1's wide kernel
// (ce_wide.cuh: bf16 images, E in 64-value slabs, wgmma) with this kernel's
// epilogue and partials, then the same merge kernel.

#include "ce_wide.cuh"

namespace {

using namespace t4r;

// One chunk's logits of the thread's two rows (acc[j][2h + q]: row h,
// column col0 + 8j + q) into their running (max, sum, count, zsum). CHECKED
// bounds the columns by V and leaves each label's own column out of the
// count. Each reduction runs as two chains per row (q = 0, 1), four in all,
// so the warp has independent work while the SFU and the adds are busy.
template <bool CHECKED, bool SMOOTH>
__device__ __forceinline__ void update_rows(const float (&acc)[NT][4], int col0, int V,
                                            const int (&lab)[2], const float (&llr)[2],
                                            float (&m)[2], float (&s)[2], int (&cnt)[2],
                                            double (&zs)[2]) {
  float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
  int gr[2][2] = {{0, 0}, {0, 0}};
  double z[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float l = acc[j][2 * h + q];
        const int col = col0 + 8 * j + q;
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
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float p = ex2(fmaf(acc[j][2 * h + q], LOG2E, -mn2[h]));
        add[h][q] += (!CHECKED || col0 + 8 * j + q < V) ? p : 0.f;
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

// KS: k-steps of 16, E rounded up to 16 * KS with zeros.
template <int KS, bool SMOOTH>
__global__ void __launch_bounds__(THREADS)
ce_rank_partial_kernel(const float* __restrict__ x, const float* __restrict__ W,
                       const int* __restrict__ labels, const float* __restrict__ ll,
                       int N, int E, int V, int chunks_per_split,
                       float* __restrict__ part_m, float* __restrict__ part_s,
                       int* __restrict__ part_cnt, double* __restrict__ part_zs) {
  constexpr int EK = 16 * KS;
  constexpr int WS = EK + 8;  // bf16 per shared row: the B-fragment loads are conflict-free
  constexpr int LOADS = BV * EK / 4 / THREADS;  // most float4 loads of W a thread makes
  __shared__ __align__(16) __nv_bfloat16 ws[BV * WS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int e4n = E / 4;
  const int nchunks = (V + BV - 1) / BV;
  const int c_begin = blockIdx.x * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, nchunks);

  // columns E..EK-1 stay zero: the loads below never write them
  for (int i = tid; i < BV * WS; i += THREADS) ws[i] = __float2bfloat16(0.f);

  // this warp's 16 rows of x as A fragments: rows g and g + 8, k pairs 2t
  const int row_lo = (int)blockIdx.y * BN + warp * 16 + g;
  const int rows[2] = {row_lo, row_lo + 8};
  uint32_t a[KS][4];
  load_x_fragments<KS>(x, N, E, row_lo, t, a);

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

  // W chunk c, row-major f32, into registers: consecutive threads read
  // consecutive 16-byte pieces of a row
  float4 pre[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = tid + i * THREADS, r = idx / e4n, q = idx - r * e4n;
    const int col = c_begin * BV + r;
    pre[i] = (r < BV && col < V && c_begin < c_end)
                 ? __ldg(reinterpret_cast<const float4*>(W + (size_t)col * E) + q)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();  // the previous chunk is consumed (and the zero fill is done)
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = tid + i * THREADS, r = idx / e4n, q = idx - r * e4n;
      if (r < BV) {
        uint2 v;
        v.x = pack_bf16(pre[i].x, pre[i].y);
        v.y = pack_bf16(pre[i].z, pre[i].w);
        *reinterpret_cast<uint2*>(ws + r * WS + 4 * q) = v;
      }
    }
    __syncthreads();
    if (c + 1 < c_end) {  // the next chunk's loads fly while this one is scored
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int idx = tid + i * THREADS, r = idx / e4n, q = idx - r * e4n;
        const int col = (c + 1) * BV + r;
        pre[i] = (r < BV && col < V)
                     ? __ldg(reinterpret_cast<const float4*>(W + (size_t)col * E) + q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }

    float acc[NT][4];
    score_chunk<KS, WS>(a, ws32, g, t, acc);

    // the label's own column is excluded from the count: ll comes from
    // another sum order and may differ from its logit in the last ulp. Only
    // a chunk that holds one of the thread's labels, and the vocab's last,
    // partial chunk, take the checked path.
    const int col0 = c * BV + 2 * t;
    const bool full = (c + 1) * BV <= V;
    const bool has_label = (unsigned)(lab[0] - c * BV) < (unsigned)BV ||
                           (unsigned)(lab[1] - c * BV) < (unsigned)BV;
    if (full && !has_label) {
      update_rows<false, SMOOTH>(acc, col0, V, lab, llr, m, s, cnt, zs);
    } else {
      update_rows<true, SMOOTH>(acc, col0, V, lab, llr, m, s, cnt, zs);
    }
  }

  // merge the 4 lanes (t) that share each row
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

__global__ void ce_rank_merge_kernel(const float* __restrict__ part_m,
                                     const float* __restrict__ part_s,
                                     const int* __restrict__ part_cnt,
                                     const double* __restrict__ part_zs, int splits, int N,
                                     float* __restrict__ lse, int* __restrict__ rank,
                                     float* __restrict__ zsum) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = NEG;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, part_m[(size_t)k * N + n]);
  float s = 0.f;
  int cnt = 0;
  double zs = 0.0;
  for (int k = 0; k < splits; ++k) {
    const size_t idx = (size_t)k * N + n;
    s += part_s[idx] * expf(part_m[idx] - m);
    cnt += part_cnt[idx];
    if (zsum != nullptr) zs += part_zs[idx];
  }
  // no valid column at all (V == 0): the reference's masked logits give -1e30
  lse[n] = s > 0.f ? m + logf(s) : NEG;
  rank[n] = cnt;
  if (zsum != nullptr) zsum[n] = (float)zs;
}

template <int KS, bool SMOOTH>
cudaError_t launch_partial(dim3 grid, cudaStream_t st, const float* x, const float* W,
                           const int* labels, const float* ll, int N, int E, int V,
                           int chunks_per_split, float* part_m, float* part_s, int* part_cnt,
                           double* part_zs) {
  ce_rank_partial_kernel<KS, SMOOTH><<<grid, THREADS, 0, st>>>(
      x, W, labels, ll, N, E, V, chunks_per_split, part_m, part_s, part_cnt, part_zs);
  return cudaGetLastError();
}

template <bool SMOOTH>
cudaError_t launch_partial_e(dim3 grid, cudaStream_t st, const float* x, const float* W,
                             const int* labels, const float* ll, int N, int E, int V,
                             int chunks_per_split, float* part_m, float* part_s, int* part_cnt,
                             double* part_zs) {
  // E is rounded up to 16, 32, 64, 128 or 256 (zero padded)
#define T4R_CE_RANK_KS(KS_)                                                                  \
  return launch_partial<KS_, SMOOTH>(grid, st, x, W, labels, ll, N, E, V, chunks_per_split, \
                                     part_m, part_s, part_cnt, part_zs)
  if (E <= 16) T4R_CE_RANK_KS(1);
  if (E <= 32) T4R_CE_RANK_KS(2);
  if (E <= 64) T4R_CE_RANK_KS(4);
  if (E <= 128) T4R_CE_RANK_KS(8);
  T4R_CE_RANK_KS(16);
#undef T4R_CE_RANK_KS
}

}  // namespace

extern "C" {

int t4r_ce_rank_block_rows() { return t4r::BN; }
int t4r_ce_rank_chunk_cols() { return t4r::BV; }

// Launches the partial and the merge kernel on `stream`. The caller checks
// shapes (E a multiple of 4, at most 256: wider tables take the wide
// entry below), dtypes, contiguity and
// alignment, and allocates every buffer: part_* are (splits, N); part_zs
// and zsum may be unused when smooth == 0. Returns the first CUDA error (0
// when both launches were accepted).
int t4r_ce_rank(const float* x, const float* W, const int* labels, const float* ll,
                int N, int E, int V, int splits, int chunks_per_split,
                float* part_m, float* part_s, int* part_cnt, double* part_zs,
                float* lse, int* rank, float* zsum, int smooth, void* stream) {
  if (E < 4 || E > 256 || E % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, (N + t4r::BN - 1) / t4r::BN);
  cudaError_t err =
      smooth ? launch_partial_e<true>(grid, st, x, W, labels, ll, N, E, V, chunks_per_split,
                                      part_m, part_s, part_cnt, part_zs)
             : launch_partial_e<false>(grid, st, x, W, labels, ll, N, E, V, chunks_per_split,
                                       part_m, part_s, part_cnt, part_zs);
  if (err != cudaSuccess) return (int)err;
  const int merge_threads = 128;
  ce_rank_merge_kernel<<<(N + merge_threads - 1) / merge_threads, merge_threads, 0, st>>>(
      part_m, part_s, part_cnt, part_zs, splits, N, lse, rank, smooth ? zsum : nullptr);
  return (int)cudaGetLastError();
}

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
  const int merge_threads = 128;
  ce_rank_merge_kernel<<<(N + merge_threads - 1) / merge_threads, merge_threads, 0, st>>>(
      part_m, part_s, part_cnt, part_zs, splits, N, lse, rank, smooth ? zsum : nullptr);
  return (int)cudaGetLastError();
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
