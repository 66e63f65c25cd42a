// Count of the logits above a given threshold, per row, in one pass over the
// item vocabulary (kernel K4 of the port).
//
// For every row n of x (N, E) against the item table W (Vp, E), over the
// columns c < V (the caller's bound: the true vocab, or a vocab-parallel
// shard's share of it; rows V..Vp-1 are padding):
//   cnt[n] = #{c < V : c != label[n], bf16(x[n]) . bf16(W[c]) > ll[n]}   (int32)
// with f32 accumulation of the products. ll[n] is given: the label's logit,
// which on a vocab-parallel shard may belong to another shard's column (the
// row then carries label -1 and no column is left out). V = 0 gives 0.
//
// Replaces: transformers4rec_tpu/ops/vocab.py:_rank_kernel (launched by
// rank_counts through pl.pallas_call, vocab.py:689). The TPU kernel leaves
// no column out: it relies on ll comparing bit-equal to its own product at
// the label's column. Tensor-core products promise no such thing, so the
// label's column is excluded explicitly, which gives the same count whenever
// ll is the label's own logit.
//
// Bound on an H100 at the evaluation shape (N=128, E=64, V=390,001, W f32):
// the table read is 390,001 x 64 x 4 B = 99.8 MB, 29.8 us at 3.35 TB/s; the
// product is 2 x 128 x 64 x 390,001 = 6.39 GFLOP, 6.5 us at the 989 TFLOP/s
// bf16 tensor-core rate. So the least time is set by the bytes: the design
// keeps the card reading the table and nothing else.
//
// Design. The layout of ce_rank.cu (K3) without the softmax: the TPU kernel
// streams V as a sequential grid axis with the running count in VMEM; here
// the vocab is split across blocks.
//   - rank_partial_kernel: block (split, row tile) holds 128 rows of x as
//     bf16 mma.sync A fragments in registers and loops over its slice of
//     64-column chunks of W: f32 from device memory, rounded to bf16 into
//     shared memory (a bf16-stored table's values are stored as they come,
//     half the bytes: 49.9 MB, 14.9 us at the evaluation shape), scored
//     with mma.sync.m16n8k16, the next chunk's loads in flight meanwhile.
//     Each thread counts for its two rows; only a chunk that holds one of
//     the thread's labels, and the vocab's last, partial chunk, pay for the
//     column checks. One int32 partial per (split, row);
//   - rank_merge_kernel adds the partials of every row, in order.
// Integer sums: the result does not depend on the order, and is the same on
// every call.
//
// A table wider than 256 takes t4r_rank_wide: K1's wide kernel
// (ce_wide.cuh: bf16 images, E in 64-value slabs, wgmma) with this kernel's
// count, then the same merge kernel.

#include "ce_wide.cuh"

namespace {

using namespace t4r;

// One chunk's logits of the thread's two rows (acc[j][2h + q]: row h,
// column col0 + 8j + q) into their counts. CHECKED bounds the columns by V
// and leaves each label's own column out.
template <bool CHECKED>
__device__ __forceinline__ void count_rows(const float (&acc)[NT][4], int col0, int V,
                                           const int (&lab)[2], const float (&llr)[2],
                                           int (&cnt)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = col0 + 8 * j + q;
        const bool counted = !CHECKED || (col < V && col != lab[h]);
        cnt[h] += (counted && acc[j][2 * h + q] > llr[h]) ? 1 : 0;
      }
    }
  }
}

// Four consecutive values of a table row, as they are read (f32: a float4,
// bf16: two packed pairs) and as they are stored into shared memory (two
// bf16 pairs, f32 rounded to nearest even).
template <class T>
struct Four;
template <>
struct Four<float> {
  using Reg = float4;
  __device__ static Reg zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static Reg load(const float* W, size_t at) {
    return __ldg(reinterpret_cast<const float4*>(W + at));
  }
  __device__ static uint2 bf16(const Reg& v) {
    return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
};
template <>
struct Four<__nv_bfloat16> {
  using Reg = uint2;
  __device__ static Reg zero() { return make_uint2(0u, 0u); }
  __device__ static Reg load(const __nv_bfloat16* W, size_t at) {
    return __ldg(reinterpret_cast<const uint2*>(W + at));
  }
  __device__ static uint2 bf16(const Reg& v) { return v; }
};

// KS: k-steps of 16, E rounded up to 16 * KS with zeros. T: the table's
// values (f32, or bf16 for a bf16-stored table).
template <int KS, class T>
__global__ void __launch_bounds__(THREADS)
rank_partial_kernel(const float* __restrict__ x, const T* __restrict__ W,
                    const int* __restrict__ labels, const float* __restrict__ ll, int N,
                    int E, int V, int chunks_per_split, int* __restrict__ part_cnt) {
  constexpr int EK = 16 * KS;
  constexpr int WS = EK + 8;  // bf16 per shared row: the B-fragment loads are conflict-free
  constexpr int LOADS = BV * EK / 4 / THREADS;  // most 4-value loads of W a thread makes
  using F = Four<T>;
  __shared__ __align__(16) __nv_bfloat16 ws[BV * WS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int e4n = E / 4;
  const int nchunks = (V + BV - 1) / BV;
  const int c_begin = blockIdx.x * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, nchunks);

  // columns E..EK-1 stay zero: the loads below never write them
  for (int i = tid; i < BV * WS; i += THREADS) ws[i] = __float2bfloat16(0.f);

  const int row_lo = (int)blockIdx.y * BN + warp * 16 + g;
  const int rows[2] = {row_lo, row_lo + 8};
  uint32_t a[KS][4];
  load_x_fragments<KS>(x, N, E, row_lo, t, a);

  float llr[2];
  int cnt[2], lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cnt[h] = 0;
    lab[h] = rows[h] < N ? labels[rows[h]] : -1;
    llr[h] = rows[h] < N ? ll[rows[h]] : 0.f;
  }

  // W chunk c, row-major, into registers: consecutive threads read
  // consecutive 4-value pieces of a row
  typename F::Reg pre[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int idx = tid + i * THREADS, r = idx / e4n, q = idx - r * e4n;
    const int col = c_begin * BV + r;
    pre[i] = (r < BV && col < V && c_begin < c_end) ? F::load(W, (size_t)col * E + 4 * q)
                                                    : F::zero();
  }

  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  for (int c = c_begin; c < c_end; ++c) {
    __syncthreads();  // the previous chunk is consumed (and the zero fill is done)
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int idx = tid + i * THREADS, r = idx / e4n, q = idx - r * e4n;
      if (r < BV) *reinterpret_cast<uint2*>(ws + r * WS + 4 * q) = F::bf16(pre[i]);
    }
    __syncthreads();
    if (c + 1 < c_end) {  // the next chunk's loads fly while this one is scored
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int idx = tid + i * THREADS, r = idx / e4n, q = idx - r * e4n;
        const int col = (c + 1) * BV + r;
        pre[i] = (r < BV && col < V) ? F::load(W, (size_t)col * E + 4 * q) : F::zero();
      }
    }

    float acc[NT][4];
    score_chunk<KS, WS>(a, ws32, g, t, acc);

    const int col0 = c * BV + 2 * t;
    const bool full = (c + 1) * BV <= V;
    const bool has_label = (unsigned)(lab[0] - c * BV) < (unsigned)BV ||
                           (unsigned)(lab[1] - c * BV) < (unsigned)BV;
    if (full && !has_label) {
      count_rows<false>(acc, col0, V, lab, llr, cnt);
    } else {
      count_rows<true>(acc, col0, V, lab, llr, cnt);
    }
  }

  // add up the 4 lanes (t) that share each row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], off);
    if (t == 0 && rows[h] < N) part_cnt[(size_t)blockIdx.x * N + rows[h]] = cnt[h];
  }
}

__global__ void rank_merge_kernel(const int* __restrict__ part_cnt, int splits, int N,
                                  int* __restrict__ cnt) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int c = 0;
  for (int k = 0; k < splits; ++k) c += part_cnt[(size_t)k * N + n];
  cnt[n] = c;
}

template <int KS, class T>
cudaError_t launch_partial(dim3 grid, cudaStream_t st, const float* x, const T* W,
                           const int* labels, const float* ll, int N, int E, int V,
                           int chunks_per_split, int* part_cnt) {
  rank_partial_kernel<KS, T><<<grid, THREADS, 0, st>>>(x, W, labels, ll, N, E, V,
                                                       chunks_per_split, part_cnt);
  return cudaGetLastError();
}

template <class T>
int rank_entry(const float* x, const T* W, const int* labels, const float* ll, int N, int E,
               int V, int splits, int chunks_per_split, int* part_cnt, int* cnt, void* stream) {
  if (E < 4 || E > 256 || E % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, (N + BN - 1) / BN);
  cudaError_t err;
  // E is rounded up to 16, 32, 64, 128 or 256 (zero padded)
#define T4R_RANK_KS(KS_) \
  err = launch_partial<KS_, T>(grid, st, x, W, labels, ll, N, E, V, chunks_per_split, part_cnt)
  if (E <= 16) T4R_RANK_KS(1);
  else if (E <= 32) T4R_RANK_KS(2);
  else if (E <= 64) T4R_RANK_KS(4);
  else if (E <= 128) T4R_RANK_KS(8);
  else T4R_RANK_KS(16);
#undef T4R_RANK_KS
  if (err != cudaSuccess) return (int)err;
  const int merge_threads = 128;
  rank_merge_kernel<<<(N + merge_threads - 1) / merge_threads, merge_threads, 0, st>>>(
      part_cnt, splits, N, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int t4r_rank_block_rows() { return t4r::BN; }
int t4r_rank_chunk_cols() { return t4r::BV; }

// Launches the partial and the merge kernel on `stream`. The caller checks
// shapes (E a multiple of 4, at most 256: wider tables take the wide entry
// below), dtypes, contiguity and
// alignment, and allocates every buffer: part_cnt is (splits, N), cnt (N,).
// V may be 0 (splits = 1): every count is then 0. Returns the first CUDA
// error (0 when both launches were accepted).
int t4r_rank(const float* x, const float* W, const int* labels, const float* ll, int N,
             int E, int V, int splits, int chunks_per_split, int* part_cnt, int* cnt,
             void* stream) {
  return rank_entry(x, W, labels, ll, N, E, V, splits, chunks_per_split, part_cnt, cnt, stream);
}

// The same on a bf16-stored table W.
int t4r_rank_bf16(const float* x, const void* W, const int* labels, const float* ll, int N,
                  int E, int V, int splits, int chunks_per_split, int* part_cnt, int* cnt,
                  void* stream) {
  return rank_entry(x, static_cast<const __nv_bfloat16*>(W), labels, ll, N, E, V, splits,
                    chunks_per_split, part_cnt, cnt, stream);
}

// The same on the images of x and of W's first V rows (t4r_image, ek a
// multiple of 64 above 256, from the launch plan with resident, row_tiles,
// splits and chunks_per_split): the wide kernel on grid (row_tiles, splits),
// then the merge.
int t4r_rank_wide(const void* ximg, const void* wimg, const int* labels, const float* ll, int N,
                  int V, int ek, int resident, int row_tiles, int splits, int chunks_per_split,
                  int* part_cnt, int* cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = t4r::wide::launch<t4r::wide::RANK, false>(
      dim3(row_tiles, splits), st, static_cast<const uint8_t*>(ximg),
      static_cast<const uint8_t*>(wimg), labels, ll, N, V, ek, resident, chunks_per_split,
      nullptr, nullptr, nullptr, part_cnt, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int merge_threads = 128;
  rank_merge_kernel<<<(N + merge_threads - 1) / merge_threads, merge_threads, 0, st>>>(
      part_cnt, splits, N, cnt);
  return (int)cudaGetLastError();
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
