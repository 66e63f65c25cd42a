// Forward pass of the fused softmax cross-entropy over the item vocabulary
// (kernel K1 of the port).
//
// For every row n of x (N, E) against the item table W (Vp, E), over the
// columns c < V (the true vocab; rows V..Vp-1 are padding):
//   lse[n]  = logsumexp_c  bf16(x[n]) . bf16(W[c])          (f32 accumulation)
//   ll[n]   = the logit at c == label[n]; 0 when the label is outside [0, V)
//   zsum[n] = sum_c logit[n, c]                              (label smoothing only)
// The (N, V) logits never reach device memory.
//
// Replaces: transformers4rec_tpu/ops/vocab.py:_ce_fwd_kernel_vmajor and
// _ce_fwd_kernel (launched through pl.pallas_call at vocab.py:176 and :237).
// The two TPU bodies differ only in the order of their sequential grid (which
// operand stays in VMEM); one CUDA kernel covers both.
//
// Bound on an H100 at the training shape (N=915, E=64, V=390,001, W f32): the
// table read is 99.8 MB, 29.8 us at 3.35 TB/s; the product is 2 x 915 x 64 x
// 390,001 = 45.7 GFLOP, 46 us at the 989 TFLOP/s bf16 tensor-core rate; the
// softmax takes 915 x 390,001 = 357 M exponentials, 85 us at the
// special-function rate (16 a clock on each of 132 SMs at 1.98 GHz). So the
// least time is set by the operations, the exponentials first.
//
// Design. Like ce_rank.cu (K3): the TPU kernels stream V as a sequential grid
// axis and keep every row's running (max, sum, label logit) in VMEM; here the
// vocab is split across blocks.
//   - ce_fwd_partial_kernel: block (row tile, split) holds 128 rows of x as
//     bf16 mma.sync A fragments in registers and loops over its slice of
//     64-column chunks of W: f32 from device memory, rounded to bf16 into
//     shared memory, scored with mma.sync.m16n8k16, the next chunk's loads in
//     flight meanwhile. Each thread keeps (max, sum, label logit, zsum) for
//     its two rows; only a chunk that holds one of the thread's labels, and
//     the vocab's last, partial chunk, pay for the column checks. The row
//     tile is the fast grid axis, so the blocks that read the same slice of
//     W run together and all but the first find it in the L2 cache.
//   - ce_fwd_merge_kernel: merges the per-split partials of every row.
// With N = 915 there are 8 row tiles, so W is requested 8 times (mostly from
// L2); a loop over the row tiles inside a block, with the chunk kept in
// shared memory, is later work, as are TMA and wgmma.

#include "common.cuh"

namespace {

using namespace t4r;

// One chunk's logits of the thread's two rows (acc[j][2h + q]: row h,
// column col0 + 8j + q) into their running (max, sum, label logit, zsum).
// CHECKED bounds the columns by V and looks for each row's label.
template <bool CHECKED, bool SMOOTH>
__device__ __forceinline__ void update_rows(const float (&acc)[NT][4], int col0, int V,
                                            const int (&lab)[2], float (&m)[2], float (&s)[2],
                                            float (&ll)[2], double (&zs)[2]) {
  float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
  double z[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float l = acc[j][2 * h + q];
        const int col = col0 + 8 * j + q;
        if (!CHECKED || col < V) {
          mx[h][q] = fmaxf(mx[h][q], l);
          if (SMOOTH) z[h][q] += (double)l;
          if (CHECKED && col == lab[h]) ll[h] += l;
        }
      }
    }
  }
  float mn2[2], mn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
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
ce_fwd_partial_kernel(const float* __restrict__ x, const float* __restrict__ W,
                      const int* __restrict__ labels, int N, int E, int V,
                      int chunks_per_split, float* __restrict__ part_m,
                      float* __restrict__ part_s, float* __restrict__ part_ll,
                      double* __restrict__ part_zs) {
  constexpr int EK = 16 * KS;
  constexpr int WS = EK + 8;  // bf16 per shared row: the B-fragment loads are conflict-free
  constexpr int LOADS = BV * EK / 4 / THREADS;  // most float4 loads of W a thread makes
  __shared__ __align__(16) __nv_bfloat16 ws[BV * WS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int e4n = E / 4;
  const int nchunks = (V + BV - 1) / BV;
  const int split = blockIdx.y;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, nchunks);

  // columns E..EK-1 stay zero: the loads below never write them
  for (int i = tid; i < BV * WS; i += THREADS) ws[i] = __float2bfloat16(0.f);

  const int row_lo = (int)blockIdx.x * BN + warp * 16 + g;
  const int rows[2] = {row_lo, row_lo + 8};
  uint32_t a[KS][4];
  load_x_fragments<KS>(x, N, E, row_lo, t, a);

  float m[2], s[2], ll[2];
  double zs[2];
  int lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = NEG;
    s[h] = 0.f;
    ll[h] = 0.f;
    zs[h] = 0.0;
    lab[h] = rows[h] < N ? labels[rows[h]] : -1;
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

    const int col0 = c * BV + 2 * t;
    const bool full = (c + 1) * BV <= V;
    const bool has_label = (unsigned)(lab[0] - c * BV) < (unsigned)BV ||
                           (unsigned)(lab[1] - c * BV) < (unsigned)BV;
    if (full && !has_label) {
      update_rows<false, SMOOTH>(acc, col0, V, lab, m, s, ll, zs);
    } else {
      update_rows<true, SMOOTH>(acc, col0, V, lab, m, s, ll, zs);
    }
  }

  // merge the 4 lanes (t) that share each row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[h], off);
      const float mn = fmaxf(m[h], m2);
      s[h] = s[h] * ex2((m[h] - mn) * LOG2E) + s2 * ex2((m2 - mn) * LOG2E);
      m[h] = mn;
      ll[h] += __shfl_xor_sync(0xffffffffu, ll[h], off);
      if (SMOOTH) zs[h] += __shfl_xor_sync(0xffffffffu, zs[h], off);
    }
    if (t == 0 && rows[h] < N) {
      const size_t idx = (size_t)split * N + rows[h];
      part_m[idx] = m[h];
      part_s[idx] = s[h];
      part_ll[idx] = ll[h];
      if (SMOOTH) part_zs[idx] = zs[h];
    }
  }
}

__global__ void ce_fwd_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_s,
                                    const float* __restrict__ part_ll,
                                    const double* __restrict__ part_zs, int splits, int N,
                                    float* __restrict__ lse, float* __restrict__ ll,
                                    float* __restrict__ zsum) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = NEG;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, part_m[(size_t)k * N + n]);
  float s = 0.f, l = 0.f;
  double zs = 0.0;
  for (int k = 0; k < splits; ++k) {
    const size_t idx = (size_t)k * N + n;
    s += part_s[idx] * expf(part_m[idx] - m);
    l += part_ll[idx];  // one split holds the label's column, the others 0
    if (zsum != nullptr) zs += part_zs[idx];
  }
  lse[n] = m + logf(s);
  ll[n] = l;
  if (zsum != nullptr) zsum[n] = (float)zs;
}

template <int KS, bool SMOOTH>
cudaError_t launch_partial(dim3 grid, cudaStream_t st, const float* x, const float* W,
                           const int* labels, int N, int E, int V, int chunks_per_split,
                           float* part_m, float* part_s, float* part_ll, double* part_zs) {
  ce_fwd_partial_kernel<KS, SMOOTH><<<grid, THREADS, 0, st>>>(
      x, W, labels, N, E, V, chunks_per_split, part_m, part_s, part_ll, part_zs);
  return cudaGetLastError();
}

template <bool SMOOTH>
cudaError_t launch_partial_e(dim3 grid, cudaStream_t st, const float* x, const float* W,
                             const int* labels, int N, int E, int V, int chunks_per_split,
                             float* part_m, float* part_s, float* part_ll, double* part_zs) {
  // E is rounded up to 16, 32, 64, 128 or 256 (zero padded)
#define T4R_CE_FWD_KS(KS_)                                                               \
  return launch_partial<KS_, SMOOTH>(grid, st, x, W, labels, N, E, V, chunks_per_split, \
                                     part_m, part_s, part_ll, part_zs)
  if (E <= 16) T4R_CE_FWD_KS(1);
  if (E <= 32) T4R_CE_FWD_KS(2);
  if (E <= 64) T4R_CE_FWD_KS(4);
  if (E <= 128) T4R_CE_FWD_KS(8);
  T4R_CE_FWD_KS(16);
#undef T4R_CE_FWD_KS
}

}  // namespace

extern "C" {

int t4r_ce_fwd_block_rows() { return t4r::BN; }
int t4r_ce_fwd_chunk_cols() { return t4r::BV; }

// Launches the partial and the merge kernel on `stream`. The caller checks
// shapes (E a multiple of 4, at most 256), dtypes, contiguity and alignment,
// and allocates every buffer: part_* are (splits, N); part_zs and zsum may
// be unused when smooth == 0. Returns the first CUDA error (0 when both
// launches were accepted).
int t4r_ce_fwd(const float* x, const float* W, const int* labels, int N, int E, int V,
               int splits, int chunks_per_split, float* part_m, float* part_s,
               float* part_ll, double* part_zs, float* lse, float* ll, float* zsum,
               int smooth, void* stream) {
  if (E < 4 || E > 256 || E % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + t4r::BN - 1) / t4r::BN, splits);  // row tiles fastest: they share a slice of W
  cudaError_t err =
      smooth ? launch_partial_e<true>(grid, st, x, W, labels, N, E, V, chunks_per_split,
                                      part_m, part_s, part_ll, part_zs)
             : launch_partial_e<false>(grid, st, x, W, labels, N, E, V, chunks_per_split,
                                       part_m, part_s, part_ll, part_zs);
  if (err != cudaSuccess) return (int)err;
  const int merge_threads = 128;
  ce_fwd_merge_kernel<<<(N + merge_threads - 1) / merge_threads, merge_threads, 0, st>>>(
      part_m, part_s, part_ll, part_zs, splits, N, lse, ll, smooth ? zsum : nullptr);
  return (int)cudaGetLastError();
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
