// Backward pass of the fused softmax cross-entropy over the item vocabulary
// (kernel K2 of the port).
//
// Given x (N, E), the item table W (Vp, E), labels, the forward's lse (N,)
// and the per-row coefficient coef (N,) (upstream gradient x row weight /
// weight sum), over the columns c < V (rows V..Vp-1 of W are padding):
//   P[n, c] = exp(bf16(x[n]) . bf16(W[c]) - lse[n])         (0 for c >= V)
//   R[n, c] = bf16((P[n, c] - eps_over_v - (1 - eps) [c == label[n]]) * coef[n])
//   dx = R . bf16(W)   (N, E) f32          dW = R^T . bf16(x)   (Vp, E) f32
// with dW rows >= V exactly zero. Neither the logits nor R reach device
// memory. A label outside [0, V) has no one-hot term; a row with coef = 0
// contributes nothing.
//
// Replaces: transformers4rec_tpu/ops/vocab.py:_ce_bwd_fused_kernel_dxsc and
// _ce_bwd_fused_kernel (launched through pl.pallas_call at vocab.py:419 and
// :486). The two TPU bodies differ in where dx is accumulated (a full-N VMEM
// scratch, or per-vocab-tile partials in HBM); one CUDA source covers both.
//
// Bound on an H100 at the training shape (N=915, E=64, V=390,001, W f32): W
// is read (99.8 MB) and dW written (99.8 MB) once, 59.7 us at 3.35 TB/s; the
// three products are 3 x 45.7 = 137 GFLOP, 139 us at the 989 TFLOP/s bf16
// tensor-core rate; recomputing P takes 357 M exponentials, 85 us at the
// special-function rate. So the least time is set by the operations.
//
// Design. dW sums over the rows and dx over the vocab: opposite axes. The TPU
// kernel walks a sequential grid and keeps one of the two sums in VMEM across
// grid steps; a Hopper block has 227 KB and shares nothing with the others.
// A single pass would hold a block's dW slice in shared memory across the row
// tiles (at most ~500 vocab columns, so ~800 blocks) and then needs ~800
// partial copies of dx (180 MB) or float atomics in an order that changes
// from run to run. This first version instead takes two passes that each
// recompute P (one more product and one more set of exponentials than the
// fused pass: 183 GFLOP instead of 137), need no atomics and give the same
// bits on every run:
//   - ce_bwd_dw_kernel: a block owns one 64-row chunk of W (bf16 in shared
//     memory) and loops over the row tiles of x: stage the tile as bf16 in
//     shared memory (plain and transposed), score it, form R in registers,
//     write R transposed to shared memory, and accumulate R^T . x in
//     registers (each warp a 16-column by E/2 piece). dW is written once.
//   - ce_bwd_dx_kernel: block (row tile, split), like the forward kernel:
//     128 rows of x in registers, a loop over the split's chunks of W. The
//     accumulator fragments of the logits are, after the residual, exactly
//     the A fragments of the next product, so R . W needs no re-layout; the
//     chunk of W is also kept transposed in shared memory as that product's
//     B operand. Each block writes one (128, E) partial of dx;
//   - ce_bwd_dx_reduce_kernel sums the partials over the splits, in order.
// Fusing the two passes, wgmma and TMA are later work.

#include "common.cuh"

namespace {

using namespace t4r;

constexpr int XT = BN + 8;  // bf16 per shared row of a transposed (., BN) tile
constexpr int WT = BV + 8;  // bf16 per shared row of a transposed (., BV) chunk

// Logits of the thread's two rows (acc[j][2h + q]: row h, column col0 + 8j +
// q) into the residual R, in place and still f32. lse2 is lse x log2(e).
// CHECKED bounds the columns by V and looks for each row's label.
template <bool CHECKED>
__device__ __forceinline__ void residual(float (&acc)[NT][4], int col0, int V,
                                         const int (&lab)[2], const float (&lse2)[2],
                                         const float (&coef)[2], float eov,
                                         float one_minus_eps) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float p = ex2(fmaf(acc[j][2 * h + q], LOG2E, -lse2[h])) - eov;
        if (CHECKED) {
          const int col = col0 + 8 * j + q;
          if (col >= V) {
            p = 0.f;
          } else if (col == lab[h]) {
            p -= one_minus_eps;
          }
        }
        acc[j][2 * h + q] = p * coef[h];
      }
    }
  }
}

__device__ __forceinline__ void chunk_residual(float (&acc)[NT][4], int c, int t, int V,
                                               const int (&lab)[2], const float (&lse2)[2],
                                               const float (&coef)[2], float eov,
                                               float one_minus_eps) {
  const int col0 = c * BV + 2 * t;
  const bool full = (c + 1) * BV <= V;
  const bool has_label = (unsigned)(lab[0] - c * BV) < (unsigned)BV ||
                         (unsigned)(lab[1] - c * BV) < (unsigned)BV;
  if (full && !has_label) {
    residual<false>(acc, col0, V, lab, lse2, coef, eov, one_minus_eps);
  } else {
    residual<true>(acc, col0, V, lab, lse2, coef, eov, one_minus_eps);
  }
}

// ------------------------------------------------------------------- dW
template <int KS>
constexpr int dw_smem_bytes() {
  return 2 * (BV * (16 * KS + 8) + BN * (16 * KS + 8) + 16 * KS * XT + BV * XT);
}

// KS: k-steps of 16, E rounded up to 16 * KS with zeros. One block per
// 64-row chunk of the (Vp, E) table.
template <int KS>
__global__ void __launch_bounds__(THREADS)
ce_bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ coef, int N, int E, int V, int Vp, float eov,
                 float one_minus_eps, float* __restrict__ dW) {
  constexpr int EK = 16 * KS;
  constexpr int WS = EK + 8;   // bf16 per shared row of a (., EK) tile
  constexpr int ETW = EK / 16;  // e n-tiles of 8 per warp: half of EK / 8
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [BV][WS] chunk of W
  __nv_bfloat16* xs = ws + BV * WS;                            // [BN][WS] tile of x
  __nv_bfloat16* xts = xs + BN * WS;                           // [EK][XT] the tile transposed
  __nv_bfloat16* pt = xts + EK * XT;                           // [BV][XT] R transposed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int e4n = E / 4;
  const int c = blockIdx.x;

  // columns E..EK-1 of ws and xs and rows E..EK-1 of xts stay zero
  for (int i = tid; i < BV * WS + BN * WS + EK * XT; i += THREADS) ws[i] = __float2bfloat16(0.f);
  __syncthreads();
  for (int idx = tid; idx < BV * e4n; idx += THREADS) {
    const int r = idx / e4n, q = idx - r * e4n;
    const int col = c * BV + r;
    const float4 v = col < Vp ? __ldg(reinterpret_cast<const float4*>(W + (size_t)col * E) + q)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    uint2 u;
    u.x = pack_bf16(v.x, v.y);
    u.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(ws + r * WS + 4 * q) = u;
  }

  const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
  const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t* xts32 = reinterpret_cast<const uint32_t*>(xts);
  const uint32_t* pt32 = reinterpret_cast<const uint32_t*>(pt);
  const int mt = warp >> 1;  // this warp's 16 vocab columns of the chunk
  const int nh = warp & 1;   // and its half of the e n-tiles

  float dwacc[ETW][4];
#pragma unroll
  for (int jl = 0; jl < ETW; ++jl) dwacc[jl][0] = dwacc[jl][1] = dwacc[jl][2] = dwacc[jl][3] = 0.f;

  const int row_tiles = (N + BN - 1) / BN;
  for (int rt = 0; rt < row_tiles; ++rt) {
    __syncthreads();  // the previous tile is consumed (and the chunk of W is in place)
    for (int idx = tid; idx < BN * e4n; idx += THREADS) {
      const int r = idx / e4n, q = idx - r * e4n;
      const int row = rt * BN + r;
      const float4 v = row < N ? __ldg(reinterpret_cast<const float4*>(x + (size_t)row * E) + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      uint2 u;
      u.x = pack_bf16(v.x, v.y);
      u.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(xs + r * WS + 4 * q) = u;
      xts[(4 * q + 0) * XT + r] = __float2bfloat16(v.x);
      xts[(4 * q + 1) * XT + r] = __float2bfloat16(v.y);
      xts[(4 * q + 2) * XT + r] = __float2bfloat16(v.z);
      xts[(4 * q + 3) * XT + r] = __float2bfloat16(v.w);
    }
    __syncthreads();

    // this warp's 16 rows as A fragments: rows g and g + 8, k pairs 2t
    uint32_t a[KS][4];
    const int rbase = (warp * 16 + g) * (WS / 2) + t;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[ks][0] = xs32[rbase + ks * 8];
      a[ks][1] = xs32[rbase + 8 * (WS / 2) + ks * 8];
      a[ks][2] = xs32[rbase + ks * 8 + 4];
      a[ks][3] = xs32[rbase + 8 * (WS / 2) + ks * 8 + 4];
    }
    float acc[NT][4];
    score_chunk<KS, WS>(a, ws32, g, t, acc);

    int lab[2];
    float lse2[2], cf[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * BN + warp * 16 + g + 8 * h;
      lab[h] = row < N ? labels[row] : -1;
      lse2[h] = row < N ? lse[row] * LOG2E : 0.f;
      cf[h] = row < N ? coef[row] : 0.f;
    }
    chunk_residual(acc, c, t, V, lab, lse2, cf, eov, one_minus_eps);

    // R, rounded to bf16, transposed: pt[column of the chunk][row of the tile]
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          pt[(8 * j + 2 * t + q) * XT + warp * 16 + g + 8 * h] =
              __float2bfloat16(acc[j][2 * h + q]);
        }
      }
    }
    __syncthreads();

    // dW piece += R^T (16 columns x BN rows) . x (BN rows x ETW n-tiles of e)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      const int abase = (16 * mt + g) * (XT / 2) + kk * 8 + t;
      pa[0] = pt32[abase];
      pa[1] = pt32[abase + 8 * (XT / 2)];
      pa[2] = pt32[abase + 4];
      pa[3] = pt32[abase + 8 * (XT / 2) + 4];
#pragma unroll
      for (int jl = 0; jl < ETW; ++jl) {
        const int bbase = (8 * (nh * ETW + jl) + g) * (XT / 2) + kk * 8 + t;
        mma_bf16(dwacc[jl], pa, xts32[bbase], xts32[bbase + 4]);
      }
    }
  }

  // dwacc[jl][2h + q]: column 16 mt + g + 8h of the chunk, e = 8 (nh ETW + jl) + 2t + q.
  // Columns V..Vp-1 had R = 0 throughout, so they are written as zeros.
#pragma unroll
  for (int jl = 0; jl < ETW; ++jl) {
    const int e = 8 * (nh * ETW + jl) + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c * BV + 16 * mt + g + 8 * h;
      if (col < Vp && e < E) {
        *reinterpret_cast<float2*>(dW + (size_t)col * E + e) =
            make_float2(dwacc[jl][2 * h], dwacc[jl][2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------- dx
template <int KS>
__global__ void __launch_bounds__(THREADS)
ce_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ coef, int N, int E, int V, int chunks_per_split,
                 float eov, float one_minus_eps, float* __restrict__ part_dx) {
  constexpr int EK = 16 * KS;
  constexpr int WS = EK + 8;
  constexpr int ET = EK / 8;  // e n-tiles of 8
  constexpr int LOADS = BV * EK / 4 / THREADS;
  __shared__ __align__(16) __nv_bfloat16 ws[BV * WS];  // [BV][WS] chunk of W
  __shared__ __align__(16) __nv_bfloat16 wt[EK * WT];  // [EK][WT] the chunk transposed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int e4n = E / 4;
  const int nchunks = (V + BV - 1) / BV;
  const int split = blockIdx.y;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, nchunks);

  for (int i = tid; i < BV * WS; i += THREADS) ws[i] = __float2bfloat16(0.f);
  for (int i = tid; i < EK * WT; i += THREADS) wt[i] = __float2bfloat16(0.f);

  const int row_lo = (int)blockIdx.x * BN + warp * 16 + g;
  const int rows[2] = {row_lo, row_lo + 8};
  uint32_t a[KS][4];
  load_x_fragments<KS>(x, N, E, row_lo, t, a);

  int lab[2];
  float lse2[2], cf[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lab[h] = rows[h] < N ? labels[rows[h]] : -1;
    lse2[h] = rows[h] < N ? lse[rows[h]] * LOG2E : 0.f;
    cf[h] = rows[h] < N ? coef[rows[h]] : 0.f;
  }

  float dacc[ET][4];
#pragma unroll
  for (int je = 0; je < ET; ++je) dacc[je][0] = dacc[je][1] = dacc[je][2] = dacc[je][3] = 0.f;

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
  const uint32_t* wt32 = reinterpret_cast<const uint32_t*>(wt);
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
        wt[(4 * q + 0) * WT + r] = __float2bfloat16(pre[i].x);
        wt[(4 * q + 1) * WT + r] = __float2bfloat16(pre[i].y);
        wt[(4 * q + 2) * WT + r] = __float2bfloat16(pre[i].z);
        wt[(4 * q + 3) * WT + r] = __float2bfloat16(pre[i].w);
      }
    }
    __syncthreads();
    if (c + 1 < c_end) {  // the next chunk's loads fly while this one is worked on
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
    chunk_residual(acc, c, t, V, lab, lse2, cf, eov, one_minus_eps);

    // two neighbouring n-tiles of the accumulator are one A fragment of the
    // next product: rows g and g + 8, k (the chunk's column) pairs 2t and 2t + 8
#pragma unroll
    for (int kk = 0; kk < BV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
      pa[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
      pa[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
      pa[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
#pragma unroll
      for (int je = 0; je < ET; ++je) {
        const int bbase = (8 * je + g) * (WT / 2) + kk * 8 + t;  // e = 8 je + g, k pair 2t
        mma_bf16(dacc[je], pa, wt32[bbase], wt32[bbase + 4]);
      }
    }
  }

  // dacc[je][2h + q]: row rows[h], e = 8 je + 2t + q
#pragma unroll
  for (int je = 0; je < ET; ++je) {
    const int e = 8 * je + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] < N && e < E) {
        *reinterpret_cast<float2*>(part_dx + ((size_t)split * N + rows[h]) * E + e) =
            make_float2(dacc[je][2 * h], dacc[je][2 * h + 1]);
      }
    }
  }
}

__global__ void ce_bwd_dx_reduce_kernel(const float* __restrict__ part_dx, int splits,
                                        int count, float* __restrict__ dx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part_dx[(size_t)k * count + i];
  dx[i] = s;
}

template <int KS>
cudaError_t launch_bwd(cudaStream_t st, const float* x, const float* W, const int* labels,
                       const float* lse, const float* coef, int N, int E, int V, int Vp,
                       float eov, float one_minus_eps, int splits, int chunks_per_split,
                       float* part_dx, float* dx, float* dW) {
  cudaError_t err = cudaFuncSetAttribute(ce_bwd_dw_kernel<KS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dw_smem_bytes<KS>());
  if (err != cudaSuccess) return err;
  ce_bwd_dw_kernel<KS><<<(Vp + BV - 1) / BV, THREADS, dw_smem_bytes<KS>(), st>>>(
      x, W, labels, lse, coef, N, E, V, Vp, eov, one_minus_eps, dW);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, splits);  // row tiles fastest: they share a slice of W
  ce_bwd_dx_kernel<KS><<<grid, THREADS, 0, st>>>(x, W, labels, lse, coef, N, E, V,
                                                  chunks_per_split, eov, one_minus_eps, part_dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = N * E, reduce_threads = 256;
  ce_bwd_dx_reduce_kernel<<<(count + reduce_threads - 1) / reduce_threads, reduce_threads, 0,
                            st>>>(part_dx, splits, count, dx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int t4r_ce_bwd_block_rows() { return t4r::BN; }
int t4r_ce_bwd_chunk_cols() { return t4r::BV; }
int t4r_ce_bwd_max_e() { return 128; }

// Launches the dW, the dx and the dx-reduce kernel on `stream`. The caller
// checks shapes (E a multiple of 4, at most 128), dtypes, contiguity and
// alignment, and allocates every buffer: part_dx is (splits, N, E), dx
// (N, E), dW (Vp, E); all are written in full. eps is the label smoothing
// and eps_over_v its share of every valid column. Returns the first CUDA
// error (0 when every launch was accepted).
int t4r_ce_bwd(const float* x, const float* W, const int* labels, const float* lse,
               const float* coef, int N, int E, int V, int Vp, float eps, float eps_over_v,
               int splits, int chunks_per_split, float* part_dx, float* dx, float* dW,
               void* stream) {
  if (E < 4 || E > 128 || E % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float ome = 1.f - eps;
#define T4R_CE_BWD_KS(KS_)                                                                  \
  return (int)launch_bwd<KS_>(st, x, W, labels, lse, coef, N, E, V, Vp, eps_over_v, ome,    \
                              splits, chunks_per_split, part_dx, dx, dW)
  if (E <= 16) T4R_CE_BWD_KS(1);
  if (E <= 32) T4R_CE_BWD_KS(2);
  if (E <= 64) T4R_CE_BWD_KS(4);
  T4R_CE_BWD_KS(8);
#undef T4R_CE_BWD_KS
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
