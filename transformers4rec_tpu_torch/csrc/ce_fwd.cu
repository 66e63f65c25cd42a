// Forward pass of the fused softmax cross-entropy over the item vocabulary
// (kernel K1 of the port).
//
// For every row n of x (N, E) against the item table W (Vp, E), over the
// columns c < V (the true vocab; rows V..Vp-1 are padding):
//   lse[n]  = logsumexp_c  bf16(x[n]) . bf16(W[c])          (f32 accumulation)
//   ll[n]   = the logit at c == label[n]: the masked logit -1e30 for a label on
//             a padding row (V <= label < Vp), 0 for a label outside [0, Vp)
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
// least time is set by the operations, the exponentials first (at N = 8,192:
// 3.19 G exponentials, 0.764 ms, against 0.41 ms of products).
//
// Design (Hopper). The TPU kernels stream V as a sequential grid axis and
// keep every row's running (max, sum, label logit) in VMEM; here the vocab is
// split across blocks and a merge kernel combines the splits.
//   - to_image_kernel (hopper.cuh) writes bf16 images of x and of the used
//     rows of W once per call: every f32 -> bf16 rounding happens there (a
//     bf16-stored table is copied into its image as it is), and
//     a 128-row tile is one contiguous block in the layout of TMA's 128-byte
//     swizzle, which one bulk copy moves as it stands.
//   - ce_fwd_kernel: block (128-row tile of x, vocab split), 384 threads. A
//     producer warp keeps bulk copies of the split's 128-column chunks of W
//     in flight through a ring of STAGES shared-memory slots (mbarriers mark
//     a slot full or free); the x tile is copied once. Two consumer
//     warpgroups own 64 rows each: per chunk, S = x . W_c^T by wgmma (both
//     operands K-major in shared memory, f32 in registers), then the running
//     (max, sum, label logit, zsum) of the thread's two rows in base 2. A
//     warpgroup issues the products of chunk i + 1 before it takes the
//     softmax of chunk i (two accumulators), so its exponentials run beside
//     its own products and the other warpgroup's, and the next chunks'
//     copies fly meanwhile. Only a chunk that holds one of the thread's
//     labels, or the vocab's last, partial chunk, pays for the column
//     checks. Row tiles are the fast grid axis, so the blocks reading a
//     split's chunks run together and find them in the L2 cache.
//   - ce_fwd_merge_kernel merges the per-split partials of every row.
// A table wider than 256 takes the wide kernel of ce_wide.cuh instead (E in
// 64-value slabs, the same partials and merge).

#include "ce_wide.cuh"

namespace {

using namespace t4r;
using namespace t4r::hopper;

// One chunk's logits of the thread's two rows (acc[4j + 2h + q]: row h,
// column col0 + 8j + q) into their running (max, sum, label logit, zsum).
// CHECKED bounds the columns by V and looks for each row's label.
template <bool CHECKED, bool SMOOTH>
__device__ __forceinline__ void update_rows(const float (&acc)[64], int col0, int V,
                                            const int (&lab)[2], float (&m)[2], float (&s)[2],
                                            float (&ll)[2], double (&zs)[2]) {
  float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
  double z[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float l = acc[4 * j + 2 * h + q];
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
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float p = ex2(fmaf(acc[4 * j + 2 * h + q], LOG2E, -mn2[h]));
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

// Issues S = x . W_c^T (64 rows x 128 columns) as one wgmma group: xa is
// the warpgroup's 64 rows of the x tile, wa a chunk of W, both K-major.
template <int KA>
__device__ __forceinline__ void issue_scores(float (&d)[64], uint32_t xa, uint32_t wa) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4 * KA; ++k) wgmma_ss_n128(d, kmajor_desc(xa, k), kmajor_desc(wa, k), k > 0);
  wgmma_commit();
}

// KA: 64-wide slabs of E (E padded with zeros to 64 KA).
template <int KA, bool SMOOTH>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
ce_fwd_kernel(const uint8_t* __restrict__ ximg, const uint8_t* __restrict__ wimg,
              const int* __restrict__ labels, int N, int V, int chunks_per_split,
              float* __restrict__ part_m, float* __restrict__ part_s,
              float* __restrict__ part_ll, double* __restrict__ part_zs) {
  using R = Ring<KA>;
  extern __shared__ uint8_t smem_raw[];
  const R sm(smem_raw);
  const RowSplit b = row_split(V, chunks_per_split);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    produce_row_pass<KA>(sm, ximg, wimg, b);
  } else {
    // ---- consumers: warpgroup wg scores rows 64 wg .. 64 wg + 63 of the tile
    consumer_registers();
    const int t = threadIdx.x & 3;
    int rows[2];
    consumer_rows(b.row_tile, rows);

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

    // Two accumulators: the products of chunk i + 1 run while the softmax of
    // chunk i does; chunk i's logits land in acc[i % 2]. After the split's
    // last chunk the products of that chunk are issued once more (read, never
    // used), so that no wgmma sits on a branch.
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
    const uint32_t xa = smem_addr(sm.tile) + wg * 64 * 128;
    const uint32_t ra = smem_addr(sm.ring);
    const int count = b.count;
    mbar_wait(sm.once, 0);
    if (count > 0) {
      mbar_wait(&sm.full[0], 0);
      issue_scores<KA>(acc[0], xa, ra);
      for (int i0 = 0; i0 < count; i0 += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = i0 + u;
          const int next = min(i + 1, count - 1);
          mbar_wait(&sm.full[next % R::STAGES], (next / R::STAGES) & 1);
          issue_scores<KA>(acc[u ^ 1], xa, ra + (next % R::STAGES) * R::TILE_BYTES);
          wgmma_wait<1>();  // chunk i's logits are in acc[u]
          fence_regs(acc[u]);
          if (i + 1 < count) release(sm.empty, i % R::STAGES);
          if (i < count) {
            const int c = b.begin + i;
            const int col0 = c * TILE + 2 * t;
            if (unchecked_chunk(c, V, lab)) {
              update_rows<false, SMOOTH>(acc[u], col0, V, lab, m, s, ll, zs);
            } else {
              update_rows<true, SMOOTH>(acc[u], col0, V, lab, m, s, ll, zs);
            }
          }
        }
      }
      wgmma_wait<0>();
      release(sm.empty, (count - 1) % R::STAGES);
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
        const size_t idx = (size_t)b.split * N + rows[h];
        part_m[idx] = m[h];
        part_s[idx] = s[h];
        part_ll[idx] = ll[h];
        if (SMOOTH) part_zs[idx] = zs[h];
      }
    }
  }
}

__global__ void ce_fwd_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_s,
                                    const float* __restrict__ part_ll,
                                    const double* __restrict__ part_zs,
                                    const int* __restrict__ labels, int splits, int N,
                                    int V, int Vp, float* __restrict__ lse,
                                    float* __restrict__ ll, float* __restrict__ zsum) {
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
  // no valid column at all (V == 0): the reference's masked logits give -1e30
  lse[n] = s > 0.f ? m + logf(s) : NEG;
  // a label on a padding row picks up that column's masked logit
  const int lab = labels[n];
  ll[n] = (lab >= V && lab < Vp) ? NEG : l;
  if (zsum != nullptr) zsum[n] = (float)zs;
}

template <bool SMOOTH>
cudaError_t launch_partial(int ek, dim3 grid, cudaStream_t st, const uint8_t* ximg,
                           const uint8_t* wimg, const int* labels, int N, int V,
                           int chunks_per_split, float* part_m, float* part_s, float* part_ll,
                           double* part_zs) {
#define T4R_CE_FWD_KA(KA_)                                                                 \
  return launch(ce_fwd_kernel<KA_, SMOOTH>, grid, Ring<KA_>::BYTES, st, ximg, wimg, labels, N, \
                V, chunks_per_split, part_m, part_s, part_ll, part_zs)
  switch (ek) {
    case 64: T4R_CE_FWD_KA(1);
    case 128: T4R_CE_FWD_KA(2);
    case 256: T4R_CE_FWD_KA(4);
    default: return cudaErrorInvalidValue;
  }
#undef T4R_CE_FWD_KA
}

}  // namespace

extern "C" {

// Launches the partial and the merge kernel on `stream`, on the images of x
// and of W's first V rows (t4r_image: ximg row_tiles x 128 rows, wimg a tile
// for each of the vocab's chunks, ek = 64, 128 or 256 columns for the narrow
// kernel, a larger multiple of 64 for the wide one, which keeps x resident
// when `resident`). The caller takes ek, resident, row_tiles, splits and
// chunks_per_split from one launch plan,
// checks shapes, dtypes, contiguity and alignment, and allocates every
// buffer: part_* (splits, N); part_zs and zsum may be unused when smooth ==
// 0. V may be 0 (splits = 1): every lse is then -1e30. Returns the first CUDA
// error (0 when every launch was accepted).
int t4r_ce_fwd(const void* ximg, const void* wimg, const int* labels, int N, int V, int Vp,
               int ek, int resident, int row_tiles, int splits, int chunks_per_split,
               float* part_m, float* part_s, float* part_ll, double* part_zs, float* lse,
               float* ll, float* zsum, int smooth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(ximg);
  const uint8_t* wi = static_cast<const uint8_t*>(wimg);
  dim3 grid(row_tiles, splits);  // row tiles fastest: they share a slice of W
  cudaError_t err;
  if (ek <= 256) {
    if (!resident) return (int)cudaErrorInvalidValue;
    err = smooth ? launch_partial<true>(ek, grid, st, xi, wi, labels, N, V, chunks_per_split,
                                        part_m, part_s, part_ll, part_zs)
                 : launch_partial<false>(ek, grid, st, xi, wi, labels, N, V, chunks_per_split,
                                         part_m, part_s, part_ll, part_zs);
  } else {
    namespace w = t4r::wide;
    err = smooth ? w::launch<w::CE, true>(grid, st, xi, wi, labels, nullptr, N, V, ek, resident,
                                          chunks_per_split, part_m, part_s, part_ll, nullptr,
                                          part_zs)
                 : w::launch<w::CE, false>(grid, st, xi, wi, labels, nullptr, N, V, ek, resident,
                                           chunks_per_split, part_m, part_s, part_ll, nullptr,
                                           part_zs);
  }
  if (err != cudaSuccess) return (int)err;
  const int merge_threads = 128;
  ce_fwd_merge_kernel<<<(N + merge_threads - 1) / merge_threads, merge_threads, 0, st>>>(
      part_m, part_s, part_ll, part_zs, labels, splits, N, V, Vp, lse, ll,
      smooth ? zsum : nullptr);
  return (int)cudaGetLastError();
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
