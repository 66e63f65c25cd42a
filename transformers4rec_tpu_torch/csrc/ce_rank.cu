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
// Design. The streamed pass of vocab_stream.cuh (E <= 256), which K4
// (rank.cu) shares, with this kernel's epilogue, and its merge:
//   - stream::kernel<KS, T, CeRank>: a producer warp's bulk copies bring the
//     split's table rows, as stored, into a ring of slots; eight consumer
//     warps score them with mma.sync against x's bf16 fragments, and each
//     thread keeps (max, sum, count, zsum) for its two rows (update_rows:
//     exponentials on the special-function unit, in base 2). At E <= 64 the
//     pass is built for two blocks an SM (its launch bound, as K4's), which
//     the launch plan counts on. At the end each row's four lanes are merged
//     and one partial per (split, row) written;
//   - stream::merge_kernel<true>: a block per 32 rows merges the partials,
//     (m, s) pairs by rescaled sums, counts and sums by plain addition.
// Reading W as f32 and rounding on the way to the tensor cores gives the
// numerics of the reference's W.astype(bfloat16) without a cast pass over
// the table on every call. A bf16-stored table (t4r_ce_rank_bf16) streams
// its bf16 rows through the same ring: a slot's bytes halve, the launch
// plan gives twice the slots (the same bytes in flight), and each pair of
// values is already a B fragment's word. At the evaluation shape that
// halves the bound: 49.9 MB, 14.9 us. zsum is accumulated in double: it is
// a sum of ~V terms of both signs.
//
// A table wider than 256 takes t4r_ce_rank_wide: K1's wide kernel
// (ce_wide.cuh: bf16 images, E in 64-value slabs, wgmma) with this kernel's
// epilogue and partials, then the same merge kernel.

#include "ce_wide.cuh"
#include "vocab_stream.cuh"

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

// K3's epilogue of the streamed pass (vocab_stream.cuh): a thread's
// (max, sum, count, zsum) of its two rows, folded slot by slot by
// update_rows, then merged over the four lanes of each row.
template <bool SMOOTH>
struct CeRank {
  // a warp holds 16 rows of x and scores the whole slot, as stored; all of
  // a slot's products come before its fold
  static constexpr int MT = 1;
  static constexpr bool OVERLAP = false;
  __device__ static void prepare(int) {}
  struct Out {
    float* m;
    float* s;
    int* cnt;
    double* zs;
  };
  float m[2] = {NEG, NEG}, s[2] = {0.f, 0.f};
  int cnt[2] = {0, 0};
  double zs[2] = {0.0, 0.0};

  template <bool CHECKED, int NT_, class Col>
  __device__ __forceinline__ void update(const float (&acc)[1][NT_][4], Col col_of, int V,
                                         const int (&lab)[2], const float (&llr)[2]) {
    update_rows<CHECKED, SMOOTH, NT_>(acc[0], col_of, V, lab, llr, m, s, cnt, zs);
  }

  __device__ __forceinline__ void finish(const int (&rows)[2], int N, int split,
                                         const Out& out) {
    const int t = threadIdx.x & 3;
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
        const size_t idx = (size_t)split * N + rows[h];
        out.m[idx] = m[h];
        out.s[idx] = s[h];
        out.cnt[idx] = cnt[h];
        if (SMOOTH) out.zs[idx] = zs[h];
      }
    }
  }
};

// CeRank as an epilogue of KS k-steps, for stream::resident_blocks_of
template <int KS>
using Plain = CeRank<false>;
template <int KS>
using Smooth = CeRank<true>;

template <class T>
int ce_rank_entry(const float* x, const T* W, const int* labels, const float* ll, int N, int E,
                  int V, int splits, int chunks_per_split, int stages, int smem, float* part_m,
                  float* part_s, int* part_cnt, double* part_zs, float* lse, int* rank,
                  float* zsum, int smooth, void* stream) {
  namespace ts = t4r::stream;
  if (E < 4 || E > 256 || E % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, (N + BN - 1) / BN);
  cudaError_t err = ts::with_ks(E, [&](auto ks) {
    constexpr int KS = decltype(ks)::value;
    return smooth ? ts::launch<KS, T, CeRank<true>>(grid, st, x, W, labels, ll, N, E, V,
                                                    chunks_per_split, stages, smem,
                                                    {part_m, part_s, part_cnt, part_zs})
                  : ts::launch<KS, T, CeRank<false>>(grid, st, x, W, labels, ll, N, E, V,
                                                     chunks_per_split, stages, smem,
                                                     {part_m, part_s, part_cnt, part_zs});
  });
  if (err != cudaSuccess) return (int)err;
  return (int)ts::launch_merge<true>(st, part_m, part_s, part_cnt, part_zs, splits, N, lse, rank,
                                     smooth ? zsum : nullptr);
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

int t4r_ce_rank_block_rows() { return t4r::BN; }
int t4r_ce_rank_chunk_cols() { return t4r::BV; }

// The shared memory of the streamed kernel with `stages` slots at width E
// (what ops/vocab.py:ce_plan computes for it), for an f32 or a bf16 table.
int t4r_ce_rank_smem(int E, int stages) { return t4r::stream::smem_of<float>(E, stages); }
int t4r_ce_rank_smem_bf16(int E, int stages) {
  return t4r::stream::smem_of<__nv_bfloat16>(E, stages);
}

// The blocks an SM is to hold of the streamed kernel at width E (its launch
// bound, stream::min_blocks): the launch plan's blocks_per_sm where the
// shared memory holds them.
int t4r_ce_rank_min_blocks(int E) { return t4r::stream::min_blocks_of(E); }

// How many blocks of the streamed kernel with `smem` bytes of shared memory
// one SM holds at width E, with and without label smoothing (the fewer):
// the launch plan's blocks_per_sm must fit.
int t4r_ce_rank_blocks_per_sm(int E, int smem, int bf16) {
  const int plain = t4r::stream::resident_blocks_of<Plain>(E, smem, bf16 != 0);
  const int smooth = t4r::stream::resident_blocks_of<Smooth>(E, smem, bf16 != 0);
  return plain < smooth ? plain : smooth;
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
  return (int)t4r::stream::launch_merge<true>(st, part_m, part_s, part_cnt, part_zs, splits, N,
                                              lse, rank, smooth ? zsum : nullptr);
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
