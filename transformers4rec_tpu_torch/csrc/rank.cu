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
// Bound on an H100 at the evaluation shape (N=128, E=64, V=390,001): the
// table read is 390,001 x 64 x 4 B = 99.8 MB f32, 29.8 us at 3.35 TB/s
// (49.9 MB, 14.9 us, for a bf16-stored table); the product is
// 2 x 128 x 64 x 390,001 = 6.39 GFLOP, 6.5 us at the 989 TFLOP/s bf16
// tensor-core rate. So the least time is set by the bytes.
//
// Design. K4 is K3 (ce_rank.cu) without the softmax, so it runs K3's
// streamed pass (vocab_stream.cuh, E <= 256) with an epilogue of its own,
// then K3's merge for counts:
//   - stream::kernel<KS, T, Count<KS>>: a producer warp's bulk copies bring
//     the split's table rows, as stored (f32, or bf16 at half the bytes),
//     into a ring of slots sized by the launch plan (about 128 KB of the
//     table in flight on each SM in either form); eight consumer warps score
//     them with mma.sync against x's bf16 fragments. Up to E = 128 each warp
//     holds two 16-row tiles of x and scores half of each slot (K3's warps
//     hold one and score the whole slot), so a slot is read from shared
//     memory four times, not eight, and each B fragment feeds two products;
//     at E <= 64 the pass is built for two blocks an SM (a register bound).
//     The epilogue (Count) only compares each logit with its row's ll and
//     adds: no exponential. Only the slot that holds one of the warp's
//     labels and the vocab's last, partial slot pay for the column checks.
//     Each row's lanes and warps are summed in shared memory; one int32
//     partial per (split, row);
//   - stream::merge_kernel<false>: a block per 32 rows adds each row's
//     partials, warps over the splits, in a fixed order.
// A ring the launch plan would not give is refused.
// Integer sums: the result does not depend on the order, and is the same on
// every call.
//
// A table wider than 256 takes t4r_rank_wide: K1's wide kernel
// (ce_wide.cuh: bf16 images, E in 64-value slabs, wgmma) with this kernel's
// count, then the same merge kernel.

#include "ce_wide.cuh"
#include "vocab_stream.cuh"

namespace {

using namespace t4r;

// The 16-row tiles of x a consumer warp of K4's pass holds (Count::MT) at KS
// k-steps: the slot's rows are read from shared memory by WARPS / MT warps,
// not by all WARPS, and each B fragment feeds MT products. The warp's x
// fragments take 4 KS MT registers a thread.
constexpr int rank_mt(int ks) { return ks <= 8 ? 2 : 1; }

// A block's counts of its BN rows, summed over the warps that share them.
__shared__ int block_counts[BN];

// K4's epilogue of the streamed pass: a thread's count of logits above ll
// for each of its 2 MT rows. CHECKED bounds the columns by V and leaves each
// row's label column out. Each row counts in two chains (q = 0, 1), so the
// warp has independent adds. At the end each row's four lanes are summed by
// shuffles and its MT warps in block_counts (integer sums: the same on every
// call, in any order).
template <int KS>
struct Count {
  static constexpr int MT = rank_mt(KS);
  static constexpr bool OVERLAP = true;  // the fold of an n-tile beside the next one's products
  struct Out {
    int* cnt;
  };
  int cnt[2 * MT] = {};

  __device__ static void prepare(int tid) {
    if (MT > 1) {
      for (int i = tid; i < BN; i += t4r::stream::THREADS) block_counts[i] = 0;
    }
  }

  template <bool CHECKED, int NTW, class Col>
  __device__ __forceinline__ void update(const float (&acc)[MT][NTW][4], Col col_of, int V,
                                         const int (&lab)[2 * MT],
                                         const float (&llr)[2 * MT]) {
    int gr[2 * MT][2] = {};
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int r = 2 * m + h, col = col_of(jj, q);
            const bool counted = !CHECKED || (col < V && col != lab[r]);
            gr[r][q] += (counted && acc[m][jj][2 * h + q] > llr[r]) ? 1 : 0;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) cnt[r] += gr[r][0] + gr[r][1];
  }

  __device__ __forceinline__ void finish(const int (&rows)[2 * MT], int N, int split,
                                         const Out& out) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < 2 * MT; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) cnt[r] += __shfl_xor_sync(0xffffffffu, cnt[r], off);
      if (MT == 1) {
        if (t == 0 && rows[r] < N) out.cnt[(size_t)split * N + rows[r]] = cnt[r];
      } else if (t == 0) {
        atomicAdd(&block_counts[rows[r] % BN], cnt[r]);
      }
    }
    if (MT == 1) return;
    // the consumer warps only: the producer warp has returned
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * t4r::stream::WARPS) : "memory");
    const int row = (int)blockIdx.y * BN + (int)threadIdx.x;
    if (threadIdx.x < BN && row < N) {
      out.cnt[(size_t)split * N + row] = block_counts[threadIdx.x];
    }
  }
};

template <class T>
int rank_entry(const float* x, const T* W, const int* labels, const float* ll, int N, int E,
               int V, int splits, int chunks_per_split, int stages, int smem, int* part_cnt,
               int* cnt, void* stream) {
  namespace ts = t4r::stream;
  if (E < 4 || E > 256 || E % 4 != 0 || stages < ts::MIN_STAGES ||
      smem != ts::smem_of<T>(E, stages) || smem > ts::MAX_SMEM) {
    return (int)cudaErrorInvalidValue;  // not the plan's ring
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, (N + BN - 1) / BN);
  cudaError_t err = ts::with_ks(E, [&](auto ks) {
    constexpr int KS = decltype(ks)::value;
    return ts::launch<KS, T, Count<KS>>(grid, st, x, W, labels, ll, N, E, V, chunks_per_split,
                                        stages, smem, {part_cnt});
  });
  if (err != cudaSuccess) return (int)err;
  return (int)ts::launch_merge<false>(st, nullptr, nullptr, part_cnt, nullptr, splits, N,
                                      nullptr, cnt, nullptr);
}

}  // namespace

extern "C" {

int t4r_rank_block_rows() { return t4r::BN; }
int t4r_rank_chunk_cols() { return t4r::BV; }

// Launches the streamed pass and the merge on `stream`, with the splits, ring
// slots (`stages`) and shared memory of the launch plan (ops/vocab.py:
// ce_plan(..., streamed=True)); a ring the plan would not give is refused.
// The caller checks shapes (E a multiple of 4, at most 256: wider tables
// take the wide entry below), dtypes, contiguity and alignment, and
// allocates every buffer: part_cnt is (splits, N), cnt (N,). V may be 0
// (splits = 1): every count is then 0. Returns the first CUDA error (0 when
// both launches were accepted).
int t4r_rank(const float* x, const float* W, const int* labels, const float* ll, int N,
             int E, int V, int splits, int chunks_per_split, int stages, int smem,
             int* part_cnt, int* cnt, void* stream) {
  return rank_entry(x, W, labels, ll, N, E, V, splits, chunks_per_split, stages, smem,
                    part_cnt, cnt, stream);
}

// The same on a bf16-stored table W, with the ring of t4r_rank_smem_bf16.
int t4r_rank_bf16(const float* x, const void* W, const int* labels, const float* ll, int N,
                  int E, int V, int splits, int chunks_per_split, int stages, int smem,
                  int* part_cnt, int* cnt, void* stream) {
  return rank_entry(x, static_cast<const __nv_bfloat16*>(W), labels, ll, N, E, V, splits,
                    chunks_per_split, stages, smem, part_cnt, cnt, stream);
}

// The shared memory of the streamed pass with `stages` slots at width E
// (what ops/vocab.py:ce_plan computes for it), for an f32 or a bf16 table:
// K3's ring, so the same bytes as t4r_ce_rank_smem.
int t4r_rank_smem(int E, int stages) { return t4r::stream::smem_of<float>(E, stages); }
int t4r_rank_smem_bf16(int E, int stages) {
  return t4r::stream::smem_of<__nv_bfloat16>(E, stages);
}
// The blocks an SM is to hold of K4's pass at width E (its launch bound,
// stream::min_blocks): the launch plan's blocks_per_sm where the shared
// memory holds them.
int t4r_rank_min_blocks(int E) { return t4r::stream::min_blocks_of(E); }

// How many blocks of K4's streamed pass with `smem` bytes of shared memory
// one SM holds at width E: the launch plan's blocks_per_sm must fit.
int t4r_rank_blocks_per_sm(int E, int smem, int bf16) {
  return t4r::stream::resident_blocks_of<Count>(E, smem, bf16 != 0);
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
  return (int)t4r::stream::launch_merge<false>(st, nullptr, nullptr, part_cnt, nullptr, splits,
                                               N, nullptr, cnt, nullptr);
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
