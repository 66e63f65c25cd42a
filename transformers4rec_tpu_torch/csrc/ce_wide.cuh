// The vocabulary pass of K1, K3 and K4 for item tables wider than the narrow
// kernels hold whole (E > 256): one kernel with three epilogues, built into
// ce_fwd.cu (CE: lse, label logit, zsum), ce_rank.cu (CE_RANK: lse, the count
// of logits above the label logit, zsum) and rank.cu (RANK: the count alone).
//
// The narrow kernels keep a 128-row tile of x whole beside a ring of whole
// W tiles (ce_fwd.cu) or x as register fragments (ce_rank.cu, rank.cu); at E
// = 448 a W tile is 112 KB and x fragments would take 224 registers a
// thread. So here E is walked in 64-value slabs, on the images that
// t4r_image writes (hopper.cuh; ek = E rounded up to a slab):
//   - block (128-row tile of x, vocab split), 384 threads, as K1's: a
//     producer warp streams, for every 128-column chunk of the split, the
//     chunk's W slabs one after the other through a ring of 16 KB slots;
//     the x tile stays resident in shared memory while it fits (up to 8
//     slabs, 128 KB, beside at least 6 slots). Past that, each slot carries
//     the x slab beside the W slab (32 KB), and x is read again from the L2
//     cache for every chunk;
//   - two consumer warpgroups own 64 rows each: the logits of a chunk
//     accumulate in the wgmma registers over its slabs (logit_slabs,
//     hopper.cuh: each slab's products are issued before the previous slab's
//     slot is let go), and only the full-E logit meets the softmax or the
//     comparison with the label logit;
//   - the partials per (split, row) have the narrow kernels' layout, so each
//     library's own merge kernel finishes the job.
// Bound: as the narrow kernels', E times wider (products and bytes); the
// exponentials do not grow with E. No atomics: the same bits on every call.

#pragma once

#include "hopper.cuh"

namespace t4r {
namespace wide {

using namespace t4r::hopper;

enum Mode { CE = 0, CE_RANK = 1, RANK = 2 };

// One chunk's logits of the thread's two rows (acc[4j + 2h + q]: row h,
// column col0 + 8j + q) into their running state: (max, sum) and zsum
// unless RANK, the label logit for CE, the count of logits above llr
// (leaving the label's own column out) otherwise. CHECKED bounds the
// columns by V and looks for each row's label.
template <int MODE, bool CHECKED, bool SMOOTH>
__device__ __forceinline__ void update_rows(const float (&acc)[64], int col0, int V,
                                            const int (&lab)[2], const float (&llr)[2],
                                            float (&m)[2], float (&s)[2], float (&ll)[2],
                                            int (&cnt)[2], double (&zs)[2]) {
  float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
  double z[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
  int gr[2][2] = {{0, 0}, {0, 0}};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float l = acc[4 * j + 2 * h + q];
        const int col = col0 + 8 * j + q;
        const bool valid = !CHECKED || col < V;
        if (MODE != RANK && valid) {
          mx[h][q] = fmaxf(mx[h][q], l);
          if (SMOOTH) z[h][q] += (double)l;
          if (MODE == CE && CHECKED && col == lab[h]) ll[h] += l;
        }
        if (MODE != CE) gr[h][q] += (valid && l > llr[h] && (!CHECKED || col != lab[h])) ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) cnt[h] += gr[h][0] + gr[h][1];
  if (MODE == RANK) return;
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

// RES: the x tile is resident (slots of one W slab); else each slot holds
// an x slab and a W slab. The images are ek = 64 slabs wide.
template <int MODE, bool SMOOTH, bool RES>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
wide_kernel(const uint8_t* __restrict__ ximg, const uint8_t* __restrict__ wimg,
            const int* __restrict__ labels, const float* __restrict__ ll_in, int N, int V,
            int slabs, int chunks_per_split, int stages, float* __restrict__ part_m,
            float* __restrict__ part_s, float* __restrict__ part_ll, int* __restrict__ part_cnt,
            double* __restrict__ part_zs) {
  extern __shared__ uint8_t smem_raw[];
  const DynRing r(smem_raw, RES ? slabs * SLAB_BYTES : 0, stages,
                  RES ? SLAB_BYTES : 2 * SLAB_BYTES);
  const RowSplit b = row_split(V, chunks_per_split);
  const size_t tile_bytes = (size_t)slabs * SLAB_BYTES;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    const uint8_t* xt = ximg + (size_t)b.row_tile * tile_bytes;
    r.produce(xt, b.count * slabs, [&](int i, uint8_t* slot, uint64_t* bar) {
      const int ci = i / slabs, s = i - ci * slabs;
      const uint8_t* w = wimg + (size_t)(b.begin + ci) * tile_bytes + (size_t)s * SLAB_BYTES;
      if (RES) {
        mbar_expect_tx(bar, SLAB_BYTES);
        bulk_load(slot, w, SLAB_BYTES, bar);
      } else {
        mbar_expect_tx(bar, 2 * SLAB_BYTES);
        bulk_load(slot, xt + (size_t)s * SLAB_BYTES, SLAB_BYTES, bar);
        bulk_load(slot + SLAB_BYTES, w, SLAB_BYTES, bar);
      }
    });
  } else {
    consumer_registers();
    const int t = threadIdx.x & 3;
    int rows[2];
    consumer_rows(b.row_tile, rows);
    float m[2], s[2], ll[2], llr[2];
    double zs[2];
    int lab[2], cnt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = NEG;
      s[h] = 0.f;
      ll[h] = 0.f;
      zs[h] = 0.0;
      cnt[h] = 0;
      lab[h] = rows[h] < N ? labels[rows[h]] : -1;
      llr[h] = (MODE != CE && rows[h] < N) ? ll_in[rows[h]] : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (RES) mbar_wait(r.once, 0);
    int item = 0;
    for (int ci = 0; ci < b.count; ++ci) {
      item = logit_slabs<RES>(acc, r, item, slabs, wg * 64 * 128);
      const int c = b.begin + ci;
      const int col0 = c * TILE + 2 * t;
      if (unchecked_chunk(c, V, lab)) {
        update_rows<MODE, false, SMOOTH>(acc, col0, V, lab, llr, m, s, ll, cnt, zs);
      } else {
        update_rows<MODE, true, SMOOTH>(acc, col0, V, lab, llr, m, s, ll, cnt, zs);
      }
    }

    // merge the 4 lanes (t) that share each row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        if (MODE != RANK) {
          const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
          const float s2 = __shfl_xor_sync(0xffffffffu, s[h], off);
          const float mn = fmaxf(m[h], m2);
          s[h] = s[h] * ex2((m[h] - mn) * LOG2E) + s2 * ex2((m2 - mn) * LOG2E);
          m[h] = mn;
        }
        if (MODE == CE) ll[h] += __shfl_xor_sync(0xffffffffu, ll[h], off);
        if (MODE != CE) cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], off);
        if (SMOOTH) zs[h] += __shfl_xor_sync(0xffffffffu, zs[h], off);
      }
      if (t == 0 && rows[h] < N) {
        const size_t idx = (size_t)b.split * N + rows[h];
        if (MODE != RANK) {
          part_m[idx] = m[h];
          part_s[idx] = s[h];
        }
        if (MODE == CE) part_ll[idx] = ll[h];
        if (MODE != CE) part_cnt[idx] = cnt[h];
        if (SMOOTH) part_zs[idx] = zs[h];
      }
    }
  }
}

// Launches the wide kernel on grid (row_tiles, splits) over images ek values
// wide (a multiple of 64 above 256); resident as the launch plan says (only
// up to 8 slabs). Returns the first CUDA error.
template <int MODE, bool SMOOTH>
cudaError_t launch(dim3 grid, cudaStream_t st, const uint8_t* ximg, const uint8_t* wimg,
                   const int* labels, const float* ll, int N, int V, int ek, int resident,
                   int chunks_per_split, float* part_m, float* part_s, float* part_ll,
                   int* part_cnt, double* part_zs) {
  const int slabs = ek / 64;
  if (ek % 64 != 0 || ek <= 256 || (resident && slabs > 8)) return cudaErrorInvalidValue;
  const int tile = resident ? slabs * SLAB_BYTES : 0;
  const int slot = resident ? SLAB_BYTES : 2 * SLAB_BYTES;
  const int stages = DynRing::most_stages(tile, slot);
  if (stages == 0) return cudaErrorInvalidValue;
  const int smem = DynRing::bytes(tile, stages, slot);
  if (resident) {
    return hopper::launch(wide_kernel<MODE, SMOOTH, true>, grid, smem, st, ximg, wimg, labels, ll,
                          N, V, slabs, chunks_per_split, stages, part_m, part_s, part_ll,
                          part_cnt, part_zs);
  }
  return hopper::launch(wide_kernel<MODE, SMOOTH, false>, grid, smem, st, ximg, wimg, labels, ll,
                        N, V, slabs, chunks_per_split, stages, part_m, part_s, part_ll, part_cnt,
                        part_zs);
}

}  // namespace wide
}  // namespace t4r
