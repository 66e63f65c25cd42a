// Backward pass of the fused softmax cross-entropy over the item vocabulary
// (kernel K2 of the port).
//
// Given x (N, E), the item table W (Vp, E), labels, the forward's lse (N,)
// and the per-row coefficient coef (N,) (upstream gradient x row weight /
// weight sum), over the columns c < V (rows V..Vp-1 of W are padding):
//   P[n, c] = exp(bf16(x[n]) . bf16(W[c]) - lse[n])         (0 for c >= V)
//   R[n, c] = bf16((P[n, c] - eps_over_v - (1 - eps) [c == label[n]]) * coef[n])
//   dx = R . bf16(W)   (N, E) f32          dW = R^T . bf16(x)   (Vp, E) f32
// W may be stored as f32 or as bf16 (a bf16-stored table); dW is written in
// W's type, the f32 sum rounded once to nearest even for a bf16 table, as
// the reference's dW.astype(W.dtype) gives.
// Neither the logits nor R reach device memory. The one-hot term stands at
// every column of the table, as in the reference: a label on a padding row
// (V <= label < Vp) puts -(1 - eps) coef[n] bf16(x[n]) into that row of dW and
// -(1 - eps) coef[n] bf16(W[label]) into dx[n]; every other row of dW at and
// beyond V is exactly zero. A label outside [0, Vp) has no one-hot term; a
// row with coef = 0 contributes nothing.
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
// special-function rate. So the least time is set by the operations. At the
// long-session shape (N = 8,192) the three products take 1.24 ms and the
// exponentials 0.76 ms.
//
// Why two passes and not one. dW sums over the rows and dx over the vocab:
// opposite axes. The TPU kernel walks a sequential grid and keeps one of the
// two sums in VMEM across grid steps; a Hopper block has 227 KB and shares
// nothing with the others. A block that owns vocab columns keeps its dW in
// registers but then owes a dx partial to every column owner: 3,047 owners
// of 128 columns at N = 8,192 are 6.4 GB of partials. A block that owns rows
// has the same problem with dW; float atomics would break "the same bits on
// every call". So each pass recomputes P (4 products instead of 3, 2 sets of
// exponentials instead of 1: at N = 8,192 about max(1.65 ms of products,
// 1.53 ms of exponentials) for the two), and each is built to run at the
// tensor cores' rate:
//   - to_image_kernel (hopper.cuh) writes bf16 images of x, of the whole
//     table (Vp rows) and a row table (lse log2(e), coef, label) once per
//     call: every f32 -> bf16 rounding happens there, and a 128-row tile is
//     one contiguous block in the layout of TMA's 128-byte swizzle, which one
//     bulk copy moves as it stands and wgmma reads both as a K-major and as
//     an MN-major operand. No shared-memory transpose is written by hand.
//   - ce_bwd_dw_kernel: a block owns 128 columns of the vocab (one W tile,
//     copied once), 64 per consumer warpgroup; a producer warp streams the x
//     tiles and their row-table entries through a ring of STAGES slots. Per
//     tile, S^T = W_c . x_t^T by wgmma (A = the W tile, B = the x tile, both
//     K-major), the residual in registers from the row table, and its bf16
//     pairs are the A fragments (from registers) of dW_c += R^T . x_t, with
//     B the same x tile read MN-major. dW is written once, every row of the
//     table included (rows at and beyond V carry only a one-hot).
//   - ce_bwd_dx_kernel: block (128-row tile of x, vocab split), like K1: the
//     x tile copied once, the split's W tiles streamed; S = x_t . W_c^T, the
//     residual, then dx_t += R . W_c with B the same W tile MN-major. Each
//     block writes one (128, E) partial of dx;
//   - ce_bwd_dx_reduce_kernel sums the partials over the splits, in order,
//     and adds a padding-row label's one-hot (the dx pass leaves columns at
//     and beyond V out).
// In both passes the two consumer warpgroups work on the same slot, each
// waiting for its own products, and the copies of the next slots fly
// meanwhile. An explicit ping-pong order between the warpgroups (named
// barriers; a turn held the second product of one slot and the logits of
// the next) was measured slower on an NVIDIA H100 80GB HBM3 at 700 W (4.21
// against 4.08 ms at N = 8,192). Overlapping a warpgroup's own products
// with its residual needs a second accumulator, which the 168 registers a
// thread of a 384-thread block gets do not hold. No atomics: the same bits
// on every call.
//
// Wider tables (E > 128). A 128-row dW tile at E = 448 is 224 KB of f32,
// more than a block's registers, so each block of the wide dW pass owns a
// (table tile, 128 columns of E) of dW and each block of the wide dx pass a
// (row tile, split, 128 columns of E) of dx. Each recomputes the full-E
// logits, slab by slab (logit_slabs, hopper.cuh), from a ring of 34 KB slots
// that carries both operands' slabs; the last slot of each step carries the
// two slabs of the other operand that its 128 output columns need (and, for
// dW, the row table), which the second product reads MN-major. So the
// residual is formed ceil(E / 128) times (4 at E = 448): the recompute
// factor. Images are E rounded up to 128 wide; the logits walk only the
// slabs that hold E. Deterministic, no atomics; the reduce is the narrow
// pass's.

#include "hopper.cuh"

namespace {

using namespace t4r;
using namespace t4r::hopper;

constexpr int INFO_BYTES = TILE * 16;  // (lse log2(e), coef, label, 0) per row

// Stores the pair (a, b) at element i of dW: f32, or bf16 rounded to nearest
// even when bf16 (a bf16-stored table's gradient). i is even.
__device__ __forceinline__ void store_dw_pair(void* dW, bool bf16, size_t i, float a, float b) {
  if (bf16) {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dW) + i) = pack_bf16(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(dW) + i) = make_float2(a, b);
  }
}

// the dW pass's ring: a slot holds an x tile and its rows' entries of the row table
template <int KA>
using DwRing = Ring<KA, KA * SLAB_BYTES + INFO_BYTES>;

// The consumers' loop of both passes over `count` slots of the ring. Per
// slot i: logits(slot) issues the wgmmas of the logits, residual(slot index,
// i) turns them into the A fragments of the second product, and
// second(slot) issues that product; slot is the slot's shared-memory
// address. Both products wait for their results: the two consumer
// warpgroups of the block, and the copies in flight, fill the gaps.
template <int STAGES, class Logits, class Residual, class Second>
__device__ __forceinline__ void consume(int count, uint64_t* full, uint64_t* empty,
                                        uint32_t ring, int slot_bytes, Logits logits,
                                        Residual residual, Second second) {
  for (int i = 0; i < count; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint32_t slot = ring + st * slot_bytes;
    wgmma_fence();
    logits(slot);
    wgmma_commit();
    wgmma_wait<0>();
    residual(st, i);
    wgmma_fence();
    second(slot);
    wgmma_commit();
    wgmma_wait<0>();
    release(empty, st);
  }
}

// ------------------------------------------------------------------- dW
// Residual of S^T in place: acc[4j + 2h + q] is vocab column cols[h], row
// 8j + 2t + q of the x tile, whose row-table entry is info[8j + 2t + q].
// CHECKED bounds the columns by V and looks for the label at every column.
template <bool CHECKED>
__device__ __forceinline__ void dw_residual(float (&acc)[64], const float4* info, int t,
                                            const int (&cols)[2], int V, float eov,
                                            float one_minus_eps) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 f = info[8 * j + 2 * t + q];  // lse2, coef, label
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p = ex2(fmaf(acc[4 * j + 2 * h + q], LOG2E, -f.x)) - eov;
        if (CHECKED) {
          if (cols[h] >= V) p = 0.f;
          if (cols[h] == __float_as_int(f.z)) p -= one_minus_eps;
        }
        acc[4 * j + 2 * h + q] = p * f.y;
      }
    }
  }
}

// KA: 64-wide slabs of E (E padded with zeros to EK = 64 KA). One block per
// 128 rows of the table.
template <int KA>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
ce_bwd_dw_kernel(const uint8_t* __restrict__ ximg, const uint8_t* __restrict__ wimg,
                 const float4* __restrict__ info, int row_tiles, int E, int V, int Vp,
                 float eov, float one_minus_eps, void* __restrict__ dW, int dw_bf16) {
  constexpr int EK = 64 * KA;
  using R = DwRing<KA>;
  constexpr int TILE_BYTES = R::TILE_BYTES, SLOT_BYTES = TILE_BYTES + INFO_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const R sm(smem_raw);

  const int c = blockIdx.x;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    sm.produce(wimg + (size_t)c * TILE_BYTES, row_tiles,
               [&](int i, uint8_t* slot, uint64_t* bar) {
                 bulk_load(slot, ximg + (size_t)i * TILE_BYTES, TILE_BYTES, bar);
                 bulk_load(slot + TILE_BYTES, info + (size_t)i * TILE, INFO_BYTES, bar);
               });
  } else {
    // ---- consumers: warpgroup wg owns columns 64 wg .. 64 wg + 63 of the tile
    consumer_registers();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int c0 = c * TILE + wg * 64;  // this warpgroup's first column
    const int cols[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
    const bool whole = c0 + 64 <= V;

    float acc[64], dw[EK / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < EK / 2; ++i) dw[i] = 0.f;
    const uint32_t wa = smem_addr(sm.tile) + wg * 64 * 128;
    uint32_t a[8][4];  // R^T of a tile, as A fragments
    mbar_wait(sm.once, 0);
    consume<R::STAGES>(
        row_tiles, sm.full, sm.empty, smem_addr(sm.ring), SLOT_BYTES,
        [&](uint32_t xa) {  // S^T = W_c . x_t^T
          fence_regs(acc);
#pragma unroll
          for (int k = 0; k < 4 * KA; ++k) {
            wgmma_ss_n128(acc, kmajor_desc(wa, k), kmajor_desc(xa, k), k > 0);
          }
        },
        [&](int st, int) {
          fence_regs(acc);
          const float4* tinfo =
              reinterpret_cast<const float4*>(sm.ring + st * SLOT_BYTES + TILE_BYTES);
          // does any row of the tile have its label among this warpgroup's columns?
          bool hit = false;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            hit |= (unsigned)(__float_as_int(tinfo[lane + 32 * u].z) - c0) < 64u;
          }
          if (whole && !__any_sync(0xffffffffu, hit)) {
            dw_residual<false>(acc, tinfo, t, cols, V, eov, one_minus_eps);
          } else {
            dw_residual<true>(acc, tinfo, t, cols, V, eov, one_minus_eps);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) acc_to_a(acc, k, a[k]);
        },
        [&](uint32_t xa) {  // dW_c += R^T . x_t
          fence_regs(dw);
#pragma unroll
          for (int k = 0; k < 8; ++k) wgmma_rs<EK>(dw, a[k], mnmajor_desc(xa, k));
        });
    fence_regs(dw);

    // dw[4j + 2h + q]: column cols[h], e = 8j + 2t + q
#pragma unroll
    for (int j = 0; j < EK / 8; ++j) {
      const int e = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cols[h] < Vp && e < E) {
          store_dw_pair(dW, dw_bf16, (size_t)cols[h] * E + e, dw[4 * j + 2 * h],
                        dw[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- dx
// Residual of S in place: acc[4j + 2h + q] is row h of the thread, column
// col0 + 8j + q. CHECKED bounds the columns by V and looks for each row's
// label below V (a label on a padding row is the reduce kernel's).
template <bool CHECKED>
__device__ __forceinline__ void dx_residual(float (&acc)[64], int col0, int V,
                                            const int (&lab)[2], const float (&lse2)[2],
                                            const float (&coef)[2], float eov,
                                            float one_minus_eps) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float p = ex2(fmaf(acc[4 * j + 2 * h + q], LOG2E, -lse2[h])) - eov;
        if (CHECKED) {
          const int col = col0 + 8 * j + q;
          if (col >= V) {
            p = 0.f;
          } else if (col == lab[h]) {
            p -= one_minus_eps;
          }
        }
        acc[4 * j + 2 * h + q] = p * coef[h];
      }
    }
  }
}

template <int KA>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
ce_bwd_dx_kernel(const uint8_t* __restrict__ ximg, const uint8_t* __restrict__ wimg,
                 const int* __restrict__ labels, const float* __restrict__ lse,
                 const float* __restrict__ coef, int N, int E, int V, int chunks_per_split,
                 float eov, float one_minus_eps, float* __restrict__ part_dx) {
  constexpr int EK = 64 * KA;
  using R = Ring<KA>;
  extern __shared__ uint8_t smem_raw[];
  const R sm(smem_raw);
  const RowSplit b = row_split(V, chunks_per_split);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    produce_row_pass<KA>(sm, ximg, wimg, b);
  } else {
    consumer_registers();
    const int t = threadIdx.x & 3;
    int rows[2];
    consumer_rows(b.row_tile, rows);
    int lab[2];
    float lse2[2], cf[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lab[h] = rows[h] < N ? labels[rows[h]] : -1;
      lse2[h] = rows[h] < N ? lse[rows[h]] * LOG2E : 0.f;
      cf[h] = rows[h] < N ? coef[rows[h]] : 0.f;
    }

    float acc[64], dx[EK / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < EK / 2; ++i) dx[i] = 0.f;
    const uint32_t xa = smem_addr(sm.tile) + wg * 64 * 128;
    uint32_t a[8][4];  // R of a chunk, as A fragments
    mbar_wait(sm.once, 0);
    consume<R::STAGES>(
        b.count, sm.full, sm.empty, smem_addr(sm.ring), R::TILE_BYTES,
        [&](uint32_t wa) {  // S = x_t . W_c^T
          fence_regs(acc);
#pragma unroll
          for (int k = 0; k < 4 * KA; ++k) {
            wgmma_ss_n128(acc, kmajor_desc(xa, k), kmajor_desc(wa, k), k > 0);
          }
        },
        [&](int, int i) {
          fence_regs(acc);
          const int c = b.begin + i;
          const int col0 = c * TILE + 2 * t;
          if (unchecked_chunk(c, V, lab)) {
            dx_residual<false>(acc, col0, V, lab, lse2, cf, eov, one_minus_eps);
          } else {
            dx_residual<true>(acc, col0, V, lab, lse2, cf, eov, one_minus_eps);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) acc_to_a(acc, k, a[k]);
        },
        [&](uint32_t wa) {  // dx_t += R . W_c
          fence_regs(dx);
#pragma unroll
          for (int k = 0; k < 8; ++k) wgmma_rs<EK>(dx, a[k], mnmajor_desc(wa, k));
        });
    fence_regs(dx);

    // dx[4j + 2h + q]: row rows[h], e = 8j + 2t + q
#pragma unroll
    for (int j = 0; j < EK / 8; ++j) {
      const int e = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] < N && e < E) {
          *reinterpret_cast<float2*>(part_dx + ((size_t)b.split * N + rows[h]) * E + e) =
              make_float2(dx[4 * j + 2 * h], dx[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- wide tables
constexpr int WIDE_STAGES = 6;
constexpr int WIDE_SLOT = 2 * SLAB_BYTES + INFO_BYTES;  // 34 KB, a multiple of 1,024

// The residual's A fragments times the 128 output columns of the step's
// last slot (two slabs, MN-major) into out.
__device__ __forceinline__ void second_product(float (&out)[64], const uint32_t (&a)[8][4],
                                               uint32_t slot) {
  wgmma_fence();
  fence_regs(out);
#pragma unroll
  for (int k = 0; k < 8; ++k) wgmma_rs<128>(out, a[k], mnmajor_desc(slot, k));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(out);
}

// One block per (table tile, 128 columns of E): blockIdx.x, blockIdx.y.
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
ce_bwd_dw_wide_kernel(const uint8_t* __restrict__ ximg, const uint8_t* __restrict__ wimg,
                      const float4* __restrict__ info, int row_tiles, int E, int V, int Vp,
                      int ek, int slabs, float eov, float one_minus_eps, void* __restrict__ dW,
                      int dw_bf16) {
  extern __shared__ uint8_t smem_raw[];
  const DynRing r(smem_raw, 0, WIDE_STAGES, WIDE_SLOT);
  const int c = blockIdx.x, js = blockIdx.y;
  const size_t tile_bytes = (size_t)TILE * ek * 2;
  const int per = slabs + 1;  // items per x tile
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    const uint8_t* wt = wimg + (size_t)c * tile_bytes;
    r.produce(nullptr, row_tiles * per, [&](int i, uint8_t* slot, uint64_t* bar) {
      const int t = i / per, s = i - t * per;
      const uint8_t* xt = ximg + (size_t)t * tile_bytes;
      if (s < slabs) {  // [W_c slab s | x_t slab s]
        mbar_expect_tx(bar, 2 * SLAB_BYTES);
        bulk_load(slot, wt + (size_t)s * SLAB_BYTES, SLAB_BYTES, bar);
        bulk_load(slot + SLAB_BYTES, xt + (size_t)s * SLAB_BYTES, SLAB_BYTES, bar);
      } else {  // [x_t slabs 2 js, 2 js + 1 | the tile's row table]
        mbar_expect_tx(bar, WIDE_SLOT);
        bulk_load(slot, xt + (size_t)2 * js * SLAB_BYTES, 2 * SLAB_BYTES, bar);
        bulk_load(slot + 2 * SLAB_BYTES, info + (size_t)t * TILE, INFO_BYTES, bar);
      }
    });
  } else {
    consumer_registers();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int c0 = c * TILE + wg * 64;
    const int cols[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
    const bool whole = c0 + 64 <= V;
    float acc[64], dw[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = dw[i] = 0.f;
    uint32_t a[8][4];
    int item = 0;
    for (int xt = 0; xt < row_tiles; ++xt) {
      item = logit_slabs<false>(acc, r, item, slabs, wg * 64 * 128);  // S^T = W_c . x_t^T
      const int st = item % WIDE_STAGES;
      mbar_wait(&r.full[st], (item / WIDE_STAGES) & 1);
      const uint8_t* slot = r.ring + st * WIDE_SLOT;
      const float4* tinfo = reinterpret_cast<const float4*>(slot + 2 * SLAB_BYTES);
      bool hit = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        hit |= (unsigned)(__float_as_int(tinfo[lane + 32 * u].z) - c0) < 64u;
      }
      if (whole && !__any_sync(0xffffffffu, hit)) {
        dw_residual<false>(acc, tinfo, t, cols, V, eov, one_minus_eps);
      } else {
        dw_residual<true>(acc, tinfo, t, cols, V, eov, one_minus_eps);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc_to_a(acc, k, a[k]);
      second_product(dw, a, smem_addr(slot));  // dW_c[:, js] += R^T . x_t[:, js]
      release(r.empty, st);
      ++item;
    }
    // dw[4j + 2h + q]: column cols[h], e = 128 js + 8j + 2t + q
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = 128 * js + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cols[h] < Vp && e < E) {
          store_dw_pair(dW, dw_bf16, (size_t)cols[h] * E + e, dw[4 * j + 2 * h],
                        dw[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// One block per (row tile, split, 128 columns of E): blockIdx.x, .y, .z.
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
ce_bwd_dx_wide_kernel(const uint8_t* __restrict__ ximg, const uint8_t* __restrict__ wimg,
                      const int* __restrict__ labels, const float* __restrict__ lse,
                      const float* __restrict__ coef, int N, int E, int V, int ek, int slabs,
                      int chunks_per_split, float eov, float one_minus_eps,
                      float* __restrict__ part_dx) {
  extern __shared__ uint8_t smem_raw[];
  const DynRing r(smem_raw, 0, WIDE_STAGES, WIDE_SLOT);
  const RowSplit b = row_split(V, chunks_per_split);
  const int js = blockIdx.z;
  const size_t tile_bytes = (size_t)TILE * ek * 2;
  const int per = slabs + 1;  // items per chunk
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    const uint8_t* xt = ximg + (size_t)b.row_tile * tile_bytes;
    r.produce(nullptr, b.count * per, [&](int i, uint8_t* slot, uint64_t* bar) {
      const int ci = i / per, s = i - ci * per;
      const uint8_t* wc = wimg + (size_t)(b.begin + ci) * tile_bytes;
      if (s < slabs) {  // [x_t slab s | W_c slab s]
        mbar_expect_tx(bar, 2 * SLAB_BYTES);
        bulk_load(slot, xt + (size_t)s * SLAB_BYTES, SLAB_BYTES, bar);
        bulk_load(slot + SLAB_BYTES, wc + (size_t)s * SLAB_BYTES, SLAB_BYTES, bar);
      } else {  // [W_c slabs 2 js, 2 js + 1]
        mbar_expect_tx(bar, 2 * SLAB_BYTES);
        bulk_load(slot, wc + (size_t)2 * js * SLAB_BYTES, 2 * SLAB_BYTES, bar);
      }
    });
  } else {
    consumer_registers();
    const int t = threadIdx.x & 3;
    int rows[2];
    consumer_rows(b.row_tile, rows);
    int lab[2];
    float lse2[2], cf[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lab[h] = rows[h] < N ? labels[rows[h]] : -1;
      lse2[h] = rows[h] < N ? lse[rows[h]] * LOG2E : 0.f;
      cf[h] = rows[h] < N ? coef[rows[h]] : 0.f;
    }
    float acc[64], dx[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = dx[i] = 0.f;
    uint32_t a[8][4];
    int item = 0;
    for (int ci = 0; ci < b.count; ++ci) {
      item = logit_slabs<false>(acc, r, item, slabs, wg * 64 * 128);  // S = x_t . W_c^T
      const int st = item % WIDE_STAGES;
      mbar_wait(&r.full[st], (item / WIDE_STAGES) & 1);
      const int c = b.begin + ci;
      const int col0 = c * TILE + 2 * t;
      if (unchecked_chunk(c, V, lab)) {
        dx_residual<false>(acc, col0, V, lab, lse2, cf, eov, one_minus_eps);
      } else {
        dx_residual<true>(acc, col0, V, lab, lse2, cf, eov, one_minus_eps);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc_to_a(acc, k, a[k]);
      second_product(dx, a, smem_addr(r.ring + st * WIDE_SLOT));  // dx_t[:, js] += R . W_c[:, js]
      release(r.empty, st);
      ++item;
    }
    // dx[4j + 2h + q]: row rows[h], e = 128 js + 8j + 2t + q
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = 128 * js + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (rows[h] < N && e < E) {
          *reinterpret_cast<float2*>(part_dx + ((size_t)b.split * N + rows[h]) * E + e) =
              make_float2(dx[4 * j + 2 * h], dx[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// The row table of the dW pass, padded to whole tiles: padded rows have
// coef 0 and label -1.
__global__ void row_info_kernel(const float* __restrict__ lse, const float* __restrict__ coef,
                                const int* __restrict__ labels, int N, int padded,
                                float4* __restrict__ info) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= padded) return;
  info[n] = n < N ? make_float4(lse[n] * LOG2E, coef[n], __int_as_float(labels[n]), 0.f)
                  : make_float4(0.f, 0.f, __int_as_float(-1), 0.f);
}

// Sums the per-split partials of dx in order. The dx kernel leaves the
// columns at and beyond V out, so the one-hot term of a label on a padding
// row is added here: R = bf16(-(1 - eps) coef[n]) times bf16(W[label]), both
// exact in f32. W is f32, or bf16 when w_bf16.
__global__ void ce_bwd_dx_reduce_kernel(const float* __restrict__ part_dx, int splits,
                                        int count, const void* __restrict__ W, int w_bf16,
                                        const int* __restrict__ labels,
                                        const float* __restrict__ coef, int E, int V, int Vp,
                                        float one_minus_eps, float* __restrict__ dx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part_dx[(size_t)k * count + i];
  const int n = i / E, lab = labels[n];
  if (lab >= V && lab < Vp) {
    const float r = __bfloat162float(__float2bfloat16(-one_minus_eps * coef[n]));
    const size_t at = (size_t)lab * E + (i - n * E);
    const __nv_bfloat16 w = w_bf16 ? static_cast<const __nv_bfloat16*>(W)[at]
                                   : __float2bfloat16(static_cast<const float*>(W)[at]);
    s += r * __bfloat162float(w);
  }
  dx[i] = s;
}

cudaError_t launch_reduce(cudaStream_t st, const void* W, int w_bf16, const int* labels,
                          const float* coef, int N, int E, int V, int Vp, float one_minus_eps,
                          int splits, const float* part_dx, float* dx) {
  const int count = N * E, reduce_threads = 256;
  ce_bwd_dx_reduce_kernel<<<(count + reduce_threads - 1) / reduce_threads, reduce_threads, 0,
                            st>>>(part_dx, splits, count, W, w_bf16, labels, coef, E, V, Vp,
                                  one_minus_eps, dx);
  return cudaGetLastError();
}

template <int KA>
cudaError_t launch_bwd(cudaStream_t st, const uint8_t* ximg, const uint8_t* wimg,
                       const float4* info, const void* W, int w_bf16, const int* labels,
                       const float* lse, const float* coef, int N, int E, int V, int Vp,
                       int row_tiles, int table_tiles, float eov, float one_minus_eps,
                       int splits, int chunks_per_split, float* part_dx, float* dx, void* dW) {
  cudaError_t err = launch(ce_bwd_dw_kernel<KA>, dim3(table_tiles), DwRing<KA>::BYTES, st, ximg,
                           wimg, info, row_tiles, E, V, Vp, eov, one_minus_eps, dW, w_bf16);
  if (err != cudaSuccess) return err;
  // row tiles fastest: they share a slice of W
  err = launch(ce_bwd_dx_kernel<KA>, dim3(row_tiles, splits), Ring<KA>::BYTES, st, ximg, wimg,
               labels, lse, coef, N, E, V, chunks_per_split, eov, one_minus_eps, part_dx);
  if (err != cudaSuccess) return err;
  return launch_reduce(st, W, w_bf16, labels, coef, N, E, V, Vp, one_minus_eps, splits,
                       part_dx, dx);
}

cudaError_t launch_bwd_wide(cudaStream_t st, const uint8_t* ximg, const uint8_t* wimg,
                            const float4* info, const void* W, int w_bf16, const int* labels,
                            const float* lse, const float* coef, int N, int E, int V, int Vp,
                            int ek, int slabs, int e_splits, int row_tiles, int table_tiles,
                            float eov, float one_minus_eps, int splits, int chunks_per_split,
                            float* part_dx, float* dx, void* dW) {
  const int smem = DynRing::bytes(0, WIDE_STAGES, WIDE_SLOT);
  cudaError_t err = launch(ce_bwd_dw_wide_kernel, dim3(table_tiles, e_splits), smem, st, ximg,
                           wimg, info, row_tiles, E, V, Vp, ek, slabs, eov, one_minus_eps, dW,
                           w_bf16);
  if (err != cudaSuccess) return err;
  err = launch(ce_bwd_dx_wide_kernel, dim3(row_tiles, splits, e_splits), smem, st, ximg, wimg,
               labels, lse, coef, N, E, V, ek, slabs, chunks_per_split, eov, one_minus_eps,
               part_dx);
  if (err != cudaSuccess) return err;
  return launch_reduce(st, W, w_bf16, labels, coef, N, E, V, Vp, one_minus_eps, splits,
                       part_dx, dx);
}

}  // namespace

extern "C" {

// Writes the row table, then launches the dW, the dx and the dx-reduce
// kernel on `stream`, on the images of x and of the whole table (t4r_image:
// ximg row_tiles x 128 rows, wimg table_tiles x 128 rows, ek columns). The
// caller takes ek, slabs, e_splits, row_tiles, table_tiles, splits and
// chunks_per_split from one launch plan: ek = 64 or 128 with slabs = ek / 64
// and e_splits = 1 for the narrow passes; for the wide ones ek a multiple of
// 128 from 256 on, e_splits = ek / 128 and slabs the 64-value slabs that
// hold E. The caller checks shapes (E a multiple of 4), dtypes, contiguity
// and alignment, and allocates every buffer: info (row_tiles x 128, 4) f32,
// part_dx (splits, N, E), dx (N, E), dW (Vp, E); the last three are written
// in full. W and dW are f32, or both bf16 when w_bf16 is 1 (a bf16-stored
// table: dW is the f32 sum rounded to nearest even). eps is the label
// smoothing and eps_over_v its share of every valid column. V may be 0
// (splits = 1). Returns the first CUDA error (0 when every launch was
// accepted).
int t4r_ce_bwd(const void* ximg, const void* wimg, const void* W, int w_bf16, const int* labels,
               const float* lse, const float* coef, int N, int E, int V, int Vp, int ek,
               int slabs, int e_splits, int row_tiles, int table_tiles, float eps,
               float eps_over_v, int splits, int chunks_per_split, void* info, float* part_dx,
               float* dx, void* dW, void* stream) {
  const bool narrow = (ek == 64 || ek == 128) && slabs == ek / 64 && e_splits == 1;
  const bool wide = ek >= 256 && ek % 128 == 0 && e_splits == ek / 128 && slabs * 64 >= E &&
                    slabs <= ek / 64 && slabs > ek / 64 - 2;
  if (E > ek || !(narrow || wide)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float ome = 1.f - eps;
  const uint8_t* xi = static_cast<const uint8_t*>(ximg);
  const uint8_t* wi = static_cast<const uint8_t*>(wimg);
  float4* in = static_cast<float4*>(info);
  const int info_threads = 128;
  row_info_kernel<<<row_tiles * TILE / info_threads, info_threads, 0, st>>>(
      lse, coef, labels, N, row_tiles * TILE, in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (wide) {
    return (int)launch_bwd_wide(st, xi, wi, in, W, w_bf16, labels, lse, coef, N, E, V, Vp, ek,
                                slabs, e_splits, row_tiles, table_tiles, eps_over_v, ome, splits,
                                chunks_per_split, part_dx, dx, dW);
  }
  if (ek == 64) {
    return (int)launch_bwd<1>(st, xi, wi, in, W, w_bf16, labels, lse, coef, N, E, V, Vp, row_tiles,
                              table_tiles, eps_over_v, ome, splits, chunks_per_split, part_dx,
                              dx, dW);
  }
  return (int)launch_bwd<2>(st, xi, wi, in, W, w_bf16, labels, lse, coef, N, E, V, Vp, row_tiles,
                            table_tiles, eps_over_v, ome, splits, chunks_per_split, part_dx, dx,
                            dW);
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
