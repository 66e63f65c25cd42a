// Flash attention backward (kernels K6a, K6b and K6c of the port).
//
// From q, k, v, dO (all (B, S, H, Dh) float32, rounded to bf16 on the way to
// shared memory, or all bf16 in the form built with -DT4R_FLASH_BF16, read as
// stored: flash_common.cuh), the forward's lse and delta = rowsum(dO * O)
// (f32), each body
// recomputes P = exp(logits - lse) tile by tile and forms
//   dS = P * (dO . v^T - delta)        (rounded to bf16 before its products)
//   dv = P^T . dO      dk = dS^T . q * Dh^-1/2      dq = dS . k * Dh^-1/2
// with f32 sums and the scale applied in f32 after the products; dq, dk and
// dv are written in q's type (rounded once in the bf16 form).
//   K6a flash_bwd_fused: dq, dk, dv from ONE recomputation (5 tile products);
//   K6b flash_bwd_dq:    dq alone (3 tile products);
//   K6c flash_bwd_dkv:   dk, dv alone (4 tile products).
//
// Replaces: transformers4rec_tpu/ops/attention.py:_make_bwd_fused_kernel
// (K6a, launched by _flash_backward through pl.pallas_call, attention.py:520),
// _make_bwd_dq_kernel (K6b, :552) and _make_bwd_dkv_kernel (K6c, :578).
//
// Bound on an H100 at the long-session shape (B=32, S=256, H=16, Dh=12,
// causal): q, k, v, dO read and dq, dk, dv written are 7 x 6.3 MB = 44 MB,
// 13 us at 3.35 TB/s; five products at the mma's depth of 16 are 5.4 GFLOP
// dense, half of it under the causal mask, 3-5 us on the tensor cores; 17 M
// exponentials are 4 us. The bytes bound it (half of them in the bf16 form:
// 6.6 us). At (4, 2048, 8, 64) the five products are 86 GFLOP dense and the
// tensor cores bound it.
//
// Design. dk and dv sum over queries, dq sums over keys. The TPU kernel runs
// its grid in order on one core and keeps dq for the whole sequence in a
// VMEM scratch beside the per-key-tile dk and dv; Hopper blocks run in no
// order and share nothing, so:
//   - flash_bwd_dkv_kernel<.., FUSED>: a block owns a (batch * head, 64-key
//     tile) and loops over the query tiles from the causal start. It
//     computes the TRANSPOSED logits k . q^T, so each of 4 warps holds 16
//     keys and P^T and dS^T come out of the tensor cores in the layout that
//     the dv and dk products take as their left operand: dk and dv stay in
//     registers over the whole loop. With FUSED (K6a) it also writes dS^T to
//     shared memory, forms dS . k for the query tile from the same dS bits
//     and writes it to the partial dq_part[key tile]; flash_dq_reduce_kernel
//     then adds the partials of every query row in key-tile order and
//     scales. No atomics: the same bits on every call. The partials cost
//     (key tiles) x the bytes of dq, which plays the part of the reference's
//     full-sequence scratch: the caller takes K6a while they stay under a
//     cap and K6b + K6c above it;
//   - flash_bwd_dq_kernel (K6b): a block owns a (batch * head, 64-query
//     tile), loops over the key tiles up to the causal end and keeps dq in
//     registers;
//   - flash_bwd_dkv_stream_kernel (K6c) and flash_bwd_dq_stream_kernel (K6b)
//     for head dims up to 32 (ops/attention.py:uses_split_stream): the two
//     loops above with 128 keys (K6c) or 128 queries (K6b) a block, one
//     row-major bf16 copy of each streamed tile, each step's loads in flight
//     during the step before, and steps whose P is 0 skipped; at the S =
//     4,096 step's (4, 4096, 16, 12) K6c takes 0.39 ms against the body's
//     0.96 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), and each gives the
//     bits of the body it replaces.
// All bodies take their logits from masked_logit (flash_common.cuh), the
// forward's function. Tiles are read from the (B, S, H, Dh) layout and stored
// in bf16 row-major and, where a product needs it, transposed: no cast or
// transpose pass runs before the kernels.
//
// K6a has a second design for Hopper (flash_bwd_fused_hw_kernel below,
// flash_hopper.cuh) for head dims of 33 to 64: a producer warpgroup copying
// f32 rows by cp.async into staging pieces and rounding them into a ring of
// bf16 tiles in the swizzled layout of hopper.cuh, wgmma for all five
// products, and dq partials per 64 keys as here. On an NVIDIA H100 80GB HBM3
// at 700 W it takes 0.336 ms at (4, 2048, 8, 64), causal, against this
// kernel's 0.69, but 0.127 ms at (32, 256, 16, 12) against 0.104 (PERF.md):
// head dims up to 32 keep this kernel (ops/attention.py:uses_wgmma).
// Past 64 its consumers would hold dk and dv of 64 keys x 128 values in
// registers beside the products, which the 168 registers a thread of a
// 384-thread block gets do not hold.

#include "flash_hopper.cuh"

namespace {

using namespace t4r;
using namespace t4r::flash;

// lse and delta of the 64 queries from q0 on; rows beyond the sequence get
// the masked sentinel, so that their P is 0.
__device__ __forceinline__ void load_row_terms(const float* __restrict__ lse_bh,
                                               const float* __restrict__ delta_bh, int q0, int S,
                                               float* __restrict__ lse_s,
                                               float* __restrict__ delta_s, int tid) {
  for (int r = tid; r < TQ; r += FTHREADS) {
    const bool ok = q0 + r < S;
    lse_s[r] = ok ? lse_bh[q0 + r] : LSE_MASKED;
    delta_s[r] = ok ? delta_bh[q0 + r] : 0.f;
  }
}

template <typename E, int KS, bool HAS_BIAS, bool FUSED>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                     const E* __restrict__ d_out, const float* __restrict__ lse,
                     const float* __restrict__ delta, const uint8_t* __restrict__ pad,
                     const float* __restrict__ bias, long long bias_sb, long long bias_sh,
                     float* __restrict__ dq_part, E* __restrict__ dk, E* __restrict__ dv, int B,
                     int S, int H, int Dh, int nk, int causal, float scale) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD, NTD = Tile<KS>::NTD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks_ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* vs = ks_ + 64 * LD;                                // [64][LD]
  __nv_bfloat16* qs = vs + 64 * LD;                                 // [64][LD]
  __nv_bfloat16* dos = qs + 64 * LD;                                // [64][LD]
  __nv_bfloat16* qt = dos + 64 * LD;                                // [DP][LDT]
  __nv_bfloat16* dot_t = qt + DP * LDT;                             // [DP][LDT]
  __nv_bfloat16* kt_t = dot_t + DP * LDT;                           // [DP][LDT]  (FUSED)
  __nv_bfloat16* ds_s = kt_t + (FUSED ? DP * LDT : 0);              // [64][LDT]  (FUSED)
  float* lse_s = reinterpret_cast<float*>(ds_s + (FUSED ? TQ * LDT : 0));
  float* delta_s = lse_s + TQ;
  float* pad_s = delta_s + TQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / nk, kt = blockIdx.x - bh * nk;
  const int b = bh / H, h = bh - b * H;
  const int row_stride = H * Dh;
  const size_t head_off = ((size_t)b * S * H + h) * Dh;
  const float* bias_bh = HAS_BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;

  load_tile<KS, true, FUSED>(k + head_off, row_stride, kt * TK, S, Dh, ks_, kt_t, tid);
  load_tile<KS, true, false>(v + head_off, row_stride, kt * TK, S, Dh, vs, nullptr, tid);
  load_pad_terms(pad != nullptr ? pad + (size_t)b * S : nullptr, kt * TK, S, pad_s, tid);

  const int key0 = kt * TK + warp * 16;
  const int keys[2] = {key0 + g, key0 + g + 8};
  float dk_acc[NTD][4], dv_acc[NTD][4];
  zero_acc<NTD>(dk_acc);
  zero_acc<NTD>(dv_acc);

  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(ks_);
  const uint32_t* vs32 = reinterpret_cast<const uint32_t*>(vs);
  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* dos32 = reinterpret_cast<const uint32_t*>(dos);
  const uint32_t* qt32 = reinterpret_cast<const uint32_t*>(qt);
  const uint32_t* dot_t32 = reinterpret_cast<const uint32_t*>(dot_t);
  const uint32_t* ktt32 = reinterpret_cast<const uint32_t*>(kt_t);
  const uint32_t* ds32 = reinterpret_cast<const uint32_t*>(ds_s);

  const int nq = (S + TQ - 1) / TQ;
  // query tiles wholly before this key tile see none of its keys
  const int qi_begin = causal ? (kt * TK) / TQ : 0;
  for (int qi = qi_begin; qi < nq; ++qi) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<KS, true, true>(q + head_off, row_stride, qi * TQ, S, Dh, qs, qt, tid);
    load_tile<KS, true, true>(d_out + head_off, row_stride, qi * TQ, S, Dh, dos, dot_t, tid);
    load_row_terms(lse_bh, delta_bh, qi * TQ, S, lse_s, delta_s, tid);
    __syncthreads();

    // transposed tiles: row = key (this warp's 16), column = query
    float p[8][4], ds[8][4];
    zero_acc<8>(p);
    zero_acc<8>(ds);
    mma_tile_smem<KS, 8>(ks32, LD / 2, warp * 16, qs32, LD / 2, g, t, p);     // k . q^T
    mma_tile_smem<KS, 8>(vs32, LD / 2, warp * 16, dos32, LD / 2, g, t, ds);   // v . dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int c = 8 * j + 2 * t + qq;  // query within the tile
          const float l = masked_logit<HAS_BIAS>(p[j][2 * hh + qq], scale, qi * TQ + c,
                                                 keys[hh], S, causal != 0,
                                                 pad_s[warp * 16 + g + 8 * hh], bias_bh);
          const float pv = ex2((l - lse_s[c]) * LOG2E);
          p[j][2 * hh + qq] = pv;
          ds[j][2 * hh + qq] = pv * (ds[j][2 * hh + qq] - delta_s[c]);
        }
      }
    }
    uint32_t frag[4][4];
    pack_a_fragments(p, frag);
    mma_tile<4, NTD>(frag, dot_t32, LDT / 2, g, t, dv_acc);  // dv += P^T . dO
    pack_a_fragments(ds, frag);
    mma_tile<4, NTD>(frag, qt32, LDT / 2, g, t, dk_acc);   // dk += dS^T . q

    if (FUSED) {
      // dS as [query][key] for the dq product: the bf16 values dk used
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            ds_s[(8 * j + 2 * t + qq) * LDT + warp * 16 + g + 8 * hh] =
                __float2bfloat16(ds[j][2 * hh + qq]);
          }
        }
      }
      __syncthreads();
      float dq_acc[NTD][4];
      zero_acc<NTD>(dq_acc);
      // this warp's 16 queries of the tile against all 64 keys
      mma_tile_smem<4, NTD>(ds32, LDT / 2, warp * 16, ktt32, LDT / 2, g, t, dq_acc);
      float* part = dq_part + ((size_t)kt * B + b) * S * row_stride + (size_t)h * Dh;
      store_rows<NTD>(dq_acc, 1.f, part, row_stride, qi * TQ + warp * 16, S, Dh, g, t);
    }
  }
  store_rows<NTD>(dk_acc, scale, dk + head_off, row_stride, key0, S, Dh, g, t);
  store_rows<NTD>(dv_acc, 1.f, dv + head_off, row_stride, key0, S, Dh, g, t);
}

// ------------------------------------------ K6c's streamed design (Dh <= 32)
// flash_bwd_dkv_stream_kernel: a block of DKV_WARPS warps per (batch * head,
// DKV_KEYS-key tile), each warp owning 16 keys as in the body above, and the
// same loop over 64-query steps from the causal start. What differs:
//   - the k and v A fragments are read once from device memory into
//     registers; q and dO of a step are kept once, row-major in bf16, and
//     the transposed operands of dv += P^T . dO and dk += dS^T . q come from
//     ldmatrix.trans (no second, transposed copy by scattered stores);
//   - step i + 1's q, dO, lse and delta are loaded into registers while
//     step i's products and exponentials run, and stored into the second of
//     two buffers after them: one barrier per step;
//   - a warp whose keys all lie after the step's queries (causal) or are all
//     padding skips the step, and a block whose keys are all padding writes
//     zeros and leaves (with a bias, only keys beyond S are skipped); a warp
//     whose keys lie wholly inside the sequence and, under the causal mask,
//     at or before every query of the step takes masked_logit's arithmetic
//     without its tests, in a loop of its own;
//   - key tiles are the slow grid axis, the longest (the first, under the
//     causal mask) first, so that the short ones fill the card's tail
//     (dkv_block_order in ops/attention.py is the Python twin).
// The logits come from the same mma.sync products of the same bf16 q and k
// in the same order as K6a's mma.sync body, so P and dS keep their bits, a
// skipped pair is one whose P is exactly 0 there, and dk and dv are summed
// in K6a's order: the two give the same bits (PERF.md). No atomics: the
// same bits on every call.
//
// Measured variants (PERF.md): cp.async into f32 staging instead of
// the register loads, as fast; 64 keys a block, 17% slower; the shortcut
// past masked_logit's tests as a select in the one loop, 7% slower than
// none, and as a loop of its own (shipped), 13% faster than none.
constexpr int DKV_WARPS = 8;
constexpr int DKV_KEYS = 16 * DKV_WARPS;
constexpr int DKV_THREADS = 32 * DKV_WARPS;
// the widest head dim that the streamed K6b and K6c take
constexpr int STREAM_MAX_DH = 32;

// Four 8 x 8 bf16 matrices of shared memory whose rows the lanes address
// (lane l: row l % 8 of matrix l / 8): r[m] is the lane's pair (row l / 4,
// columns 2 (l % 4), +1) of matrix m, or with TRANS of its transpose
// (rows 2 (l % 4), +1 of column l / 4).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  if (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
  }
}

// bf16 pair (columns col, col + 1) of row `row` of one (batch, head) of a
// (B, S, H, Dh) tensor of E; 0 at and beyond S and Dh.
template <typename E>
__device__ __forceinline__ uint32_t pair_at(const E* __restrict__ base, int row_stride, int row,
                                            int col, int S, int Dh) {
  if (row >= S || col >= Dh) return 0u;
  return load2_bf16(base + (size_t)row * row_stride + col);
}

// P^T and dS^T of 16 keys (keys[], two a thread) against the 32 queries of a
// half step from query c_half of the tile on, in place of the logits k . q^T
// in p and of v . dO^T in ds (acc[j][2hh + qq]: key keys[hh], query c_half +
// 8j + 2t + qq). INSIDE: every key lies inside the sequence and, under the
// causal mask, at or before every query: masked_logit's arithmetic without
// its tests (the scale and the padding term).
template <bool INSIDE, bool HAS_BIAS>
__device__ __forceinline__ void probabilities(float (&p)[4][4], float (&ds)[4][4],
                                              const float* __restrict__ lse_s,
                                              const float* __restrict__ delta_s, int c_half, int t,
                                              int q0, const int (&keys)[2], const float (&pad_k)[2],
                                              int S, int causal, float scale,
                                              const float* __restrict__ bias_bh) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c0 = c_half + 8 * j + 2 * t;  // the pair's first query in the step
    const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + c0);
    const float2 delta2 = *reinterpret_cast<const float2*>(delta_s + c0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const float l = INSIDE ? p[j][2 * hh + qq] * scale + pad_k[hh]
                               : masked_logit<HAS_BIAS>(p[j][2 * hh + qq], scale, q0 + c0 + qq,
                                                        keys[hh], S, causal != 0, pad_k[hh],
                                                        bias_bh);
        const float pv = ex2((l - (qq ? lse2.y : lse2.x)) * LOG2E);
        p[j][2 * hh + qq] = pv;
        ds[j][2 * hh + qq] = pv * (ds[j][2 * hh + qq] - (qq ? delta2.y : delta2.x));
      }
    }
  }
}

template <typename E, int KS, bool HAS_BIAS>
__global__ void __launch_bounds__(DKV_THREADS, 2)
flash_bwd_dkv_stream_kernel(const E* __restrict__ q, const E* __restrict__ k,
                            const E* __restrict__ v, const E* __restrict__ d_out,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            const uint8_t* __restrict__ pad, const float* __restrict__ bias,
                            long long bias_sb, long long bias_sh, E* __restrict__ dk,
                            E* __restrict__ dv, int S, int H, int Dh, int nk, int causal,
                            float scale) {
  constexpr int LD = Tile<KS>::LD, NTD = Tile<KS>::NTD;
  constexpr int C4 = Tile<KS>::DP / 4;         // pieces of 4 values of a padded row
  constexpr int PIECES = 2 * TQ * C4;          // of q and dO in a step
  constexpr int PER = PIECES / DKV_THREADS;    // a thread's
  static_assert(PIECES % DKV_THREADS == 0 && 2 * TQ <= DKV_THREADS, "a step's loads");
  __shared__ __align__(16) __nv_bfloat16 tiles[2][2][TQ * LD];  // [buffer][q, dO][row][LD]
  __shared__ float rows_s[2][2][TQ];                             // [buffer][lse, delta]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int BH = gridDim.x / nk, kt = blockIdx.x / BH, bh = blockIdx.x - kt * BH;
  const int b = bh / H, h = bh - b * H;
  const int row_stride = H * Dh;
  const size_t head_off = ((size_t)b * S * H + h) * Dh;
  const float* bias_bh = HAS_BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* delta_bh = delta + (size_t)bh * S;
  const uint8_t* pad_b = pad != nullptr ? pad + (size_t)b * S : nullptr;

  const int key0 = kt * DKV_KEYS + warp * 16;  // the warp's first key
  const int keys[2] = {key0 + g, key0 + g + 8};
  float pad_k[2];
  bool dead = true;  // both of the thread's keys have P = 0 for every query
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    pad_k[hh] = hw::pad_term_of(pad_b, keys[hh], S);
    dead = dead && (keys[hh] >= S || (!HAS_BIAS && pad_k[hh] != 0.f));
  }
  const bool warp_dead = __all_sync(0xffffffffu, dead);
  float dk_acc[NTD][4], dv_acc[NTD][4];
  zero_acc<NTD>(dk_acc);
  zero_acc<NTD>(dv_acc);
  if (__syncthreads_and(warp_dead)) {  // keys wholly of padding: dk = dv = 0
    store_rows<NTD>(dk_acc, 1.f, dk + head_off, row_stride, key0, S, Dh, g, t);
    store_rows<NTD>(dv_acc, 1.f, dv + head_off, row_stride, key0, S, Dh, g, t);
    return;
  }

  uint32_t ka[KS][4], va[KS][4];  // this warp's 16 keys of k and v as A fragments
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = keys[i & 1], col = 16 * ks + 8 * (i >> 1) + 2 * t;
      ka[ks][i] = pair_at(k + head_off, row_stride, key, col, S, Dh);
      va[ks][i] = pair_at(v + head_off, row_stride, key, col, S, Dh);
    }
  }
  // the head dim's padding columns stay zero: the stores below never write them
  for (int i = tid; i < 2 * 2 * TQ * LD / 2; i += DKV_THREADS) {
    reinterpret_cast<uint32_t*>(&tiles[0][0][0])[i] = 0u;
  }

  // A step's piece i: tile i / (TQ C4) (q, dO), row (i / C4) % TQ, 4 values
  // (i % C4) of it; consecutive threads read consecutive pieces of a row.
  // Rows beyond S are stored as zeros, with the masked lse and delta 0. The
  // pieces wait in registers as loaded and are rounded as they are stored.
  const int d4n = Dh / 4;
  typename Raw<E>::type pre[PER];
  float pre_row = 0.f;
  auto load = [&](int qi) {
    const int q0 = qi * TQ;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * DKV_THREADS, c = i % C4, r = (i / C4) % TQ;
      pre[j] = {};
      if (q0 + r < S && c < d4n) {
        const E* src = (i < TQ * C4 ? q : d_out) + head_off;
        pre[j] = load4(src + (size_t)(q0 + r) * row_stride + 4 * c);
      }
    }
    if (tid < 2 * TQ) {
      const int r = tid % TQ;
      const bool ok = q0 + r < S;
      pre_row = tid < TQ ? (ok ? lse_bh[q0 + r] : LSE_MASKED) : (ok ? delta_bh[q0 + r] : 0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * DKV_THREADS, c = i % C4, r = (i / C4) % TQ;
      if (c < d4n) {
        *reinterpret_cast<uint2*>(&tiles[buf][i / (TQ * C4)][r * LD + 4 * c]) = to_bf16x4(pre[j]);
      }
    }
    if (tid < 2 * TQ) rows_s[buf][tid / TQ][tid % TQ] = pre_row;
  };

  const int nq = (S + TQ - 1) / TQ;
  // query steps wholly before this key tile see none of its keys
  const int qi_begin = causal ? kt * DKV_KEYS / TQ : 0;
  load(qi_begin);
  __syncthreads();  // the zero fill is done
  store(0);
  if (qi_begin + 1 < nq) load(qi_begin + 1);
  __syncthreads();

  for (int qi = qi_begin; qi < nq; ++qi) {
    const int buf = (qi - qi_begin) & 1, q0 = qi * TQ;
    if (!warp_dead && (!causal || key0 <= q0 + TQ - 1)) {
      const __nv_bfloat16* qs = tiles[buf][0];
      const __nv_bfloat16* dos = tiles[buf][1];
      const float* lse_s = rows_s[buf][0];
      const float* delta_s = rows_s[buf][1];
      const bool inside = !HAS_BIAS && key0 + 16 <= S && (!causal || key0 + 15 <= q0);
      // two halves of 32 queries: transposed logits, row = key, column =
      // query; each half is k-steps 2 half and 2 half + 1 of dv's and dk's
      // products, so every accumulator sums its k-steps in K6a's order
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p[4][4], ds[4][4];
        zero_acc<4>(p);
        zero_acc<4>(ds);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {  // n-tiles 2 jp and 2 jp + 1 of the half
            const int row = 32 * half + 16 * jp + ((lane >> 4) << 3) + (lane & 7);
            const int col = 16 * ks + (((lane >> 3) & 1) << 3);
            uint32_t bq[4], bo[4];
            ldmatrix_x4<false>(bq, qs + row * LD + col);
            ldmatrix_x4<false>(bo, dos + row * LD + col);
            mma_bf16(p[2 * jp], ka[ks], bq[0], bq[1]);      // k . q^T
            mma_bf16(p[2 * jp + 1], ka[ks], bq[2], bq[3]);
            mma_bf16(ds[2 * jp], va[ks], bo[0], bo[1]);     // v . dO^T
            mma_bf16(ds[2 * jp + 1], va[ks], bo[2], bo[3]);
          }
        }
        if (inside) {
          probabilities<true, HAS_BIAS>(p, ds, lse_s, delta_s, 32 * half, t, q0, keys, pad_k, S,
                                        causal, scale, bias_bh);
        } else {
          probabilities<false, HAS_BIAS>(p, ds, lse_s, delta_s, 32 * half, t, q0, keys, pad_k, S,
                                         causal, scale, bias_bh);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // P^T and dS^T of queries 16 K .. 16 K + 15 as A fragments
          const int K = 2 * half + kk;
          const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                                  pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                                  pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                                  pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
          const uint32_t da[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                                  pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                                  pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                                  pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
          for (int jd = 0; jd < NTD / 2; ++jd) {  // n-tiles 2 jd and 2 jd + 1 of the head dim
            const int row = 16 * K + (((lane >> 3) & 1) << 3) + (lane & 7);
            const int col = 16 * jd + ((lane >> 4) << 3);
            uint32_t bo[4], bq[4];
            ldmatrix_x4<true>(bo, dos + row * LD + col);
            ldmatrix_x4<true>(bq, qs + row * LD + col);
            mma_bf16(dv_acc[2 * jd], pa, bo[0], bo[1]);      // dv += P^T . dO
            mma_bf16(dv_acc[2 * jd + 1], pa, bo[2], bo[3]);
            mma_bf16(dk_acc[2 * jd], da, bq[0], bq[1]);      // dk += dS^T . q
            mma_bf16(dk_acc[2 * jd + 1], da, bq[2], bq[3]);
          }
        }
      }
    }
    if (qi + 1 < nq) {
      store(buf ^ 1);  // read in step i - 1, which every warp has left
      if (qi + 2 < nq) load(qi + 2);
    }
    __syncthreads();
  }
  store_rows<NTD>(dk_acc, scale, dk + head_off, row_stride, key0, S, Dh, g, t);
  store_rows<NTD>(dv_acc, 1.f, dv + head_off, row_stride, key0, S, Dh, g, t);
}

// ------------------------------------------ K6b's streamed design (Dh <= 32)
// flash_bwd_dq_stream_kernel: K6c's streamed design with the roles of queries
// and keys swapped. A block of DQ_WARPS warps per (batch * head,
// DQ_QUERIES-query tile), each warp owning 16 queries, loops over 64-key
// steps up to the causal end:
//   - the q and dO A fragments of the warp's queries are read once from
//     device memory into registers, and so are their lse and delta; k and v
//     of a step are kept once, row-major in bf16: q . k^T and dO . v^T read
//     them by ldmatrix, dS . k reads k by ldmatrix.trans (no second,
//     transposed copy of k);
//   - step i + 1's k, v and padding terms are loaded into registers while
//     step i's products and exponentials run, and stored into the second of
//     two buffers after them: one barrier per step;
//   - the block's last step is the one that holds the session's last real key
//     (a block-wide scan of the pad bytes; with a bias, the last key of the
//     sequence), so steps wholly of padding at the end are never loaded, and
//     a block with no real key writes zeros and leaves; a warp skips each half
//     step whose keys all lie after its queries (causal), and every step when
//     its queries lie beyond S; a half step whose keys lie wholly inside
//     the sequence and, under the causal mask, at or before every query of
//     the warp takes masked_logit's arithmetic without its tests;
//   - query tiles are the slow grid axis, the longest (the last, under the
//     causal mask) first (dq_block_order in ops/attention.py is the Python
//     twin).
// The logits come from the same mma.sync products of the same bf16 q and k
// in the same order as the mma.sync K6b body below, P and dS from the same
// expressions, dS is packed as pack_a_fragments packs it and dq sums the
// four 16-key k-steps of a step in order (a step's two halves of 32 keys are
// k-steps 0-1 and 2-3), step after step: the two give the same bits, and a
// skipped pair is one whose P is exactly 0 there. No atomics.
constexpr int DQ_WARPS = 8;
constexpr int DQ_QUERIES = 16 * DQ_WARPS;
constexpr int DQ_THREADS = 32 * DQ_WARPS;

// dS of a warp's 16 queries (rows[], two a thread) against the 32 keys of a
// half step from key c_half of the step on, in place of the logits q . k^T
// in p and of dO . v^T in ds (acc[j][2hh + qq]: query rows[hh], key c_half +
// 8j + 2t + qq of the step). INSIDE as in probabilities() above.
template <bool INSIDE, bool HAS_BIAS>
__device__ __forceinline__ void dq_probabilities(float (&p)[4][4], float (&ds)[4][4],
                                                 const float* __restrict__ pad_s, int c_half,
                                                 int t, int k0, const int (&rows)[2],
                                                 const float (&lse_r)[2],
                                                 const float (&delta_r)[2], int S, int causal,
                                                 float scale, const float* __restrict__ bias_bh) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c0 = c_half + 8 * j + 2 * t;  // the pair's first key in the step
    const float2 pad2 = *reinterpret_cast<const float2*>(pad_s + c0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const float pad_add = qq ? pad2.y : pad2.x;
        const float l = INSIDE ? p[j][2 * hh + qq] * scale + pad_add
                               : masked_logit<HAS_BIAS>(p[j][2 * hh + qq], scale, rows[hh],
                                                        k0 + c0 + qq, S, causal != 0, pad_add,
                                                        bias_bh);
        const float pv = ex2((l - lse_r[hh]) * LOG2E);
        ds[j][2 * hh + qq] = pv * (ds[j][2 * hh + qq] - delta_r[hh]);
      }
    }
  }
}

template <typename E, int KS, bool HAS_BIAS>
__global__ void __launch_bounds__(DQ_THREADS, 2)
flash_bwd_dq_stream_kernel(const E* __restrict__ q, const E* __restrict__ k,
                           const E* __restrict__ v, const E* __restrict__ d_out,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           const uint8_t* __restrict__ pad, const float* __restrict__ bias,
                           long long bias_sb, long long bias_sh, E* __restrict__ dq, int S,
                           int H, int Dh, int nq, int causal, float scale) {
  constexpr int LD = Tile<KS>::LD, NTD = Tile<KS>::NTD;
  constexpr int C4 = Tile<KS>::DP / 4;         // pieces of 4 values of a padded row
  constexpr int PIECES = 2 * TK * C4;          // of k and v in a step
  constexpr int PER = PIECES / DQ_THREADS;     // a thread's
  static_assert(PIECES % DQ_THREADS == 0 && TK <= DQ_THREADS, "a step's loads");
  __shared__ __align__(16) __nv_bfloat16 tiles[2][2][TK * LD];  // [buffer][k, v][key][LD]
  __shared__ __align__(16) float pad_s[2][TK];                   // [buffer][key]
  __shared__ int last_s[DQ_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int BH = gridDim.x / nq, qt = nq - 1 - blockIdx.x / BH, bh = blockIdx.x % BH;
  const int b = bh / H, h = bh - b * H;
  const int row_stride = H * Dh;
  const size_t head_off = ((size_t)b * S * H + h) * Dh;
  const float* bias_bh = HAS_BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
  const uint8_t* pad_b = pad != nullptr ? pad + (size_t)b * S : nullptr;
  const bool scan = !HAS_BIAS && pad_b != nullptr;

  const int q0 = qt * DQ_QUERIES, row0 = q0 + warp * 16;  // the block's and the warp's first query
  // keys from kcap on lie after every query of the block (causal) or beyond S
  const int kcap = causal ? min(q0 + DQ_QUERIES, S) : S;
  // the last real key before kcap: P is 0 for every key after it
  if (scan) {
    int mine = -1;
    for (int i = tid; i < kcap; i += DQ_THREADS) {
      if (pad_b[i]) mine = i;
    }
    mine = __reduce_max_sync(0xffffffffu, mine);
    if (lane == 0) last_s[warp] = mine;
  }
  const int rows[2] = {row0 + g, row0 + g + 8};
  uint32_t qa[KS][4], oa[KS][4];  // this warp's 16 queries of q and dO as A fragments
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i & 1], col = 16 * ks + 8 * (i >> 1) + 2 * t;
      qa[ks][i] = pair_at(q + head_off, row_stride, row, col, S, Dh);
      oa[ks][i] = pair_at(d_out + head_off, row_stride, row, col, S, Dh);
    }
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool ok = rows[hh] < S;
    lse_r[hh] = ok ? lse[(size_t)bh * S + rows[hh]] : LSE_MASKED;
    delta_r[hh] = ok ? delta[(size_t)bh * S + rows[hh]] : 0.f;
  }
  float dq_acc[NTD][4];
  zero_acc<NTD>(dq_acc);
  // the head dim's padding columns stay zero: the stores below never write them
  for (int i = tid; i < 2 * 2 * TK * LD / 2; i += DQ_THREADS) {
    reinterpret_cast<uint32_t*>(&tiles[0][0][0])[i] = 0u;
  }

  // A step's piece i: tile i / (TK C4) (k, v), row (i / C4) % TK, 4 values
  // (i % C4) of it; consecutive threads read consecutive pieces of a row.
  // Keys beyond S are stored as zeros. The pieces wait in registers as
  // loaded and are rounded as they are stored.
  const int d4n = Dh / 4;
  typename Raw<E>::type pre[PER];
  float pre_pad = 0.f;
  auto load = [&](int ki) {
    const int k0 = ki * TK;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * DQ_THREADS, c = i % C4, r = (i / C4) % TK;
      pre[j] = {};
      if (k0 + r < S && c < d4n) {
        const E* src = (i < TK * C4 ? k : v) + head_off;
        pre[j] = load4(src + (size_t)(k0 + r) * row_stride + 4 * c);
      }
    }
    if (tid < TK) pre_pad = hw::pad_term_of(pad_b, k0 + tid, S);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * DQ_THREADS, c = i % C4, r = (i / C4) % TK;
      if (c < d4n) {
        *reinterpret_cast<uint2*>(&tiles[buf][i / (TK * C4)][r * LD + 4 * c]) = to_bf16x4(pre[j]);
      }
    }
    if (tid < TK) pad_s[buf][tid] = pre_pad;
  };

  load(0);
  __syncthreads();  // the zero fill and the scan are done
  int kend = kcap;  // keys from kend on have P = 0 for every query of the block
  if (scan) {
    kend = 0;
#pragma unroll
    for (int w = 0; w < DQ_WARPS; ++w) kend = max(kend, last_s[w] + 1);
  }
  const int nk = (kend + TK - 1) / TK;
  if (nk == 0) {  // no real key: dq = 0
    store_rows<NTD>(dq_acc, 1.f, dq + head_off, row_stride, row0, S, Dh, g, t);
    return;
  }
  store(0);
  if (1 < nk) load(1);
  __syncthreads();

  const int row_last = row0 + 15;  // the warp's last query
  for (int ki = 0; ki < nk; ++ki) {
    const int buf = ki & 1, k0 = ki * TK;
    if (row0 < S && (!causal || k0 <= row_last)) {
      const __nv_bfloat16* ks_ = tiles[buf][0];
      const __nv_bfloat16* vs = tiles[buf][1];
      const float* pads = pad_s[buf];
      // two halves of 32 keys: logits row = query, column = key; each half is
      // k-steps 2 half and 2 half + 1 of dS . k, so dq sums its k-steps in
      // the mma.sync body's order
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kh0 = k0 + 32 * half;  // the half's first key
        if (causal && kh0 > row_last) continue;
        float p[4][4], ds[4][4];
        zero_acc<4>(p);
        zero_acc<4>(ds);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {  // n-tiles 2 jp and 2 jp + 1 of the half
            const int row = 32 * half + 16 * jp + ((lane >> 4) << 3) + (lane & 7);
            const int col = 16 * ks + (((lane >> 3) & 1) << 3);
            uint32_t bk[4], bv[4];
            ldmatrix_x4<false>(bk, ks_ + row * LD + col);
            ldmatrix_x4<false>(bv, vs + row * LD + col);
            mma_bf16(p[2 * jp], qa[ks], bk[0], bk[1]);      // q . k^T
            mma_bf16(p[2 * jp + 1], qa[ks], bk[2], bk[3]);
            mma_bf16(ds[2 * jp], oa[ks], bv[0], bv[1]);     // dO . v^T
            mma_bf16(ds[2 * jp + 1], oa[ks], bv[2], bv[3]);
          }
        }
        if (!HAS_BIAS && kh0 + 32 <= S && (!causal || kh0 + 31 <= row0)) {
          dq_probabilities<true, HAS_BIAS>(p, ds, pads, 32 * half, t, k0, rows, lse_r, delta_r,
                                           S, causal, scale, bias_bh);
        } else {
          dq_probabilities<false, HAS_BIAS>(p, ds, pads, 32 * half, t, k0, rows, lse_r, delta_r,
                                            S, causal, scale, bias_bh);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // dS of keys 16 K .. 16 K + 15 as an A fragment (pack_a_fragments)
          const int K = 2 * half + kk;
          const uint32_t da[4] = {pack_bf16(ds[2 * kk][0], ds[2 * kk][1]),
                                  pack_bf16(ds[2 * kk][2], ds[2 * kk][3]),
                                  pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]),
                                  pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3])};
#pragma unroll
          for (int jd = 0; jd < NTD / 2; ++jd) {  // n-tiles 2 jd and 2 jd + 1 of the head dim
            const int row = 16 * K + (((lane >> 3) & 1) << 3) + (lane & 7);
            const int col = 16 * jd + ((lane >> 4) << 3);
            uint32_t bk[4];
            ldmatrix_x4<true>(bk, ks_ + row * LD + col);
            mma_bf16(dq_acc[2 * jd], da, bk[0], bk[1]);      // dq += dS . k
            mma_bf16(dq_acc[2 * jd + 1], da, bk[2], bk[3]);
          }
        }
      }
    }
    if (ki + 1 < nk) {
      store(buf ^ 1);  // read in step i - 1, which every warp has left
      if (ki + 2 < nk) load(ki + 2);
    }
    __syncthreads();
  }
  store_rows<NTD>(dq_acc, scale, dq + head_off, row_stride, row0, S, Dh, g, t);
}

// ------------------------------------------------------------ Hopper design
// flash_bwd_fused_hw_kernel (K6a for head dims of 33 to 64, padded to DP =
// 64): a block of 384 threads per (batch * head, 128-key tile). Warpgroup 2
// stores the k and v tiles and the keys' padding terms once, then for every
// 64-query step from the causal start the q and dO tiles and the queries'
// lse and delta into a ring slot (bf16, image layout, through the staging
// pieces of flash_hopper.cuh's Stager);
// warpgroups 0 and 1 own 64 keys each. Per step, by wgmma: S^T = k . q^T and
// dP^T = v . dO^T from shared memory (m64n64), then P^T and dS^T in
// registers, then dv += P^T . dO and dk += dS^T . q with P^T and dS^T as
// register A fragments and q, dO read MN-major. dS^T also goes, in bf16
// (the bits dk used), to the warpgroup's own staging tile, from which the
// warpgroup forms dS . k over its 64 keys (both operands MN-major) and
// writes it to the dq partial of its 64 keys: the partials are per 64 keys,
// as the mma.sync kernel's, and flash_dq_reduce_kernel adds them in order.
// No warpgroup waits for the other, no wgmma sits on a branch, and nothing
// needs atomics: the same bits on every call.
constexpr int BWD_STAGES = 4;  // ring slots of q and dO
constexpr int BWD_NSTG = 4;    // staging pieces

template <typename E, bool HAS_BIAS>
__global__ void __launch_bounds__(hw::HW_THREADS, 1)
flash_bwd_fused_hw_kernel(const E* __restrict__ q, const E* __restrict__ k,
                          const E* __restrict__ v, const E* __restrict__ d_out,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const uint8_t* __restrict__ pad, const float* __restrict__ bias,
                          long long bias_sb, long long bias_sh, float* __restrict__ dq_part,
                          E* __restrict__ dk, E* __restrict__ dv, int B, int S, int H, int Dh,
                          int nk, int causal, float scale) {
  using namespace t4r::flash::hw;
  constexpr int DP = 64, QR = 64;              // head dim, queries per step
  constexpr int TB = SLAB_BYTES;               // a 128-row tile of 64 values
  constexpr int SLOT = TB + 1024;              // q and dO (64 rows each), lse and delta
  constexpr int STAGES = BWD_STAGES, NSTG = BWD_NSTG;
  using Stg = Stager<DP, NSTG, E>;
  static_assert(Stg::R == QR, "a step's q or dO is one staging piece");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + TB;
  uint8_t* staging = vs + TB;  // per warpgroup two 64-row tiles of dS^T (keys x queries)
  float* pad_s = reinterpret_cast<float*>(staging + 2 * TB);
  uint8_t* ring = staging + 2 * TB + 1024;
  uint8_t* stage_ring = ring + STAGES * SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_ring + Stg::BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* once = empty + STAGES;
  init_store_ring(STAGES, full, empty, once);

  // key tiles are the slow grid axis, the longest (the first, under the
  // causal mask) first, so that the short ones fill the card's tail
  const int BH = gridDim.x / nk, kt = blockIdx.x / BH, bh = blockIdx.x - kt * BH;
  const int b = bh / H, h = bh - b * H;
  const int row_stride = H * Dh;
  const size_t head_off = ((size_t)b * S * H + h) * Dh;
  const int nq = (S + QR - 1) / QR;
  // query steps wholly before this key tile see none of its keys
  const int qi_begin = causal ? kt * (T / QR) : 0;
  const int steps = nq - qi_begin;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // k's and v's pieces once, then each step's q piece and dO piece, NSTG - 1
    // of them in flight ahead of the one being rounded
    Stg sg(stage_ring, threadIdx.x - 256);
    const int p = sg.p;
    constexpr int TP = T / QR;  // pieces of the k or v tile
    const int pieces = 2 * TP + 2 * steps;
    auto issue = [&](int n) {
      if (n >= pieces) return sg.skip();
      if (n < 2 * TP) {
        return sg.issue((n < TP ? k : v) + head_off, row_stride, kt * T + (n % TP) * QR, S, Dh);
      }
      const int i = (n - 2 * TP) / 2;
      sg.issue(((n - 2 * TP) % 2 ? d_out : q) + head_off, row_stride, (qi_begin + i) * QR, S, Dh);
    };
    for (int n = 0; n < NSTG - 1; ++n) issue(n);
    const uint8_t* pad_b = pad != nullptr ? pad + (size_t)b * S : nullptr;
    const float pad_term = pad_term_of(pad_b, kt * T + p, S);
    const float* lse_bh = lse + (size_t)bh * S;
    const float* delta_bh = delta + (size_t)bh * S;
    float row_lse = 0.f, row_delta = 0.f;
    for (int n = 0; n < pieces; ++n) {
      issue(n + NSTG - 1);
      if (n < 2 * TP) {
        sg.round(n < TP ? ks : vs, (n % TP) * QR);
        if (n == 2 * TP - 1) {
          pad_s[p] = pad_term;
          stored(once);
        }
        continue;
      }
      const int i = (n - 2 * TP) / 2, st = i % STAGES, q0 = (qi_begin + i) * QR;
      uint8_t* slot = ring + st * SLOT;
      if ((n - 2 * TP) % 2 == 0) {
        if (p < QR) {  // read while q is rounded; rows beyond the sequence get the
          const bool ok = q0 + p < S;  // masked sentinel: their P is 0
          row_lse = ok ? lse_bh[q0 + p] : LSE_MASKED;
          row_delta = ok ? delta_bh[q0 + p] : 0.f;
        }
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        sg.round(slot, 0);
        continue;
      }
      sg.round(slot + TB / 2, 0);
      float* rows_s = reinterpret_cast<float*>(slot + TB);
      if (p < QR) {
        rows_s[p] = row_lse;
        rows_s[QR + p] = row_delta;
      }
      stored(&full[st]);
    }
    cp_async_wait<0>();
    return;
  }

  const float* bias_bh = HAS_BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int key_row = warp * 16 + g;  // this thread's first key in the warpgroup's 64
  const int key0 = kt * T + wg * 64;  // the warpgroup's first key
  const int keys[2] = {key0 + key_row, key0 + key_row + 8};
  const uint32_t ka = smem_addr(ks) + wg * 64 * 128, va = smem_addr(vs) + wg * 64 * 128;
  // the warpgroup's 64 keys form dq partial key0 / 64 (none when all lie beyond S)
  float* part = key0 < S
                    ? dq_part + ((size_t)(key0 / QR) * B + b) * S * row_stride + (size_t)h * Dh
                    : nullptr;
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(once, 0);
  const float pad_k[2] = {pad_s[wg * 64 + key_row], pad_s[wg * 64 + key_row + 8]};
  for (int i = 0; i < steps; ++i) {
    const int st = i % STAGES, q0 = (qi_begin + i) * QR;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint8_t* slot = ring + st * SLOT;
    const uint32_t qa = smem_addr(slot), da = qa + TB / 2;
    const float* lse_s = reinterpret_cast<const float*>(slot + TB);
    const float* delta_s = lse_s + QR;

    // transposed tiles: row = key (this warpgroup's 64), column = query
    float p[32], ds[32];
    fence_regs(p);
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n64<0, 0>(p, kmajor_desc(ka, kk), kmajor_desc(qa, kk), kk > 0);  // k . q^T
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss_n64<0, 0>(ds, kmajor_desc(va, kk), kmajor_desc(da, kk), kk > 0);  // v . dO^T
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(p);
    fence_regs(ds);
    // keys wholly inside the sequence and, under the causal mask, at or
    // before every query of the step take only the scale and the padding
    // terms (masked_logit's arithmetic without its tests)
    const bool inside = !HAS_BIAS && key0 + 64 <= S && (!causal || key0 + 63 <= q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int c = 8 * j + 2 * t + qq;  // query within the step
          const float raw = p[4 * j + 2 * hh + qq];
          const float l = inside ? raw * scale + pad_k[hh]
                                 : masked_logit<HAS_BIAS>(raw, scale, q0 + c, keys[hh], S,
                                                          causal != 0, pad_k[hh], bias_bh);
          const float pv = ex2((l - lse_s[c]) * LOG2E);
          p[4 * j + 2 * hh + qq] = pv;
          ds[4 * j + 2 * hh + qq] = pv * (ds[4 * j + 2 * hh + qq] - delta_s[c]);
        }
      }
    }
    uint32_t pa[QR / 16][4], dsa[QR / 16][4];  // P^T and dS^T as A fragments
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) {
      acc_to_a(p, kk, pa[kk]);
      acc_to_a(ds, kk, dsa[kk]);
    }
    // dS^T into this step's staging tile of the warpgroup (rows = its keys)
    uint8_t* stage = staging + (2 * wg + (i & 1)) * (TB / 2);
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // dsa[kk][hh]: row key_row + 8hh, queries 16kk + 2t, +1; [2 + hh]: 16kk + 8 + 2t, +1
        *reinterpret_cast<uint32_t*>(stage + image_offset(key_row + 8 * hh, 16 * kk + 2 * t, DP)) =
            dsa[kk][hh];
        *reinterpret_cast<uint32_t*>(stage + image_offset(key_row + 8 * hh, 16 * kk + 8 + 2 * t,
                                                          DP)) = dsa[kk][2 + hh];
      }
    }
    fence_proxy_async();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) wgmma_rs_n64(dv_acc, pa[kk], mnmajor_desc(da, kk));
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) wgmma_rs_n64(dk_acc, dsa[kk], mnmajor_desc(qa, kk));
    wgmma_commit();
    named_barrier(1 + wg, 128);  // the warpgroup's dS^T is stored
    // dq partial (64 queries x DP) = dS . k over the warpgroup's 64 keys
    float dq[32];
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      wgmma_ss_n64<1, 1>(dq, mnmajor_desc(smem_addr(stage), kk), mnmajor_desc(ka, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    release(empty, st);
    // dq[4j + 2hh + qq]: query q0 + 16 warp + g + 8hh, d = 8j + 2t + qq
    if (part != nullptr) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + warp * 16 + g + 8 * hh;
        if (row >= S) continue;
        float* dst = part + (size_t)row * row_stride;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 8 * j + 2 * t;
          if (d < Dh) {
            *reinterpret_cast<float2*>(dst + d) = make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
          }
        }
      }
    }
  }
  // dk_acc, dv_acc[4j + 2hh + qq]: key keys[hh], d = 8j + 2t + qq
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (keys[hh] >= S) continue;
    E* dkr = dk + head_off + (size_t)keys[hh] * row_stride;
    E* dvr = dv + head_off + (size_t)keys[hh] * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < Dh) {
        store2(dkr + d, dk_acc[4 * j + 2 * hh] * scale, dk_acc[4 * j + 2 * hh + 1] * scale);
        store2(dvr + d, dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// dq = scale * sum over the key tiles, in order, of dq_part[key tile], in
// q's type (rounded once): the tiles a query row's causal mask leaves out
// were never written and are not read. Four values a thread.
template <typename E>
__global__ void flash_dq_reduce_kernel(const float4* __restrict__ part, E* __restrict__ dq,
                                       size_t total4, int S, int row_stride, int nk, int causal,
                                       float scale) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  const int srow = (int)((i * 4 / row_stride) % S);
  const int last = causal ? min(nk - 1, (srow / TQ * TQ + TQ - 1) / TK) : nk - 1;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt <= last; ++kt) {
    const float4 x = part[(size_t)kt * total4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(dq + 4 * i, make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale));
}

template <typename E, int KS, bool HAS_BIAS>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                    const E* __restrict__ d_out, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ pad,
                    const float* __restrict__ bias, long long bias_sb, long long bias_sh,
                    E* __restrict__ dq, int S, int H, int Dh, int nq, int causal, float scale) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD, NTD = Tile<KS>::NTD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* dos = qs + 64 * LD;                               // [64][LD]
  __nv_bfloat16* ks_ = dos + 64 * LD;                              // [64][LD]
  __nv_bfloat16* vs = ks_ + 64 * LD;                               // [64][LD]
  __nv_bfloat16* kt_t = vs + 64 * LD;                              // [DP][LDT]
  float* pad_s = reinterpret_cast<float*>(kt_t + DP * LDT);        // [64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / nq, qi = blockIdx.x - bh * nq;
  const int b = bh / H, h = bh - b * H;
  const int row_stride = H * Dh;
  const size_t head_off = ((size_t)b * S * H + h) * Dh;
  const float* bias_bh = HAS_BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
  const uint8_t* pad_b = pad != nullptr ? pad + (size_t)b * S : nullptr;

  load_tile<KS, true, false>(q + head_off, row_stride, qi * TQ, S, Dh, qs, nullptr, tid);
  load_tile<KS, true, false>(d_out + head_off, row_stride, qi * TQ, S, Dh, dos, nullptr, tid);

  const int row0 = qi * TQ + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const bool ok = rows[hh] < S;
    lse_r[hh] = ok ? lse[(size_t)bh * S + rows[hh]] : LSE_MASKED;
    delta_r[hh] = ok ? delta[(size_t)bh * S + rows[hh]] : 0.f;
  }
  float dq_acc[NTD][4];
  zero_acc<NTD>(dq_acc);

  const uint32_t* qs32 = reinterpret_cast<const uint32_t*>(qs);
  const uint32_t* dos32 = reinterpret_cast<const uint32_t*>(dos);
  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(ks_);
  const uint32_t* vs32 = reinterpret_cast<const uint32_t*>(vs);
  const uint32_t* ktt32 = reinterpret_cast<const uint32_t*>(kt_t);

  const int nk = (S + TK - 1) / TK;
  const int kt_end = causal ? min(nk - 1, (qi * TQ + TQ - 1) / TK) : nk - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    __syncthreads();  // the previous key tile is consumed (and q, dO are stored)
    load_tile<KS, true, true>(k + head_off, row_stride, kt * TK, S, Dh, ks_, kt_t, tid);
    load_tile<KS, true, false>(v + head_off, row_stride, kt * TK, S, Dh, vs, nullptr, tid);
    load_pad_terms(pad_b, kt * TK, S, pad_s, tid);
    __syncthreads();

    float p[8][4], ds[8][4];
    zero_acc<8>(p);
    zero_acc<8>(ds);
    mma_tile_smem<KS, 8>(qs32, LD / 2, warp * 16, ks32, LD / 2, g, t, p);     // q . k^T
    mma_tile_smem<KS, 8>(dos32, LD / 2, warp * 16, vs32, LD / 2, g, t, ds);   // dO . v^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int c = 8 * j + 2 * t + qq;  // key within the tile
          const float l = masked_logit<HAS_BIAS>(p[j][2 * hh + qq], scale, rows[hh],
                                                 kt * TK + c, S, causal != 0, pad_s[c], bias_bh);
          const float pv = ex2((l - lse_r[hh]) * LOG2E);
          ds[j][2 * hh + qq] = pv * (ds[j][2 * hh + qq] - delta_r[hh]);
        }
      }
    }
    uint32_t frag[4][4];
    pack_a_fragments(ds, frag);
    mma_tile<4, NTD>(frag, ktt32, LDT / 2, g, t, dq_acc);  // dq += dS . k
  }
  store_rows<NTD>(dq_acc, scale, dq + head_off, row_stride, row0, S, Dh, g, t);
}

struct Args {
  const Elem *q, *k, *v, *d_out;
  const float *lse, *delta;
  const uint8_t* pad;
  const float* bias;
  long long bias_sb, bias_sh;
  int B, S, H, Dh, causal;
  float scale;
  cudaStream_t st;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// dq from the partials of both K6a designs: ceil(S / 64) of them
cudaError_t launch_dq_reduce(const Args& a, const float* dq_part, Elem* dq) {
  const size_t total4 = (size_t)a.B * a.S * a.H * a.Dh / 4;
  const int threads = 256;
  flash_dq_reduce_kernel<Elem><<<(unsigned)((total4 + threads - 1) / threads), threads, 0, a.st>>>(
      reinterpret_cast<const float4*>(dq_part), dq, total4, a.S,
      a.H * a.Dh, (a.S + TK - 1) / TK, a.causal, a.scale);
  return cudaGetLastError();
}

template <bool HAS_BIAS>
cudaError_t launch_fused_hw(const Args& a, float* dq_part, Elem* dq, Elem* dk, Elem* dv) {
  constexpr int TB = hopper::SLAB_BYTES, STAGES = BWD_STAGES;
  constexpr int smem = 1024 + 4 * TB + 1024 + STAGES * (TB + 1024) +
                       hw::Stager<64, BWD_NSTG, Elem>::BYTES + 8 * (2 * STAGES + 1);
  static_assert(smem <= hopper::MAX_SMEM, "K6a's shared memory");
  auto kernel = flash_bwd_fused_hw_kernel<Elem, HAS_BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nk = (a.S + hw::T - 1) / hw::T;
  kernel<<<(unsigned)((size_t)a.B * a.H * nk), hw::HW_THREADS, smem, a.st>>>(
      a.q, a.k, a.v, a.d_out, a.lse, a.delta, a.pad, a.bias, a.bias_sb, a.bias_sh, dq_part, dk,
      dv, a.B, a.S, a.H, a.Dh, nk, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_dq_reduce(a, dq_part, dq);
}

template <int KS, bool HAS_BIAS, bool FUSED>
cudaError_t launch_dkv(const Args& a, float* dq_part, Elem* dq, Elem* dk, Elem* dv) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD;
  const int smem = (4 * 64 * LD + (FUSED ? 3 : 2) * DP * LDT + (FUSED ? TQ * LDT : 0)) *
                       (int)sizeof(__nv_bfloat16) +
                   (2 * TQ + TK) * (int)sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<Elem, KS, HAS_BIAS, FUSED>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nk = (a.S + TK - 1) / TK;
  kernel<<<(unsigned)((size_t)a.B * a.H * nk), FTHREADS, smem, a.st>>>(
      a.q, a.k, a.v, a.d_out, a.lse, a.delta, a.pad, a.bias, a.bias_sb, a.bias_sh, dq_part, dk,
      dv, a.B, a.S, a.H, a.Dh, nk, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !FUSED) return err;
  return launch_dq_reduce(a, dq_part, dq);
}

template <int KS, bool HAS_BIAS>
cudaError_t launch_dq(const Args& a, Elem* dq) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD;
  const int smem =
      (4 * 64 * LD + DP * LDT) * (int)sizeof(__nv_bfloat16) + TK * (int)sizeof(float);
  auto kernel = flash_bwd_dq_kernel<Elem, KS, HAS_BIAS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nq = (a.S + TQ - 1) / TQ;
  kernel<<<(unsigned)((size_t)a.B * a.H * nq), FTHREADS, smem, a.st>>>(
      a.q, a.k, a.v, a.d_out, a.lse, a.delta, a.pad, a.bias, a.bias_sb, a.bias_sh, dq, a.S, a.H,
      a.Dh, nq, a.causal, a.scale);
  return cudaGetLastError();
}

template <int KS, bool HAS_BIAS>
cudaError_t launch_dkv_stream(const Args& a, Elem* dk, Elem* dv) {
  const int nk = (a.S + DKV_KEYS - 1) / DKV_KEYS;
  flash_bwd_dkv_stream_kernel<Elem, KS, HAS_BIAS>
      <<<(unsigned)((size_t)a.B * a.H * nk), DKV_THREADS, 0, a.st>>>(
      a.q, a.k, a.v, a.d_out, a.lse, a.delta, a.pad, a.bias, a.bias_sb, a.bias_sh, dk, dv, a.S,
      a.H, a.Dh, nk, a.causal, a.scale);
  return cudaGetLastError();
}

template <int KS, bool HAS_BIAS>
cudaError_t launch_dq_stream(const Args& a, Elem* dq) {
  const int nq = (a.S + DQ_QUERIES - 1) / DQ_QUERIES;
  flash_bwd_dq_stream_kernel<Elem, KS, HAS_BIAS>
      <<<(unsigned)((size_t)a.B * a.H * nq), DQ_THREADS, 0, a.st>>>(
      a.q, a.k, a.v, a.d_out, a.lse, a.delta, a.pad, a.bias, a.bias_sb, a.bias_sh, dq, a.S, a.H,
      a.Dh, nq, a.causal, a.scale);
  return cudaGetLastError();
}

// mode 0: K6a (fused), 1: K6b (dq), 2: K6c (dk, dv), 3: K6a on the Hopper
// design, 4: K6c on the streamed design, 5: K6b on the streamed design
template <int KS, bool HAS_BIAS>
cudaError_t launch_mode(int mode, const Args& a, float* dq_part, Elem* dq, Elem* dk,
                        Elem* dv) {
  if (mode == 0) return launch_dkv<KS, HAS_BIAS, true>(a, dq_part, dq, dk, dv);
  if (mode == 1) return launch_dq<KS, HAS_BIAS>(a, dq);
  return launch_dkv<KS, HAS_BIAS, false>(a, nullptr, nullptr, dk, dv);
}

template <bool HAS_BIAS>
cudaError_t launch_dh(int mode, const Args& a, float* dq_part, Elem* dq, Elem* dk, Elem* dv) {
  if (mode == 3) {  // Dh is rounded up to 64
    if (a.Dh > 64) return cudaErrorInvalidValue;
    return launch_fused_hw<HAS_BIAS>(a, dq_part, dq, dk, dv);
  }
  if (mode == 4 || mode == 5) {  // Dh is rounded up to 16 or 32
    if (a.Dh > STREAM_MAX_DH) return cudaErrorInvalidValue;
    if (mode == 5) {
      return a.Dh <= 16 ? launch_dq_stream<1, HAS_BIAS>(a, dq) : launch_dq_stream<2, HAS_BIAS>(a, dq);
    }
    return a.Dh <= 16 ? launch_dkv_stream<1, HAS_BIAS>(a, dk, dv)
                      : launch_dkv_stream<2, HAS_BIAS>(a, dk, dv);
  }
  // Dh is rounded up to 16, 32, 64 or 128 (zero padded)
  if (a.Dh <= 16) return launch_mode<1, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
  if (a.Dh <= 32) return launch_mode<2, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
  if (a.Dh <= 64) return launch_mode<4, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
  return launch_mode<8, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
}

int launch_checked(int mode, const Elem* q, const Elem* k, const Elem* v, const Elem* d_out,
                   const float* lse, const float* delta, const uint8_t* pad, const float* bias,
                   long long bias_sb, long long bias_sh, float* dq_part, Elem* dq, Elem* dk,
                   Elem* dv, int B, int S, int H, int Dh, int causal, float scale,
                   void* stream) {
  if (Dh < 4 || Dh > 128 || Dh % 4 != 0 || B < 1 || S < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {q, k, v, d_out, lse, delta, pad, bias, bias_sb, bias_sh,
                  B, S, H, Dh, causal, scale, static_cast<cudaStream_t>(stream)};
  return (int)(bias != nullptr ? launch_dh<true>(mode, a, dq_part, dq, dk, dv)
                               : launch_dh<false>(mode, a, dq_part, dq, dk, dv));
}

}  // namespace

using t4r::flash::Elem;

extern "C" {

int t4r_flash_tile_rows() { return t4r::flash::TQ; }

// The bytes of a stored value of q, k, v, dO, dq, dk and dv in this library:
// 4 (f32) or 2 (the bf16 form, built with -DT4R_FLASH_BF16).
int t4r_flash_elem_bytes() { return (int)sizeof(Elem); }

// All three launch on `stream` and return the first CUDA error (0 when every
// launch was accepted). q, k, v, d_out, dq, dk, dv: (B, S, H, Dh) of Elem,
// contiguous and aligned to 4 values; lse, delta: (B * H, S) float32; pad:
// (B, S) bytes (non-zero = a real key) or null; bias: float32 with strides
// bias_sb / bias_sh (elements; 0 on a broadcast axis) between its (S, S)
// planes, or null. The caller checks shapes (Dh a multiple of 4 up to 128)
// and allocates every buffer.

// K6a: dq, dk, dv from one recomputation, with wgmma on the Hopper design
// (Dh up to 64). dq_part: (key tiles, B, S, H, Dh) float32 scratch, key
// tiles = ceil(S / 64) in both designs.
int t4r_flash_bwd_fused(const Elem* q, const Elem* k, const Elem* v, const Elem* d_out,
                        const float* lse, const float* delta, const uint8_t* pad,
                        const float* bias, long long bias_sb, long long bias_sh, float* dq_part,
                        Elem* dq, Elem* dk, Elem* dv, int B, int S, int H, int Dh, int causal,
                        float scale, int wgmma, void* stream) {
  return launch_checked(wgmma ? 3 : 0, q, k, v, d_out, lse, delta, pad, bias, bias_sb, bias_sh,
                        dq_part, dq, dk, dv, B, S, H, Dh, causal, scale, stream);
}

// K6b: dq alone, on the streamed design (`streamed`, head dims up to 32;
// refused above) or the mma.sync body above.
int t4r_flash_bwd_dq(const Elem* q, const Elem* k, const Elem* v, const Elem* d_out,
                     const float* lse, const float* delta, const uint8_t* pad, const float* bias,
                     long long bias_sb, long long bias_sh, Elem* dq, int B, int S, int H, int Dh,
                     int causal, float scale, int streamed, void* stream) {
  return launch_checked(streamed ? 5 : 1, q, k, v, d_out, lse, delta, pad, bias, bias_sb, bias_sh,
                        nullptr, dq, nullptr, nullptr, B, S, H, Dh, causal, scale, stream);
}

// K6c: dk and dv alone, on the streamed design (`streamed`, head dims up to
// 32; refused above) or the mma.sync body above.
int t4r_flash_bwd_dkv(const Elem* q, const Elem* k, const Elem* v, const Elem* d_out,
                      const float* lse, const float* delta, const uint8_t* pad,
                      const float* bias, long long bias_sb, long long bias_sh, Elem* dk,
                      Elem* dv, int B, int S, int H, int Dh, int causal, float scale,
                      int streamed, void* stream) {
  return launch_checked(streamed ? 4 : 2, q, k, v, d_out, lse, delta, pad, bias, bias_sb, bias_sh,
                        nullptr, nullptr, dk, dv, B, S, H, Dh, causal, scale, stream);
}

// The widest head dim the streamed designs of K6b and K6c take.
int t4r_flash_stream_max_dh() { return STREAM_MAX_DH; }

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
