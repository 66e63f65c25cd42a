// Flash attention forward (kernel K5 of the port).
//
//   out = softmax(q . k^T * Dh^-1/2 + masks + bias) . v
// by an online softmax over key tiles: the (S, S) probabilities never reach
// device memory. q, k, v are (B, S, H, Dh) float32, rounded to bf16 on the
// way to shared memory; products accumulate in f32; the scale is applied in
// f32 after the product; P is rounded to bf16 before P . v. A row with no
// valid key gives 0. lse (B * H, S) is kept for the backward, with the
// sentinel +2e9 on such rows.
//
// Replaces: transformers4rec_tpu/ops/attention.py:_make_kernel (launched by
// _flash_forward through pl.pallas_call, attention.py:449).
//
// Bound on an H100 at the long-session shape (B=32, S=256, H=16, Dh=12,
// causal): q, k, v and out are 4 x 6.3 MB = 25 MB, 7.5 us at 3.35 TB/s; the
// two products are 2 x 2 x 512 x 256 x 256 x 16 (Dh padded to the mma's
// depth) = 2.1 GFLOP dense, half of it under the causal mask, 1-2 us at the
// 989 TFLOP/s bf16 rate; 17 M exponentials are 4 us on the special-function
// units. The bytes bound it. At (4, 2048, 8, 64) the products are 34 GFLOP
// dense and the tensor cores bound it.
//
// Design. The TPU kernel walks the key tiles as a sequential grid axis and
// carries (max, sum, acc) in VMEM scratch between grid steps. Hopper blocks
// share nothing, so one block owns a (batch * head, 64-query tile) and loops
// over its key tiles with the carry in registers: 2,048 blocks at the shape
// above. Each of 4 warps holds 16 queries: its q fragments stay in registers
// for the whole loop; a key tile's k (row-major) and v (transposed) are read
// as f32 straight from the (B, S, H, Dh) layout, rounded, and stored to
// shared memory, so no cast or transpose pass runs before the kernel; the
// logits, the softmax update and the bf16 P fragments never leave registers
// (the accumulator layout of q . k^T is the A layout of P . v). Key tiles
// wholly in a query tile's future are skipped under the causal mask. The
// head dim is padded with zeros to 16, 32, 64 or 128. mma.sync.m16n8k16 does
// the products.
//
// A second design for Hopper (flash_fwd_hw_kernel below, flash_hopper.cuh):
// a producer warpgroup copies f32 rows by cp.async into staging pieces and
// rounds them into 128-row tiles in the swizzled bf16 layout of hopper.cuh,
// through a ring of slots, and two consumer warpgroups take both products on
// wgmma. On an NVIDIA H100 80GB HBM3 at 700 W it takes 0.132 ms at
// (4, 2048, 8, 64), causal, against this kernel's 0.27, but 0.078 ms at
// (32, 256, 16, 12) against 0.039: 1,024 short blocks with the head dim
// padded from 12 to 64; at (32, 256, 16, 32) this kernel still wins (PERF.md).
// ops/attention.py:uses_wgmma picks: the Hopper design for head dims 33-64.

#include "flash_hopper.cuh"

namespace {

using namespace t4r;
using namespace t4r::flash;

template <int KS, bool HAS_BIAS>
__global__ void __launch_bounds__(FTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const uint8_t* __restrict__ pad,
                 const float* __restrict__ bias, long long bias_sb, long long bias_sh,
                 float* __restrict__ out, float* __restrict__ lse, int S, int H, int Dh, int nq,
                 int causal, float scale) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD, NTD = Tile<KS>::NTD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* ks_ = qs + 64 * LD;                               // [64][LD]
  __nv_bfloat16* vt = ks_ + 64 * LD;                               // [DP][LDT]
  float* pad_s = reinterpret_cast<float*>(vt + DP * LDT);          // [64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / nq, qi = blockIdx.x - bh * nq;
  const int b = bh / H, h = bh - b * H;
  const int row_stride = H * Dh;
  const size_t head_off = ((size_t)b * S * H + h) * Dh;  // (b, 0, h, 0)
  const float* bias_bh = HAS_BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
  const uint8_t* pad_b = pad != nullptr ? pad + (size_t)b * S : nullptr;

  load_tile<KS, true, false>(q + head_off, row_stride, qi * TQ, S, Dh, qs, nullptr, tid);
  __syncthreads();
  uint32_t qa[KS][4];
  load_a_fragments<KS>(reinterpret_cast<const uint32_t*>(qs), LD / 2, warp * 16, g, t, qa);

  const int row0 = qi * TQ + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  float m[2] = {2.f * FNEG, 2.f * FNEG};
  float s[2] = {0.f, 0.f};  // this lane's share of the row sums
  float o[NTD][4];
  zero_acc<NTD>(o);

  const int nk = (S + TK - 1) / TK;
  const int kt_end = causal ? min(nk - 1, (qi * TQ + TQ - 1) / TK) : nk - 1;
  const uint32_t* ks32 = reinterpret_cast<const uint32_t*>(ks_);
  const uint32_t* vt32 = reinterpret_cast<const uint32_t*>(vt);
  for (int kt = 0; kt <= kt_end; ++kt) {
    __syncthreads();  // the previous tile is consumed
    load_tile<KS, true, false>(k + head_off, row_stride, kt * TK, S, Dh, ks_, nullptr, tid);
    load_tile<KS, false, true>(v + head_off, row_stride, kt * TK, S, Dh, nullptr, vt, tid);
    load_pad_terms(pad_b, kt * TK, S, pad_s, tid);
    __syncthreads();

    float acc[8][4];
    zero_acc<8>(acc);
    mma_tile<KS, 8>(qa, ks32, LD / 2, g, t, acc);

    float mx[2] = {2.f * FNEG, 2.f * FNEG};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int c = 8 * j + 2 * t + qq;
          const float l = masked_logit<HAS_BIAS>(acc[j][2 * hh + qq], scale, rows[hh],
                                                 kt * TK + c, S, causal != 0, pad_s[c], bias_bh);
          acc[j][2 * hh + qq] = l;
          mx[hh] = fmaxf(mx[hh], l);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = ex2((m[hh] - m_new) * LOG2E);
      m[hh] = m_new;
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const float p = ex2((acc[j][2 * hh + qq] - m_new) * LOG2E);
          acc[j][2 * hh + qq] = p;
          add += p;
        }
      }
      s[hh] = s[hh] * corr[hh] + add;
    }
#pragma unroll
    for (int j = 0; j < NTD; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    uint32_t pa[4][4];
    pack_a_fragments(acc, pa);
    mma_tile<4, NTD>(pa, vt32, LDT / 2, g, t, o);
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
    const bool row_ok = m[hh] > 0.5f * FNEG;
    const float denom = s[hh] > 0.f ? s[hh] : 1.f;
    inv[hh] = row_ok ? 1.f / denom : 0.f;
    if (t == 0 && rows[hh] < S) {
      lse[(size_t)bh * S + rows[hh]] = row_ok ? m[hh] + logf(denom) : LSE_MASKED;
    }
  }
#pragma unroll
  for (int j = 0; j < NTD; ++j) {
    o[j][0] *= inv[0];
    o[j][1] *= inv[0];
    o[j][2] *= inv[1];
    o[j][3] *= inv[1];
  }
  store_rows<NTD>(o, 1.f, out + head_off, row_stride, row0, S, Dh, g, t);
}

// ------------------------------------------------------------ Hopper design
// Shared memory of flash_fwd_hw_kernel: the q tile, STAGES ring slots (k, v
// and the keys' padding terms), NSTG f32 staging pieces, the barriers.
template <int DP>
struct FwdLayout {
  static constexpr int TILE_BYTES = DP / 64 * hopper::SLAB_BYTES;
  static constexpr int SLOT = 2 * TILE_BYTES + 1024;
  static constexpr int STAGES = DP == 64 ? 4 : 2;
  static constexpr int NSTG = DP == 64 ? 4 : 3;
  static constexpr int STAGING = hw::Stager<DP, NSTG>::BYTES;
  static constexpr int BYTES = 1024 + TILE_BYTES + STAGES * SLOT + STAGING + 8 * (2 * STAGES + 1);
};

// flash_fwd_hw_kernel: a block of 384 threads per (batch * head, 128-query
// tile). Warpgroup 2 stores the q tile once, then for every key tile up to
// the causal end the k and v tiles (bf16, image layout, through the f32
// staging pieces of flash_hopper.cuh's Stager) and the keys' padding terms
// into a ring slot; warpgroups 0 and 1 own 64
// queries each: S = q . k^T by wgmma from shared memory (m64n128, DP / 16
// depth steps), the scale, masks and bias by masked_logit, the online
// softmax in registers, and o += P . v by wgmma with P as register A
// fragments and v read MN-major. The producer fills the next slots while the
// consumers work, and the two consumer warpgroups overlap each other.
template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(hw::HW_THREADS, 1)
flash_fwd_hw_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ pad,
                    const float* __restrict__ bias, long long bias_sb, long long bias_sh,
                    float* __restrict__ out, float* __restrict__ lse, int S, int H, int Dh,
                    int nq, int causal, float scale) {
  using namespace t4r::flash::hw;
  using L = FwdLayout<DP>;
  constexpr int TILE_BYTES = L::TILE_BYTES, SLOT = L::SLOT, stages = L::STAGES, NSTG = L::NSTG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ring = qs + TILE_BYTES;
  uint8_t* staging = ring + stages * SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + L::STAGING);
  uint64_t* empty = full + stages;
  uint64_t* once = empty + stages;
  init_store_ring(stages, full, empty, once);

  // query tiles are the slow grid axis, the longest (the last, under the
  // causal mask) first, so that the short ones fill the card's tail
  const int BH = gridDim.x / nq, order = blockIdx.x / BH;
  const int bh = blockIdx.x - order * BH, qi = causal ? nq - 1 - order : order;
  const int b = bh / H, h = bh - b * H;
  const int row_stride = H * Dh;
  const size_t head_off = ((size_t)b * S * H + h) * Dh;
  const int nk = (S + T - 1) / T;
  const int kt_end = causal ? min(nk - 1, qi) : nk - 1;
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the q tile's pieces, then each key tile's k pieces and v pieces, NSTG - 1
    // of them in flight ahead of the one being rounded
    Stager<DP, NSTG> sg(staging, threadIdx.x - 256);
    constexpr int R = Stager<DP, NSTG>::R, TP = T / R;  // rows a piece, pieces a tile
    const int pieces = TP + (kt_end + 1) * 2 * TP;
    const uint8_t* pad_b = pad != nullptr ? pad + (size_t)b * S : nullptr;
    auto issue = [&](int n) {
      if (n >= pieces) return sg.skip();
      if (n < TP) return sg.issue(q + head_off, row_stride, qi * T + n * R, S, Dh);
      const int j = (n - TP) % (2 * TP), kt = (n - TP) / (2 * TP);
      sg.issue((j < TP ? k : v) + head_off, row_stride, kt * T + (j % TP) * R, S, Dh);
    };
    for (int n = 0; n < NSTG - 1; ++n) issue(n);
    float pad_term = 0.f;
    for (int n = 0; n < pieces; ++n) {
      issue(n + NSTG - 1);
      if (n < TP) {
        sg.round(qs, n * R);
        if (n == TP - 1) stored(once);
        continue;
      }
      const int j = (n - TP) % (2 * TP), kt = (n - TP) / (2 * TP), st = kt % stages;
      uint8_t* slot = ring + st * SLOT;
      if (j == 0) {
        pad_term = pad_term_of(pad_b, kt * T + sg.p, S);  // read while the tile is rounded
        mbar_wait(&empty[st], ((kt / stages) & 1) ^ 1);
      }
      sg.round(slot + (j < TP ? 0 : TILE_BYTES), (j % TP) * R);
      if (j == 2 * TP - 1) {
        reinterpret_cast<float*>(slot + 2 * TILE_BYTES)[sg.p] = pad_term;
        stored(&full[st]);
      }
    }
    cp_async_wait<0>();
    return;
  }

  const float* bias_bh = HAS_BIAS ? bias + b * bias_sb + h * bias_sh : nullptr;
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row0 = qi * T + wg * 64 + warp * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  float m[2] = {2.f * FNEG, 2.f * FNEG};
  float s[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[64], o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  const uint32_t qa = smem_addr(qs) + wg * 64 * 128;
  mbar_wait(once, 0);
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int st = kt % stages;
    mbar_wait(&full[st], (kt / stages) & 1);
    const uint8_t* slot = ring + st * SLOT;
    const float* pad_s = reinterpret_cast<const float*>(slot + 2 * TILE_BYTES);
    tile_logits<DP>(acc, qa, smem_addr(slot));

    // acc[4j + 2hh + qq]: row rows[hh], key kt * T + 8j + 2t + qq. A tile
    // wholly inside the sequence and, under the causal mask, at or before
    // every row of the warpgroup, takes only the scale and the padding terms
    // (masked_logit's arithmetic without its tests)
    float mx[2] = {2.f * FNEG, 2.f * FNEG};
    const bool inside = !HAS_BIAS && (kt + 1) * T <= S &&
                        (!causal || (kt + 1) * T - 1 <= qi * T + wg * 64);
    if (inside) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const float l = acc[4 * j + 2 * hh + qq] * scale + pad_s[8 * j + 2 * t + qq];
            acc[4 * j + 2 * hh + qq] = l;
            mx[hh] = fmaxf(mx[hh], l);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int c = 8 * j + 2 * t + qq;
            const float l = masked_logit<HAS_BIAS>(acc[4 * j + 2 * hh + qq], scale, rows[hh],
                                                   kt * T + c, S, causal != 0, pad_s[c], bias_bh);
            acc[4 * j + 2 * hh + qq] = l;
            mx[hh] = fmaxf(mx[hh], l);
          }
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = ex2((m[hh] - m_new) * LOG2E);
      m[hh] = m_new;
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const float pv = ex2((acc[4 * j + 2 * hh + qq] - m_new) * LOG2E);
          acc[4 * j + 2 * hh + qq] = pv;
          add += pv;
        }
      }
      s[hh] = s[hh] * corr[hh] + add;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 0] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    tile_times<DP>(o, acc, smem_addr(slot + TILE_BYTES));  // o += P . v
    release(empty, st);
  }

  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
    const bool row_ok = m[hh] > 0.5f * FNEG;
    const float denom = s[hh] > 0.f ? s[hh] : 1.f;
    inv[hh] = row_ok ? 1.f / denom : 0.f;
    if (t == 0 && rows[hh] < S) {
      lse[(size_t)bh * S + rows[hh]] = row_ok ? m[hh] + logf(denom) : LSE_MASKED;
    }
  }
  // o[4j + 2hh + qq]: row rows[hh], d = 8j + 2t + qq
  float* base = out + head_off;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= S) continue;
    float* dst = base + (size_t)rows[hh] * row_stride;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < Dh) {
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
      }
    }
  }
}

template <int DP, bool HAS_BIAS>
cudaError_t launch_hw(const float* q, const float* k, const float* v, const uint8_t* pad,
                      const float* bias, long long bias_sb, long long bias_sh, float* out,
                      float* lse, int B, int S, int H, int Dh, int causal, float scale,
                      cudaStream_t st) {
  constexpr int smem = FwdLayout<DP>::BYTES;
  static_assert(smem <= hopper::MAX_SMEM, "K5's shared memory");
  auto kernel = flash_fwd_hw_kernel<DP, HAS_BIAS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nq = (S + hw::T - 1) / hw::T;
  kernel<<<(unsigned)((size_t)B * H * nq), hw::HW_THREADS, smem, st>>>(
      q, k, v, pad, bias, bias_sb, bias_sh, out, lse, S, H, Dh, nq, causal, scale);
  return cudaGetLastError();
}

template <int KS, bool HAS_BIAS>
cudaError_t launch(const float* q, const float* k, const float* v, const uint8_t* pad,
                   const float* bias, long long bias_sb, long long bias_sh, float* out,
                   float* lse, int B, int S, int H, int Dh, int causal, float scale,
                   cudaStream_t st) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD;
  const int smem = (2 * 64 * LD + DP * LDT) * (int)sizeof(__nv_bfloat16) + TK * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<KS, HAS_BIAS>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int nq = (S + TQ - 1) / TQ;
  kernel<<<(unsigned)((size_t)B * H * nq), FTHREADS, smem, st>>>(
      q, k, v, pad, bias, bias_sb, bias_sh, out, lse, S, H, Dh, nq, causal, scale);
  return cudaGetLastError();
}

template <bool HAS_BIAS>
cudaError_t launch_dh(const float* q, const float* k, const float* v, const uint8_t* pad,
                      const float* bias, long long bias_sb, long long bias_sh, float* out,
                      float* lse, int B, int S, int H, int Dh, int causal, float scale,
                      int wgmma, cudaStream_t st) {
  if (wgmma) {  // Dh is rounded up to 64 or 128 (zero padded)
    if (Dh <= 64) {
      return launch_hw<64, HAS_BIAS>(q, k, v, pad, bias, bias_sb, bias_sh, out, lse, B, S, H, Dh,
                                     causal, scale, st);
    }
    return launch_hw<128, HAS_BIAS>(q, k, v, pad, bias, bias_sb, bias_sh, out, lse, B, S, H, Dh,
                                    causal, scale, st);
  }
  // Dh is rounded up to 16, 32, 64 or 128 (zero padded)
#define T4R_FLASH_FWD_KS(KS_)                                                              \
  return launch<KS_, HAS_BIAS>(q, k, v, pad, bias, bias_sb, bias_sh, out, lse, B, S, H, Dh, \
                               causal, scale, st)
  if (Dh <= 16) T4R_FLASH_FWD_KS(1);
  if (Dh <= 32) T4R_FLASH_FWD_KS(2);
  if (Dh <= 64) T4R_FLASH_FWD_KS(4);
  T4R_FLASH_FWD_KS(8);
#undef T4R_FLASH_FWD_KS
}

}  // namespace

extern "C" {

int t4r_flash_tile_rows() { return t4r::flash::TQ; }

// Launches the forward on `stream`. q, k, v, out: (B, S, H, Dh) float32,
// contiguous and 16-byte aligned; pad: (B, S) bytes (non-zero = a real key)
// or null; bias: float32 with strides bias_sb / bias_sh (elements; 0 on a
// broadcast axis) between its (S, S) planes, or null; lse: (B * H, S). The
// caller checks shapes (Dh a multiple of 4 up to 128) and allocates. Returns
// the CUDA error of the launch (0 when it was accepted).
int t4r_flash_fwd(const float* q, const float* k, const float* v, const uint8_t* pad,
                  const float* bias, long long bias_sb, long long bias_sh, float* out,
                  float* lse, int B, int S, int H, int Dh, int causal, float scale, int wgmma,
                  void* stream) {
  if (Dh < 4 || Dh > 128 || Dh % 4 != 0 || B < 1 || S < 1 || H < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bias != nullptr
                        ? launch_dh<true>(q, k, v, pad, bias, bias_sb, bias_sh, out, lse, B, S,
                                          H, Dh, causal, scale, wgmma, st)
                        : launch_dh<false>(q, k, v, pad, bias, bias_sb, bias_sh, out, lse, B, S,
                                           H, Dh, causal, scale, wgmma, st);
  return (int)err;
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
