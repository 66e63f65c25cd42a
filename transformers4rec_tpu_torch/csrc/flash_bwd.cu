// Flash attention backward (kernels K6a, K6b and K6c of the port).
//
// From q, k, v, dO (all (B, S, H, Dh) float32, rounded to bf16 on the way to
// shared memory), the forward's lse and delta = rowsum(dO * O), each body
// recomputes P = exp(logits - lse) tile by tile and forms
//   dS = P * (dO . v^T - delta)        (rounded to bf16 before its products)
//   dv = P^T . dO      dk = dS^T . q * Dh^-1/2      dq = dS . k * Dh^-1/2
// with f32 sums and the scale applied in f32 after the products.
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
// exponentials are 4 us. The bytes bound it. At (4, 2048, 8, 64) the five
// products are 86 GFLOP dense and the tensor cores bound it.
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
//     registers.
// All bodies take their logits from masked_logit (flash_common.cuh), the
// forward's function. Tiles are read as f32 from the (B, S, H, Dh) layout and
// stored row-major and, where a product needs it, transposed: no cast or
// transpose pass runs before the kernels. TMA, wgmma, a pipelined loop and
// a split of long loops across blocks are later work.

#include "flash_common.cuh"

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

template <int KS, bool HAS_BIAS, bool FUSED>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ d_out,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ pad, const float* __restrict__ bias,
                     long long bias_sb, long long bias_sh, float* __restrict__ dq_part,
                     float* __restrict__ dk, float* __restrict__ dv, int B, int S, int H, int Dh,
                     int nk, int causal, float scale) {
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

// dq = scale * sum over the key tiles, in order, of dq_part[key tile]: the
// tiles a query row's causal mask leaves out were never written and are not
// read. One float4 a thread.
__global__ void flash_dq_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ dq,
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
  dq[i] = make_float4(acc.x * scale, acc.y * scale, acc.z * scale, acc.w * scale);
}

template <int KS, bool HAS_BIAS>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ d_out,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ pad, const float* __restrict__ bias,
                    long long bias_sb, long long bias_sh, float* __restrict__ dq, int S, int H,
                    int Dh, int nq, int causal, float scale) {
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
  const float *q, *k, *v, *d_out, *lse, *delta;
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

template <int KS, bool HAS_BIAS, bool FUSED>
cudaError_t launch_dkv(const Args& a, float* dq_part, float* dq, float* dk, float* dv) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD;
  const int smem = (4 * 64 * LD + (FUSED ? 3 : 2) * DP * LDT + (FUSED ? TQ * LDT : 0)) *
                       (int)sizeof(__nv_bfloat16) +
                   (2 * TQ + TK) * (int)sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<KS, HAS_BIAS, FUSED>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nk = (a.S + TK - 1) / TK;
  kernel<<<(unsigned)((size_t)a.B * a.H * nk), FTHREADS, smem, a.st>>>(
      a.q, a.k, a.v, a.d_out, a.lse, a.delta, a.pad, a.bias, a.bias_sb, a.bias_sh, dq_part, dk,
      dv, a.B, a.S, a.H, a.Dh, nk, a.causal, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !FUSED) return err;
  const size_t total4 = (size_t)a.B * a.S * a.H * a.Dh / 4;
  const int threads = 256;
  flash_dq_reduce_kernel<<<(unsigned)((total4 + threads - 1) / threads), threads, 0, a.st>>>(
      reinterpret_cast<const float4*>(dq_part), reinterpret_cast<float4*>(dq), total4, a.S,
      a.H * a.Dh, nk, a.causal, a.scale);
  return cudaGetLastError();
}

template <int KS, bool HAS_BIAS>
cudaError_t launch_dq(const Args& a, float* dq) {
  constexpr int DP = Tile<KS>::DP, LD = Tile<KS>::LD;
  const int smem =
      (4 * 64 * LD + DP * LDT) * (int)sizeof(__nv_bfloat16) + TK * (int)sizeof(float);
  auto kernel = flash_bwd_dq_kernel<KS, HAS_BIAS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nq = (a.S + TQ - 1) / TQ;
  kernel<<<(unsigned)((size_t)a.B * a.H * nq), FTHREADS, smem, a.st>>>(
      a.q, a.k, a.v, a.d_out, a.lse, a.delta, a.pad, a.bias, a.bias_sb, a.bias_sh, dq, a.S, a.H,
      a.Dh, nq, a.causal, a.scale);
  return cudaGetLastError();
}

// mode 0: K6a (fused), 1: K6b (dq), 2: K6c (dk, dv)
template <int KS, bool HAS_BIAS>
cudaError_t launch_mode(int mode, const Args& a, float* dq_part, float* dq, float* dk,
                        float* dv) {
  if (mode == 0) return launch_dkv<KS, HAS_BIAS, true>(a, dq_part, dq, dk, dv);
  if (mode == 1) return launch_dq<KS, HAS_BIAS>(a, dq);
  return launch_dkv<KS, HAS_BIAS, false>(a, nullptr, nullptr, dk, dv);
}

template <bool HAS_BIAS>
cudaError_t launch_dh(int mode, const Args& a, float* dq_part, float* dq, float* dk, float* dv) {
  // Dh is rounded up to 16, 32, 64 or 128 (zero padded)
  if (a.Dh <= 16) return launch_mode<1, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
  if (a.Dh <= 32) return launch_mode<2, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
  if (a.Dh <= 64) return launch_mode<4, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
  return launch_mode<8, HAS_BIAS>(mode, a, dq_part, dq, dk, dv);
}

int launch_checked(int mode, const float* q, const float* k, const float* v, const float* d_out,
                   const float* lse, const float* delta, const uint8_t* pad, const float* bias,
                   long long bias_sb, long long bias_sh, float* dq_part, float* dq, float* dk,
                   float* dv, int B, int S, int H, int Dh, int causal, float scale,
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

extern "C" {

int t4r_flash_tile_rows() { return t4r::flash::TQ; }

// All three launch on `stream` and return the first CUDA error (0 when every
// launch was accepted). q, k, v, d_out, dq, dk, dv: (B, S, H, Dh) float32,
// contiguous and 16-byte aligned; lse, delta: (B * H, S) float32; pad:
// (B, S) bytes (non-zero = a real key) or null; bias: float32 with strides
// bias_sb / bias_sh (elements; 0 on a broadcast axis) between its (S, S)
// planes, or null. The caller checks shapes (Dh a multiple of 4 up to 128)
// and allocates every buffer.

// K6a: dq, dk, dv from one recomputation. dq_part: (key tiles, B, S, H, Dh)
// float32 scratch, key tiles = ceil(S / 64).
int t4r_flash_bwd_fused(const float* q, const float* k, const float* v, const float* d_out,
                        const float* lse, const float* delta, const uint8_t* pad,
                        const float* bias, long long bias_sb, long long bias_sh, float* dq_part,
                        float* dq, float* dk, float* dv, int B, int S, int H, int Dh, int causal,
                        float scale, void* stream) {
  return launch_checked(0, q, k, v, d_out, lse, delta, pad, bias, bias_sb, bias_sh, dq_part, dq,
                        dk, dv, B, S, H, Dh, causal, scale, stream);
}

// K6b: dq alone.
int t4r_flash_bwd_dq(const float* q, const float* k, const float* v, const float* d_out,
                     const float* lse, const float* delta, const uint8_t* pad, const float* bias,
                     long long bias_sb, long long bias_sh, float* dq, int B, int S, int H, int Dh,
                     int causal, float scale, void* stream) {
  return launch_checked(1, q, k, v, d_out, lse, delta, pad, bias, bias_sb, bias_sh, nullptr, dq,
                        nullptr, nullptr, B, S, H, Dh, causal, scale, stream);
}

// K6c: dk and dv alone.
int t4r_flash_bwd_dkv(const float* q, const float* k, const float* v, const float* d_out,
                      const float* lse, const float* delta, const uint8_t* pad,
                      const float* bias, long long bias_sb, long long bias_sh, float* dk,
                      float* dv, int B, int S, int H, int Dh, int causal, float scale,
                      void* stream) {
  return launch_checked(2, q, k, v, d_out, lse, delta, pad, bias, bias_sb, bias_sh, nullptr,
                        nullptr, dk, dv, B, S, H, Dh, causal, scale, stream);
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
