// Hopper (sm_90a) pieces of the wgmma attention kernels: K5's
// (flash_fwd.cu) and K6a's (flash_bwd.cu). They work on tiles of T = 128
// queries or keys in the image layout of hopper.cuh (128 rows, the head dim
// padded with zeros to DP = 64 or 128 values: one or two 64-value slabs in
// the 128-byte swizzle), so one set of wgmma descriptors (kmajor_desc,
// mnmajor_desc) reads a tile both as a K-major operand (q . k^T, with the
// head dim as the depth) and as an MN-major one (P . v, with the rows as
// the depth).
//
// Why tiles are rounded in shared memory and not by an image pass. q, k, v
// and dO arrive as f32 in the (B, S, H, Dh) layout, where one row of a head
// is Dh x 4 bytes (48 at Dh = 12) at a stride of H x Dh x 4: no 1-D bulk
// copy moves a tile, and an image pass that wrote bf16 tiles first would
// read every byte once more and write half as many again, which at the
// long-session shape (B, S, H, Dh) = (32, 256, 16, 12) is as much traffic
// as the kernel's own. So a producer warpgroup copies the f32 rows with
// cp.async (16 bytes a copy, zero-filled beyond S and Dh) into a ring of
// f32 staging pieces of 16 KB (Stager), several pieces in flight, then
// rounds each landed piece to bf16 into a ring slot in the swizzled layout;
// the next tiles' copies and this tile's rounding overlap the consumers'
// products and softmax. The slots' barriers count the producer's 128
// threads (full) and the 8 consumer warps (empty). A generic-proxy store is
// made visible to wgmma's async proxy by fence.proxy.async before the
// arrival.

#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace t4r {
namespace flash {
namespace hw {

using namespace t4r::hopper;

constexpr int T = TILE;                 // queries or keys per tile
constexpr int PRODUCER_THREADS = 128;   // warpgroup 2
constexpr int HW_THREADS = 384;         // two consumer warpgroups and the producer

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The barriers of a ring of `stages` slots whose producer is a warpgroup of
// threads that store (not bulk copies): full[s] and `once` wait for all 128
// producer threads, empty[s] for the 8 consumer warps. Ends with
// __syncthreads().
__device__ __forceinline__ void init_store_ring(int stages, uint64_t* full, uint64_t* empty,
                                                uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], PRODUCER_THREADS);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(once, PRODUCER_THREADS);
    fence_barrier_init();
  }
  __syncthreads();
}

// The calling producer thread's stores are done: make them visible to the
// consumers' wgmma and arrive on `bar`.
__device__ __forceinline__ void stored(uint64_t* bar) {
  fence_proxy_async();
  mbar_arrive(bar);
}

// cp.async of 16 bytes; the bytes past `bytes` (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The producer thread p's share of a ring of NSTG f32 staging pieces, each
// R = 4096 / DP rows of DP values (16 KB): issue() copies rows [r0, r0 + R)
// of one (batch, head) of a (B, S, H, Dh) float32 tensor (`base` at
// (batch, 0, head, 0), `row_stride` = H x Dh) into the next piece as one
// cp.async group, zero beyond S and Dh; round() waits until the oldest piece
// in flight has landed (NSTG - 1 newer ones may still fly) and stores it in
// bf16 as rows [row_off, row_off + R) of an image tile of DP values. A
// thread's units are 16 bytes (4 values) p + 128 m of the piece, so that the
// 32 copies of a warp read 512 contiguous bytes (whole 32-byte sectors: the
// copies bypass L1), and each thread reads back and rounds only the bytes it
// copied itself, so the producer's threads need no barrier among them.
// Pieces are issued and rounded in one order, and every issue() or skip() is
// one group, so that wait_group counts right to the end of the stream.
template <int DP, int NSTG>
struct Stager {
  static constexpr int R = 4096 / DP;                              // rows of a piece
  static constexpr int PER_ROW = DP / 4;                           // 16-byte units of a row
  static constexpr int UNITS = R * PER_ROW / PRODUCER_THREADS;     // a thread's units a piece
  static constexpr int PIECE_BYTES = R * DP * 4;
  static constexpr int BYTES = NSTG * PIECE_BYTES;
  uint8_t* buf;
  int p, issued = 0, rounded = 0;

  __device__ __forceinline__ Stager(uint8_t* buf_, int p_) : buf(buf_), p(p_) {}

  __device__ __forceinline__ void issue(const float* __restrict__ base, int row_stride, int r0,
                                        int S, int Dh) {
    uint8_t* stg = buf + (issued % NSTG) * PIECE_BYTES;
#pragma unroll
    for (int m = 0; m < UNITS; ++m) {
      const int i = p + m * PRODUCER_THREADS, r = i / PER_ROW, d0 = (i - r * PER_ROW) * 4;
      const bool ok = r0 + r < S && d0 < Dh;
      cp_async16(stg + i * 16, ok ? base + (size_t)(r0 + r) * row_stride + d0 : base, ok ? 16 : 0);
    }
    cp_async_commit();
    ++issued;
  }

  // an empty group where the stream has no piece left to issue
  __device__ __forceinline__ void skip() {
    cp_async_commit();
    ++issued;
  }

  __device__ __forceinline__ void round(uint8_t* dst, int row_off) {
    cp_async_wait<NSTG - 1>();
    const uint8_t* stg = buf + (rounded % NSTG) * PIECE_BYTES;
#pragma unroll
    for (int m = 0; m < UNITS; ++m) {
      const int i = p + m * PRODUCER_THREADS, r = i / PER_ROW, d0 = (i - r * PER_ROW) * 4;
      const float4 x = *reinterpret_cast<const float4*>(stg + i * 16);
      *reinterpret_cast<uint2*>(dst + image_offset(row_off + r, d0, DP)) =
          make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
    }
    ++rounded;
  }
};

// The padding term (masked_logit's pad_add) of key `key` of a row of S.
__device__ __forceinline__ float pad_term_of(const uint8_t* __restrict__ pad_b, int key, int S) {
  if (pad_b == nullptr) return 0.f;
  return key < S ? (pad_b[key] ? 0.f : FNEG) : 2.f * FNEG;
}

// S (+)= A . B^T over the head dim: A the warpgroup's 64 rows of one tile
// (a_rows added), B a whole tile (128 columns), both K-major, DP / 16
// depth steps; one wgmma group, waited for.
template <int DP>
__device__ __forceinline__ void tile_logits(float (&acc)[64], uint32_t a, uint32_t b) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < DP / 16; ++k) wgmma_ss_n128(acc, kmajor_desc(a, k), kmajor_desc(b, k), k > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// out (64 x DP) += P (64 x 128, the accumulator `p` rounded to bf16 as A
// fragments) . tile (128 rows x DP, MN-major); one wgmma group, waited for.
template <int DP>
__device__ __forceinline__ void tile_times(float (&out)[DP / 2], const float (&p)[64],
                                           uint32_t tile) {
  uint32_t a[8][4];  // P packed once, before the products, so no register of
#pragma unroll        // theirs is defined between two of them
  for (int k = 0; k < 8; ++k) acc_to_a(p, k, a[k]);
  fence_regs(out);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k) wgmma_rs<DP>(out, a[k], mnmajor_desc(tile, k));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(out);
}

// D (64 x 64) (+)= A (64 x 16) . B (16 x 64), both from shared memory; TA
// and TB set the transpose bits (an MN-major operand); scale_d = 0
// overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB));
}

// Waits at named barrier `id` (1..15; 0 is __syncthreads) for `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace hw
}  // namespace flash
}  // namespace t4r
