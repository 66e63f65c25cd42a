// Hopper (sm_90a) building blocks of the port's vocabulary kernels
// (ce_fwd.cu, ce_bwd.cu): the bf16 "image" of a matrix that the bulk copies
// and the wgmma shared-memory descriptors read, the kernel that writes it,
// mbarriers and the ring of slots they guard, the 1-D bulk copy (TMA),
// register rebalancing, wgmma, and the pieces of a block that K1 and both
// passes of K2 share (the ring's shared-memory layout and its producer, the
// row pass's split of the vocab and its rows).
//
// The image. A matrix of f32 or bf16 rows (x (N, E) or the item table
// (Vp, E), which may be stored as bf16) is rounded to bf16 (a bf16 table is
// copied as it is), its rows padded with zeros to EK, a multiple of 64 (for
// the narrow kernels 64, 128 or 256, the least of them that holds E; for the
// wide ones E rounded up to one or two slabs), and
// cut into tiles of TILE = 128 rows (the last one padded with zero rows).
// A tile is EK / 64 slabs of 128 rows x 64 values; a slab row is 128 bytes,
// and within every group of 8 rows (1,024 bytes) the 16-byte piece j of row
// r sits at place j ^ (r % 8): the layout that TMA's 128-byte swizzle
// writes and that a wgmma descriptor with 128-byte swizzle reads. So a whole
// tile is one contiguous block of 128 x EK x 2 bytes that one bulk copy
// moves into shared memory as it stands, and the same bytes serve as a
// K-major operand (rows x E, E the depth of the product) and as an MN-major
// one (E the output width, rows the depth). image_offset is the layout;
// ops/vocab.py keeps the same function in Python (swizzled_image_index),
// which the CPU tests check is a permutation and the card tests hold
// against what to_image_kernel writes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace t4r {
namespace hopper {

constexpr int TILE = 128;                  // rows of an image tile
constexpr int SLAB_BYTES = TILE * 128;     // 128 rows x 64 bf16
constexpr int GROUP_BYTES = 8 * 128;       // 8 swizzled rows
constexpr int MAX_SMEM = 232448;           // dynamic shared memory a block may ask for

// Byte offset of element (r, e) in the image of a matrix padded to ek columns.
__host__ __device__ __forceinline__ size_t image_offset(int r, int e, int ek) {
  const int rr = r % TILE, col = e % 64;
  return (size_t)(r / TILE) * TILE * ek * 2 + (size_t)(e / 64) * SLAB_BYTES + rr * 128 +
         ((((col >> 3) ^ (rr & 7))) << 4) + (col & 7) * 2;
}

// Four values of row r of src, from column e0 on (e0 + 4 <= E), as two bf16
// pairs: f32 rounded to nearest even, bf16 copied as it is.
__device__ __forceinline__ uint2 four_bf16(const float* __restrict__ src, size_t at) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src + at));
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ uint2 four_bf16(const __nv_bfloat16* __restrict__ src, size_t at) {
  return __ldg(reinterpret_cast<const uint2*>(src + at));
}

// One thread per 16-byte piece (8 values) of the image of src (rows x E,
// f32 or bf16, E a multiple of 4): rows at and beyond `rows` and columns at
// and beyond E are zero. pieces = padded rows x ek / 8.
template <class T>
__global__ void to_image_kernel(const T* __restrict__ src, int rows, int E, int ek,
                                long long pieces, uint8_t* __restrict__ img) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= pieces) return;
  const int per_row = ek / 8;
  const int r = (int)(i / per_row), e0 = (int)(i - (long long)r * per_row) * 8;
  uint2 lo = make_uint2(0u, 0u), hi = lo;
  if (r < rows) {
    const size_t at = (size_t)r * E + e0;
    if (e0 + 4 <= E) lo = four_bf16(src, at);
    if (e0 + 8 <= E) hi = four_bf16(src, at + 4);
  }
  *reinterpret_cast<uint4*>(img + image_offset(r, e0, ek)) = make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// Writes the image of the first `rows` rows of src, padded to padded_rows.
template <class T>
inline cudaError_t to_image(cudaStream_t st, const T* src, int rows, int padded_rows, int E,
                            int ek, uint8_t* img) {
  const long long pieces = (long long)padded_rows * (ek / 8);
  if (pieces == 0) return cudaSuccess;
  const int threads = 256;
  to_image_kernel<T><<<(unsigned)((pieces + threads - 1) / threads), threads, 0, st>>>(
      src, rows, E, ek, pieces, img);
  return cudaGetLastError();
}

// ------------------------------------------------------------- barriers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (the bulk copies)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of the given parity has completed. A wait that has
// not ended after about 10 s of clock cycles is a fault of the kernel: it
// traps (the launch then fails loudly) instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// TMA's 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------- the ring
// A kernel's dynamic shared memory, moved up to the 1,024-byte alignment that
// the swizzled tiles need (the launch asks for 1,024 bytes more).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The barriers of a ring of `stages` slots: full[s] completes when the
// producer's arrival and the bytes it announced have landed, empty[s] when
// every consumer warp has let go of the slot; `once` is for the tile that is
// copied once. Ends with __syncthreads().
__device__ __forceinline__ void init_ring(int stages, int consumer_warps, uint64_t* full,
                                          uint64_t* empty, uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init(once, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// the calling warp is done with slot st: one arrival per warp
__device__ __forceinline__ void release(uint64_t* empty, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[st]);
}

// ------------------------------------------------- register rebalancing
// The producer warpgroup gives registers back and the two consumer
// warpgroups take them (40 x 128 + 232 x 256 <= 65,536).
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor with 128-byte swizzle: start address,
// leading byte offset (MN-major: from one 64-wide slab of the MN dimension
// to the next; unused by a K-major swizzled operand) and stride byte offset
// (from one group of 8 rows, or of 8 depth steps when MN-major, to the next).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A K-major operand: 16 depth values (32 bytes) at depth step k of an image
// tile whose 64-row (or 128-row) block starts at `addr`.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int k) {
  return smem_desc(addr + (k >> 2) * SLAB_BYTES + (k & 3) * 32, 16, GROUP_BYTES);
}

// An MN-major operand: rows 16k .. 16k + 15 of an image tile as the depth,
// its columns as the output width.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int k) {
  return smem_desc(addr + k * 2 * GROUP_BYTES, SLAB_BYTES, GROUP_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nN (each of the warpgroup's 4 warps holds 16
// rows): d[4j + 2h + q] is row 16 warp + lane / 4 + 8h, column 8j + 2 (lane %
// 4) + q. Packed to bf16 pairs, columns 16k .. 16k + 15 of it are exactly the
// A fragment of depth step k of a product whose depth is those columns.
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R], int k, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

// D (64 x 128) (+)= A (64 x 16, K-major in shared memory) . B (128 x 16, K-major
// in shared memory)^T; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64) += A (64 x 16, bf16 fragments in registers) . B (16 x 64, MN-major
// in shared memory: the descriptor's transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128) += A (64 x 16, bf16 fragments in registers) . B (16 x 128, MN-major
// in shared memory: the descriptor's transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x ek) += A . B for ek = 64 or 128
template <int EK>
__device__ __forceinline__ void wgmma_rs(float (&d)[EK / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (EK == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else {
    static_assert(EK == 128, "the backward's products are 64 or 128 wide");
    wgmma_rs_n128(d, a, desc_b);
  }
}

// ------------------------------------------------- the blocks of K1 and K2
// Every block of ce_fwd.cu and ce_bwd.cu has 384 threads: warpgroups 0 and 1
// consume (wgmma, 64 rows of M each), warpgroup 2 produces (one thread
// issues every bulk copy). Shared memory holds one tile that is copied once
// and a ring of slots that stream: for the row passes (K1, K2's dx pass) the
// x tile and the split's W tiles, for K2's dW pass a W tile and the x tiles
// with their row table.
constexpr int BLOCK_THREADS = 384;
constexpr int CONSUMER_WARPS = 8;

// slots of the ring for tiles of KA slabs: 6 of 16 KB, 4 of 32 KB, 2 of 64 KB
template <int KA>
__host__ __device__ constexpr int ring_stages() {
  return KA == 1 ? 6 : KA == 2 ? 4 : 2;
}

// The shared-memory layout of a block: the tile copied once (KA slabs), the
// ring of STAGES slots of SLOT bytes, then the barriers full[], empty[] and
// once. BYTES is what the launch asks for (1,024 of it for the alignment).
template <int KA, int SLOT = KA * SLAB_BYTES>
struct Ring {
  static constexpr int STAGES = ring_stages<KA>();
  static constexpr int TILE_BYTES = KA * SLAB_BYTES;
  static constexpr int BYTES = 1024 + TILE_BYTES + STAGES * SLOT + 8 * (2 * STAGES + 1);
  uint8_t* tile;
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* once;

  // Lays the ring out in the block's dynamic shared memory and initialises
  // its barriers; every thread of the block constructs it (__syncthreads()).
  __device__ explicit Ring(uint8_t* smem)
      : tile(align1024(smem)),
        ring(tile + TILE_BYTES),
        full(reinterpret_cast<uint64_t*>(ring + STAGES * SLOT)),
        empty(full + STAGES),
        once(empty + STAGES) {
    init_ring(STAGES, CONSUMER_WARPS, full, empty, once);
  }

  // The producer warpgroup gives registers back; its first thread copies the
  // tile from src once, then fills slot after slot for `count` steps,
  // load(i, slot, bar) issuing the SLOT bytes of step i onto bar.
  template <class Load>
  __device__ __forceinline__ void produce(const uint8_t* src, int count, Load load) const {
    producer_registers();
    if (threadIdx.x != 256) return;
    mbar_expect_tx(once, TILE_BYTES);
    bulk_load(tile, src, TILE_BYTES, once);
    for (int i = 0; i < count; ++i) {
      const int s = i % STAGES;
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], SLOT);
      load(i, ring + s * SLOT, &full[s]);
    }
  }
};

// A block of a row pass (K1, K2's dx pass): row tile blockIdx.x of x against
// split blockIdx.y of the vocab, chunks [begin, begin + count) of 128 columns.
struct RowSplit {
  int row_tile, split, begin, count;
};

__device__ __forceinline__ RowSplit row_split(int V, int chunks_per_split) {
  const int chunks = (V + TILE - 1) / TILE;
  const int begin = blockIdx.y * chunks_per_split;
  return {(int)blockIdx.x, (int)blockIdx.y, begin,
          max(0, min(begin + chunks_per_split, chunks) - begin)};
}

// A ring whose sizes are known only at run time, for the wide kernels
// (ce_wide.cuh, ce_bwd.cu), whose slab counts follow E: a tile of
// tile_bytes copied once (0: none), `stages` slots of slot_bytes, then the
// barriers full[], empty[] and once. bytes() is what the launch asks for.
struct DynRing {
  uint8_t* tile;
  uint8_t* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* once;
  int tile_bytes, stages, slot_bytes;

  __host__ __device__ static int bytes(int tile_bytes, int stages, int slot_bytes) {
    return 1024 + tile_bytes + stages * slot_bytes + 8 * (2 * stages + 1);
  }

  // The most slots (up to 8) that fit beside the tile, 0 when fewer than 2 do.
  __host__ static int most_stages(int tile_bytes, int slot_bytes) {
    int s = 8;
    while (s >= 2 && bytes(tile_bytes, s, slot_bytes) > MAX_SMEM) --s;
    return s >= 2 ? s : 0;
  }

  // Lays the ring out in the block's dynamic shared memory and initialises
  // its barriers; every thread of the block constructs it (__syncthreads()).
  __device__ DynRing(uint8_t* smem, int tile_bytes_, int stages_, int slot_bytes_)
      : tile(align1024(smem)),
        ring(tile + tile_bytes_),
        full(reinterpret_cast<uint64_t*>(ring + stages_ * slot_bytes_)),
        empty(full + stages_),
        once(empty + stages_),
        tile_bytes(tile_bytes_),
        stages(stages_),
        slot_bytes(slot_bytes_) {
    init_ring(stages, CONSUMER_WARPS, full, empty, once);
  }

  // The producer warpgroup gives registers back; its first thread copies the
  // tile from src once (when there is one), then fills slot after slot for
  // `count` steps: load(i, slot, bar) announces the bytes of step i on bar
  // (mbar_expect_tx) and issues their copies.
  template <class Load>
  __device__ __forceinline__ void produce(const uint8_t* src, int count, Load load) const {
    producer_registers();
    if (threadIdx.x != 256) return;
    if (tile_bytes > 0) {
      mbar_expect_tx(once, tile_bytes);
      bulk_load(tile, src, tile_bytes, once);
    }
    for (int i = 0; i < count; ++i) {
      const int s = i % stages;
      mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
      load(i, ring + s * slot_bytes, &full[s]);
    }
  }
};

// The logits of one step of a wide kernel: acc = A . B^T over `slabs` items
// of the ring from item j on (returns the next item). Item s holds B's slab s
// (128 rows x 64 values) and, unless A is RESident, first A's slab s; a
// resident A is the ring's tile, slab s at s x SLAB_BYTES. a_rows is the
// calling warpgroup's place in an A slab (its 64 rows). Each item is let go
// as soon as its products are done; the next item's products are issued
// before that wait, so two are in flight.
template <bool RES>
__device__ __forceinline__ int logit_slabs(float (&acc)[64], const DynRing& r, int j, int slabs,
                                           uint32_t a_rows) {
  const uint32_t tile = smem_addr(r.tile) + a_rows, ring = smem_addr(r.ring);
  fence_regs(acc);
  for (int s = 0; s < slabs; ++s, ++j) {
    const int st = j % r.stages;
    mbar_wait(&r.full[st], (j / r.stages) & 1);
    const uint32_t slot = ring + st * r.slot_bytes;
    const uint32_t a = RES ? tile + s * SLAB_BYTES : slot + a_rows;
    const uint32_t b = RES ? slot : slot + SLAB_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_ss_n128(acc, kmajor_desc(a, k), kmajor_desc(b, k), (s | k) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous item's products are done
    if (s > 0) release(r.empty, (j - 1) % r.stages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (slabs > 0) release(r.empty, (j - 1) % r.stages);
  return j;
}

// The row pass's producer: the x tile once, then the split's W tiles.
template <int KA>
__device__ __forceinline__ void produce_row_pass(const Ring<KA>& sm, const uint8_t* ximg,
                                                 const uint8_t* wimg, const RowSplit& b) {
  constexpr int BYTES = Ring<KA>::TILE_BYTES;
  sm.produce(ximg + (size_t)b.row_tile * BYTES, b.count,
             [&](int i, uint8_t* slot, uint64_t* bar) {
               bulk_load(slot, wimg + (size_t)(b.begin + i) * BYTES, BYTES, bar);
             });
}

// The two rows of the row tile whose entries of an m64 accumulator a
// consumer thread holds: warp w of warpgroup wg, lanes l and l + 8.
__device__ __forceinline__ void consumer_rows(int row_tile, int (&rows)[2]) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2;
  rows[0] = row_tile * TILE + wg * 64 + warp * 16 + g;
  rows[1] = rows[0] + 8;
}

// A chunk wholly below V that holds neither of the thread's labels needs no
// column checks: the vocab's last, partial chunk and a label's chunk do.
__device__ __forceinline__ bool unchecked_chunk(int c, int V, const int (&lab)[2]) {
  return (c + 1) * TILE <= V && (unsigned)(lab[0] - c * TILE) >= (unsigned)TILE &&
         (unsigned)(lab[1] - c * TILE) >= (unsigned)TILE;
}

// Launches a kernel of BLOCK_THREADS threads with `smem` bytes of dynamic
// shared memory; returns the first error.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int smem, cudaStream_t st,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BLOCK_THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace t4r

extern "C" {

// Writes the image of the first `rows` rows of src (f32, or bf16 when
// src_bf16 is 1; E a multiple of 4) into img (padded_rows x ek bf16, ek a
// multiple of 64 that holds E) on `stream`: f32 rounds to nearest even, bf16
// is copied. Returns the CUDA error of the launch (0 when it was accepted).
int t4r_image(const void* src, int rows, int padded_rows, int E, int ek, void* img,
              int src_bf16, void* stream) {
  if (E < 4 || E % 4 != 0 || E > ek || ek % 64 != 0 ||
      padded_rows % t4r::hopper::TILE != 0 || rows > padded_rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* out = static_cast<uint8_t*>(img);
  if (src_bf16) {
    return (int)t4r::hopper::to_image(st, static_cast<const __nv_bfloat16*>(src), rows,
                                      padded_rows, E, ek, out);
  }
  return (int)t4r::hopper::to_image(st, static_cast<const float*>(src), rows, padded_rows, E,
                                    ek, out);
}

}  // extern "C"
