// Streamed Adafactor update of an embedding table with an unfactored f32
// second moment, in two passes over the table (kernels K7a and K7b of the
// port).
//
// With g the gradient, v the second moment and p the table, all n f32 values:
//   pass A   v    <- decay v + (1 - decay) (g^2 + eps)          (in place)
//            part[b] = sum over block b's elements of (g rsqrt(v))^2
//            coef = -lr / max(1, sqrt(sum_b part[b] / n) / clip)   (-lr without a clip)
//   pass B   p    <- p + g coef rsqrt(v)                         (in place)
// Pass B reads the unrounded f32 moment that pass A wrote. decay is read
// from device memory and coef is written there, so nothing goes back to the
// host between the passes.
//
// Replaces: transformers4rec_tpu/ops/fused_adafactor.py:_upd_a_kernel and
// _upd_b_kernel (launched through pl.pallas_call at fused_adafactor.py:127
// and :154). The TPU passes return new_v and the update as new arrays, and
// optax adds the update to the table afterwards; here both passes write in
// place, as torch.optim does.
//
// Bound on an H100 at the item table's shape (390,008 x 64 f32, 99.84 MB a
// tensor): pass A reads g and v and writes v, 299.5 MB, 89 us at 3.35 TB/s;
// pass B reads g, v and p and writes p, 399.4 MB, 119 us. The arithmetic is
// a few operations per element, far below the memory's time: both passes are
// bound by the bytes, and the design moves each tensor once per pass and
// nothing else.
//
// Design. The TPU kernels walk 512-row blocks in order and write one partial
// sum per block. Here a fixed grid of blocks strides over the flat tensor
// with 16-byte loads (a scalar loop takes the last n mod 4 values), each
// thread sums its own terms in order, the block adds them up through a
// shuffle tree, and one more block adds the partials in order: no atomics,
// so a second call on the same inputs gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float new_moment(float g, float v, float decay, float eps) {
  return decay * v + (1.f - decay) * (g * g + eps);
}

// Block-wide sum in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  }
  return total;
}

__global__ void __launch_bounds__(THREADS)
adafactor_a_kernel(const float* __restrict__ g, float* __restrict__ v,
                   const float* __restrict__ decay_ptr, float eps, long long n,
                   float* __restrict__ part) {
  const float decay = *decay_ptr;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* v4 = reinterpret_cast<float4*>(v);
  float s = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4; i += stride) {
    const float4 gg = __ldg(g4 + i);
    float4 vv = v4[i];
    vv.x = new_moment(gg.x, vv.x, decay, eps);
    vv.y = new_moment(gg.y, vv.y, decay, eps);
    vv.z = new_moment(gg.z, vv.z, decay, eps);
    vv.w = new_moment(gg.w, vv.w, decay, eps);
    v4[i] = vv;
    const float a = gg.x * rsqrtf(vv.x), b = gg.y * rsqrtf(vv.y);
    const float c = gg.z * rsqrtf(vv.z), d = gg.w * rsqrtf(vv.w);
    s += (a * a + b * b) + (c * c + d * d);
  }
  // the last n mod 4 values
  for (long long i = 4 * n4 + (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float gg = g[i];
    const float vv = new_moment(gg, v[i], decay, eps);
    v[i] = vv;
    const float a = gg * rsqrtf(vv);
    s += a * a;
  }
  const float total = block_sum(s);
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// One block: the partials in order, then the step's coefficient.
__global__ void __launch_bounds__(THREADS)
adafactor_coef_kernel(const float* __restrict__ part, int nparts, long long n, float lr,
                      float clip, int has_clip, float* __restrict__ coef) {
  float s = 0.f;
  if (has_clip) {
    for (int i = threadIdx.x; i < nparts; i += THREADS) s += part[i];
  }
  const float total = block_sum(s);
  if (threadIdx.x == 0) {
    float scale = 1.f;
    if (has_clip) {
      const float rms = sqrtf(total / (float)n);
      scale = 1.f / fmaxf(1.f, rms / clip);
    }
    coef[0] = -lr * scale;
  }
}

__global__ void __launch_bounds__(THREADS)
adafactor_b_kernel(const float* __restrict__ g, const float* __restrict__ v,
                   const float* __restrict__ coef_ptr, long long n, float* __restrict__ p) {
  const float coef = *coef_ptr;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float4* p4 = reinterpret_cast<float4*>(p);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4; i += stride) {
    const float4 gg = __ldg(g4 + i), vv = __ldg(v4 + i);
    float4 pp = p4[i];
    pp.x += gg.x * (coef * rsqrtf(vv.x));
    pp.y += gg.y * (coef * rsqrtf(vv.y));
    pp.z += gg.z * (coef * rsqrtf(vv.z));
    pp.w += gg.w * (coef * rsqrtf(vv.w));
    p4[i] = pp;
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    p[i] += g[i] * (coef * rsqrtf(v[i]));
  }
}

}  // namespace

extern "C" {

int t4r_adafactor_threads() { return THREADS; }

// Pass A and the coefficient on `stream`. The caller checks dtypes,
// contiguity and 16-byte alignment and allocates part (blocks,) and coef
// (1,). g and v hold n values; v is updated in place. decay is a device
// scalar. has_clip == 0 leaves the clip out (coef = -lr). Returns the first
// CUDA error (0 when both launches were accepted).
int t4r_adafactor_a(const float* g, float* v, const float* decay, float eps, long long n,
                    int blocks, float lr, float clip, int has_clip, float* part,
                    float* coef, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  adafactor_a_kernel<<<blocks, THREADS, 0, st>>>(g, v, decay, eps, n, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adafactor_coef_kernel<<<1, THREADS, 0, st>>>(part, blocks, n, lr, clip, has_clip, coef);
  return (int)cudaGetLastError();
}

// Pass B on `stream`: p is updated in place from g, the moment pass A wrote
// and the device scalar coef.
int t4r_adafactor_b(const float* g, const float* v, const float* coef, long long n,
                    int blocks, float* p, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  adafactor_b_kernel<<<blocks, THREADS, 0, st>>>(g, v, coef, n, p);
  return (int)cudaGetLastError();
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
