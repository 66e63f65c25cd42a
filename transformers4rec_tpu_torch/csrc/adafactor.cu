// Streamed Adafactor update of an embedding table with an unfactored second
// moment stored in the table's type, in two passes over the table (kernels
// K7a and K7b of the port).
//
// With g the gradient, v the second moment and p the table, all n values of
// one type T (f32, or bf16 for a bf16-stored table), the arithmetic in f32:
//   pass A   nv   = decay v + (1 - decay) (g^2 + eps);  v <- T(nv)   (in place)
//            part[b] = sum over block b's elements of (g rsqrt(nv))^2
//            coef = -lr / max(1, sqrt(sum_b part[b] / n) / clip)   (-lr without a clip)
//   pass B   p    <- T(p + T(g coef rsqrt(v)))                   (in place)
// The clip's sums take the unrounded nv; pass B reads the moment as pass A
// stored it (for f32 the same values). For bf16 the update is rounded to
// bf16 and the sum once more, as the reference's update cast to p.dtype and
// then added by optax.apply_updates gives. decay is read from device memory
// and coef is written there, so nothing goes back to the host between the
// passes.
//
// Replaces: transformers4rec_tpu/ops/fused_adafactor.py:_upd_a_kernel and
// _upd_b_kernel (launched through pl.pallas_call at fused_adafactor.py:127
// and :154). The TPU passes return new_v and the update as new arrays, and
// optax adds the update to the table afterwards; here both passes write in
// place, as torch.optim does.
//
// Bound on an H100 at the item table's shape (390,008 x 64 f32, 99.84 MB a
// tensor): pass A reads g and v and writes v, 299.5 MB, 89 us at 3.35 TB/s;
// pass B reads g, v and p and writes p, 399.4 MB, 119 us. A bf16 table
// halves each: 149.8 MB and 44.7 us, 199.7 MB and 59.6 us. The arithmetic is
// a few operations per element, far below the memory's time: both passes are
// bound by the bytes, and the design moves each tensor once per pass and
// nothing else.
//
// Design. The TPU kernels walk 512-row blocks in order and write one partial
// sum per block. Here a fixed grid of blocks strides over the flat tensor
// with loads of 4 values (16 bytes of f32, 8 of bf16; a scalar loop takes
// the last n mod 4 values), each
// thread sums its own terms in order, the block adds them up through a
// shuffle tree, and one more block adds the partials in order: no atomics,
// so a second call on the same inputs gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float new_moment(float g, float v, float decay, float eps) {
  return decay * v + (1.f - decay) * (g * g + eps);
}

// Four values of type T as f32, and back (bf16 rounded to nearest even).
template <class T>
struct Vec4;
template <>
struct Vec4<float> {
  using Reg = float4;
  __device__ static float4 get(const Reg& r) { return r; }
  __device__ static Reg put(const float4& f) { return f; }
  __device__ static float one(float v) { return v; }
  __device__ static float round(float v) { return v; }
};
template <>
struct Vec4<__nv_bfloat16> {
  using Reg = uint2;
  __device__ static float lo(uint32_t w) { return __uint_as_float(w << 16); }
  __device__ static float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
  __device__ static float4 get(const Reg& r) {
    return make_float4(lo(r.x), hi(r.x), lo(r.y), hi(r.y));
  }
  __device__ static uint32_t pack(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static Reg put(const float4& f) { return make_uint2(pack(f.x, f.y), pack(f.z, f.w)); }
  __device__ static float one(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

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

template <class T>
__global__ void __launch_bounds__(THREADS)
adafactor_a_kernel(const T* __restrict__ g, T* __restrict__ v,
                   const float* __restrict__ decay_ptr, float eps, long long n,
                   float* __restrict__ part) {
  using F = Vec4<T>;
  using R = typename F::Reg;
  const float decay = *decay_ptr;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  const R* g4 = reinterpret_cast<const R*>(g);
  R* v4 = reinterpret_cast<R*>(v);
  float s = 0.f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4; i += stride) {
    const float4 gg = F::get(__ldg(g4 + i));
    float4 vv = F::get(v4[i]);
    vv.x = new_moment(gg.x, vv.x, decay, eps);
    vv.y = new_moment(gg.y, vv.y, decay, eps);
    vv.z = new_moment(gg.z, vv.z, decay, eps);
    vv.w = new_moment(gg.w, vv.w, decay, eps);
    v4[i] = F::put(vv);
    const float a = gg.x * rsqrtf(vv.x), b = gg.y * rsqrtf(vv.y);
    const float c = gg.z * rsqrtf(vv.z), d = gg.w * rsqrtf(vv.w);
    s += (a * a + b * b) + (c * c + d * d);
  }
  // the last n mod 4 values
  for (long long i = 4 * n4 + (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float gg = F::one(g[i]);
    const float vv = new_moment(gg, F::one(v[i]), decay, eps);
    v[i] = T(vv);
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

template <class T>
__global__ void __launch_bounds__(THREADS)
adafactor_b_kernel(const T* __restrict__ g, const T* __restrict__ v,
                   const float* __restrict__ coef_ptr, long long n, T* __restrict__ p) {
  using F = Vec4<T>;
  using R = typename F::Reg;
  const float coef = *coef_ptr;
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  const R* g4 = reinterpret_cast<const R*>(g);
  const R* v4 = reinterpret_cast<const R*>(v);
  R* p4 = reinterpret_cast<R*>(p);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4; i += stride) {
    const float4 gg = F::get(__ldg(g4 + i)), vv = F::get(__ldg(v4 + i));
    float4 pp = F::get(p4[i]);
    pp.x += F::round(gg.x * (coef * rsqrtf(vv.x)));
    pp.y += F::round(gg.y * (coef * rsqrtf(vv.y)));
    pp.z += F::round(gg.z * (coef * rsqrtf(vv.z)));
    pp.w += F::round(gg.w * (coef * rsqrtf(vv.w)));
    p4[i] = F::put(pp);
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    p[i] = T(F::one(p[i]) + F::round(F::one(g[i]) * (coef * rsqrtf(F::one(v[i])))));
  }
}

template <class T>
int pass_a(const T* g, T* v, const float* decay, float eps, long long n, int blocks, float lr,
           float clip, int has_clip, float* part, float* coef, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  adafactor_a_kernel<T><<<blocks, THREADS, 0, st>>>(g, v, decay, eps, n, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adafactor_coef_kernel<<<1, THREADS, 0, st>>>(part, blocks, n, lr, clip, has_clip, coef);
  return (int)cudaGetLastError();
}

template <class T>
int pass_b(const T* g, const T* v, const float* coef, long long n, int blocks, T* p,
           void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  adafactor_b_kernel<T><<<blocks, THREADS, 0, st>>>(g, v, coef, n, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int t4r_adafactor_threads() { return THREADS; }

// Pass A and the coefficient on `stream`. The caller checks dtypes,
// contiguity and 16-byte alignment and allocates part (blocks,) and coef
// (1,). g and v hold n values, f32 (t4r_adafactor_a) or bf16
// (t4r_adafactor_a_bf16); v is updated in place. decay is a device scalar.
// has_clip == 0 leaves the clip out (coef = -lr). Returns the first CUDA
// error (0 when both launches were accepted).
int t4r_adafactor_a(const float* g, float* v, const float* decay, float eps, long long n,
                    int blocks, float lr, float clip, int has_clip, float* part,
                    float* coef, void* stream) {
  return pass_a(g, v, decay, eps, n, blocks, lr, clip, has_clip, part, coef, stream);
}

int t4r_adafactor_a_bf16(const void* g, void* v, const float* decay, float eps, long long n,
                         int blocks, float lr, float clip, int has_clip, float* part,
                         float* coef, void* stream) {
  return pass_a(static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(v), decay,
                eps, n, blocks, lr, clip, has_clip, part, coef, stream);
}

// Pass B on `stream`: p is updated in place from g, the moment pass A wrote
// and the device scalar coef (all f32, or all bf16 with the _bf16 entry).
int t4r_adafactor_b(const float* g, const float* v, const float* coef, long long n,
                    int blocks, float* p, void* stream) {
  return pass_b(g, v, coef, n, blocks, p, stream);
}

int t4r_adafactor_b_bf16(const void* g, const void* v, const float* coef, long long n,
                         int blocks, void* p, void* stream) {
  return pass_b(static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(v), coef,
                n, blocks, static_cast<__nv_bfloat16*>(p), stream);
}

const char* t4r_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
