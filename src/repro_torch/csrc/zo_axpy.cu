// K1: fused ZO perturb/update axpy over an (L, n) leaf view, in place.
//
// Replaces the Pallas TPU kernel repro/kernels/zo_axpy.py::zo_axpy_2d
// (pallas_call at :82):
//
//   theta[l, i] <- decay * theta[l, i] + scale * z(fold(seed, l), i)
//
// on rows where mask[l], theta untouched elsewhere.  z is made in
// registers from the counter RNG (rng.cuh) and never exists in memory.
//
// Bound on the H100: memory.  Each active element is read once and
// written once (2 x 2 bytes in bf16) against some 40 integer and float
// operations of RNG work, well under the 295 operations per byte at
// which the card turns compute-bound.  The design therefore only keeps
// traffic minimal: a masked-off row returns before any RNG work or any
// access, and neighbouring threads touch neighbouring elements so every
// warp's loads and stores coalesce.
//
// Grid: (ceil(n / CHUNK), L); a block covers CHUNK consecutive elements
// of one row.  Math in float32; the result is rounded to theta's type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr long long CHUNK = (long long)THREADS * PER_THREAD;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float& dst, float v) { dst = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& dst, float v) {
  dst = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
zo_axpy_2d_kernel(T* __restrict__ theta, const bool* __restrict__ mask,
                  long long n, uint32_t seed, float scale, float decay) {
  const uint32_t l = blockIdx.y;
  if (!mask[l]) return;                       // dropped layer: no work at all
  const uint32_t seed_l = rz::fold(seed, l);
  T* row = theta + (long long)l * n;
  const long long start = (long long)blockIdx.x * CHUNK + threadIdx.x;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const long long i = start + (long long)k * THREADS;
    if (i < n) {
      const float z = rz::counter_normal(seed_l, static_cast<uint32_t>(i));
      const float x = to_f32(row[i]);
      from_f32(row[i], __fadd_rn(__fmul_rn(decay, x), __fmul_rn(scale, z)));
    }
  }
}

template <typename T>
int launch(void* theta, const void* mask, long long L, long long n,
           uint32_t seed, float scale, float decay, void* stream) {
  if (L <= 0 || n <= 0) return 0;
  dim3 grid((unsigned)((n + CHUNK - 1) / CHUNK), (unsigned)L);
  zo_axpy_2d_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<T*>(theta), static_cast<const bool*>(mask), n, seed, scale,
      decay);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int zo_axpy_2d_launch(void* theta, const void* mask, long long L,
                                 long long n, int dtype, unsigned int seed,
                                 float scale, float decay, void* stream) {
  if (dtype == 0)
    return launch<float>(theta, mask, L, n, seed, scale, decay, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(theta, mask, L, n, seed, scale, decay,
                                 stream);
  return (int)cudaErrorInvalidValue;
}
