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
// Bound on the H100: instruction issue, not bytes.  An active bf16
// element moves 4 bytes against the instructions of its z and axpy.  With
// the general logf/sqrtf/cosf and one element a thread step, that was 111
// SASS instructions an element; this kernel issues 76 (both counted by
// repro_torch.kernels.sass, nvcc 12.9).  At 132 SMs x 128 lanes x 1.98
// GHz, 76 instructions take 2.3x the time of 4 bytes at 3.35 TB/s.  The
// design therefore cuts instructions per z and keeps the bits:
//
// - counter_normal's float part runs r_fast/c_fast (rng.cuh): libdevice's
//   logf/cosf/sqrtf operations without the special cases that the
//   RNG's domain never reaches, proved bit-identical on all 2^24 inputs.
// - Each thread takes one 16-byte vector (8 bf16 or 4 float32) per loop
//   step: one load, one store and one index step for 8 z, which run
//   independently in flight.  Blocks stride over the row, so the mask
//   test and the row seed are paid once per thread, not per element.
// - A row whose base is not 16-byte aligned (odd n, a sliced view)
//   takes its head up to the first 16-byte boundary and its tail after
//   the last whole vector element by element, in block 0.
// - A masked-off row returns before any RNG work or any access.
//
// Grid: (min(vectors / THREADS, MAX_BLOCKS), L).  Math in float32; the
// result is rounded to theta's type.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1024;   // per row; 8 resident a SM x 132

// decay * x + scale * z, each step rounded.
__device__ __forceinline__ float axpy(float x, float z, float scale,
                                      float decay) {
  return __fadd_rn(__fmul_rn(decay, x), __fmul_rn(scale, z));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float& dst, float v) { dst = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& dst, float v) {
  dst = __float2bfloat16_rn(v);
}

// Elements i0 .. i0 + 7 of a bf16 row, one 16-byte access each way.
__device__ __forceinline__ void axpy_vec(__nv_bfloat16* p, uint32_t seed,
                                         uint32_t i0, float scale,
                                         float decay) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = __uint_as_float(w[k] << 16);
    const float hi = __uint_as_float(w[k] & 0xFFFF0000u);
    const __nv_bfloat162 out = __floats2bfloat162_rn(
        axpy(lo, rz::counter_normal(seed, i0 + 2 * k), scale, decay),
        axpy(hi, rz::counter_normal(seed, i0 + 2 * k + 1), scale, decay));
    w[k] = *reinterpret_cast<const uint32_t*>(&out);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Elements i0 .. i0 + 3 of a float32 row.
__device__ __forceinline__ void axpy_vec(float* p, uint32_t seed,
                                         uint32_t i0, float scale,
                                         float decay) {
  float4 v = *reinterpret_cast<const float4*>(p);
  v.x = axpy(v.x, rz::counter_normal(seed, i0), scale, decay);
  v.y = axpy(v.y, rz::counter_normal(seed, i0 + 1), scale, decay);
  v.z = axpy(v.z, rz::counter_normal(seed, i0 + 2), scale, decay);
  v.w = axpy(v.w, rz::counter_normal(seed, i0 + 3), scale, decay);
  *reinterpret_cast<float4*>(p) = v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
zo_axpy_2d_kernel(T* __restrict__ theta, const bool* __restrict__ mask,
                  long long n, uint32_t seed, float scale, float decay) {
  constexpr int V = 16 / sizeof(T);           // elements per 16 bytes
  const uint32_t l = blockIdx.y;
  if (!mask[l]) return;                       // dropped layer: no work at all
  const uint32_t seed_l = rz::fold(seed, l);
  T* row = theta + (long long)l * n;
  const long long mis = reinterpret_cast<uintptr_t>(row) & 15;
  const long long head = min(n, ((16 - mis) & 15) / (long long)sizeof(T));
  const long long nvec = (n - head) / V;
  for (long long v = (long long)blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * THREADS) {
    const long long i0 = head + v * V;
    axpy_vec(row + i0, seed_l, static_cast<uint32_t>(i0), scale, decay);
  }
  // Head (threads 0 .. V-1) and tail (V .. 2V-1), one element each.
  if (blockIdx.x == 0 && threadIdx.x < 2 * V) {
    const int t = threadIdx.x;
    const long long i = t < V ? t : head + nvec * V + (t - V);
    if (t < V ? i < head : i < n) {
      const float z = rz::counter_normal(seed_l, static_cast<uint32_t>(i));
      from_f32(row[i], axpy(to_f32(row[i]), z, scale, decay));
    }
  }
}

template <typename T>
int launch(void* theta, const void* mask, long long L, long long n,
           uint32_t seed, float scale, float decay, void* stream) {
  if (L <= 0 || n <= 0) return 0;
  const long long vecs = n / (16 / (long long)sizeof(T));
  long long blocks = (vecs + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
  dim3 grid((unsigned)blocks, (unsigned)L);
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
