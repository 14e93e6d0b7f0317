// Exhaustive check of the counter RNG's float part (rng.cuh).
//
// For every m in [0, 2^24) — every value h >> 8 can take, so every u the
// RNG can draw — compares r_fast(h) with r_ref(u) and c_fast(h) with
// c_ref(u), h = m << 8, u = uniform01(h), bit for bit (r_fast and c_fast
// read only the top 24 bits of h).  Built with the kernels'
// own flags, so both sides compile as the kernels compile them.
#include <cuda_runtime.h>
#include <cstdint>

#include "rng.cuh"

namespace {

constexpr int THREADS = 256;
constexpr uint32_t INPUTS = 1u << 24;

// out[0], out[1]: mismatches of r and of c; out[2], out[3]: the smallest
// m at which each differs (left as set by the caller when none does).
__global__ void __launch_bounds__(THREADS)
rng_check_kernel(unsigned long long* __restrict__ out) {
  const uint32_t m = blockIdx.x * THREADS + threadIdx.x;
  const uint32_t h = m << 8;
  const float u = rz::uniform01(h);
  if (__float_as_uint(rz::r_fast(h)) != __float_as_uint(rz::r_ref(u))) {
    atomicAdd(&out[0], 1ull);
    atomicMin(&out[2], (unsigned long long)m);
  }
  if (__float_as_uint(rz::c_fast(h)) != __float_as_uint(rz::c_ref(u))) {
    atomicAdd(&out[1], 1ull);
    atomicMin(&out[3], (unsigned long long)m);
  }
}

}  // namespace

// out: 4 uint64 on the device.  Returns the cudaError_t of the launch.
extern "C" int rng_check_launch(void* out, void* stream) {
  rng_check_kernel<<<INPUTS / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<unsigned long long*>(out));
  return (int)cudaGetLastError();
}
