// The port's norm kernel: LayerNorm (scale, bias) or RMSNorm (scale) over
// the last dim of an (R, D) row view, one launch for all rows.
//
// No Pallas kernel answers to it: the reference leaves the norms to XLA,
// which fuses each into one pass.  In eager PyTorch the same float32 maths
// is a dozen kernels (cast, mean, subtract, square, mean, add, rsqrt,
// subtract, three broadcast multiply/adds, cast), each a pass over the
// rows in float32.  Here each row is read once and written once.
//
//   LayerNorm:  mu = sum(x) / D,  var = sum((x - mu)^2) / D,
//               y = ((x - mu) * rsqrtf(var + eps)) * scale + bias
//   RMSNorm:    ms = sum(x^2) / D,
//               y = (x * rsqrtf(ms + eps)) * scale
//
// Every step is a separately rounded float32 operation (built with
// --fmad=false), in the plain version's order, and y is rounded once to
// x's type; only the summation order of the two means differs from
// PyTorch's reductions.  The sums are a fixed tree (each thread's
// elements in order, a warp's xor butterfly, then the warps' partials in
// order from shared memory): no atomics, so a launch is bit-deterministic.
//
// Bound on the H100: bytes.  A row stays in registers between its two
// passes: K 16-byte vectors a thread (8 bf16 or 4 float32), vector k of
// thread t covering elements (k * nt + t) * V .. + V - 1.
// - Rows of D >= 1024 take one CTA each: nt = 128 threads, or 256/512
//   where K would pass 8 (bf16 D = 5120 is K = 5 at 128).
// - Narrower rows take one warp each (nt = 32), four rows a CTA.
// - A row base that is not 16-byte aligned (a strided slice, an odd D)
//   and a partial last vector take scalar accesses in the same code.
// - scale/bias are (G, D) float32: row r reads group r / rows_per_group.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int MAX_K = 8;        // vectors a thread
constexpr int CTA_MIN_D = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The sum of s over the nt threads of a row, the same bits in each.
// nt = 32: the warp alone; else one row a CTA, its warps' partials
// through red[0 .. nt/32 - 1].
__device__ __forceinline__ float row_sum(float s, int nt, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (nt == 32) return s;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < nt / 32; ++w) t = __fadd_rn(t, red[w]);
  return t;
}

template <typename T, int K>
__global__ void __launch_bounds__(512)
norm_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, long long R, int D,
                 long long xstride, long long rows_per_group, int nt,
                 float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[2][16];
  const int t = threadIdx.x % nt;
  const long long r = (long long)blockIdx.x * (blockDim.x / nt) +
                      threadIdx.x / nt;
  if (r >= R) return;                  // nt = 32 only: a warp at a time
  const T* xr = x + r * xstride;
  T* yr = y + r * (long long)D;
  const long long g = r / rows_per_group;
  const float* sc = scale + g * D;
  const float* bi = bias ? bias + g * D : nullptr;
  const bool x_vec = aligned16(xr);
  const bool y_vec =
      aligned16(yr) && aligned16(sc) && (!bi || aligned16(bi));

  float v[K][V];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = (k * nt + t) * V;
    if (x_vec && e0 + V <= D) {
      load_vec(xr + e0, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[k][j] = e0 + j < D ? to_f32(xr[e0 + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      s = __fadd_rn(s, bi ? v[k][j] : __fmul_rn(v[k][j], v[k][j]));
  }
  const float fD = (float)D;
  float rs;
  if (bi) {                            // LayerNorm: v <- x - mu, then var
    const float mu = __fdiv_rn(row_sum(s, nt, red[0]), fD);
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e0 = (k * nt + t) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[k][j] = e0 + j < D ? __fsub_rn(v[k][j], mu) : 0.f;
        s2 = __fadd_rn(s2, __fmul_rn(v[k][j], v[k][j]));
      }
    }
    rs = rsqrtf(__fadd_rn(__fdiv_rn(row_sum(s2, nt, red[1]), fD), eps));
  } else {
    rs = rsqrtf(__fadd_rn(__fdiv_rn(row_sum(s, nt, red[0]), fD), eps));
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e0 = (k * nt + t) * V;
    if (e0 >= D) break;
    float o[V];
    if (y_vec && e0 + V <= D) {
      float a[V], b[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        load_vec(sc + e0 + j, a + j);
        if (bi) load_vec(bi + e0 + j, b + j);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = __fmul_rn(__fmul_rn(v[k][j], rs), a[j]);
        if (bi) o[j] = __fadd_rn(o[j], b[j]);
      }
      store_vec(yr + e0, o);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = e0 + j;
        if (e < D) {
          float u = __fmul_rn(__fmul_rn(v[k][j], rs), sc[e]);
          if (bi) u = __fadd_rn(u, bi[e]);
          store1(yr + e, u);
        }
      }
    }
  }
}

template <typename T, int K>
int launch_k(const void* x, void* y, const float* scale, const float* bias,
             long long R, int D, long long xstride, long long rows_per_group,
             int nt, float eps, cudaStream_t stream) {
  const int block = nt < 128 ? 128 : nt;
  const long long rows_per_block = block / nt;
  const long long grid = (R + rows_per_block - 1) / rows_per_block;
  norm_rows_kernel<T, K><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias, R, D,
      xstride, rows_per_group, nt, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, const float* scale, const float* bias,
           long long R, int D, long long xstride, long long rows_per_group,
           float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = (D + V - 1) / V;
  int nt = D < CTA_MIN_D ? 32 : 128;
  while ((nvec + nt - 1) / nt > MAX_K && nt < 512) nt *= 2;
  const int K = (nvec + nt - 1) / nt;
  switch (K) {
#define NORM_K(k)                                                          \
  case k:                                                                  \
    return launch_k<T, k>(x, y, scale, bias, R, D, xstride,                \
                          rows_per_group, nt, eps, stream);
    NORM_K(1) NORM_K(2) NORM_K(3) NORM_K(4)
    NORM_K(5) NORM_K(6) NORM_K(7) NORM_K(8)
#undef NORM_K
  }
  return (int)cudaErrorInvalidValue;   // D too wide for MAX_K x 512 x V
}

}  // namespace

// Rows r = 0 .. R-1 of x start at x + r * xstride (elements) and hold D
// contiguous elements; y is contiguous (R, D).  scale, bias (nullptr for
// RMSNorm) are contiguous float32 (G, D), G = R / rows_per_group.
// dtype: 0 = float32, 1 = bfloat16.  The launch goes to ``device``'s
// ``stream``; the calling thread's current device is put back after it.
// Returns the cudaError_t of the launch.
extern "C" int norm_rows_launch(const void* x, void* y, const void* scale,
                                const void* bias, long long R, int D,
                                long long xstride, long long rows_per_group,
                                int dtype, float eps, int device,
                                void* stream) {
  if (R <= 0) return 0;
  if (D <= 0 || rows_per_group <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = (cudaStream_t)stream;
  const int ret =
      dtype == 0
          ? launch<float>(x, y, s, b, R, D, xstride, rows_per_group, eps, st)
          : launch<__nv_bfloat16>(x, y, s, b, R, D, xstride, rows_per_group,
                                  eps, st);
  if (current != device) cudaSetDevice(current);
  return ret;
}
