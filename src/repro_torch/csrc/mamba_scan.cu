// The port's selective-scan kernel: Mamba's diagonal SSM over a whole
// sequence, with its softplus in front and its skip and gate behind, one
// launch for all batch rows and channels.
//
// No Pallas kernel answers to it: the reference's scan is XLA's
// lax.associative_scan, fused by the compiler.  The port's plain version
// (models/ssm.py: _mamba_scan, a doubling scan in PyTorch ops) builds
// exp(dt A) and dt B x as float32 (B, S, Di, St) tensors and rewrites them
// at each of its log2(S) steps: about 44 GB of traffic a layer at
// (16, 63, 8192, 16), where reading the inputs once is 83 MB.
//
//   delta = softplus(dt + dt_b)            logaddexp(v, 0), as JAX's
//   h_s   = exp(delta A_s) h_s + B_s (delta x),   A_s = -exp(A_log_s)
//   y     = (sum_s h_s C_s + Dskip x) * silu(z)   rounded once to x's type
//
// One thread owns one (batch row, channel) and keeps its St float32
// states in registers across the whole sequence, so h never leaves the
// SM.  The step is sequential in t; the St states are independent chains,
// so each step has St-way parallelism for the exponentials and the
// multiply-adds.  A CTA of SCAN_THREADS channels shares one batch row:
// its B and C (St floats each a step) are staged TILE steps at a time in
// shared memory and read as broadcasts.  dt, x and z are read once and y
// written once, each warp on 32 consecutive channels of one step
// (coalesced); the next step's three values are loaded before the current
// step's arithmetic.
//
// Bound on the H100: not the bytes.  At (16, 63, 8192, 16) the bytes (dt
// 4, x 2, z 2, y 2 a channel-step; B and C) take 24.7 us at 3.35 TB/s,
// but a channel-step issues St = 16 exponentials and 4 more for the
// softplus and the gate on the SFU (16 a clock an SM: 165 M, 40 us), and
// 5 instructions a state element (the exponent's multiply, ex2, B's
// multiply, the state's and C's multiply-adds) beside the step's own.
// So the work is the SFU's and the issue slots': exp(delta A_s) is ex2
// of delta * (A_s log2 e), A_s log2 e formed once a thread; the softplus
// (JAX's logaddexp(v, 0) = max(v, 0) + log(1 + exp(-|v|))) and the
// gate's sigmoid take the SFU's exp, log and reciprocal (a few float32
// ulp); 8 CTAs an SM keep 32 warps to hide the SFU's latency.  Summation
// order and those roundings differ from the plain version's (a tree of
// partial products, the library's exp and log), so the two agree to
// float32 rounding, not in bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int SCAN_THREADS = 128;
// 8 CTAs an SM (64 registers a thread) hold 135,168 channels at once,
// so Jamba's train rows, 16 x 8192, run in one wave where 72 registers left 7
// CTAs an SM and a second wave of 100 CTAs.
constexpr int SCAN_BLOCKS_PER_SM = 8;
constexpr int TILE = 32;        // steps of B and C staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// 2^x on the SFU, denormal results flushed to zero: one instruction,
// where exp2f adds the denormal range's handling around the same one.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int NS>
__global__ void __launch_bounds__(SCAN_THREADS, SCAN_BLOCKS_PER_SM)
mamba_scan_kernel(const float* __restrict__ dt, long long dt_stride,
                  const float* __restrict__ dt_b,
                  const float* __restrict__ A_log,
                  const T* __restrict__ x, long long x_stride,
                  const float* __restrict__ Bm, long long b_stride,
                  const float* __restrict__ Cm, long long c_stride,
                  const float* __restrict__ Dskip,
                  const T* __restrict__ z, long long z_stride,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ h_out, int S, int Di) {
  __shared__ float4 bc[TILE][NS / 2];   // B then C, NS floats each a step
  const int b = blockIdx.y;
  const int d = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const bool live = d < Di;
  const int dc = live ? d : 0;          // a dead lane reads channel 0

  constexpr float LOG2E = 1.4426950408889634f;
  float a2[NS], h[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a2[s] = __fmul_rn(-expf(A_log[dc * NS + s]), LOG2E);
    h[s] = h0 ? h0[((long long)b * Di + dc) * NS + s] : 0.f;
  }
  const float bias = dt_b[dc], skip = Dskip[dc];
  const long long row0 = (long long)b * S;

  // this thread's channel of row 0 of its batch row; each step moves
  // the pointers one row on, and loads the next step's values before the
  // current step's arithmetic
  const float* pdt = dt + row0 * dt_stride + dc;
  const T* px = x + row0 * x_stride + dc;
  const T* pz = z + row0 * z_stride + dc;
  T* py = y + row0 * (long long)Di + dc;
  float n_dt = 0.f, n_x = 0.f, n_z = 0.f;
  if (S > 0) {
    n_dt = *pdt;
    n_x = to_f32(*px);
    n_z = to_f32(*pz);
  }
  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int nt = min(TILE, S - t0);
    __syncthreads();
    float* tile = reinterpret_cast<float*>(bc);
    for (int e = threadIdx.x; e < TILE * 2 * NS; e += SCAN_THREADS) {
      const int t = e / (2 * NS), j = e % (2 * NS);
      float v = 0.f;
      if (t < nt) {
        const long long r = row0 + t0 + t;
        v = j < NS ? Bm[r * b_stride + j] : Cm[r * c_stride + (j - NS)];
      }
      tile[e] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      const float vdt = n_dt, xv = n_x, zv = n_z;
      if (t0 + t + 1 < S) {
        pdt += dt_stride;
        px += x_stride;
        pz += z_stride;
        n_dt = *pdt;
        n_x = to_f32(*px);
        n_z = to_f32(*pz);
      }
      const float v = __fadd_rn(vdt, bias);
      const float delta =
          __fadd_rn(fmaxf(v, 0.f), __logf(__fadd_rn(1.f, __expf(-fabsf(v)))));
      const float dx = __fmul_rn(delta, xv);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < NS; q += 4) {
        const float4 ub = bc[t][q / 4];
        const float4 uc = bc[t][NS / 4 + q / 4];
        const float bs[4] = {ub.x, ub.y, ub.z, ub.w};
        const float cs[4] = {uc.x, uc.y, uc.z, uc.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float da = ex2(__fmul_rn(delta, a2[q + i]));
          h[q + i] = __fmaf_rn(da, h[q + i], __fmul_rn(bs[i], dx));
          acc = __fmaf_rn(h[q + i], cs[i], acc);
        }
      }
      const float gate = __fdividef(zv, __fadd_rn(1.f, __expf(-zv)));
      const float out = __fmul_rn(__fadd_rn(acc, __fmul_rn(skip, xv)), gate);
      if (live) store1(py, out);
      py += Di;
    }
  }
  if (h_out && live) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      h_out[((long long)b * Di + d) * NS + s] = h[s];
  }
}

template <typename T, int NS>
int launch_ns(const float* dt, long long dts, const float* dt_b,
              const float* A_log, const void* x, long long xs,
              const float* Bm, long long bs, const float* Cm, long long cs,
              const float* Dskip, const void* z, long long zs,
              const float* h0, void* y, float* h_out, int Bn, int S, int Di,
              cudaStream_t stream) {
  const dim3 grid((Di + SCAN_THREADS - 1) / SCAN_THREADS, Bn);
  mamba_scan_kernel<T, NS><<<grid, SCAN_THREADS, 0, stream>>>(
      dt, dts, dt_b, A_log, static_cast<const T*>(x), xs, Bm, bs, Cm, cs,
      Dskip, static_cast<const T*>(z), zs, h0, static_cast<T*>(y), h_out, S,
      Di);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const float* dt, long long dts, const float* dt_b,
           const float* A_log, const void* x, long long xs, const float* Bm,
           long long bs, const float* Cm, long long cs, const float* Dskip,
           const void* z, long long zs, const float* h0, void* y,
           float* h_out, int Bn, int S, int Di, int St, cudaStream_t stream) {
  switch (St) {
#define SCAN_NS(n)                                                        \
  case n:                                                                 \
    return launch_ns<T, n>(dt, dts, dt_b, A_log, x, xs, Bm, bs, Cm, cs,   \
                           Dskip, z, zs, h0, y, h_out, Bn, S, Di, stream);
    SCAN_NS(4) SCAN_NS(8) SCAN_NS(16)
#undef SCAN_NS
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Row r = b * S + t of dt, x, z, B and C starts at its pointer plus
// r * (its stride) elements; dt, B, C float32, x and z of ``dtype``
// (0 = float32, 1 = bfloat16).  dt_b, Dskip (Di,), A_log (Di, St), h0
// and h_out (Bn, Di, St) float32 contiguous; h0 nullptr for zeros, h_out
// nullptr for no final state.  y is contiguous (Bn, S, Di) of ``dtype``.
// The launch goes to ``device``'s ``stream``; the calling thread's
// current device is put back after it.  Returns the cudaError_t.
extern "C" int mamba_scan_launch(
    const void* dt, long long dt_stride, const void* dt_b, const void* A_log,
    const void* x, long long x_stride, const void* Bm, long long b_stride,
    const void* Cm, long long c_stride, const void* Dskip, const void* z,
    long long z_stride, const void* h0, void* y, void* h_out, int Bn, int S,
    int Di, int St, int dtype, int device, void* stream) {
  if (Bn <= 0 || Di <= 0) return 0;
  if (S < 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_b = static_cast<const float*>(dt_b);
  const float* f_a = static_cast<const float*>(A_log);
  const float* f_B = static_cast<const float*>(Bm);
  const float* f_C = static_cast<const float*>(Cm);
  const float* f_D = static_cast<const float*>(Dskip);
  const float* f_h0 = static_cast<const float*>(h0);
  float* f_h = static_cast<float*>(h_out);
  cudaStream_t st = (cudaStream_t)stream;
  const int ret =
      dtype == 0
          ? launch<float>(f_dt, dt_stride, f_b, f_a, x, x_stride, f_B,
                          b_stride, f_C, c_stride, f_D, z, z_stride, f_h0, y,
                          f_h, Bn, S, Di, St, st)
          : launch<__nv_bfloat16>(f_dt, dt_stride, f_b, f_a, x, x_stride,
                                  f_B, b_stride, f_C, c_stride, f_D, z,
                                  z_stride, f_h0, y, f_h, Bn, S, Di, St, st);
  if (current != device) cudaSetDevice(current);
  return ret;
}
