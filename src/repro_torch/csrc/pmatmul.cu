// K3/K4: the virtual-perturbation matmul, P probes off one pass over W.
//
// Replaces the Pallas TPU kernels repro/fused/matmul.py::pmatmul_stack
// (K3, pallas_call at :273) and ::pmatmul (K4, pallas_call at :154):
//
//   out[p] = x[p] @ (W + scale[p] * z),   p < P
//
// where z is never stored: each block makes the z of its W tile from the
// counter RNG (rng.cuh) under the counter window
//   counter(k, n) = trans ? (col_off + n) * ld + (row_off + k)
//                         : (row_off + k) * ld + (col_off + n)     (uint32)
// (W + s*z) is rounded to bf16 before the product, accumulation is f32.
// K4 is this kernel at P = 1; inactive probes carry scale 0 (exact:
// bf16(w + 0*z) == w), and a tile with no active probe skips the RNG.
// With a shared seed (the +-eps*z pair) z is made once per element for
// all probes.  Each probe's accumulation runs the same loop as at P = 1,
// so a P = 2 call equals two P = 1 calls bit for bit.
//
// W is read in its stored layout through its strides, so the tied head
// reads embed/tok (V, D) as the logical (D, V) matrix with no transpose
// copy, and ragged M, N and K are masked here, not padded on the host.
//
// Bound on the H100: at the training shapes (M = 1008 rows per probe,
// P = 2) the product is compute-bound on the tensor cores (989 TFLOP/s
// bf16); the RNG adds some 40 CUDA-core operations per W element per
// M-tile.  This first version: 128x64 output tiles per block, BK = 32,
// W tile perturbed once per block into shared memory for all P probes,
// WMMA bf16 16x16x16 products from shared memory, no pipelining.
// wgmma, TMA and a persistent schedule that makes each z once are later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

#include "rng.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 64, BK = 32, THREADS = 256;
constexpr int XPAD = BK + 8;   // row strides chosen for conflict-free
constexpr int WPAD = BN + 8;   // fragment loads and 32-byte alignment

template <int P>
struct Args {
  const bf16* x;           // (P, M, K) contiguous
  const bf16* w;           // logical (K, N): w[k * swk + n * swn]
  bf16* out;               // (P, M, N) contiguous
  long long swk, swn;
  int M, N, K;
  uint32_t seed[P];
  float scale[P];          // 0 for an inactive probe
  int any_active, shared_seed, trans, xvec, wvec;
  uint32_t row_off, col_off, ld;
};

template <int P>
__device__ __forceinline__ void perturb(const Args<P>& a, bf16 w, int gk,
                                        int gn, bf16 (&dst)[P]) {
  if (gk >= a.K || gn >= a.N) {
#pragma unroll
    for (int p = 0; p < P; ++p) dst[p] = __float2bfloat16_rn(0.0f);
    return;
  }
  if (!a.any_active) {
#pragma unroll
    for (int p = 0; p < P; ++p) dst[p] = w;
    return;
  }
  const uint32_t row = a.row_off + (uint32_t)gk, col = a.col_off + (uint32_t)gn;
  const uint32_t idx = a.trans ? col * a.ld + row : row * a.ld + col;
  const float wf = __bfloat162float(w);
  const float z0 = rz::counter_normal(a.seed[0], idx);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float z = (p == 0 || a.shared_seed) ? z0
                                              : rz::counter_normal(a.seed[p], idx);
    dst[p] = __float2bfloat16_rn(__fadd_rn(wf, __fmul_rn(a.scale[p], z)));
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS) pmatmul_kernel(const Args<P> a) {
  __shared__ __align__(32) bf16 Xs[P][BM][XPAD];
  __shared__ __align__(32) bf16 Ws[P][BK][WPAD];
  __shared__ __align__(32) float Cs[THREADS / 32][16][16];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;           // 4 x 2 warps, 32x32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[P][2][2];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[p][i][j], 0.0f);

  for (int k0 = 0; k0 < a.K; k0 += BK) {
    // ---- x tiles: (BM, BK) per probe, 8 bf16 per thread-step
#pragma unroll
    for (int p = 0; p < P; ++p) {
      for (int e = tid; e < BM * BK / 8; e += THREADS) {
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + c;
        const bf16* src = a.x + ((long long)p * a.M + gm) * a.K + gk;
        if (a.xvec && gm < a.M && gk + 8 <= a.K) {
          *reinterpret_cast<uint4*>(&Xs[p][r][c]) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            Xs[p][r][c + i] = (gm < a.M && gk + i < a.K) ? src[i]
                                                         : __float2bfloat16_rn(0.0f);
        }
      }
    }
    // ---- W tile: (BK, BN), perturbed once for all probes
    if (a.swn == 1) {                        // stored row-major: runs along n
      for (int e = tid; e < BK * BN / 8; e += THREADS) {
        const int kk = e / (BN / 8), nn = (e % (BN / 8)) * 8;
        const int gk = k0 + kk, gn = n0 + nn;
        __align__(16) bf16 vals[8];
        const bf16* src = a.w + (long long)gk * a.swk + gn;
        if (a.wvec && gk < a.K && gn + 8 <= a.N) {
          *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            vals[i] = (gk < a.K && gn + i < a.N) ? src[i] : __float2bfloat16_rn(0.0f);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          bf16 d[P];
          perturb<P>(a, vals[i], gk, gn + i, d);
#pragma unroll
          for (int p = 0; p < P; ++p) Ws[p][kk][nn + i] = d[p];
        }
      }
    } else {                                 // stored transposed: runs along k
      for (int e = tid; e < BK * BN / 8; e += THREADS) {
        const int nn = e / (BK / 8), kk = (e % (BK / 8)) * 8;
        const int gk = k0 + kk, gn = n0 + nn;
        __align__(16) bf16 vals[8];
        const bf16* src = a.w + (long long)gn * a.swn + gk;
        if (a.wvec && gn < a.N && gk + 8 <= a.K) {
          *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            vals[i] = (gn < a.N && gk + i < a.K) ? src[i] : __float2bfloat16_rn(0.0f);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          bf16 d[P];
          perturb<P>(a, vals[i], gk + i, gn, d);
#pragma unroll
          for (int p = 0; p < P; ++p) Ws[p][kk + i][nn] = d[p];
        }
      }
    }
    __syncthreads();
    // ---- tensor-core products, the same sequence for every probe
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &Xs[p][wm * 32 + i * 16][kk], XPAD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Ws[p][kk][wn * 32 + j * 16], WPAD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[p][i][j], fa[i], fb[j], acc[p][i][j]);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: f32 -> bf16 (round to nearest even), masked store
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(&Cs[warp][0][0], acc[p][i][j], 16,
                                wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = e % 16;
          const int gm = m0 + wm * 32 + i * 16 + r, gn = n0 + wn * 32 + j * 16 + c;
          if (gm < a.M && gn < a.N)
            a.out[((long long)p * a.M + gm) * a.N + gn] = __float2bfloat16_rn(Cs[warp][r][c]);
        }
        __syncwarp();
      }
}

template <int P>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           long long swk, long long swn, const unsigned* seeds,
           const float* scales, int any_active, int shared_seed,
           unsigned row_off, unsigned col_off, unsigned ld, int trans,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (swn != 1 && swk != 1) return (int)cudaErrorInvalidValue;
  Args<P> a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.swk = swk; a.swn = swn; a.M = M; a.N = N; a.K = K;
  for (int p = 0; p < P; ++p) { a.seed[p] = seeds[p]; a.scale[p] = scales[p]; }
  a.any_active = any_active; a.shared_seed = shared_seed; a.trans = trans;
  a.xvec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const long long lead = (swn == 1) ? swk : swn;
  a.wvec = (lead % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  a.row_off = row_off; a.col_off = col_off; a.ld = ld;
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  pmatmul_kernel<P><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// P in {1, 2}; bf16 only.  Returns the cudaError_t of the launch.
extern "C" int pmatmul_launch(int P, const void* x, const void* w, void* out,
                              int M, int N, int K, long long swk,
                              long long swn, const unsigned* seeds,
                              const float* scales, int any_active,
                              int shared_seed, unsigned row_off,
                              unsigned col_off, unsigned ld, int trans,
                              void* stream) {
  if (P == 1)
    return launch<1>(x, w, out, M, N, K, swk, swn, seeds, scales, any_active,
                     shared_seed, row_off, col_off, ld, trans, stream);
  if (P == 2)
    return launch<2>(x, w, out, M, N, K, swk, swn, seeds, scales, any_active,
                     shared_seed, row_off, col_off, ld, trans, stream);
  return (int)cudaErrorInvalidValue;
}
