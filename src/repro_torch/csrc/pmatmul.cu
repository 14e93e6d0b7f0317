// K3/K4: the virtual-perturbation matmul, P probes off one pass over W.
//
// Replaces the Pallas TPU kernels repro/fused/matmul.py::pmatmul_stack
// (K3, pallas_call at :273) and ::pmatmul (K4, pallas_call at :154):
//
//   out[p] = x[p] @ bf16(W + scale[p] * z),   p < P in {1, 2}
//
// z is never stored: a block makes the z of its W tile from the counter
// RNG (rng.cuh) under the counter window
//   counter(k, n) = trans ? (col_off + n) * ld + (row_off + k)
//                         : (row_off + k) * ld + (col_off + n)     (uint32)
// w + s*z is rounded to bf16 before the product; accumulation is f32 and
// the output is rounded to bf16 (nearest even).  With a shared seed (the
// +-eps pair) z is drawn once per element for all probes.  A launch with
// no active probe draws nothing: the tensor cores read the raw W tile.
//
// Bound on the H100: a launch with no active probe (30 of 40 layers a
// step) is a plain bf16 GEMM, compute-bound on the tensor cores
// (989 TFLOP/s).  An active launch draws K*N*ceil(M/BMP) z, each some
// hundred CUDA-core instructions (full-precision logf/cosf/sqrtf, no
// FMA contraction), which takes several times longer than its product:
// it is bound by the RNG on the CUDA cores, and the design hides the
// product and the loads under it.
//
// Design (sm_90a), two tilings, one per activity (calls of the same
// activity take the same one, which keeps P = 2 == 2 x P = 1 bitwise):
// - Inactive: a block holds 256 rows of x (128 of each probe at P = 2,
//   256 of the one probe at P = 1) and a BN = 128 column tile of W; two
//   warpgroups of two 64 x 128 f32 accumulators (128 registers a thread).
// - Active: 512 rows (BMP = 512/P rows a probe) and BN = 64, so the
//   stacked pair draws each z 4 times at M = 1008 and the head twice,
//   against 8 and 8 with 128-row tiles; four warpgroups of two 64 x 64
//   accumulators, so 16 warps share the RNG.
// - The grid walks M fastest, so the blocks of one W tile run together
//   and W comes from device memory about once; x (20 MB at most) stays
//   in the 50 MB L2.
// - Rings in shared memory, 128-byte swizzle: x (rows x 64, 4 stages
//   inactive / 2 active) and raw W (64 x BN, 4 stages), each slot with an
//   mbarrier.  Thread 0 fills a slot with TMA (cp.async.bulk.tensor,
//   tensor maps from cuTensorMapEncodeTiled on the host); an operand TMA
//   cannot describe (base or row pitch not 16-byte aligned) is loaded by
//   every thread with masked loads into the same swizzled layout.
// - wgmma m64nBNk16 bf16 -> f32, both operands from shared memory.  x is
//   K-major; W is read in its stored layout: a projection's (K, N) W is
//   MN-major (transpose bit), the tied head's tok (V, D) is K-major.
//   One wgmma group stays in flight; a slot is refilled only after the
//   wgmma that read it has retired in every warpgroup.
// - Active: while the wgmma of k-tile kt runs, the same threads turn the
//   raw W of k-tile kt+1 into W~[p] = bf16(w + scale[p]*z), double
//   buffered in the same swizzled layout, so the RNG on the CUDA cores
//   overlaps the tensor cores.  Each element's counter comes from its
//   logical (k, n), recovered by undoing the swizzle.
// - Epilogue: accumulators to bf16 through shared memory, then 16-byte
//   masked stores (scalar when N is not a multiple of 8).
//
// Contracts: every output row runs the same wgmma sequence whatever P
// and whichever warpgroup owns it, so a P = 2 call equals two P = 1
// calls bit for bit at the same activity; a scale of 0 gives bf16(w) = w
// exactly.  The kernel allocates nothing and launches on the caller's
// stream.  Left for a second pass (ROADMAP 2b): drawing each z once per W
// element, warp specialisation with setmaxnreg, persistent scheduling.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <cstdint>

#include "rng.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;

// Tiles of one instantiation (see the design note): x rows a block
// holds, W columns, threads, ring depths of x and W.  Each of the
// THREADS/128 warpgroups owns SUB 64-row subtiles of BN/2 accumulators;
// subtile t of warpgroup g holds x rows t*RSTEP + g*64 ... + 63.
// Measured on the H100 at the FFN shape: the active tiling makes an
// inactive launch 0.866 ms against 0.607; 128-row probe tiles with the
// RNG in two warpgroups took 7.66 ms for an active launch, this 2.85.
template <bool ACTIVE> struct Tile {
  static constexpr int ROWS = ACTIVE ? 512 : 256, BN = ACTIVE ? 64 : 128;
  static constexpr int THREADS = ACTIVE ? 512 : 256;
  static constexpr int SX = ACTIVE ? 2 : 4, SW = 4;
  static constexpr int RSTEP = THREADS / 2, SUB = ROWS / RSTEP;
  static constexpr int NACC = BN / 2;
  static constexpr int X_BYTES = ROWS * BK * 2, W_BYTES = BK * BN * 2;
  static constexpr int PITCH = BN + 8;               // epilogue row, bf16
  template <int P> __host__ __device__ static constexpr int wt_bytes() {
    return ACTIVE ? 2 * P * W_BYTES : 0;
  }
  template <int P>                                   // + alignment, barriers
  __host__ __device__ static constexpr int smem() {
    return SX * X_BYTES + SW * W_BYTES + wt_bytes<P>() + 1024 + 128;
  }
  static_assert(SUB == 2, "two subtiles a warpgroup");
  static_assert(ROWS * PITCH * 2 <= SX * X_BYTES, "epilogue fits the x ring");
};

template <int P>
struct Args {
  const bf16* x;           // (P, M, K) contiguous
  const bf16* w;           // logical (K, N): w[k * swk + n * swn]
  bf16* out;               // (P, M, N) contiguous
  long long swk, swn;
  int M, N, K;
  uint32_t seed[P];
  float scale[P];          // 0 for an inactive probe
  int shared_seed, trans, x_tma, w_tma, out_vec;
  uint32_t row_off, col_off, ld;
};

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spins until the phase of parity `parity` completes; traps (a launch
// error, not a hung card) if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 128-byte-swizzle descriptor; byte offsets lbo/sbo.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
         | (uint64_t)1 << 62;
}

// Keeps the compiler from moving accumulator reads and writes across
// the asynchronous wgmma.
template <int SUB, int NACC>
__device__ __forceinline__ void fence_acc(float (&d)[SUB][NACC]) {
#pragma unroll
  for (int t = 0; t < SUB; ++t)
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[t][i]) :: "memory");
}

// d += A(64x16, K-major) @ B(16xN); TB = 1 when B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, %34;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TB), "r"(1));
}

template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %66;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TB), "r"(1));
}

// ---------------------------------------------------------- tile geometry
// Byte offset, inside a 128-byte-swizzled tile, of the 16-byte chunk
// `chunk` (0..7) of 128-byte row `row` (TMA's SWIZZLE_128B on a
// 1024-byte-aligned tile).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Masked per-thread loads of a stage's x tile into the swizzled layout
// TMA would have written: row r is row m0 + r % BMP of probe r / BMP.
template <int P, bool ACTIVE>
__device__ void thread_load_x(const Args<P>& a, uint8_t* xs, int m0, int k0) {
  using T = Tile<ACTIVE>;
  constexpr int BMP = T::ROWS / P;
  for (int q = threadIdx.x; q < T::ROWS * 8; q += T::THREADS) {
    const int r = q >> 3, c = q & 7;
    const int gm = m0 + r % BMP, gk = k0 + c * 8;
    const bf16* src = a.x + ((long long)(r / BMP) * a.M + gm) * a.K;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = (gm < a.M && gk + e < a.K) ? src[gk + e]
                                        : __float2bfloat16_rn(0.0f);
    *reinterpret_cast<uint4*>(xs + swz(r, c)) = *reinterpret_cast<uint4*>(v);
  }
}

// The same for a W tile: K-major, BN rows of n with k along a row; or
// MN-major, BN/64 boxes of BK rows of k with n along a row.
template <int P, bool KMAJ, bool ACTIVE>
__device__ void thread_load_w(const Args<P>& a, uint8_t* ws, int n0, int k0) {
  using T = Tile<ACTIVE>;
  constexpr int CPR = T::BN / 8;             // chunks per k row, MN-major
  for (int q = threadIdx.x; q < BK * T::BN / 8; q += T::THREADS) {
    __align__(16) bf16 v[8];
    int off;
    if (KMAJ) {
      const int n = q >> 3, c = q & 7, gn = n0 + n, gk = k0 + c * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (gn < a.N && gk + e < a.K)
                   ? a.w[(long long)gn * a.swn + (gk + e) * a.swk]
                   : __float2bfloat16_rn(0.0f);
      off = swz(n, c);
    } else {
      const int k = q / CPR, c = q % CPR, gk = k0 + k, gn = n0 + c * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (gk < a.K && gn + e < a.N)
                   ? a.w[(long long)gk * a.swk + (gn + e) * a.swn]
                   : __float2bfloat16_rn(0.0f);
      off = (c >> 3) * (BK * 128) + swz(k, c & 7);
    }
    *reinterpret_cast<uint4*>(ws + off) = *reinterpret_cast<uint4*>(v);
  }
}

// Fill x ring slot `s` with k-tile `kt`: TMA from thread 0 where the
// operand allows it, else per-thread loads.  Every thread calls this.
template <int P, bool ACTIVE>
__device__ __forceinline__ void load_x(const Args<P>& a,
                                       const CUtensorMap* map, uint8_t* xs,
                                       uint32_t bar, int kt, int m0) {
  using T = Tile<ACTIVE>;
  constexpr int BMP = T::ROWS / P;
  if (threadIdx.x == 0) {
    fence_async_smem();
    mbar_arrive_tx(bar, a.x_tma ? T::X_BYTES : 0);
    if (a.x_tma) {
#pragma unroll
      for (int b = 0; b < T::ROWS / 128; ++b)
        tma_load(smem_u32(xs + b * 128 * 128), map, bar, kt * BK,
                 (b * 128 / BMP) * a.M + m0 + (b * 128) % BMP);
    }
  }
  if (!a.x_tma) {
    thread_load_x<P, ACTIVE>(a, xs, m0, kt * BK);
    fence_async_smem();
  }
}

template <int P, bool KMAJ, bool ACTIVE>
__device__ __forceinline__ void load_w(const Args<P>& a,
                                       const CUtensorMap* map, uint8_t* ws,
                                       uint32_t bar, int kt, int n0) {
  using T = Tile<ACTIVE>;
  if (threadIdx.x == 0) {
    fence_async_smem();
    mbar_arrive_tx(bar, a.w_tma ? T::W_BYTES : 0);
    if (a.w_tma) {
      if (KMAJ) {
        tma_load(smem_u32(ws), map, bar, kt * BK, n0);
      } else {
#pragma unroll
        for (int b = 0; b < T::BN / 64; ++b)
          tma_load(smem_u32(ws + b * BK * 128), map, bar, n0 + b * 64,
                   kt * BK);
      }
    }
  }
  if (!a.w_tma) {
    thread_load_w<P, KMAJ, ACTIVE>(a, ws, n0, kt * BK);
    fence_async_smem();
  }
}

// W~[p] = bf16(w + scale[p] * z) for one raw W tile, in the same layout.
// A chunk's logical (k, n) comes from undoing the swizzle.  Fully
// unrolled and branch-free, so the compiler can interleave the RNG of a
// thread's 16 elements: the CUDA cores are the bound here.
template <int P, bool KMAJ, bool ACTIVE, bool SHARED>
__device__ __forceinline__ void perturb_tile(const Args<P>& a,
                                             const uint8_t* raw, uint8_t* wt,
                                             int n0, int k0) {
  using T = Tile<ACTIVE>;
  static_assert(BK * T::BN / 8 % T::THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int it = 0; it < BK * T::BN / 8 / T::THREADS; ++it) {
    const int off = (threadIdx.x + it * T::THREADS) * 16;
    int k, n, dk, dn;                      // logical (k, n) of element 0
    if (KMAJ) {
      n = off >> 7;
      k = (((off >> 4) & 7) ^ (n & 7)) * 8;
      dk = 1; dn = 0;
    } else {
      k = (off >> 7) & (BK - 1);
      n = (off >> 13) * 64 + (((off >> 4) & 7) ^ (k & 7)) * 8;
      dk = 0; dn = 1;
    }
    __align__(16) bf16 w[8];
    __align__(16) bf16 v[P][8];
    *reinterpret_cast<uint4*>(w) = *reinterpret_cast<const uint4*>(raw + off);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int gk = k0 + k + e * dk, gn = n0 + n + e * dn;
      const bool in = gk < a.K && gn < a.N;
      const uint32_t row = a.row_off + (uint32_t)gk;
      const uint32_t col = a.col_off + (uint32_t)gn;
      const uint32_t idx = a.trans ? col * a.ld + row : row * a.ld + col;
      const float wf = __bfloat162float(w[e]);
      const float z0 = rz::counter_normal(a.seed[0], idx);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float z = (p == 0 || SHARED)
                            ? z0 : rz::counter_normal(a.seed[p], idx);
        v[p][e] = in ? __float2bfloat16_rn(
                           __fadd_rn(wf, __fmul_rn(a.scale[p], z)))
                     : __float2bfloat16_rn(0.0f);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint4*>(wt + p * T::W_BYTES + off) =
          *reinterpret_cast<uint4*>(v[p]);
  }
}

// With one seed for all probes (the +-eps pair) z is drawn once.
template <int P, bool KMAJ, bool ACTIVE>
__device__ __forceinline__ void perturb(const Args<P>& a, const uint8_t* raw,
                                        uint8_t* wt, int n0, int k0) {
  if (P == 1 || a.shared_seed)
    perturb_tile<P, KMAJ, ACTIVE, true>(a, raw, wt, n0, k0);
  else
    perturb_tile<P, KMAJ, ACTIVE, false>(a, raw, wt, n0, k0);
}

// The wgmmas of one k-tile: 4 k16 steps over the warpgroup's subtiles.
// Subtile t holds x rows t*RSTEP + wg*64 ... + 63, of probe t*RSTEP/BMP;
// `wb` is the W tile (W~[0], followed by W~[1] at P = 2, when ACTIVE).
template <int P, bool KMAJ, bool ACTIVE>
__device__ __forceinline__ void mma_tile(
    float (&acc)[Tile<ACTIVE>::SUB][Tile<ACTIVE>::NACC], const uint8_t* xs,
    const uint8_t* wb, int wg) {
  using T = Tile<ACTIVE>;
  constexpr int BMP = T::ROWS / P;
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
    for (int t = 0; t < T::SUB; ++t) {
      const uint8_t* w = wb + (ACTIVE ? (t * T::RSTEP / BMP) * T::W_BYTES : 0);
      const uint32_t xa = smem_u32(xs + (t * T::RSTEP + wg * 64) * 128)
                          + ks * 32;
      const uint32_t wa = smem_u32(w) + (KMAJ ? ks * 32 : ks * 16 * 128);
      wgmma<KMAJ ? 0 : 1>(acc[t], desc(xa, 16, 1024),
                          KMAJ ? desc(wa, 16, 1024)
                               : desc(wa, BK * 128, 1024));
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

template <int P, bool KMAJ, bool ACTIVE>
__global__ void __launch_bounds__(Tile<ACTIVE>::THREADS, 1)
pmatmul_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap, const Args<P> a) {
  using T = Tile<ACTIVE>;
  constexpr int SX = T::SX, SW = T::SW, BMP = T::ROWS / P;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* wring = xring + SX * T::X_BYTES;
  uint8_t* wt = wring + SW * T::W_BYTES;                 // [2][P] W~ tiles
  const uint32_t xfull = smem_u32(wt + T::template wt_bytes<P>());
  const uint32_t wfull = xfull + 8 * SX;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * BMP, n0 = blockIdx.y * T::BN;
  const int nk = (a.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < SX + SW; ++s) mbar_init(xfull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < SX && s < nk; ++s)
    load_x<P, ACTIVE>(a, &xmap, xring + s * T::X_BYTES, xfull + 8 * s, s, m0);
  for (int s = 0; s < SW && s < nk; ++s)
    load_w<P, KMAJ, ACTIVE>(a, &wmap, wring + s * T::W_BYTES, wfull + 8 * s,
                            s, n0);
  __syncthreads();

  float acc[T::SUB][T::NACC];
#pragma unroll
  for (int t = 0; t < T::SUB; ++t)
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[t][i] = 0.0f;
  fence_acc(acc);

  if (ACTIVE && nk > 0) {
    mbar_wait(wfull, 0);
    perturb<P, KMAJ, ACTIVE>(a, wring, wt, n0, 0);
    fence_async_smem();
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int sx = kt % SX, sw = kt % SW;
    mbar_wait(xfull + 8 * sx, (kt / SX) & 1);
    const uint8_t* wb;
    if (ACTIVE) {
      wb = wt + (kt & 1) * P * T::W_BYTES;
    } else {
      mbar_wait(wfull + 8 * sw, (kt / SW) & 1);
      wb = wring + sw * T::W_BYTES;
    }
    mma_tile<P, KMAJ, ACTIVE>(acc, xring + sx * T::X_BYTES, wb, wg);
    wgmma_wait<1>();                       // k-tile kt-1's wgmma retired
    __syncthreads();                       // ... in both warpgroups
    if (kt >= 1 && kt - 1 + SX < nk)
      load_x<P, ACTIVE>(a, &xmap, xring + ((kt - 1) % SX) * T::X_BYTES,
                        xfull + 8 * ((kt - 1) % SX), kt - 1 + SX, m0);
    if (ACTIVE) {                          // raw tile kt was perturbed
      if (kt + SW < nk)
        load_w<P, KMAJ, ACTIVE>(a, &wmap, wring + sw * T::W_BYTES,
                                wfull + 8 * sw, kt + SW, n0);
    } else if (kt >= 1 && kt - 1 + SW < nk) {
      load_w<P, KMAJ, ACTIVE>(a, &wmap, wring + ((kt - 1) % SW) * T::W_BYTES,
                              wfull + 8 * ((kt - 1) % SW), kt - 1 + SW, n0);
    }
    if (ACTIVE && kt + 1 < nk) {           // overlaps k-tile kt's wgmma
      const int s1 = (kt + 1) % SW;
      mbar_wait(wfull + 8 * s1, ((kt + 1) / SW) & 1);
      perturb<P, KMAJ, ACTIVE>(a, wring + s1 * T::W_BYTES,
                               wt + ((kt + 1) & 1) * P * T::W_BYTES, n0,
                               (kt + 1) * BK);
      fence_async_smem();
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();

  // ---- epilogue: f32 -> bf16 (nearest even) in shared memory, then
  // 16-byte rows out, masked at the ragged M and N edges.
  bf16* tile = reinterpret_cast<bf16*>(xring);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int t = 0; t < T::SUB; ++t)
#pragma unroll
    for (int i = 0; i < T::NACC; i += 2) {
      const int r = t * T::RSTEP + wg * 64 + warp * 16 + (lane >> 2)
                    + ((i >> 1) & 1) * 8;
      const int c = (i >> 2) * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(tile + r * T::PITCH + c) =
          __floats2bfloat162_rn(acc[t][i], acc[t][i + 1]);
    }
  __syncthreads();
  constexpr int CPR = T::BN / 8;
  for (int q = tid; q < T::ROWS * CPR; q += T::THREADS) {
    const int r = q / CPR, c = (q % CPR) * 8;
    const int gm = m0 + r % BMP, gn = n0 + c;
    if (gm >= a.M || gn >= a.N) continue;
    const bf16* src = tile + r * T::PITCH + c;
    bf16* dst = a.out + ((long long)(r / BMP) * a.M + gm) * a.N + gn;
    if (a.out_vec && gn + 8 <= a.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gn + e < a.N; ++e) dst[e] = src[e];
    }
  }
}

// ------------------------------------------------------------------- host
using EncodeFn = decltype(&cuTensorMapEncodeTiled);

EncodeFn encoder() {
  static EncodeFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeFn>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// A 2-D bf16 tensor map: `inner` contiguous elements, `outer` rows
// `pitch` elements apart, a box of box0 x box1, 128-byte swizzle, zeros
// out of bounds.
bool make_map(CUtensorMap* map, const void* base, long long inner,
              long long outer, long long pitch, int box0, int box1) {
  EncodeFn enc = encoder();
  if (!enc) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  cuuint32_t box[2] = {(cuuint32_t)box0, (cuuint32_t)box1};
  cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int P, bool KMAJ, bool ACTIVE>
int run(const Args<P>& a, long long pitch, cudaStream_t stream) {
  using T = Tile<ACTIVE>;
  CUtensorMap xmap = {}, wmap = {};
  if (a.x_tma && !make_map(&xmap, a.x, a.K, (long long)P * a.M, a.K, BK, 128))
    return (int)cudaErrorInvalidValue;
  if (a.w_tma && !(KMAJ ? make_map(&wmap, a.w, a.K, a.N, pitch, BK, T::BN)
                        : make_map(&wmap, a.w, a.N, a.K, pitch, 64, BK)))
    return (int)cudaErrorInvalidValue;
  auto kern = pmatmul_kernel<P, KMAJ, ACTIVE>;
  constexpr int bytes = T::template smem<P>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a.M + T::ROWS / P - 1) / (T::ROWS / P)),
            (unsigned)((a.N + T::BN - 1) / T::BN));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, T::THREADS, bytes, stream>>>(xmap, wmap, a);
  return (int)cudaGetLastError();
}

template <int P>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           long long swk, long long swn, const unsigned* seeds,
           const float* scales, int any_active, int shared_seed,
           unsigned row_off, unsigned col_off, unsigned ld, int trans,
           int x_tma, int w_tma, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool kmaj = swn != 1;              // W K-contiguous (the tied head)
  if (kmaj && swk != 1) return (int)cudaErrorInvalidValue;
  const long long pitch = kmaj ? swn : swk;
  auto aligned = [](const void* p, long long elems) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (elems * 2) % 16 == 0;
  };
  if ((x_tma && !aligned(x, K)) || (w_tma && !aligned(w, pitch)))
    return (int)cudaErrorInvalidValue;
  Args<P> a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.swk = swk; a.swn = swn; a.M = M; a.N = N; a.K = K;
  for (int p = 0; p < P; ++p) { a.seed[p] = seeds[p]; a.scale[p] = scales[p]; }
  a.shared_seed = shared_seed; a.trans = trans;
  a.x_tma = x_tma; a.w_tma = w_tma;
  a.out_vec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  a.row_off = row_off; a.col_off = col_off; a.ld = ld;
  auto s = (cudaStream_t)stream;
  if (kmaj)
    return any_active ? run<P, true, true>(a, pitch, s)
                      : run<P, true, false>(a, pitch, s);
  return any_active ? run<P, false, true>(a, pitch, s)
                    : run<P, false, false>(a, pitch, s);
}

}  // namespace

// P in {1, 2}; bf16 only.  x_tma / w_tma choose TMA or per-thread loads
// for each operand (TMA needs a 16-byte-aligned base and row pitch).
// Returns the cudaError_t of the launch.
extern "C" int pmatmul_launch(int P, const void* x, const void* w, void* out,
                              int M, int N, int K, long long swk,
                              long long swn, const unsigned* seeds,
                              const float* scales, int any_active,
                              int shared_seed, unsigned row_off,
                              unsigned col_off, unsigned ld, int trans,
                              int x_tma, int w_tma, void* stream) {
  if (P == 1)
    return launch<1>(x, w, out, M, N, K, swk, swn, seeds, scales, any_active,
                     shared_seed, row_off, col_off, ld, trans, x_tma, w_tma,
                     stream);
  if (P == 2)
    return launch<2>(x, w, out, M, N, K, swk, swn, seeds, scales, any_active,
                     shared_seed, row_off, col_off, ld, trans, x_tma, w_tma,
                     stream);
  return (int)cudaErrorInvalidValue;
}
