// K2: causal flash-attention forward over the model's layout, on tensor
// cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn.py::
// flash_attention_pallas (pallas_call at :87), and covers what the model
// calls, repro/models/layers.py::flash_attention:
//
//   q (B, Sq, KV, G, dh), k/v (B, Sk, KV, dh) -> out (B, Sq, KV, G, dh)
//
// with GQA as an index map (query head (kv, g) reads k/v head kv, no
// repeated K/V), an absolute query offset q_offset, a key offset
// k_offset (negative marks leading always-visible keys), any Sq and Sk
// (ragged tiles are zero-filled and masked), and key padding.  Online
// softmax keeps (m, l, acc) in float32 with the plain version's
// arithmetic: masked scores are -1e30, l is summed from the float32 p,
// and P is rounded to bf16 before P.V, as layers.py:125 does.  Key
// tiles past the block's last query are skipped; a row that sees no key
// at all leaves 0 through the 1e-30 clamp of l.
//
// Bound on the H100: at the training shapes (S = 63, dh = 128) a head
// moves 4 x 63 x 128 bf16 values for 2 x 64 x 64 x 128 multiply-adds, a
// few operations per byte, so bytes and latency bound it, not the
// tensor-core rate.  The design, FlashAttention-2 style:
//
// - One block of 4 warps per (b, kv, g) head and 64-row query tile; a
//   warp owns 16 query rows.  At S = 63 that is one tile, so the head's
//   K and V are read once.
// - Both products on tensor cores: mma.sync m16n8k16 bf16 -> f32, with
//   operands from shared memory by ldmatrix (V by ldmatrix.trans from
//   its row-major tile).  Shared-memory rows are XOR-swizzled in 16-byte
//   chunks, so the 8 rows of one ldmatrix phase hit 8 different banks
//   and Q, K and V fit in 48 KB without padding.
// - Softmax in the accumulator's fragment layout: a row lies on a quad
//   of 4 lanes, so its max and sum take two __shfl_xor_sync.  P stays in
//   registers and is the A fragment of P.V.
// - K/V tiles of 64 keys arrive by cp.async in 16-byte chunks; V lands
//   while Q.K^T and the softmax run, and for Sk > 64 the next tile's K
//   and V load while the current one is used (two stages).
// - The output goes out through the warp's own rows of the Q tile in
//   shared memory, as 16-byte stores.
// - Optionally (stats != nullptr, a forward whose gradient is wanted)
//   each row's final running max m and sum l go out as float32, so the
//   backward (kernels/flash_attn.py, tensor ops) recomputes P from q, k
//   and them: stats[head * Sq + row] = m, stats[(heads + head) * Sq +
//   row] = l.
//
// Why mma.sync and not wgmma/TMA: a head at S = 63 is 64x64x128 +
// 64x128x64 multiply-adds, too little to keep a warpgroup's
// asynchronous pipeline busy; what counts is the bytes and the latency
// of one small tile.  wgmma and TMA pay off at long sequences, which
// come with serving.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BQ = 64;         // query rows per block (16 per warp)
constexpr int BK = 64;         // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Element offset of 16-byte chunk c of row r in a swizzled 64-row tile.
// dh >= 64: the chunk index is XORed with r % 8.  dh = 32 (4 chunks, 64 B
// a row): with (r / 2) % 4, since rows r and r + 1 already lie in the two
// halves of one 128-byte bank line.
template <int DH>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = DH / 8;
  constexpr int X = CPR >= 8 ? 7 : CPR - 1;
  constexpr int SH = CPR >= 8 ? 0 : 1;
  return r * DH + ((c ^ ((r >> SH) & X)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid (src not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows row0 .. row0 + 63 of a (rows, stride) bf16 matrix into a swizzled
// tile; rows >= nrows are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* g,
                                          long long stride, int row0,
                                          int nrows, int tid) {
  constexpr int CPR = DH / 8;
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int i = 0; i < 64 * CPR / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / CPR, c = e % CPR;
    const bool ok = row0 + r < nrows;
    const __nv_bfloat16* src = ok ? g + (long long)(row0 + r) * stride + c * 8 : g;
    cp_async16(base + swz<DH>(r, c) * 2, src, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ stats, int Sq, int Sk, int KV,
                 int G, int q_offset, int k_offset, int causal, float scale) {
  constexpr int TILE = 64 * DH;          // elements of one 64-row tile
  constexpr int KSTEPS = DH / 16;        // k16 steps of Q.K^T
  constexpr int NT = DH / 8;             // 8-column tiles of the output
  constexpr int CPR = DH / 8;            // 16-byte chunks per row
  extern __shared__ __align__(128) __nv_bfloat16 smem[];
  __nv_bfloat16* Qs = smem;              // then K[0], V[0], K[1], V[1]

  const int head = blockIdx.x;           // b * KV * G + kv * G + g
  const int b = head / (KV * G);
  const int kv = (head / G) % KV;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t4 = lane & 3;   // fragment row / column pair
  const long long q_row_stride = (long long)KV * G * DH;
  const long long k_row_stride = (long long)KV * DH;
  const __nv_bfloat16* qh = q + ((long long)b * Sq * KV * G + (head % (KV * G))) * DH;
  __nv_bfloat16* oh = out + ((long long)b * Sq * KV * G + (head % (KV * G))) * DH;
  const __nv_bfloat16* kh = k + ((long long)b * Sk * KV + kv) * DH;
  const __nv_bfloat16* vh = v + ((long long)b * Sk * KV + kv) * DH;

  // Key tiles this block reads: all, or (causal) up to its last query.
  int nt = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = q_offset + min(q0 + BQ, Sq) - 1 - k_offset;
    nt = last < 0 ? 0 : min(nt, last / BK + 1);
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  if (nt > 0) {
    load_tile<DH>(Qs, qh, q_row_stride, q0, Sq, tid);
    load_tile<DH>(smem + TILE, kh, k_row_stride, 0, Sk, tid);
    cp_commit();
    load_tile<DH>(smem + 2 * TILE, vh, k_row_stride, 0, Sk, tid);
    cp_commit();
  }

  const int qpos0 = q_offset + q0 + warp * 16 + gr;   // rows gr and gr + 8
  const uint32_t q_base = smem_u32(Qs);
  for (int t = 0; t < nt; ++t) {
    __nv_bfloat16* Ks = smem + (1 + 2 * (t & 1)) * TILE;
    __nv_bfloat16* Vs = Ks + TILE;
    if (t + 1 < nt) {                    // two stages: prefetch tile t + 1
      __nv_bfloat16* Kn = smem + (1 + 2 * ((t + 1) & 1)) * TILE;
      load_tile<DH>(Kn, kh, k_row_stride, (t + 1) * BK, Sk, tid);
      cp_commit();
      load_tile<DH>(Kn + TILE, vh, k_row_stride, (t + 1) * BK, Sk, tid);
      cp_commit();
      cp_wait<3>();                      // K[t] (and Q) landed
    } else {
      cp_wait<1>();
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const uint32_t k_base = smem_u32(Ks);
    // Not unrolled: unrolled, the k-steps' fragments are all loaded ahead
    // and hold 235 registers a thread at dh = 128 (2 blocks an SM);
    // rolled, 168 (3 blocks), the faster of the two at S = 63.
#pragma unroll 1
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      ldsm_x4(q_base + swz<DH>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)) * 2, a);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(k_base + swz<DH>(np * 16 + (lane >> 4) * 8 + (lane & 7),
                                 kk * 2 + ((lane >> 3) & 1)) * 2, bk);
        mma16816(s[2 * np], a, bk[0], bk[1]);
        mma16816(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Scale and mask; element e of tile n is row gr + 8 * (e >> 1), key
    // t * BK + 8n + 2 t4 + (e & 1).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kidx = t * BK + n * 8 + t4 * 2 + (e & 1);
        bool ok = kidx < Sk;
        if (causal) ok = ok && (qpos0 + 8 * (e >> 1) >= k_offset + kidx);
        s[n][e] = ok ? __fmul_rn(s[n][e], scale) : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      corr[h] = expf(__fadd_rn(m[h], -mx[h]));
      m[h] = mx[h];
    }
    // P in float32 for l, rounded to bf16 as the A fragments of P.V:
    // k-step j covers key tiles 2j (a0, a1) and 2j + 1 (a2, a3).
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(__fadd_rn(s[n][e], -mx[e >> 1]));
        ls[e >> 1] = __fadd_rn(ls[e >> 1], p[e]);
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ls[h] = __fadd_rn(ls[h], __shfl_xor_sync(FULL, ls[h], 1));
      ls[h] = __fadd_rn(ls[h], __shfl_xor_sync(FULL, ls[h], 2));
      l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), ls[h]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = __fmul_rn(o[j][e], corr[e >> 1]);

    if (t + 1 < nt) cp_wait<2>(); else cp_wait<0>();   // V[t] landed
    __syncthreads();

    // O += P V: keys are the k dimension, V read transposed by ldmatrix.
    const uint32_t v_base = smem_u32(Vs);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(v_base + swz<DH>(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                   dp * 2 + (lane >> 4)) * 2, bv);
        mma16816(o[2 * dp], pa[kk], bv[0], bv[1]);
        mma16816(o[2 * dp + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();                     // before tile t + 2 reuses the slot
  }

  // Epilogue: normalise, stage the warp's 16 rows in its own rows of the
  // Q tile (no other warp reads them), store 16-byte chunks.
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gr + 8 * h;
      *reinterpret_cast<uint32_t*>(Qs + swz<DH>(r, j) + t4 * 2) =
          pack_bf16(__fdiv_rn(o[j][2 * h], den[h]),
                    __fdiv_rn(o[j][2 * h + 1], den[h]));
    }
  if (stats != nullptr && t4 == 0) {      // a quad's lanes hold equal m, l
    const long long heads = gridDim.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + gr + 8 * h;
      if (row < Sq) {
        stats[(long long)head * Sq + row] = m[h];
        stats[(heads + head) * Sq + row] = l[h];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < CPR / 2; ++i) {    // 16 rows x CPR chunks, 32 lanes
    const int e = lane + 32 * i, r = warp * 16 + e / CPR, c = e % CPR;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(oh + (q0 + r) * q_row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<DH>(r, c));
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           float* stats, int B, int Sq, int Sk, int KV, int G, int q_offset,
           int k_offset, int causal, float scale, void* stream) {
  const long long heads = (long long)B * KV * G;
  const int qtiles = (Sq + BQ - 1) / BQ;
  if (heads == 0 || qtiles == 0) return 0;
  if (heads > 0x7fffffffLL || qtiles > 65535) return (int)cudaErrorInvalidValue;
  // Q and one K/V stage; a second stage only when there is a second tile.
  const int stages = Sk > BK ? 2 : 1;
  const int smem = (1 + 2 * stages) * 64 * DH * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)heads, (unsigned)qtiles);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      stats, Sq, Sk, KV, G, q_offset, k_offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; dh in {32, 64, 128}; every row of q/k/v/out 16-byte aligned.
// stats: nullptr, or float32 (2, B, KV, G, Sq) for each row's m and l.
// Returns the cudaError_t of the launch.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, float* stats, int B, int Sq,
                                int Sk, int KV, int G, int dh, int q_offset,
                                int k_offset, int causal, float scale,
                                void* stream) {
  switch (dh) {
    case 32:  return launch<32>(q, k, v, out, stats, B, Sq, Sk, KV, G, q_offset, k_offset, causal, scale, stream);
    case 64:  return launch<64>(q, k, v, out, stats, B, Sq, Sk, KV, G, q_offset, k_offset, causal, scale, stream);
    case 128: return launch<128>(q, k, v, out, stats, B, Sq, Sk, KV, G, q_offset, k_offset, causal, scale, stream);
    default:  return (int)cudaErrorInvalidValue;
  }
}
