// K2: causal flash-attention forward over the model's layout.
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
// (ragged tiles are masked, not asserted away), and key padding.
// Online softmax keeps (m, l, acc) in float32; P is rounded to the input
// type before P.V, as layers.py:125 does.  Fully masked key tiles past
// the block's last query are skipped.
//
// Bound on the H100: at the training shapes (S = 63, dh = 128) each head
// moves 4 x 63 x 128 bf16 values for 2 x 63 x 63 x 128 multiply-adds, a
// few operations per byte, so memory bounds it.  This first version is
// plain FMA from shared memory: a block owns BQ query rows of one head,
// stages each BK-key tile of K and V in shared memory (K rows padded so
// lanes reading different keys hit different banks), lane j scores key j
// and key j + 32, and each lane accumulates dh / 32 output dimensions.
// Tensor cores (wgmma) and TMA are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int BQ = 16;         // query rows per block (4 per warp)
constexpr int BK = 64;         // keys per tile
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int DH>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int KV,
                 int G, int q_offset, int k_offset, int causal, float scale) {
  constexpr int KPAD = DH + 2;           // odd word stride: no bank conflicts
  constexpr int NPER = DH / 32;          // output dims per lane
  __shared__ float Qs[BQ][DH];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][KPAD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK][DH];

  const int head = blockIdx.x;           // b * KV * G + kv * G + g
  const int b = head / (KV * G);
  const int kv = (head / G) % KV;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_row_stride = (long long)KV * G * DH;
  const long long k_row_stride = (long long)KV * DH;
  const __nv_bfloat16* qh = q + ((long long)b * Sq * KV * G + (head % (KV * G))) * DH;
  __nv_bfloat16* oh = out + ((long long)b * Sq * KV * G + (head % (KV * G))) * DH;
  const __nv_bfloat16* kh = k + ((long long)b * Sk * KV + kv) * DH;
  const __nv_bfloat16* vh = v + ((long long)b * Sk * KV + kv) * DH;

  for (int e = tid; e < BQ * DH; e += WARPS * 32) {
    const int r = e / DH, d = e % DH;
    Qs[r][d] = (q0 + r < Sq) ? __bfloat162float(qh[(q0 + r) * q_row_stride + d])
                             : 0.0f;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][NPER];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NPER; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = q_offset + min(q0 + BQ, Sq) - 1;   // last query position
  const int ntiles = (Sk + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * BK;
    if (causal && k_offset + j0 > q_last) break;         // tiles above diagonal
    __syncthreads();
    for (int e = tid; e < BK * DH / 2; e += WARPS * 32) {
      const int j = e / (DH / 2), d = (e % (DH / 2)) * 2;
      __nv_bfloat162 kk = __floats2bfloat162_rn(0.0f, 0.0f), vv = kk;
      if (j0 + j < Sk) {
        kk = *reinterpret_cast<const __nv_bfloat162*>(kh + (j0 + j) * k_row_stride + d);
        vv = *reinterpret_cast<const __nv_bfloat162*>(vh + (j0 + j) * k_row_stride + d);
      }
      *reinterpret_cast<__nv_bfloat162*>(&Ks[j][d]) = kk;
      *reinterpret_cast<__nv_bfloat162*>(&Vs[j][d]) = vv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      if (q0 + r >= Sq) continue;                         // warp-uniform
      const int qpos = q_offset + q0 + r;
      float s[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        float dot = 0.0f;
#pragma unroll 8
        for (int d = 0; d < DH; d += 2) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&Ks[j][d]));
          dot = fmaf(Qs[r][d], kf.x, dot);
          dot = fmaf(Qs[r][d + 1], kf.y, dot);
        }
        const int kidx = j0 + j;
        bool ok = kidx < Sk;
        if (causal) ok = ok && (qpos >= k_offset + kidx);
        s[h] = ok ? __fmul_rn(dot, scale) : NEG_INF;
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(__fadd_rn(s[0], -m_new));
      const float p1 = expf(__fadd_rn(s[1], -m_new));
      const float corr = expf(__fadd_rn(m[i], -m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), warp_sum(__fadd_rn(p0, p1)));
      m[i] = m_new;
      // P is rounded to the input type before P.V (layers.py:125)
      const float pb0 = __bfloat162float(__float2bfloat16_rn(p0));
      const float pb1 = __bfloat162float(__float2bfloat16_rn(p1));
      float pv[NPER];
#pragma unroll
      for (int c = 0; c < NPER; ++c) pv[c] = 0.0f;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(FULL, j < 32 ? pb0 : pb1, j & 31);
#pragma unroll
        for (int c = 0; c < NPER; ++c)
          pv[c] = fmaf(pj, __bfloat162float(Vs[j][lane + 32 * c]), pv[c]);
      }
#pragma unroll
      for (int c = 0; c < NPER; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], corr), pv[c]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NPER; ++c)
      oh[(q0 + r) * q_row_stride + lane + 32 * c] =
          __float2bfloat16_rn(__fdiv_rn(acc[i][c], den));
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int KV, int G, int q_offset, int k_offset,
           int causal, float scale, void* stream) {
  const long long heads = (long long)B * KV * G;
  const int qtiles = (Sq + BQ - 1) / BQ;
  if (heads == 0 || qtiles == 0) return 0;
  if (heads > 0x7fffffffLL || qtiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)heads, (unsigned)qtiles);
  flash_fwd_kernel<DH><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, KV, G, q_offset, k_offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; dh in {32, 64, 128}.  Returns the cudaError_t of the launch.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Sk, int KV,
                                int G, int dh, int q_offset, int k_offset,
                                int causal, float scale, void* stream) {
  switch (dh) {
    case 32:  return launch<32>(q, k, v, out, B, Sq, Sk, KV, G, q_offset, k_offset, causal, scale, stream);
    case 64:  return launch<64>(q, k, v, out, B, Sq, Sk, KV, G, q_offset, k_offset, causal, scale, stream);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, KV, G, q_offset, k_offset, causal, scale, stream);
    default:  return (int)cudaErrorInvalidValue;
  }
}
