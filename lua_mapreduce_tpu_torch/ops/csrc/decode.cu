// Decode attention on Hopper (sm_90a): one query position's G grouped
// query heads against a (B, H_kv, S, D) KV cache, with an online softmax,
// in bf16/f32 or int8 with per-row f32 scales.
//
// Replaces: lua_mapreduce_tpu/ops/decode.py::_decode_kernel, driven by
// _decode_pallas.
//
// What bounds it on the H100: bytes. Each step reads the live part of
// the cache once — at the serving shape (B=4, H_kv=16, t≈4094, d=64,
// bf16) 2·4·16·4095·64·2 = 33.5 MB per layer — for about 4 FLOPs per
// cache element, some 2 operations per byte.
//
// What this simple design does about it:
//  * The TPU grid walks cache chunks as a sequential axis with the
//    softmax state in VMEM scratch, and clamps dead chunks onto the live
//    range so their DMAs are elided. Here one block owns one
//    (batch, kv-head) row and walks positions 0..t itself: positions past
//    the live range are never read (the loop bound is the clamp), and the
//    cache is never padded — the ragged tail is just where the loop ends.
//  * Each warp streams its own share of positions (interleaved, UNROLL
//    rows in flight per warp so enough loads are outstanding), each lane
//    reading D/32 contiguous elements of a row: one coalesced 128-256 B
//    read per cache row. The dot product finishes with warp shuffles and
//    each warp keeps its own online-softmax state (max, denominator,
//    output) per query head in registers; the warps' states merge once at
//    the end through shared memory, in a fixed order.
//  * Rounding points follow _decode_xla / the TPU kernel: bf16 p before
//    the value product for bf16 caches; for int8, q in bf16, k int8 → f32
//    exactly, s × k_scale × 1/√d, p × v_scale rounded to bf16, p·v in f32.
//    The denominator is summed in f32 before any rounding.
//  * Known limit, recorded in PERF.md: one block per (batch, kv-head) row
//    puts B·H_kv = 64 blocks on the 132 SMs at the serving shape. The
//    split-S (flash-decoding) redesign that fills the card is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

// cache kinds: q dtype / cache dtype
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_BF16_INT8 = 2 };
constexpr float NEG_BIG = -1e30f;
constexpr int NW = 16, NT = NW * 32, UNROLL = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// DPL contiguous elements of a row as f32, one vector load
template <int DPL>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if (DPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
}
template <int DPL>
__device__ __forceinline__ void load_row(const bf16* p, float* out) {
  if (DPL == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    out[0] = __bfloat162float(v.x); out[1] = __bfloat162float(v.y);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(e[i]);
  }
}
template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* p, float* out) {
  if (DPL == 2) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    out[0] = (float)v.x; out[1] = (float)v.y;
  } else {
    const char4 v = *reinterpret_cast<const char4*>(p);
    out[0] = (float)v.x; out[1] = (float)v.y; out[2] = (float)v.z;
    out[3] = (float)v.w;
  }
}

template <typename QT, typename KV, int DPL, int G>
__global__ void __launch_bounds__(NT)
decode_kernel(const QT* __restrict__ Q, const KV* __restrict__ K,
              const KV* __restrict__ V, const float* __restrict__ KS,
              const float* __restrict__ VS, float* __restrict__ O, int Hkv,
              int S, int n_live, long long sqb, long long sqh, long long sqg,
              float scale) {
  constexpr int D = DPL * 32;
  constexpr bool Q8 = sizeof(KV) == 1;
  constexpr bool BF = sizeof(KV) == 2;
  __shared__ float sm[NW][G], sl[NW][G];
  __shared__ float sacc[G * D];
  const int row = blockIdx.x, b = row / Hkv, kh = row % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const KV* kr = K + (long long)row * S * D + lane * DPL;
  const KV* vr = V + (long long)row * S * D + lane * DPL;
  const float* ksr = Q8 ? KS + (long long)row * S : nullptr;
  const float* vsr = Q8 ? VS + (long long)row * S : nullptr;

  float qv[G][DPL], acc[G][DPL], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const QT* qp = Q + b * sqb + kh * sqh + gi * sqg + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qv[gi][i] = to_f32(qp[i]);
      acc[gi][i] = 0.f;
    }
    m[gi] = NEG_BIG;
    l[gi] = 0.f;
  }

  for (int j0 = warp * UNROLL; j0 < n_live; j0 += NW * UNROLL) {
    float kf[UNROLL][DPL], vf[UNROLL][DPL], ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      if (j < n_live) {
        load_row<DPL>(kr + (long long)j * D, kf[u]);
        load_row<DPL>(vr + (long long)j * D, vf[u]);
        if (Q8) { ksc[u] = ksr[j]; vsc[u] = vsr[j]; }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j0 + u >= n_live) break;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qv[gi][i], kf[u][i], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const float s = (Q8 ? part * ksc[u] : part) * scale;
        const float mn = fmaxf(m[gi], s);
        const float alpha = expf(m[gi] - mn);
        const float p = expf(s - mn);
        l[gi] = l[gi] * alpha + p;
        m[gi] = mn;
        const float pw = Q8 ? round_bf16(p * vsc[u]) : (BF ? round_bf16(p) : p);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[gi][i] = fmaf(pw, vf[u][i], acc[gi][i] * alpha);
      }
    }
  }

  // merge the warps' states: global max, then outputs summed in warp order
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) { sm[warp][gi] = m[gi]; sl[warp][gi] = l[gi]; }
  }
  __syncthreads();
  float fac[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float M = NEG_BIG;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm[w][gi]);
    fac[gi] = expf(m[gi] - M);
  }
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int idx = gi * D + lane * DPL + i;
          const float x = acc[gi][i] * fac[gi];
          sacc[idx] = w == 0 ? x : sacc[idx] + x;
        }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int gi = idx / D;
    float M = NEG_BIG, Ls = 0.f;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm[w][gi]);
    for (int w = 0; w < NW; ++w) Ls += sl[w][gi] * expf(sm[w][gi] - M);
    O[(long long)row * G * D + idx] = sacc[idx] / fmaxf(Ls, 1e-30f);
  }
}

template <typename QT, typename KV, int DPL>
static int launch_g(int G, const void* q, const void* k, const void* v,
                    const float* ks, const float* vs, float* o, int rows,
                    int Hkv, int S, int n_live, long long sqb, long long sqh,
                    long long sqg, float scale, cudaStream_t s) {
  const QT* Q = static_cast<const QT*>(q);
  const KV* K = static_cast<const KV*>(k);
  const KV* V = static_cast<const KV*>(v);
#define LMR_DECODE_G(GG)                                                    \
  decode_kernel<QT, KV, DPL, GG><<<rows, NT, 0, s>>>(Q, K, V, ks, vs, o,   \
                                                     Hkv, S, n_live, sqb,  \
                                                     sqh, sqg, scale)
  switch (G) {
    case 1: LMR_DECODE_G(1); break;
    case 2: LMR_DECODE_G(2); break;
    case 4: LMR_DECODE_G(4); break;
    case 8: LMR_DECODE_G(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef LMR_DECODE_G
  return cudaSuccess;
}

template <typename QT, typename KV>
static int launch_d(int D, int G, const void* q, const void* k,
                    const void* v, const float* ks, const float* vs, float* o,
                    int rows, int Hkv, int S, int n_live, long long sqb,
                    long long sqh, long long sqg, float scale,
                    cudaStream_t s) {
  if (D == 64)
    return launch_g<QT, KV, 2>(G, q, k, v, ks, vs, o, rows, Hkv, S, n_live,
                               sqb, sqh, sqg, scale, s);
  if (D == 128)
    return launch_g<QT, KV, 4>(G, q, k, v, ks, vs, o, rows, Hkv, S, n_live,
                               sqb, sqh, sqg, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" {

// q: (B, Hkv, G, D) with element strides sqb/sqh/sqg, head dim
// contiguous; k/v: contiguous (B, Hkv, S, D); ks/vs: contiguous
// (B, Hkv, S) f32 (KIND_BF16_INT8 only, else null); o: contiguous
// (B, Hkv, G, D) f32. Positions [0, n_live) are visible. Returns
// cudaGetLastError() after the launch (0 = launched).
int lmr_decode(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, void* o, int B, int Hkv, int G, int D, int S,
               int n_live, long long sqb, long long sqh, long long sqg,
               int kind, void* stream) {
  const long long rows = (long long)B * Hkv;
  if (rows <= 0 || rows > 2147483647LL || S <= 0 || n_live < 0 ||
      n_live > S)
    return cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* KS = static_cast<const float*>(ks);
  const float* VS = static_cast<const float*>(vs);
  float* O = static_cast<float*>(o);
  int rc;
  if (kind == KIND_F32)
    rc = launch_d<float, float>(D, G, q, k, v, nullptr, nullptr, O, rows,
                                Hkv, S, n_live, sqb, sqh, sqg, scale, s);
  else if (kind == KIND_BF16)
    rc = launch_d<bf16, bf16>(D, G, q, k, v, nullptr, nullptr, O, rows, Hkv,
                              S, n_live, sqb, sqh, sqg, scale, s);
  else if (kind == KIND_BF16_INT8) {
    if (KS == nullptr || VS == nullptr) return cudaErrorInvalidValue;
    rc = launch_d<bf16, int8_t>(D, G, q, k, v, KS, VS, O, rows, Hkv, S,
                                n_live, sqb, sqh, sqg, scale, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
