// Flash attention forward on Hopper (sm_90a): softmax(Q·Kᵀ/√d)·V with an
// online softmax, causal / sliding-window masks and grouped-query heads,
// optionally returning the per-row logsumexp.
//
// Replaces: lua_mapreduce_tpu/ops/attention.py::_flash_kernel_nolse and
// ::_flash_kernel (one kernel here, the lse output a template flag), both
// driven by _flash_pallas.
//
// What bounds it on the H100: at the serving prefill shape (B=4,
// L=3968, H=16, d=64, causal, bf16) the tensor-core rate — about
// 4·B·H·L²·d/2 = 64.5 GFLOP against 4·B·L·H·d·2 = 32.5 MB of q/k/v/out —
// far above the ~295 operations per byte where bf16 products stop being
// limited by the 3.35 TB/s of device memory.
//
// What this simple design does about it:
//  * The TPU grid walks kv blocks as a sequential axis carrying the
//    running (max, denominator, output) in VMEM scratch. GPU blocks run
//    in no order, so each block owns one (batch·head, q-tile) and loops
//    over the kv tiles itself, keeping that state in registers.
//  * bf16 inputs: 4 warps, each owning 16 query rows of a 64-row q tile.
//    Q·Kᵀ and P·V run on the tensor cores as mma.sync m16n8k16 bf16
//    products with f32 accumulators. The score fragment's register
//    layout is the P operand's layout, so P never leaves registers: it
//    is rounded to bf16 there, after its row sums were taken in f32
//    (the TPU kernel's "p in the value dtype, denominator in f32").
//    The running output lives in mma accumulator fragments and is
//    rescaled in place.
//  * f32 inputs: full-precision FP32 FMAs (no TF32), 4 threads per
//    query row, each owning a quarter of the head dim; the dot products
//    are finished by quad shuffles.
//  * q/k/v are read through their (batch, seq, head) strides in the
//    public (B, L, H, D) layout — no transposed (B·H, L, D) copy, no
//    padding. Rows past L are zero-filled in shared memory and masked
//    by the loop bounds and the column test.
//  * Dead kv tiles are never loaded: the loop runs only over the tiles
//    that _tile_live / _kv_clamp call live (above the causal diagonal
//    and behind the window are skipped).
//  * GQA: q head h reads kv head h / (H / H_kv); k/v tiles are re-read
//    per group member (from L2), as the TPU kernel re-fetches them.
//  * A row with no visible key ends with l = max(l, 1e-30) and writes 0.
//  * Left for later work: cp.async / TMA double buffering, wgmma, a
//    larger q tile per block, ldmatrix for the V operand.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };
constexpr float NEG_BIG = -1e30f;   // the finite mask fill of the JAX op

struct Geom {
  int L, H, Hkv;
  long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
  int causal, window, q_offset;
  float scale;
};

// The kv tile range [lo, hi] a q tile starting at (offset) row row0 with
// `rows` rows can see — _tile_live's algebra as loop bounds.
__device__ __forceinline__ void live_range(const Geom& g, int row0, int rows,
                                           int bk, int& lo, int& hi) {
  const int n_kv = (g.L + bk - 1) / bk;
  lo = 0;
  hi = n_kv - 1;
  if (g.causal) {
    const int h2 = (row0 + rows - 1) / bk;
    hi = h2 < hi ? h2 : hi;
  }
  if (g.window) {
    const int first = row0 - g.window + 1;   // lowest visible column
    lo = first > 0 ? first / bk : 0;
  }
}

__device__ __forceinline__ bool visible(const Geom& g, int row, int col) {
  return col < g.L && (!g.causal || row >= col) &&
         (!g.window || row - col < g.window);
}

// ------------------------------------------------------------ bf16 path

namespace bfk {
constexpr int BQ = 64, BK = 64, NW = 4, NT = NW * 32;

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a · b, a 16×16 row-major, b 16×8 column-major, f32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows [r0, r0+64) of a (L, D) slab with row stride sl into S (row
// stride D+8), zero past L; 16-byte vectors when `vec`
template <int D>
__device__ __forceinline__ void load_rows(bf16* S, const bf16* base,
                                          long long sl, int r0, int L,
                                          bool vec) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int VPR = D / 8;
    for (int i = threadIdx.x; i < BK * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < L)
        v = *reinterpret_cast<const uint4*>(base + (r0 + r) * sl + c);
      *reinterpret_cast<uint4*>(S + r * LD + c) = v;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      S[r * LD + c] = (r0 + r < L) ? base[(r0 + r) * sl + c] : zero;
    }
  }
}

template <int D, bool LSE>
__global__ void __launch_bounds__(NT)
flash_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                  const bf16* __restrict__ V, void* __restrict__ O,
                  float* __restrict__ LSEo, Geom g, bool vq, bool vk,
                  bool vv) {
  constexpr int LD = D + 8, KD = D / 16, ND = D / 8, NS = BK / 8;
  __shared__ __align__(16) bf16 sK[BK * LD];
  __shared__ __align__(16) bf16 sV[BK * LD];
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const bf16* qb = Q + b * g.sqb + h * g.sqh;
  const bf16* kb = K + b * g.skb + hk * g.skh;
  const bf16* vb = V + b * g.svb + hk * g.svh;

  // stage the q tile through sK and keep this warp's A fragments
  load_rows<D>(sK, qb, g.sql, q0, g.L, vq);
  __syncthreads();
  uint32_t qa[KD][4];
  {
    const bf16* p0 = sK + (warp * 16 + gi) * LD + 2 * ti;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const bf16* p = p0 + kk * 16;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
    }
  }
  __syncthreads();

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  // offset rows of this thread's two accumulator rows
  const int row_a = q0 + g.q_offset + warp * 16 + gi, row_b = row_a + 8;
  int lo, hi;
  live_range(g, q0 + g.q_offset, BQ, BK, lo, hi);

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    load_rows<D>(sK, kb, g.skl, k0, g.L, vk);
    load_rows<D>(sV, vb, g.svl, k0, g.L, vv);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* p = sK + (j * 8 + gi) * LD + kk * 16 + 2 * ti;
        const uint32_t bb[2] = {*reinterpret_cast<const uint32_t*>(p),
                                *reinterpret_cast<const uint32_t*>(p + 8)};
        mma(s[j], qa[kk], bb);
      }

    // scale, mask (masked = -inf so exp gives exactly 0), row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * ti + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const float val = visible(g, row, col) ? s[j][e] * g.scale : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P·V: two adjacent score fragments form one bf16 A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* pv = sV + (kk * 16 + 2 * ti) * LD + gi;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* p = pv + n * 8;
        const uint32_t bb[2] = {pack(p[0], p[LD]), pack(p[8 * LD], p[9 * LD])};
        mma(o[n], pa, bb);
      }
    }
    __syncthreads();
  }

  const float lf[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + gi + 8 * r;
    if (row >= g.L) continue;
    const long long base = ((long long)(b * g.L + row) * g.H + h) * D;
    const float inv = 1.f / lf[r];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = o[n][2 * r] * inv, x1 = o[n][2 * r + 1] * inv;
      const int d = n * 8 + 2 * ti;
      if (LSE) {
        *reinterpret_cast<float2*>(static_cast<float*>(O) + base + d) =
            make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(O) + base + d) =
            pack(x0, x1);
      }
    }
    if (LSE && ti == 0)
      LSEo[(long long)(b * g.L + row) * g.H + h] = m[r] + logf(lf[r]);
  }
}
}  // namespace bfk

// ------------------------------------------------------------- f32 path

namespace f32k {
constexpr int BQ = 32, BK = 32, NT = BQ * 4;

template <int D>
__device__ __forceinline__ void load_rows(float* S, const float* base,
                                          long long sl, int r0, int L,
                                          bool vec) {
  if (vec) {
    constexpr int VPR = D / 4;
    for (int i = threadIdx.x; i < BK * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < L)
        v = *reinterpret_cast<const float4*>(base + (r0 + r) * sl + c);
      *reinterpret_cast<float4*>(S + r * D + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      S[r * D + c] = (r0 + r < L) ? base[(r0 + r) * sl + c] : 0.f;
    }
  }
}

template <int D, bool LSE>
__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                 const float* __restrict__ V, float* __restrict__ O,
                 float* __restrict__ LSEo, Geom g, bool vk, bool vv) {
  constexpr int DP = D / 4;     // head dims per thread: c, c+4, c+8, …
  __shared__ __align__(16) float sK[BK * D];
  __shared__ __align__(16) float sV[BK * D];
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;
  const int qrow = q0 + r;               // rows past L compute, never store
  const int row = qrow + g.q_offset;
  const float* kb = K + b * g.skb + hk * g.skh;
  const float* vb = V + b * g.svb + hk * g.svh;

  float qv[DP], acc[DP];
  {
    const float* qr = Q + b * g.sqb + h * g.sqh + (long long)qrow * g.sql;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      qv[i] = qrow < g.L ? qr[c + 4 * i] : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = NEG_BIG, l = 0.f;
  int lo, hi;
  live_range(g, q0 + g.q_offset, BQ, BK, lo, hi);

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    load_rows<D>(sK, kb, g.skl, k0, g.L, vk);
    load_rows<D>(sV, vb, g.svl, k0, g.L, vv);
    __syncthreads();
    float s[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part = fmaf(qv[i], sK[j * D + c + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const float val = visible(g, row, k0 + j) ? part * g.scale : -INFINITY;
      s[j] = val;
      mx = fmaxf(mx, val);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - mx);
      rs += p;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(p, sV[j * D + c + 4 * i], acc[i]);
    }
    l = l * alpha + rs;
    __syncthreads();
  }

  if (qrow < g.L) {
    const float lf = fmaxf(l, 1e-30f);
    const long long base = ((long long)(b * g.L + qrow) * g.H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) O[base + c + 4 * i] = acc[i] / lf;
    if (LSE && c == 0) LSEo[(long long)(b * g.L + qrow) * g.H + h] = m + logf(lf);
  }
}
}  // namespace f32k

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int D>
static void launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, const Geom& g, int BH, bool with_lse,
                        cudaStream_t s) {
  auto vec = [](const void* p, long long a, long long b2, long long c) {
    return aligned16(p) && a % 8 == 0 && b2 % 8 == 0 && c % 8 == 0;
  };
  const bool vq = vec(q, g.sqb, g.sql, g.sqh);
  const bool vk = vec(k, g.skb, g.skl, g.skh);
  const bool vv = vec(v, g.svb, g.svl, g.svh);
  dim3 grid((g.L + bfk::BQ - 1) / bfk::BQ, BH);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  if (with_lse)
    bfk::flash_bf16_kernel<D, true><<<grid, bfk::NT, 0, s>>>(Q, K, V, o, lse, g, vq, vk, vv);
  else
    bfk::flash_bf16_kernel<D, false><<<grid, bfk::NT, 0, s>>>(Q, K, V, o, lse, g, vq, vk, vv);
}

template <int D>
static void launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Geom& g, int BH, bool with_lse,
                       cudaStream_t s) {
  auto vec = [](const void* p, long long a, long long b2, long long c) {
    return aligned16(p) && a % 4 == 0 && b2 % 4 == 0 && c % 4 == 0;
  };
  const bool vk = vec(k, g.skb, g.skl, g.skh);
  const bool vv = vec(v, g.svb, g.svl, g.svh);
  dim3 grid((g.L + f32k::BQ - 1) / f32k::BQ, BH);
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  float* O = static_cast<float*>(o);
  if (with_lse)
    f32k::flash_f32_kernel<D, true><<<grid, f32k::NT, 0, s>>>(Q, K, V, O, lse, g, vk, vv);
  else
    f32k::flash_f32_kernel<D, false><<<grid, f32k::NT, 0, s>>>(Q, K, V, O, lse, g, vk, vv);
}

extern "C" {

// q (B, L, H, D), k/v (B, L, Hkv, D): element strides for batch, seq and
// head, head dim contiguous. o: contiguous (B, L, H, D), f32 when
// with_lse else the input dtype; lse: contiguous (B, L, H) f32 or null.
// Returns cudaGetLastError() after the launch (0 = launched).
int lmr_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int L, int H, int Hkv, int D,
                  long long sqb, long long sql, long long sqh, long long skb,
                  long long skl, long long skh, long long svb, long long svl,
                  long long svh, int causal, int window, int q_offset,
                  int dtype, int with_lse, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (long long)B * H > 65535 || (with_lse && lse == nullptr))
    return cudaErrorInvalidValue;
  Geom g{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
         causal, window, q_offset, (float)(1.0 / sqrt((double)D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* LSE = static_cast<float*>(lse);
  const int BH = B * H;
  const bool wl = with_lse != 0;
  if (dtype == DT_BF16) {
    if (D == 64) launch_bf16<64>(q, k, v, o, LSE, g, BH, wl, s);
    else if (D == 128) launch_bf16<128>(q, k, v, o, LSE, g, BH, wl, s);
    else return cudaErrorInvalidValue;
  } else if (dtype == DT_F32) {
    if (D == 64) launch_f32<64>(q, k, v, o, LSE, g, BH, wl, s);
    else if (D == 128) launch_f32<128>(q, k, v, o, LSE, g, BH, wl, s);
    else return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
