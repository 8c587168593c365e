// FlashAttention-2 backward on Hopper (sm_90a): dq, and dk/dv, of
// softmax(Q·Kᵀ/√d)·V under causal / sliding-window masks (with the
// banded ring's q_offset) and grouped-query heads, re-materializing
// p = exp(s − lse) one tile at a time from the forward's saved lse.
//
// Replaces: lua_mapreduce_tpu/ops/attention.py::_flash_bwd_dq_kernel
// (the dq kernel here) and ::_flash_bwd_dkv_kernel (the dkv kernel),
// both driven by _flash_bwd_pallas, with _bwd_tile's arithmetic in each.
//
// Inputs: q, do (B, L, H, D) and k, v (B, L, Hkv, D) through their
// (batch, seq, head) strides, head dim contiguous; lse and
// Δ = rowsum(do∘o) − g_lse as contiguous (B, L, H) f32 (Δ comes from one
// elementwise pass in torch, as the JAX package leaves it to XLA).
// Outputs: dq contiguous (B, L, H, D), dk and dv contiguous (B, L, Hkv, D),
// in the input dtype.
//
// What bounds them on the H100: at the training shape (B=8, L=2048,
// H=16, d=64, causal, bf16) the tensor-core rate. The dq kernel does
// three L²-sized products (s, dp, dq), the dkv kernel four (s, dp, dv,
// dk): 6 and 8 · B·H·L²·d/2 operations = 103 and 137 GFLOP against
// ~50 MB of operands, far above the ~295 operations per byte where bf16
// products stop being limited by the 3.35 TB/s of device memory.
//
// What this simple design does about it:
//  * The TPU grids walk their innermost axis (kv for dq; the group's
//    (q head × q block) pairs for dk/dv) sequentially, carrying the
//    accumulators in VMEM scratch. GPU blocks run in no order, so each
//    block owns one output tile and loops over its live partner tiles
//    itself, keeping the accumulators in registers. GQA's sum over the
//    group happens in the dkv block's own accumulators: no atomics, and
//    the result is deterministic.
//  * bf16 inputs: 4 warps, mma.sync m16n8k16 with f32 accumulators.
//    dq kernel: a 64-row q tile, each warp owning 16 rows; per 64-key kv
//    tile it forms s = q·kᵀ and dp = do·vᵀ, then p and ds in the
//    accumulator fragments, and ds (rounded to bf16 as the A operand,
//    as the TPU kernel rounds it) times k into dq.
//    dkv kernel: a 64-key kv tile, each warp owning 16 keys; it forms
//    the TRANSPOSED tiles sᵀ = k·qᵀ and dpᵀ = v·doᵀ directly (16 keys ×
//    32 q rows), so pᵀ and dsᵀ land in the accumulator layout that is
//    also the A-operand layout of dv += pᵀ·do and dk += dsᵀ·q: no
//    fragment transposition, no shared-memory round trip.
//    The tiles live in dynamic shared memory (above 48 KB at d = 128).
//  * f32 inputs: full-precision FP32 FMAs (no TF32), 4 threads per row
//    (q row for dq, key row for dkv), each owning a quarter of the head
//    dim; dot products are finished by quad shuffles.
//  * Dead tiles are never visited: the dq loop runs over _kv_clamp's
//    live kv range, the dkv loop over _q_clamp's live q range (causal
//    gives its lower bound, the window its upper bound, which is
//    negative for a kv tile wholly behind the window: no iteration,
//    dk = dv = 0).
//  * p is computed only where the score is visible, so a fully masked
//    row (lse ≈ −1e30) never reaches exp. Rows past L are zero-filled
//    in shared memory, masked, and never written.
//  * Left for later work: cp.async / TMA double buffering, wgmma, a
//    single-kernel FA2 backward with atomics, ldmatrix.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };

struct Geom {
  int L, H, Hkv;
  long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sdb, sdl, sdh;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The kv tile range [lo, hi] a q tile of `rows` rows starting at
// (offset) row row0 can see — _kv_clamp's live range.
__device__ __forceinline__ void kv_range(const Geom& g, int row0, int rows,
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

// The q tile range [lo, hi] (tiles of bq q rows) that can see the kv tile
// of bk keys starting at key k0 — _q_clamp's live range.
__device__ __forceinline__ void q_range(const Geom& g, int k0, int bk,
                                        int bq, int& lo, int& hi) {
  const int n_q = (g.L + bq - 1) / bq;
  lo = 0;
  hi = n_q - 1;
  if (g.causal) {
    const int l2 = floor_div(k0 - g.q_offset, bq);
    lo = l2 > 0 ? l2 : 0;
  }
  if (g.window) {
    const int h2 = floor_div(k0 + bk - 2 + g.window - g.q_offset, bq);
    hi = h2 < hi ? h2 : hi;
  }
}

// q row `qrow` (unshifted index) sees key `col`
__device__ __forceinline__ bool visible(const Geom& g, int qrow, int col) {
  const int row = qrow + g.q_offset;
  return qrow < g.L && col < g.L && (!g.causal || row >= col) &&
         (!g.window || row - col < g.window);
}

// ------------------------------------------------------------ bf16 path

namespace bfk {
constexpr int NW = 4, NT = NW * 32;
constexpr int DQ_BQ = 64, DQ_BK = 64;     // dq kernel: q tile, kv tile
constexpr int KV_BK = 64, KV_BQ = 32;     // dkv kernel: kv tile, q tile

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// rows [r0, r0+ROWS) of an (L, D) slab with row stride sl into S (row
// stride D+8), zero past L; 16-byte vectors when `vec`
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* S, const bf16* base,
                                          long long sl, int r0, int L,
                                          bool vec) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int VPR = D / 8;
    for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < L)
        v = *reinterpret_cast<const uint4*>(base + (r0 + r) * sl + c);
      *reinterpret_cast<uint4*>(S + r * LD + c) = v;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < ROWS * D; i += NT) {
      const int r = i / D, c = i % D;
      S[r * LD + c] = (r0 + r < L) ? base[(r0 + r) * sl + c] : zero;
    }
  }
}

// A fragment (16×16, row-major) of rows [m0, m0+16), cols [kk·16, +16)
// of a shared tile with row stride LD
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* S, int m0,
                                       int kk, int gi, int ti) {
  const bf16* p = S + (m0 + gi) * LD + kk * 16 + 2 * ti;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// C (16 × 8·NS) += A(16 rows of S1 from m0) · B where B[d][n] = S2[n][d]:
// the "rows times rows transposed" product over the head dim
template <int D, int NS>
__device__ __forceinline__ void rows_by_rowsT(float (*c)[4], const bf16* S1,
                                              int m0, const bf16* S2,
                                              int gi, int ti) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a_frag<LD>(a, S1, m0, kk, gi, ti);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const bf16* p = S2 + (j * 8 + gi) * LD + kk * 16 + 2 * ti;
      const uint32_t b[2] = {ld32(p), ld32(p + 8)};
      mma(c[j], a, b);
    }
  }
}

// acc (16 × D) += P · S where P (16 × 16·KS) sits in accumulator fragments
// pf[2·KS][4] (rounded to bf16 here) and S is a (16·KS × D) shared tile
template <int D, int KS>
__device__ __forceinline__ void frag_by_rows(float (*acc)[4],
                                             float (*pf)[4], const bf16* S,
                                             int gi, int ti) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint32_t a[4] = {pack(pf[2 * kk][0], pf[2 * kk][1]),
                           pack(pf[2 * kk][2], pf[2 * kk][3]),
                           pack(pf[2 * kk + 1][0], pf[2 * kk + 1][1]),
                           pack(pf[2 * kk + 1][2], pf[2 * kk + 1][3])};
    const bf16* pb = S + (kk * 16 + 2 * ti) * LD + gi;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* p = pb + n * 8;
      const uint32_t b[2] = {pack(p[0], p[LD]), pack(p[8 * LD], p[9 * LD])};
      mma(acc[n], a, b);
    }
  }
}

template <int D>
constexpr int dq_smem() { return 4 * 64 * (D + 8) * 2; }

template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
          const bf16* __restrict__ V, const bf16* __restrict__ DO,
          const float* __restrict__ LSE, const float* __restrict__ DELTA,
          bf16* __restrict__ DQ, Geom g, bool vq, bool vk, bool vv,
          bool vd) {
  constexpr int LD = D + 8, ND = D / 8, NS = DQ_BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + DQ_BQ * LD;
  bf16* sK = sDO + DQ_BQ * LD;
  bf16* sV = sK + DQ_BK * LD;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const int q0 = blockIdx.x * DQ_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const bf16* kb = K + b * g.skb + hk * g.skh;
  const bf16* vb = V + b * g.svb + hk * g.svh;

  load_rows<D, DQ_BQ>(sQ, Q + b * g.sqb + h * g.sqh, g.sql, q0, g.L, vq);
  load_rows<D, DQ_BQ>(sDO, DO + b * g.sdb + h * g.sdh, g.sdl, q0, g.L, vd);
  // this thread's two accumulator rows (unshifted q indices)
  const int rows[2] = {q0 + warp * 16 + gi, q0 + warp * 16 + gi + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)(b * g.L + rows[r]) * g.H + h;
    lse[r] = rows[r] < g.L ? LSE[i] : 0.f;
    delta[r] = rows[r] < g.L ? DELTA[i] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  int lo, hi;
  kv_range(g, q0 + g.q_offset, DQ_BQ, DQ_BK, lo, hi);

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * DQ_BK;
    __syncthreads();             // the previous tile's readers are done
    load_rows<D, DQ_BK>(sK, kb, g.skl, k0, g.L, vk);
    load_rows<D, DQ_BK>(sV, vb, g.svl, k0, g.L, vv);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_by_rowsT<D, NS>(s, sQ, warp * 16, sK, gi, ti);
    rows_by_rowsT<D, NS>(dp, sDO, warp * 16, sV, gi, ti);
    // ds = p ∘ (dp − Δ) · scale, in place of dp
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * ti + (e & 1);
        const int r = e >> 1;
        const float p = visible(g, rows[r], col)
                            ? expf(s[j][e] * g.scale - lse[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta[r]) * g.scale;
      }
    frag_by_rows<D, DQ_BK / 16>(dq, dp, sK, gi, ti);   // dq += ds · k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= g.L) continue;
    bf16* out = DQ + ((long long)(b * g.L + rows[r]) * g.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * ti) =
          pack(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

template <int D>
constexpr int dkv_smem() {
  return (2 * KV_BK + 2 * KV_BQ) * (D + 8) * 2 + 2 * KV_BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
           const bf16* __restrict__ V, const bf16* __restrict__ DO,
           const float* __restrict__ LSE, const float* __restrict__ DELTA,
           bf16* __restrict__ DK, bf16* __restrict__ DV, Geom g, bool vq,
           bool vk, bool vv, bool vd) {
  constexpr int LD = D + 8, ND = D / 8, NS = KV_BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KV_BK * LD;
  bf16* sQ = sV + KV_BK * LD;
  bf16* sDO = sQ + KV_BQ * LD;
  float* sLSE = reinterpret_cast<float*>(sDO + KV_BQ * LD);
  float* sDELTA = sLSE + KV_BQ;
  const int bhk = blockIdx.y, b = bhk / g.Hkv, hk = bhk % g.Hkv;
  const int group = g.H / g.Hkv;
  const int k0 = blockIdx.x * KV_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;

  load_rows<D, KV_BK>(sK, K + b * g.skb + hk * g.skh, g.skl, k0, g.L, vk);
  load_rows<D, KV_BK>(sV, V + b * g.svb + hk * g.svh, g.svl, k0, g.L, vv);
  // this thread's two accumulator rows: keys
  const int keys[2] = {k0 + warp * 16 + gi, k0 + warp * 16 + gi + 8};
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  int lo, hi;
  q_range(g, k0, KV_BK, KV_BQ, lo, hi);

  for (int gh = 0; gh < group; ++gh) {
    const int h = hk * group + gh;
    const bf16* qb = Q + b * g.sqb + h * g.sqh;
    const bf16* db = DO + b * g.sdb + h * g.sdh;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * KV_BQ;
      __syncthreads();
      load_rows<D, KV_BQ>(sQ, qb, g.sql, q0, g.L, vq);
      load_rows<D, KV_BQ>(sDO, db, g.sdl, q0, g.L, vd);
      if (threadIdx.x < KV_BQ) {
        const int row = q0 + threadIdx.x;
        const long long i = (long long)(b * g.L + row) * g.H + h;
        sLSE[threadIdx.x] = row < g.L ? LSE[i] : 0.f;
        sDELTA[threadIdx.x] = row < g.L ? DELTA[i] : 0.f;
      }
      __syncthreads();

      // sᵀ = k·qᵀ and dpᵀ = v·doᵀ: 16 keys × KV_BQ q rows per warp
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      rows_by_rowsT<D, NS>(st, sK, warp * 16, sQ, gi, ti);
      rows_by_rowsT<D, NS>(dpt, sV, warp * 16, sDO, gi, ti);
      // pᵀ in place of sᵀ, dsᵀ in place of dpᵀ
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * ti + (e & 1);     // q row in the tile
          const float p = visible(g, q0 + c, keys[e >> 1])
                              ? expf(st[j][e] * g.scale - sLSE[c]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - sDELTA[c]) * g.scale;
        }
      frag_by_rows<D, KV_BQ / 16>(dv, st, sDO, gi, ti);   // dv += pᵀ·do
      frag_by_rows<D, KV_BQ / 16>(dk, dpt, sQ, gi, ti);   // dk += dsᵀ·q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= g.L) continue;
    const long long base = ((long long)(b * g.L + keys[r]) * g.Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = n * 8 + 2 * ti;
      *reinterpret_cast<uint32_t*>(DK + base + d) =
          pack(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(DV + base + d) =
          pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}
}  // namespace bfk

// ------------------------------------------------------------- f32 path

namespace f32k {
constexpr int BR = 32, NT = BR * 4;   // rows per tile, 4 threads per row

template <int D>
__device__ __forceinline__ void load_rows(float* S, const float* base,
                                          long long sl, int r0, int L,
                                          bool vec) {
  if (vec) {
    constexpr int VPR = D / 4;
    for (int i = threadIdx.x; i < BR * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < L)
        v = *reinterpret_cast<const float4*>(base + (r0 + r) * sl + c);
      *reinterpret_cast<float4*>(S + r * D + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < BR * D; i += NT) {
      const int r = i / D, c = i % D;
      S[r * D + c] = (r0 + r < L) ? base[(r0 + r) * sl + c] : 0.f;
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ Q, const float* __restrict__ K,
          const float* __restrict__ V, const float* __restrict__ DO,
          const float* __restrict__ LSE, const float* __restrict__ DELTA,
          float* __restrict__ DQ, Geom g, bool vk, bool vv) {
  constexpr int DP = D / 4;     // head dims per thread: c, c+4, c+8, …
  __shared__ __align__(16) float sK[BR * D];
  __shared__ __align__(16) float sV[BR * D];
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  const int q0 = blockIdx.x * BR;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;
  const int qrow = q0 + r;      // rows past L compute, never store
  const float* kb = K + b * g.skb + hk * g.skh;
  const float* vb = V + b * g.svb + hk * g.svh;

  float qv[DP], dov[DP], acc[DP];
  {
    const bool in = qrow < g.L;
    const float* qr = Q + b * g.sqb + h * g.sqh + (long long)qrow * g.sql;
    const float* dr = DO + b * g.sdb + h * g.sdh + (long long)qrow * g.sdl;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      qv[i] = in ? qr[c + 4 * i] : 0.f;
      dov[i] = in ? dr[c + 4 * i] : 0.f;
      acc[i] = 0.f;
    }
  }
  const long long ri = (long long)(b * g.L + qrow) * g.H + h;
  const float lse = qrow < g.L ? LSE[ri] : 0.f;
  const float delta = qrow < g.L ? DELTA[ri] : 0.f;
  int lo, hi;
  kv_range(g, q0 + g.q_offset, BR, BR, lo, hi);

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BR;
    load_rows<D>(sK, kb, g.skl, k0, g.L, vk);
    load_rows<D>(sV, vb, g.svl, k0, g.L, vv);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BR; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) {
        s = fmaf(qv[i], sK[j * D + c + 4 * i], s);
        dp = fmaf(dov[i], sV[j * D + c + 4 * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const float p = visible(g, qrow, k0 + j) ? expf(s * g.scale - lse)
                                               : 0.f;
      const float ds = p * (dp - delta) * g.scale;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        acc[i] = fmaf(ds, sK[j * D + c + 4 * i], acc[i]);
    }
    __syncthreads();
  }

  if (qrow < g.L) {
    float* out = DQ + ((long long)(b * g.L + qrow) * g.H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) out[c + 4 * i] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const float* __restrict__ Q, const float* __restrict__ K,
           const float* __restrict__ V, const float* __restrict__ DO,
           const float* __restrict__ LSE, const float* __restrict__ DELTA,
           float* __restrict__ DK, float* __restrict__ DV, Geom g, bool vq,
           bool vd) {
  constexpr int DP = D / 4;
  __shared__ __align__(16) float sQ[BR * D];
  __shared__ __align__(16) float sDO[BR * D];
  __shared__ float sLSE[BR], sDELTA[BR];
  const int bhk = blockIdx.y, b = bhk / g.Hkv, hk = bhk % g.Hkv;
  const int group = g.H / g.Hkv;
  const int k0 = blockIdx.x * BR;
  const int r = threadIdx.x / 4, c = threadIdx.x % 4;
  const int key = k0 + r;

  float kv[DP], vv[DP], dk[DP], dv[DP];
  {
    const bool in = key < g.L;
    const float* kr = K + b * g.skb + hk * g.skh + (long long)key * g.skl;
    const float* vr = V + b * g.svb + hk * g.svh + (long long)key * g.svl;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      kv[i] = in ? kr[c + 4 * i] : 0.f;
      vv[i] = in ? vr[c + 4 * i] : 0.f;
      dk[i] = dv[i] = 0.f;
    }
  }
  int lo, hi;
  q_range(g, k0, BR, BR, lo, hi);

  for (int gh = 0; gh < group; ++gh) {
    const int h = hk * group + gh;
    const float* qb = Q + b * g.sqb + h * g.sqh;
    const float* db = DO + b * g.sdb + h * g.sdh;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * BR;
      load_rows<D>(sQ, qb, g.sql, q0, g.L, vq);
      load_rows<D>(sDO, db, g.sdl, q0, g.L, vd);
      if (threadIdx.x < BR) {
        const int row = q0 + threadIdx.x;
        const long long i = (long long)(b * g.L + row) * g.H + h;
        sLSE[threadIdx.x] = row < g.L ? LSE[i] : 0.f;
        sDELTA[threadIdx.x] = row < g.L ? DELTA[i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < BR; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          s = fmaf(kv[i], sQ[j * D + c + 4 * i], s);
          dp = fmaf(vv[i], sDO[j * D + c + 4 * i], dp);
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const float p = visible(g, q0 + j, key)
                            ? expf(s * g.scale - sLSE[j]) : 0.f;
        const float ds = p * (dp - sDELTA[j]) * g.scale;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          dv[i] = fmaf(p, sDO[j * D + c + 4 * i], dv[i]);
          dk[i] = fmaf(ds, sQ[j * D + c + 4 * i], dk[i]);
        }
      }
      __syncthreads();
    }
  }

  if (key < g.L) {
    const long long base = ((long long)(b * g.L + key) * g.Hkv + hk) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      DK[base + c + 4 * i] = dk[i];
      DV[base + c + 4 * i] = dv[i];
    }
  }
}
}  // namespace f32k

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

static bool vec_ok(const void* p, long long a, long long b, long long c,
                   int elems) {
  return aligned16(p) && a % elems == 0 && b % elems == 0 && c % elems == 0;
}

// Raise the kernel's dynamic shared-memory limit once (above 48 KB it
// must be asked for); returns the cudaError_t of the attribute call.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <int D>
static cudaError_t launch_bf16(bool dq, const void* q, const void* k,
                               const void* v, const void* d, const float* lse,
                               const float* delta, void* o0, void* o1,
                               const Geom& g, int B, cudaStream_t s) {
  const bool vq = vec_ok(q, g.sqb, g.sql, g.sqh, 8);
  const bool vk = vec_ok(k, g.skb, g.skl, g.skh, 8);
  const bool vv = vec_ok(v, g.svb, g.svl, g.svh, 8);
  const bool vd = vec_ok(d, g.sdb, g.sdl, g.sdh, 8);
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* DO = static_cast<const bf16*>(d);
  if (dq) {
    static bool done = false;
    constexpr int smem = bfk::dq_smem<D>();
    cudaError_t e = allow_smem(bfk::dq_kernel<D>, smem, done);
    if (e != cudaSuccess) return e;
    dim3 grid((g.L + bfk::DQ_BQ - 1) / bfk::DQ_BQ, B * g.H);
    bfk::dq_kernel<D><<<grid, bfk::NT, smem, s>>>(
        Q, K, V, DO, lse, delta, static_cast<bf16*>(o0), g, vq, vk, vv, vd);
  } else {
    static bool done = false;
    constexpr int smem = bfk::dkv_smem<D>();
    cudaError_t e = allow_smem(bfk::dkv_kernel<D>, smem, done);
    if (e != cudaSuccess) return e;
    dim3 grid((g.L + bfk::KV_BK - 1) / bfk::KV_BK, B * g.Hkv);
    bfk::dkv_kernel<D><<<grid, bfk::NT, smem, s>>>(
        Q, K, V, DO, lse, delta, static_cast<bf16*>(o0),
        static_cast<bf16*>(o1), g, vq, vk, vv, vd);
  }
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_f32(bool dq, const void* q, const void* k,
                              const void* v, const void* d, const float* lse,
                              const float* delta, void* o0, void* o1,
                              const Geom& g, int B, cudaStream_t s) {
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const float* DO = static_cast<const float*>(d);
  if (dq) {
    dim3 grid((g.L + f32k::BR - 1) / f32k::BR, B * g.H);
    f32k::dq_kernel<D><<<grid, f32k::NT, 0, s>>>(
        Q, K, V, DO, lse, delta, static_cast<float*>(o0), g,
        vec_ok(k, g.skb, g.skl, g.skh, 4), vec_ok(v, g.svb, g.svl, g.svh, 4));
  } else {
    dim3 grid((g.L + f32k::BR - 1) / f32k::BR, B * g.Hkv);
    f32k::dkv_kernel<D><<<grid, f32k::NT, 0, s>>>(
        Q, K, V, DO, lse, delta, static_cast<float*>(o0),
        static_cast<float*>(o1), g, vec_ok(q, g.sqb, g.sql, g.sqh, 4),
        vec_ok(d, g.sdb, g.sdl, g.sdh, 4));
  }
  return cudaGetLastError();
}

static int launch(bool dq, const void* q, const void* k, const void* v,
                  const void* d, const void* lse, const void* delta,
                  void* o0, void* o1, int B, int L, int H, int Hkv, int D,
                  long long sqb, long long sql, long long sqh, long long skb,
                  long long skl, long long skh, long long svb, long long svl,
                  long long svh, long long sdb, long long sdl, long long sdh,
                  int causal, int window, int q_offset, int dtype,
                  void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (long long)B * H > 65535 || o0 == nullptr || (!dq && o1 == nullptr))
    return cudaErrorInvalidValue;
  Geom g{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
         sdb, sdl, sdh, causal, window, q_offset,
         (float)(1.0 / sqrt((double)D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* LSE = static_cast<const float*>(lse);
  const float* DELTA = static_cast<const float*>(delta);
  cudaError_t e;
  if (dtype == DT_BF16) {
    if (D == 64) e = launch_bf16<64>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s);
    else if (D == 128) e = launch_bf16<128>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s);
    else return cudaErrorInvalidValue;
  } else if (dtype == DT_F32) {
    if (D == 64) e = launch_f32<64>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s);
    else if (D == 128) e = launch_f32<128>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s);
    else return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" {

// Both entry points: q, k, v, do, lse, delta, the outputs (dq and an
// unused null for the dq kernel; dk, dv for the dkv kernel), the sizes,
// element strides for batch, seq and head of q, k, v and do, the mask,
// the dtype code and the stream. Returns cudaGetLastError() after the
// launch (0 = launched).
int lmr_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* d, const void* lse, const void* delta,
                     void* dq, void* unused, int B, int L, int H, int Hkv,
                     int D, long long sqb, long long sql, long long sqh,
                     long long skb, long long skl, long long skh,
                     long long svb, long long svl, long long svh,
                     long long sdb, long long sdl, long long sdh, int causal,
                     int window, int q_offset, int dtype, void* stream) {
  return launch(true, q, k, v, d, lse, delta, dq, unused, B, L, H, Hkv, D,
                sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sdb, sdl, sdh,
                causal, window, q_offset, dtype, stream);
}

int lmr_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* d, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int L, int H, int Hkv,
                      int D, long long sqb, long long sql, long long sqh,
                      long long skb, long long skl, long long skh,
                      long long svb, long long svl, long long svh,
                      long long sdb, long long sdl, long long sdh, int causal,
                      int window, int q_offset, int dtype, void* stream) {
  return launch(false, q, k, v, d, lse, delta, dk, dv, B, L, H, Hkv, D,
                sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sdb, sdl, sdh,
                causal, window, q_offset, dtype, stream);
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
