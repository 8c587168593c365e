// FlashAttention-2 backward on Hopper (sm_90a): dq, and dk/dv, of
// softmax(Q·Kᵀ/√d)·V under causal / sliding-window masks (with the
// banded ring's q_offset) and grouped-query heads, re-materializing
// p = exp(s − lse) one tile at a time from the forward's saved lse.
//
// Replaces: lua_mapreduce_tpu/ops/attention.py::_flash_bwd_dq_kernel
// (the dq kernels here) and ::_flash_bwd_dkv_kernel (the dkv kernels),
// both driven by _flash_bwd_pallas, with _bwd_tile's arithmetic in each.
// Two kernels, one launch each per backward, as the TPU splits them; no
// atomics: GQA's sum over a kv head's group stays in the dkv block's own
// accumulators, and two calls give the same bits.
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
// Three kernel families; which one runs is a predicate on the operands'
// layout alone (lmr_flash_bwd_path, the forward's lmr_flash_path with do
// added):
//  * bf16 q/k/v/do that TMA can describe (head dim 64 or 128, 16-byte
//    aligned bases, every stride of a dimension longer than one a
//    multiple of 8 elements: contiguous tensors, the model's fused-qkv
//    views, do[:, :, ::2]) take the warp-specialised kernels (wsk): 384
//    threads, one producer thread issuing TMA through a 4-stage
//    full/empty mbarrier ring and two consumer warpgroups running wgmma,
//    the tensor maps the forward's ({D, H, L, B}, 64-d boxes with the
//    128-byte swizzle, the head a coordinate, rows past L zero-filled:
//    sm90_common.cuh's make_map4). A map that fails to encode is a launch
//    error, never a switch to the general kernels.
//    dq: a block per (batch·head, 128-row q tile), heaviest causal tiles
//    first with batch·head the fast grid axis; q and do land once; 64-key
//    K/V tiles stream through the ring (kv head hk = h / group). Each
//    consumer owns 64 q rows: S = Q·Kᵀ and dP = dO·Vᵀ are SS wgmma chains
//    (m64n64k16, K-major), p = exp2(s·scale·log2e − lse·log2e) and
//    ds = p∘(dp − Δ)·scale stay in f32 registers, ds is rounded to bf16
//    (the TPU kernel's rounding point) in the accumulator layout, which
//    is wgmma's register A layout, and dQ += dS·K reads the same K stage
//    N-major (the forward's P·V with K in V's place).
//    dkv: a block per (batch·kv head, 128-key tile), key tile 0 (under
//    causal masking the heaviest: it sees every q row) first; K and V
//    land once; 64-row q/do tiles of the group's q heads (h = hk·group +
//    g) × _q_clamp's live q tiles stream through the ring. lse and Δ are
//    strided by H and a 1-float TMA box is not allowed, so the producer
//    warp's 32 lanes read the tile's rows with ordinary loads (issued
//    before the wait for a free stage), store lse·log2e and Δ beside the
//    stage and each arrive on its full barrier (33 arrivals: TMA's and
//    theirs). Each consumer owns 64 keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are
//    SS chains, Pᵀ and dSᵀ land in the accumulator layout, the A operand
//    of dV += Pᵀ·dO and dK += dSᵀ·Q (dO and Q read N-major), and dk, dv
//    stay in registers across the whole group.
//    The column test runs only on tiles that cross L, the causal
//    diagonal or the window's edge; q rows past L (lse 0 after TMA's
//    zero rows) and fully masked rows (lse ≈ −1e30) are masked by it,
//    never through exp. The loops run over _kv_clamp's / _q_clamp's live
//    tiles only.
//    Measured on the H100 (PERF.md §6): ptxas gives the 384
//    threads 168 registers each whatever setmaxnreg hands the consumers
//    at run time, so the partner tiles are 64 wide (128-key dq tiles
//    spilled and ran slower); the register operands are fenced around
//    wgmma's fence, commit and wait (CUTLASS's operand fences), without
//    which ptxas injected its own arrives and serialised the products;
//    the forward's turn-taking between the warpgroups, and splitting a
//    tile's waits so that exp overlaps dP, both came out slower.
//  * Other bf16 layouts take the general kernels (bfk), the first design:
//    4 warps, mma.sync m16n8k16 from padded shared memory; the dq kernel
//    a 64-row q tile over 64-key kv tiles, the dkv kernel a 64-key tile
//    forming sᵀ = k·qᵀ and dpᵀ = v·doᵀ directly (16 keys × 32 q rows a
//    warp) so that pᵀ and dsᵀ are the A fragments of the next products.
//  * f32 inputs: full-precision FP32 FMAs (f32k; no TF32), 4 threads per
//    row (q row for dq, key row for dkv), each owning a quarter of the
//    head dim; dot products are finished by quad shuffles.
// In all three, dead tiles are never visited (the dkv loop's window
// bound is negative for a kv tile wholly behind the window: no
// iteration, dk = dv = 0), and rows past L are never written.
// Left for later work: a single-kernel backward with dq accumulated by
// atomics (FA3's form; calls would no longer be bit-equal), more than
// 168 registers for the D = 128 dkv consumers (dk and dv alone hold 128
// a thread; it spills), ldmatrix in the general kernels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { PATH_GENERAL = 0, PATH_TMA = 1, PATH_F32 = 2 };

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

// ------------------------------------------- bf16, TMA + wgmma (Hopper)

namespace wsk {
constexpr int NT = 384;      // two consumer warpgroups and the producer's
constexpr int ROWS = 128;    // a dq block's q rows, a dkv block's keys
constexpr float LOG2E = 1.4426950408889634f;

// The partner tiles each block streams: kv tiles of 64 keys for dq, q
// tiles of 64 rows for dkv. ptxas allocates 168 registers to each of the
// 384 threads, whatever setmaxnreg hands the consumers at run time:
// 64-wide tiles keep dq's live registers (its accumulator, S, dP) within
// them; 128-key tiles spilled at D = 64 and ran slower.
constexpr int TILE = 64;

// Over the q rows [q_lo, q_hi] (unshifted) × keys [k_lo, k_hi]: is every
// pair visible (no column test needed), or none (no work at all)?
__device__ __forceinline__ bool all_visible(const Geom& g, int q_lo, int q_hi,
                                            int k_lo, int k_hi) {
  return q_hi < g.L && k_hi < g.L &&
         (!g.causal || q_lo + g.q_offset >= k_hi) &&
         (!g.window || q_hi + g.q_offset - k_lo < g.window);
}
__device__ __forceinline__ bool none_visible(const Geom& g, int q_lo, int q_hi,
                                             int k_lo, int k_hi) {
  return q_lo >= g.L || k_lo >= g.L ||
         (g.causal && q_hi + g.q_offset < k_lo) ||
         (g.window && q_lo + g.q_offset - k_hi >= g.window);
}

// A K-major operand (rows × D, in boxes of 64 d of `box` bytes): rows
// from r0, the 16-wide slice kk of the head dim; SBO the next 8 rows.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int box, int r0,
                                           int kk) {
  return sm90::desc_sw128(tile + (kk / 4) * box + (kk % 4) * 32 + r0 * 128,
                          16, 1024);
}
// The same tile read N-major (its rows the product's depth, D its width):
// rows 16·kk .. 16·kk + 15 are two swizzle atoms (2 KB); LBO the next 64 d.
__device__ __forceinline__ uint64_t nmajor(uint32_t tile, int box, int kk) {
  return sm90::desc_sw128(tile + kk * 2048, box, 1024);
}

// acc (64 × D) += A (64 × 16, bf16 registers) · B (N-major)
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) sm90::wgmma_rs_64(d, a, db);
  else sm90::wgmma_rs_128(d, a, db);
}

// a 64 × N f32 accumulator rounded to bf16 A fragments: the fragment of
// its columns 16·kk .. 16·kk + 15 is registers 8kk .. 8kk + 7
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[kk][q] = sm90::pack_bf16(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Accumulator fragment of m64nN: register j of warp w4 (of the
// warpgroup), lane l holds row 16·w4 + l/4 + 8·((j >> 1) & 1), column
// 8·(j >> 2) + 2·(l % 4) + (j & 1).
__device__ __forceinline__ int frag_col(int j, int lane) {
  return 8 * (j >> 2) + 2 * (lane % 4) + (j & 1);
}

// Shared memory of the dq kernel: the q and do tiles (128 rows), then
// STAGES stages of {K tile, V tile}; each tile D / 64 boxes of 64 d; 1 KB
// of slack to align the swizzle atoms.
template <int D>
struct DqLayout {
  static constexpr int BK = TILE;
  static constexpr int QBOX = ROWS * 128, KBOX = BK * 128;
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int FIT = (232448 - 1024 - 256 - 2 * Q_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int DYN = 2 * Q_BYTES + STAGES * STAGE + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ LSE, const float* __restrict__ DELTA,
                bf16* __restrict__ DQ, Geom g) {
  using Lay = DqLayout<D>;
  constexpr int S = Lay::STAGES, DC = D / 64, BK = Lay::BK;
  extern __shared__ uint8_t smem_raw[];
  // qbar: q and do have landed; full: a stage's K and V have landed;
  // empty: both consumers are done with a stage
  __shared__ __align__(8) uint64_t qbar, full[S], empty[S];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdo = base + Lay::Q_BYTES;
  const uint32_t skv = base + 2 * Lay::Q_BYTES;
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  // causal: the heaviest q tiles (largest index) start first
  const int q0 = (g.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * ROWS;
  int lo, hi;
  kv_range(g, q0 + g.q_offset, ROWS, BK, lo, hi);
  const int n = hi >= lo ? hi - lo + 1 : 0;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(sm90::smem_u32(&qbar), 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (t == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tk)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tv)) : "memory");
      const uint32_t qb = sm90::smem_u32(&qbar);
      sm90::mbar_expect_tx(qb, 2 * Lay::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        sm90::tma_load_4d(sq + c * Lay::QBOX, &tq, qb, 64 * c, h, q0, b);
        sm90::tma_load_4d(sdo + c * Lay::QBOX, &tdo, qb, 64 * c, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % S, k0 = (lo + i) * BK;
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
        const uint32_t fb = sm90::smem_u32(&full[s]);
        sm90::mbar_expect_tx(fb, Lay::STAGE);
        const uint32_t sk = skv + s * Lay::STAGE, sv = sk + Lay::KV_BYTES;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          sm90::tma_load_4d(sk + c * Lay::KBOX, &tk, fb, 64 * c, hk, k0, b);
          sm90::tma_load_4d(sv + c * Lay::KBOX, &tv, fb, 64 * c, hk, k0, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w4 = t / 32, lane = t % 32;
  const float c = g.scale * LOG2E;          // scores to the log2 domain
  const int qs = q0 + wg * 64;              // this warpgroup's first q row
  const int row_a = qs + w4 * 16 + lane / 4;   // its rows: row_a, row_a + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const long long i = (long long)(b * g.L + row) * g.H + h;
    lse2[r] = row < g.L ? LSE[i] * LOG2E : 0.f;
    dlt[r] = row < g.L ? DELTA[i] : 0.f;
  }
  float dq[D / 2], sc[BK / 2], dp[BK / 2];
  uint32_t da[BK / 16][4];
  zero(dq);
  sm90::mbar_wait(sm90::smem_u32(&qbar), 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % S, k0 = (lo + i) * BK;
    sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / S) & 1);
    const uint32_t sk = skv + s * Lay::STAGE, sv = sk + Lay::KV_BYTES;
    // a warpgroup whose 64 rows see none of the tile skips it (though
    // that saves one tile in ~17 under causal masking, the kernel came
    // out faster with the skip on the H100; dkv's came out slower)
    if (!none_visible(g, qs, qs + 63, k0, k0 + BK - 1)) {
      // S = Q·Kᵀ and dP = dO·Vᵀ
      zero(sc);
      zero(dp);
      sm90::fence_acc(sc);
      sm90::fence_acc(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_64<0, 0>(sc, kmajor(sq, Lay::QBOX, wg * 64, kk),
                             kmajor(sk, Lay::KBOX, 0, kk));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_64<0, 0>(dp, kmajor(sdo, Lay::QBOX, wg * 64, kk),
                             kmajor(sv, Lay::KBOX, 0, kk));
      sm90::wgmma_commit();
      sm90::fence_acc(sc);
      sm90::fence_acc(dp);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sc);
      sm90::fence_acc(dp);
      // ds = p∘(dp − Δ)·scale with p = exp(s·scale − lse), rounded to
      // bf16 into da; the column test only where the tile crosses L, the
      // diagonal or the window's edge
      const bool all = all_visible(g, qs, qs + 63, k0, k0 + BK - 1);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        float p = exp2f(fmaf(sc[j], c, -lse2[r]));
        if (!all && !visible(g, row_a + 8 * r, k0 + frag_col(j, lane)))
          p = 0.f;
        sc[j] = p * (dp[j] - dlt[r]) * g.scale;
      }
      pack_a<BK>(da, sc);
      // dQ += dS·K, K read N-major from the same stage
      sm90::fence_frag(da);
      sm90::fence_acc(dq);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<D>(dq, da[kk], nmajor(sk, Lay::KBOX, kk));
      sm90::wgmma_commit();
      sm90::fence_acc(dq);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dq);
    }
    if (t == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= g.L) continue;
    bf16* out = DQ + ((long long)(b * g.L + row) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * (lane % 4)) =
          sm90::pack_bf16(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// Shared memory of the dkv kernel: the K and V tiles (128 keys), then
// STAGES stages of {q tile, do tile}; their lse and Δ rows in static
// shared memory beside.
template <int D>
struct DkvLayout {
  static constexpr int BQ = TILE;
  static constexpr int KBOX = ROWS * 128, QBOX = BQ * 128;
  static constexpr int K_BYTES = ROWS * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int FIT =
      (232448 - 1024 - 256 - 2 * K_BYTES) / (STAGE + 2 * BQ * 4);
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int DYN = 2 * K_BYTES + STAGES * STAGE + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ LSE,
                 const float* __restrict__ DELTA, bf16* __restrict__ DK,
                 bf16* __restrict__ DV, Geom g) {
  using Lay = DkvLayout<D>;
  constexpr int S = Lay::STAGES, DC = D / 64, BQ = Lay::BQ;
  extern __shared__ uint8_t smem_raw[];
  // kbar: K and V have landed; full: a stage's q and do (TMA) and its
  // lse and Δ rows (the producer warp's 32 lanes, each arriving after
  // its stores) have landed; empty: both consumers are done with it
  __shared__ __align__(8) uint64_t kbar, full[S], empty[S];
  __shared__ float s_lse[S][BQ], s_dlt[S][BQ];   // lse·log2(e), Δ
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = base, sv = base + Lay::K_BYTES;
  const uint32_t sqd = base + 2 * Lay::K_BYTES;
  const int bhk = blockIdx.x, b = bhk / g.Hkv, hk = bhk % g.Hkv;
  const int group = g.H / g.Hkv;
  // causal: key tile 0 sees every q row; the heaviest tiles come first
  const int k0 = blockIdx.y * ROWS;
  int lo, hi;
  q_range(g, k0, ROWS, BQ, lo, hi);
  const int nq = hi >= lo ? hi - lo + 1 : 0;
  const int n = group * nq;        // (q head, q tile): head-major
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(sm90::smem_u32(&kbar), 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1 + 32);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (t >= 32) return;         // one warp: TMA from lane 0, lse/Δ rows
    if (t == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tq)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tdo)) : "memory");
      const uint32_t kb = sm90::smem_u32(&kbar);
      sm90::mbar_expect_tx(kb, 2 * Lay::K_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        sm90::tma_load_4d(sk + c * Lay::KBOX, &tk, kb, 64 * c, hk, k0, b);
        sm90::tma_load_4d(sv + c * Lay::KBOX, &tv, kb, 64 * c, hk, k0, b);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % S, h = hk * group + i / nq;
      const int q0 = (lo + i % nq) * BQ;
      // the tile's lse and Δ rows are read before the wait for a free
      // stage, so that their latency passes while the producer waits
      float rl[BQ / 32], rd[BQ / 32];
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) {
        const int row = q0 + t + 32 * u;
        const long long x = (long long)(b * g.L + row) * g.H + h;
        rl[u] = row < g.L ? LSE[x] * LOG2E : 0.f;
        rd[u] = row < g.L ? DELTA[x] : 0.f;
      }
      sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
      const uint32_t fb = sm90::smem_u32(&full[s]);
      if (t == 0) {
        sm90::mbar_expect_tx(fb, Lay::STAGE);
        const uint32_t sq = sqd + s * Lay::STAGE, sdo = sq + Lay::Q_BYTES;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          sm90::tma_load_4d(sq + c * Lay::QBOX, &tq, fb, 64 * c, h, q0, b);
          sm90::tma_load_4d(sdo + c * Lay::QBOX, &tdo, fb, 64 * c, h, q0,
                            b);
        }
      }
#pragma unroll
      for (int u = 0; u < BQ / 32; ++u) {
        s_lse[s][t + 32 * u] = rl[u];
        s_dlt[s][t + 32 * u] = rd[u];
      }
      sm90::mbar_arrive(fb);
    }
    return;
  }

  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w4 = t / 32, lane = t % 32;
  const float c = g.scale * LOG2E;
  const int ks = k0 + wg * 64;               // this warpgroup's first key
  const int key_a = ks + w4 * 16 + lane / 4;    // its keys: key_a, key_a + 8
  float dk[D / 2], dv[D / 2], st[BQ / 2], dpt[BQ / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
  zero(dk);
  zero(dv);
  sm90::mbar_wait(sm90::smem_u32(&kbar), 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % S, q0 = (lo + i % nq) * BQ;
    sm90::mbar_wait(sm90::smem_u32(&full[s]), (i / S) & 1);
    const uint32_t sq = sqd + s * Lay::STAGE, sdo = sq + Lay::Q_BYTES;
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: keys × q rows
    zero(st);
    zero(dpt);
    sm90::fence_acc(st);
    sm90::fence_acc(dpt);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_64<0, 0>(st, kmajor(sk, Lay::KBOX, wg * 64, kk),
                           kmajor(sq, Lay::QBOX, 0, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_64<0, 0>(dpt, kmajor(sv, Lay::KBOX, wg * 64, kk),
                           kmajor(sdo, Lay::QBOX, 0, kk));
    sm90::wgmma_commit();
    sm90::fence_acc(st);
    sm90::fence_acc(dpt);
    sm90::wgmma_wait<0>();
    sm90::fence_acc(st);
    sm90::fence_acc(dpt);
    // pᵀ and dsᵀ, rounded to bf16 into pa and da; q rows past L (lse
    // 0, zero rows) fall to the column test of the edge tile, never to
    // exp
    const bool all = all_visible(g, q0, q0 + BQ - 1, ks, ks + 63);
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int col = frag_col(j, lane), r = (j >> 1) & 1;
      float p = exp2f(fmaf(st[j], c, -s_lse[s][col]));
      if (!all && !visible(g, q0 + col, key_a + 8 * r)) p = 0.f;
      st[j] = p;
      dpt[j] = p * (dpt[j] - s_dlt[s][col]) * g.scale;
    }
    pack_a<BQ>(pa, st);
    pack_a<BQ>(da, dpt);
    // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q read N-major
    sm90::fence_frag(pa);
    sm90::fence_frag(da);
    sm90::fence_acc(dv);
    sm90::fence_acc(dk);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mma_rs<D>(dv, pa[kk], nmajor(sdo, Lay::QBOX, kk));
      mma_rs<D>(dk, da[kk], nmajor(sq, Lay::QBOX, kk));
    }
    sm90::wgmma_commit();
    sm90::fence_acc(dv);
    sm90::fence_acc(dk);
    sm90::wgmma_wait<0>();
    sm90::fence_acc(dv);
    sm90::fence_acc(dk);
    if (t == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= g.L) continue;
    const long long o = ((long long)(b * g.L + key) * g.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(DK + o + d) =
          sm90::pack_bf16(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(DV + o + d) =
          sm90::pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}
}  // namespace wsk

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

using sm90::aligned16;
using sm90::make_map4;
using sm90::tma_layout;

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

// Which kernels lmr_flash_bwd_dq / _dkv run: the TMA + wgmma kernels
// for bf16 operands TMA can describe (head dims 64 and 128), the general
// bf16 kernels for other bf16 layouts, the f32 kernels for f32.
static int bwd_path(const void* q, const void* k, const void* v,
                    const void* d, int B, int D, const Geom& g, int dtype) {
  if (dtype == DT_F32) return PATH_F32;
  if ((D == 64 || D == 128) &&
      tma_layout(q, B, g.L, g.H, g.sqb, g.sql, g.sqh) &&
      tma_layout(k, B, g.L, g.Hkv, g.skb, g.skl, g.skh) &&
      tma_layout(v, B, g.L, g.Hkv, g.svb, g.svl, g.svh) &&
      tma_layout(d, B, g.L, g.H, g.sdb, g.sdl, g.sdh))
    return PATH_TMA;
  return PATH_GENERAL;
}

// An operand that passed tma_layout but whose map does not encode is a
// launch error, never a switch to the general kernels.
template <int D>
static cudaError_t launch_tma(bool dq, const void* q, const void* k,
                              const void* v, const void* d, const float* lse,
                              const float* delta, void* o0, void* o1,
                              const Geom& g, int B, cudaStream_t s) {
  const int qrows = dq ? wsk::ROWS : wsk::TILE;
  const int krows = dq ? wsk::TILE : wsk::ROWS;
  CUtensorMap tq, tk, tv, td;
  if (!make_map4(&tq, q, B, g.L, g.H, D, g.sqb, g.sql, g.sqh, qrows) ||
      !make_map4(&tk, k, B, g.L, g.Hkv, D, g.skb, g.skl, g.skh, krows) ||
      !make_map4(&tv, v, B, g.L, g.Hkv, D, g.svb, g.svl, g.svh, krows) ||
      !make_map4(&td, d, B, g.L, g.H, D, g.sdb, g.sdl, g.sdh, qrows))
    return cudaErrorInvalidValue;
  const int tiles = (g.L + wsk::ROWS - 1) / wsk::ROWS;
  if (dq) {
    static bool done = false;
    constexpr int smem = wsk::DqLayout<D>::DYN;
    cudaError_t e = allow_smem(wsk::dq_wgmma_kernel<D>, smem, done);
    if (e != cudaSuccess) return e;
    wsk::dq_wgmma_kernel<D><<<dim3(B * g.H, tiles), wsk::NT, smem, s>>>(
        tq, tk, tv, td, lse, delta, static_cast<bf16*>(o0), g);
  } else {
    static bool done = false;
    constexpr int smem = wsk::DkvLayout<D>::DYN;
    cudaError_t e = allow_smem(wsk::dkv_wgmma_kernel<D>, smem, done);
    if (e != cudaSuccess) return e;
    wsk::dkv_wgmma_kernel<D><<<dim3(B * g.Hkv, tiles), wsk::NT, smem, s>>>(
        tq, tk, tv, td, lse, delta, static_cast<bf16*>(o0),
        static_cast<bf16*>(o1), g);
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
      (long long)B * H > 65535 || o0 == nullptr || (!dq && o1 == nullptr) ||
      (D != 64 && D != 128) || (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  Geom g{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
         sdb, sdl, sdh, causal, window, q_offset,
         (float)(1.0 / sqrt((double)D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* LSE = static_cast<const float*>(lse);
  const float* DELTA = static_cast<const float*>(delta);
  const bool d64 = D == 64;
  cudaError_t e;
  switch (bwd_path(q, k, v, d, B, D, g, dtype)) {
    case PATH_TMA:
      e = d64 ? launch_tma<64>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s)
              : launch_tma<128>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s);
      break;
    case PATH_GENERAL:
      e = d64 ? launch_bf16<64>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s)
              : launch_bf16<128>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s);
      break;
    default:
      e = d64 ? launch_f32<64>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s)
              : launch_f32<128>(dq, q, k, v, d, LSE, DELTA, o0, o1, g, B, s);
  }
  return static_cast<int>(e);
}

extern "C" {

// Which kernels lmr_flash_bwd_dq / _dkv run for these operands: 1 the TMA
// + wgmma kernels, 0 the general bf16 kernels, 2 the f32 kernels, -1 none
// (an unsupported dtype or head dim). Arguments as theirs, without the
// lse, Δ, outputs, mask and stream.
int lmr_flash_bwd_path(const void* q, const void* k, const void* v,
                       const void* d, int B, int L, int H, int Hkv, int D,
                       long long sqb, long long sql, long long sqh,
                       long long skb, long long skl, long long skh,
                       long long svb, long long svl, long long svh,
                       long long sdb, long long sdl, long long sdh,
                       int dtype) {
  if ((dtype != DT_F32 && dtype != DT_BF16) || (D != 64 && D != 128))
    return -1;
  Geom g{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
         sdb, sdl, sdh, 0, 0, 0, 0.f};
  return bwd_path(q, k, v, d, B, D, g, dtype);
}

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
