// FlashAttention backward on Hopper (sm_90a): dq, dk and dv of
// softmax(Q·Kᵀ/√d)·V under causal / sliding-window masks (with the
// banded ring's q_offset) and grouped-query heads, re-materializing
// p = exp(s − lse) one tile at a time from the forward's saved lse.
//
// Replaces: lua_mapreduce_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel, both driven by _flash_bwd_pallas, with
// _bwd_tile's arithmetic in each. The TPU splits the backward in two
// because it has no cheap sum across grid steps of different blocks;
// here bf16 at head dim 64 takes one kernel, one pass (FlashAttention-3's
// form), and the other cases keep a dq kernel and a dkv kernel.
//
// Inputs: q, do (B, L, H, D) and k, v (B, L, Hkv, D) through their
// (batch, seq, head) strides, head dim contiguous; the lse and
// Δ = rowsum(do∘o) − g_lse, which the JAX package leaves to XLA: for the
// one-pass kernel a pre-pass here (opk::prep_kernel) writes each row's
// lse·log2(e) and Δ·scale in one pass over o and do, for the others
// torch computes Δ. Outputs dq (B, L, H, D), dk and dv (B, L, Hkv, D),
// contiguous, in the input dtype.
//
// Which kernels run is a predicate on the operands' layout
// (lmr_flash_bwd_path, the forward's lmr_flash_path with do added) and
// head dim:
//  * bf16 q/k/v/do that TMA can describe (16-byte aligned bases, every
//    stride of a dimension longer than one a multiple of 8 elements:
//    contiguous tensors, the model's fused-qkv views, do[:, :, ::2]),
//    head dim 64: the one-pass kernel (opk). 384 threads: a producer
//    thread issuing TMA, a writer thread adding dq partials, two
//    consumer warpgroups running wgmma; persistent, one block an SM,
//    taking (batch·kv head, 128-key tile) items from a counter in device
//    memory (opk::Walk). K and V of an item land once (two buffers: the
//    next item's load beside this one's work); its steps, the group's q
//    heads × the q tiles of 64 rows that see the key tile (_q_clamp's
//    range), stream q, do and the rows' lse·log2(e) and Δ·scale through
//    a ring of stages. Each consumer owns 64 keys. A step runs five
//    products: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (SS, two commit groups);
//    Pᵀ = exp2(Sᵀ·scale·log2(e) − lse·log2(e)) (the bare ex2.approx,
//    the column test only on tiles that cross L, the diagonal or the
//    window's edge) rounded to bf16 in the accumulator layout, which is
//    wgmma's register A layout, and dV += Pᵀ·dO issued at once, beside
//    dSᵀ = Pᵀ∘(dPᵀ·scale − Δ·scale); dSᵀ rounded to bf16 (the TPU
//    kernel's rounding point), dK += dSᵀ·Q, and dSᵀ stored to shared
//    memory, from which, after both warpgroups' halves are in, each
//    warpgroup forms half of dQ = dS·K over the item's 128 keys (dSᵀ
//    read M-major, K N-major: 64 × 32 a warpgroup). The first k step of
//    each chain writes its accumulator without reading it, so that the
//    last step's values die before it: with "+f" operands ptxas kept
//    them live past the 168 registers a thread of a 384-thread block
//    and serialised the wgmmas. A stage is freed by each consumer warp
//    after its own wait; dK and dV leave through swizzled shared memory
//    and a TMA store.
//    dQ: each step stages its 64 × 64 f32 partial in shared memory (each
//    thread's 16 values contiguous) and, unless it is the q tile's last,
//    the writer puts it into the q tile's tile of an f32 workspace with
//    one bulk copy (the first of the tile's partials) or bulk reduce-add
//    (cp.reduce.async.bulk .add.f32, the others), once the tile's
//    counter in device memory says the partials of every later key tile
//    are in, and counts it once the copy or add has completed (up to two
//    in flight; all are counted before the writer waits for another
//    tile's count). The last partial's consumers wait for the count,
//    read the sum back, add their own in registers, write dq in bf16 and
//    set the counter back to 0 (so no memset precedes a launch, and the
//    workspace needs none). So every q tile's partials are summed in one
//    order, descending key tiles, whatever the blocks' timing: two calls,
//    a captured call and the mesh steps give the same bits, as the
//    two-kernel form did.
//    No deadlock: a step waits only for items of later key tiles of its
//    own batch·kv head, and the walk puts the key tiles of a batch·kv
//    head last first (within chunks of batch·kv heads whose q, do, K and
//    V fit in half the L2), so every item a step waits for was taken
//    earlier, by a block that is running or done, and that item's own
//    waits point further back; the writer releases a partial's count
//    before it waits for another. Nothing assumes the blocks run at
//    once (tests/test_torch_flash_bwd_plan.py walks it with one SM).
//    Under GQA an item carries its group's q heads, so a kv head's key
//    tile 0 is the heaviest item and comes last among its items: the
//    walk's tail (splitting items by q head, dK and dV summed over the
//    group like dQ, measured slower). At the LM's GQA 4:1 shape the
//    kernel still runs as fast as the two-kernel form did (PERF.md §6).
//  * bf16 TMA layouts at head dim 128, the two-kernel form (wsk): 384
//    threads, one producer thread issuing TMA through a 4-stage ring,
//    two consumer warpgroups. dq: a block per (batch·head, 128-row q
//    tile), 32-key K/V tiles streaming; dkv: a block per (batch·kv head,
//    128-key tile), 32-row q/do tiles of the group's q heads streaming,
//    dk and dv (128 registers a thread) held across the group; the
//    narrow partner tiles end dq's spill and cut dkv's (which dk and dv
//    alone make: the one instantiation the ptxas gate lets spill, by at
//    most what it spills now, and serialise, for want of registers
//    only).
//  * Other bf16 layouts take the general kernels (bfk), the first design:
//    4 warps, mma.sync m16n8k16 from padded shared memory; the dq kernel
//    a 64-row q tile over 64-key kv tiles, the dkv kernel a 64-key tile
//    forming sᵀ = k·qᵀ and dpᵀ = v·doᵀ directly (16 keys × 32 q rows a
//    warp) so that pᵀ and dsᵀ are the A fragments of the next products.
//  * f32 inputs: full-precision FP32 FMAs (f32k; no TF32), 4 threads per
//    row (q row for dq, key row for dkv), each owning a quarter of the
//    head dim; dot products are finished by quad shuffles.
// In all of them, dead tiles are never visited (a key tile wholly behind
// the window has no step: dk = dv = 0; a q tile no key tile sees gets
// dq = 0, from the one-pass kernel's pre-pass there), and rows past L
// are never written.
//
// What bounds the one-pass kernel on the H100 at the training shape
// (B=8, L=2048, H=16, d=64, causal, bf16): the tensor cores need
// 5 · 2 · B·H·d·L(L+1)/2 = 172 GFLOP, 0.174 ms at 989 TFLOP/s, against
// ~270 MB read and written, the f32 workspace included (0.08 ms at
// 3.35 TB/s); the SFU needs one
// exponential a score, B·H·L(L+1)/2 = 2.7·10^8, 0.07 ms at 16 a clock an
// SM. Beside each exponential a consumer thread issues about four FP32
// instructions (the scale-and-subtract FMA, dS's FMA and multiply, the
// column test's select on edge tiles), a bf16 pack for P and one for dS
// and half a shared-memory store of dS, so with two consumer warps a
// sub-partition the products wait on that issue, as in the forward.
// Left for later: issuing the next step's Sᵀ and dPᵀ before this step's
// dK and dQ retire (the registers: dK, dV, Sᵀ, dPᵀ, Pᵀ, dSᵀ and dQ
// together exceed 168 a thread); a GQA schedule without the heavy last
// item; head dim 128 in one pass (dK and dV alone take 128 registers);
// ldmatrix in the general kernels.

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

// The partner tiles each block streams, kv tiles for dq and q tiles for
// dkv, are 32 wide (these kernels run head dim 128 only: 64 takes the
// one-pass kernel). ptxas allocates 168 registers to each of the 384
// threads, whatever setmaxnreg hands the consumers at run time: 32-wide
// kv tiles end dq's spill, but in dkv dk and dv alone take 128 a
// thread: 64-wide q tiles spilled 2.4 KB a thread and serialised the
// wgmmas, 32-wide ones spill 548 bytes and 16-wide ones still 92 bytes,
// slower (PERF.md §6).
constexpr int TILE = 32;

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

// d (64 × 32, f32) += A (64 × 16) · B (16 × 32), both from shared
// memory; TA / TB: M- / N-major (else K-major); scale_d 0: d = A · B
template <int TA, int TB>
__device__ __forceinline__ void wgmma_32(float (&d)[16], uint64_t da,
                                         uint64_t db, uint32_t scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d = A · B for the first k step of a chain: d's earlier values are not
// read, so that they die before it (a "+f" operand would keep the last
// tile's values live into the next, past the 168 registers a thread)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_32_set(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  constexpr uint32_t scale_d = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_64_set(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  constexpr uint32_t scale_d = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// a chain of STEPS k steps of a K-major SS product into an N-wide
// accumulator (N 64 or 32), the first step writing it; da(kk) and
// db(kk) give step kk's descriptors
template <int N, int STEPS, typename A, typename B>
__device__ __forceinline__ void ss_chain(float (&d)[N / 2], A da, B db) {
  if constexpr (N == 64) wgmma_64_set<0, 0>(d, da(0), db(0));
  else wgmma_32_set<0, 0>(d, da(0), db(0));
#pragma unroll
  for (int kk = 1; kk < STEPS; ++kk) {
    if constexpr (N == 64) sm90::wgmma_64<0, 0>(d, da(kk), db(kk));
    else wgmma_32<0, 0>(d, da(kk), db(kk));
  }
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
      sm90::wgmma_fence();
      ss_chain<BK, D / 16>(
          sc, [&](int kk) { return kmajor(sq, Lay::QBOX, wg * 64, kk); },
          [&](int kk) { return kmajor(sk, Lay::KBOX, 0, kk); });
      ss_chain<BK, D / 16>(
          dp, [&](int kk) { return kmajor(sdo, Lay::QBOX, wg * 64, kk); },
          [&](int kk) { return kmajor(sv, Lay::KBOX, 0, kk); });
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
    sm90::wgmma_fence();
    ss_chain<BQ, D / 16>(
        st, [&](int kk) { return kmajor(sk, Lay::KBOX, wg * 64, kk); },
        [&](int kk) { return kmajor(sq, Lay::QBOX, 0, kk); });
    ss_chain<BQ, D / 16>(
        dpt, [&](int kk) { return kmajor(sv, Lay::KBOX, wg * 64, kk); },
        [&](int kk) { return kmajor(sdo, Lay::QBOX, 0, kk); });
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

// ------------------------- bf16, d = 64: one pass, five products (FA3)

namespace opk {
constexpr int NT = 384;       // two consumer warpgroups, the producer's
constexpr int D = 64;
constexpr int BK = 128;       // keys an item: 64 a consumer warpgroup
constexpr int BQ = 64;        // q rows a step
constexpr int STAGES = 3;     // q / do stages
constexpr int NDQ = 3;        // dQ staging buffers
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1 KB aligned base: two {K, V} buffers (the
// producer loads the next item's while the consumers finish this one),
// STAGES {Q, dO} stages, dSᵀ twice (keys × q rows, the A operand of the
// dQ product), NDQ dQ partials (f32, each thread's 16 values
// contiguous: the workspace tile's order; up to NDQ − 1 in flight to
// the workspace while the consumers stage the next), dK and dV's
// staging for the TMA store, and each stage's lse·log2(e) and Δ·scale
// rows; 1 KB of slack to align the swizzle atoms.
constexpr int KV_BYTES = BK * D * 2;              // 16 KB: one box
constexpr int Q_BYTES = BQ * D * 2;               // 8 KB: one box
constexpr int STAGE = 2 * Q_BYTES;
constexpr int DS_BYTES = BK * BQ * 2;             // 16 KB
constexpr int DQ_BYTES = BQ * D * 4;              // 16 KB
constexpr int OUT_BYTES = 2 * 2 * 64 * D * 2;     // 32 KB: dK, dV a warpgroup
constexpr int RS_BYTES = BQ * 8;                  // 512 B: float2 a row
constexpr int OFF_Q = 2 * 2 * KV_BYTES;
constexpr int OFF_DS = OFF_Q + STAGES * STAGE;
constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;
constexpr int OFF_OUT = OFF_DQ + NDQ * DQ_BYTES;
constexpr int OFF_RS = OFF_OUT + OUT_BYTES;
constexpr int DYN = OFF_RS + STAGES * RS_BYTES + 1024;
static_assert(DYN + 512 <= 232448, "shared memory");

// The launch's walk over its nk · bh items (batch·kv head, key tile of
// BK keys), taken one at a time from a counter in device memory. The
// batch·kv heads go in chunks of `chunk` whose q, do, K and V fit in half
// the L2; within a chunk the key tiles go last first (rank r is key tile
// nk − 1 − r), the chunk's batch·kv heads fastest. A q tile's dQ
// partials are summed in descending key-tile order, so every item a
// step waits on (a later key tile of the same batch·kv head) comes
// earlier in the walk.
struct Walk {
  int nk, bh, chunk;
};

__host__ __device__ __forceinline__ void walk_decode(const Walk& w, int it,
                                                     int& bh, int& kt) {
  const int per = w.chunk * w.nk, ch = it / per, rem = it - ch * per;
  const int rest = w.bh - ch * w.chunk;
  const int cw = rest < w.chunk ? rest : w.chunk;
  bh = ch * w.chunk + rem % cw;
  kt = w.nk - 1 - rem / cw;
}

// 2^x on the MUFU pipe, without exp2f's range fix-up (subnormal results
// flush to 0, as below −126)
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one try of an mbarrier phase's wait: has the phase of parity `parity`
// completed?
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// spin until the int at p (device memory) holds `want`, with acquire
// semantics; a count that never comes traps (the launch fails) instead
// of hanging the card
__device__ __forceinline__ void wait_count(const int* p, int want);

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void wait_count(const int* p, int want) {
  uint32_t tries = 0;
  while (ld_acquire(p) != want)
    if (++tries == (1u << 24)) __trap();
}

// MODE 0 is the kernel; 1 (products alone: Pᵀ and dSᵀ are Sᵀ and dPᵀ
// copied), 2 (the elementwise part alone: no product issued) and 3 (the
// loads and the dQ sums alone: neither) are for phase 2's
// decomposition, times only.
//
// ctr[0] counts the items taken (the block taking the last count sets
// it back to 0); ctr[1 + i], for the q tile i = (b·H + h)·nq + qt, counts
// the partials in its workspace tile (its last contributor sets it back
// to 0). ws: B·H·nq tiles of 64 × 64 f32, each thread's 16 values of a
// partial contiguous (nothing reads it but the kernel: the first
// contributor stores its partial, the later ones add theirs, the last
// reads the sum back, adds its own and writes dq). dq: contiguous (B, L,
// H, 64) bf16; the q tiles no step writes (dq_written) are the
// pre-pass's zeros. rs: (B, H, nq·64, 2) f32, {lse·log2(e), Δ·scale} a
// row.
template <int MODE>
__global__ void __launch_bounds__(NT, 1)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tdk,
                 const __grid_constant__ CUtensorMap tdv,
                 const float* __restrict__ rs, float* __restrict__ ws,
                 bf16* __restrict__ DQ, int* __restrict__ ctr, Geom g,
                 const __grid_constant__ Walk w) {
  extern __shared__ uint8_t smem_raw[];
  // kvfull / kvempty: an item's K and V have landed / the 8 consumer
  // warps are done with them; full / empty: the same for a q/do stage
  // (its rows' lse and Δ with it); dqfull / dqempty: a dQ partial is
  // staged (8 consumer warps) / the writer has added it
  __shared__ __align__(8) uint64_t kvfull[2], kvempty[2], full[STAGES],
      empty[STAGES], dqfull[NDQ], dqempty[NDQ];
  __shared__ volatile int item[2];
  // a staged partial: its q tile's index, the count of partials before
  // it, the count it leaves (0 after the last); index −1 ends the walk
  __shared__ volatile int dqinfo[NDQ][3];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  const int items = w.nk * w.bh;
  const int group = g.H / g.Hkv;
  const int nq = (g.L + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(sm90::smem_u32(&kvfull[i]), 1);
      sm90::mbar_init(sm90::smem_u32(&kvempty[i]), 8);
    }
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), 8);
    }
    for (int i = 0; i < NDQ; ++i) {
      sm90::mbar_init(sm90::smem_u32(&dqfull[i]), 8);
      sm90::mbar_init(sm90::smem_u32(&dqempty[i]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (t == 0) {
      // ---------------------------------------------------- producer
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tq)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tdo)) : "memory");
      int st = 0;                                // steps loaded so far
      for (int r = 0;; ++r) {
        const int kb = r & 1;
        sm90::mbar_wait(sm90::smem_u32(&kvempty[kb]), ((r >> 1) & 1) ^ 1);
        const int it = atomicAdd(ctr, 1);
        item[kb] = it;
        const uint32_t kvb = sm90::smem_u32(&kvfull[kb]);
        if (it >= items) {
          // each block counts once past the items: the last count is
          // items + grid − 1, after which no block reads the counter
          if (it == items + (int)gridDim.x - 1) atomicExch(ctr, 0);
          sm90::mbar_arrive(kvb);
          break;
        }
        int bhk, kt;
        walk_decode(w, it, bhk, kt);
        const int b = bhk / g.Hkv, hk = bhk % g.Hkv, k0 = kt * BK;
        sm90::mbar_expect_tx(kvb, 2 * KV_BYTES);
        const uint32_t sk = base + kb * 2 * KV_BYTES;
        sm90::tma_load_4d(sk, &tk, kvb, 0, hk, k0, b);
        sm90::tma_load_4d(sk + KV_BYTES, &tv, kvb, 0, hk, k0, b);
        int lo, hi;
        q_range(g, k0, BK, BQ, lo, hi);
        // the steps: the q tiles ascending, the group's q heads fastest
        for (int i = 0; i < (hi >= lo ? hi - lo + 1 : 0) * group; ++i, ++st) {
          const int qt = lo + i / group, h = hk * group + i % group;
          const int s = st % STAGES;
          sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((st / STAGES) & 1) ^ 1);
          const uint32_t fb = sm90::smem_u32(&full[s]);
          sm90::mbar_expect_tx(fb, STAGE + RS_BYTES);
          const uint32_t sq = base + OFF_Q + s * STAGE;
          sm90::tma_load_4d(sq, &tq, fb, 0, h, qt * BQ, b);
          sm90::tma_load_4d(sq + Q_BYTES, &tdo, fb, 0, h, qt * BQ, b);
          const float* src = rs + ((long long)(b * g.H + h) * nq + qt) * BQ * 2;
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];" ::"r"(base + OFF_RS + s * RS_BYTES),
              "l"(src), "r"(RS_BYTES), "r"(fb) : "memory");
        }
      }
    } else if (t == 32) {
      // ------------------------------------------------------ writer
      // stores or adds each staged dQ partial into its workspace tile
      // once the partials of the key tiles before it (in descending
      // order) are in, and counts it once the store or add has completed.
      // Up to NDQ − 1 partials are in flight; all of them are completed
      // and counted before the writer waits for another tile's count,
      // and whenever it waits for the consumers.
      int pidx[NDQ], pafter[NDQ], pnb[NDQ], np = 0;
      auto count = [&](int i) {
        st_release(ctr + 1 + pidx[i], pafter[i]);
        sm90::mbar_arrive(sm90::smem_u32(&dqempty[pnb[i]]));
      };
      auto drain = [&] {
        if (np == 0) return;
        asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
        asm volatile("fence.proxy.async.global;" ::: "memory");
        for (int i = 0; i < np; ++i) count(i);
        np = 0;
      };
      for (int n = 0;; ++n) {
        const int nb = n % NDQ;
        const uint32_t fb = sm90::smem_u32(&dqfull[nb]);
        uint32_t tries = 0;
        while (!mbar_try(fb, (n / NDQ) & 1)) {
          drain();
          if (++tries == (1u << 26)) __trap();
        }
        const int idx = dqinfo[nb][0], before = dqinfo[nb][1];
        const int after = dqinfo[nb][2];
        if (idx < 0) {
          drain();
          break;
        }
        if (before > 0 && ld_acquire(ctr + 1 + idx) != before) {
          drain();
          wait_count(ctr + 1 + idx, before);
        }
        asm volatile("fence.proxy.async.global;" ::: "memory");
        const uint32_t src = base + OFF_DQ + nb * DQ_BYTES;
        float* dst = ws + (long long)idx * (BQ * D);
        if (before == 0)
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
              ::"l"(dst), "r"(src), "r"(DQ_BYTES) : "memory");
        else
          asm volatile(
              "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
              "[%0], [%1], %2;" ::"l"(dst), "r"(src), "r"(DQ_BYTES)
              : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        pidx[np] = idx;
        pafter[np] = after;
        pnb[np] = nb;
        if (++np == NDQ) {       // the oldest must free its buffer
          asm volatile("cp.async.bulk.wait_group %0;" ::"n"(NDQ - 1)
                       : "memory");
          asm volatile("fence.proxy.async.global;" ::: "memory");
          count(0);
          for (int i = 1; i < NDQ; ++i) {
            pidx[i - 1] = pidx[i];
            pafter[i - 1] = pafter[i];
            pnb[i - 1] = pnb[i];
          }
          --np;
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  constexpr bool PRODUCTS = MODE == 0 || MODE == 1;
  constexpr bool ELEMENTWISE = MODE == 0 || MODE == 2;
  const int w4 = t / 32, lane = t % 32;
  const float c = g.scale * LOG2E;
  float dk[32], dv[32], sc[32], dp[32], dq[16];
  uint32_t pa[4][4], da[4][4];
  if (!PRODUCTS) {
    wsk::zero(sc);
    wsk::zero(dp);
    wsk::zero(dq);
  }
  int st = 0, n = 0;                   // steps consumed, partials staged
  // stage a dQ partial (or, idx −1, the end) for the writer
  auto post = [&](int idx, int before, int after) {
    const int nb = n % NDQ;
    sm90::mbar_wait(sm90::smem_u32(&dqempty[nb]), ((n / NDQ) & 1) ^ 1);
    if (idx >= 0) {
      const uint32_t at = base + OFF_DQ + nb * DQ_BYTES + (wg * 128 + t) * 64;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(at + 16 * q),
                     "f"(dq[4 * q]), "f"(dq[4 * q + 1]), "f"(dq[4 * q + 2]),
                     "f"(dq[4 * q + 3]) : "memory");
    }
    if (wg == 0 && t == 0) {
      dqinfo[nb][0] = idx;
      dqinfo[nb][1] = before;
      dqinfo[nb][2] = after;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&dqfull[nb]));
    ++n;
  };

  for (int r = 0;; ++r) {
    const int kb = r & 1;
    sm90::mbar_wait(sm90::smem_u32(&kvfull[kb]), (r >> 1) & 1);
    const int it = item[kb];
    if (it >= items) break;
    int bhk, kt;
    walk_decode(w, it, bhk, kt);
    const int b = bhk / g.Hkv, hk = bhk % g.Hkv, k0 = kt * BK;
    const int ks = k0 + wg * 64;              // this warpgroup's first key
    const int key_a = ks + w4 * 16 + lane / 4;   // its keys: key_a, key_a + 8
    const uint32_t sk = base + kb * 2 * KV_BYTES, sv = sk + KV_BYTES;
    int lo, hi;
    q_range(g, k0, BK, BQ, lo, hi);
    wsk::zero(dk);
    wsk::zero(dv);
    // the item's steps i: q tile lo + i / group (ascending), q head
    // hk·group + i % group; step i uses stage (st0 + i) % STAGES
    const int nsteps = (hi >= lo ? hi - lo + 1 : 0) * group, st0 = st;
    auto stage_of = [&](int i) { return (st0 + i) % STAGES; };
    auto sq_of = [&](int i) { return base + OFF_Q + stage_of(i) * STAGE; };
    auto wait_full = [&](int i) {
      sm90::mbar_wait(sm90::smem_u32(&full[stage_of(i)]),
                      ((st0 + i) / STAGES) & 1);
    };
    // Sᵀ = K·Qᵀ of step i (keys × q rows), one group
    auto issue_s = [&](int i) {
      if constexpr (PRODUCTS) {
        sm90::wgmma_fence();
        wsk::ss_chain<64, D / 16>(
            sc, [&](int kk) { return wsk::kmajor(sk, BK * 128, wg * 64, kk); },
            [&](int kk) { return wsk::kmajor(sq_of(i), BQ * 128, 0, kk); });
        sm90::wgmma_commit();
      }
    };
    // step i
    auto body = [&](int i) {
      const int qt = lo + i / group, h = hk * group + i % group;
      // the key tiles that see q tile qt, summed last first: this one
      // adds after the (klast − kt) before it
      int klo, klast;
      kv_range(g, qt * BQ + g.q_offset, BQ, BK, klo, klast);
      const int q0 = qt * BQ;
      const bool all = wsk::all_visible(g, q0, q0 + BQ - 1, ks, ks + 63);
      const int s = stage_of(i);
      const uint32_t sq = sq_of(i), sdo = sq + Q_BYTES;
      const float4* rsv = reinterpret_cast<const float4*>(
          gbase + OFF_RS + s * RS_BYTES);
      const uint32_t sds = base + OFF_DS + ((st0 + i) & 1) * DS_BYTES;
      wait_full(i);
      issue_s(i);
      if constexpr (PRODUCTS) {
        // dPᵀ = V·dOᵀ, a second group
        sm90::wgmma_fence();
        wsk::ss_chain<64, D / 16>(
            dp, [&](int kk) { return wsk::kmajor(sv, BK * 128, wg * 64, kk); },
            [&](int kk) { return wsk::kmajor(sdo, BQ * 128, 0, kk); });
        sm90::wgmma_commit();
        sm90::fence_acc(sc);
        sm90::fence_acc(dp);
        sm90::wgmma_wait<1>();
        sm90::fence_acc(sc);
      }
      // Pᵀ = exp2(Sᵀ·scale·log2(e) − lse·log2(e)), the column test on
      // edge tiles only (q rows past L, keys past L, the diagonal, the
      // window's edge, fully masked rows: never through exp)
      if constexpr (ELEMENTWISE) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 x = rsv[4 * jj + lane % 4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * jj + e;
            float p = exp2_mufu(fmaf(sc[j], c, -((e & 1) ? x.z : x.x)));
            if (!all && !visible(g, q0 + wsk::frag_col(j, lane),
                                 key_a + 8 * ((j >> 1) & 1)))
              p = 0.f;
            sc[j] = p;
          }
        }
      }
      if constexpr (MODE != 3) wsk::pack_a<64>(pa, sc);
      if constexpr (PRODUCTS) {
        // dV += Pᵀ·dO, dO read N-major; runs beside dSᵀ below
        sm90::fence_frag(pa);
        sm90::fence_acc(dv);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::wgmma_rs_64(dv, pa[kk], wsk::nmajor(sdo, BQ * 128, kk));
        sm90::wgmma_commit();
        sm90::fence_acc(dv);
        sm90::wgmma_wait<1>();
        sm90::fence_acc(dp);
      }
      // dSᵀ = Pᵀ∘(dPᵀ − Δ)·scale, rounded to bf16 (the TPU kernel's
      // rounding point) into da, and into shared memory for dQ
      if constexpr (ELEMENTWISE) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 x = rsv[4 * jj + lane % 4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * jj + e;
            dp[j] = sc[j] * fmaf(dp[j], g.scale, -((e & 1) ? x.w : x.y));
          }
        }
      }
      if constexpr (MODE != 3) {
        wsk::pack_a<64>(da, dp);
        // dSᵀ's rows (keys) 64·wg + 16·w4 + lane/4 (+8), its columns (q
        // rows) in the 128-byte swizzle: row r's 16-byte chunk c at
        // c ^ (r % 8)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = wg * 64 + w4 * 16 + lane / 4 + 8 * (q & 1);
            const int byte = 2 * (16 * kk + 8 * (q >> 1) + 2 * (lane % 4));
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(
                             sds + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) +
                             (byte & 15)), "r"(da[kk][q]) : "memory");
          }
      }
      if constexpr (PRODUCTS) {
        // dK += dSᵀ·Q, Q read N-major
        sm90::fence_frag(da);
        sm90::fence_acc(dk);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          sm90::wgmma_rs_64(dk, da[kk], wsk::nmajor(sq, BQ * 128, kk));
        sm90::wgmma_commit();
        sm90::fence_acc(dk);
      }
      // both warpgroups' halves of dSᵀ are written
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      sm90::named_sync(1, 256);
      if constexpr (PRODUCTS) {
        // dQ[:, 32·wg, +32] = dS·K over the item's 128 keys: dSᵀ read
        // M-major, K N-major from column 32·wg
        sm90::wgmma_fence();
        wsk::wgmma_32_set<1, 1>(dq, sm90::desc_sw128(sds, 8192, 1024),
                                sm90::desc_sw128(sk + wg * 64, 8192, 1024));
#pragma unroll
        for (int kk = 1; kk < BK / 16; ++kk)
          wsk::wgmma_32<1, 1>(
              dq, sm90::desc_sw128(sds + kk * 2048, 8192, 1024),
              sm90::desc_sw128(sk + kk * 2048 + wg * 64, 8192, 1024));
        sm90::wgmma_commit();
        sm90::fence_acc(dq);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(dq);
        sm90::fence_acc(dv);
        sm90::fence_acc(dk);
      } else if constexpr (MODE == 2) {
        sm90::fence_frag(da);      // keep the elementwise part's result
        sm90::fence_frag(pa);
      }
      // each warp frees the stage once its own products have retired
      if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
      const int idx = (b * g.H + h) * nq + qt, before = klast - kt;
      if (kt != klo) {
        post(idx, before, before + 1);
        return;
      }
      // the last contributor: once the others' sum is in, it adds its
      // own partial in registers and writes dq (bf16) itself
      if (before > 0) {
        if (wg == 0 && t == 0) wait_count(ctr + 1 + idx, before);
        sm90::named_sync(1, 256);
        asm volatile("fence.proxy.async.global;" ::: "memory");
        const float4* sum = reinterpret_cast<const float4*>(
            ws + (long long)idx * (BQ * D) + (wg * 128 + t) * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x = __ldcg(sum + q);
          dq[4 * q] += x.x;
          dq[4 * q + 1] += x.y;
          dq[4 * q + 2] += x.z;
          dq[4 * q + 3] += x.w;
        }
        if (wg == 0 && t == 0) ctr[1 + idx] = 0;
      }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const int row = q0 + w4 * 16 + lane / 4 + 8 * r2;
        if (row >= g.L) continue;
        bf16* out = DQ + ((long long)(b * g.L + row) * g.H + h) * D +
                    32 * wg + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              sm90::pack_bf16(dq[4 * j + 2 * r2], dq[4 * j + 2 * r2 + 1]);
      }
    };
    for (int i = 0; i < nsteps; ++i) body(i);
    st += nsteps;
    if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&kvempty[kb]));
    // dK and dV (bf16) through swizzled shared memory, one TMA store of
    // 64 keys × 64 d each a warpgroup; keys past L are not written
    const uint32_t ob = base + OFF_OUT + wg * (2 * 64 * D * 2);
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    sm90::named_sync(2 + wg, 128);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = w4 * 16 + lane / 4 + 8 * q;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int byte = (8 * j + 2 * (lane % 4)) * 2;
        const uint32_t at = ob + row * 128 + ((((byte >> 4) ^ (row & 7))) << 4) +
                            (byte & 15);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                     "r"(sm90::pack_bf16(dk[4 * j + 2 * q], dk[4 * j + 2 * q + 1]))
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + 64 * D * 2),
                     "r"(sm90::pack_bf16(dv[4 * j + 2 * q], dv[4 * j + 2 * q + 1]))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    sm90::named_sync(2 + wg, 128);
    if (t == 0) {
      sm90::tma_store_4d(&tdk, ob, 0, hk, ks, b);
      sm90::tma_store_4d(&tdv, ob + 64 * D * 2, 0, hk, ks, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  post(-1, 0, 0);
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The one-pass kernel's rows, in one pass over o and do (the work the
// JAX package leaves to XLA in _flash_bwd_pallas, attention.py:527-538):
// rows[(b·H + h)·Lp + l] = {lse·log2(e), (rowsum(do∘o) − g_lse)·scale}
// for each (b, l, h) row of contiguous f32 o, lse and g_lse (or none)
// and contiguous do (f32 or bf16). Eight threads a row, each summing
// eight of its 64 products, then a shuffle over the eight: bound by the
// bytes of o and do. With dq given it also writes the zeros of each q
// tile that no step of the kernel writes (dq_written).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Does a step of the kernel write q tile qt's dq? Its last contributor
// does: key tile klo of the tiles that see it, where that key tile's
// steps (q_range) include qt. Otherwise (a q tile past every key the
// window or q_offset lets it see) dq stays 0.
__device__ __forceinline__ bool dq_written(const Geom& g, int qt) {
  int klo, khi, lo, hi;
  kv_range(g, qt * BQ + g.q_offset, BQ, BK, klo, khi);
  if (klo > khi) return false;
  q_range(g, klo * BK, BK, BQ, lo, hi);
  return lo <= qt && qt <= hi;
}

template <typename T>
__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ O, const T* __restrict__ DO,
            const float* __restrict__ LSE, const float* __restrict__ GL,
            float2* __restrict__ rows, bf16* __restrict__ DQ, Geom g,
            int Lp, long long n) {
  const int L = g.L, H = g.H;
  const long long r = ((long long)blockIdx.x * 256 + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  float acc = 0.f;
  if (r < n) {
    float o[8], d[8];
    load8(O + r * D + part * 8, o);
    load8(DO + r * D + part * 8, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(o[i], d[i], acc);
    if (DQ != nullptr && !dq_written(g, static_cast<int>((r / H) % L) / BQ))
      *reinterpret_cast<uint4*>(DQ + r * D + part * 8) = make_uint4(0, 0, 0, 0);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (part == 0 && r < n) {
    const int h = static_cast<int>(r % H);
    const long long bl = r / H;
    const int l = static_cast<int>(bl % L);
    const long long b = bl / L;
    const float dl = acc - (GL != nullptr ? GL[r] : 0.f);
    rows[(b * H + h) * Lp + l] = make_float2(LSE[r] * LOG2E, dl * g.scale);
  }
}

// The walk and its grid: one block an SM, at most one an item.
static int make_walk(Walk& w, const Geom& g, int BHkv) {
  w.nk = (g.L + BK - 1) / BK;
  w.bh = BHkv;
  // q and do of a kv head's group, and its K and V (bf16)
  const long long bytes = (long long)(2 * (g.H / g.Hkv) + 2) * g.L * D * 2;
  const long long half_l2 = sm90::l2_bytes() / 2;
  const long long fit = bytes > 0 ? half_l2 / bytes : BHkv;
  w.chunk = static_cast<int>(fit < 1 ? 1 : fit > BHkv ? BHkv : fit);
  const int sms = sm90::sm_count();
  if (sms <= 0) return 0;
  const long long items = (long long)w.nk * BHkv;
  return static_cast<int>(items < sms ? items : sms);
}
}  // namespace opk

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

// One launch of the one-pass kernel (bf16, head dim 64, TMA layouts):
// the persistent grid of opk::make_walk. An operand whose map does not
// encode is a launch error, never a switch to another kernel.
template <int MODE>
static cudaError_t launch_one_pass(const void* q, const void* k,
                                   const void* v, const void* d,
                                   const float* rs, float* ws, void* dq,
                                   int* ctr, void* dk, void* dv,
                                   const Geom& g, int B, cudaStream_t s) {
  constexpr int D = opk::D;
  CUtensorMap tq, tk, tv, td, tdk, tdv;
  const long long kvl = (long long)g.Hkv * D;
  if (!make_map4(&tq, q, B, g.L, g.H, D, g.sqb, g.sql, g.sqh, opk::BQ) ||
      !make_map4(&tk, k, B, g.L, g.Hkv, D, g.skb, g.skl, g.skh, opk::BK) ||
      !make_map4(&tv, v, B, g.L, g.Hkv, D, g.svb, g.svl, g.svh, opk::BK) ||
      !make_map4(&td, d, B, g.L, g.H, D, g.sdb, g.sdl, g.sdh, opk::BQ) ||
      !aligned16(dk) || !aligned16(dv) ||
      !make_map4(&tdk, dk, B, g.L, g.Hkv, D, kvl * g.L, kvl, D, 64) ||
      !make_map4(&tdv, dv, B, g.L, g.Hkv, D, kvl * g.L, kvl, D, 64))
    return cudaErrorInvalidValue;
  opk::Walk w;
  const int grid = opk::make_walk(w, g, B * g.Hkv);
  if (grid <= 0 || rs == nullptr || ws == nullptr || dq == nullptr ||
      ctr == nullptr)
    return cudaErrorInvalidValue;
  static bool done = false;   // once per instantiation
  cudaError_t e = allow_smem(opk::bwd_wgmma_kernel<MODE>, opk::DYN, done);
  if (e != cudaSuccess) return e;
  opk::bwd_wgmma_kernel<MODE><<<grid, opk::NT, opk::DYN, s>>>(
      tq, tk, tv, td, tdk, tdv, rs, ws, static_cast<bf16*>(dq), ctr, g, w);
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
      // head dim 64 takes the one-pass kernel (lmr_flash_bwd), not these
      e = d64 ? cudaErrorInvalidValue
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

static Geom make_geom(int L, int H, int Hkv, int D, long long sqb,
                      long long sql, long long sqh, long long skb,
                      long long skl, long long skh, long long svb,
                      long long svl, long long svh, long long sdb,
                      long long sdl, long long sdh, int causal, int window,
                      int q_offset) {
  return Geom{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
              sdb, sdl, sdh, causal, window, q_offset,
              (float)(1.0 / sqrt((double)D))};
}

extern "C" {

// Which kernels run the backward for these operands: 1 the TMA + wgmma
// kernels (at head dim 64 the one-pass lmr_flash_bwd, at 128 the two of
// lmr_flash_bwd_dq / _dkv), 0 the general bf16 kernels, 2 the f32
// kernels, -1 none (an unsupported dtype or head dim). Arguments as
// lmr_flash_bwd_dq's, without the lse, Δ, outputs, mask and stream.
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
// launch (0 = launched); bf16 operands at head dim 64 that TMA can
// describe are refused (they take lmr_flash_bwd).
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

// The one-pass backward (bf16 q/k/v/do that TMA can describe, head dim
// 64): dq (contiguous (B, L, H, 64) bf16, the q tiles no step writes
// zeroed by lmr_flash_bwd_prep), dk and
// dv (contiguous (B, L, Hkv, 64) bf16) through the workspace ws (B·H·nq
// tiles of 64 × 64 f32, no initial values). rs: (B, H, nq·64, 2) f32 rows
// {lse·log2(e), Δ·scale}, zero past L; ctr: 1 + B·H·nq ints holding 0,
// which the kernel leaves at 0. mode: as opk's MODE (0 the kernel; 1-3
// phase 2's decomposition). Operands the kernel does not take are
// refused, never sent elsewhere.
int lmr_flash_bwd(const void* q, const void* k, const void* v,
                  const void* d, const void* rs, void* ws, void* dq,
                  void* ctr, void* dk, void* dv, int B, int L, int H,
                  int Hkv, int D,
                  long long sqb, long long sql, long long sqh,
                  long long skb, long long skl, long long skh,
                  long long svb, long long svl, long long svh,
                  long long sdb, long long sdl, long long sdh, int causal,
                  int window, int q_offset, int mode, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      D != opk::D || mode < 0 || mode > 3)
    return cudaErrorInvalidValue;
  const Geom g = make_geom(L, H, Hkv, D, sqb, sql, sqh, skb, skl, skh, svb,
                           svl, svh, sdb, sdl, sdh, causal, window, q_offset);
  if (bwd_path(q, k, v, d, B, D, g, DT_BF16) != PATH_TMA)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* R = static_cast<const float*>(rs);
  float* W = static_cast<float*>(ws);
  int* C = static_cast<int*>(ctr);
  cudaError_t e;
  switch (mode) {
    case 0: e = launch_one_pass<0>(q, k, v, d, R, W, dq, C, dk, dv, g, B, s); break;
    case 1: e = launch_one_pass<1>(q, k, v, d, R, W, dq, C, dk, dv, g, B, s); break;
    case 2: e = launch_one_pass<2>(q, k, v, d, R, W, dq, C, dk, dv, g, B, s); break;
    default: e = launch_one_pass<3>(q, k, v, d, R, W, dq, C, dk, dv, g, B, s);
  }
  return static_cast<int>(e);
}

// The one-pass kernel's rows (opk::prep_kernel): o, lse and g_lse (or
// null) contiguous f32, do contiguous in dtype do_dtype (0 f32, 1 bf16),
// head dim 64; rows: (B, H, Lp, 2) f32, rows l < L written (the caller
// zeroes the rest); dq (or null): the one-pass launch's contiguous
// (B, L, H, 64) bf16 dq, whose q tiles that launch never writes (under
// this causal, window and q_offset) get their zeros here.
int lmr_flash_bwd_prep(const void* o, const void* d, const void* lse,
                       const void* g_lse, void* rows, void* dq, int B, int L,
                       int H, int Lp, int causal, int window, int q_offset,
                       int do_dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Lp < L || o == nullptr ||
      d == nullptr || lse == nullptr || rows == nullptr ||
      !aligned16(o) || !aligned16(d) || (dq != nullptr && !aligned16(dq)) ||
      (do_dtype != DT_F32 && do_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const long long n = (long long)B * L * H;
  const long long blocks = (n * 8 + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = make_geom(L, H, H, opk::D, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                           0, causal, window, q_offset);
  const float* O = static_cast<const float*>(o);
  const float* LSE = static_cast<const float*>(lse);
  const float* GL = static_cast<const float*>(g_lse);
  float2* R = static_cast<float2*>(rows);
  bf16* DQ = static_cast<bf16*>(dq);
  if (do_dtype == DT_F32)
    opk::prep_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(
        O, static_cast<const float*>(d), LSE, GL, R, DQ, g, Lp, n);
  else
    opk::prep_kernel<bf16><<<(unsigned)blocks, 256, 0, s>>>(
        O, static_cast<const bf16*>(d), LSE, GL, R, DQ, g, Lp, n);
  return static_cast<int>(cudaGetLastError());
}

// The one-pass kernel's schedule for these shapes on the current card:
// out[0] the grid, out[1] the batch·kv heads of a chunk, out[2] the key
// tiles a batch·kv head (mirrored by ops/attention.py::flash_bwd_plan).
int lmr_flash_bwd_plan(int B, int L, int H, int Hkv, int* out) {
  if (B <= 0 || L <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      out == nullptr)
    return cudaErrorInvalidValue;
  Geom g{L, H, Hkv, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.f};
  opk::Walk w;
  const int grid = opk::make_walk(w, g, B * Hkv);
  if (grid <= 0) return cudaErrorInvalidValue;
  out[0] = grid;
  out[1] = w.chunk;
  out[2] = w.nk;
  return cudaSuccess;
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
