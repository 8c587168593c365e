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
// 4·B·H·d·L(L+1)/2 = 129 GFLOP against 2·4·B·L·H·d = 65 MB of q/k/v/out
// — far above the ~295 operations per byte where bf16 products stop
// being limited by the 3.35 TB/s of device memory.
//
// Three kernels; which one runs is a predicate on the operands' layout
// alone (lmr_flash_path):
//  * bf16 operands TMA can describe (16-byte aligned bases, every stride
//    of a dimension longer than one a multiple of 8 elements — the
//    contiguous tensors and the model's fused-qkv views) take the
//    warp-specialised kernel (wsk): a 128-row q tile per block, three
//    warpgroups. One producer thread loads Q once and streams K and V
//    tiles of 128 keys through a ring of shared-memory stages with TMA
//    (full/empty mbarriers, as gemm_sm90.cuh's mainloop), the tensor maps
//    describing the public (B, L, H, D) layout as it lies: 4-D {D, H, L,
//    B}, boxes of {64, 1, 128, 1} with the 128-byte swizzle (D = 128 is
//    two boxes), the kv head picked by its coordinate (GQA), rows past L
//    zero-filled. Two consumer warpgroups own 64 q rows each: S = Q·Kᵀ
//    is one wgmma m64n128k16 chain from shared memory (K stored (keys, D)
//    is K-major); the online softmax stays in f32 registers with exp2
//    and scale·log2(e) folded into one FMA; P is rounded to bf16 in
//    registers after its row sums were taken in f32 (the TPU kernel's
//    rounding point) and is wgmma's A operand from registers, V (keys,
//    D) an N-major B operand through the descriptor. The column test
//    runs only on tiles that cross the causal diagonal, the window edge
//    or L (TMA's zero rows past L would otherwise score 0). The two
//    consumers take turns at the tensor cores (two named barriers): one
//    issues P·V of its tile and S of its next tile while the other runs
//    its softmax, the exp2 work (at d = 64 the SFU's exp2 rate is about
//    the tensor cores' rate for the same tile) hidden behind the other's
//    products. Under causal masking the heaviest q tiles start first
//    (the tile index is reversed, batch·head is the fast grid axis), so
//    no heavy tile is left for the tail. setmaxnreg hands the producer's
//    registers to the consumers.
//  * Other bf16 layouts take the general kernel (bfk): 4 warps, a 64-row
//    q tile, mma.sync m16n8k16 bf16 products with f32 accumulators and
//    the same rounding points, K/V tiles read with 16-byte loads where
//    aligned, else element by element.
//  * f32 inputs take full-precision FP32 FMAs (f32k; no TF32), 4 threads
//    per query row, each owning a quarter of the head dim.
// In all three: no transposed (B·H, L, D) copy and no padding; dead kv
// tiles (above the causal diagonal, behind the window) are never loaded
// — the loops run over _tile_live / _kv_clamp's live range only; q head
// h reads kv head h / (H / H_kv); a row with no visible key ends with
// l = max(l, 1e-30) and writes 0 (its lse below -1e29).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

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

// ------------------------------------------- bf16, TMA + wgmma (Hopper)

namespace wsk {
constexpr int BQ = 128, BK = 128, NT = 384;
constexpr int BOX = 128 * 128;     // one {64 d, 128 rows} box: 16 KB
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// Shared memory: the q tile, then STAGES stages of {K tile, V tile},
// each tile D / 64 boxes; 1 KB of slack to align the swizzle atoms, all
// within the 227 KB a block may have (less 256 bytes for the barriers).
// A stage is held from its S until its P·V retires, one tile later, so
// D = 128 takes a third stage to keep a load in flight.
template <int D>
struct Layout {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int FIT = (232448 - 1024 - 256 - Q_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int DYN = Q_BYTES + STAGES * STAGE + 1024;
};

// Does the warpgroup's 64-row slab [row0, row0 + 64) (offset rows) need
// the column test on the kv tile at k0: does the tile cross L, the
// causal diagonal or the window's edge?
__device__ __forceinline__ bool edge_tile(const Geom& g, int row0, int k0) {
  return k0 + BK > g.L || (g.causal && k0 + BK - 1 > row0) ||
         (g.window && row0 + 63 - k0 >= g.window);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, void* __restrict__ O,
                   float* __restrict__ LSEo, Geom g) {
  using Lay = Layout<D>;
  constexpr int S = Lay::STAGES, DC = D / 64, NO = D / 2;
  extern __shared__ uint8_t smem_raw[];
  // qbar: the q tile has landed; full: a stage's K and V have landed;
  // empty: both consumers are done with a stage
  __shared__ __align__(8) uint64_t qbar, full[S], empty[S];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, skv = base + Lay::Q_BYTES;
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int hk = h / (g.H / g.Hkv);
  // causal: the heaviest q tiles (largest index) start first
  const int qt = g.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  int lo, hi;
  live_range(g, q0 + g.q_offset, BQ, BK, lo, hi);
  const int n = hi >= lo ? hi - lo + 1 : 0;   // kv tiles hi, hi-1, ..., lo
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
      sm90::mbar_expect_tx(qb, Lay::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        sm90::tma_load_4d(sq + c * BOX, &tq, qb, 64 * c, h, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % S, k0 = (hi - i) * BK;
        sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((i / S) & 1) ^ 1);
        const uint32_t fb = sm90::smem_u32(&full[s]);
        sm90::mbar_expect_tx(fb, Lay::STAGE);
        const uint32_t sk = skv + s * Lay::STAGE, sv = sk + Lay::KV_BYTES;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          sm90::tma_load_4d(sk + c * BOX, &tk, fb, 64 * c, hk, k0, b);
          sm90::tma_load_4d(sv + c * BOX, &tv, fb, 64 * c, hk, k0, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w4 = t / 32, lane = t % 32;
  const float c = g.scale * LOG2E;            // scores to the log2 domain
  // accumulator fragment: register 4j + 2r + {0,1} of warp w4, lane l
  // holds row 16·w4 + l/4 + 8r, columns 8j + 2(l%4) + {0,1}
  const int slab = q0 + g.q_offset + wg * 64;   // first offset row
  const int row_a = slab + w4 * 16 + lane / 4, row_b = row_a + 8;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m2[2] = {NEG_BIG, NEG_BIG};   // running max, log2 domain
  float l[2] = {0.f, 0.f};            // this thread's share of the sums
  float sc[64];                       // the scores of the current tile
  uint32_t pa[BK / 16][4];            // its P, the A operand of P·V

  // S = Q·Kᵀ of the tile in stage s into sc (issued, not waited for)
  auto issue_s = [&](int s) {
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = 0.f;
    sm90::wgmma_fence();
    const uint32_t sk = skv + s * Lay::STAGE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // K-major, 16 d = 32 bytes along a swizzled row; the next 64 d in
      // the next box; SBO: the next 8 rows (1 KB)
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      sm90::wgmma_128<0, 0>(sc, sm90::desc_sw128(sq + wg * 8192 + off, 16, 1024),
                            sm90::desc_sw128(sk + off, 16, 1024));
    }
    sm90::wgmma_commit();
  };

  // the softmax of tile i in place in sc (P, unrounded), this thread's
  // row sums added to l, the rescale of the running rows in alpha
  auto softmax = [&](int i, float (&alpha)[2]) {
    const int k0 = (hi - i) * BK;
    if (edge_tile(g, slab, k0)) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * (lane % 4) + (e & 1);
          if (!visible(g, e < 2 ? row_a : row_b, col)) sc[4 * j + e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 64; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m2[r], mx[r] * c);
      alpha[r] = exp2f(m2[r] - mn);
      m2[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int r = (j >> 1) & 1;
      const float p = exp2f(fmaf(sc[j], c, -m2[r]));
      sc[j] = p;
      rs[r] += p;
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
  };
  // O rescaled, and P rounded to bf16 into pa (the score fragment of 16
  // keys is the A fragment of the next product, registers 8kk..8kk+7)
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pa[kk][q] = sm90::pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
  };
  // O += P·V of tile i (issued, not waited for)
  auto issue_pv = [&](int i) {
    sm90::wgmma_fence();
    const uint32_t sv = skv + (i % S) * Lay::STAGE + Lay::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // N-major V: 16 keys = two 8-row swizzle atoms (2 KB); LBO: the
      // next 64 d (the next box); SBO: the next 8 keys (1 KB)
      const uint64_t db = sm90::desc_sw128(sv + kk * 2048, BOX, 1024);
      if constexpr (D == 64) sm90::wgmma_rs_64(o, pa[kk], db);
      else sm90::wgmma_rs_128(o, pa[kk], db);
    }
    sm90::wgmma_commit();
  };
  // The two warpgroups take turns at the tensor cores (named barriers 1
  // and 2, both warpgroups' 256 threads): one issues its products while
  // the other runs its softmax. Warpgroup 0 goes first.
  auto my_turn = [&] { sm90::named_sync(1 + wg, 256); };
  auto their_turn = [&] {
    asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
  };
  if (wg == 1) asm volatile("bar.arrive 1, 256;" ::: "memory");

  sm90::mbar_wait(sm90::smem_u32(&qbar), 0);
  if (n > 0) {
    sm90::mbar_wait(sm90::smem_u32(&full[0]), 0);
    my_turn();
    issue_s(0);
    their_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(sc);
  }
  // Tile i: its softmax, then in one turn P·V of tile i and S of tile
  // i + 1, both waited for; the stage of tile i is then free.
  for (int i = 0; i < n; ++i) {
    float alpha[2];
    softmax(i, alpha);
    rescale_and_pack(alpha);
    const bool more = i + 1 < n;
    if (more)
      sm90::mbar_wait(sm90::smem_u32(&full[(i + 1) % S]), ((i + 1) / S) & 1);
    my_turn();
    issue_pv(i);
    if (more) issue_s((i + 1) % S);
    their_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(o);
    sm90::fence_acc(sc);
    if (t == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[i % S]));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wg * 64 + w4 * 16 + lane / 4 + 8 * r;
    if (row >= g.L) continue;
    const float lf = fmaxf(l[r], 1e-30f), inv = 1.f / lf;
    const long long base_o = ((long long)(b * g.L + row) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = o[4 * j + 2 * r] * inv, x1 = o[4 * j + 2 * r + 1] * inv;
      const int d = j * 8 + 2 * (lane % 4);
      if (LSE)
        *reinterpret_cast<float2*>(static_cast<float*>(O) + base_o + d) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(O) + base_o + d) =
            sm90::pack_bf16(x0, x1);
    }
    if (LSE && lane % 4 == 0)
      LSEo[(long long)(b * g.L + row) * g.H + h] = (m2[r] + log2f(lf)) * LN2;
  }
}
}  // namespace wsk

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

using sm90::aligned16;
using sm90::make_map4;
using sm90::tma_layout;

enum { PATH_GENERAL = 0, PATH_TMA = 1, PATH_F32 = 2 };

static int flash_path(const void* q, const void* k, const void* v, int B,
                      int L, int H, int Hkv, int D, const Geom& g,
                      int dtype) {
  if (dtype == DT_F32) return PATH_F32;
  if ((D == 64 || D == 128) && tma_layout(q, B, L, H, g.sqb, g.sql, g.sqh) &&
      tma_layout(k, B, L, Hkv, g.skb, g.skl, g.skh) &&
      tma_layout(v, B, L, Hkv, g.svb, g.svl, g.svh))
    return PATH_TMA;
  return PATH_GENERAL;
}

template <int D, bool LSE>
static int launch_tma_lse(const CUtensorMap& tq, const CUtensorMap& tk,
                          const CUtensorMap& tv, void* o, float* lse,
                          const Geom& g, int BH, cudaStream_t s) {
  using Lay = wsk::Layout<D>;
  auto kern = wsk::flash_wgmma_kernel<D, LSE>;
  static bool attr = false;   // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::DYN);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  dim3 grid(BH, (g.L + wsk::BQ - 1) / wsk::BQ);
  kern<<<grid, wsk::NT, Lay::DYN, s>>>(tq, tk, tv, o, lse, g);
  return cudaSuccess;
}

// An operand that passed tma_layout but whose map does not encode is a
// launch error, never a switch to the general kernel.
template <int D>
static int launch_tma(const void* q, const void* k, const void* v, void* o,
                      float* lse, const Geom& g, int B, int BH, bool with_lse,
                      cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  if (!make_map4(&tq, q, B, g.L, g.H, D, g.sqb, g.sql, g.sqh, wsk::BQ) ||
      !make_map4(&tk, k, B, g.L, g.Hkv, D, g.skb, g.skl, g.skh, wsk::BK) ||
      !make_map4(&tv, v, B, g.L, g.Hkv, D, g.svb, g.svl, g.svh, wsk::BK))
    return cudaErrorInvalidValue;
  return with_lse ? launch_tma_lse<D, true>(tq, tk, tv, o, lse, g, BH, s)
                  : launch_tma_lse<D, false>(tq, tk, tv, o, lse, g, BH, s);
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

// Which kernel lmr_flash_fwd runs for these operands: 1 the TMA + wgmma
// kernel, 0 the general bf16 kernel, 2 the f32 kernel, -1 none (an
// unsupported dtype or head dim). Arguments as lmr_flash_fwd's.
int lmr_flash_path(const void* q, const void* k, const void* v, int B,
                   int L, int H, int Hkv, int D, long long sqb, long long sql,
                   long long sqh, long long skb, long long skl, long long skh,
                   long long svb, long long svl, long long svh, int dtype) {
  if ((dtype != DT_F32 && dtype != DT_BF16) || (D != 64 && D != 128))
    return -1;
  Geom g{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh, 0, 0, 0, 0.f};
  return flash_path(q, k, v, B, L, H, Hkv, D, g, dtype);
}

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
      (long long)B * H > 65535 || (with_lse && lse == nullptr) ||
      (D != 64 && D != 128) || (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  Geom g{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
         causal, window, q_offset, (float)(1.0 / sqrt((double)D))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* LSE = static_cast<float*>(lse);
  const int BH = B * H;
  const bool wl = with_lse != 0;
  int rc = cudaSuccess;
  switch (flash_path(q, k, v, B, L, H, Hkv, D, g, dtype)) {
    case PATH_TMA:
      rc = D == 64 ? launch_tma<64>(q, k, v, o, LSE, g, B, BH, wl, s)
                   : launch_tma<128>(q, k, v, o, LSE, g, B, BH, wl, s);
      break;
    case PATH_GENERAL:
      if (D == 64) launch_bf16<64>(q, k, v, o, LSE, g, BH, wl, s);
      else launch_bf16<128>(q, k, v, o, LSE, g, BH, wl, s);
      break;
    default:
      if (D == 64) launch_f32<64>(q, k, v, o, LSE, g, BH, wl, s);
      else launch_f32<128>(q, k, v, o, LSE, g, BH, wl, s);
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
