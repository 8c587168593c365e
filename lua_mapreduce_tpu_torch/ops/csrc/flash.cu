// Flash attention forward on Hopper (sm_90a): softmax(Q·Kᵀ/√d)·V with an
// online softmax, causal / sliding-window masks and grouped-query heads,
// optionally returning the per-row logsumexp.
//
// Replaces: lua_mapreduce_tpu/ops/attention.py::_flash_kernel_nolse and
// ::_flash_kernel (one kernel here, the lse output a template flag), both
// driven by _flash_pallas.
//
// What bounds it on the H100, at d = 64: two pipes about equally. At
// the serving prefill shape (B=4, L=3968, H=16, d=64, causal, bf16) the
// tensor cores need 4·B·H·d·L(L+1)/2 = 129 GFLOP, 0.130 ms at 989
// TFLOP/s (the 65 MB of q/k/v/out are far below the ~295 operations a
// byte where bf16 products stop being limited by device memory); the
// softmax needs one exponential a score, B·H·L(L+1)/2 = 5.0·10^8, and
// the SFU (MUFU) does 16 a clock an SM: 0.130 ms at 1.83 GHz. Beside
// each exponential the softmax issues a scale-and-subtract FMA, a max, a
// sum and half a bf16 pack, so with two consumer warps a sub-partition
// its instruction issue, not the MUFU rate, is what it waits on.
//
// Three kernels; which one runs is a predicate on the operands' layout
// alone (lmr_flash_path):
//  * bf16 operands TMA can describe (16-byte aligned bases, every stride
//    of a dimension longer than one a multiple of 8 elements — the
//    contiguous tensors and the model's fused-qkv views) take the
//    warp-specialised kernel (wsk), persistent: one block an SM, three
//    warpgroups, taking (batch·head, q tile of 128 rows) items one at a
//    time from a counter, heaviest first by live kv tiles within chunks
//    of batch·heads whose K and V fit in half the L2 (wsk::Walk). One
//    producer thread takes the items, loads each item's Q into one of
//    two buffers (the next item's while the consumers finish this one)
//    and streams K and V tiles (128 keys at d = 64, 64 at d = 128)
//    through a ring of shared-memory stages with TMA (full/empty
//    mbarriers; a stage is freed by each consumer warp's own arrival),
//    the tensor maps describing the public (B, L, H, D) layout as it
//    lies: 4-D {D, H, L, B}, boxes of 64 d with the 128-byte swizzle,
//    the kv head picked by its coordinate (GQA), rows past L zero-filled.
//    Two consumer warpgroups own 64 q rows each. For the tensor cores:
//    S = Q·Kᵀ is a wgmma chain from shared memory (K stored (keys, D)
//    is K-major), P·V takes P from registers as the A operand and V
//    (keys, D) as an N-major B operand; each warpgroup issues S of tile
//    i + 1 and P·V of tile i together and runs the softmax of tile i + 1
//    once its S retires, while its own P·V is still in flight, so that
//    the exponentials of one tile overlap the products of the one before
//    (the last P·V of an item leaves the loop so that every pass issues
//    both, which ptxas needs to keep the products in flight). For the
//    SFU: 2^x is the bare ex2.approx.ftz (exp2f adds an FSETP and two
//    FMULs a call), scale·log2(e) folded into the one FMA, the row max
//    and sum kept in four partials a row, O's rescale skipped when no
//    row's max moved, descriptors stepped by adding offsets. P is
//    rounded to bf16 in registers after its row sums were taken in f32
//    (the TPU kernel's rounding point). The column test runs only on
//    tiles that cross the causal diagonal, the window edge or L (TMA's
//    zero rows past L would otherwise score 0). O leaves through swizzled
//    shared memory and a TMA store, each item's while the next one runs.
//    Phase 2 of chip_smoke.py times the kernel beside its products alone,
//    its softmax alone and its loads alone (lmr_flash_fwd_forced's modes).
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

#include <algorithm>

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
__host__ __device__ __forceinline__ void live_range(const Geom& g, int row0,
                                                    int rows,
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
constexpr int BQ = 128, NT = 384;
constexpr int QBOX = BQ * 128;      // one {64 d, 128 rows} q box: 16 KB
constexpr int ORDER_MAX = 1024;     // q tiles the host orders for the walk
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// The kv tile: 128 keys at d = 64 (S in 64 registers a thread), 64 at
// d = 128, where O takes 64 registers and S, P and O must all be live
// while the next tile's softmax overlaps this tile's P·V.
template <int D>
__host__ __device__ constexpr int kv_tile() { return D == 64 ? 128 : 64; }

// The launch's walk over its nq · bh items, taken one at a time by the
// blocks from a counter in device memory (a block's producer takes the
// next item when it has a q buffer free), so that no block idles while
// another has items queued. The batch·heads go in chunks of `chunk`
// whose K and V fit in half the L2 (the blocks running at once then read
// each kv tile from device memory about once); within a chunk the q tile
// of rank r is qt[r], the host's order (heaviest first by live kv tiles,
// a later tile first among equals) when nq <= ORDER_MAX, else
// nq - 1 - r, and the chunk's batch·heads are the fast axis.
struct Walk {
  int nq, bh, chunk, sorted;
  uint16_t qt[ORDER_MAX];
};

// item it of the walk → its batch·head and q tile
__device__ __forceinline__ void walk_decode(const Walk& w, int it, int& bh,
                                            int& qt) {
  const int per = w.chunk * w.nq, ch = it / per, rem = it - ch * per;
  const int rest = w.bh - ch * w.chunk;
  const int cw = rest < w.chunk ? rest : w.chunk;
  const int rank = rem / cw;
  bh = ch * w.chunk + rem % cw;
  qt = w.sorted ? w.qt[rank] : w.nq - 1 - rank;
}

// Shared memory: two q buffers (the producer loads the next item's q
// tile while the consumers finish this one), O's staging for the TMA
// store, then STAGES stages of {K tile, V tile}, each tile D / 64 boxes
// of 128-byte rows; 1 KB of slack to align the swizzle atoms, all within
// the 227 KB a block may have (less 512 bytes for the barriers). A stage
// is held from its S until its P·V retires, which is after the next
// tile's S was issued: three stages keep a load in flight.
template <int D, bool LSE>
struct Layout {
  static constexpr int BK = kv_tile<D>();
  static constexpr int KBOX = BK * 128;
  static constexpr int QBUF = 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int O_BYTES = BQ * D * (LSE ? 4 : 2);
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int FIT =
      (232448 - 1024 - 512 - QBUF * Q_BYTES - O_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static constexpr int DYN = QBUF * Q_BYTES + O_BYTES + STAGES * STAGE + 1024;
  static_assert(STAGES >= 3, "a load in flight needs three stages");
};

// Does the warpgroup's 64-row slab [row0, row0 + 64) (offset rows) need
// the column test on the kv tile at k0: does the tile cross L, the
// causal diagonal or the window's edge?
template <int BK>
__device__ __forceinline__ bool edge_tile(const Geom& g, int row0, int k0) {
  return k0 + BK > g.L || (g.causal && k0 + BK - 1 > row0) ||
         (g.window && row0 + 63 - k0 >= g.window);
}

// 2^x on the MUFU pipe, without exp2f's range fix-up (an FSETP and two
// FMULs a call): subnormal results flush to 0, as below −126
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// MODE 0 is the kernel; 1 (products alone: P is S copied), 2 (the
// softmax alone: no product issued) and 3 (the loads alone: neither) are
// for phase 2's decomposition, times only. `next` counts the items taken
// (it starts at 0; the block that takes the last count sets it back to
// 0, so that the next launch on the stream finds it so).
template <int D, bool LSE, int MODE>
__global__ void __launch_bounds__(NT, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   float* __restrict__ LSEo, Geom g,
                   const __grid_constant__ Walk w, int* __restrict__ next) {
  using Lay = Layout<D, LSE>;
  constexpr int S = Lay::STAGES, QB = Lay::QBUF, BK = Lay::BK;
  constexpr int DC = D / 64, NO = D / 2, NS = BK / 2, KK = BK / 16;
  constexpr int ES = LSE ? 4 : 2;              // bytes of an O element
  extern __shared__ uint8_t smem_raw[];
  // qfull / qempty: a q buffer has landed / all 8 consumer warps are
  // done with it; full / empty: the same for a kv stage
  __shared__ __align__(8) uint64_t qfull[QB], qempty[QB], full[S], empty[S];
  // the item each q buffer holds, written by the producer before the
  // arrival on qfull that the consumers wait for
  __shared__ volatile int item[QB];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, so = sq + QB * Lay::Q_BYTES;
  const uint32_t skv = so + Lay::O_BYTES;
  const int items = w.nq * w.bh;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int q = 0; q < QB; ++q) {
      sm90::mbar_init(sm90::smem_u32(&qfull[q]), 1);
      sm90::mbar_init(sm90::smem_u32(&qempty[q]), 8);
    }
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
      sm90::mbar_init(sm90::smem_u32(&empty[s]), 8);
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
      int kt = 0;                                // kv tiles loaded so far
      for (int r = 0;; ++r) {
        const int qb = r % QB;
        sm90::mbar_wait(sm90::smem_u32(&qempty[qb]), ((r / QB) & 1) ^ 1);
        const int it = atomicAdd(next, 1);
        item[qb] = it;
        const uint32_t qbar = sm90::smem_u32(&qfull[qb]);
        if (it >= items) {                       // no more: tell the consumers
          // each block counts once past the items: the last count is
          // items + grid − 1, after which no block reads the counter
          if (it == items + (int)gridDim.x - 1) atomicExch(next, 0);
          sm90::mbar_arrive(qbar);
          break;
        }
        int bh, qt;
        walk_decode(w, it, bh, qt);
        const int b = bh / g.H, h = bh % g.H, hk = h / (g.H / g.Hkv);
        const int q0 = qt * BQ;
        int lo, hi;
        live_range(g, q0 + g.q_offset, BQ, BK, lo, hi);
        const int n = hi >= lo ? hi - lo + 1 : 0;   // kv tiles hi, ..., lo
        sm90::mbar_expect_tx(qbar, Lay::Q_BYTES);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          sm90::tma_load_4d(sq + qb * Lay::Q_BYTES + c * QBOX, &tq, qbar,
                            64 * c, h, q0, b);
        for (int i = 0; i < n; ++i, ++kt) {
          const int s = kt % S, k0 = (hi - i) * BK;
          sm90::mbar_wait(sm90::smem_u32(&empty[s]), ((kt / S) & 1) ^ 1);
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
    }
    return;
  }

  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w4 = t / 32, lane = t % 32;
  const float c = g.scale * LOG2E;            // scores to the log2 domain
  // accumulator fragment: register 4j + 2r + {0,1} of warp w4, lane l
  // holds row 16·w4 + l/4 + 8r, columns 8j + 2(l%4) + {0,1}
  float o[NO];
  float sc[NS];                 // the scores of the tile in hand
  uint32_t pa[KK][4];           // P of the tile before it, P·V's A operand
  constexpr bool PRODUCTS = MODE == 0 || MODE == 1;
  constexpr bool SOFTMAX = MODE == 0 || MODE == 2;
  if (!PRODUCTS) {
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j] = 0.f;
  }
  // the descriptors of stage 0's K tile (K-major) and V tile (N-major)
  const uint64_t dk0 = sm90::desc_sw128(skv, 16, 1024);
  const uint64_t dv0 = sm90::desc_sw128(skv + Lay::KV_BYTES, Lay::KBOX, 1024);

  // An item in hand: its q buffer, coordinates, live kv tiles hi, ...,
  // hi − n + 1, this warpgroup's first offset row, its q descriptor and
  // its rows' running max (log2 domain) and sums.
  struct Item {
    int qb, b, h, q0, hi, n, slab;
    uint64_t dq;
    float m2[2], l[2];
  };
  // the r-th item this block takes, once the producer has handed it
  // over; false when the walk is done
  auto fetch = [&](int r, Item& x) {
    x.qb = r % QB;
    sm90::mbar_wait(sm90::smem_u32(&qfull[x.qb]), (r / QB) & 1);
    const int it = item[x.qb];
    if (it >= items) return false;
    int bh, qt, lo;
    walk_decode(w, it, bh, qt);
    x.b = bh / g.H;
    x.h = bh % g.H;
    x.q0 = qt * BQ;
    live_range(g, x.q0 + g.q_offset, BQ, BK, lo, x.hi);
    x.n = x.hi >= lo ? x.hi - lo + 1 : 0;
    x.slab = x.q0 + g.q_offset + wg * 64;
    // Shared-memory descriptors are built once, then stepped by adding a
    // byte offset / 16 to their start-address field (every address is
    // under 256 KB, so the 14-bit field never carries).
    x.dq = sm90::desc_sw128(sq + x.qb * Lay::Q_BYTES + wg * 8192, 16, 1024);
    x.m2[0] = x.m2[1] = NEG_BIG;
    x.l[0] = x.l[1] = 0.f;
    return true;
  };
  // S = Q·Kᵀ of item x's tile in stage s into sc (issued, not waited for)
  auto issue_s = [&](const Item& x, int s) {
    if (!PRODUCTS) return;
    sm90::wgmma_fence();
    const uint64_t dk = dk0 + (uint32_t)(s * (Lay::STAGE / 16));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // K-major, 16 d = 32 bytes along a swizzled row; the next 64 d in
      // the next box; SBO: the next 8 rows (1 KB); the first k step
      // overwrites sc
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = x.dq + ((kk / 4) * QBOX + off) / 16;
      const uint64_t db = dk + ((kk / 4) * Lay::KBOX + off) / 16;
      if constexpr (BK == 128) sm90::wgmma_128<0, 0>(sc, da, db, kk > 0);
      else sm90::wgmma_64<0, 0>(sc, da, db, kk > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P·V of the tile in stage s (issued, not waited for)
  auto issue_pv = [&](int s) {
    if (!PRODUCTS) return;
    sm90::wgmma_fence();
    const uint64_t dv = dv0 + (uint32_t)(s * (Lay::STAGE / 16));
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      // N-major V: 16 keys = two 8-row swizzle atoms (2 KB); LBO: the
      // next 64 d (the next box); SBO: the next 8 keys (1 KB)
      const uint64_t db = dv + kk * (2048 / 16);
      if constexpr (D == 64) sm90::wgmma_rs_64(o, pa[kk], db);
      else sm90::wgmma_rs_128(o, pa[kk], db);
    }
    sm90::wgmma_commit();
  };
  // the softmax of item x's tile i in place in sc (P, unrounded, f32),
  // this thread's row sums added to x.l, the rescale of the running rows
  // in alpha; touches neither o nor pa (a P·V may be in flight)
  auto softmax = [&](Item& x, int i, float (&alpha)[2]) {
    if (!SOFTMAX) return;
    const int k0 = (x.hi - i) * BK;
    if (edge_tile<BK>(g, x.slab, k0)) {
      const int row_a = x.slab + w4 * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * (lane % 4) + (e & 1);
          if (!visible(g, row_a + (e < 2 ? 0 : 8), col)) sc[4 * j + e] = -INFINITY;
        }
    }
    // the row max and row sum each in four independent partials a row
    // (register 4jj + 2q + e holds row q: partial jj % 4), so that no
    // chain of dependent instructions is longer than NS / 8
    float mx[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) mx[q][u] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mx[(j >> 1) & 1][(j >> 2) & 3] = fmaxf(mx[(j >> 1) & 1][(j >> 2) & 3], sc[j]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float m = fmaxf(fmaxf(mx[q][0], mx[q][1]), fmaxf(mx[q][2], mx[q][3]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float mn = fmaxf(x.m2[q], m * c);
      alpha[q] = exp2_mufu(x.m2[q] - mn);
      x.m2[q] = mn;
    }
    float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int q = (j >> 1) & 1;
      const float p = exp2_mufu(fmaf(sc[j], c, -x.m2[q]));
      sc[j] = p;
      rs[q][(j >> 2) & 3] += p;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
      x.l[q] = x.l[q] * alpha[q] + ((rs[q][0] + rs[q][1]) + (rs[q][2] + rs[q][3]));
  };
  // P rounded to bf16 into pa (the score fragment of 16 keys is the A
  // fragment of the next product, registers 8kk..8kk+7)
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pa[kk][q] = sm90::pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
  };
  // O / l of item x out, and its lse
  auto epilogue = [&](Item& x) {
    float lf[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      x.l[q] += __shfl_xor_sync(0xffffffffu, x.l[q], 1);
      x.l[q] += __shfl_xor_sync(0xffffffffu, x.l[q], 2);
      lf[q] = fmaxf(x.l[q], 1e-30f);
    }
    // 1 / l by MUFU.RCP alone (l in [1e-30, L]: no subnormal, and no
    // call to the IEEE division's slow path)
    float inv[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv[q]) : "f"(lf[q]));
    // this warpgroup's 64 rows as boxes of {128 bytes of D, 64 rows},
    // 128-byte swizzled (8 KB each), then one TMA store a box; rows
    // past L are not written
    const uint32_t ob = so + wg * (64 * D * ES);
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    sm90::named_sync(3 + wg, 128);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = w4 * 16 + lane / 4 + 8 * q;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float x0 = o[4 * j + 2 * q] * inv[q], x1 = o[4 * j + 2 * q + 1] * inv[q];
        const int byte = (8 * j + 2 * (lane % 4)) * ES;
        const uint32_t at = ob + (byte / 128) * 8192 + row * 128 +
                            ((((byte % 128) / 16) ^ (row % 8)) * 16) + byte % 16;
        if (LSE)
          asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(at), "f"(x0),
                       "f"(x1) : "memory");
        else
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(at),
                       "r"(sm90::pack_bf16(x0, x1)) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    sm90::named_sync(3 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int z = 0; z < D * ES / 128; ++z)
        sm90::tma_store_4d(&to, ob + z * 8192, z * (128 / ES), x.h,
                           x.q0 + wg * 64, x.b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (LSE && lane % 4 == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = x.q0 + wg * 64 + w4 * 16 + lane / 4 + 8 * q;
        if (row < g.L)
          LSEo[(long long)(x.b * g.L + row) * g.H + x.h] =
              (x.m2[q] + log2f(lf[q])) * LN2;
      }
    }
  };

  int kt = 0;                                  // kv tiles consumed so far
  for (int r = 0;; ++r) {
    Item cur;
    if (!fetch(r, cur)) break;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = 0.f;
    if (cur.n > 0) {
      sm90::mbar_wait(sm90::smem_u32(&full[kt % S]), (kt / S) & 1);
      issue_s(cur, kt % S);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sc);
      float alpha[2];
      softmax(cur, 0, alpha);
      pack();
    }
    // Tile i < n − 1: S of tile i + 1 and P·V of tile i issued
    // together; the softmax of tile i + 1 runs once its S retires, while P·V
    // of tile i is still in flight; then O is rescaled and P of tile
    // i + 1 packed. Every pass issues both (the last P·V comes after the
    // loop), so that ptxas can see which group each wait retires and
    // keeps the products in flight.
    for (int i = 0; i + 1 < cur.n; ++i) {
      const int s = (kt + i) % S, s1 = (kt + i + 1) % S;
      sm90::mbar_wait(sm90::smem_u32(&full[s1]), ((kt + i + 1) / S) & 1);
      issue_s(cur, s1);
      issue_pv(s);
      float alpha[2] = {1.f, 1.f};
      sm90::wgmma_wait<1>();
      sm90::fence_acc(sc);
      softmax(cur, i + 1, alpha);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(o);
      sm90::fence_frag(pa);
      // each warp frees the stage once its own products have retired
      if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
      // O rescaled unless no row of the warp has a new max (alpha 1: the
      // product would change nothing)
      if (SOFTMAX &&
          __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < NO; ++j) o[j] *= alpha[(j >> 1) & 1];
      }
      pack();
    }
    if (cur.n > 0) {
      const int s = (kt + cur.n - 1) % S;
      issue_pv(s);
      sm90::wgmma_wait<0>();
      sm90::fence_acc(o);
      if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&empty[s]));
    }
    kt += cur.n;
    if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(&qempty[cur.qb]));
    epilogue(cur);
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The walk: batch·heads in chunks whose K and V fit in half the L2; the
// q tile order heaviest first by live kv tiles (live_range, _tile_live's
// algebra), a later tile first among equals, descending tiles when there
// are more than ORDER_MAX. The grid: one block an SM, at most one a
// (batch·head, q tile) item.
template <int D>
static int make_walk(Walk& w, const Geom& g, int BH) {
  constexpr int BK = kv_tile<D>();
  w.nq = (g.L + BQ - 1) / BQ;
  w.bh = BH;
  // a q head's share of its kv head's K and V (bf16)
  const long long kv = (long long)g.L * D * 4 / (g.H / g.Hkv);
  const long long half_l2 = sm90::l2_bytes() / 2;
  const long long fit = kv > 0 ? half_l2 / kv : BH;
  w.chunk = static_cast<int>(fit < 1 ? 1 : fit > BH ? BH : fit);
  w.sorted = w.nq <= ORDER_MAX;
  if (w.sorted) {
    int live[ORDER_MAX];
    for (int q = 0; q < w.nq; ++q) {
      int lo, hi;
      live_range(g, q * BQ + g.q_offset, BQ, BK, lo, hi);
      live[q] = hi >= lo ? hi - lo + 1 : 0;
      w.qt[q] = static_cast<uint16_t>(q);
    }
    std::sort(w.qt, w.qt + w.nq, [&](uint16_t a, uint16_t b) {
      return live[a] != live[b] ? live[a] > live[b] : a > b;
    });
  }
  const int sms = sm90::sm_count();
  if (sms <= 0) return 0;
  const long long items = (long long)w.nq * BH;
  return static_cast<int>(items < sms ? items : sms);
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

// One launch of the TMA kernel: the persistent grid of make_walk, its
// walk a kernel argument, `next` an int of device memory that holds 0
// (the kernel leaves it so). An operand that passed tma_layout but whose
// map does not encode is a launch error, never a switch to the general
// kernel.
template <int D, bool LSE, int MODE>
static int launch_wsk(const void* q, const void* k, const void* v, void* o,
                      float* lse, int* next, const Geom& g, int B,
                      cudaStream_t s) {
  using Lay = wsk::Layout<D, LSE>;
  CUtensorMap tq, tk, tv, to;
  const int L = g.L, H = g.H, Hkv = g.Hkv;
  if (!make_map4(&tq, q, B, L, H, D, g.sqb, g.sql, g.sqh, wsk::BQ) ||
      !make_map4(&tk, k, B, L, Hkv, D, g.skb, g.skl, g.skh, Lay::BK) ||
      !make_map4(&tv, v, B, L, Hkv, D, g.svb, g.svl, g.svh, Lay::BK) ||
      !aligned16(o) ||
      !sm90::make_map4_of(&to, o, LSE, B, L, H, D, (long long)L * H * D,
                          (long long)H * D, D, 64))
    return cudaErrorInvalidValue;
  wsk::Walk w;
  const int grid = wsk::make_walk<D>(w, g, B * H);
  if (grid <= 0 || next == nullptr) return cudaErrorInvalidValue;
  auto kern = wsk::flash_wgmma_kernel<D, LSE, MODE>;
  static bool attr = false;   // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::DYN);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  kern<<<grid, wsk::NT, Lay::DYN, s>>>(tq, tk, tv, to, lse, g, w, next);
  return cudaSuccess;
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
// with_lse else the input dtype; lse: contiguous (B, L, H) f32 or null;
// next: one int of device memory that holds 0, which the TMA kernel's
// walk counts its items in and leaves at 0 (so one int serves every
// launch on a stream; the other kernels ignore it). Returns cudaGetLastError() after the launch (0 = launched).
int lmr_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, void* next, int B, int L, int H, int Hkv, int D,
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
  int* nx = static_cast<int*>(next);
  const int BH = B * H;
  const bool wl = with_lse != 0;
  int rc = cudaSuccess;
  switch (flash_path(q, k, v, B, L, H, Hkv, D, g, dtype)) {
    case PATH_TMA:
      if (D == 64)
        rc = wl ? launch_wsk<64, true, 0>(q, k, v, o, LSE, nx, g, B, s)
                : launch_wsk<64, false, 0>(q, k, v, o, LSE, nx, g, B, s);
      else
        rc = wl ? launch_wsk<128, true, 0>(q, k, v, o, LSE, nx, g, B, s)
                : launch_wsk<128, false, 0>(q, k, v, o, LSE, nx, g, B, s);
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

// The TMA kernel at D = 64, no lse, in decomposition mode `mode` (0 the
// kernel, 1 products alone, 2 the softmax alone, 3 the loads alone):
// phase 2's times. Operands as lmr_flash_fwd's; a layout TMA cannot
// describe is refused.
int lmr_flash_fwd_forced(const void* q, const void* k, const void* v,
                         void* o, void* next, int B, int L, int H, int Hkv,
                         int D,
                         long long sqb, long long sql, long long sqh,
                         long long skb, long long skl, long long skh,
                         long long svb, long long svl, long long svh,
                         int causal, int window, int q_offset, int mode,
                         void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (long long)B * H > 65535 || D != 64 || mode < 0 || mode > 3)
    return cudaErrorInvalidValue;
  Geom g{L, H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
         causal, window, q_offset, (float)(1.0 / sqrt((double)D))};
  if (flash_path(q, k, v, B, L, H, Hkv, D, g, DT_BF16) != PATH_TMA)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* nx = static_cast<int*>(next);
  int rc;
  switch (mode) {
    case 0: rc = launch_wsk<64, false, 0>(q, k, v, o, nullptr, nx, g, B, s); break;
    case 1: rc = launch_wsk<64, false, 1>(q, k, v, o, nullptr, nx, g, B, s); break;
    case 2: rc = launch_wsk<64, false, 2>(q, k, v, o, nullptr, nx, g, B, s); break;
    default: rc = launch_wsk<64, false, 3>(q, k, v, o, nullptr, nx, g, B, s);
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The TMA kernel's schedule for these shapes on the current card (the
// grid, make_walk's walk), mirrored by ops/attention.py::flash_plan:
// out[0] the grid, out[1] the batch·heads of a chunk, out[2] whether the
// order was sorted, out[3 + r] the q tile of rank r for r < min(nq, cap).
int lmr_flash_plan(int B, int L, int H, int Hkv, int D, int causal,
                   int window, int q_offset, int* out, int cap) {
  if (B <= 0 || L <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (D != 64 && D != 128) || out == nullptr)
    return cudaErrorInvalidValue;
  Geom g{L, H, Hkv, 0, 0, 0, 0, 0, 0, 0, 0, 0, causal, window, q_offset, 0.f};
  wsk::Walk w;
  const int grid = D == 64 ? wsk::make_walk<64>(w, g, B * H)
                           : wsk::make_walk<128>(w, g, B * H);
  if (grid <= 0) return cudaErrorInvalidValue;
  out[0] = grid;
  out[1] = w.chunk;
  out[2] = w.sorted;
  for (int r = 0; r < w.nq && r < cap; ++r)
    out[3 + r] = w.sorted ? w.qt[r] : w.nq - 1 - r;
  return cudaSuccess;
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
