// Weight-only int8 matmul on Hopper (sm_90a): out = (bf16(x) · W_q8) · s,
// x (M, K) f32 or bf16, W (K, N) int8, s (N,) f32 per output channel,
// f32 accumulation, the scale applied once to the accumulator, out in
// x's dtype.
//
// Replaces: lua_mapreduce_tpu/ops/q8.py::_q8_kernel, driven by
// _q8_matmul_pallas.
//
// What bounds it on the H100, at the serving shapes:
//  * decode, M = 4: the weight bytes. A (1024, 32768) head is 32 MB of
//    int8 for 2·4·1024·32768 = 268 MFLOP — 8 operations per byte. The
//    tensor cores would idle; a 128-row tile would waste 124 of its rows.
//  * prefill, M = 15872: the tensor-core rate (2·M·K·N = 99.8 GFLOP for
//    the (1024, 3072) qkv weight against 45 MB moved).
//
// So there are two kernels behind one entry point, chosen by M:
//  * M <= 8, gemv_kernel: one launch a call. A CTA owns a strip of 32,
//    64 or 128 output columns and one K-slice; each of its 256 threads
//    takes 16 int8 columns (one 16-byte cp.async) of every
//    (256·16/cols)-th k row of the slice, 8 rows in flight through its
//    own slots of a shared-memory ring. gemv_plan picks the strip width
//    and the K split: a thread block cluster of up to 8 CTAs along K
//    lands within one GPC (clusters of 8 reach 120 of the H100's 132
//    SMs), so the plan counts the SMs a cluster of each size can use and
//    keeps the busiest SM's work least; at the 1-4 MB projections a
//    call is latency-bound and the best grids hold 64-128 CTAs, one an
//    SM. A split cluster sums through distributed shared memory: each
//    CTA writes its sums of a column share into that share's owner, one
//    cluster barrier, and the owner adds them in rank order, scales and
//    stores, so there is no second kernel and no scratch, and the sum
//    order is fixed. x is rounded to bf16 once per CTA (as the TPU
//    kernel casts x before the dot) into shared memory, k-major, and
//    read as a broadcast. int8 is widened on the full-rate pipes (a
//    byte permute under the exponent of 2^23, one FADD; no I2F), then
//    M FMAs a weight byte. A warp's K-lanes reduce by halving exchanges
//    (each lane ends with its share of the sums), then the warps in
//    order. At M = 1 the head streams at the bytes bound; at M = 4 and
//    8 the FMA issue rate holds it (PERF.md).
//  * M > 8, the prefill: the pipelined wgmma mainloop of gemm_sm90.cuh,
//    shared with matmul.cu, persistent over 128 × 128 tiles. TMA brings
//    x (bf16) and the int8 weight tile; seven warps (three of the
//    producer warpgroup and a fourth warpgroup) widen each int8 tile to
//    bf16 (exact) in shared memory, in the swizzled layout wgmma reads,
//    beside the consumers' tensor-core
//    work, so device memory moves only the int8 weight bytes; the
//    epilogue multiplies each column by its scale once, casts, and hands
//    the tile to a TMA store. x in f32, K % 8 != 0, N % 16 != 0 or an
//    unaligned pointer (layouts TMA cannot read) take mma_kernel: a
//    128×128×32 shared-memory tiled GEMM on WMMA bf16 16×16×16 fragments, x
//    converted to bf16 and int8 widened as the tiles are written.
//  * Ragged edges are masked in the loads (or come back as zeros from
//    TMA) and at the stores; nothing is padded. Left for later work: an
//    int8 × int8 path with activation scales.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

#include "gemm_sm90.cuh"

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_bf16_f32(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float to_bf16_f32(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------------------------------------ M <= 8

// The GEMV's launch constants. tests/test_torch_kernel_plans.py reads
// them from here and holds ops/q8.py's mirror of the plan to them.
#define GEMV_NT 256
#define GEMV_MAX_M 8
#define GEMV_MAX_CLUSTER 8
#define GEMV_XCH 1024
#define GEMV_CTA_COST 4
#define GEMV_STAGES 8
#define GEMV_COLS(X) X(128) X(64) X(32)
// int8 → f32 on the full-rate pipes: flip the sign bit (the byte b
// becomes b + 128 as unsigned), move it under the exponent of 2^23 with
// one byte permute, subtract 2^23 + 128. Exact for every byte.
#define GEMV_SIGN_FLIP 0x80808080u
#define GEMV_MAGIC 0x4B000000u
#define GEMV_PERM 0x7440u

namespace gv {
namespace coop = cooperative_groups;

// a thread: one 16-byte weight load (16 columns) of one k row a step;
// STAGES rows of it in flight through its own slots of a shared-memory
// ring
constexpr int NT = GEMV_NT, NW = NT / 32, CPT = 16, S = GEMV_STAGES,
              XCH = GEMV_XCH, RING_BYTES = S * NT * 16;
constexpr float WIDEN_BIAS = 8388736.f;          // 2^23 + 128

// x's chunk (k-major, MT values a row, rounded to bf16) is dead once the
// k loop ends; the warps' partial sums reuse its bytes
template <int MT, int COLS>
struct Smem {
  union {
    float x[XCH * MT];
    float red[NW * MT * COLS];
  } u;
  float part[MT * COLS];          // the cluster's sums of owned columns
};

// `magic` is GEMV_MAGIC, passed in as a kernel argument: as a constant
// it would take the permute's one immediate slot and push the four
// selectors into registers, re-made every row at 128 registers a thread
__device__ __forceinline__ float widen(uint32_t flipped, int b,
                                       uint32_t magic) {
  return __uint_as_float(__byte_perm(flipped, magic, GEMV_PERM + b)) -
         WIDEN_BIAS;
}

// 16 int8 weights of row k from column col, byte by byte (N % 16 != 0
// or an unaligned W: the ring's 16-byte copies cannot read them); zeros
// past N
__device__ __forceinline__ int4 load16_bytes(const int8_t* __restrict__ W,
                                             long long k, int col, int N) {
  const int8_t* p = W + k * N + col;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (col + c < N)
      w[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[c]))
                  << (8 * (c % 4));
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                   static_cast<int>(w[2]), static_cast<int>(w[3]));
}

// a 16-byte cp.async into this thread's ring slot; zeros when !full
__device__ __forceinline__ void cp_async16(int4* slot, const void* src,
                                           bool full) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(slot));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x's row kk of the staged chunk: MT floats, read as a broadcast
template <int MT>
__device__ __forceinline__ void load_x(const float* xs, int kk,
                                       float (&xv)[MT]) {
  if constexpr (MT >= 4) {
#pragma unroll
    for (int m = 0; m < MT; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xs + kk * MT + m);
      xv[m] = v.x; xv[m + 1] = v.y; xv[m + 2] = v.z; xv[m + 3] = v.w;
    }
  } else if constexpr (MT == 2) {
    const float2 v = *reinterpret_cast<const float2*>(xs + kk * 2);
    xv[0] = v.x; xv[1] = v.y;
  } else {
    xv[0] = xs[kk];
  }
}

// one row of a K-lane into its ring slot: 16 bytes from src when
// `full`, else zeros (`any` is a valid address); one commit group a
// row, empty when the row is past the chunk's steps (!live)
__device__ __forceinline__ void issue_row(int4* slot, const int8_t* src,
                                          const int8_t* any, bool live,
                                          bool full) {
  if (live) cp_async16(slot, full ? src : any, full);
  cp_async_commit();
}

// acc[m·16 + c] += x[m][k] · w[k][col + c] for one k row: w its 16
// int8 weights, x read from the staged chunk (xs row kk = k − c0)
template <int MT>
__device__ __forceinline__ void fma_row(float (&acc)[MT * CPT],
                                        const int4& b, const float* xs,
                                        int kk, uint32_t magic) {
  float xv[MT];
  load_x<MT>(xs, kk, xv);
  const uint32_t words[4] = {
      static_cast<uint32_t>(b.x), static_cast<uint32_t>(b.y),
      static_cast<uint32_t>(b.z), static_cast<uint32_t>(b.w)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t f = words[q] ^ GEMV_SIGN_FLIP;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = widen(f, e, magic);
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m * CPT + q * 4 + e] = fmaf(xv[m], w, acc[m * CPT + q * 4 + e]);
    }
  }
}

// One step of the warp's K-lane reduction and the steps after it: the
// lane pairs O apart each keep one half of acc[0..2H) and sum in the
// partner's copy of it. Every index is a constant, so acc stays in
// registers.
template <int V, int H, int O>
__device__ __forceinline__ void halve(float (&acc)[V], int lane) {
  if constexpr (O < 32) {
    const bool up = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = acc[i], hi = acc[i + H];
      const float send = up ? lo : hi;
      acc[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, send, O);
    }
    halve<V, H / 2, O * 2>(acc, lane);
  }
}

// A CTA: COLS output columns (a strip) × one K-slice of kper rows (its
// rank in a cluster of gridDim.y CTAs along K). Its 256 threads are
// COLS/16 column groups × NT/(COLS/16) K-lanes; a K-lane takes every
// KSB-th row of the slice.
template <typename XT, typename OT, int MT, int COLS>
__global__ void __launch_bounds__(NT, MT <= 4 ? 2 : 1)
gemv_kernel(const XT* __restrict__ X, const int8_t* __restrict__ W,
            const float* __restrict__ Sc, OT* __restrict__ Out, int M,
            int K, int N, int kper, bool vec, uint32_t magic) {
  constexpr int CG = COLS / CPT, KSW = 32 / CG, KSB = NT / CG,
                V = MT * CPT, LOG_COLS = COLS == 128 ? 7 : COLS == 64 ? 6 : 5;
  static_assert(1 << LOG_COLS == COLS, "a strip is 32, 64 or 128 columns");
  static_assert(KSW >= 4 && KSW <= 16 && V >= KSW,
                "4-16 K-lanes a warp, each keeping at least one sum");
  extern __shared__ __align__(16) unsigned char dsm[];
  int4* ring = reinterpret_cast<int4*>(dsm);
  Smem<MT, COLS>& sm = *reinterpret_cast<Smem<MT, COLS>*>(dsm + RING_BYTES);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane % CG, sel = lane / CG, ks = warp * KSW + sel;
  const int n0 = blockIdx.x * COLS, col = n0 + grp * CPT;
  const int kbeg = blockIdx.y * kper;
  const int kend = K < kbeg + kper ? K : kbeg + kper;

  // a split cluster writes into its CTAs' shared memory only once all
  // of them run: each arrives here and waits before its first write
  const int split = gridDim.y;
  if (split > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int c0 = kbeg; c0 < kend; c0 += XCH) {
    const int c1 = kend < c0 + XCH ? kend : c0 + XCH;
    const int rows = (c1 - c0 + KSB - 1) / KSB;   // the same in the CTA
    // row r of this K-lane: k = k0 + r·KSB, its bytes at wp + r·step,
    // in flight through ring slot r % S
    const int k0 = c0 + ks;
    const int8_t* wp = W + (long long)k0 * N + col;
    const long long step = (long long)KSB * N;
    int4* slots = ring + tid;
    if (vec) {
      // the first S − 1 rows are in flight before x is staged
#pragma unroll
      for (int r = 0; r < S - 1; ++r)
        issue_row(slots + r * NT, wp + r * step, W, r < rows,
                  k0 + r * KSB < c1 && col < N);
    }
    __syncthreads();               // the last chunk's x is read
    // x rounded to bf16 once (as the TPU kernel casts x before the
    // dot), zeros past the slice and past M: every load is issued
    // before the first is used, so staging costs one trip to L2
    const int len = rows * KSB;
    float xr[MT][XCH / NT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < XCH / NT; ++j) {
        const int kk = tid + j * NT, k = c0 + kk;
        xr[m][j] = (m < M && k < c1) ? to_bf16_f32(X[(long long)m * K + k])
                                     : 0.f;
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < XCH / NT; ++j)
        if (tid + j * NT < len) sm.u.x[(tid + j * NT) * MT + m] = xr[m][j];
    __syncthreads();
    if (vec) {
      // each thread reads back only its own slots: its wait is the
      // only ordering the ring needs. A turn of the ring is unrolled, so
      // every slot is a constant offset.
      for (int r0 = 0; r0 < rows; r0 += S) {
        const int8_t* wr = wp + r0 * step;
#pragma unroll
        for (int u = 0; u < S; ++u) {
          if (r0 + u < rows) {
            const int ri = r0 + u + S - 1;         // the row to issue
            issue_row(slots + (u + S - 1) % S * NT, wr + (u + S - 1) * step,
                      W, ri < rows, k0 + ri * KSB < c1 && col < N);
            cp_async_wait<S - 1>();
            fma_row<MT>(acc, slots[u * NT], sm.u.x, ks + (r0 + u) * KSB,
                        magic);
          }
        }
      }
      cp_async_wait<0>();          // the ring is free for the next chunk
    } else {
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int k = c0 + ks + r * KSB;
        const int4 b = k < c1 ? load16_bytes(W, k, col, N)
                              : make_int4(0, 0, 0, 0);
        fma_row<MT>(acc, b, sm.u.x, ks + r * KSB, magic);
      }
    }
  }

  // the warp's KSW K-lanes (lane bits log2(CG)..4): each step halves
  // what a lane holds and sends the other half to its partner, so a lane
  // ends with V / KSW of the warp's sums, in a fixed order
  halve<V, V / 2, CG>(acc, lane);
  // lane bit j of sel kept the upper half at step j: its sums start at
  // (V / KSW) · bit-reverse(sel)
  constexpr int KEPT = V / KSW, LOG_KSW = KSW == 16 ? 4 : KSW == 8 ? 3 : 2;
  const int first = KEPT * static_cast<int>(__brev(sel) >> (32 - LOG_KSW));
  __syncthreads();                 // every warp is done with x
#pragma unroll
  for (int i = 0; i < KEPT; ++i) {
    const int v = first + i, m = v / CPT, c = v % CPT;
    sm.u.red[(warp * MT + m) * COLS + grp * CPT + c] = acc[i];
  }
  __syncthreads();
  // the 8 warps in order: the CTA's sum alone is the output when K is
  // not split
  if (split == 1) {
    for (int i = tid; i < M * COLS; i += NT) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) s += sm.u.red[w * MT * COLS + i];
      const int n = n0 + i % COLS;
      if (n < N) store_out(&Out[(long long)(i / COLS) * N + n], s * Sc[n]);
    }
    return;
  }
  // The cluster's K-slices. Rank r owns the strip's columns
  // [r·cw, (r+1)·cw): every CTA writes its sums of them into row `rank`
  // of the owner's `part` (distributed shared memory), then one cluster
  // barrier, then each owner adds its rows in rank order (the K order),
  // scales once and stores. Past that barrier a CTA reads only its own
  // shared memory, so none waits for the others to finish.
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lg = __ffs(split) - 1;             // split is a power of two
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int cw = COLS >> lg;
  for (int i = tid; i < M * COLS; i += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += sm.u.red[w * MT * COLS + i];
    const int m = i / COLS, c = i % COLS;
    float* owner = cluster.map_shared_rank(sm.part, c >> (LOG_COLS - lg));
    owner[(rank * MT + m) * cw + (c & (cw - 1))] = s;
  }
  cluster.sync();
  for (int j = tid; j < M * cw; j += NT) {
    const int m = j >> (LOG_COLS - lg), c = j & (cw - 1);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < GEMV_MAX_CLUSTER; ++q)
      if (q < split) s += sm.part[(q * MT + m) * cw + c];
    const int n = n0 + rank * cw + c;
    if (n < N) store_out(&Out[(long long)m * N + n], s * Sc[n]);
  }
}
}  // namespace gv

// ------------------------------------------------------------- M > 8

namespace mk {
using namespace nvcuda;
constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int LDA = BK + 8, LDB = BN + 8;
constexpr int WM = 64, WN = 32, FM = WM / 16, FN = WN / 16;

template <typename XT, typename OT>
__global__ void __launch_bounds__(NT)
mma_kernel(const XT* __restrict__ X, const int8_t* __restrict__ W,
           const float* __restrict__ Sc, OT* __restrict__ Out, int M, int K,
           int N, bool xvec, bool wvec) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[NT / 32][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 128 rows × 32 k, 8 elements per thread-step
    for (int i = threadIdx.x; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + c;
      bf16* dst = As + r * LDA + c;
      const XT* src = X + (long long)gr * K + gc;
      if (xvec && gr < M && gc < K) {      // K % 8 == 0: the 8 are in range
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = to_bf16(src[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gc + e < K) ? to_bf16(src[e])
                                          : __float2bfloat16(0.f);
      }
    }
    // weight tile: 32 k × 128 columns, 16 int8 per thread-step
    for (int i = threadIdx.x; i < BK * (BN / 16); i += NT) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const int gr = k0 + r, gc = n0 + c;
      bf16* dst = Bs + r * LDB + c;
      const int8_t* src = W + (long long)gr * N + gc;
      if (wvec && gr < K && gc < N) {      // N % 16 == 0, aligned
        const int4 v = *reinterpret_cast<const int4*>(src);
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) dst[j] = __float2bfloat16((float)e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = __float2bfloat16((gr < K && gc + j < N) ? (float)src[j]
                                                           : 0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * WM + i * 16, c0 = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gr = r0 + e / 16, gc = c0 + e % 16;
        if (gr < M && gc < N)
          store_out(&Out[(long long)gr * N + gc], cs[e] * Sc[gc]);
      }
      __syncwarp();
    }
}
}  // namespace mk

using sm90::aligned16;

// The GEMV's launch for an M <= 8 product: the strip width (one of
// GEMV_COLS) and the K split, a cluster of 1, 2, 4 or 8 CTAs along K no
// larger than K's KSB-row steps. A cluster's CTAs land on SMs of one
// GPC, so a cluster of s CTAs can use only `cluster_sms[log2 s]` of the
// card's SMs (the H100's 132 take clusters of 8 on 120), and a grid with
// more CTAs than that puts two on some SM, which then takes twice as
// long. The plan minimises the busiest SM's work:
//   ceil(CTAs / cluster_sms) · (k steps a thread + GEMV_CTA_COST · x
//   chunks),
// GEMV_CTA_COST being a CTA's fixed cost (staging x, the reductions)
// counted in k steps; ties go to the wider strip, then the smaller
// split. kper is the rows of K a CTA takes (the last rank may take
// fewer). ops/q8.py::gemv_plan is its mirror, held to it on the CPU
// and on the card.
struct GemvPlan {
  int cols, split, kper, strips;
};

static GemvPlan gemv_plan(int K, int N, const int* cluster_sms) {
  GemvPlan best = {0, 0, 0, 0};
  long long best_cost = 0;
#define LMR_PLAN(c)                                                        \
  {                                                                        \
    const int strips = (N + c - 1) / c, ksb = gv::NT * gv::CPT / c;        \
    const int steps = (K + ksb - 1) / ksb;                                 \
    for (int lg = 0, split = 1; split <= GEMV_MAX_CLUSTER;                 \
         ++lg, split *= 2) {                                               \
      if (split > 1 && split > steps) break;                               \
      const int kper = (K + split - 1) / split;                            \
      const int chunks = (kper + GEMV_XCH - 1) / GEMV_XCH;                 \
      const long long ctas = (long long)strips * split;                    \
      const long long per_sm =                                             \
          (ctas + cluster_sms[lg] - 1) / cluster_sms[lg];                  \
      const long long cost = per_sm * ((kper + ksb - 1) / ksb +            \
                                       (long long)GEMV_CTA_COST * chunks); \
      if (best.cols == 0 || cost < best_cost) {                            \
        best = {c, split, kper, strips};                                   \
        best_cost = cost;                                                  \
      }                                                                    \
    }                                                                      \
  }
  GEMV_COLS(LMR_PLAN)
#undef LMR_PLAN
  return best;
}

// The SMs a cluster of 1, 2, 4 and 8 GEMV CTAs can use on the current
// device: from the occupancy query, as clusters that fit at once times
// their size over the CTAs an SM holds. Asked once a device.
static bool cluster_sms(int* out) {
  static std::atomic<int> table[32][4];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 32) return false;
  if (table[dev][0].load() == 0) {
    auto kernel = gv::gemv_kernel<bf16, bf16, 4, 128>;
    constexpr int smem = gv::RING_BYTES + sizeof(gv::Smem<4, 128>);
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return false;
    int sms = 0, got[4];
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return false;
    for (int lg = 0; lg < 4; ++lg) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1, 1 << lg, 1);
      cfg.blockDim = dim3(gv::NT, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = 1 << lg;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&got[lg], kernel, &cfg) !=
              cudaSuccess || got[lg] <= 0)
        return false;
    }
    for (int lg = 3; lg >= 0; --lg)       // [0] last: it marks the table
      table[dev][lg].store(static_cast<int>(
          (long long)got[lg] * (1 << lg) * sms / got[0]));
  }
  for (int lg = 0; lg < 4; ++lg) out[lg] = table[dev][lg].load();
  return true;
}

// How many CTAs split K, a cluster: the GEMV's split for M <= 8, 1 for
// M > 8 (the tensor-core path does not split), 0 for a shape the kernels
// do not take.
static bool q8_takes(int M, int K, int N) {
  return M > 0 && K > 0 && N > 0 && (M + mk::BM - 1) / mk::BM <= 65535;
}

static int q8_splits(int M, int K, int N) {
  if (!q8_takes(M, K, N)) return 0;
  if (M > GEMV_MAX_M) return 1;
  int usable[4];
  return cluster_sms(usable) ? gemv_plan(K, N, usable).split : 0;
}

// One launch: the cluster along K (split > 1) sums its partials through
// distributed shared memory, so nothing is written but the output. A
// refused launch returns its error; nothing else is tried.
template <typename XT, typename OT, int MT, int COLS>
static int launch_gemv(const XT* X, const int8_t* W, const float* s, OT* O,
                       int M, int K, int N, const GemvPlan& p,
                       cudaStream_t st) {
  const bool vec = N % 16 == 0 && aligned16(W);
  auto kernel = gv::gemv_kernel<XT, OT, MT, COLS>;
  // the ring and the x chunk: past 48 KB the kernel opts in, once a
  // device (a function attribute is per device)
  constexpr int smem = gv::RING_BYTES + sizeof(gv::Smem<MT, COLS>);
  static std::atomic<unsigned> opted{0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && dev < 32 && !(opted.load() & (1u << dev))) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted.fetch_or(1u << dev);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.strips, p.split, 1);
  cfg.blockDim = dim3(gv::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, kernel, X, W, s, O, M, K, N, p.kper, vec,
                         GEMV_MAGIC));
}

template <typename XT, typename OT, int MT>
static int launch_gemv_cols(const XT* X, const int8_t* W, const float* s,
                            OT* O, int M, int K, int N, const GemvPlan& p,
                            cudaStream_t st) {
#define LMR_LAUNCH(c)                                                   \
  if (p.cols == c)                                                      \
    return launch_gemv<XT, OT, MT, c>(X, W, s, O, M, K, N, p, st);
  GEMV_COLS(LMR_LAUNCH)
#undef LMR_LAUNCH
  return cudaErrorInvalidValue;
}

// the GEMV instantiated for M's rows: 1, 2, 4 or 8
template <typename XT, typename OT>
static int launch_gemv_m(const void* x, const void* w, const float* s,
                         void* out, int M, int K, int N, const GemvPlan& p,
                         cudaStream_t st) {
  const XT* X = static_cast<const XT*>(x);
  const int8_t* W = static_cast<const int8_t*>(w);
  OT* O = static_cast<OT*>(out);
  if (M == 1) return launch_gemv_cols<XT, OT, 1>(X, W, s, O, M, K, N, p, st);
  if (M == 2) return launch_gemv_cols<XT, OT, 2>(X, W, s, O, M, K, N, p, st);
  if (M <= 4) return launch_gemv_cols<XT, OT, 4>(X, W, s, O, M, K, N, p, st);
  return launch_gemv_cols<XT, OT, 8>(X, W, s, O, M, K, N, p, st);
}

template <typename XT, typename OT>
static int launch(const void* x, const void* w, const float* s, void* out,
                  int M, int K, int N, cudaStream_t st) {
  const XT* X = static_cast<const XT*>(x);
  const int8_t* W = static_cast<const int8_t*>(w);
  OT* O = static_cast<OT*>(out);
  if (M <= GEMV_MAX_M) {
    int usable[4];
    if (!cluster_sms(usable)) return cudaErrorInvalidDevice;
    return launch_gemv_m<XT, OT>(x, w, s, out, M, K, N,
                                 gemv_plan(K, N, usable), st);
  } else if (sizeof(XT) == 2 && K % 8 == 0 && N % 16 == 0 &&
             aligned16(x) && aligned16(w) && aligned16(out)) {
    // bf16 x, int8 W and the bf16 out, all of which TMA can read and
    // write: the wgmma mainloop on 128 × 128 tiles
    CUtensorMap tx, tw, to;
    if (!sm90::make_map(&tx, x, true, K, M, K, 64, 128) ||
        !sm90::make_map(&tw, w, false, N, K, N, 128, 64) ||
        !sm90::make_map(&to, out, true, N, M, N, 64, 64))
      return cudaErrorInvalidValue;
    const int kt = (K + sm90::BK - 1) / sm90::BK;
    return sm90::launch_wgmma<128, false, true, true>(
        tx, tw, to, out, false, nullptr, s, M, N, K, 1, kt, st);
  } else {
    const bool xvec = K % 8 == 0;
    const bool wvec = N % 16 == 0 && aligned16(w);
    dim3 grid((N + mk::BN - 1) / mk::BN, (M + mk::BM - 1) / mk::BM);
    mk::mma_kernel<XT, OT><<<grid, mk::NT, 0, st>>>(X, W, s, O, M, K, N,
                                                    xvec, wvec);
  }
  return cudaSuccess;
}

extern "C" {

// The K split (cluster size) lmr_q8_matmul launches for this shape on
// the current device: 1 past M = 8, 0 when the kernels do not take the
// shape (M past the tensor-core grid).
int lmr_q8_splits(int M, int K, int N) { return q8_splits(M, K, N); }

// The GEMV's plan for an M <= 8 shape on the current device, into
// out[0..3]: strip width, split, K rows a CTA, strips; and into
// out[4..7] the SMs clusters of 1, 2, 4 and 8 CTAs can use, which the
// plan reads. Returns 0, or an error for a shape the GEMV does not take.
int lmr_q8_plan(int M, int K, int N, void* out) {
  if (M <= 0 || M > GEMV_MAX_M || K <= 0 || N <= 0)
    return cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  if (!cluster_sms(o + 4)) return cudaErrorInvalidDevice;
  const GemvPlan p = gemv_plan(K, N, o + 4);
  o[0] = p.cols; o[1] = p.split; o[2] = p.kper; o[3] = p.strips;
  return cudaSuccess;
}

// The GEMV with a given strip width and split (a plan gemv_plan would
// not pick, for the tests and for timing the alternatives): the same
// kernel, refused unless cols is one of GEMV_COLS, split a power of two
// up to GEMV_MAX_CLUSTER and no more than K's steps, and M <= 8.
int lmr_q8_gemv(const void* x, const void* w, const void* s, void* out,
                int M, int K, int N, int dtype, int cols, int split,
                void* stream) {
  bool known = false;
#define LMR_KNOWN(c) known = known || cols == c;
  GEMV_COLS(LMR_KNOWN)
#undef LMR_KNOWN
  if (!known || M <= 0 || M > GEMV_MAX_M || K <= 0 || N <= 0 || split < 1 ||
      split > GEMV_MAX_CLUSTER || (split & (split - 1)) ||
      (split > 1 && split > (K + gv::NT * gv::CPT / cols - 1) /
                                (gv::NT * gv::CPT / cols)))
    return cudaErrorInvalidValue;
  const GemvPlan p = {cols, split, (K + split - 1) / split,
                      (N + cols - 1) / cols};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* S = static_cast<const float*>(s);
  int rc;
  if (dtype == DT_F32)
    rc = launch_gemv_m<float, float>(x, w, S, out, M, K, N, p, st);
  else if (dtype == DT_BF16)
    rc = launch_gemv_m<bf16, bf16>(x, w, S, out, M, K, N, p, st);
  else
    return cudaErrorInvalidValue;
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

// x: contiguous (M, K) f32 or bf16; w: contiguous (K, N) int8; s: (N,)
// f32; out: contiguous (M, N) in x's dtype. Returns cudaGetLastError()
// after the launch (0 = launched).
int lmr_q8_matmul(const void* x, const void* w, const void* s, void* out,
                  int M, int K, int N, int dtype, void* stream) {
  if (!q8_takes(M, K, N)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* S = static_cast<const float*>(s);
  int rc;
  if (dtype == DT_F32)
    rc = launch<float, float>(x, w, S, out, M, K, N, st);
  else if (dtype == DT_BF16)
    rc = launch<bf16, bf16>(x, w, S, out, M, K, N, st);
  else
    return cudaErrorInvalidValue;
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
