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
//    the (1024, 3072) qkv weight against 133 MB moved).
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
//  * M > 8, the prefill: pf::prefill_kernel, one launch, persistent over
//    tiles of 128 output channels × 208 tokens (128 for an f32 output)
//    computed transposed (Wᵀ · xᵀ), so that the int8 weight is wgmma's
//    A operand, from registers: TMA brings x (bf16) and the int8 weight
//    box as they lie in device memory, each consumer warp widens its 16
//    channels' A fragments in registers (a pair-ldmatrix.trans of the
//    int8 tile, then a byte permute under bf16's exponent and one bf16x2
//    subtraction; no widening warps, no bf16 weight tile in shared
//    memory), and x is read by descriptor as wgmma's B. The epilogue
//    scales each channel once, casts, and writes the transposed tile
//    through a TMA store (the kernel's note below). The weight crosses
//    device memory as int8 only. An f32 x is rounded to bf16 by the
//    wrapper first (as the TPU kernel casts x before the dot); an f32
//    output has its own instantiation. K % 8 != 0, N % 16 != 0 or an
//    unaligned pointer (layouts TMA cannot read) take mk::mma_kernel: a
//    128×128×32 shared-memory tiled GEMM on WMMA bf16 16×16×16
//    fragments, int8 widened as the tiles are written.
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

// The prefill kernel's launch constants. tests/test_torch_kernel_plans.py
// reads them from here and holds ops/q8.py's mirror of the plan to them.
// A CTA of PF_THREADS threads (two consumer warpgroups and a producer
// warpgroup) owns PF_CHANNELS output channels (64 a consumer warpgroup)
// and PF_TOKENS tokens, PF_F32_TOKENS for an f32 output (its staged C
// tile twice as wide a token); its stages are as many as fit in
// PF_SMEM_BUDGET bytes (the 227 KB a block may hold, less its static
// barriers) beside the C tile, at most PF_MAX_STAGES. 208 tokens is the
// widest tile whose accumulators and fragments fit a consumer's
// registers (the kernel's note), and the fastest at every serving
// product on the H100 (PERF.md); the f32 output's C tile leaves room
// for 128.
#define PF_CHANNELS 128
#define PF_TOKENS 208
#define PF_F32_TOKENS 128
#define PF_THREADS 384
#define PF_SMEM_BUDGET 232192
#define PF_MAX_STAGES 8
// widen_pair's byte selectors: bytes 0 and 2 of a word into the low byte
// of each 16-bit half, bf16 128's high byte 0x43 above them (lo); bytes
// 1 and 3 (hi)
#define PF_PERM_LO 0x4240
#define PF_PERM_HI 0x4341
// the routes of an M > 8 product, by kind: the prefill kernel and the
// general kernel
#define PF_KIND_RS 0
#define PF_KIND_GENERAL 1

namespace pf {
using namespace sm90;

// Shared memory of the <BT, F32> instantiation: STAGES stages of {x tile
// (BT tokens × 64 k, bf16, 128-byte swizzle), int8 tile (64 k × 128
// channels, 128-byte swizzle)}, then the staged C tile (BT tokens × 128
// channels in the output type), 1 KB aligned.
template <int BT, bool F32>
struct Layout {
  static constexpr int X_BYTES = BT * 64 * 2;
  static constexpr int W_BYTES = 64 * PF_CHANNELS;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int C_BYTES = BT * PF_CHANNELS * (F32 ? 4 : 2);
  static constexpr int FIT = (PF_SMEM_BUDGET - 1024 - C_BYTES) / STAGE;
  static constexpr int STAGES = FIT < PF_MAX_STAGES ? FIT : PF_MAX_STAGES;
  static constexpr int DYN = STAGES * STAGE + C_BYTES + 1024;
  static_assert(STAGES >= 2, "a ring of two stages at least");
};

// ldmatrix of four 8 × 8 b16 matrices, transposed: lanes 8j..8j+7 give
// the row addresses of matrix j, and lane (g, t) = (l / 4, l % 4) gets
// elements (2t, g) and (2t + 1, g) of each
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// A lane's word of a pair-ldmatrix: bytes {w[k][c], w[k][c+1],
// w[k+1][c], w[k+1][c+1]} (two channels c, c + 1 read as one b16
// element, at rows k and k + 1), widened exactly to channel c's bf16
// pair {w[k][c], w[k+1][c]} (lo) and channel c + 1's (hi): a permute
// puts a byte b under the bf16 exponent of 128 in each half (0x43bb),
// then v1 = 128 + (b & 127) and v2 = 128 or 256 (b's sign bit as the
// exponent's low bit), and one bf16x2 subtraction gives b exactly (an
// integer in [-128, 127]) — 8 operations a word, none a conversion.
__device__ __forceinline__ uint32_t widen_half(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0x43434343u, sel);
  const uint32_t v1 = t & 0xFF7FFF7Fu, v2 = t & 0xFF80FF80u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(v1), "r"(v2));
  return d;
}
__device__ __forceinline__ void widen_pair(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  lo = widen_half(w, PF_PERM_LO);
  hi = widen_half(w, PF_PERM_HI);
}

// The bf16 A fragments of a K-tile's four k16 steps for this warp's 16
// channels, from the int8 tile of a stage. The tile is (64 k, 128
// channels) as TMA wrote it: row k at k · 128 bytes, its 16-byte chunk c
// (channels 16c..16c+15) at chunk c ^ (k % 8). A pair of channels is one
// b16 element, so a chunk is an 8-element row of an ldmatrix matrix: an
// x4 load of 32 k rows (lane l addressing row 32·half + l) gives matrix
// j k rows 8j..8j+7, and the transposed load hands lane (g, t) k rows
// 2t, 2t + 1 of channels 2g, 2g + 1. Widened, those are the fragment
// registers of rows g and g + 8 (k 2t, 2t + 1; a step's second matrix
// gives k 2t + 8, 2t + 9): the warp's fragment row r is its channel
// 2·(r % 8) + r / 8.
__device__ __forceinline__ void load_frags(uint32_t (&a)[4][4],
                                           uint32_t wtile, int chunk,
                                           int lane) {
  const uint32_t col = (chunk ^ (lane & 7)) << 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t r[4];
    ldsm_x4_trans(r, wtile + (32 * half + lane) * 128 + col);
    widen_pair(r[0], a[2 * half][0], a[2 * half][1]);
    widen_pair(r[1], a[2 * half][2], a[2 * half][3]);
    widen_pair(r[2], a[2 * half + 1][0], a[2 * half + 1][1]);
    widen_pair(r[3], a[2 * half + 1][2], a[2 * half + 1][3]);
  }
}

// d (64 × N, f32) += A (64 × 16, bf16 registers) · B (16 × N); B is
// K-major in shared memory (a token's 16 k contiguous): one instruction a
// k16 step of a tile's N tokens.
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs_k<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_k<208>(float (&d)[104],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103}, "
      "{%104, %105, %106, %107}, %108, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One commit group, a K-tile: its four k16 steps of this warpgroup's 64
// channels × BT tokens, A from registers, B (x) from the stage's tile
// (K-major: 16 k = 32 bytes along a swizzled row).
template <int BT>
__device__ __forceinline__ void mma_ktile(float (&acc)[BT / 2],
                                          const uint32_t (&a)[4][4],
                                          uint32_t xtile) {
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wgmma_rs_k<BT>(acc, a[q], desc_sw128(xtile + q * 32, 16, 1024));
  wgmma_commit();
}

// K-tile i of a tile (the block's gi-th): issue it from `cur`; once the
// K-tile before it has retired, release that one's stage and build the
// next K-tile's fragments into `nxt` (the retired one's registers) — the
// tile's next, or with `more` the block's next tile's first — waiting
// for its stage to land first. Each warp releases a stage itself (the
// "empty" barrier counts the 8 consumer warps), once its own wait has
// retired its share of the group that read the stage's x tile, and
// after its own ldmatrix reads of the int8 tile (a K-tile earlier): the
// release does not lean on the other warps of the warpgroup having
// reached the same point.
template <typename L, int BT>
__device__ __forceinline__ void step(float (&acc)[BT / 2],
                                     uint32_t (&cur)[4][4],
                                     uint32_t (&nxt)[4][4], int i, int nkt,
                                     bool more, int gi, uint32_t base,
                                     uint64_t* full, uint64_t* empty,
                                     int chunk, int lane) {
  constexpr int S = L::STAGES;
  mma_ktile<BT>(acc, cur, base + (gi % S) * L::STAGE);
  wgmma_wait<1>();
  fence_frag(nxt);
  if (i > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(gi - 1) % S]));
  if (i + 1 < nkt || more) {
    const int gn = gi + 1;
    mbar_wait(smem_u32(&full[gn % S]), (gn / S) & 1);
    load_frags(nxt, base + (gn % S) * L::STAGE + L::X_BYTES, chunk, lane);
  }
}

// The prefill kernel: out (M tokens, N channels) = bf16(x) · W_q8 · s,
// computed tile by tile transposed, as Wᵀ · xᵀ, so that the int8 weight
// is wgmma's A operand, taken from registers: a tile is 128 channels ×
// BT tokens, each consumer warpgroup's 64 channels × BT tokens one
// m64nBTk16 product a k16 step.
//  * Warpgroup 2, the producer: one thread keeps the ring of STAGES
//    stages filled by TMA, x's box {64 k, BT tokens} and W's int8 box
//    {128 channels, 64 k} as they lie in device memory (both with the
//    128-byte swizzle), each stage's arrival counted on "full", refilled
//    once every consumer warp has released it ("empty").
//  * Warpgroups 0 and 1, the consumers: each warp builds the A
//    fragments of its 16 channels with a pair-ldmatrix of the int8 tile
//    (load_frags) and widens them in registers; x is wgmma's B, read by
//    descriptor from its tile as it lies. No widening warps, no bf16
//    weight tile, no third barrier. A K-tile is one commit group, its
//    fragments double-buffered: the next K-tile's are built while the
//    tensor cores run this one, into the registers of the K-tile before
//    it once that one has retired (one group in flight, as B1's
//    mainloop keeps), and its stage is released then. The last K-tile's
//    step builds the block's next tile's first fragments, so a tile
//    starts with no widening in front of its first product.
//  * Registers: ptxas gives every thread of the block the same count,
//    168 at 384 threads (setmaxnreg moves them only at run time; a
//    block of 288 threads gets no more, its ninth warp sharing a
//    sub-partition's register file with two others), so a tile's BT / 2
//    accumulators and 32 fragment registers fit up to 208 tokens; at 224
//    and 256 ptxas spills and serialises the wgmmas. A fragment buffer
//    is rebuilt only after the wait that retires the group reading it;
//    tests/torch_sass_wgmma.py holds the built SASS to that (no write
//    to an in-flight HGMMA's A registers, no touch of its accumulators,
//    on any path). A variant with three buffers (two groups in flight)
//    gave wrong results once and was dropped, its cause not found.
//  * The epilogue: rows of the accumulator are channels and columns
//    tokens, and with the fragment rows permuted (row r of a warp is its
//    channel 2·(r % 8) + r / 8) a lane holds channels 2g and 2g + 1 of
//    each of its tokens: it scales both (the per-channel scale in f32,
//    once), casts, and writes them as one 32-bit (bf16) or 64-bit (f32)
//    store into the transposed (tokens, channels) C tile, swizzled, which
//    a TMA store hands to device memory (ragged edges clipped) while the
//    warpgroup goes on to its next tile; the buffer is waited on (the
//    store's read) only before it is reused.
// Persistent: a block walks tiles blockIdx.x, blockIdx.x + gridDim.x,
// ... in gemm_sm90.cuh's L2-friendly order (token tiles grouped), and
// the ring's stage and phase run on across tiles. Ragged M, N and K come
// back from TMA as zeros and are clipped by the TMA store.
template <int BT, bool F32>
__global__ void __launch_bounds__(PF_THREADS, 1)
prefill_kernel(const __grid_constant__ CUtensorMap tma_x,
               const __grid_constant__ CUtensorMap tma_w,
               const __grid_constant__ CUtensorMap tma_o,
               const float* __restrict__ Sc, int M, int N, int K) {
  using L = Layout<BT, F32>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1 KB
  uint8_t* gbase = smem_raw + (base - raw);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int tiles_t = (M + BT - 1) / BT;
  const int tiles_c = (N + PF_CHANNELS - 1) / PF_CHANNELS;
  const int total = tiles_t * tiles_c, kt_all = (K + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);     // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (t == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_w)) : "memory");
      int g = 0;                     // K-tiles issued so far, all tiles
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        int m_t, n_t, z;
        work_of(w, tiles_t, tiles_c, m_t, n_t, z);
        for (int i = 0; i < kt_all; ++i, ++g) {
          const int s = g % S;
          mbar_wait(smem_u32(&empty[s]), ((g / S) & 1) ^ 1);
          const uint32_t fb = smem_u32(&full[s]);
          mbar_expect_tx(fb, L::STAGE);
          const uint32_t sx = base + s * L::STAGE;
          tma_load_2d(sx, &tma_x, fb, i * 64, m_t * BT);
          tma_load_2d(sx + L::X_BYTES, &tma_w, fb, n_t * PF_CHANNELS, i * 64);
        }
      }
    }
    return;
  }
  // -------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w4 = t / 32, lane = t % 32;
  const int chunk = wg * 4 + w4;     // this warp's 16 channels of the tile
  uint8_t* cbuf = gbase + S * L::STAGE + wg * (BT * 64 * (F32 ? 4 : 2));
  int g = 0;                         // K-tiles consumed so far, all tiles
  uint32_t fa[4][4], fb[4][4];       // a K-tile's fragments, two buffers
  bool ready = false;                // fa holds this tile's first K-tile
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    int m_t, n_t, z;
    work_of(w, tiles_t, tiles_c, m_t, n_t, z);
    float acc[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    // the block has a next tile: the last K-tile's step builds that
    // tile's first fragments before this one's epilogue
    const bool more = w + gridDim.x < total;
    if (!ready && kt_all > 0) {
      mbar_wait(smem_u32(&full[g % S]), (g / S) & 1);
      load_frags(fa, base + (g % S) * L::STAGE + L::X_BYTES, chunk, lane);
    }
    for (int i = 0; i < kt_all; i += 2) {
      step<L, BT>(acc, fa, fb, i, kt_all, more, g + i, base, full, empty,
                  chunk, lane);
      if (i + 1 < kt_all)
        step<L, BT>(acc, fb, fa, i + 1, kt_all, more, g + i + 1, base, full,
                    empty, chunk, lane);
    }
    wgmma_wait<0>();
    fence_frag(fa);
    fence_frag(fb);
    if (kt_all > 0 && lane == 0)
      mbar_arrive(smem_u32(&empty[(g + kt_all - 1) % S]));
    g += kt_all;
    fence_acc(acc);
    // the next tile's first fragments went to the buffer after the last
    // K-tile's: fa when the count is even
    ready = more && kt_all > 0;
    if (ready && kt_all % 2 == 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) fa[q][r] = fb[q][r];
    }

    // accumulator register 4j + 2h + e of warp w4, lane (g8, t4) is
    // fragment row 16·w4 + g8 + 8h — channel 2·g8 + h of the warp's 16 —
    // and token 8j + 2·t4 + e
    const int g8 = lane / 4, t4 = lane % 4;
    const int ch = w4 * 16 + 2 * g8;   // of this warpgroup's 64
    const int gc = n_t * PF_CHANNELS + wg * 64 + ch;
    const float s0 = gc < N ? Sc[gc] : 0.f;
    const float s1 = gc + 1 < N ? Sc[gc + 1] : 0.f;
    // the previous tile's store must have read the buffer first
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    named_sync(2 + wg, 128);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * j + 2 * t4 + e;                 // token
        const float v0 = acc[4 * j + e] * s0;
        const float v1 = acc[4 * j + 2 + e] * s1;
        if (F32) {
          // boxes of 32 channels × BT tokens, 128-byte rows
          uint8_t* row = cbuf + (ch / 32) * (BT * 128) + r * 128;
          *reinterpret_cast<float2*>(
              row + ((((ch % 32) / 4) ^ (r & 7)) << 4) + (ch % 4) * 4) =
              make_float2(v0, v1);
        } else {
          // one box of 64 channels × BT tokens, 128-byte rows
          uint8_t* row = cbuf + r * 128;
          *reinterpret_cast<uint32_t*>(
              row + (((ch / 8) ^ (r & 7)) << 4) + (ch % 8) * 2) =
              pack_bf16(v0, v1);
        }
      }
    // generic-proxy writes, read next by TMA (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(2 + wg, 128);
    if (t == 0) {
      const int c0 = n_t * PF_CHANNELS + wg * 64;
      if (F32) {
        tma_store_2d(&tma_o, smem_u32(cbuf), c0, m_t * BT);
        tma_store_2d(&tma_o, smem_u32(cbuf + BT * 128), c0 + 32, m_t * BT);
      } else {
        tma_store_2d(&tma_o, smem_u32(cbuf), c0, m_t * BT);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // the last TMA store has read its shared memory before the block ends
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A 2-D tensor map: dims {inner, outer}, the outer stride in bytes, a box
// of {box_inner, box_outer}, the 128-byte swizzle; out-of-range elements
// read as zero (and are not written by a store)
static bool map2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType dt,
                  long long inner, long long outer, long long pitch,
                  int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)pitch};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The prefill kernel's launch: a grid of min(tiles, SMs) persistent
// blocks
template <int BT, bool F32>
static int launch(const void* x, const void* w, const float* s, void* out,
                  int M, int K, int N, cudaStream_t st) {
  using L = Layout<BT, F32>;
  auto kern = prefill_kernel<BT, F32>;
  static bool attr = false;   // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DYN);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  CUtensorMap tx, tw, to;
  if (!map2d(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, M, 2ll * K, 64,
             BT) ||
      !map2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, N, K, N, PF_CHANNELS,
             64) ||
      !map2d(&to, out,
             F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             N, M, (long long)N * (F32 ? 4 : 2), F32 ? 32 : 64, BT))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long tiles = (long long)((M + BT - 1) / BT) *
                          ((N + PF_CHANNELS - 1) / PF_CHANNELS);
  if (tiles > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  kern<<<grid, PF_THREADS, L::DYN, st>>>(tx, tw, to, s, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace pf


// The general kernel, for layouts TMA cannot read (K % 8 != 0, N % 16
// != 0, an unaligned pointer): a 128 × 128 × 32 shared-memory tiled GEMM
// on WMMA bf16 16 × 16 × 16 fragments, int8 widened as its tiles are
// written. x is bf16 (the wrapper rounds an f32 x first); out bf16 or
// f32.
namespace mk {
using namespace nvcuda;
constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int LDA = BK + 8, LDB = BN + 8;
constexpr int WM = 64, WN = 32, FM = WM / 16, FN = WN / 16;

template <typename OT>
__global__ void __launch_bounds__(NT)
mma_kernel(const bf16* __restrict__ X, const int8_t* __restrict__ W,
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
      const bf16* src = X + (long long)gr * K + gc;
      if (xvec && gr < M && gc < K) {      // K % 8 == 0: the 8 are in range
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gr < M && gc + e < K) ? src[e] : __float2bfloat16(0.f);
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

// The prefill's plan for an M > 8 product: the token width (PF_TOKENS,
// PF_F32_TOKENS for an f32 output), its instantiation's stages, the
// tiles (128 channels × the width) and the persistent grid.
// ops/q8.py::prefill_plan is its mirror, held to it on the CPU and on
// the card.
struct PrefillPlan {
  int tokens, stages, tiles, ctas;
};

static PrefillPlan prefill_plan(int M, int N, bool f32, int sms) {
  const int b = f32 ? PF_F32_TOKENS : PF_TOKENS;
  const long long tiles = (long long)((M + b - 1) / b) *
                          ((N + PF_CHANNELS - 1) / PF_CHANNELS);
  const int stages = f32 ? pf::Layout<PF_F32_TOKENS, true>::STAGES
                         : pf::Layout<PF_TOKENS, false>::STAGES;
  return {b, stages, static_cast<int>(tiles),
          static_cast<int>(tiles < sms ? tiles : sms)};
}

// Can TMA read x (bf16) and W: 16-byte aligned bases, rows of a
// multiple of 16 bytes (K % 8 == 0 for x, N % 16 == 0 for W)? (It then
// writes any 16-byte aligned out: its rows, N in bf16 or f32, are too.)
static bool pf_reads(const void* x, const void* w, int K, int N) {
  return K % 8 == 0 && N % 16 == 0 && aligned16(x) && aligned16(w);
}
static bool pf_route(const void* x, const void* w, const void* out, int K,
                     int N) {
  return pf_reads(x, w, K, N) && aligned16(out);
}

template <typename OT>
static int launch_general(const void* x, const void* w, const float* s,
                          void* out, int M, int K, int N, cudaStream_t st) {
  const bool xvec = K % 8 == 0;
  const bool wvec = N % 16 == 0 && aligned16(w);
  dim3 grid((N + mk::BN - 1) / mk::BN, (M + mk::BM - 1) / mk::BM);
  mk::mma_kernel<OT><<<grid, mk::NT, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), s,
      static_cast<OT*>(out), M, K, N, xvec, wvec);
  return static_cast<int>(cudaGetLastError());
}

// M > 8: x bf16 (the wrapper rounds an f32 x, as the TPU kernel does),
// out bf16 or f32. The prefill kernel where TMA can read the operands,
// else the general kernel (or that one alone, `general`); a refused
// launch returns its error.
template <typename OT>
static int launch_prefill(const void* x, const void* w, const float* s,
                          void* out, int M, int K, int N, bool general,
                          cudaStream_t st) {
  if (general || !pf_route(x, w, out, K, N))
    return launch_general<OT>(x, w, s, out, M, K, N, st);
  if constexpr (sizeof(OT) == 4)
    return pf::launch<PF_F32_TOKENS, true>(x, w, s, out, M, K, N, st);
  else
    return pf::launch<PF_TOKENS, false>(x, w, s, out, M, K, N, st);
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

// The prefill's route and plan for an M > 8 product on the current
// device, for these operands and a fresh (aligned) output, as
// lmr_q8_matmul's caller allocates it: into out[0..5] the route
// (PF_KIND_RS: the prefill kernel; PF_KIND_GENERAL: the general kernel),
// the token width, its stages, the tiles, the CTAs (0, 0, 0, 0 for the
// general kernel) and the SMs the plan counted. Returns 0, or an error
// for a shape the kernels do not take.
int lmr_q8_prefill_plan(const void* x, const void* w, int M, int K, int N,
                        int out_dtype, void* out) {
  if (!q8_takes(M, K, N) || M <= GEMV_MAX_M ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  int* r = static_cast<int*>(out);
  const int sms = sm90::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  r[0] = PF_KIND_GENERAL; r[1] = r[2] = r[3] = r[4] = 0; r[5] = sms;
  if (pf_reads(x, w, K, N)) {
    const PrefillPlan p = prefill_plan(M, N, out_dtype == DT_F32, sms);
    r[0] = PF_KIND_RS; r[1] = p.tokens; r[2] = p.stages; r[3] = p.tiles;
    r[4] = p.ctas;
  }
  return cudaSuccess;
}

// An M > 8 product by a given route, for the tests and for timing the
// general kernel where the main path would not take it: PF_KIND_RS (the
// prefill kernel at its plan) or PF_KIND_GENERAL (any layout). x bf16.
// Refused (cudaErrorInvalidValue) where the route cannot take the
// operands.
int lmr_q8_prefill_forced(const void* x, const void* w, const void* s,
                          void* out, int M, int K, int N, int out_dtype,
                          int kind, void* stream) {
  if (!q8_takes(M, K, N) || M <= GEMV_MAX_M ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16) ||
      (kind != PF_KIND_RS && kind != PF_KIND_GENERAL) ||
      (kind == PF_KIND_RS && !pf_route(x, w, out, K, N)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* S = static_cast<const float*>(s);
  const bool general = kind == PF_KIND_GENERAL;
  const int rc =
      out_dtype == DT_F32
          ? launch_prefill<float>(x, w, S, out, M, K, N, general, st)
          : launch_prefill<bf16>(x, w, S, out, M, K, N, general, st);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

// x: contiguous (M, K) in `dtype` (f32 or bf16; bf16 past M = 8, where
// the wrapper rounds an f32 x first); w: contiguous (K, N) int8; s: (N,)
// f32; out: contiguous (M, N) in `out_dtype` (x's dtype at M <= 8).
// Returns cudaGetLastError() after the launch (0 = launched).
int lmr_q8_matmul(const void* x, const void* w, const void* s, void* out,
                  int M, int K, int N, int dtype, int out_dtype,
                  void* stream) {
  if (!q8_takes(M, K, N) || (dtype != DT_F32 && dtype != DT_BF16) ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* S = static_cast<const float*>(s);
  int rc;
  if (M <= GEMV_MAX_M) {
    if (dtype != out_dtype) return cudaErrorInvalidValue;
    int usable[4];
    if (!cluster_sms(usable)) return cudaErrorInvalidDevice;
    const GemvPlan p = gemv_plan(K, N, usable);
    rc = dtype == DT_F32
             ? launch_gemv_m<float, float>(x, w, S, out, M, K, N, p, st)
             : launch_gemv_m<bf16, bf16>(x, w, S, out, M, K, N, p, st);
  } else {
    if (dtype != DT_BF16) return cudaErrorInvalidValue;
    rc = out_dtype == DT_F32
             ? launch_prefill<float>(x, w, S, out, M, K, N, false, st)
             : launch_prefill<bf16>(x, w, S, out, M, K, N, false, st);
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
