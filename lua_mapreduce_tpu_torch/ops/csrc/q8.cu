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
//  * M ≤ 8, gemv_kernel: each block owns 64 output columns; its 256
//    threads are 4 column groups (16 int8 columns = one 16-byte load
//    each) × 64 slices of K, so a block keeps 4 KB of weight loads in
//    flight per unrolled step. Every weight byte is read once, widened to
//    f32 in registers and used for all M rows; x is rounded to bf16 (as
//    the TPU kernel casts x before the dot) and read from L1. When N is
//    narrow (the (1024, 1024) out projection makes only 16 column
//    blocks) K is also split across blocks, so the card has enough
//    blocks to pull the weight at full rate; a second small kernel sums
//    the f32 partials in split order. Slices reduce by warp shuffles and
//    then across warps through shared memory, in a fixed order, so the
//    result does not change from run to run.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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

namespace gv {
// a block: 64 output columns × 64 K-slices; a thread: 16 columns (one
// 16-byte weight load) of one K-slice; a warp: 4 column groups × 8 slices
constexpr int COLS = 64, CPT = 16, CG = COLS / CPT, NT = 256, NW = NT / 32,
              KSW = 32 / CG, KSB = NT / CG;

template <typename XT, typename OT, int MT>
__global__ void __launch_bounds__(NT)
gemv_kernel(const XT* __restrict__ X, const int8_t* __restrict__ W,
            const float* __restrict__ Sc, OT* __restrict__ Out,
            float* __restrict__ Part, int M, int K, int N, int kper,
            bool vec) {
  __shared__ float red[NW][MT][COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cg = lane % CG, ks = warp * KSW + lane / CG;
  const int n0 = blockIdx.x * COLS, col = n0 + cg * CPT;
  const int k0 = blockIdx.y * kper;
  const int k1 = K < k0 + kper ? K : k0 + kper;
  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

#pragma unroll 4
  for (int k = k0 + ks; k < k1; k += KSB) {
    const int8_t* wp = W + (long long)k * N + col;
    float w[CPT];
    if (vec) {                     // N % 16 == 0: a column group is whole
      int4 v = make_int4(0, 0, 0, 0);
      if (col < N) v = *reinterpret_cast<const int4*>(wp);
      const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int c = 0; c < CPT; ++c) w[c] = (float)e[c];
    } else {
#pragma unroll
      for (int c = 0; c < CPT; ++c) w[c] = col + c < N ? (float)wp[c] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // x is rounded to bf16 before the product, as the TPU kernel does;
      // the few KB of x stay in L1 across the block
      const float xv = m < M ? to_bf16_f32(X[(long long)m * K + k]) : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
    }
  }
  // the warp's 8 K-slices (lane bits 2-4), then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int off = CG; off < 32; off <<= 1)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) red[warp][m][cg * CPT + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * COLS; i += NT) {
    const int m = i / COLS, c = i % COLS, n = n0 + c;
    if (n >= N) continue;
    float sum = 0.f;
    for (int w = 0; w < NW; ++w) sum += red[w][m][c];
    if (gridDim.y == 1)
      store_out(&Out[(long long)m * N + n], sum * Sc[n]);
    else
      Part[((long long)blockIdx.y * M + m) * N + n] = sum;
  }
}

// sum the K-split partials in split order, scale once, cast
template <typename OT>
__global__ void reduce_kernel(const float* __restrict__ Part,
                              const float* __restrict__ Sc,
                              OT* __restrict__ Out, int splits, int M,
                              int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += Part[s * mn + i];
  store_out(&Out[i], sum * Sc[i % N]);
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

// How many ways the M <= 8 GEMV splits K: enough blocks for two per SM of
// the current device when N is narrow, each split at least MIN_SPLIT_K
// deep. 1 for M > 8 (the tensor-core path does not split), 0 for a shape
// the kernels do not take.
constexpr int GEMV_MAX_M = 8, MIN_SPLIT_K = 512;
static int q8_splits(int M, int K, int N) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + mk::BM - 1) / mk::BM > 65535)
    return 0;
  if (M > GEMV_MAX_M) return 1;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int col_blocks = (N + gv::COLS - 1) / gv::COLS;
  const int want = (2 * sms + col_blocks - 1) / col_blocks;
  const int most = K / MIN_SPLIT_K;
  const int splits = want < most ? want : most;
  return splits > 1 ? splits : 1;
}

template <typename XT, typename OT, int MT>
static void launch_gemv(const XT* X, const int8_t* W, const float* s, OT* O,
                        float* part, int M, int K, int N, int splits,
                        cudaStream_t st) {
  // K per split, a whole number of the block's K-slices
  int kper = (K + splits - 1) / splits;
  kper = (kper + gv::KSB - 1) / gv::KSB * gv::KSB;
  splits = (K + kper - 1) / kper;
  const bool vec = N % 16 == 0 && aligned16(W);
  dim3 grid((N + gv::COLS - 1) / gv::COLS, splits);
  gv::gemv_kernel<XT, OT, MT><<<grid, gv::NT, 0, st>>>(X, W, s, O, part, M,
                                                        K, N, kper, vec);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    gv::reduce_kernel<OT><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
        part, s, O, splits, M, N);
  }
}

template <typename XT, typename OT>
static int launch(const void* x, const void* w, const float* s, void* out,
                  float* part, int M, int K, int N, int splits,
                  cudaStream_t st) {
  const XT* X = static_cast<const XT*>(x);
  const int8_t* W = static_cast<const int8_t*>(w);
  OT* O = static_cast<OT*>(out);
  if (M <= GEMV_MAX_M) {
    if (splits > 1 && part == nullptr) return cudaErrorInvalidValue;
    if (M == 1) launch_gemv<XT, OT, 1>(X, W, s, O, part, M, K, N, splits, st);
    else if (M == 2) launch_gemv<XT, OT, 2>(X, W, s, O, part, M, K, N, splits, st);
    else if (M <= 4) launch_gemv<XT, OT, 4>(X, W, s, O, part, M, K, N, splits, st);
    else launch_gemv<XT, OT, 8>(X, W, s, O, part, M, K, N, splits, st);
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

// The K-split count lmr_q8_matmul uses for this shape on the current
// device: when it is above 1, the caller passes f32 scratch of
// splits·M·N as `part`. 0 when the kernels do not take the shape (M past
// the tensor-core grid).
int lmr_q8_splits(int M, int K, int N) { return q8_splits(M, K, N); }

// x: contiguous (M, K) f32 or bf16; w: contiguous (K, N) int8; s: (N,)
// f32; out: contiguous (M, N) in x's dtype; part: the scratch
// lmr_q8_splits asks for, or null when it returns 1. Returns
// cudaGetLastError() after the launches (0 = launched).
int lmr_q8_matmul(const void* x, const void* w, const void* s, void* out,
                  void* part, int M, int K, int N, int dtype, void* stream) {
  const int splits = q8_splits(M, K, N);
  if (splits < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* S = static_cast<const float*>(s);
  float* P = static_cast<float*>(part);
  int rc;
  if (dtype == DT_F32)
    rc = launch<float, float>(x, w, S, out, P, M, K, N, splits, st);
  else if (dtype == DT_BF16)
    rc = launch<bf16, bf16>(x, w, S, out, P, M, K, N, splits, st);
  else
    return cudaErrorInvalidValue;
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
