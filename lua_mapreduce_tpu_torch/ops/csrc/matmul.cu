// C = A · B on Hopper (sm_90a): a shared-memory tiled GEMM with the
// whole K loop inside the block and an f32 accumulator in registers.
//
// Replaces: lua_mapreduce_tpu/ops/matmul.py::_matmul_kernel (driven by
// _matmul_pallas; its custom VJP _mm_bwd runs dA = g·Bᵀ and dB = Aᵀ·g
// through the same kernel, and so does the port's autograd.Function).
//
// What bounds it on the H100: at large shapes (the (8192,)×4 bf16 MLP,
// 8192³ products) the tensor-core FLOP rate, 989 TFLOP/s dense bf16; at
// the digits shapes ((128,256)·(256,128), (128,128)·(128,10)) the bytes
// moved and, below that, the launch itself — those products are a few
// MFLOP, microseconds of work for the whole card.
//
// What this simple design does about it:
//  * The TPU kernel walks K as a sequential grid axis carrying an f32
//    VMEM scratch from step to step. GPU blocks run in no order, so here
//    each block owns one output tile and loops over K itself, keeping the
//    partial sums in registers (f32 path) or in WMMA accumulator
//    fragments (bf16 path), and casts once at the store.
//  * bf16 inputs go through the tensor cores with mma.sync-class WMMA
//    16×16×16 bf16 fragments and an f32 accumulator. f32 inputs use full
//    FP32 FMAs (never TF32), so f32 results match the plain version to
//    summation order.
//  * No zero padding of the operands: tile loads mask the ragged edges
//    (digits has N=10 and M=200) and fill zeros in shared memory; the
//    store masks rows and columns past (M, N).
//  * Operands are read through (row, col) strides, so the backward's
//    transposed operands (g·Bᵀ, Aᵀ·g) are plain views with swapped
//    strides: no transposed copy is made. Loads vectorise to 16 bytes
//    along whichever axis is contiguous.
//  * Left for later work: double-buffered cp.async/TMA loads, wgmma,
//    larger warp tiles, a persistent schedule.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------- f32 path
// 64×64 output tile, BK=16, 256 threads, each thread a 4×4 micro-tile.

namespace f32k {
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, NT = 256;

template <typename OutT>
__global__ void __launch_bounds__(NT)
matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  OutT* __restrict__ C, int M, int N, int K,
                  long long sam, long long sak, long long sbk,
                  long long sbn) {
  // As[k][m] and Bs[k][n]: both read along the output tile's axis
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // walk the contiguous axis fastest so global loads coalesce
  const bool a_k_fast = (sak == 1) || (sam != 1);
  const bool b_n_fast = (sbn == 1) || (sbk != 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      int mm, kk;
      if (a_k_fast) { mm = i / BK; kk = i % BK; }
      else          { kk = i / BM; mm = i % BM; }
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[gm * sam + gk * sak] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      int kk, nn;
      if (b_n_fast) { kk = i / BN; nn = i % BN; }
      else          { nn = i / BK; kk = i % BK; }
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? B[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) store_out(&C[(long long)gm * N + gn], acc[i][j]);
    }
  }
}
}  // namespace f32k

// --------------------------------------------------------------- bf16 path
// 128×128 output tile, BK=32, 8 warps in a 2×4 grid, each warp 64×32 =
// 4×2 WMMA 16×16 fragments with f32 accumulators.

namespace bf16k {
using namespace nvcuda;
constexpr int BM = 128, BN = 128, BK = 32, NT = 256;
constexpr int LDA = BK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int LDB = BN + 8;
constexpr int WM = 64, WN = 32, FM = WM / 16, FN = WN / 16;

// Load a ROWS×COLS tile of a strided matrix (element (r, c) at
// P[r*sr + c*sc], valid for r < R, c < C) into S[r*LD + c], zero-filling
// outside. vec_c: c is contiguous and 8-element vectors never straddle
// the edge; vec_r: the same along r.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(bf16* S, const bf16* __restrict__ P,
                                          int r0, int c0, int R, int C,
                                          long long sr, long long sc,
                                          bool vec_c, bool vec_r) {
  const int tid = threadIdx.x;
  if (vec_c) {
    constexpr int VPR = COLS / 8;
    for (int i = tid; i < ROWS * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const int gr = r0 + r, gc = c0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gr < R && gc < C)
        v = *reinterpret_cast<const uint4*>(P + gr * sr + gc);
      *reinterpret_cast<uint4*>(S + r * LD + c) = v;
    }
  } else if (vec_r) {
    constexpr int VPC = ROWS / 8;
    for (int i = tid; i < COLS * VPC; i += NT) {
      const int c = i / VPC, r = (i % VPC) * 8;
      const int gr = r0 + r, gc = c0 + c;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gr < R && gc < C)
        v = *reinterpret_cast<const uint4*>(P + gr + gc * sc);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) S[(r + j) * LD + c] = e[j];
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const int gr = r0 + r, gc = c0 + c;
      S[r * LD + c] = (gr < R && gc < C) ? P[gr * sr + gc * sc] : zero;
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(NT)
matmul_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   OutT* __restrict__ C, int M, int N, int K,
                   long long sam, long long sak, long long sbk,
                   long long sbn, bool a_vk, bool a_vm, bool b_vn,
                   bool b_vk) {
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
    load_tile<BM, BK, LDA>(As, A, m0, k0, M, K, sam, sak, a_vk, a_vm);
    load_tile<BK, BN, LDB>(Bs, B, k0, n0, K, N, sbk, sbn, b_vn, b_vk);
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
  // epilogue: each fragment goes through a per-warp f32 scratch tile so
  // the store can mask the ragged edge and cast once
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
        if (gr < M && gc < N) store_out(&C[(long long)gr * N + gc], cs[e]);
      }
      __syncwarp();
    }
}
}  // namespace bf16k

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int lmr_matmul(const void* a, const void* b, void* c, int M, int N, int K,
               long long sam, long long sak, long long sbk, long long sbn,
               int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_F32) {
    dim3 grid((N + f32k::BN - 1) / f32k::BN, (M + f32k::BM - 1) / f32k::BM);
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    if (out_dtype == DT_F32)
      f32k::matmul_f32_kernel<float><<<grid, f32k::NT, 0, s>>>(
          A, B, static_cast<float*>(c), M, N, K, sam, sak, sbk, sbn);
    else if (out_dtype == DT_BF16)
      f32k::matmul_f32_kernel<bf16><<<grid, f32k::NT, 0, s>>>(
          A, B, static_cast<bf16*>(c), M, N, K, sam, sak, sbk, sbn);
    else
      return cudaErrorInvalidValue;
  } else if (in_dtype == DT_BF16) {
    dim3 grid((N + bf16k::BN - 1) / bf16k::BN,
              (M + bf16k::BM - 1) / bf16k::BM);
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    // 16-byte vectors: the contiguous axis has stride 1, its extent and
    // the other stride are multiples of 8 elements, the base is aligned
    const bool a_vk = aligned16(a) && sak == 1 && K % 8 == 0 && sam % 8 == 0;
    const bool a_vm = aligned16(a) && sam == 1 && M % 8 == 0 && sak % 8 == 0;
    const bool b_vn = aligned16(b) && sbn == 1 && N % 8 == 0 && sbk % 8 == 0;
    const bool b_vk = aligned16(b) && sbk == 1 && K % 8 == 0 && sbn % 8 == 0;
    if (out_dtype == DT_F32)
      bf16k::matmul_bf16_kernel<float><<<grid, bf16k::NT, 0, s>>>(
          A, B, static_cast<float*>(c), M, N, K, sam, sak, sbk, sbn, a_vk,
          a_vm, b_vn, b_vk);
    else if (out_dtype == DT_BF16)
      bf16k::matmul_bf16_kernel<bf16><<<grid, bf16k::NT, 0, s>>>(
          A, B, static_cast<bf16*>(c), M, N, K, sam, sak, sbk, sbn, a_vk,
          a_vm, b_vn, b_vk);
    else
      return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
