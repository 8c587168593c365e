// C = A · B on Hopper (sm_90a), A (M, K) and B (K, N) read through any
// (row, col) strides, f32 accumulation, one cast at the store.
//
// Replaces: lua_mapreduce_tpu/ops/matmul.py::_matmul_kernel (driven by
// _matmul_pallas; its custom VJP _mm_bwd runs dA = g·Bᵀ and dB = Aᵀ·g
// through the same kernel, and so does the port's autograd.Function).
//
// What bounds it on the H100: the large bf16 products (the (8192,)×4 MLP,
// ResNet's later stages) the tensor-core rate, 989 TFLOP/s dense bf16;
// the conv weight gradients dB = patchesᵀ·g (outputs of 75×6 to 576×64
// over K up to 802,816) the bytes of their two operands; the digits f32
// products (a few MFLOP) latency and launch.
//
// What the design does about it:
//  * Split-K, decided here (lmr_matmul_splits, from M, N, K, the dtype and
//    the device's SM count): when the output tiles leave SMs idle, K is
//    cut into equal chunks of whole 64-deep K-tiles, each (tile, chunk)
//    block writes an f32 partial, and splitk_reduce_kernel sums the
//    partials in split order and casts once — no atomics, so the result
//    is bit-identical from run to run. The caller allocates the scratch.
//  * bf16 operands that TMA can read (16-byte aligned base, unit stride
//    along one axis, the other stride a multiple of 8 elements) take the
//    pipelined wgmma mainloop of gemm_sm90.cuh, in any of the four
//    major-ness combinations: x·W, g·Wᵀ (B K-major), hᵀ·g (A M-major).
//  * Other bf16 layouts take matmul_bf16_kernel: a 128 × BN tile (BN 32,
//    64 or 128 by N, so the conv paths' narrow products do not compute a
//    128-wide tile of zeros) with WMMA 16×16×16 fragments; the next
//    K-tile's loads are in flight while the current one is computed. A
//    tile is read in 16-byte vectors along whichever axis is contiguous
//    when that axis is a multiple of 8. The conv operands' contiguous
//    axes are not (patches rows of 75, 147 or 150; g rows of 6 or 16),
//    but each is a contiguous matrix, so the slab a tile needs — K rows
//    k0..k0+32 of patchesᵀ or g, or all K of 128 patches rows — is one
//    span of memory: cp.async copies it in 16-byte pieces into a staging
//    area, and the block spreads it into the tile. Anything else is read
//    element by element, neighbouring threads on neighbouring addresses.
//  * f32 inputs use full FP32 FMAs (never TF32) on 64×64 tiles with the
//    same register prefetch and the same split.
//  * Nothing is padded: ragged edges are masked in the loads (or come
//    back as zeros from TMA) and at the store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>
#include <mutex>

#include "gemm_sm90.cuh"

using bf16 = __nv_bfloat16;
using sm90::aligned16;

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// to C (cast once) or, in a split, to this split's f32 partial
__device__ __forceinline__ void put(void* C, bool out_f32, float* Part,
                                    long long off, float v) {
  if (Part != nullptr) Part[off] = v;
  else if (out_f32) static_cast<float*>(C)[off] = v;
  else store_out(static_cast<bf16*>(C) + off, v);
}

// sum the split-K partials in split order, cast once
__global__ void splitk_reduce_kernel(const float* __restrict__ Part, void* C,
                                     bool out_f32, int splits,
                                     long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += Part[s * mn + i];
  if (out_f32) static_cast<float*>(C)[i] = sum;
  else store_out(static_cast<bf16*>(C) + i, sum);
}

// ---------------------------------------------------------------- f32 path
// 64×64 output tile, BK=16, 256 threads, each thread a 4×4 micro-tile;
// the next K-tile's 4 + 4 elements per thread are loaded into registers
// before the current tile is computed.

namespace f32k {
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, NT = 256;
constexpr int EA = BM * BK / NT, EB = BK * BN / NT;

__global__ void __launch_bounds__(NT)
matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  void* C, bool out_f32, float* Part, int M, int N, int K,
                  long long sam, long long sak, long long sbk, long long sbn,
                  int kt_per) {
  // As[k][m] and Bs[k][n]: both read along the output tile's axis
  __shared__ float As[2][BK][BM + 4];
  __shared__ float Bs[2][BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_all = (K + BK - 1) / BK, kt0 = blockIdx.z * kt_per;
  const int nkt = kt_per < kt_all - kt0 ? kt_per : kt_all - kt0;
  // walk the contiguous axis fastest so global loads coalesce
  const bool a_k_fast = (sak == 1) || (sam != 1);
  const bool b_n_fast = (sbn == 1) || (sbk != 1);
  float ra[EA], rb[EB];

  auto load = [&](int kt) {
    const int k0 = (kt0 + kt) * BK;
#pragma unroll
    for (int e = 0; e < EA; ++e) {
      const int i = tid + e * NT;
      const int mm = a_k_fast ? i / BK : i % BM, kk = a_k_fast ? i % BK : i / BM;
      const int gm = m0 + mm, gk = k0 + kk;
      ra[e] = (gm < M && gk < K) ? A[gm * sam + gk * sak] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int i = tid + e * NT;
      const int kk = b_n_fast ? i / BN : i % BK, nn = b_n_fast ? i % BN : i / BK;
      const int gk = k0 + kk, gn = n0 + nn;
      rb[e] = (gk < K && gn < N) ? B[gk * sbk + gn * sbn] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < EA; ++e) {
      const int i = tid + e * NT;
      As[buf][a_k_fast ? i % BK : i / BM][a_k_fast ? i / BK : i % BM] = ra[e];
    }
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      const int i = tid + e * NT;
      Bs[buf][b_n_fast ? i / BN : i % BK][b_n_fast ? i % BN : i / BK] = rb[e];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (nkt > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int it = 0; it < nkt; ++it) {
    const int cur = it & 1;
    if (it + 1 < nkt) load(it + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[cur][kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[cur][kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (it + 1 < nkt) store(cur ^ 1);
    __syncthreads();
  }
  float* part = gridDim.z > 1 ? Part + (long long)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) put(C, out_f32, part, (long long)gm * N + gn, acc[i][j]);
    }
  }
}
}  // namespace f32k

// ------------------------------------------------- bf16, general layouts
// 128 × BN output tile, BK=32, 8 warps; each warp 16·FM × 32 with WMMA
// 16×16×16 bf16 fragments and f32 accumulators, two shared-memory tile
// buffers. Loads run ahead of the math: flat slabs RSTAGES - 1 tiles
// ahead through a cp.async ring of staging buffers, strided tiles one
// tile ahead through registers (2 × 16 bytes of A, up to 2 of B per
// thread). A slab is then spread into the tile by threads walking the
// tile's rows, so the scattered shared-memory writes do not collide in
// one bank.

namespace bf16k {
using namespace nvcuda;
constexpr int BM = 128, BK = 32, NT = 256, LDA = BK + 8;
// flat slabs, in elements: one that spans all of K is loaded once (up to
// 20480: all K of 128 patches rows up to K = 160, past the ResNet stem's
// 147); one per K-tile (up to 8192: BK rows of patchesᵀ or g up to 256
// wide) goes through a ring of RSTAGES buffers
constexpr int RAW_ONCE = 20480, RAW_TILE = 8192, RSTAGES = 4;

// how a tile reaches shared memory
enum Mode { VEC_C = 0, VEC_R = 1, SCALAR = 2, FLAT_C = 3, FLAT_R = 4 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   sm90::smem_u32(dst)), "l"(src) : "memory");
}

// One operand tile: ROWS × COLS of a strided matrix (element (r, c) at
// P[r*sr + c*sc], valid for r < R, c < C) into S[r*LD + c].
//  * VEC_C / VEC_R / SCALAR: each thread stages NV 16-byte registers.
//  * FLAT_C / FLAT_R: the matrix is contiguous along c (sr == C) / r
//    (sc == R) and the tile's slab — its rows (FLAT_C) or columns
//    (FLAT_R) over the whole contiguous axis — is one span of memory,
//    copied by cp.async into Raw and spread into S by convert().
template <int ROWS, int COLS, int LD>
struct Tile {
  static constexpr int NV = (ROWS * COLS / 8 + NT - 1) / NT;
  uint4 v[NV];

  __device__ __forceinline__ static void span(int r0, int c0, int R, int C,
                                              int mode, long long& lo,
                                              long long& hi) {
    if (mode == FLAT_C) {                   // rows r0.. of an (R, C) matrix
      const int r1 = r0 + ROWS < R ? r0 + ROWS : R;
      lo = (long long)r0 * C;
      hi = (long long)r1 * C;
    } else {                                // cols c0.. of a col-major one
      const int c1 = c0 + COLS < C ? c0 + COLS : C;
      lo = (long long)c0 * R;
      hi = (long long)c1 * R;
    }
  }

  // issue the loads of the tile at (r0, c0)
  __device__ __forceinline__ void load(const bf16* __restrict__ P, bf16* Raw,
                                       int r0, int c0, int R, int C,
                                       long long sr, long long sc, int mode) {
    const int tid = threadIdx.x;
    if (mode >= FLAT_C) {
      long long lo, hi;
      span(r0, c0, R, C, mode, lo, hi);
      const int n = static_cast<int>(hi - lo);
      for (int q = tid; q * 8 < n; q += NT) {
        if (q * 8 + 8 <= n) {
          cp_async16(Raw + q * 8, P + lo + q * 8);
        } else {                            // the span's ragged end
          for (int k = q * 8; k < n; ++k) Raw[k] = P[lo + k];
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int q = tid + j * NT;           // this thread's j-th vector
      uint4 x = make_uint4(0, 0, 0, 0);
      if (q < ROWS * COLS / 8) {
        if (mode == VEC_C) {
          const int gr = r0 + q / (COLS / 8), gc = c0 + (q % (COLS / 8)) * 8;
          if (gr < R && gc < C)
            x = *reinterpret_cast<const uint4*>(P + gr * sr + gc);
        } else if (mode == VEC_R) {
          const int gr = r0 + (q % (ROWS / 8)) * 8, gc = c0 + q / (ROWS / 8);
          if (gr < R && gc < C)
            x = *reinterpret_cast<const uint4*>(P + gr + gc * sc);
        } else {
          bf16* e = reinterpret_cast<bf16*>(&x);
          const bool c_fast = sc <= sr;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int i = (j * 8 + k) * NT + tid;
            if (i >= ROWS * COLS) break;
            const int gr = r0 + (c_fast ? i / COLS : i % ROWS);
            const int gc = c0 + (c_fast ? i % COLS : i / ROWS);
            if (gr < R && gc < C) e[k] = P[gr * sr + gc * sc];
          }
        }
      }
      v[j] = x;
    }
  }

  // write the loaded tile into S (every position: zeros outside the
  // matrix). A flat slab must have landed in Raw and be visible to the
  // block. Its rows past the matrix hold zeros that stay: they are
  // written only with zero_tail (each buffer's first fill, or always
  // when the rows run along K and move from tile to tile).
  __device__ __forceinline__ void store(bf16* S, const bf16* Raw, int r0,
                                        int c0, int R, int C, long long sr,
                                        long long sc, int mode,
                                        int slab_r0, int slab_c0,
                                        bool zero_tail) const {
    const int tid = threadIdx.x;
    if (mode >= FLAT_C) {
      // walk the tile row by row (c fastest): the writes to S are
      // consecutive; the slab starts at row slab_r0 (FLAT_C) or column
      // slab_c0 (FLAT_R)
      const bf16 zero = __float2bfloat16(0.f);
      const int valid = R - r0 < ROWS ? (R - r0 > 0 ? R - r0 : 0) : ROWS;
      const int n = (zero_tail ? ROWS : valid) * COLS;
#pragma unroll 4
      for (int d = tid; d < n; d += NT) {
        const int r = d / COLS, c = d % COLS;
        const int gr = r0 + r, gc = c0 + c;
        bf16 x = zero;
        if (gr < R && gc < C)
          x = mode == FLAT_C ? Raw[(gr - slab_r0) * C + gc]
                             : Raw[(gc - slab_c0) * R + gr];
        S[r * LD + c] = x;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int q = tid + j * NT;
      if (q >= ROWS * COLS / 8) break;
      const bf16* e = reinterpret_cast<const bf16*>(&v[j]);
      if (mode == VEC_C) {
        const int r = q / (COLS / 8), c = (q % (COLS / 8)) * 8;
        *reinterpret_cast<uint4*>(S + r * LD + c) = v[j];
      } else if (mode == VEC_R) {
        const int r = (q % (ROWS / 8)) * 8, c = q / (ROWS / 8);
#pragma unroll
        for (int k = 0; k < 8; ++k) S[(r + k) * LD + c] = e[k];
      } else {
        const bool c_fast = sc <= sr;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = (j * 8 + k) * NT + tid;
          if (i >= ROWS * COLS) break;
          const int r = c_fast ? i / COLS : i % ROWS;
          const int c = c_fast ? i % COLS : i / ROWS;
          S[r * LD + c] = e[k];
        }
      }
    }
  }
};

// the mode for a tile of an operand: FLAT when the matrix is contiguous
// (every slab then starts 16-byte aligned) and the slab fits its staging
// (k_is_c: the operand's C axis is K, so a FLAT_C slab spans all of K and
// is loaded once; else a FLAT_R one is); else 16-byte vectors along a
// contiguous axis of a multiple of 8; else scalars
template <int ROWS, int COLS>
static int pick_mode(const void* p, int R, int C, long long sr, long long sc,
                     bool k_is_c) {
  const bool al = aligned16(p);
  if (al && sc == 1 && sr == C &&
      (long long)ROWS * C <= (k_is_c ? RAW_ONCE : RAW_TILE))
    return FLAT_C;
  if (al && sr == 1 && sc == R &&
      (long long)COLS * R <= (k_is_c ? RAW_TILE : RAW_ONCE))
    return FLAT_R;
  if (al && sc == 1 && C % 8 == 0 && sr % 8 == 0) return VEC_C;
  if (al && sr == 1 && R % 8 == 0 && sc % 8 == 0) return VEC_R;
  return SCALAR;
}

// the fixed part of the dynamic shared memory; the flat staging follows
template <int TBM, int BN>
struct Smem {
  static constexpr int LDB = BN + 8;
  bf16 As[2][TBM * LDA];
  bf16 Bs[2][BK * LDB];
  float Cs[NT / 32][16 * 16];
};

// staging elements of one flat slab (a multiple of 8), 0 if not flat
template <int ROWS, int COLS>
static int slab_elems(int mode, int R, int C) {
  const long long n = mode == FLAT_C ? (long long)ROWS * C
                    : mode == FLAT_R ? (long long)COLS * R : 0;
  return static_cast<int>((n + 7) / 8 * 8);
}

// TBM × BN tiles: 128 × 32/64/128 by N, or 256 × 32 for a narrow product
// with 128 < M ≤ 256 (LeNet c2's dB, 150 × 16), which a 128-row tile
// would cut into a full block and a block of 22 rows
template <int TBM, int BN>
__global__ void __launch_bounds__(NT, TBM * BN <= 128 * 64 ? 2 : 1)
matmul_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   void* C, bool out_f32, float* Part, int M, int N, int K,
                   long long sam, long long sak, long long sbk,
                   long long sbn, int a_mode, int b_mode, int kt_per,
                   int raw_a, int raw_b) {
  constexpr int LDB = Smem<TBM, BN>::LDB;
  constexpr int WARPS_N = BN / 32, WARPS_M = 8 / WARPS_N;
  constexpr int WM = TBM / WARPS_M, FM = WM / 16, FN = 2;
  extern __shared__ __align__(128) uint8_t general_smem[];
  Smem<TBM, BN>& sm = *reinterpret_cast<Smem<TBM, BN>*>(general_smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * BN;
  const int kt_all = (K + BK - 1) / BK, kt0 = blockIdx.z * kt_per;
  const int nkt = kt_per < kt_all - kt0 ? kt_per : kt_all - kt0;
  // a flat slab along K (A's FLAT_C, B's FLAT_R) spans every K-tile of
  // the block: it is loaded once
  const bool a_once = a_mode == FLAT_C, b_once = b_mode == FLAT_R;
  const bool a_flat = a_mode >= FLAT_C, b_flat = b_mode >= FLAT_C;
  bf16* RawA =
      reinterpret_cast<bf16*>(general_smem + sizeof(Smem<TBM, BN>));
  bf16* RawB = RawA + (a_once ? 1 : RSTAGES) * raw_a;
  Tile<TBM, BK, LDA> ta;
  Tile<BK, BN, LDB> tb;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // the staging slot of tile t's slab
  auto raw_a_of = [&](int t) { return RawA + (a_once ? 0 : t % RSTAGES) * raw_a; };
  auto raw_b_of = [&](int t) { return RawB + (b_once ? 0 : t % RSTAGES) * raw_b; };
  // cp.async of tile t's flat slabs: one commit group per tile, empty
  // past the end, so the group count tells which tiles have landed
  auto issue = [&](int t) {
    if (t < nkt) {
      const int k0 = (kt0 + t) * BK;
      if (a_flat && (!a_once || t == 0))
        ta.load(A, raw_a_of(t), m0, a_once ? 0 : k0, M, K, sam, sak, a_mode);
      if (b_flat && (!b_once || t == 0))
        tb.load(B, raw_b_of(t), b_once ? 0 : k0, n0, K, N, sbk, sbn, b_mode);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // register loads of tile t's strided operands
  auto load = [&](int t) {
    const int k0 = (kt0 + t) * BK;
    if (!a_flat) ta.load(A, nullptr, m0, k0, M, K, sam, sak, a_mode);
    if (!b_flat) tb.load(B, nullptr, k0, n0, K, N, sbk, sbn, b_mode);
  };
  // tile t into buffer buf; its slabs have landed (wait_group, then the
  // barrier makes every thread's copies visible)
  auto store = [&](int t, int buf) {
    const int k0 = (kt0 + t) * BK;
    asm volatile("cp.async.wait_group %0;" ::"n"(RSTAGES - 2) : "memory");
    __syncthreads();
    ta.store(sm.As[buf], raw_a_of(t), m0, k0, M, K, sam, sak, a_mode, m0,
             a_once ? 0 : k0, t < 2);
    tb.store(sm.Bs[buf], raw_b_of(t), k0, n0, K, N, sbk, sbn, b_mode,
             b_once ? 0 : k0, n0, true);
  };

  for (int t = 0; t < RSTAGES - 1; ++t) issue(t);
  if (nkt > 0) {
    load(0);
    store(0, 0);
  }
  __syncthreads();
  for (int it = 0; it < nkt; ++it) {
    const int cur = it & 1;
    // slot (it + RSTAGES - 1) % RSTAGES held tile it - 1, spread into
    // the tiles before the last barrier
    issue(it + RSTAGES - 1);
    if (it + 1 < nkt) load(it + 1);        // in flight during the math
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], sm.As[cur] + (wm * WM + i * 16) * LDA +
                                          kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], sm.Bs[cur] + kk * LDB + wn * 32 +
                                          j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (it + 1 < nkt) store(it + 1, cur ^ 1);
    __syncthreads();
  }
  // epilogue: each fragment goes through a per-warp f32 scratch tile so
  // the store can mask the ragged edge and cast once
  float* part = gridDim.z > 1 ? Part + (long long)blockIdx.z * M * N : nullptr;
  float* cs = sm.Cs[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * WM + i * 16, c0 = n0 + wn * 32 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gr = r0 + e / 16, gc = c0 + e % 16;
        if (gr < M && gc < N)
          put(C, out_f32, part, (long long)gr * N + gc, cs[e]);
      }
      __syncwarp();
    }
}

template <int TBM, int BN>
static int launch(const bf16* A, const bf16* B, void* C, bool out_f32,
                  float* part, int M, int N, int K, long long sam,
                  long long sak, long long sbk, long long sbn, int splits,
                  int kt_per, cudaStream_t s) {
  constexpr int most = (int)sizeof(Smem<TBM, BN>) +
                       2 * RSTAGES * RAW_TILE * (int)sizeof(bf16);
  static bool attr = false;   // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_bf16_kernel<TBM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int a_mode = pick_mode<TBM, BK>(A, M, K, sam, sak, true);
  const int b_mode = pick_mode<BK, BN>(B, K, N, sbk, sbn, false);
  const int raw_a = slab_elems<TBM, BK>(a_mode, M, K);
  const int raw_b = slab_elems<BK, BN>(b_mode, K, N);
  const int bytes = (int)sizeof(Smem<TBM, BN>) +
                    ((a_mode == FLAT_C ? 1 : RSTAGES) * raw_a +
                     (b_mode == FLAT_R ? 1 : RSTAGES) * raw_b) *
                        (int)sizeof(bf16);
  dim3 grid((N + BN - 1) / BN, (M + TBM - 1) / TBM, splits);
  matmul_bf16_kernel<TBM, BN><<<grid, NT, bytes, s>>>(
      A, B, C, out_f32, part, M, N, K, sam, sak, sbk, sbn, a_mode, b_mode,
      kt_per, raw_a, raw_b);
  return 0;
}

// the general kernel's tile height for an M × N output
static int tile_m(int M, int N) {
  return M > BM && M <= 256 && N <= 32 ? 256 : BM;
}
}  // namespace bf16k

// ------------------------------------------------------------ the split

static long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Which kernel a product runs, from its dtype and its operands' layout.
enum Path { PATH_F32 = 0, PATH_TMA = 1, PATH_GENERAL = 2 };

struct Layouts {
  bool a_m, b_n;   // TMA path: A M-major (else K-major), B N-major
};

static int choose_path(const void* a, const void* b, int M, int N, int K,
                       long long sam, long long sak, long long sbk,
                       long long sbn, int dtype, Layouts* lay) {
  if (dtype == DT_F32) return PATH_F32;
  // TMA reads A K-major (sak == 1) or M-major (sam == 1), B N-major
  // (sbn == 1) or K-major (sbk == 1)
  const bool a_k = sm90::tma_ok(a, sak, sam, K, M, 2);
  const bool a_m = !a_k && sm90::tma_ok(a, sam, sak, M, K, 2);
  const bool b_n = sm90::tma_ok(b, sbn, sbk, N, K, 2);
  const bool b_k = !b_n && sm90::tma_ok(b, sbk, sbn, K, N, 2);
  lay->a_m = a_m;
  lay->b_n = b_n;
  return (a_k || a_m) && (b_n || b_k) && sm90::encode_fn() != nullptr
             ? PATH_TMA : PATH_GENERAL;
}

// K is cut in units of 64 (bf16: one wgmma K-tile, two of the general
// kernel's) or 16 (f32: one K-tile). A small cost model picks the split:
// per block, the K units it walks, each costing the larger of its math
// (the tensor cores at 60% of one SM's share of the card's peak for the
// wgmma kernel, 30% for the WMMA one; FP32 FMA at 50%), its operand
// bytes at one SM's share of 3 TB/s and, for the general kernel, a
// floor of 4 µs for its two 32-deep steps (each waits on staging,
// spreading and two barriers, whatever the tile's width); plus ~2 µs of
// set-up; times the waves of blocks (two resident per SM for the
// general kernel below BN 128, else one); plus, with a split, the f32
// partials written and read back and the reduce launch. Ties go to
// fewer splits. Returns the split count (1: none) and the chunk in units.
static int plan_uncached(int M, int N, int K, int dtype, int path, int sms,
                         int* chunk) {
  const int unit = dtype == DT_F32 ? 16 : 64;
  const long long units = cdiv(K, unit);
  *chunk = static_cast<int>(units);
  if (units <= 1) return 1;
  int bm = sm90::BM, bn = N > 128 ? 256 : 128, per_sm = 1;
  double rate = 989e12 * 0.6, floor_s = 0;
  if (path == PATH_F32) {
    bm = f32k::BM;
    bn = f32k::BN;
    rate = 67e12 * 0.5;
  } else if (path == PATH_GENERAL) {
    bn = N <= 32 ? 32 : N <= 64 ? 64 : 128;
    bm = bf16k::tile_m(M, N);
    per_sm = bm * bn <= 128 * 64 ? 2 : 1;
    rate = 989e12 * 0.3;
    floor_s = 4e-6;
  }
  const double tiles = (double)cdiv(M, bm) * cdiv(N, bn);
  const double bw = 3e12 / sms, esize = dtype == DT_F32 ? 4 : 2;
  const double flops = 2.0 * bm * bn * unit;
  const double bytes = (double)unit * ((M < bm ? M : bm) + (N < bn ? N : bn))
                       * esize;
  double t_unit = flops / (rate / sms);
  if (bytes / bw > t_unit) t_unit = bytes / bw;
  if (floor_s > t_unit) t_unit = floor_s;
  double best = 1e30;
  int best_s = 1;
  for (long long s = 1; s <= units && s <= 8 * sms; ++s) {
    const long long c = cdiv(units, s);
    if (cdiv(units, c) != s) continue;     // the same split as a smaller s
    double t = std::ceil(tiles * s / ((double)sms * per_sm)) *
               (c * t_unit + 2e-6);
    if (s > 1) t += 2.0 * s * (double)M * N * 4 / 3e12 + 3e-6;
    if (t < 0.97 * best) {
      best = t;
      best_s = static_cast<int>(s);
      *chunk = static_cast<int>(c);
    }
  }
  return best_s;
}

// plan_uncached, remembered per device, path and shape: a training step
// asks for the same few dozen products again and again
static int plan_split(int M, int N, int K, int dtype, int path, int* chunk) {
  struct Entry { int dev, M, N, K, key, splits, chunk; };
  static Entry cache[256];
  static int sms_of[64];
  static std::mutex mu;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  const int key = dtype * 4 + path;
  const unsigned h = ((unsigned)M * 73856093u) ^ ((unsigned)N * 19349663u) ^
                     ((unsigned)K * 83492791u) ^ ((unsigned)(dev * 8 + key));
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = cache[h % 256];
  if (e.splits > 0 && e.dev == dev && e.M == M && e.N == N && e.K == K &&
      e.key == key) {
    *chunk = e.chunk;
    return e.splits;
  }
  if (sms_of[dev] <= 0 &&
      cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  if (sms_of[dev] <= 0) return 0;
  const int splits = plan_uncached(M, N, K, dtype, path, sms_of[dev], chunk);
  e = Entry{dev, M, N, K, key, splits, *chunk};
  return splits;
}

extern "C" {

// How many ways lmr_matmul splits K for this product on the current
// device (1: no split; 0: the device could not be queried). It takes the
// operands' layout too: that picks the kernel, and the kernels split
// differently. Above 1 the caller passes f32 scratch of splits·M·N as
// `part`.
int lmr_matmul_splits(const void* a, const void* b, int M, int N, int K,
                      long long sam, long long sak, long long sbk,
                      long long sbn, int dtype) {
  Layouts lay;
  const int path = choose_path(a, b, M, N, K, sam, sak, sbk, sbn, dtype,
                               &lay);
  int chunk = 0;
  return plan_split(M, N, K, dtype, path, &chunk);
}

// Returns cudaGetLastError() after the launches (0 = launched).
int lmr_matmul(const void* a, const void* b, void* c, void* part, int M,
               int N, int K, long long sam, long long sak, long long sbk,
               long long sbn, int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((in_dtype != DT_F32 && in_dtype != DT_BF16) ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const bool out_f32 = out_dtype == DT_F32;
  Layouts lay;
  const int path = choose_path(a, b, M, N, K, sam, sak, sbk, sbn, in_dtype,
                               &lay);
  int chunk = 0;
  const int splits = plan_split(M, N, K, in_dtype, path, &chunk);
  if (splits < 1 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  float* P = static_cast<float*>(part);
  float* kpart = splits > 1 ? P : nullptr;
  if (in_dtype == DT_F32) {
    dim3 grid(cdiv(N, f32k::BN), cdiv(M, f32k::BM), splits);
    f32k::matmul_f32_kernel<<<grid, f32k::NT, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), c,
        out_f32, kpart, M, N, K, sam, sak, sbk, sbn, chunk);
  } else {
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    const bool a_m = lay.a_m, b_n = lay.b_n;
    const int bn = N > 128 ? 256 : 128;
    int rc = 0;
    if (path == PATH_TMA) {
      CUtensorMap ta, tb;
      if (!(a_m ? sm90::make_map(&ta, a, true, M, K, sak, 64, 64)
                : sm90::make_map(&ta, a, true, K, M, sam, 64, 128)) ||
          !(b_n ? sm90::make_map(&tb, b, true, N, K, sbk, 64, 64)
                : sm90::make_map(&tb, b, true, K, N, sbn, 64, bn)))
        return cudaErrorInvalidValue;
#define LMR_WGMMA(BN, AM, BNM)                                              \
  rc = sm90::launch_wgmma<BN, AM, BNM, false>(ta, tb, ta, c, out_f32,       \
                                              kpart, nullptr, M, N, K,      \
                                              splits, chunk, s)
      if (bn == 256) {
        if (a_m) { if (b_n) LMR_WGMMA(256, true, true); else LMR_WGMMA(256, true, false); }
        else     { if (b_n) LMR_WGMMA(256, false, true); else LMR_WGMMA(256, false, false); }
      } else {
        if (a_m) { if (b_n) LMR_WGMMA(128, true, true); else LMR_WGMMA(128, true, false); }
        else     { if (b_n) LMR_WGMMA(128, false, true); else LMR_WGMMA(128, false, false); }
      }
#undef LMR_WGMMA
      if (rc != 0) return rc;
    } else {
      const int kt_per = chunk * (64 / bf16k::BK);
#define LMR_GENERAL(TBM, BN)                                                 \
  rc = bf16k::launch<TBM, BN>(A, B, c, out_f32, kpart, M, N, K, sam, sak,    \
                              sbk, sbn, splits, kt_per, s)
      if (bf16k::tile_m(M, N) == 256) LMR_GENERAL(256, 32);
      else if (N <= 32) LMR_GENERAL(128, 32);
      else if (N <= 64) LMR_GENERAL(128, 64);
      else LMR_GENERAL(128, 128);
#undef LMR_GENERAL
      if (rc != 0) return rc;
    }
  }
  if (splits > 1) {
    const long long mn = (long long)M * N;
    splitk_reduce_kernel<<<(unsigned)cdiv(mn, 256), 256, 0, s>>>(
        P, c, out_f32, splits, mn);
  }
  return static_cast<int>(cudaGetLastError());
}

// 1 when this build can encode TMA descriptors on this machine (the
// driver exposes cuTensorMapEncodeTiled), else 0.
int lmr_matmul_tma_available() { return sm90::encode_fn() != nullptr; }

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
