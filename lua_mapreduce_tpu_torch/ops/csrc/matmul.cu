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
// over K up to 802,816) the bytes of their two operands; the f32
// products of k-means and ALS ((10⁶,128)·(128,1024), (1024,10⁶)·(10⁶,128),
// (6040,3706)·(3706,4096) and its transpose) the FP32 FMA rate, 67
// TFLOP/s; the digits f32 products (a few MFLOP) latency and launch.
//
// What the design does about it:
//  * Split-K, decided here (lmr_matmul_splits, from M, N, K, the dtype and
//    the device's SM count): when the output tiles leave SMs idle, K is
//    cut into equal chunks of whole K units, each (tile, chunk) block
//    writes an f32 partial, and splitk_reduce_kernel sums the partials in
//    split order and casts once — no atomics, so the result is
//    bit-identical from run to run. The caller allocates the scratch.
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
//  * f32 inputs use full FP32 FMAs, never TF32, in one of three kernels
//    chosen by the output's shape alone (f32_path):
//    - an output of at most F32_SMALL_MN elements (the digits step's
//      products) takes the 64×64 kernel f32k: 256 threads, a 4×4
//      accumulator each, the next K-tile staged in registers. Its few
//      blocks are split along K and it is bound by latency, not by FMAs.
//    - any other output takes f32w, a 128 × 128 tile (128 × 64 when N ≤
//      64: ALS's (w·r)·V) with an 8×8 accumulator per thread, 256 (128)
//      threads. Each thread's rows are ty·4..+3 and 64 + ty·4..+3, its
//      columns tx·4..+3 and BN/2 + tx·4..+3, so every k of the tile
//      costs it four 16-byte shared loads (two of A, two of B) for 64
//      FMAs. The loads are conflict-free: lanes of one quarter-warp read
//      either one address (A: they share ty) or eight consecutive 16-byte
//      words (B).
//    - f32w's operands reach shared memory only through cp.async, in a
//      ring of F32_STAGES K-tiles of F32_BK (tiles t + 1 and t + 2 are in
//      flight while tile t is computed; one barrier per tile; on the card
//      neither a fourth stage nor 32-deep tiles helped). Both tiles are
//      kept with the output's axis contiguous, As[k][m] and Bs[k][n],
//      row pitch + F32_PAD floats. How a tile gets there is chosen per
//      operand from its layout (copy_mode): in place in 16-byte pieces
//      when its M (or N) axis has unit stride and the rows are 16-byte
//      aligned (one_hotᵀ, x as B, V⊗V); in 8-byte pieces when they are
//      only 8-byte aligned (ALS's Wᵀ, whose 3,706-float rows are not
//      16-byte aligned); element by element, transposed on the way in,
//      when K has the unit stride (x and W as A, cᵀ and Vᵀ as B): each
//      warp copies 8 consecutive k of 4 rows, so the global reads are 4
//      full 32-byte sectors and the pitch of 132 puts the 32 writes in
//      32 banks (4k + m). (A k-pair layout filled in 8-byte pieces, which
//      halves those copies, measured slower on the card.) Ragged edges
//      come back as zeros from cp.async's zero fill; nothing is staged
//      through registers.
//    - f32w's epilogue writes each thread's runs of 4 columns as one
//      16-byte store (8 bytes in bf16), a warp covering 256 contiguous
//      bytes of a row, masked at the ragged edge; split-K partials keep
//      the output's layout. The split counts the blocks resident per SM
//      from the kernel's registers and shared memory (the occupancy
//      query) at F32W_FFMA_RATE, the rate the kernel reaches on the
//      card, so one_hotᵀ·x's 8 output tiles are split 33 ways to put a
//      block in each of the 264 resident slots of 132 SMs.
//  * Nothing is padded: ragged edges are masked in the loads (or come
//    back as zeros from TMA and cp.async) and at the store.

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

// the f32 kernels' tiles
#define F32_SMALL_TILE 64
#define F32_SMALL_MN 32768
#define F32_BM 128
#define F32_BN 128
#define F32_BN_NARROW 64
#define F32_BK 16
#define F32_STAGES 3
#define F32_PAD 4

// The small kernel: 64×64 output tile, BK=16, 256 threads, each thread a
// 4×4 micro-tile; the next K-tile's 4 + 4 elements per thread are loaded
// into registers before the current tile is computed.

namespace f32k {
constexpr int BM = F32_SMALL_TILE, BN = F32_SMALL_TILE, BK = 16, TM = 4,
              TN = 4, NT = 256;
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

// The wide kernels (the source note): BM × BN tiles, an 8×8 accumulator
// per thread, operands through a cp.async ring, 16-byte stores.

namespace f32w {
constexpr int BK = F32_BK, STAGES = F32_STAGES, PAD = F32_PAD;

// How an operand's K-tile reaches shared memory (copy_mode): in 16- or
// 8-byte pieces along its tile axis, element by element along it, or
// element by element along K.
enum Copy { V16 = 0, V8 = 1, E4C = 2, E4K = 3 };

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes, int size) {
  const uint32_t d = sm90::smem_u32(dst);
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(bytes) : "memory");
  else if (size == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(bytes) : "memory");
}

// One operand's K-tiles into a slot S[k][c] of the ring (pitch LD =
// COLS + PAD): element (k, c) of the operand is P[k·sk + c·sc], valid for
// k < K and c < CN, zero elsewhere (a copy of 0 source bytes fills zeros
// and reads nothing; its address is then P). Each thread's copies j =
// 0..J-1 of a tile are at (kb + j·DK, cb + j·DC):
//  * V16 / V8 / E4C: consecutive threads take consecutive 4-, 2- or
//    1-float pieces of a k row, so a warp writes one run of shared memory
//    and reads one run of global memory along the tile's axis.
//  * E4K (K has the unit stride): a warp takes 8 consecutive k (fastest)
//    of 4 rows, so its reads are 4 full 32-byte sectors; its writes, at
//    words k·LD + c with LD ≡ 4 (mod 32), fall in banks 4k + c: all 32
//    once (the transpose on the way in).
template <int COLS, int NT, int MODE>
struct Loader {
  static constexpr int W = MODE == V16 ? 4 : MODE == V8 ? 2 : 1;
  static constexpr int LD = COLS + PAD;
  static constexpr int J = BK * COLS / W / NT;
  static constexpr int KG = BK / 8;          // E4K: 8-deep k groups a tile
  static constexpr int DK = MODE == E4K ? 0 : NT / (COLS / W);
  static constexpr int DC = MODE == E4K ? 4 * (NT / 32) / KG : 0;
  static_assert(BK * COLS % (W * NT) == 0, "a K-tile is whole rounds");
  static_assert(LD % 32 == 4, "E4K's writes and the fragment reads");
  static_assert(MODE == E4K ? (NT / 32) % KG == 0
                            : NT % (COLS / W) == 0, "copies in a line");
  const float* p;       // element (kb, c0 + cb) of the operand
  long long sk, sc;
  int kb, cb, c0;

  __device__ __forceinline__ Loader(const float* P, int c0_, long long sk_,
                                    long long sc_)
      : sk(sk_), sc(sc_), c0(c0_) {
    const int tid = threadIdx.x;
    if (MODE == E4K) {
      kb = tid % 8 + 8 * ((tid / 32) % KG);
      cb = 4 * ((tid / 32) / KG) + (tid / 8) % 4;
    } else {
      kb = tid / (COLS / W);
      cb = (tid % (COLS / W)) * W;
    }
    p = P + (long long)kb * sk + (long long)(c0 + cb) * sc;
  }

  // issue the copies of the tile at k0 into S
  __device__ __forceinline__ void issue(float* S, const float* P, int k0,
                                        int K, int CN) const {
    const float* q = p + (long long)k0 * sk;
    const int kl = K - k0 - kb, cl = CN - c0 - cb;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      int n = cl - j * DC;          // floats to read
      n = kl > j * DK ? (n < 0 ? 0 : n > W ? W : n) : 0;
      const float* src =
          n > 0 ? q + (long long)(j * DK) * sk + (long long)(j * DC) * sc
                : P;
      cp_async(S + (kb + j * DK) * LD + cb + j * DC, src, n * 4, W * 4);
    }
  }
};

// A thread's fragments of k steps k0 and k0 + 1: its 8 rows of A, ty·4 +
// (0..3) and BM/2 + ty·4 + (0..3), or its 8 columns of B, tx·4 + (0..3)
// and BN/2 + tx·4 + (0..3); four 16-byte reads. A's lanes of one
// quarter-warp share ty (one address), B's read 8 consecutive 16-byte
// words: no read has a bank conflict.
template <int COLS>
__device__ __forceinline__ void fragments(const float* S, int k0, int t,
                                          float* f0, float* f1) {
  constexpr int LD = COLS + PAD;
  const float* s0 = S + k0 * LD + t * 4;
  const float4 x0 = *reinterpret_cast<const float4*>(s0);
  const float4 x1 = *reinterpret_cast<const float4*>(s0 + COLS / 2);
  const float4 y0 = *reinterpret_cast<const float4*>(s0 + LD);
  const float4 y1 = *reinterpret_cast<const float4*>(s0 + LD + COLS / 2);
  f0[0] = x0.x; f0[1] = x0.y; f0[2] = x0.z; f0[3] = x0.w;
  f0[4] = x1.x; f0[5] = x1.y; f0[6] = x1.z; f0[7] = x1.w;
  f1[0] = y0.x; f1[1] = y0.y; f1[2] = y0.z; f1[3] = y0.w;
  f1[4] = y1.x; f1[5] = y1.y; f1[6] = y1.z; f1[7] = y1.w;
}

// four consecutive outputs from a 16-byte aligned `off` (8 bytes in bf16)
__device__ __forceinline__ void put4(void* C, bool out_f32, float* Part,
                                     long long off, const float (&v)[8],
                                     int j) {
  const float4 x = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  if (Part != nullptr) {
    *reinterpret_cast<float4*>(Part + off) = x;
  } else if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(C) + off) = x;
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[j], v[j + 1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[j + 2], v[j + 3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(C) + off) = w;
  }
}

template <int BM, int BN>
struct Tile {
  static constexpr int NT = (BM / 8) * (BN / 8);
  static constexpr int LDA = BM + PAD, LDB = BN + PAD;
  static constexpr int SMEM = STAGES * BK * (LDA + LDB) * (int)sizeof(float);
};

template <int BM, int BN, int AMODE, int BMODE>
__global__ void __launch_bounds__(Tile<BM, BN>::NT,
                                  512 / Tile<BM, BN>::NT)
matmul_f32_wide(const float* __restrict__ A, const float* __restrict__ B,
                void* C, bool out_f32, float* Part, int M, int N, int K,
                long long sam, long long sak, long long sbk, long long sbn,
                int kt_per) {
  constexpr int NT = Tile<BM, BN>::NT, LDA = Tile<BM, BN>::LDA,
                LDB = Tile<BM, BN>::LDB, TX = BN / 8;
  extern __shared__ __align__(16) float wide_smem[];
  float* As = wide_smem;                       // STAGES slots of BK·LDA
  float* Bs = wide_smem + STAGES * BK * LDA;   // STAGES slots of BK·LDB
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_all = (K + BK - 1) / BK, kt0 = blockIdx.z * kt_per;
  const int nkt = kt_per < kt_all - kt0 ? kt_per : kt_all - kt0;
  const Loader<BM, NT, AMODE> la(A, m0, sak, sam);
  const Loader<BN, NT, BMODE> lb(B, n0, sbk, sbn);

  // tile t's copies, one commit group per tile (empty past the end, so
  // the group count tells which tiles have landed)
  auto issue = [&](int t) {
    if (t < nkt) {
      const int s = t % STAGES, k0 = (kt0 + t) * BK;
      la.issue(As + s * BK * LDA, A, k0, K, M);
      lb.issue(Bs + s * BK * LDB, B, k0, K, N);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  for (int t = 0; t < nkt; ++t) {
    // tile t has landed for every thread, and every thread is done with
    // tile t - 1, whose slot the next issue refills
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    issue(t + STAGES - 1);
    const float* as = As + (t % STAGES) * BK * LDA;
    const float* bs = Bs + (t % STAGES) * BK * LDB;
#pragma unroll
    for (int k = 0; k < BK; k += 2) {
      float a0[8], a1[8], b0[8], b1[8];
      fragments<BM>(as, k, ty, a0, a1);
      fragments<BN>(bs, k, tx, b0, b1);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a0[i], b0[j], acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a1[i], b1[j], acc[i][j]);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");

  // C and Part are fresh contiguous (M, N) buffers: a run of 4 outputs
  // starting at a column multiple of 4 is 16-byte aligned when N is a
  // multiple of 4. A warp's stores of one run cover 256 contiguous bytes
  // of each of 2 rows (128 bytes of each of 4 in the 128 × 64 tile).
  float* part = gridDim.z > 1 ? Part + (long long)blockIdx.z * M * N : nullptr;
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty * 4 + (i & 3) + (i >> 2) * (BM / 2);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const int gn = n0 + tx * 4 + (j / 4) * (BN / 2);
      const long long off = (long long)gm * N + gn;
      if (vec && gn + 4 <= N) {
        put4(C, out_f32, part, off, acc[i], j);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < N) put(C, out_f32, part, off + e, acc[i][j + e]);
      }
    }
  }
}

// the copy mode of an operand whose tile axis c (M of A, N of B) has
// stride sc and whose K axis has stride sk (the source note)
static int copy_mode(const void* p, long long sc, long long sk) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (sc == 1) {
    if (a % 16 == 0 && sk % 4 == 0) return V16;
    if (a % 8 == 0 && sk % 2 == 0) return V8;
    return E4C;
  }
  return sk < sc ? E4K : E4C;
}

// Every instantiation of the kernel for a tile shape, by copy modes: the
// mode pair is a template argument, so each kernel carries the address
// arithmetic of its own layouts only.
template <int BM, int BN>
struct Kernels {
  using Fn = void (*)(const float*, const float*, void*, bool, float*, int,
                      int, int, long long, long long, long long, long long,
                      int);
  template <int AM>
  static Fn row(int bm) {
    return bm == V16 ? matmul_f32_wide<BM, BN, AM, V16>
         : bm == V8 ? matmul_f32_wide<BM, BN, AM, V8>
         : bm == E4C ? matmul_f32_wide<BM, BN, AM, E4C>
         : matmul_f32_wide<BM, BN, AM, E4K>;
  }
  static Fn of(int am, int bm) {
    return am == V16 ? row<V16>(bm) : am == V8 ? row<V8>(bm)
         : am == E4C ? row<E4C>(bm) : row<E4K>(bm);
  }
};

// each instantiation's shared-memory limit, set once per device
template <int BM, int BN>
static int prepare(int dev) {
  static bool done[64];
  static std::mutex mu;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    for (int am = 0; am < 4; ++am)
      for (int bm = 0; bm < 4; ++bm) {
        const cudaError_t e = cudaFuncSetAttribute(
            Kernels<BM, BN>::of(am, bm),
            cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BM, BN>::SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);

      }
    done[dev] = true;
  }
  return 0;
}

// blocks of the tile shape's kernels resident on one SM of device dev,
// from their registers and shared memory: the fewest over the
// instantiations (0: the query failed)
template <int BM, int BN>
static int resident(int dev) {
  if (prepare<BM, BN>(dev) != 0) return 0;
  int least = 1 << 30;
  for (int am = 0; am < 4; ++am)
    for (int bm = 0; bm < 4; ++bm) {
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, Kernels<BM, BN>::of(am, bm), Tile<BM, BN>::NT,
              Tile<BM, BN>::SMEM) != cudaSuccess)
        return 0;
      if (n < least) least = n;
    }
  return least;
}

template <int BM, int BN>
static int launch(const float* A, const float* B, void* C, bool out_f32,
                  float* part, int M, int N, int K, long long sam,
                  long long sak, long long sbk, long long sbn, int splits,
                  int kt_per, cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = prepare<BM, BN>(dev);
  if (rc != 0) return rc;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  Kernels<BM, BN>::of(copy_mode(A, sam, sak), copy_mode(B, sbn, sbk))
      <<<grid, Tile<BM, BN>::NT, Tile<BM, BN>::SMEM, s>>>(
          A, B, C, out_f32, part, M, N, K, sam, sak, sbk, sbn, kt_per);
  return 0;
}
}  // namespace f32w

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

// Which kernel a product runs: for f32 from the output's shape alone,
// for bf16 from the operands' layout. The values are lmr_matmul_plan's
// kernel codes.
enum Path { PATH_F32 = 0, PATH_F32_WIDE = 1, PATH_F32_NARROW = 2,
            PATH_TMA = 3, PATH_GENERAL = 4 };

static int f32_path(int M, int N) {
  if ((long long)M * N <= F32_SMALL_MN) return PATH_F32;
  return N <= F32_BN_NARROW ? PATH_F32_NARROW : PATH_F32_WIDE;
}

struct Layouts {
  bool a_m, b_n;   // TMA path: A M-major (else K-major), B N-major
};

static int choose_path(const void* a, const void* b, int M, int N, int K,
                       long long sam, long long sak, long long sbk,
                       long long sbn, int dtype, Layouts* lay) {
  if (dtype == DT_F32) return f32_path(M, N);
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
// kernel's) or 16 (f32: one K-tile). For every kernel but f32w (below) a
// small cost model picks the split:
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

// f32w's FMA rate on the whole card, per second: what the 128 × 128
// kernel reaches on an H100 SXM at 700 W where nothing but its FMAs
// bounds it, one_hotᵀ·x (2.6·10¹¹ FLOP in 5.9 ms, chip_smoke.py phase 2)
constexpr double F32W_FFMA_RATE = 44e12;

// The split of an f32w product whose BM × bn tiles fit per_sm to an SM.
// A block's K unit (one F32_BK tile) takes its 2·BM·bn·F32_BK FLOP at its
// share of the SM's rate — the SM's 1/sms of F32W_FFMA_RATE, divided
// among per_sm blocks — or its operand bytes at its share of 3 TB/s,
// whichever is longer; a block adds ~3 µs of pipeline fill and
// epilogue; the blocks run in waves of sms·per_sm; a split adds its f32
// partials written and read back and the reduce launch. Ties go to
// fewer splits.
static int plan_f32_wide(int M, int N, int K, int bn, int per_sm, int sms,
                         int* chunk) {
  const long long units = cdiv(K, F32_BK);
  *chunk = static_cast<int>(units);
  if (units <= 1) return 1;
  const double slots = (double)sms * per_sm;
  const double tiles = (double)cdiv(M, F32_BM) * cdiv(N, bn);
  double t_unit = 2.0 * F32_BM * bn * F32_BK / (F32W_FFMA_RATE / slots);
  const double t_bytes = (double)F32_BK * (F32_BM + bn) * 4 / (3e12 / slots);
  if (t_bytes > t_unit) t_unit = t_bytes;
  double best = 1e30;
  int best_s = 1;
  for (long long s = 1; s <= units && s <= 8 * sms; ++s) {
    const long long c = cdiv(units, s);
    if (cdiv(units, c) != s) continue;     // the same split as a smaller s
    double t = std::ceil(tiles * s / slots) * (c * t_unit + 3e-6);
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
  const int key = dtype * 8 + path;
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
  int splits;
  if (path == PATH_F32_WIDE || path == PATH_F32_NARROW) {
    const bool wide = path == PATH_F32_WIDE;
    const int per_sm = wide ? f32w::resident<F32_BM, F32_BN>(dev)
                            : f32w::resident<F32_BM, F32_BN_NARROW>(dev);
    if (per_sm <= 0) return 0;
    splits = plan_f32_wide(M, N, K, wide ? F32_BN : F32_BN_NARROW, per_sm,
                           sms_of[dev], chunk);
  } else {
    splits = plan_uncached(M, N, K, dtype, path, sms_of[dev], chunk);
  }
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

// What lmr_matmul runs for this product on the current device: plan[0]
// the kernel (a Path), plan[1] the split (0: the device could not be
// queried), plan[2] the chunk in K units, plan[3] and plan[4] how A's and
// B's tiles reach shared memory (f32w's Copy; -1 for the other kernels).
int lmr_matmul_plan(const void* a, const void* b, int M, int N, int K,
                    long long sam, long long sak, long long sbk,
                    long long sbn, int dtype, int* plan) {
  Layouts lay;
  const int path = choose_path(a, b, M, N, K, sam, sak, sbk, sbn, dtype,
                               &lay);
  int chunk = 0;
  const bool wide = path == PATH_F32_WIDE || path == PATH_F32_NARROW;
  plan[0] = path;
  plan[1] = plan_split(M, N, K, dtype, path, &chunk);
  plan[2] = chunk;
  plan[3] = wide ? f32w::copy_mode(a, sam, sak) : -1;
  plan[4] = wide ? f32w::copy_mode(b, sbn, sbk) : -1;
  return 0;
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
  if (path == PATH_F32) {
    dim3 grid(cdiv(N, f32k::BN), cdiv(M, f32k::BM), splits);
    f32k::matmul_f32_kernel<<<grid, f32k::NT, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), c,
        out_f32, kpart, M, N, K, sam, sak, sbk, sbn, chunk);
  } else if (path == PATH_F32_WIDE || path == PATH_F32_NARROW) {
    const float* A = static_cast<const float*>(a);
    const float* B = static_cast<const float*>(b);
    const int rc =
        path == PATH_F32_WIDE
            ? f32w::launch<F32_BM, F32_BN>(A, B, c, out_f32, kpart, M, N, K,
                                           sam, sak, sbk, sbn, splits,
                                           chunk, s)
            : f32w::launch<F32_BM, F32_BN_NARROW>(A, B, c, out_f32, kpart,
                                                  M, N, K, sam, sak, sbk,
                                                  sbn, splits, chunk, s);
    if (rc != 0) return rc;
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
