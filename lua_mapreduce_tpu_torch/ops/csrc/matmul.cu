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
//  * The plan, decided here (plan_of; lmr_matmul_plan_ex says it): the
//    kernel from the dtype and the layout, then the split and, for bf16,
//    the tile, the epilogue and how a split is summed, from M, N, K and
//    the device's occupancy (bf16_plan, a cost model whose rates are
//    what the kernels reach on the H100). When the output tiles leave
//    SMs idle, K is cut into equal chunks of whole K units. A split of
//    the wgmma kernel into 2-8 chunks (the portable cluster size) may
//    run as one thread block cluster a tile, summed through distributed
//    shared memory in rank order (gemm_sm90.cuh), where the plan finds
//    that faster; any other split writes f32 partials to a slab that
//    splitk_reduce_kernel sums in split order and casts once
//    (the caller allocates the slab: lmr_matmul_slab). No atomics, so
//    every result is bit-identical from run to run.
//  * bf16 operands that TMA can read (16-byte aligned base, unit stride
//    along one axis, the other stride a multiple of 8 elements) take the
//    pipelined wgmma mainloop of gemm_sm90.cuh, in any of the four
//    major-ness combinations: x·W, g·Wᵀ (B K-major), hᵀ·g (A M-major).
//    Its tile is 128 × 64 for N <= 64 (ResNet's first stage, the stem's
//    and LeNet c2's products: no 128-wide tile of zeros), 128 × 128 for
//    N <= 128, else 128 × 128 or 128 × 256 by the cost model; a 64- or
//    128-wide unsplit tile stores C through TMA, overlapped with the
//    next tile's math (the dA products' 1-8 K-tiles a tile would
//    otherwise wait on their stores). ops/conv.py gives the patch matrix
//    a 16-byte row pitch (the stem's 147 columns at 152, LeNet c2's 150
//    at 152), so that its products take this kernel too.
//  * Other bf16 layouts (LeNet c1's W and g, rows of 6; unaligned views)
//    take matmul_bf16_kernel (the general kernel): the same tensor cores
//    through wgmma from shared memory, its tiles written there by the
//    block in the swizzled layout wgmma reads. Each conv operand is a
//    contiguous matrix or a row-pitched one, so the slab a tile needs —
//    64 rows of g, 64 columns of patchesᵀ, or all K of 128 patches rows
//    — is one span of memory: cp.async copies it in 16-byte pieces into
//    a staging ring, and the block spreads it into the tile, a 16-byte
//    unit at a time where the pitch is a multiple of 8. Other layouts
//    are read in 16-byte vectors along a contiguous axis whose extent
//    and pitch are multiples of 8, else element by element.
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
#include <stdint.h>

#include <cmath>
#include <mutex>

#include "gemm_sm90.cuh"

using bf16 = __nv_bfloat16;
using sm90::aligned16;
using sm90::EPI_REGS;
using sm90::EPI_TMA;

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
// The layouts TMA cannot read (the source note): a 128 × BN output tile
// (BN 64 for N <= 64, else 128) of two warpgroups, each 64 rows, on
// wgmma m64nBNk16 from shared memory, K-tiles of 64. Each K-tile of A
// and B is written into shared memory in the 128-byte-swizzled layout
// wgmma reads (the one TMA would write), in 16-byte units of 8 elements
// along whichever axis the operand is contiguous in: A K-major or
// M-major, B N-major or K-major, so a unit is one 16-byte read of a
// staged slab or of device memory wherever the pitch allows it. A tile
// comes from one of:
//  * a flat slab (FLAT_C / FLAT_R): the operand is contiguous along one
//    axis with a row pitch of at least its extent (the conv operands:
//    patches rows of 75, 80 or 152, g rows of 6 or 16), so the rows a
//    tile needs are one span of memory. cp.async copies the span in
//    16-byte pieces (its start is 16-byte aligned: tiles start at
//    multiples of 64 rows) into a staging ring of RSTAGES slots, tiles
//    RSTAGES - 1 ahead; a span along K that holds every K-tile of the
//    block (A's rows, B's columns) is loaded once. The block then
//    spreads it into the swizzled tile: one 16-byte load a unit where the
//    pitch is a multiple of 8, else element by element.
//  * registers (VEC_C / VEC_R: 16-byte vectors along a contiguous axis
//    whose extent and pitch are multiples of 8; SCALAR: elements), one
//    tile ahead.
// Two tile buffers: tile t is spread into buffer t % 2 while the wgmma
// group of tile t - 1 runs on the other; a warpgroup waits for the group
// of tile t - 2 before the block overwrites its buffer. Two barriers a
// K-tile of 64 (the first kernel's WMMA steps took two a 32-deep step).

namespace bf16k {
constexpr int BM = 128, BK = 64, NT = 256;
// flat slabs, in elements: one that spans all of K is loaded once (up to
// GEN_RAW_ONCE: all K of 128 patches rows at a pitch up to 160); one per
// K-tile (up to GEN_RAW_TILE: 64 rows of g, or 64 columns of patchesᵀ, at
// a pitch up to 128) goes through a ring of GEN_RSTAGES slots
#define GEN_RAW_ONCE 20480
#define GEN_RAW_TILE 8192
#define GEN_RSTAGES 4
constexpr int RAW_ONCE = GEN_RAW_ONCE, RAW_TILE = GEN_RAW_TILE,
              RSTAGES = GEN_RSTAGES;

// how a tile reaches shared memory
enum Mode { VEC_C = 0, VEC_R = 1, SCALAR = 2, FLAT_C = 3, FLAT_R = 4 };

// 16 bytes into shared memory, of which the first `bytes` are read (the
// rest zero-filled)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   sm90::smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// An (R, C) operand, element (r, c) at P[r·sr + c·sc]. A is (M, K), B
// (K, N). cm: its units run along C (A K-major, B N-major), else along R.
struct Opnd {
  const bf16* P;
  int R, C, mode;
  long long sr, sc;
  bool cm;
};

// Unit q of a ROWS × COLS tile at (r0, c0): its place (y, u) in the
// tile (u: the unit along the contiguous axis) and its first element.
template <int ROWS, int COLS>
__device__ __forceinline__ void unit_at(bool cm, int q, int r0, int c0,
                                        int& y, int& u, int& r, int& c) {
  if (cm) {
    u = q % (COLS / 8);
    y = q / (COLS / 8);
    r = r0 + y;
    c = c0 + 8 * u;
  } else {
    u = q % (ROWS / 8);
    y = q / (ROWS / 8);
    c = c0 + y;
    r = r0 + 8 * u;
  }
}

// Byte offset of unit (y, u) in the swizzled tile: rows of 128 bytes
// along y, in chunks of 64 elements along the contiguous axis (the
// layout of TMA's 128-byte-swizzled boxes of 64 × rows)
template <int ROWS, int COLS>
__device__ __forceinline__ uint32_t unit_off(bool cm, int y, int u) {
  const int ylen = cm ? ROWS : COLS;
  return (u >> 3) * (ylen * 128) + y * 128 + (((u & 7) ^ (y & 7)) << 4);
}

// a unit from device memory (the register modes), zeros outside
__device__ __forceinline__ uint4 load_unit(const Opnd& o, int r, int c) {
  uint4 x = make_uint4(0, 0, 0, 0);
  if (o.mode == VEC_C) {
    if (r < o.R && c < o.C)
      x = *reinterpret_cast<const uint4*>(o.P + r * o.sr + c);
  } else if (o.mode == VEC_R) {
    if (r < o.R && c < o.C)
      x = *reinterpret_cast<const uint4*>(o.P + r + c * o.sc);
  } else {
    bf16* e = reinterpret_cast<bf16*>(&x);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (r < o.R && c + k < o.C) e[k] = o.P[r * o.sr + (c + k) * o.sc];
  }
  return x;
}

// a unit from a staged slab whose first row (FLAT_C) or column (FLAT_R)
// is slab0, zeros outside
__device__ __forceinline__ uint4 raw_unit(const bf16* Raw, const Opnd& o,
                                          int r, int c, int slab0) {
  uint4 x = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&x);
  if (o.mode == FLAT_C) {
    if (r >= o.R) return x;
    const bf16* s = Raw + (long long)(r - slab0) * o.sr + c;
    if (c + 8 <= o.C && (o.sr & 7) == 0)
      return *reinterpret_cast<const uint4*>(s);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c + k < o.C) e[k] = s[k];
  } else {
    if (c >= o.C) return x;
    const bf16* s = Raw + (long long)(c - slab0) * o.sc + r;
    if (r + 8 <= o.R && (o.sc & 7) == 0)
      return *reinterpret_cast<const uint4*>(s);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (r + k < o.R) e[k] = s[k];
  }
  return x;
}

// issue the copies of a slab: n elements from P + lo into Raw, in
// 16-byte pieces by cp.async; the span's ragged end reads only its own
// elements (no thread waits on a load here)
__device__ __forceinline__ void issue_slab(bf16* Raw, const bf16* P,
                                           long long lo, long long n) {
  for (long long q = threadIdx.x; q * 8 < n; q += NT) {
    const long long left = n - q * 8;
    cp_async16(Raw + q * 8, P + lo + q * 8,
               left >= 8 ? 16 : static_cast<int>(left) * 2);
  }
}

// the mode of an operand whose slab, were it flat, would span `extent`
// rows or columns of the tile (the source note's order: flat, vectors,
// scalars); k_is_c: its C axis is K (A), so a FLAT_C slab spans all of K
// and is loaded once, else a FLAT_R one is
static int pick_mode(const void* p, int R, int C, long long sr, long long sc,
                     int rows, int cols, bool k_is_c) {
  const bool al = aligned16(p);
  if (al && sc == 1 && sr >= C &&
      (long long)rows * sr <= (k_is_c ? RAW_ONCE : RAW_TILE))
    return FLAT_C;
  if (al && sr == 1 && sc >= R &&
      (long long)cols * sc <= (k_is_c ? RAW_TILE : RAW_ONCE))
    return FLAT_R;
  if (al && sc == 1 && C % 8 == 0 && sr % 8 == 0) return VEC_C;
  if (al && sr == 1 && R % 8 == 0 && sc % 8 == 0) return VEC_R;
  return SCALAR;
}

// staging elements of one flat slab (a multiple of 8), 0 if not flat
static int slab_elems(int mode, int rows, int cols, long long sr,
                      long long sc) {
  const long long n = mode == FLAT_C ? rows * sr
                    : mode == FLAT_R ? cols * sc : 0;
  return static_cast<int>((n + 7) / 8 * 8);
}

template <int BN>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  // two tile buffers after up to 1 KB of alignment (swizzle atoms)
  static constexpr int TILES = 1024 + 2 * (A_BYTES + B_BYTES);
};

// d += A · B for one K-tile at (sa, sb): A K-major (TA 0) or M-major,
// B N-major (TB 1) or K-major
template <int BN, int TA, int TB>
__device__ __forceinline__ void mma_tile(float (&d)[BN / 2], uint32_t sa,
                                         uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = TA ? sm90::desc_sw128(sa + kk * 2048, 8192, 1024)
                           : sm90::desc_sw128(sa + kk * 32, 16, 1024);
    const uint64_t db = TB ? sm90::desc_sw128(sb + kk * 2048, 8192, 1024)
                           : sm90::desc_sw128(sb + kk * 32, 16, 1024);
    if constexpr (BN == 128)
      sm90::wgmma_128<TA, TB>(d, da, db);
    else
      sm90::wgmma_64<TA, TB>(d, da, db);
  }
}

// two blocks an SM for the 64-wide tile (LeNet c1's products: one block
// stages while the other multiplies); the 128-wide one keeps its
// registers
template <int BN>
__global__ void __launch_bounds__(NT, BN == 64 ? 2 : 1)
matmul_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   void* C, bool out_f32, float* Part, int M, int N, int K,
                   long long sam, long long sak, long long sbk,
                   long long sbn, int a_mode, int b_mode, int kt_per,
                   int raw_a, int raw_b) {
  using SM = Smem<BN>;
  constexpr int UA = BM * BK / 8 / NT, UB = BN * BK / 8 / NT;
  extern __shared__ __align__(16) uint8_t general_smem[];
  const uint32_t raw0 = sm90::smem_u32(general_smem);
  const uint32_t tiles = (raw0 + 1023) & ~1023u;
  uint8_t* gtiles = general_smem + (tiles - raw0);
  const bool a_once = a_mode == FLAT_C, b_once = b_mode == FLAT_R;
  const bool a_flat = a_mode >= FLAT_C, b_flat = b_mode >= FLAT_C;
  bf16* RawA = reinterpret_cast<bf16*>(general_smem + SM::TILES);
  bf16* RawB = RawA + (a_flat ? (a_once ? 1 : RSTAGES) * raw_a : 0);
  const Opnd oa = {A, M, K, a_mode, sam, sak,
                   a_mode == VEC_C || a_mode == SCALAR || a_mode == FLAT_C};
  const Opnd ob = {B, K, N, b_mode, sbk, sbn,
                   b_mode == VEC_C || b_mode == SCALAR || b_mode == FLAT_C};
  const int wg = threadIdx.x / 128, t4 = threadIdx.x % 128;
  const int w4 = t4 / 32, lane = t4 % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_all = (K + BK - 1) / BK, kt0 = blockIdx.z * kt_per;
  const int nkt = kt_per < kt_all - kt0 ? kt_per : kt_all - kt0;

  // the staging slot of tile t's slab
  auto raw_a_of = [&](int t) { return RawA + (a_once ? 0 : t % RSTAGES) * raw_a; };
  auto raw_b_of = [&](int t) { return RawB + (b_once ? 0 : t % RSTAGES) * raw_b; };
  // cp.async of tile t's flat slabs: one commit group per tile, empty
  // past the end, so the group count tells which tiles have landed
  auto issue = [&](int t) {
    if (t < nkt) {
      const int k0 = (kt0 + t) * BK;
      if (a_flat && (!a_once || t == 0)) {
        if (a_once) {                      // rows m0.. of A, all of K
          const int r1 = m0 + BM < M ? m0 + BM : M;
          issue_slab(raw_a_of(t), A, (long long)m0 * sam,
                     r1 > m0 ? (long long)(r1 - 1 - m0) * sam + K : 0);
        } else {                           // columns k0.. of A, all of M
          const int c1 = k0 + BK < K ? k0 + BK : K;
          issue_slab(raw_a_of(t), A, (long long)k0 * sak,
                     (long long)(c1 - 1 - k0) * sak + M);
        }
      }
      if (b_flat && (!b_once || t == 0)) {
        if (b_once) {                      // columns n0.. of B, all of K
          const int c1 = n0 + BN < N ? n0 + BN : N;
          issue_slab(raw_b_of(t), B, (long long)n0 * sbn,
                     c1 > n0 ? (long long)(c1 - 1 - n0) * sbn + K : 0);
        } else {                           // rows k0.. of B, all of N
          const int r1 = k0 + BK < K ? k0 + BK : K;
          issue_slab(raw_b_of(t), B, (long long)k0 * sbk,
                     (long long)(r1 - 1 - k0) * sbk + N);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // register loads of tile t's units (the register modes)
  uint4 va[UA], vb[UB];
  auto load = [&](int t) {
    const int k0 = (kt0 + t) * BK;
    int y, u, r, c;
    if (!a_flat) {
#pragma unroll
      for (int i = 0; i < UA; ++i) {
        unit_at<BM, BK>(oa.cm, threadIdx.x + i * NT, m0, k0, y, u, r, c);
        va[i] = load_unit(oa, r, c);
      }
    }
    if (!b_flat) {
#pragma unroll
      for (int i = 0; i < UB; ++i) {
        unit_at<BK, BN>(ob.cm, threadIdx.x + i * NT, k0, n0, y, u, r, c);
        vb[i] = load_unit(ob, r, c);
      }
    }
  };
  // tile t into buffer buf, a 16-byte unit at a time
  auto spread = [&](int t, int buf) {
    const int k0 = (kt0 + t) * BK;
    uint8_t* ta = gtiles + buf * (SM::A_BYTES + SM::B_BYTES);
    uint8_t* tb = ta + SM::A_BYTES;
    int y, u, r, c;
#pragma unroll
    for (int i = 0; i < UA; ++i) {
      unit_at<BM, BK>(oa.cm, threadIdx.x + i * NT, m0, k0, y, u, r, c);
      const uint4 x = a_flat ? raw_unit(raw_a_of(t), oa, r, c,
                                        a_once ? m0 : k0)
                             : va[i];
      *reinterpret_cast<uint4*>(ta + unit_off<BM, BK>(oa.cm, y, u)) = x;
    }
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      unit_at<BK, BN>(ob.cm, threadIdx.x + i * NT, k0, n0, y, u, r, c);
      const uint4 x = b_flat ? raw_unit(raw_b_of(t), ob, r, c,
                                        b_once ? n0 : k0)
                             : vb[i];
      *reinterpret_cast<uint4*>(tb + unit_off<BK, BN>(ob.cm, y, u)) = x;
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < RSTAGES - 1; ++t) issue(t);
  if (nkt > 0) load(0);
  for (int t = 0; t < nkt; ++t) {
    const int buf = t & 1;
    // this warpgroup's group of tile t - 2 (buffer buf) has retired;
    // tile t's slabs have landed for this thread, then for every thread
    sm90::wgmma_wait<1>();
    asm volatile("cp.async.wait_group %0;" ::"n"(RSTAGES - 2) : "memory");
    __syncthreads();
    // the slot of tile t - 1, spread before the barrier
    issue(t + RSTAGES - 1);
    spread(t, buf);
    // generic-proxy writes, read next by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (t + 1 < nkt) load(t + 1);          // in flight during the math
    const uint32_t sa = tiles + buf * (SM::A_BYTES + SM::B_BYTES) + wg * 8192;
    const uint32_t sb = tiles + buf * (SM::A_BYTES + SM::B_BYTES) +
                        SM::A_BYTES;
    sm90::wgmma_fence();
    if (oa.cm) {
      if (ob.cm) mma_tile<BN, 0, 1>(acc, sa, sb);
      else mma_tile<BN, 0, 0>(acc, sa, sb);
    } else {
      if (ob.cm) mma_tile<BN, 1, 1>(acc, sa, sb);
      else mma_tile<BN, 1, 0>(acc, sa, sb);
    }
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc(acc);
  asm volatile("cp.async.wait_all;" ::: "memory");

  // accumulator fragment: register 4j + 2h + {0,1} of warp w4, lane l
  // holds row 16·w4 + l/4 + 8h of the warpgroup's 64, columns 8j +
  // 2(l%4) + {0,1}
  float* part = gridDim.z > 1 ? Part + (long long)blockIdx.z * M * N : nullptr;
  const int rbase = m0 + wg * 64 + w4 * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + 8 * h;
      if (row >= M) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const long long off = (long long)row * N + col;
      if (part != nullptr)
        sm90::store_pair(part + off, v0, v1, col, N);
      else if (out_f32)
        sm90::store_pair(static_cast<float*>(C) + off, v0, v1, col, N);
      else
        sm90::store_pair(static_cast<bf16*>(C) + off, v0, v1, col, N);
    }
  }
}

// the dynamic shared memory of a launch with these modes
template <int BN>
static int smem_bytes(int a_mode, int b_mode, int raw_a, int raw_b) {
  return Smem<BN>::TILES +
         ((a_mode == FLAT_C ? 1 : a_mode == FLAT_R ? RSTAGES : 0) * raw_a +
          (b_mode == FLAT_R ? 1 : b_mode == FLAT_C ? RSTAGES : 0) * raw_b) *
             (int)sizeof(bf16);
}

// The modes, staging and shared memory of a product on the general
// kernel of tile width BN
struct Staging {
  int a_mode, b_mode, raw_a, raw_b, bytes;
};
template <int BN>
static Staging staging(const void* A, const void* B, int M, int N, int K,
                       long long sam, long long sak, long long sbk,
                       long long sbn) {
  Staging s;
  s.a_mode = pick_mode(A, M, K, sam, sak, BM, BK, true);
  s.b_mode = pick_mode(B, K, N, sbk, sbn, BK, BN, false);
  s.raw_a = slab_elems(s.a_mode, BM, BK, sam, sak);
  s.raw_b = slab_elems(s.b_mode, BK, BN, sbk, sbn);
  s.bytes = smem_bytes<BN>(s.a_mode, s.b_mode, s.raw_a, s.raw_b);
  return s;
}

// the most shared memory a launch takes (two operands staged through a
// ring each): set once per instantiation
template <int BN>
static int prepare() {
  constexpr int ring = RSTAGES * RAW_TILE > RAW_ONCE ? RSTAGES * RAW_TILE
                                                      : RAW_ONCE;
  constexpr int most = Smem<BN>::TILES + 2 * ring * (int)sizeof(bf16);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_bf16_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  return 0;
}

// blocks of this launch resident on one SM (0: the query failed)
template <int BN>
static int resident(const Staging& s) {
  if (prepare<BN>() != 0) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, matmul_bf16_kernel<BN>, NT, s.bytes) != cudaSuccess)
    return 0;
  return n;
}

template <int BN>
static int launch(const bf16* A, const bf16* B, void* C, bool out_f32,
                  float* part, int M, int N, int K, long long sam,
                  long long sak, long long sbk, long long sbn, int splits,
                  int kt_per, cudaStream_t s) {
  const int rc = prepare<BN>();
  if (rc != 0) return rc;
  const Staging st = staging<BN>(A, B, M, N, K, sam, sak, sbk, sbn);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  matmul_bf16_kernel<BN><<<grid, NT, st.bytes, s>>>(
      A, B, C, out_f32, part, M, N, K, sam, sak, sbk, sbn, st.a_mode,
      st.b_mode, kt_per, st.raw_a, st.raw_b);
  return 0;
}
}  // namespace bf16k

// ------------------------------------------------------------ the plan

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

// What a product runs: its split (1: none) and chunk (K units of 64 for
// bf16, 16 for f32, a split), and for bf16 the tile width, the cluster
// (1: none; else the split, summed in the kernel) and the epilogue of an
// unsplit tile. A split without a cluster writes f32 partials to a slab
// that splitk_reduce_kernel sums.
struct Plan {
  int splits, chunk, bn, cluster, epi;
};

// f32k's split (the digits step's small products): per block, the K
// units it walks, each costing the larger of its FP32 FMAs at 50% of
// one SM's share of 67 TFLOP/s and its operand bytes at one SM's share
// of 3 TB/s; plus ~2 µs of set-up; times the waves of blocks; plus, with
// a split, the f32 partials written and read back and the reduce launch.
// Ties go to fewer splits.
static int plan_f32_small(int M, int N, int K, int sms, int* chunk) {
  const long long units = cdiv(K, 16);
  *chunk = static_cast<int>(units);
  if (units <= 1) return 1;
  const double tiles = (double)cdiv(M, f32k::BM) * cdiv(N, f32k::BN);
  const double bw = 3e12 / sms;
  const double flops = 2.0 * f32k::BM * f32k::BN * 16;
  const double bytes = 16.0 * ((M < f32k::BM ? M : f32k::BM) +
                               (N < f32k::BN ? N : f32k::BN)) * 4;
  double t_unit = flops / (67e12 * 0.5 / sms);
  if (bytes / bw > t_unit) t_unit = bytes / bw;
  double best = 1e30;
  int best_s = 1;
  for (long long s = 1; s <= units && s <= 8 * sms; ++s) {
    const long long c = cdiv(units, s);
    if (cdiv(units, c) != s) continue;     // the same split as a smaller s
    double t = std::ceil(tiles * s / (double)sms) * (c * t_unit + 2e-6);
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

// The bf16 plan's cost model: what the kernels reach on an H100 SXM at
// 700 W, fitted to a sweep of the wgmma kernel's legal plans at every
// conv trainer product it takes (PERF.md §6), in the units named.
#define BF16_PEAK_GFLOPS 989000
#define WG_RATE_PCT 60        // wgmma kernel, 128- and 256-wide tiles
#define WG64_RATE_PCT 40      // wgmma kernel, 64-wide tiles
#define GEN_RATE_PCT 40       // the general kernel
#define HBM_GBS 3000          // device memory, read or written by TMA
#define REGS_STORE_GBS 500    // C stored from registers in 4-byte pairs
#define ITEM_NS 2000          // a work item's fill and epilogue
#define CTA_NS 2000           // a general kernel block's launch and fill
#define CLUSTER_NS 4000       // a cluster's two barriers and exchange
#define GEN_STEP_NS 500       // general: a K-tile's spread, two barriers
#define SLAB_NS 5000          // the split-K reduce: its launch and pass
#define WG_MAX_CLUSTER 8
static_assert(WG_MAX_CLUSTER == sm90::MAX_CLUSTER, "the kernel's cluster");

// The plan of a bf16 product (the source note), for the wgmma kernel
// (path PATH_TMA) or the general kernel. The wgmma kernel's candidates:
// tiles 128 × bn, bn 64 (N <= 64), 64 or 128 (N <= 128), else 64, 128
// or 256; each split s of K's units of 64 (s <= 8·sms, one s per
// chunk), as a cluster (s up to WG_MAX_CLUSTER whose clusters fit:
// cl_sms[s - 1] > 0, the SMs the occupancy query lets clusters of s
// use) or a slab. A candidate's time is the longer of
//  * its math: waves of work items over the SMs (over cl_sms for a
//    cluster), an item's K-tiles each taking 2·128·bn·64 FLOP at
//    WG_RATE_PCT (WG64_RATE_PCT for bn 64) of one SM's share of the
//    peak, plus ITEM_NS (and CLUSTER_NS for a cluster), and
//  * its bytes: A and B once, C once (at REGS_STORE_GBS where it is
//    stored from registers: an unsplit tile that TMA cannot store, bn
//    256 or N % 8 != 0), a slab's partials written and read back, all
//    at HBM_GBS;
// plus SLAB_NS for a slab. An unsplit 64- or 128-wide tile whose bf16
// rows are 16-byte multiples stores C through TMA. The general kernel
// (bn 64 for N <= 64, else 128; gen_per_sm of its blocks resident an SM,
// from the occupancy query at this product's staging) takes slab splits
// only; its K-tile costs its math at GEN_RATE_PCT, shared by the blocks
// of an SM, or GEN_STEP_NS, whichever is longer, and a block CTA_NS.
// The least time wins, a candidate taking it only below 0.97 of the best
// so far: ties go to the wider tile (the 8192³ products keep their 128 ×
// 256 tile), the fewer splits, a cluster before a slab.
static Plan bf16_plan(int M, int N, int K, int path, int sms,
                      const int* cl_sms, int gen_per_sm) {
  const long long units = cdiv(K, 64);
  const double peak = BF16_PEAK_GFLOPS * 1e9, bw = HBM_GBS * 1e9;
  const double regs_bw = REGS_STORE_GBS * 1e9;
  const double ab = ((double)M * K + (double)K * N) * 2 / bw;
  const double c_bytes = (double)M * N * 2;
  Plan best = {1, static_cast<int>(units), N <= 64 ? 64 : 128, 1, EPI_REGS};
  double best_t = 1e30;
  auto consider = [&](double t, long long s, long long c, int bn, int cl,
                      int epi) {
    if (t < 0.97 * best_t) {
      best_t = t;
      best = {static_cast<int>(s), static_cast<int>(c), bn, cl, epi};
    }
  };
  if (path != PATH_TMA) {
    const int bn = N <= 64 ? 64 : 128;
    const double per = gen_per_sm > 0 ? gen_per_sm : 1;
    const double tiles = (double)cdiv(M, 128) * cdiv(N, bn);
    double t_unit = 2.0 * 128 * bn * 64 * per /
                    (peak * GEN_RATE_PCT / 100 / sms);
    if (GEN_STEP_NS * 1e-9 > t_unit) t_unit = GEN_STEP_NS * 1e-9;
    for (long long s = 1; s <= units && s <= 8 * sms; ++s) {
      const long long c = cdiv(units, s);
      if (cdiv(units, c) != s) continue;
      const double math = std::ceil(tiles * s / (sms * per)) *
                          (c * t_unit + CTA_NS * 1e-9);
      double mem = ab + c_bytes / regs_bw;
      if (s > 1) mem += 2.0 * s * (double)M * N * 4 / bw;
      double t = math > mem ? math : mem;
      if (s > 1) t += SLAB_NS * 1e-9;
      consider(t, s, c, bn, 1, EPI_REGS);
    }
    return best;
  }
  const int bns[3] = {256, 128, 64};
  for (int i = N <= 64 ? 2 : N <= 128 ? 1 : 0; i < 3; ++i) {
    const int bn = bns[i];
    const double tiles = (double)cdiv(M, 128) * cdiv(N, bn);
    const double t_mma = 2.0 * 128 * bn * 64 /
        (peak * (bn == 64 ? WG64_RATE_PCT : WG_RATE_PCT) / 100 / sms);
    const bool c_tma = bn <= 128 && N % 8 == 0;
    for (long long s = 1; s <= units && s <= 8 * sms; ++s) {
      const long long c = cdiv(units, s);
      if (cdiv(units, c) != s) continue;
      const double work = c * t_mma + ITEM_NS * 1e-9;
      if (s == 1) {
        const double math = std::ceil(tiles / sms) * work;
        const double mem = ab + c_bytes / (c_tma ? bw : regs_bw);
        consider(math > mem ? math : mem, 1, c, bn, 1,
                 c_tma ? EPI_TMA : EPI_REGS);
        continue;
      }
      if (s <= WG_MAX_CLUSTER && cl_sms[s - 1] > 0) {
        const double math = std::ceil(tiles * s / cl_sms[s - 1]) *
                            (work + CLUSTER_NS * 1e-9);
        const double mem = ab + c_bytes / bw;
        consider(math > mem ? math : mem, s, c, bn, static_cast<int>(s),
                 EPI_REGS);
      }
      const double math = std::ceil(tiles * s / sms) * work;
      const double mem = ab + c_bytes / bw +
                         2.0 * s * (double)M * N * 4 / bw;
      consider((math > mem ? math : mem) + SLAB_NS * 1e-9, s, c, bn, 1,
               EPI_REGS);
    }
  }
  return best;
}

// The SMs clusters of 1-8 wgmma CTAs can use on the current device
// (out[size - 1], the occupancy query), asked once a device: the 64-,
// 128- and 256-wide tiles all hold one CTA an SM in the same shared
// memory.
static bool wgmma_cluster_sms(int* out) {
  static int table[64][WG_MAX_CLUSTER];
  static std::mutex mu;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return false;
  std::lock_guard<std::mutex> lock(mu);
  if (table[dev][0] <= 0 &&
      !sm90::wgmma_cluster_sms<128, false, true>(table[dev]))
    return false;
  for (int i = 0; i < WG_MAX_CLUSTER; ++i) out[i] = table[dev][i];
  return true;
}

// blocks of the general kernel resident an SM for this product's staging
static int general_resident(const void* a, const void* b, int M, int N,
                            int K, long long sam, long long sak,
                            long long sbk, long long sbn) {
  if (N <= 64) {
    const bf16k::Staging s =
        bf16k::staging<64>(a, b, M, N, K, sam, sak, sbk, sbn);
    return bf16k::resident<64>(s);
  }
  const bf16k::Staging s =
      bf16k::staging<128>(a, b, M, N, K, sam, sak, sbk, sbn);
  return bf16k::resident<128>(s);
}

// The plan of a product, remembered per device, path, shape and (for the
// general kernel) residency: a training step asks for the same few dozen
// products again and again. splits 0: the device could not be queried.
static Plan plan_of(const void* a, const void* b, int M, int N, int K,
                    long long sam, long long sak, long long sbk,
                    long long sbn, int dtype, int path) {
  struct Entry { int dev, M, N, K, key, per; Plan p; };
  static Entry cache[256];
  static int sms_of[64];
  static std::mutex mu;
  Plan none = {0, 0, 0, 1, EPI_REGS};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return none;
  const int per = path == PATH_GENERAL
                      ? general_resident(a, b, M, N, K, sam, sak, sbk, sbn)
                      : 0;
  if (path == PATH_GENERAL && per <= 0) return none;
  int cl[WG_MAX_CLUSTER] = {0};
  if (path == PATH_TMA && !wgmma_cluster_sms(cl)) return none;
  const int key = dtype * 8 + path;
  const unsigned h = ((unsigned)M * 73856093u) ^ ((unsigned)N * 19349663u) ^
                     ((unsigned)K * 83492791u) ^ ((unsigned)(dev * 8 + key)) ^
                     ((unsigned)per * 2654435761u);
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = cache[h % 256];
  if (e.p.splits > 0 && e.dev == dev && e.M == M && e.N == N && e.K == K &&
      e.key == key && e.per == per)
    return e.p;
  if (sms_of[dev] <= 0 &&
      cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return none;
  const int sms = sms_of[dev];
  if (sms <= 0) return none;
  Plan p = {1, 0, 0, 1, EPI_REGS};
  if (path == PATH_F32) {
    p.splits = plan_f32_small(M, N, K, sms, &p.chunk);
  } else if (path == PATH_F32_WIDE || path == PATH_F32_NARROW) {
    const bool wide = path == PATH_F32_WIDE;
    const int per_sm = wide ? f32w::resident<F32_BM, F32_BN>(dev)
                            : f32w::resident<F32_BM, F32_BN_NARROW>(dev);
    if (per_sm <= 0) return none;
    p.splits = plan_f32_wide(M, N, K, wide ? F32_BN : F32_BN_NARROW, per_sm,
                             sms, &p.chunk);
  } else {
    p = bf16_plan(M, N, K, path, sms, cl, per);
  }
  e = Entry{dev, M, N, K, key, per, p};
  return p;
}

// The wgmma kernel on A (bf16; M-major with lay.a_m, else K-major) and
// B (N-major with lay.b_n, else K-major) at plan p. C's TMA store falls
// back to register stores where TMA cannot write C (an f32 C with N % 4
// != 0). kpart: the slab of a split without a cluster.
static int launch_tma(const void* a, const void* b, void* c, bool out_f32,
                      float* kpart, int M, int N, int K, long long sam,
                      long long sak, long long sbk, long long sbn,
                      const Layouts& lay, const Plan& p, cudaStream_t s) {
  const bool a_m = lay.a_m, b_n = lay.b_n;
  const int bn = p.bn;
  CUtensorMap ta, tb, tc;
  if (!(a_m ? sm90::make_map(&ta, a, M, K, sak, 64, 64)
            : sm90::make_map(&ta, a, K, M, sam, 64, 128)) ||
      !(b_n ? sm90::make_map(&tb, b, N, K, sbk, 64, 64)
            : sm90::make_map(&tb, b, K, N, sbn, 64, bn)))
    return cudaErrorInvalidValue;
  int epi = p.epi;
  if (epi == sm90::EPI_TMA &&
      !(sm90::tma_store_ok(c, N, out_f32) &&
        sm90::make_map_c(&tc, c, out_f32, M, N)))
    epi = sm90::EPI_REGS;
  if (epi != sm90::EPI_TMA) tc = ta;    // read by no instantiation here
  int rc = cudaErrorInvalidValue;
#define LMR_WGMMA(BN, AM, BNM, CL)                                          \
  rc = sm90::launch_wgmma<BN, AM, BNM, CL>(                                 \
      ta, tb, tc, c, out_f32, kpart, M, N, K, p.splits, p.chunk, s, epi,    \
      p.cluster)
#define LMR_WGMMA_BN(BN, CL)                                                \
  if (a_m) { if (b_n) LMR_WGMMA(BN, true, true, CL); else LMR_WGMMA(BN, true, false, CL); } \
  else     { if (b_n) LMR_WGMMA(BN, false, true, CL); else LMR_WGMMA(BN, false, false, CL); }
  // a 256-wide cluster split takes its own instantiation: the unsplit
  // 256-wide kernel (the 8192³ products) keeps its code
  if (bn == 256 && p.cluster > 1) { LMR_WGMMA_BN(256, true) }
  else if (bn == 256) { LMR_WGMMA_BN(256, false) }
  else if (bn == 128) { LMR_WGMMA_BN(128, false) }
  else if (bn == 64) { LMR_WGMMA_BN(64, false) }
#undef LMR_WGMMA_BN
#undef LMR_WGMMA
  return rc;
}

// the split-K reduce of a slab split
static bool slab_split(const Plan& p) { return p.splits > 1 && p.cluster == 1; }

static int reduce_slab(const Plan& p, float* P, void* c, bool out_f32,
                       int M, int N, cudaStream_t s) {
  const long long mn = (long long)M * N;
  splitk_reduce_kernel<<<(unsigned)cdiv(mn, 256), 256, 0, s>>>(
      P, c, out_f32, p.splits, mn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// How many ways lmr_matmul splits K for this product on the current
// device (1: no split; 0: the device could not be queried). It takes the
// operands' layout too: that picks the kernel, and the kernels split
// differently.
int lmr_matmul_splits(const void* a, const void* b, int M, int N, int K,
                      long long sam, long long sak, long long sbk,
                      long long sbn, int dtype) {
  Layouts lay;
  const int path = choose_path(a, b, M, N, K, sam, sak, sbk, sbn, dtype,
                               &lay);
  return plan_of(a, b, M, N, K, sam, sak, sbk, sbn, dtype, path).splits;
}

// The f32 partials of a slab split (0: none, the product is unsplit or
// its cluster sums its split in the kernel; -1: the device could not be
// queried): above 0 the caller passes f32 scratch of that many · M·N as
// lmr_matmul's `part`.
int lmr_matmul_slab(const void* a, const void* b, int M, int N, int K,
                    long long sam, long long sak, long long sbk,
                    long long sbn, int dtype) {
  Layouts lay;
  const int path = choose_path(a, b, M, N, K, sam, sak, sbk, sbn, dtype,
                               &lay);
  const Plan p = plan_of(a, b, M, N, K, sam, sak, sbk, sbn, dtype, path);
  if (p.splits < 1) return -1;
  return slab_split(p) ? p.splits : 0;
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
  const Plan p = plan_of(a, b, M, N, K, sam, sak, sbk, sbn, dtype, path);
  const bool wide = path == PATH_F32_WIDE || path == PATH_F32_NARROW;
  plan[0] = path;
  plan[1] = p.splits;
  plan[2] = p.chunk;
  plan[3] = wide ? f32w::copy_mode(a, sam, sak) : -1;
  plan[4] = wide ? f32w::copy_mode(b, sbn, sbk) : -1;
  return 0;
}

// lmr_matmul_plan's five, then for bf16: plan[5] the tile width, plan[6]
// the cluster (1: none), plan[7] the epilogue of an unsplit tile (Epi),
// plan[8] and plan[9] the general kernel's modes of A and B (bf16k::Mode;
// -1 on the wgmma kernel), plan[10] the general kernel's blocks an SM
// that the plan read (0 elsewhere); -1 in 5-9 for f32.
int lmr_matmul_plan_ex(const void* a, const void* b, int M, int N, int K,
                       long long sam, long long sak, long long sbk,
                       long long sbn, int dtype, int* plan) {
  lmr_matmul_plan(a, b, M, N, K, sam, sak, sbk, sbn, dtype, plan);
  for (int i = 5; i < 10; ++i) plan[i] = -1;
  plan[10] = 0;
  if (dtype != DT_BF16) return 0;
  Layouts lay;
  const int path = choose_path(a, b, M, N, K, sam, sak, sbk, sbn, dtype,
                               &lay);
  const Plan p = plan_of(a, b, M, N, K, sam, sak, sbk, sbn, dtype, path);
  plan[5] = p.bn;
  plan[6] = p.cluster;
  plan[7] = p.epi;
  if (path == PATH_GENERAL) {
    const bf16k::Staging s =
        N <= 64 ? bf16k::staging<64>(a, b, M, N, K, sam, sak, sbk, sbn)
                : bf16k::staging<128>(a, b, M, N, K, sam, sak, sbk, sbn);
    plan[8] = s.a_mode;
    plan[9] = s.b_mode;
    plan[10] = general_resident(a, b, M, N, K, sam, sak, sbk, sbn);
  }
  return 0;
}

// The SMs clusters of 1-8 wgmma CTAs can use on the current device,
// which the bf16 plan reads, into out[size - 1]; 0 where a size does not
// fit. Returns 0, or an error.
int lmr_matmul_cluster_sms(int* out) {
  return wgmma_cluster_sms(out) ? 0 : cudaErrorInvalidDevice;
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
  const Plan p = plan_of(a, b, M, N, K, sam, sak, sbk, sbn, in_dtype, path);
  const int splits = p.splits, chunk = p.chunk;
  if (splits < 1 || (slab_split(p) && part == nullptr))
    return cudaErrorInvalidValue;
  float* P = static_cast<float*>(part);
  float* kpart = slab_split(p) ? P : nullptr;
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
  } else if (path == PATH_TMA) {
    const int rc = launch_tma(a, b, c, out_f32, kpart, M, N, K, sam, sak,
                              sbk, sbn, lay, p, s);
    if (rc != 0) return rc;
  } else {
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    const int rc =
        p.bn == 64
            ? bf16k::launch<64>(A, B, c, out_f32, kpart, M, N, K, sam, sak,
                                sbk, sbn, splits, chunk, s)
            : bf16k::launch<128>(A, B, c, out_f32, kpart, M, N, K, sam, sak,
                                 sbk, sbn, splits, chunk, s);
    if (rc != 0) return rc;
  }
  if (slab_split(p)) return reduce_slab(p, P, c, out_f32, M, N, s);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma kernel at a given plan (bf16 operands TMA can read): tile
// width bn (64, 128 or 256), split, cluster (1, or the split: up to
// WG_MAX_CLUSTER CTAs that fit) and epilogue, for the
// tests and for timing a plan the cost model does not pick. `part`:
// f32 scratch of splits·M·N for a split without a cluster. Refuses what
// the kernel cannot run.
int lmr_matmul_forced(const void* a, const void* b, void* c, void* part,
                      int M, int N, int K, long long sam, long long sak,
                      long long sbk, long long sbn, int out_dtype, int bn,
                      int splits, int cluster, int epi, void* stream) {
  Layouts lay;
  if (choose_path(a, b, M, N, K, sam, sak, sbk, sbn, DT_BF16, &lay) !=
          PATH_TMA ||
      (bn != 64 && bn != 128 && bn != 256) || splits < 1 ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16) ||
      (epi != sm90::EPI_REGS && epi != sm90::EPI_TMA) ||
      (epi == sm90::EPI_TMA && (bn > 128 || splits > 1)))
    return cudaErrorInvalidValue;
  const long long units = cdiv(K, 64);
  const long long chunk = cdiv(units, splits);
  if (splits > units || cdiv(units, chunk) != splits)
    return cudaErrorInvalidValue;
  if (cluster != 1) {
    int cl[WG_MAX_CLUSTER];
    if (!wgmma_cluster_sms(cl)) return cudaErrorInvalidDevice;
    if (cluster != splits || cluster < 2 || cluster > WG_MAX_CLUSTER ||
        cl[cluster - 1] <= 0)
      return cudaErrorInvalidValue;
  }
  const Plan p = {splits, static_cast<int>(chunk), bn, cluster, epi};
  if (slab_split(p) && part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool out_f32 = out_dtype == DT_F32;
  float* P = static_cast<float*>(part);
  const int rc = launch_tma(a, b, c, out_f32, slab_split(p) ? P : nullptr,
                            M, N, K, sam, sak, sbk, sbn, lay, p, s);
  if (rc != 0) return rc;
  if (slab_split(p)) return reduce_slab(p, P, c, out_f32, M, N, s);
  return static_cast<int>(cudaGetLastError());
}

// 1 when this build can encode TMA descriptors on this machine (the
// driver exposes cuTensorMapEncodeTiled), else 0.
int lmr_matmul_tma_available() { return sm90::encode_fn() != nullptr; }

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
