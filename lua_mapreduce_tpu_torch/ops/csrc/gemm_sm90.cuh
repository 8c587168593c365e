// The pipelined tensor-core GEMM mainloop that matmul.cu (B1) and q8.cu
// (B7, its M > 8 path) share on Hopper (sm_90a).
//
// A block computes 128 × BN tiles of C = A · B (BN = 128 or 256), each
// over a range of K-tiles of 64 (all of K, or one chunk of a split-K);
// it is persistent (one block per SM walks the tiles in an L2-friendly
// order, the pipeline running on from one tile into the next). It has
// three warpgroups (four with W8):
//  * warpgroup 2, the producer: one thread keeps a ring of STAGES
//    shared-memory stages filled by TMA (cp.async.bulk.tensor), each
//    stage's arrival tracked by an mbarrier ("full"); it refills a stage
//    once both consumers have released it ("empty"). With W8 (q8's int8
//    weights) TMA brings the int8 tile, and seven warps (the producer's
//    other three and a fourth warpgroup) widen it (exactly) into the
//    stage's bf16 B tile, in the swizzled layout TMA would have written,
//    and mark the stage "ready" for the consumers: device memory moves
//    int8 weight bytes only, and the widening runs beside the tensor
//    cores, not between the consumers' wgmma groups; seven warps, not
//    the producer's spare three, so that it keeps pace with them at the
//    prefill shapes.
//  * warpgroups 0 and 1, the consumers: each owns 64 rows of the tile and
//    issues wgmma.mma_async m64n128k16 (bf16 × bf16 → f32 registers),
//    reading both operands from shared memory through 128-byte-swizzled
//    descriptors. wgmma takes either major-ness of a 16-bit operand, so
//    a transposed view (hᵀ·g, g·Wᵀ, patchesᵀ·g) is read as it lies: no
//    copy. A consumer keeps one wgmma group in flight and releases the
//    stage before it once that group has retired.
//  * The epilogue stores from the accumulator registers: C in bf16 or
//    f32 (one cast), the per-column scale of q8 applied once, or, for a
//    split-K block, its f32 partial in a scratch slab that a second
//    kernel sums in split order (no atomics: bit-identical run to run).
//
// TMA needs a 16-byte aligned base, a unit inner stride and an outer
// stride that is a multiple of 16 bytes; the callers check this and send
// other layouts to their general kernels. Ragged M, N and K edges come
// back from TMA as zeros and are masked at the store.

#pragma once

#include "sm90_common.cuh"

namespace sm90 {

constexpr int BM = 128, BK = 64;
// threads per block: two consumer warpgroups and the producer's; with
// W8 a fourth warpgroup, whose four warps and the producer's other three
// widen the int8 tiles
template <bool W8>
constexpr int threads() { return W8 ? 512 : 384; }
constexpr int WIDEN_THREADS = 224;

// Shared memory: STAGES stages of {A, bf16 B (, the int8 tile with W8)},
// then, with W8, the bf16 C tile that the TMA store reads.
template <int BN, bool W8>
struct Layout {
  static constexpr int A_BYTES = BM * BK * 2;           // 16 KB
  static constexpr int B_BYTES = BN * BK * 2;           // bf16 B tile
  static constexpr int W_BYTES = W8 ? BN * BK : 0;      // int8 tile
  static constexpr int C_BYTES = W8 ? BM * BN * 2 : 0;  // staged C tile
  static constexpr int STAGE = A_BYTES + B_BYTES + W_BYTES;
  static constexpr int FIT = (220 * 1024 - C_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int DYN = STAGES * STAGE + C_BYTES + 1024;  // + align
};

// columns col, col + 1 of one row: one 8- or 4-byte store when both are
// in range and N is even (the pair is then aligned), else masked scalars
__device__ __forceinline__ void store_pair(float* p, float v0, float v1,
                                           int col, int N) {
  if (col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (col < N) p[0] = v0;
    if (col + 1 < N) p[1] = v1;
  }
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1,
                                           int col, int N) {
  if (col + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  } else {
    if (col < N) p[0] = __float2bfloat16(v0);
    if (col + 1 < N) p[1] = __float2bfloat16(v1);
  }
}

// Four int8 (one word) to four bf16 (two words), exactly, on the integer
// and FP32 add pipes (int-to-float conversions run at a quarter of their
// rate): byte b + 128 becomes the low mantissa byte of 2^23 (bits
// 0x4B0000xx), minus 2^23 + 128 leaves b as an f32 whose low 16 bits are
// zero (|b| < 256), so its high half is b in bf16.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) -
                   8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) -
                   8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) -
                   8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Widen 16 int8 weights to bf16 (exact) and write them as two 16-byte
// units of the N-major, 128-byte-swizzled B tile: unit u of row k of a
// 64-column chunk lies at chunk + k·128 + ((u ^ (k % 8)) · 16).
__device__ __forceinline__ void widen16(uint8_t* chunk, int k, int u,
                                        int4 v) {
  uint4 lo, hi;
  widen4(static_cast<uint32_t>(v.x), lo.x, lo.y);
  widen4(static_cast<uint32_t>(v.y), lo.z, lo.w);
  widen4(static_cast<uint32_t>(v.z), hi.x, hi.y);
  widen4(static_cast<uint32_t>(v.w), hi.z, hi.w);
  uint8_t* row = chunk + k * 128;
  *reinterpret_cast<uint4*>(row + ((u ^ (k & 7)) << 4)) = lo;
  *reinterpret_cast<uint4*>(row + (((u + 1) ^ (k & 7)) << 4)) = hi;
}

// The work item w of a launch: split z (outermost), then the output
// tiles in groups of GROUP_M tile-rows, walked column by column inside a
// group, so the blocks in flight at one time share a few A row-strips and
// B column-strips in L2 instead of streaming all of B once per tile-row.
constexpr int GROUP_M = 16;
__device__ __forceinline__ void work_of(int w, int tiles_m, int tiles_n,
                                        int& m_t, int& n_t, int& z) {
  const int per = tiles_m * tiles_n;
  z = w / per;
  const int r = w - z * per, span = GROUP_M * tiles_n;
  const int first = (r / span) * GROUP_M;
  const int rows = tiles_m - first < GROUP_M ? tiles_m - first : GROUP_M;
  const int q = r % span;
  m_t = first + q % rows;
  n_t = q / rows;
}

// A: (M, K) bf16 through tma_a — K-major boxes {64 k, 128 m}, or with
// A_MN M-major boxes {64 m, 64 k}. B: (K, N) through tma_b — N-major
// boxes {64 n, 64 k}, or K-major {64 k, BN n}; with W8 one int8 box
// {BN n, 64 k} without swizzle. C (M, N) contiguous, f32 if out_f32
// else bf16; Part: the split-K slab (splits > 1); Sc: per-column scale
// or null. kt_per: K-tiles of 64 per split. With W8, C is bf16 and
// written through tma_c (boxes {64 n, 64 m}, 128-byte swizzle): each
// consumer puts its 64 × BN rows, scaled and cast, into shared memory
// and one thread hands them to TMA, which writes them (ragged edges
// clipped) while the consumer goes on to its next tile, where 4-byte
// stores from registers would hold the consumer until they drain.
//
// The kernel is persistent: a block walks work items blockIdx.x,
// blockIdx.x + gridDim.x, ... (one per SM, at most), and the ring's
// stage and phase run on across items, so the producer fills the next
// item's first stages while the consumers store the last one's tile.
template <int BN, bool A_MN, bool B_MN, bool W8>
__global__ void __launch_bounds__(threads<W8>(), 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  const __grid_constant__ CUtensorMap tma_c, void* C,
                  bool out_f32, float* Part, const float* Sc, int M, int N,
                  int K, int kt_per, int splits) {
  using L = Layout<BN, W8>;
  constexpr int S = L::STAGES, PIECES = BN / 128;
  static_assert(!W8 || B_MN, "int8 weights are N-major");
  extern __shared__ uint8_t smem_raw[];
  // full: TMA has landed a stage; ready (W8): its int8 tile has been
  // widened; empty: both consumers are done with it
  __shared__ __align__(8) uint64_t full[S], ready[W8 ? S : 1], empty[S];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // swizzle atoms: 1 KB
  uint8_t* gbase = smem_raw + (base - raw);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int total = tiles_m * tiles_n * splits;
  const int kt_all = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      if (W8) mbar_init(smem_u32(&ready[s]), WIDEN_THREADS);
      mbar_init(smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    // ------------------------------------------------------ producer
    // (without W8 its registers go to the consumers; with W8 every
    // thread keeps the 128 a 512-thread block allows)
    if (!W8) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (wg == 2 && t == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&tma_b)) : "memory");
      int g = 0;                     // K-tiles issued so far, all items
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        int m_t, n_t, z;
        work_of(w, tiles_m, tiles_n, m_t, n_t, z);
        const int m0 = m_t * BM, n0 = n_t * BN, kt0 = z * kt_per;
        const int nkt = kt_per < kt_all - kt0 ? kt_per : kt_all - kt0;
        for (int i = 0; i < nkt; ++i, ++g) {
          const int s = g % S;
          mbar_wait(smem_u32(&empty[s]), ((g / S) & 1) ^ 1);
          const uint32_t fb = smem_u32(&full[s]);
          mbar_expect_tx(fb, L::A_BYTES + (W8 ? L::W_BYTES : L::B_BYTES));
          const uint32_t sa = base + s * L::STAGE, sb = sa + L::A_BYTES;
          const int kc = (kt0 + i) * BK;
          if (A_MN) {
            tma_load_2d(sa, &tma_a, fb, m0, kc);
            tma_load_2d(sa + 8192, &tma_a, fb, m0 + 64, kc);
          } else {
            tma_load_2d(sa, &tma_a, fb, kc, m0);
          }
          if (W8) {
            tma_load_2d(sb + L::B_BYTES, &tma_b, fb, n0, kc);
          } else if (B_MN) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(sb + c * 8192, &tma_b, fb, n0 + 64 * c, kc);
          } else {
            tma_load_2d(sb, &tma_b, fb, kc, n0);
          }
        }
      }
    } else if (W8 && (wg == 3 || t >= 32)) {
      // W8: seven warps widen each landed int8 tile (exactly) into its
      // stage's bf16 B tile, in the swizzled layout TMA would have
      // written, and mark the stage ready; the consumers only multiply.
      // Unit q is 16 int8 weights (one 16-byte load, two 16-byte stores):
      // 8 consecutive units cover 4 16-byte pieces of one 64-column chunk
      // in rows k and k + 1, whose swizzled bf16 units are 8 different
      // bank groups.
      constexpr int UNITS = BK * BN / 16, PER = (UNITS + WIDEN_THREADS - 1) /
                                                WIDEN_THREADS;
      const int tw = wg == 3 ? 96 + t : t - 32;
      int g = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        int m_t, n_t, z;
        work_of(w, tiles_m, tiles_n, m_t, n_t, z);
        const int kt0 = z * kt_per;
        const int nkt = kt_per < kt_all - kt0 ? kt_per : kt_all - kt0;
        for (int i = 0; i < nkt; ++i, ++g) {
          const int s = g % S;
          mbar_wait(smem_u32(&full[s]), (g / S) & 1);
          uint8_t* gb = gbase + s * L::STAGE + L::A_BYTES;
          const uint8_t* gw = gb + L::B_BYTES;
          int4 v[PER];
#pragma unroll
          for (int u = 0; u < PER; ++u) {     // every load first
            const int q = tw + u * WIDEN_THREADS;
            const int rest = q / 8, c = rest % (BN / 64);
            const int k = 2 * (rest / (BN / 64)) + (q / 4) % 2;
            if (q < UNITS)
              v[u] = *reinterpret_cast<const int4*>(gw + k * BN + c * 64 +
                                                    (q % 4) * 16);
          }
#pragma unroll
          for (int u = 0; u < PER; ++u) {
            const int q = tw + u * WIDEN_THREADS;
            const int rest = q / 8, c = rest % (BN / 64);
            const int k = 2 * (rest / (BN / 64)) + (q / 4) % 2;
            if (q < UNITS) widen16(gb + c * (BK * 128), k, (q % 4) * 2, v[u]);
          }
          // generic-proxy writes, read next by wgmma (the async proxy)
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(smem_u32(&ready[s]));
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    if (!W8) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int w4 = t / 32, lane = t % 32;
    int g = 0;                       // K-tiles consumed so far, all items
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      int m_t, n_t, z;
      work_of(w, tiles_m, tiles_n, m_t, n_t, z);
      const int m0 = m_t * BM, n0 = n_t * BN, kt0 = z * kt_per;
      const int nkt = kt_per < kt_all - kt0 ? kt_per : kt_all - kt0;
      float acc[PIECES][64];
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;
      for (int i = 0; i < nkt; ++i) {
        const int gi = g + i, s = gi % S;
        mbar_wait(smem_u32(&full[s]), (gi / S) & 1);
        if (W8) mbar_wait(smem_u32(&ready[s]), (gi / S) & 1);
        const uint32_t sa = base + s * L::STAGE + wg * 8192;
        const uint32_t sb = base + s * L::STAGE + L::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // K-major: 16 k = 32 bytes along a swizzled row; M/N-major:
          // 16 k = two 8-row swizzle atoms (2 KB). LBO: the next 64-wide
          // M/N chunk (8 KB); SBO: the next 8 rows (1 KB).
          const uint64_t da = A_MN ? desc_sw128(sa + kk * 2048, 8192, 1024)
                                   : desc_sw128(sa + kk * 32, 16, 1024);
#pragma unroll
          for (int p = 0; p < PIECES; ++p) {
            const uint64_t db =
                B_MN ? desc_sw128(sb + p * 16384 + kk * 2048, 8192, 1024)
                     : desc_sw128(sb + p * 16384 + kk * 32, 16, 1024);
            wgmma_128<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc[p], da, db);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        // the group before this one has retired: its stage is free
        if (i > 0 && t == 0) mbar_arrive(smem_u32(&empty[(gi - 1) % S]));
      }
      wgmma_wait<0>();
      if (nkt > 0 && t == 0) mbar_arrive(smem_u32(&empty[(g + nkt - 1) % S]));
      g += nkt;
#pragma unroll
      for (int p = 0; p < PIECES; ++p) fence_acc(acc[p]);

      // accumulator fragment: register 4j + 2h + {0,1} of warp w, lane l
      // holds row 16w + l/4 + 8h, columns 8j + 2(l%4) + {0,1}
      if (W8) {
        // this consumer's 64 rows: BN / 64 swizzled boxes of 64 × 64;
        // the previous tile's store must have read them first
        uint8_t* cbuf = gbase + S * L::STAGE + wg * (64 * BN * 2);
        if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        named_sync(2 + wg, 128);
#pragma unroll
        for (int p = 0; p < PIECES; ++p)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = p * 128 + j * 8 + (lane % 4) * 2;
            const int gc = n0 + col;
            const float s0 = gc < N ? Sc[gc] : 0.f;
            const float s1 = gc + 1 < N ? Sc[gc + 1] : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = w4 * 16 + lane / 4 + 8 * h;
              uint8_t* box = cbuf + (col / 64) * 8192 + r * 128;
              *reinterpret_cast<uint32_t*>(
                  box + ((((col % 64) / 8) ^ (r & 7)) << 4) + (col % 8) * 2) =
                  pack_bf16(acc[p][4 * j + 2 * h] * s0,
                            acc[p][4 * j + 2 * h + 1] * s1);
            }
          }
        // generic-proxy writes, read next by TMA (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_sync(2 + wg, 128);
        if (t == 0) {
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_store_2d(&tma_c, smem_u32(cbuf + b * 8192), n0 + 64 * b,
                         m0 + wg * 64);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        }
        continue;
      }
      const int rbase = m0 + wg * 64 + w4 * 16 + lane / 4;
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + p * 128 + j * 8 + (lane % 4) * 2;
          if (col >= N) continue;
          float s0 = 1.f, s1 = 1.f;
          if (Sc != nullptr) {
            s0 = Sc[col];
            if (col + 1 < N) s1 = Sc[col + 1];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rbase + 8 * h;
            if (row >= M) continue;
            const float v0 = acc[p][4 * j + 2 * h],
                        v1 = acc[p][4 * j + 2 * h + 1];
            const long long off = (long long)row * N + col;
            if (splits > 1)
              store_pair(Part + (long long)z * M * N + off, v0, v1, col, N);
            else if (out_f32)
              store_pair(static_cast<float*>(C) + off, v0 * s0, v1 * s1,
                         col, N);
            else
              store_pair(static_cast<bf16*>(C) + off, v0 * s0, v1 * s1,
                         col, N);
          }
        }
    }
    // the last TMA store has read its shared memory before the block ends
    if (W8 && t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// ------------------------------------------------------------ host side

// Can TMA read a matrix whose contiguous axis (extent `inner`) has unit
// stride and whose other axis has stride `outer_stride` elements of
// `esize` bytes?
static inline bool tma_ok(const void* p, long long inner_stride,
                          long long outer_stride, long long inner,
                          long long outer, int esize) {
  return aligned16(p) && inner_stride == 1 && inner > 0 && outer > 0 &&
         outer_stride >= inner && (outer_stride * esize) % 16 == 0 &&
         outer_stride * esize < (1ll << 40) && inner < (1ll << 32) &&
         outer < (1ll << 32);
}

// A 2-D tensor map: dims {inner, outer}, outer stride in elements; a box
// of {box_inner, box_outer}; bf16 with the 128-byte swizzle, or int8
// without. Out-of-range elements read as zero.
static bool make_map(CUtensorMap* map, const void* ptr, bool is_bf16,
                     long long inner, long long outer, long long outer_stride,
                     int box_inner, int box_outer) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const int esize = is_bf16 ? 2 : 1;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)(outer_stride * esize)};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t estr[2] = {1, 1};
  return fn(map,
            is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tc: C's map (boxes {64 n, 64 m}), read only with W8
template <int BN, bool A_MN, bool B_MN, bool W8>
static int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                        const CUtensorMap& tc, void* C, bool out_f32,
                        float* part, const float* sc, int M, int N, int K,
                        int splits, int kt_per, cudaStream_t st) {
  using L = Layout<BN, W8>;
  auto kern = wgmma_gemm_kernel<BN, A_MN, B_MN, W8>;
  static bool attr = false;   // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::DYN);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long total = (long long)((M + BM - 1) / BM) *
                          ((N + BN - 1) / BN) * splits;
  if (total > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = total < sms ? static_cast<int>(total) : sms;
  kern<<<grid, threads<W8>(), L::DYN, st>>>(ta, tb, tc, C, out_f32, part, sc, M, N,
                                 K, kt_per, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
