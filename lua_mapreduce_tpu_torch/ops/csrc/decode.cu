// Decode attention on Hopper (sm_90a): one query position's G grouped
// query heads against a (B, H_kv, S, D) KV cache, with an online softmax,
// in bf16/f32 or int8 with per-row f32 scales.
//
// Replaces: lua_mapreduce_tpu/ops/decode.py::_decode_kernel, driven by
// _decode_pallas.
//
// What bounds it on the H100: bytes. Each step reads the live part of
// the cache once — at the serving shape (B=4, H_kv=16, t≈4094, d=64,
// bf16) K plus V are 2·4·16·4095·64·2 = 67.1 MB per layer — for about 4
// FLOPs per cache element, some 2 operations per byte.
//
// What the design does about it (split-S, "flash-decoding"):
//  * The TPU grid walks cache chunks as a sequential axis with the
//    softmax state in VMEM scratch. Here the positions of each
//    (batch, kv-head) row are cut into n_split contiguous splits, one
//    block each, so B·H_kv·n_split blocks fill the card where B·H_kv
//    (64 at the serving shape, 16 under GQA 4:1) would leave most SMs
//    idle. lmr_decode_splits picks n_split from the cache capacity S, the
//    row count and the SM count — never from t — so the grid of a decode
//    step does not change as t grows. The position t itself is read from
//    device memory (an int64 the caller's decode loop advances on the
//    card), so one captured CUDA graph of a decode step serves every t.
//    Each split computes the live positions [0, n_live) from t — S once a
//    rolling cache is full, else min(t + 1, S) — clamps its range to them,
//    and a split with nothing live writes the empty state (m = -1e30,
//    l = 0, acc = 0): dead positions are never read, the cache never
//    padded.
//  * Loads: a row's cache is contiguous over S, so a split is one span
//    of memory. Each lane reads 16 bytes (4 f32, 8 bf16 or 16 int8) of a
//    cache row, D / (16 bytes) lanes a row, so one warp instruction covers
//    2-8 consecutive rows; every thread keeps 4 rows of K and V in flight
//    and loads the next chunk's while it computes this one's. The int8
//    per-row scales come along with their rows.
//  * The softmax runs per chunk, not per position: a thread takes the
//    scores of its 4 rows for all G heads, then one max and one rescale
//    of its accumulator per head. Its state (max, denominator, output
//    slice) merges with the other threads' once, at the end of the split,
//    in a fixed order (warp butterflies, then warps in order through
//    shared memory).
//  * Rounding points follow _decode_xla / the TPU kernel: bf16 p before
//    the value product for bf16 caches; for int8, q in bf16, k int8 → f32
//    exactly, s × k_scale × 1/√d, p × v_scale rounded to bf16, p·v in
//    f32. The denominator is summed in f32 before any rounding. Scores
//    are kept in the log2 domain (1/√d · log2 e folded into one product).
//  * Each split writes its (m, l, acc) to an f32 scratch the wrapper
//    allocates, and decode_combine_kernel merges the splits in split
//    order: M = max mₛ, L = Σ lₛ·e^(mₛ−M), O = Σ accₛ·e^(mₛ−M) / max(L,
//    1e-30). No atomics, so two calls are bit-equal. With one split the
//    split kernel writes the output itself.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

using bf16 = __nv_bfloat16;

// cache kinds: q dtype / cache dtype
enum { KIND_F32 = 0, KIND_BF16 = 1, KIND_BF16_INT8 = 2 };
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
// warps and threads of a split block; cache rows in flight per thread
constexpr int NW = 4, NT = NW * 32, U = 4;
// a split covers this many positions at least, and the splits aim at
// this many blocks per SM
constexpr int MIN_SPLIT = 256, BLOCKS_PER_SM = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 bytes of a cache row as EPL f32 values (exact)
template <typename KV>
struct Row;
template <>
struct Row<float> {
  static constexpr int EPL = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
};
template <>
struct Row<bf16> {
  static constexpr int EPL = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Row<int8_t> {
  static constexpr int EPL = 16;
  static __device__ __forceinline__ void widen(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      o[i] = static_cast<float>(static_cast<int8_t>(w[i / 4] >> (8 * (i % 4))));
  }
};

// The visible cache slots at position t: all S once a rolling cache has
// wrapped, else slots [0, t + 1) (the plain version's mask).
__device__ __forceinline__ int live_positions(long long t, int S, int roll) {
  if (roll && t >= S) return S;
  return t < 0 ? 0 : (t + 1 < S ? static_cast<int>(t + 1) : S);
}

// One split of one (batch, kv-head) row. Pm/Pl (rows, n_split, G) and
// Pacc (rows, n_split, G, D) receive the split's state (m in natural-log
// units); with one split, O (rows, G, D) receives the output instead.
template <typename QT, typename KV, int D, int G>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const QT* __restrict__ Q, const KV* __restrict__ K,
                    const KV* __restrict__ V, const float* __restrict__ KS,
                    const float* __restrict__ VS, float* __restrict__ O,
                    float* __restrict__ Pm, float* __restrict__ Pl,
                    float* __restrict__ Pacc, int Hkv, int S,
                    const long long* __restrict__ T, int roll,
                    int split_len, long long sqb, long long sqh,
                    long long sqg, float c) {
  using R = Row<KV>;
  constexpr int EPL = R::EPL, LPR = D / EPL, NG = NT / LPR, CH = U * NG;
  constexpr bool Q8 = sizeof(KV) == 1, BF = sizeof(KV) == 2;
  __shared__ float sm[NW][G], sl[NW][G];
  __shared__ float sacc[NW][G][D];
  const int z = blockIdx.x, n_split = gridDim.x, row = blockIdx.y;
  const int b = row / Hkv, kh = row % Hkv;
  const int n_live = live_positions(*T, S, roll);
  const int p0 = z * split_len;
  const int p1 = min(p0 + split_len, n_live);
  const long long slot = (long long)row * n_split + z;

  if (p0 >= p1) {                     // nothing live: the empty state
    float* out = n_split == 1 ? O + (long long)row * G * D
                              : Pacc + slot * G * D;
    for (int i = threadIdx.x; i < G * D; i += NT) out[i] = 0.f;
    if (n_split > 1 && threadIdx.x < G) {
      Pm[slot * G + threadIdx.x] = NEG_BIG;
      Pl[slot * G + threadIdx.x] = 0.f;
    }
    return;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % LPR;                 // elements [sub·EPL, +EPL)
  const int pg = threadIdx.x / LPR;           // position group
  float q[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const QT* qp = Q + b * sqb + kh * sqh + gi * sqg + sub * EPL;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      q[gi][i] = to_f32(qp[i]);
      acc[gi][i] = 0.f;
    }
    m[gi] = NEG_BIG;
    l[gi] = 0.f;
  }
  // a cache row is LPR 16-byte units; lane `sub` reads unit `sub`
  const uint4* kr = reinterpret_cast<const uint4*>(K + (long long)row * S * D) + sub;
  const uint4* vr = reinterpret_cast<const uint4*>(V + (long long)row * S * D) + sub;
  const float* ksr = Q8 ? KS + (long long)row * S : nullptr;
  const float* vsr = Q8 ? VS + (long long)row * S : nullptr;

  // rows j0 + u·NG + pg of a chunk; a row past the split reads as zeros
  uint4 kc[U], vc[U];
  float ksc[U], vsc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int pos = p0 + u * NG + pg;
    const bool live = pos < p1;
    kc[u] = live ? kr[(long long)pos * LPR] : make_uint4(0, 0, 0, 0);
    vc[u] = live ? vr[(long long)pos * LPR] : make_uint4(0, 0, 0, 0);
    ksc[u] = Q8 && live ? ksr[pos] : 0.f;
    vsc[u] = Q8 && live ? vsr[pos] : 0.f;
  }

  for (int j0 = p0; j0 < p1; j0 += CH) {
    // the next chunk's rows, in flight while this one is computed
    uint4 kn[U], vn[U];
    float ksn[U], vsn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = j0 + CH + u * NG + pg;
      const bool live = pos < p1;
      kn[u] = live ? kr[(long long)pos * LPR] : make_uint4(0, 0, 0, 0);
      vn[u] = live ? vr[(long long)pos * LPR] : make_uint4(0, 0, 0, 0);
      ksn[u] = Q8 && live ? ksr[pos] : 0.f;
      vsn[u] = Q8 && live ? vsr[pos] : 0.f;
    }

    // scores of this thread's U rows for every head, log2 domain
    float s[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      R::widen(kc[u], kf);
      const bool live = j0 + u * NG + pg < p1;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) part = fmaf(q[gi][i], kf[i], part);
#pragma unroll
        for (int off = 1; off < LPR; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[gi][u] = live ? (Q8 ? part * ksc[u] : part) * c : -INFINITY;
      }
    }
    // one max and one rescale per head for the chunk
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[gi][u]);
      const float alpha = exp2f(m[gi] - mx);
      m[gi] = mx;
      float rs = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[gi][u] - mx);
        rs += p;
        s[gi][u] = Q8 ? round_bf16(p * vsc[u]) : (BF ? round_bf16(p) : p);
      }
      l[gi] = l[gi] * alpha + rs;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[gi][i] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      R::widen(vc[u], vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          acc[gi][i] = fmaf(s[gi][u], vf[i], acc[gi][i]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u]; vc[u] = vn[u]; ksc[u] = ksn[u]; vsc[u] = vsn[u];
    }
  }

  // merge: the warp's position groups (a butterfly over the lane bits
  // above LPR), then the warps in order through shared memory
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    float M = m[gi];
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float f = exp2f(m[gi] - M);
    float lg = l[gi] * f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[gi][i] *= f;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      lg += __shfl_xor_sync(0xffffffffu, lg, off);
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        acc[gi][i] += __shfl_xor_sync(0xffffffffu, acc[gi][i], off);
    }
    if (lane < LPR) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) sacc[warp][gi][sub * EPL + i] = acc[gi][i];
      if (lane == 0) {
        sm[warp][gi] = M;
        sl[warp][gi] = lg;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int gi = idx / D, d = idx % D;
    float M = NEG_BIG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm[w][gi]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(sm[w][gi] - M);
      Ls += sl[w][gi] * f;
      A += sacc[w][gi][d] * f;
    }
    if (n_split == 1) {
      O[(long long)row * G * D + idx] = A / fmaxf(Ls, 1e-30f);
    } else {
      Pacc[slot * G * D + idx] = A;
      if (d == 0) {
        Pm[slot * G + gi] = M * LN2;
        Pl[slot * G + gi] = Ls;
      }
    }
  }
}

// The splits of one row merged in split order; one thread per (head,
// element), G·D threads.
__global__ void decode_combine_kernel(const float* __restrict__ Pm,
                                      const float* __restrict__ Pl,
                                      const float* __restrict__ Pacc,
                                      float* __restrict__ O, int n_split,
                                      int G, int D) {
  const int row = blockIdx.x, idx = threadIdx.x, gi = idx / D;
  const long long r0 = (long long)row * n_split;
  float M = NEG_BIG;
#pragma unroll 8
  for (int z = 0; z < n_split; ++z) M = fmaxf(M, Pm[(r0 + z) * G + gi]);
  float Ls = 0.f, A = 0.f;
#pragma unroll 8
  for (int z = 0; z < n_split; ++z) {
    const float f = expf(Pm[(r0 + z) * G + gi] - M);
    Ls += Pl[(r0 + z) * G + gi] * f;
    A += Pacc[(r0 + z) * G * D + idx] * f;
  }
  O[(long long)row * G * D + idx] = A / fmaxf(Ls, 1e-30f);
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  float *o, *pm, *pl, *pacc;
  const long long* t;
  int rows, Hkv, S, roll, split_len, n_split;
  long long sqb, sqh, sqg;
  float c;
};

template <typename QT, typename KV, int D>
static int launch_g(int G, const Args& a, cudaStream_t s) {
  const QT* Q = static_cast<const QT*>(a.q);
  const KV* K = static_cast<const KV*>(a.k);
  const KV* V = static_cast<const KV*>(a.v);
  const dim3 grid(a.n_split, a.rows);
#define LMR_DECODE_G(GG)                                                     \
  decode_split_kernel<QT, KV, D, GG><<<grid, NT, 0, s>>>(                    \
      Q, K, V, a.ks, a.vs, a.o, a.pm, a.pl, a.pacc, a.Hkv, a.S, a.t, a.roll, \
      a.split_len, a.sqb, a.sqh, a.sqg, a.c)
  switch (G) {
    case 1: LMR_DECODE_G(1); break;
    case 2: LMR_DECODE_G(2); break;
    case 4: LMR_DECODE_G(4); break;
    case 8: LMR_DECODE_G(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef LMR_DECODE_G
  return cudaSuccess;
}

template <typename QT, typename KV>
static int launch_d(int D, int G, const Args& a, cudaStream_t s) {
  if (D == 64) return launch_g<QT, KV, 64>(G, a, s);
  if (D == 128) return launch_g<QT, KV, 128>(G, a, s);
  return cudaErrorInvalidValue;
}

static bool valid(long long rows, int S, int D, int G, int kind) {
  return rows > 0 && rows <= 65535 && S > 0 && (D == 64 || D == 128) &&
         (G == 1 || G == 2 || G == 4 || G == 8) && kind >= KIND_F32 &&
         kind <= KIND_BF16_INT8;
}

extern "C" {

// How many splits lmr_decode cuts each row's positions into on the
// current device: from the cache capacity S, the row count B·H_kv and
// the SM count, never from t (0: invalid arguments, or the device could
// not be queried). Above 1 the caller passes scratch for the splits'
// states.
int lmr_decode_splits(int rows, int S, int D, int G, int kind) {
  if (!valid(rows, S, D, G, kind)) return 0;
  const int sms = sm90::sm_count();
  if (sms <= 0) return 0;
  const int by_sm = (BLOCKS_PER_SM * sms + rows - 1) / rows;
  const int by_len = S / MIN_SPLIT;
  const int n = by_sm < by_len ? by_sm : by_len;
  return n < 1 ? 1 : n;
}

// q: (B, Hkv, G, D) with element strides sqb/sqh/sqg, head dim
// contiguous; k/v: contiguous (B, Hkv, S, D), 16-byte aligned; ks/vs:
// contiguous (B, Hkv, S) f32 (KIND_BF16_INT8 only, else null); o:
// contiguous (B, Hkv, G, D) f32; pm/pl (B·Hkv, n_split, G) and pacc
// (B·Hkv, n_split, G, D) f32 scratch when lmr_decode_splits gives
// n_split > 1, else null; t: a device int64, the current position (slots
// [0, t] visible, every slot once roll is set and t >= S), read by the
// kernel, so a captured launch serves every t. Launches the split kernel
// and, with more than one split, the combine. Returns cudaGetLastError()
// after the launches (0 = launched).
int lmr_decode(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, void* o, void* pm, void* pl, void* pacc,
               const void* t, int roll, int B, int Hkv, int G, int D, int S,
               long long sqb, long long sqh, long long sqg, int kind,
               void* stream) {
  const long long rows = (long long)B * Hkv;
  if (!valid(rows, S, D, G, kind) || t == nullptr ||
      (kind == KIND_BF16_INT8 && (ks == nullptr || vs == nullptr)))
    return cudaErrorInvalidValue;
  const int n_split = lmr_decode_splits(static_cast<int>(rows), S, D, G, kind);
  if (n_split < 1 || (n_split > 1 && (pm == nullptr || pl == nullptr ||
                                      pacc == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<float*>(o), static_cast<float*>(pm),
         static_cast<float*>(pl), static_cast<float*>(pacc),
         static_cast<const long long*>(t), static_cast<int>(rows), Hkv, S,
         roll ? 1 : 0, (S + n_split - 1) / n_split, n_split, sqb, sqh, sqg,
         (float)(LOG2E / sqrt((double)D))};
  int rc;
  if (kind == KIND_F32) rc = launch_d<float, float>(D, G, a, s);
  else if (kind == KIND_BF16) rc = launch_d<bf16, bf16>(D, G, a, s);
  else rc = launch_d<bf16, int8_t>(D, G, a, s);
  if (rc != cudaSuccess) return rc;
  if (n_split > 1)
    decode_combine_kernel<<<a.rows, G * D, 0, s>>>(a.pm, a.pl, a.pacc, a.o,
                                                   n_split, G, D);
  return static_cast<int>(cudaGetLastError());
}

// The combine alone, on given split states (as lmr_decode lays them out).
int lmr_decode_combine(const void* pm, const void* pl, const void* pacc,
                       void* o, int rows, int n_split, int G, int D,
                       void* stream) {
  if (rows <= 0 || n_split <= 0 || G <= 0 || D <= 0 || G * D > 1024)
    return cudaErrorInvalidValue;
  decode_combine_kernel<<<rows, G * D, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(pacc), static_cast<float*>(o), n_split, G, D);
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
