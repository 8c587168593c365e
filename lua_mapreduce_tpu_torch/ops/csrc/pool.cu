// VALID max / average pooling over NHWC on Hopper (sm_90a).
//
// Replaces: lua_mapreduce_tpu/ops/pool.py::_pool_kernel (driven by
// _pool_pallas; one kernel here, both modes selected by `mode`). The
// backward stays outside any kernel, as in the JAX op: the autograd of
// the plain composition (_pool_plain here, _pool_xla there).
//
// What bounds it on the H100: bytes. Each output element is the max or
// mean of KH·KW inputs — a handful of operations per 2-4 bytes, far below
// the ~20 operations per byte where the 67 TFLOP/s FP32 rate would take
// over from the 3.35 TB/s of HBM3. Overlapping windows (3×3/2) read some
// inputs twice, but the second read hits L1/L2.
//
// What this simple design does about it:
//  * The TPU kernel takes one image per grid step and pads its VMEM block
//    to slice headroom. Here one thread computes one output element, c
//    fastest, so a warp's loads of one window tap are contiguous along C
//    (NHWC) and coalesce; a grid-stride loop covers any size.
//  * No padding: a VALID window never reads past (ho−1)·sh + kh − 1 ≤ h−1,
//    so the unpadded input is read in place.
//  * max starts from the window's first element (as pool.py:38-39), never
//    from 0 or a sentinel, so an all -inf window (the stem's -inf border)
//    gives -inf, and NaN propagates as torch.maximum propagates it. Taps
//    combine in the plain version's order (i outer, j inner), so max
//    equals it bit for bit in f32 and bf16.
//  * avg accumulates in f32 in the same order and divides once by KH·KW
//    (pool.py:39-45). f32 differs from the plain version at most by the
//    last bit of that division (torch divides a CUDA tensor by a scalar
//    as a multiply by its reciprocal); bf16 rounds once at the store
//    where the plain version rounds after every add.
//  * Left for later work: 16-byte vector loads along C (C is 6 in LeNet's
//    first pool), keeping a row of windows in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { MODE_MAX = 0, MODE_AVG = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int MODE>
__global__ void pool_kernel(const T* __restrict__ X, T* __restrict__ Y,
                            int h, int w, int c, int kh, int kw, int sh,
                            int sw, int ho, int wo, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < total; o += step) {
    const int ch = (int)(o % c);
    long long r = o / c;
    const int ow = (int)(r % wo);
    r /= wo;
    const int oh = (int)(r % ho);
    const long long n = r / ho;
    const T* x = X + ((n * h + (long long)oh * sh) * w +
                      (long long)ow * sw) * c + ch;
    if (MODE == MODE_MAX) {
      // compare as f32 (exact for bf16) and keep the element itself
      T best = x[0];
      float bv = to_f32(best);
      for (int i = 0; i < kh; ++i)
        for (int j = 0; j < kw; ++j) {
          if (i == 0 && j == 0) continue;
          const T v = x[((long long)i * w + j) * c];
          const float fv = to_f32(v);
          // NaN wins and then stays: NaN > anything and anything > NaN
          // are both false, so a NaN best is never replaced
          if (fv > bv || fv != fv) { best = v; bv = fv; }
        }
      Y[o] = best;
    } else {
      float acc = 0.f;
      for (int i = 0; i < kh; ++i)
        for (int j = 0; j < kw; ++j)
          acc += to_f32(x[((long long)i * w + j) * c]);
      store_as(&Y[o], acc / (float)(kh * kw));
    }
  }
}

template <typename T>
static void launch(const void* x, void* y, int h, int w, int c, int kh,
                   int kw, int sh, int sw, int ho, int wo, long long total,
                   int mode, cudaStream_t s) {
  constexpr int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;    // grid-stride beyond
  const T* X = static_cast<const T*>(x);
  T* Y = static_cast<T*>(y);
  if (mode == MODE_MAX)
    pool_kernel<T, MODE_MAX><<<(unsigned)blocks, threads, 0, s>>>(
        X, Y, h, w, c, kh, kw, sh, sw, ho, wo, total);
  else
    pool_kernel<T, MODE_AVG><<<(unsigned)blocks, threads, 0, s>>>(
        X, Y, h, w, c, kh, kw, sh, sw, ho, wo, total);
}

extern "C" {

// x: contiguous (n, h, w, c); y: contiguous (n, ho, wo, c) with
// ho = (h − kh)/sh + 1, wo = (w − kw)/sw + 1. Returns cudaGetLastError()
// after the launch (0 = launched).
int lmr_pool(const void* x, void* y, int n, int h, int w, int c, int kh,
             int kw, int sh, int sw, int dtype, int mode, void* stream) {
  if (n <= 0 || c <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      kh > h || kw > w || (mode != MODE_MAX && mode != MODE_AVG))
    return cudaErrorInvalidValue;
  const int ho = (h - kh) / sh + 1, wo = (w - kw) / sw + 1;
  const long long total = (long long)n * ho * wo * c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    launch<float>(x, y, h, w, c, kh, kw, sh, sw, ho, wo, total, mode, s);
  else if (dtype == DT_BF16)
    launch<bf16>(x, y, h, w, c, kh, kw, sh, sw, ho, wo, total, mode, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
