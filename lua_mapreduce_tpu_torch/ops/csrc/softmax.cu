// Row-wise log_softmax / softmax over the last axis on Hopper (sm_90a).
//
// Replaces: lua_mapreduce_tpu/ops/softmax.py::_log_softmax_kernel and
// ::_softmax_kernel (one kernel here, selected by `mode`), both driven
// by _rowwise_pallas.
//
// What bounds it on the H100: bytes. Each element is read, exp'd and
// written once (a handful of FLOPs per 2-4 bytes), far below the ~20
// operations per byte where the 67 TFLOP/s FP32 rate would take over
// from the 3.35 TB/s of HBM3. At the digits shapes ((128,10), (200,10))
// the whole tensor is a few KB and the launch dominates.
//
// What this simple design does about it:
//  * One block per row, all math in f32 (as the TPU kernel does): one
//    pass reads the row once keeping an online (max, sum of exp) pair
//    per thread, merged across the warp by shuffles and across warps in
//    shared memory; a second pass reads the row again (from L1/L2 — a
//    row is at most tens of KB) and writes (x − max) − log(sum) for
//    log_softmax or exp(x − max) / sum for softmax, in the input dtype.
//    So device memory sees one read and one write per element.
//  * The block is 32 threads for narrow rows (the digits' 10 classes)
//    and up to 512 for wide ones, picked by the host entry point.
//  * Columns past n are never touched: there is no dtype-min padding
//    (the TPU kernel pads to 128 lanes); the loop bounds mask them.
//  * Stable at extreme values: the running max starts at -inf and an
//    all--inf partial merges as empty, so exp never sees inf − inf.
//  * Left for later work: 16-byte vector loads, several rows per block
//    for narrow rows, keeping a wide row in registers between passes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { MODE_LOG_SOFTMAX = 0, MODE_SOFTMAX = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// fold (m2, s2) into the running (m, s): s is a sum of exp(x − m)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;          // both partials empty / all -inf
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T, int MODE>
__global__ void rowwise_softmax_kernel(const T* __restrict__ X,
                                       T* __restrict__ Y, int n) {
  __shared__ float sm[32], ss[32];
  const long long row = blockIdx.x;
  const T* x = X + row * n;
  T* y = Y + row * n;

  float m = -INFINITY, s = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) merge(m, s, to_f32(x[j]), 1.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  if (nwarps > 1) {
    if (lane == 0) { sm[warp] = m; ss[warp] = s; }
    __syncthreads();
    if (warp == 0) {
      m = lane < nwarps ? sm[lane] : -INFINITY;
      s = lane < nwarps ? ss[lane] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        merge(m, s, m2, s2);
      }
      if (lane == 0) { sm[0] = m; ss[0] = s; }
    }
    __syncthreads();
    m = sm[0];
    s = ss[0];
  }

  if (MODE == MODE_LOG_SOFTMAX) {
    const float lse = logf(s);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      store_as(&y[j], (to_f32(x[j]) - m) - lse);
  } else {
    const float inv = 1.f / s;
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      store_as(&y[j], expf(to_f32(x[j]) - m) * inv);
  }
}

template <typename T>
static void launch(const void* x, void* y, long long rows, int n, int mode,
                   int threads, cudaStream_t s) {
  const T* X = static_cast<const T*>(x);
  T* Y = static_cast<T*>(y);
  if (mode == MODE_LOG_SOFTMAX)
    rowwise_softmax_kernel<T, MODE_LOG_SOFTMAX><<<rows, threads, 0, s>>>(X, Y, n);
  else
    rowwise_softmax_kernel<T, MODE_SOFTMAX><<<rows, threads, 0, s>>>(X, Y, n);
}

extern "C" {

// x, y: contiguous (rows, n). Returns cudaGetLastError() after the
// launch (0 = launched).
int lmr_rowwise_softmax(const void* x, void* y, long long rows, int n,
                        int dtype, int mode, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || n <= 0 ||
      (mode != MODE_LOG_SOFTMAX && mode != MODE_SOFTMAX))
    return cudaErrorInvalidValue;
  // 32 threads for narrow rows, then one more warp per 64 columns, up
  // to 16 warps
  int threads = ((n + 63) / 64) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    launch<float>(x, y, rows, n, mode, threads, s);
  else if (dtype == DT_BF16)
    launch<bf16>(x, y, rows, n, mode, threads, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
