// Row-wise log_softmax / softmax over the last axis on Hopper (sm_90a).
//
// Replaces: lua_mapreduce_tpu/ops/softmax.py::_log_softmax_kernel and
// ::_softmax_kernel (one source here, `mode` selects the output), both
// driven by _rowwise_pallas.
//
// What bounds it on the H100: bytes. Each element is read once and
// written once, with a handful of f32 operations and one exponential
// in between, far below the ~20 operations per byte where the 67
// TFLOP/s FP32 rate (or the MUFU's exponentials) would take over from
// the 3.35 TB/s of HBM3. Narrow rows (the digits' and LeNet's 10
// classes, ResNet's 1000) are a few KB to 64 KB in all: the launch
// dominates there.
//
// What the design does about it: three branches of one source, chosen
// per call by ops/softmax.py::softmax_plan (rows, n, dtype, alignment)
// and checked here by plan_ok, which refuses a plan it cannot run.
//  * warp   (n <= 1024): one warp per row, several rows per block; the
//    row sits in the lanes' registers (E elements a lane), the max and
//    the sum are warp shuffles only: no shared memory, no
//    __syncthreads.
//  * regs   (1024 < n <= 16384): one block per row, the row held in
//    registers (E = 16 or 32 elements a thread). Every thread issues all
//    of its loads up front, the block reduces the max, then
//    Σ exp2((x − m)·log2 e) with one exponential per element, then
//    writes (x − m) − log s or e·(1/s). Device memory sees one read and
//    one write per element.
//  * stream (n > 16384, e.g. 32k-wide vocab rows): one block per row,
//    rows of any width. Pass 1 folds chunks of 4 accesses a thread into
//    an online (max, sum) pair, one rescale per chunk (so about one
//    exponential per element); pass 2 reads the row again (from L2 at
//    these widths) and writes it.
//  Each branch runs with 16-byte accesses (8 bf16 or 4 f32) when both
//  pointers and both row pitches are 16-byte aligned and with one
//  element per access otherwise, so a misaligned view still runs here.
//  Columns past n are masked, never padded. All math is f32; the output
//  is in the input dtype. Sums are taken in a fixed order, so two calls
//  are bit-equal. Stable at extreme values: a row's max comes first, so
//  exp2 only sees x − m <= 0; a −inf entry gives exp2(−inf) = 0 and
//  never meets inf − inf unless the row is all −inf or holds +inf or
//  NaN, where the plain version gives NaN too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { MODE_LOG_SOFTMAX = 0, MODE_SOFTMAX = 1 };
enum { BRANCH_WARP = 0, BRANCH_REGS = 1, BRANCH_STREAM = 2 };

// The plans the kernels below are instantiated for; ops/softmax.py
// mirrors them (tests/test_torch_kernel_plans.py reads these lines).
#define WARP_MAX_N 1024
#define WARP_ROWS 4
#define WARP_ELEMS(X) X(1) X(2) X(4) X(8) X(16) X(32)
#define REGS_ELEMS(X) X(16) X(32)
#define REGS_MAX_THREADS 512
#define STREAM_THREADS 512
#define STREAM_LOADS 4

constexpr float kLog2e = 1.4426950408889634f;

// ---- W elements of T at a time, as f32 (W = 16 bytes' worth, or 1)

template <int W>
__device__ __forceinline__ void load_w(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(W == 1, "f32 accesses are 16 bytes or one element");
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, 4);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

template <int W>
__device__ __forceinline__ void load_w(const bf16* p, float* v) {
  if constexpr (W == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack2(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(W == 1, "bf16 accesses are 16 bytes or one element");
    v[0] = __bfloat162float(p[0]);
  }
}

template <int W>
__device__ __forceinline__ void store_w(float* p, const float* v) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    p[0] = v[0];
}

template <int W>
__device__ __forceinline__ void store_w(bf16* p, const float* v) {
  if constexpr (W == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(
        pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
        pack2(v[6], v[7]));
  else
    p[0] = __float2bfloat16(v[0]);
}

// ---- reductions

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// every thread of the block gets the same value: warp 0's partial
// first, then the others in order
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  return r;
}

// fold (m2, s2) into the running (m, s), s a sum of exp(x − m)
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) {        // both empty or all -inf: s, s2 are 0 or
    s += s2;                    // NaN (a NaN entry), and NaN must stay
    return;
  }
  s = s * exp2f((m - mn) * kLog2e) + s2 * exp2f((m2 - mn) * kLog2e);
  m = mn;
}

// ---- the register-resident row: E elements a thread, slot k of thread
// t covering access k·stride + t (W elements each), as the warp and
// regs branches share it

// v[] holds the row's values (−inf past its end); replace them with
// x − m (log_softmax) or exp(x − m) (softmax) and return this thread's
// share of Σ exp(x − m)
template <int W, int E>
__device__ __forceinline__ float exp_pass(float (&v)[E], float m, int t,
                                          int stride, int nv, int mode) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < E / W; ++k) {
    if (k * stride + t < nv) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float d = v[k * W + w] - m;
        const float e = exp2f(d * kLog2e);
        s += e;
        v[k * W + w] = mode == MODE_SOFTMAX ? e : d;
      }
    }
  }
  return s;
}

template <typename T, int W, int E>
__device__ __forceinline__ void load_row(const T* x, float (&v)[E], int t,
                                         int stride, int nv) {
#pragma unroll
  for (int k = 0; k < E / W; ++k) {
    if (k * stride + t < nv) {
      load_w<W>(x + (k * stride + t) * W, v + k * W);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) v[k * W + w] = -INFINITY;
    }
  }
}

template <typename T, int W, int E>
__device__ __forceinline__ void store_row(T* y, float (&v)[E], int t,
                                          int stride, int nv, float shift,
                                          float scale) {
#pragma unroll
  for (int k = 0; k < E / W; ++k) {
    if (k * stride + t < nv) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        v[k * W + w] = (v[k * W + w] - shift) * scale;
      store_w<W>(y + (k * stride + t) * W, v + k * W);
    }
  }
}

// ---- warp: one warp per row, WARP_ROWS rows a block

template <typename T, int W, int E>
__global__ void __launch_bounds__(32 * WARP_ROWS)
softmax_warp_kernel(const T* __restrict__ X, T* __restrict__ Y, int rows,
                    int n, long long ldx, int mode) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;                   // the whole warp leaves
  const int nv = n / W;
  float v[E];
  load_row<T, W, E>(X + row * ldx, v, lane, 32, nv);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < E; ++i) m = fmaxf(m, v[i]);
  m = warp_max(m);
  const float s = warp_sum(exp_pass<W, E>(v, m, lane, 32, nv, mode));
  if (mode == MODE_SOFTMAX)
    store_row<T, W, E>(Y + (long long)row * n, v, lane, 32, nv, 0.f,
                       1.f / s);
  else
    store_row<T, W, E>(Y + (long long)row * n, v, lane, 32, nv, logf(s),
                       1.f);
}

// ---- regs: one block per row, the row in registers

template <typename T, int W, int E>
__global__ void __launch_bounds__(REGS_MAX_THREADS)
softmax_regs_kernel(const T* __restrict__ X, T* __restrict__ Y, int n,
                    long long ldx, int mode) {
  __shared__ float red_m[32], red_s[32];
  const long long row = blockIdx.x;
  const int nv = n / W;
  float v[E];
  load_row<T, W, E>(X + row * ldx, v, threadIdx.x, blockDim.x, nv);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < E; ++i) m = fmaxf(m, v[i]);
  m = block_max(m, red_m);
  const float s = block_sum(
      exp_pass<W, E>(v, m, threadIdx.x, blockDim.x, nv, mode), red_s);
  if (mode == MODE_SOFTMAX)
    store_row<T, W, E>(Y + row * n, v, threadIdx.x, blockDim.x, nv, 0.f,
                       1.f / s);
  else
    store_row<T, W, E>(Y + row * n, v, threadIdx.x, blockDim.x, nv,
                       logf(s), 1.f);
}

// ---- stream: one block per row, rows of any width, read twice

template <typename T, int W>
__global__ void __launch_bounds__(STREAM_THREADS)
softmax_stream_kernel(const T* __restrict__ X, T* __restrict__ Y, int n,
                      long long ldx, int mode) {
  constexpr int E = STREAM_LOADS * W;
  __shared__ float red_m[32], red_s[32];
  const long long row = blockIdx.x;
  const T* x = X + row * ldx;
  T* y = Y + row * n;
  const int nv = n / W, t = threadIdx.x, nt = blockDim.x;
  const int step = STREAM_LOADS * nt;
  float m = -INFINITY, s = 0.f;
  for (int base = 0; base < nv; base += step) {
    float v[E];
    load_row<T, W, E>(x + base * W, v, t, nt, nv - base);
    float cm = -INFINITY;
#pragma unroll
    for (int i = 0; i < E; ++i) cm = fmaxf(cm, v[i]);
    const float mn = fmaxf(m, cm);       // fmaxf passes NaN over
    // shift by the new max; while the thread has seen nothing but -inf,
    // by 0, so that -inf entries add exp2(-inf) = 0 and NaN ones NaN
    const float ref = mn == -INFINITY ? 0.f : mn;
    float cs = 0.f;
#pragma unroll
    for (int k = 0; k < STREAM_LOADS; ++k)
      if (base + k * nt + t < nv) {
#pragma unroll
        for (int w = 0; w < W; ++w)
          cs += exp2f((v[k * W + w] - ref) * kLog2e);
      }
    s = s * exp2f((m - ref) * kLog2e) + cs;
    m = mn;
  }
  // merge the threads' pairs: shuffles, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if ((t & 31) == 0) { red_m[t >> 5] = m; red_s[t >> 5] = s; }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < (nt >> 5); ++w) merge(m, s, red_m[w], red_s[w]);

  const float lse = logf(s), inv = 1.f / s;
  for (int base = 0; base < nv; base += step) {
    float v[E];
    load_row<T, W, E>(x + base * W, v, t, nt, nv - base);
#pragma unroll
    for (int i = 0; i < E; ++i)
      v[i] = mode == MODE_SOFTMAX ? exp2f((v[i] - m) * kLog2e) * inv
                                  : (v[i] - m) - lse;
#pragma unroll
    for (int k = 0; k < STREAM_LOADS; ++k)
      if (base + k * nt + t < nv)
        store_w<W>(y + (base + k * nt + t) * W, v + k * W);
  }
}

// ---- the plan

struct Plan {
  int branch, vector, per_thread, threads, rows_per_block;
  long long blocks;
};

static bool is_warp_elems(int e) {
#define X(v) if (e == v) return true;
  WARP_ELEMS(X)
#undef X
  return false;
}

static bool is_regs_elems(int e) {
#define X(v) if (e == v) return true;
  REGS_ELEMS(X)
#undef X
  return false;
}

// what a launch of the plan needs, checked before it is made
static bool plan_ok(const Plan& p, const void* x, const void* y,
                    long long rows, int n, long long ldx, int item) {
  if (p.threads < 32 || p.threads % 32 != 0 || p.threads > 1024)
    return false;
  const int w = p.vector ? 16 / item : 1;
  if (p.vector &&
      (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
       reinterpret_cast<uintptr_t>(y) % 16 != 0 || n % w != 0 ||
       ldx % w != 0))
    return false;
  switch (p.branch) {
    case BRANCH_WARP:
      return n <= WARP_MAX_N && is_warp_elems(p.per_thread) &&
             p.per_thread % w == 0 && 32LL * p.per_thread >= n &&
             p.rows_per_block == WARP_ROWS &&
             p.threads == 32 * WARP_ROWS &&
             p.blocks == (rows + WARP_ROWS - 1) / WARP_ROWS;
    case BRANCH_REGS:
      return is_regs_elems(p.per_thread) && p.per_thread % w == 0 &&
             p.threads <= REGS_MAX_THREADS &&
             (long long)p.threads * p.per_thread >= n &&
             p.rows_per_block == 1 && p.blocks == rows;
    case BRANCH_STREAM:
      return p.per_thread == STREAM_LOADS && p.threads == STREAM_THREADS &&
             p.rows_per_block == 1 && p.blocks == rows;
    default:
      return false;
  }
}

template <typename T, int W>
static int launch(const Plan& p, const T* x, T* y, long long rows, int n,
                  long long ldx, int mode, cudaStream_t s) {
  const dim3 grid((unsigned)p.blocks), block(p.threads);
  switch (p.branch) {
    case BRANCH_WARP:
#define X(v)                                                          \
  if constexpr (v % W == 0)                                           \
    if (p.per_thread == v) {                                          \
      softmax_warp_kernel<T, W, v><<<grid, block, 0, s>>>(            \
          x, y, (int)rows, n, ldx, mode);                             \
      return 0;                                                       \
    }
      WARP_ELEMS(X)
#undef X
      break;
    case BRANCH_REGS:
#define X(v)                                                          \
  if constexpr (v % W == 0)                                           \
    if (p.per_thread == v) {                                          \
      softmax_regs_kernel<T, W, v><<<grid, block, 0, s>>>(x, y, n,    \
                                                          ldx, mode); \
      return 0;                                                       \
    }
      REGS_ELEMS(X)
#undef X
      break;
    case BRANCH_STREAM:
      softmax_stream_kernel<T, W><<<grid, block, 0, s>>>(x, y, n, ldx,
                                                         mode);
      return 0;
  }
  return -1;
}

template <typename T>
static int launch_t(const Plan& p, const void* x, void* y, long long rows,
                    int n, long long ldx, int mode, cudaStream_t s) {
  const T* X = static_cast<const T*>(x);
  T* Y = static_cast<T*>(y);
  if (p.vector) return launch<T, (int)(16 / sizeof(T))>(p, X, Y, rows, n, ldx,
                                                 mode, s);
  return launch<T, 1>(p, X, Y, rows, n, ldx, mode, s);
}

extern "C" {

// x: (rows, n) with row pitch ldx elements and unit column stride;
// y: contiguous (rows, n). The plan (branch, vector, per_thread,
// threads, rows_per_block, blocks) comes from ops/softmax.py::
// softmax_plan; one it cannot run is refused with cudaErrorInvalidValue
// before any launch. Returns cudaGetLastError() after the launch
// (0 = launched).
int lmr_softmax(const void* x, void* y, long long rows, int n,
                long long ldx, int dtype, int mode, int branch, int vector,
                int per_thread, int threads, int rows_per_block,
                long long blocks, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || n <= 0 || ldx < n ||
      (mode != MODE_LOG_SOFTMAX && mode != MODE_SOFTMAX) ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const Plan p{branch, vector, per_thread, threads, rows_per_block, blocks};
  const int item = dtype == DT_F32 ? 4 : 2;
  if (!plan_ok(p, x, y, rows, n, ldx, item)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dtype == DT_F32
                     ? launch_t<float>(p, x, y, rows, n, ldx, mode, s)
                     : launch_t<bf16>(p, x, y, rows, n, ldx, mode, s);
  if (rc != 0) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
