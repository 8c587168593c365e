// VALID max / average pooling over NHWC on Hopper (sm_90a).
//
// Replaces: lua_mapreduce_tpu/ops/pool.py::_pool_kernel (driven by
// _pool_pallas; one kernel template here, both modes). The backward
// stays outside any kernel, as in the JAX op: the gradient of the plain
// composition (_pool_grad here, the VJP of _pool_xla there).
//
// What bounds it on the H100: bytes. Each output element is the max or
// mean of KH·KW inputs, a handful of operations per 2-4 bytes, far below
// the ~20 operations per byte where the 67 TFLOP/s FP32 rate would take
// over from the 3.35 TB/s of HBM3. The bound counts each input byte once;
// overlapping windows (3×3/2 reads an input pixel 2.25 times on average)
// have to find their repeats in L1/L2.
//
// What the design does about it:
//  * One thread per (output pixel, chunk of its channels). A chunk is 16
//    bytes (8 bf16 or 4 f32: the vector branch, when C·itemsize is a
//    multiple of 16 and both pointers are 16-byte aligned), else a bf16
//    pair or one element (the general branch, e.g. LeNet's C = 6, a
//    12-byte pixel). The block is (chunks, ow, oh): threadIdx.x walks a
//    pixel's chunks (looping when a pixel has more than the block's x
//    extent), so a warp's loads of one tap are contiguous along C (NHWC)
//    and each 16-byte load is whole.
//  * No 64-bit division anywhere and no division per element: ow, oh
//    and the chunk come from the 3-D grid (ow tiles, oh tiles, images),
//    offsets inside an image are 32-bit (the host refuses an image of
//    2^31 elements or more), and the image's base is one 64-bit pointer
//    step per image. The plan (ops/pool.py::pool_plan) is checked here by
//    plan_ok before the launch.
//  * The 2×2 and 3×3 windows are compile-time, so all KH·KW loads of a
//    thread are issued before the first compare; other windows loop.
//  * No padding: a VALID window never reads past (ho−1)·sh + kh − 1 ≤ h−1.
//  * max starts from the window's first element (as pool.py:38-39), never
//    from 0 or a sentinel, so an all -inf window (the stem's -inf border)
//    gives -inf, and NaN wins and then stays, as torch.maximum propagates
//    it. Taps combine in the plain version's order (i outer, j inner);
//    values compare as f32 (exact for bf16) and the winner's bits are
//    stored back as they were read (bf16: the f32's high half), so max
//    equals the plain version bit for bit in f32 and bf16.
//  * avg accumulates in f32 in the same order and divides once by KH·KW
//    (pool.py:39-45), rounding once more at a bf16 store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

using bf16 = __nv_bfloat16;

enum { DT_F32 = 0, DT_BF16 = 1 };
enum { MODE_MAX = 0, MODE_AVG = 1 };
enum { BRANCH_VECTOR = 0, BRANCH_GENERAL = 1 };

// The plans the kernels are instantiated for; ops/pool.py mirrors them
// (tests/test_torch_kernel_plans.py reads these lines).
#define POOL_MAX_THREADS 256
#define POOL_MAX_GRID_YZ 65535

// ---- a chunk of W elements as f32, and back

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t u16) {
  return __uint_as_float(u16 << 16);
}

template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* p, float* v) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (W == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      static_assert(W == 1, "f32 chunks are 16 bytes or one element");
      v[0] = __ldg(reinterpret_cast<const float*>(p));
    }
  } else {
    if constexpr (W == 8) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = bf16_bits_to_f32(w[i] & 0xffffu);
        v[2 * i + 1] = bf16_bits_to_f32(w[i] >> 16);
      }
    } else if constexpr (W == 2) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
      v[0] = bf16_bits_to_f32(w & 0xffffu);
      v[1] = bf16_bits_to_f32(w >> 16);
    } else {
      static_assert(W == 1, "bf16 chunks are 16 bytes, a pair or one");
      v[0] = bf16_bits_to_f32(
          __ldg(reinterpret_cast<const unsigned short*>(p)));
    }
  }
}

// EXACT: v holds values read from T (a max): store their bits as read.
// Otherwise round to nearest even (an average).
template <bool EXACT>
__device__ __forceinline__ uint32_t to_bf16_bits(float f) {
  if constexpr (EXACT) return __float_as_uint(f) >> 16;
  const bf16 h = __float2bfloat16(f);
  unsigned short u;
  memcpy(&u, &h, 2);
  return u;
}

template <typename T, int W, bool EXACT>
__device__ __forceinline__ void store_chunk(T* p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (W == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<float*>(p) = v[0];
  } else {
    uint32_t u[W];
#pragma unroll
    for (int i = 0; i < W; ++i) u[i] = to_bf16_bits<EXACT>(v[i]);
    if constexpr (W == 8)
      *reinterpret_cast<uint4*>(p) =
          make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16,
                     u[4] | u[5] << 16, u[6] | u[7] << 16);
    else if constexpr (W == 2)
      *reinterpret_cast<unsigned int*>(p) = u[0] | u[1] << 16;
    else
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)u[0];
  }
}

// ---- the kernel: KH, KW > 0 compile-time windows, 0 = runtime kh, kw
// (at least 1 block of POOL_MAX_THREADS an SM: with the thread count
// alone ptxas held the f32 16-byte avg kernel for runtime windows to 32
// registers and spilled)

template <typename T, int W, int MODE, int KH, int KW>
__global__ void __launch_bounds__(POOL_MAX_THREADS, 1)
pool_kernel(const T* __restrict__ X, T* __restrict__ Y, int n, int h,
            int w, int c, int kh_, int kw_, int sh, int sw, int ho,
            int wo) {
  const int kh = KH > 0 ? KH : kh_, kw = KW > 0 ? KW : kw_;
  const int ow = blockIdx.x * blockDim.y + threadIdx.y;
  const int oh = blockIdx.y * blockDim.z + threadIdx.z;
  if (ow >= wo || oh >= ho) return;
  const int chunks = c / W;
  const int in_img = h * w * c, out_img = ho * wo * c;   // < 2^31
  const int row = w * c;                                 // input row pitch
  const int in0 = (oh * sh * w + ow * sw) * c;
  const int out0 = (oh * wo + ow) * c;
  for (int b = blockIdx.z; b < n; b += gridDim.z) {
    const T* x = X + (size_t)b * in_img + in0;
    T* y = Y + (size_t)b * out_img + out0;
    for (int g = threadIdx.x; g < chunks; g += blockDim.x) {
      const int c0 = g * W;
      float acc[W];
      load_chunk<T, W>(x + c0, acc);
      // kh, kw are constants where KH, KW are: the loops unroll and all
      // the taps' loads are issued before the first combine
#pragma unroll
      for (int i = 0; i < kh; ++i)
#pragma unroll
        for (int j = 0; j < kw; ++j) {
          if (i == 0 && j == 0) continue;
          float v[W];
          load_chunk<T, W>(x + i * row + j * c + c0, v);
#pragma unroll
          for (int e = 0; e < W; ++e) {
            if constexpr (MODE == MODE_MAX) {
              // NaN wins and then stays: NaN > anything and anything >
              // NaN are both false, so a NaN best is only replaced by a
              // NaN
              if (v[e] > acc[e] || v[e] != v[e]) acc[e] = v[e];
            } else {
              acc[e] += v[e];
            }
          }
        }
      if constexpr (MODE == MODE_MAX) {
        store_chunk<T, W, true>(y + c0, acc);
      } else {
        const float taps = (float)(kh * kw);
#pragma unroll
        for (int e = 0; e < W; ++e) acc[e] = acc[e] / taps;
        store_chunk<T, W, false>(y + c0, acc);
      }
    }
  }
}

// ---- the plan

struct Plan {
  int branch, width, bx, by, bz, gx, gy, gz;
};

static bool plan_ok(const Plan& p, const void* x, const void* y, int n,
                    int h, int w, int c, int ho, int wo, int item) {
  const int chunk = p.width * item;
  const bool vector = chunk == 16;
  if (p.branch != (vector ? BRANCH_VECTOR : BRANCH_GENERAL)) return false;
  if (!(p.width == 1 || (item == 2 && p.width == 2) || vector)) return false;
  if (c % p.width != 0 || reinterpret_cast<uintptr_t>(x) % chunk != 0 ||
      reinterpret_cast<uintptr_t>(y) % chunk != 0)
    return false;
  if ((long long)h * w * c > 2147483647LL ||
      (long long)ho * wo * c > 2147483647LL)
    return false;
  if (p.bx < 1 || p.by < 1 || p.bz < 1 || p.bx > c / p.width ||
      p.bx * p.by * p.bz > POOL_MAX_THREADS)
    return false;
  return p.gx >= 1 && p.gy >= 1 && p.gz >= 1 &&
         (long long)p.gx * p.by >= wo && (long long)p.gy * p.bz >= ho &&
         p.gy <= POOL_MAX_GRID_YZ && p.gz <= POOL_MAX_GRID_YZ && p.gz <= n;
}

template <typename T, int W, int MODE>
static void launch_w(const Plan& p, const T* x, T* y, int n, int h, int w,
                     int c, int kh, int kw, int sh, int sw, int ho, int wo,
                     cudaStream_t s) {
  const dim3 grid(p.gx, p.gy, p.gz), block(p.bx, p.by, p.bz);
  if (kh == 2 && kw == 2)
    pool_kernel<T, W, MODE, 2, 2><<<grid, block, 0, s>>>(
        x, y, n, h, w, c, kh, kw, sh, sw, ho, wo);
  else if (kh == 3 && kw == 3)
    pool_kernel<T, W, MODE, 3, 3><<<grid, block, 0, s>>>(
        x, y, n, h, w, c, kh, kw, sh, sw, ho, wo);
  else
    pool_kernel<T, W, MODE, 0, 0><<<grid, block, 0, s>>>(
        x, y, n, h, w, c, kh, kw, sh, sw, ho, wo);
}

template <typename T, int MODE>
static void launch_t(const Plan& p, const void* x, void* y, int n, int h,
                     int w, int c, int kh, int kw, int sh, int sw, int ho,
                     int wo, cudaStream_t s) {
  const T* X = static_cast<const T*>(x);
  T* Y = static_cast<T*>(y);
  constexpr int V = 16 / sizeof(T);
  if (p.width == V)
    launch_w<T, V, MODE>(p, X, Y, n, h, w, c, kh, kw, sh, sw, ho, wo, s);
  else if constexpr (sizeof(T) == 2) {
    if (p.width == 2)
      launch_w<T, 2, MODE>(p, X, Y, n, h, w, c, kh, kw, sh, sw, ho, wo, s);
    else
      launch_w<T, 1, MODE>(p, X, Y, n, h, w, c, kh, kw, sh, sw, ho, wo, s);
  } else {
    launch_w<T, 1, MODE>(p, X, Y, n, h, w, c, kh, kw, sh, sw, ho, wo, s);
  }
}

extern "C" {

// x: contiguous (n, h, w, c); y: contiguous (n, ho, wo, c) with
// ho = (h − kh)/sh + 1, wo = (w − kw)/sw + 1. The plan (branch, width,
// block bx·by·bz, grid gx·gy·gz) comes from ops/pool.py::pool_plan; one
// it cannot run is refused with cudaErrorInvalidValue before any launch.
// Returns cudaGetLastError() after the launch (0 = launched).
int lmr_pool(const void* x, void* y, int n, int h, int w, int c, int kh,
             int kw, int sh, int sw, int dtype, int mode, int branch,
             int width, int bx, int by, int bz, int gx, int gy, int gz,
             void* stream) {
  if (n <= 0 || c <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      kh > h || kw > w || (mode != MODE_MAX && mode != MODE_AVG) ||
      (dtype != DT_F32 && dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const int ho = (h - kh) / sh + 1, wo = (w - kw) / sw + 1;
  const Plan p{branch, width, bx, by, bz, gx, gy, gz};
  if (!plan_ok(p, x, y, n, h, w, c, ho, wo, dtype == DT_F32 ? 4 : 2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    if (mode == MODE_MAX)
      launch_t<float, MODE_MAX>(p, x, y, n, h, w, c, kh, kw, sh, sw, ho,
                                wo, s);
    else
      launch_t<float, MODE_AVG>(p, x, y, n, h, w, c, kh, kw, sh, sw, ho,
                                wo, s);
  } else {
    if (mode == MODE_MAX)
      launch_t<bf16, MODE_MAX>(p, x, y, n, h, w, c, kh, kw, sh, sw, ho, wo,
                               s);
    else
      launch_t<bf16, MODE_AVG>(p, x, y, n, h, w, c, kh, kw, sh, sw, ho, wo,
                               s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lmr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
