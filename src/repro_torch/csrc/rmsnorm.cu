// RMSNorm on the card, CUDA C++ for sm_90a with a plain C interface (bound
// with ctypes by repro_torch/kernels/rmsnorm/kernel.py).
//
// Replaces the Pallas TPU kernel rmsnorm_fwd of
// repro/kernels/rmsnorm/kernel.py (:24, pallas_call at :35, _rmsnorm_kernel):
// per row of x (R, d), y = x * rsqrt(mean(x^2) + eps) * scale, all in
// float32, y cast to the type of x.  x is bfloat16 or float32, scale float32.
//
// Rounding follows the reference: the sum of squares in float32 (in another
// order than torch.mean: lanes, then a warp tree), ms = sum / d, the IEEE
// round-to-nearest reciprocal square root (__frsqrt_rn, not the approximate
// rsqrtf; no fast-math), then (x * r) * scale with two rounded products and
// one rounding to the output type.
//
// What bounds it.  It reads each element once and writes it once and does
// about 4 operations per element: at the serving path's prefill shape
// (R = 8 * 2048 rows, d = 768 or 1536, bfloat16) that is 0.5 operations per
// byte, so HBM bytes bound it (50 MB at d = 768: 15 us at 3.35 TB/s).  In
// decode R = 8 and the launch itself is all of the cost.
//
// Design.  One warp per row, four rows per block of 128 threads.  Each lane
// reads 16 bytes at a time (8 bfloat16 or 4 float32; neighbouring lanes read
// neighbouring 16-byte words, so each warp load is one coalesced 512-byte
// transaction) when d is a multiple of the vector width and the rows start
// 16-byte aligned, and one element at a time otherwise.  The row is read
// twice: once for the sum of squares, once to scale and write.  The second
// read hits L1 (a row is at most a few KB), so device memory sees one read.
// The sum is reduced across the warp with shuffles; nothing goes through
// shared memory and no block-wide barrier is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               int R, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps leave together: the shuffles below stay full
  const int nv = d / VEC;
  const Vec<T, VEC>* xr = reinterpret_cast<const Vec<T, VEC>*>(x + (size_t)row * d);
  Vec<T, VEC>* yr = reinterpret_cast<Vec<T, VEC>*>(y + (size_t)row * d);

  float ss = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const Vec<T, VEC> a = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(a.v[j]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)d), eps));

  for (int i = lane; i < nv; i += 32) {
    const Vec<T, VEC> a = xr[i];
    Vec<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float s = __ldg(scale + i * VEC + j);
      o.v[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(a.v[j]), r), s));
    }
    yr[i] = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* scale, void* y, int R, int d, float eps,
            cudaStream_t stream) {
  const dim3 grid((R + WARPS - 1) / WARPS), block(WARPS * 32);
  rmsnorm_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(y), R, d,
      eps);
}

}  // namespace

// x, y: (R, d) of one type (bf16 != 0: bfloat16, else float32), contiguous;
// scale: (d,) float32.  Returns the CUDA error of the launch (0: launched).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int R, int d,
                              int bf16, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (bf16) {
    if (aligned && d % 8 == 0)
      launch<__nv_bfloat16, 8>(x, scale, y, R, d, eps, s);
    else
      launch<__nv_bfloat16, 1>(x, scale, y, R, d, eps, s);
  } else {
    if (aligned && d % 4 == 0)
      launch<float, 4>(x, scale, y, R, d, eps, s);
    else
      launch<float, 1>(x, scale, y, R, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
