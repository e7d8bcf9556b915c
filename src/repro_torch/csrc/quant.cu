// Per-row symmetric int8 quantization on the card, CUDA C++ for sm_90a with a
// plain C interface (bound with ctypes by repro_torch/kernels/quant/kernel.py).
//
// Replaces the Pallas TPU kernel quantize_int8_fwd of
// repro/kernels/quant/kernel.py (:24, pallas_call at :33, _quant_kernel):
// per row of x (R, d), in float32,
//   scale = max(amax, 1e-12) / 127,   q = clip(round(x / scale), -127, 127),
// q int8 (R, d), scale float32 (R, 1); x is bfloat16 or float32.
//
// Rounding follows the reference bit for bit: both divisions are IEEE
// round-to-nearest (__fdiv_rn; no fast-math, no flush to zero), the round is
// half to even (rintf), and the clamp comes before the narrowing.  Three
// rules XLA gives the reference that CUDA does not: the row max keeps NaN
// (fmaxf drops it), the 1e-12 floor keeps a NaN max (fmaxf would replace it),
// and an element that is NaN after the round (a NaN or infinite scale)
// becomes 0 rather than going through an undefined float-to-int conversion.
// So a row holding NaN gets a NaN scale and all-zero codes, one holding an
// infinity an infinite scale and all-zero codes, as in JAX.
//
// What bounds it.  Each element is read once and its code written once:
// 5 bytes per float32 element, 3 per bfloat16 one, plus 4 per row, against a
// handful of float operations (abs, max, one division, round, clamp).  So HBM
// bytes bound it: the smollm-135m gradient tree's 135 M float32 elements
// move 0.68 GB, 0.2 ms at 3.35 TB/s.
//
// Design.  One block per row (a grid-stride loop over rows beyond the grid),
// two passes over the row: a max-abs reduction (lanes, then warp shuffles,
// then one word per warp in shared memory), and a second pass that divides,
// rounds and writes the codes.  Each thread reads 16 bytes at a time (4
// float32 or 8 bfloat16; neighbouring threads on neighbouring words) and
// writes its 4 or 8 codes in one store, when d is a multiple of the vector
// width and the rows are 16-byte aligned; one element at a time otherwise.
// The block has as many threads as the row has vectors, rounded up to a
// warp, at most 256 (1024 when there are fewer rows than two per SM, so that
// a lone wide row is not left to a few warps).  The second pass re-reads the
// row: a row of a few KB (every smollm-135m row is at most 6 KB) is still in
// L1, so device memory sees one read; a row too wide for L1 and L2 together
// with the other rows in flight (llama3-8b's head, 513 KB) is read twice.
// Offsets are 64-bit: a stacked expert leaf has more than 2^31 elements.
// Any d >= 1 and any R work; nothing is staged in shared memory, so the row
// width has no limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that keeps NaN (the reference's jnp.max does; fmaxf does not)
__device__ __forceinline__ float max_nan(float m, float a) { return (a > m || a != a) ? a : m; }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <int VEC>
struct alignas(VEC) Codes {
  int8_t v[VEC];
};

__device__ __forceinline__ int8_t code(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (r != r) return 0;  // NaN: 0, as XLA converts it
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

// The block's NaN-keeping max of m; every thread gets it.  blockDim.x is a
// multiple of 32, so every warp is full.
__device__ __forceinline__ float block_max(float m, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[32] = m;
  }
  __syncthreads();
  // the next row writes red[0..31] only after every thread has passed this
  // barrier, and red[32] only after its own first barrier: no third one needed
  return red[32];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
             long long R, long long d) {
  __shared__ float red[33];
  const long long nv = d / VEC;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const Vec<T, VEC>* xr = reinterpret_cast<const Vec<T, VEC>*>(x + row * d);
    Codes<VEC>* qr = reinterpret_cast<Codes<VEC>*>(q + row * d);

    float m = 0.f;  // |x| >= 0: the identity of the max
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      const Vec<T, VEC> a = xr[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = max_nan(m, fabsf(to_f(a.v[j])));
    }
    const float amax = block_max(m, red);
    const float scale = amax != amax ? amax : __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    if (threadIdx.x == 0) s[row] = scale;

#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      const Vec<T, VEC> a = xr[i];
      Codes<VEC> c;
#pragma unroll
      for (int j = 0; j < VEC; ++j) c.v[j] = code(to_f(a.v[j]), scale);
      qr[i] = c;
    }
  }
}

template <typename T, int VEC>
void launch(const void* x, void* q, void* s, long long R, long long d, int n_sm,
            cudaStream_t stream) {
  const long long nv = d / VEC;
  const int cap = R < 2LL * n_sm ? MAX_THREADS : 256;
  const long long want = ((nv + 31) / 32) * 32;
  const int threads = static_cast<int>(want < 32 ? 32 : (want > cap ? cap : want));
  const long long blocks = R < 0x7fffffffLL ? R : 0x7fffffffLL;
  quant_kernel<T, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), R, d);
}

}  // namespace

// x: (R, d) contiguous (bf16 != 0: bfloat16, else float32); q: (R, d) int8;
// s: (R,) float32; R >= 1, d >= 1.  Returns the CUDA error of the launch
// (0: launched).
extern "C" int quant_launch(const void* x, void* q, void* s, long long R, long long d,
                            int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, n_sm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), qa = reinterpret_cast<uintptr_t>(q);
  if (bf16) {
    if (xa % 16 == 0 && qa % 8 == 0 && d % 8 == 0)
      launch<__nv_bfloat16, 8>(x, q, s, R, d, n_sm, st);
    else
      launch<__nv_bfloat16, 1>(x, q, s, R, d, n_sm, st);
  } else {
    if (xa % 16 == 0 && qa % 4 == 0 && d % 4 == 0)
      launch<float, 4>(x, q, s, R, d, n_sm, st);
    else
      launch<float, 1>(x, q, s, R, d, n_sm, st);
  }
  return static_cast<int>(cudaGetLastError());
}
