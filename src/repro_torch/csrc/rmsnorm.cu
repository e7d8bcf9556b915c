// RMSNorm on the card, CUDA C++ for sm_90a with a plain C interface (bound
// with ctypes by repro_torch/kernels/rmsnorm/kernel.py).
//
// Replaces the Pallas TPU kernel rmsnorm_fwd of
// repro/kernels/rmsnorm/kernel.py (:24, pallas_call at :35, _rmsnorm_kernel):
// per row of x (R, d), y = x * rsqrt(mean(x^2) + eps) * scale, all in
// float32, y cast to the type of x.  x is bfloat16 or float32, scale float32.
//
// Rounding follows the reference: the sum of squares by fmaf in float32 (in
// another order than torch.mean: a lane's elements, the warp's xor tree,
// then the row's warps in order), ms = __fdiv_rn(sum, d), __fadd_rn with
// eps, the IEEE round-to-nearest reciprocal square root (__frsqrt_rn, not the
// approximate rsqrtf; no fast-math), then (x * r) * scale as two __fmul_rn
// and one rounding to the output type.
//
// What bounds it.  It reads each element once and writes it once and does
// about 4 operations per element: at the serving path's prefill shape
// (R = 8 * 2048 rows, d = 768 or 1536, bfloat16) that is 0.5 operations per
// byte, so HBM bytes bound it (50 MB at d = 768: 15 us at 3.35 TB/s).  In
// decode R = 8 and the launch and one round trip to memory are all of the
// cost.
//
// Design: one pass over device memory.  A row is held by `wpr` warps (1, 2,
// 4 or 8); each lane holds VPL 16-byte vectors of it in registers (8
// bfloat16 or 4 float32; VPL <= 16 a template argument, so every load is
// issued before any arithmetic), neighbouring lanes on neighbouring vectors,
// the ragged end masked.  The lanes' sums of squares meet by shuffles and,
// across the row's warps, through shared memory and a named barrier of the
// row's warps; then the lanes scale and write the vectors they hold.  A block
// holds `rows` rows side by side and walks the rows with a grid of at most
// four times the card's resident blocks, so each lane loads its columns of
// `scale`, in 16-byte vectors, once and keeps them in registers across its
// block's rows (where they take at most 64 registers; a lane holding 12 or
// 16 bf16 vectors reads them for each row, from cache, rather than spill),
// while the block scheduler still evens out the tail (on the
// card, one resident wave lost to F.rms_norm at float32 d 768, and an
// unbounded grid at bf16 d 2048).  The caller's plan (kernel.py
// norm_plan) picks wpr, rows and VPL from (R, d, dtype): one warp a row at
// large R (more when a lane would hold more than 4 vectors: past that the
// registers of `scale` cost occupancy), the most warps a row that keep every
// lane busy when R is small (decode: 8 rows occupy 8 SMs instead of two).  Where d is not a
// multiple of the vector width or a pointer is not 16-byte aligned, the same
// template runs with one element a "vector".  Rows wider than a block's
// registers (more than 8 * 32 * 16 vectors) go in passes: the sum over all
// passes, then each pass re-read and written (no shape of the repo's models
// needs a second pass).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;  // per block
constexpr int WAVES = 4;      // the grid: at most this many times the resident blocks

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

template <int VEC>
struct alignas(VEC >= 4 ? 16 : 4 * VEC) Scale {
  float v[VEC];
};

// the row's warps of this thread (id 1 + slot: barrier 0 is __syncthreads)
__device__ __forceinline__ void row_sync(int slot, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(threads) : "memory");
}

// Rows of x (R, d) by `wpr` warps each, `blockDim.x / (32 wpr)` rows a block
// walking the rows by gridDim.x blocks; `passes` = ceil(d / (32 wpr VPL VEC)).
template <typename T, int VEC, int VPL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ y,
               int R, int d, float eps, int wpr, int passes) {
  __shared__ float part[2][MAX_WARPS];  // the row's warp sums, by row parity
  const int lanes = 32 * wpr;
  const int slot = threadIdx.x / lanes, lt = threadIdx.x % lanes;
  const int rows = blockDim.x / lanes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int span = lanes * VPL * VEC;  // elements of one pass
  using V = Vec<T, VEC>;
  using SV = Scale<VEC>;
  // scale's columns of the first pass stay in registers across the rows
  // where they take at most 64 (bf16 at 12 or 16 vectors a lane would spill)
  constexpr bool HOLD = VPL * VEC <= 64;

  // this lane's columns of the first pass: vector v at element (v lanes + lt) VEC
  SV s[HOLD ? VPL : 1];
  if constexpr (HOLD) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int col = (v * lanes + lt) * VEC;
      if (col < d) s[v] = *reinterpret_cast<const SV*>(scale + col);
      else
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[v].v[j] = 0.f;
    }
  }

  int parity = 0;
  for (int row = blockIdx.x * rows + slot; row < R; row += gridDim.x * rows, parity ^= 1) {
    const T* xr = x + (size_t)row * d;
    T* yr = y + (size_t)row * d;
    V a[VPL];
    float ss = 0.f;
    for (int p = 0; p < passes; ++p) {  // one pass unless the row is wider than the block
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int col = p * span + (v * lanes + lt) * VEC;
        if (col < d) a[v] = *reinterpret_cast<const V*>(xr + col);
        else
#pragma unroll
          for (int j = 0; j < VEC; ++j) a[v].v[j] = from_f<T>(0.f);
      }
#pragma unroll
      for (int v = 0; v < VPL; ++v)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f(a[v].v[j]);
          ss = fmaf(f, f, ss);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (wpr > 1) {
      if (lane == 0) part[parity][warp] = ss;
      row_sync(slot, lanes);
      ss = 0.f;
      for (int w = 0; w < wpr; ++w) ss += part[parity][slot * wpr + w];
    }
    const float r = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)d), eps));

    for (int p = passes - 1; p >= 0; --p) {  // the last pass is in registers
      if (p < passes - 1) {
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int col = p * span + (v * lanes + lt) * VEC;
          if (col < d) a[v] = *reinterpret_cast<const V*>(xr + col);
        }
      }
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int col = p * span + (v * lanes + lt) * VEC;
        if (col >= d) continue;
        SV sv;
        if constexpr (HOLD) {
          sv = s[v];
          if (p > 0) sv = *reinterpret_cast<const SV*>(scale + col);
        } else {
          sv = *reinterpret_cast<const SV*>(scale + col);
        }
        V o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = from_f<T>(__fmul_rn(__fmul_rn(to_f(a[v].v[j]), r), sv.v[j]));
        *reinterpret_cast<V*>(yr + col) = o;
      }
    }
  }
}

template <typename T, int VEC, int VPL>
int launch(const void* x, const void* scale, void* y, int R, int d, float eps, int wpr,
           int rows, int passes, cudaStream_t st) {
  const auto kernel = rmsnorm_kernel<T, VEC, VPL>;
  const int threads = 32 * wpr * rows;
  // at most WAVES times the blocks the card holds at once (looked up once per
  // instantiation and block size)
  static int resident[MAX_WARPS + 1] = {};
  const int w = wpr * rows;
  if (resident[w] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != 0) return err;
    resident[w] = sms * per_sm;
  }
  const int need = (R + rows - 1) / rows;
  const int cap = WAVES * resident[w];
  const int grid = need < cap ? need : cap;
  kernel<<<grid, threads, 0, st>>>(static_cast<const T*>(x), static_cast<const float*>(scale),
                                   static_cast<T*>(y), R, d, eps, wpr, passes);
  return (int)cudaGetLastError();
}

// the instantiation holding vpl vectors a lane (1, 2, 3, 4, 6, 8, 12 or 16)
template <typename T, int VEC>
int dispatch(int vpl, const void* x, const void* scale, void* y, int R, int d, float eps,
             int wpr, int rows, int passes, cudaStream_t st) {
  switch (vpl) {
    case 1: return launch<T, VEC, 1>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    case 2: return launch<T, VEC, 2>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    case 3: return launch<T, VEC, 3>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    case 4: return launch<T, VEC, 4>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    case 6: return launch<T, VEC, 6>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    case 8: return launch<T, VEC, 8>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    case 12: return launch<T, VEC, 12>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    case 16: return launch<T, VEC, 16>(x, scale, y, R, d, eps, wpr, rows, passes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (R, d) of one type (bf16 != 0: bfloat16, else float32), contiguous;
// scale: (d,) float32.  The plan: wpr warps a row, rows a block, vpl vectors
// a lane, vec != 0 for 16-byte vectors (d a multiple of the width and every
// pointer 16-byte aligned), passes over a row.  Returns the CUDA error of the
// launch (0: launched).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y, int R, int d,
                              int bf16, float eps, int wpr, int rows, int vpl, int vec,
                              int passes, void* stream) {
  if (wpr < 1 || rows < 1 || wpr * rows > MAX_WARPS || (wpr & (wpr - 1)) || passes < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return vec ? dispatch<T, 8>(vpl, x, scale, y, R, d, eps, wpr, rows, passes, s)
               : dispatch<T, 1>(vpl, x, scale, y, R, d, eps, wpr, rows, passes, s);
  }
  return vec ? dispatch<float, 4>(vpl, x, scale, y, R, d, eps, wpr, rows, passes, s)
             : dispatch<float, 1>(vpl, x, scale, y, R, d, eps, wpr, rows, passes, s);
}
