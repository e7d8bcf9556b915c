// Mamba-2 SSD chunked scan on the card, CUDA C++ for sm_90a with a plain C
// interface (bound with ctypes by repro_torch/kernels/ssd_scan/kernel.py).
//
// Replaces the Pallas TPU kernel ssd_scan_fwd of
// repro/kernels/ssd_scan/kernel.py (:72, pallas_call at :90, _ssd_kernel).
// Per row bh = b * nheads + h and chunk of Q tokens, with a_cs the inclusive
// cumsum of da = dt * A over the chunk:
//   y      = y_diag + y_inter
//   y_diag = (C B^T  *  L  *  dt[k]) x,   L[q, k] = exp(a_cs[q] - a_cs[k]) for
//            q >= k and 0 above the diagonal
//   y_inter = (C state^T) * exp(a_cs[q])
//   state  = state * exp(a_cs[Q-1]) + x^T (B * exp(a_cs[Q-1] - a_cs[k]) * dt[k])
// and the state after the last chunk is the second output.  Layout: x, y
// (BH, S, P) in bfloat16 or float32; dt, da (BH, S) float32; B, C (Bb, S, N)
// of x's type, shared by the nheads heads of a batch row (row bh reads
// bh / nheads, as the Pallas index map b // nheads); state (BH, P, N) float32.
// P <= 64, N <= 128, Q <= 256 and Q divides S.  All arithmetic is float32, as
// in the Pallas kernel (kernel.py:33-37); the products are plain float32
// sums in another order than the reference's dots.
//
// The TPU kernel runs the chunk axis as a sequential grid dimension and keeps
// the (P, N) state in VMEM scratch between grid steps.  Here blocks run in no
// order, so ONE block per (b, h) loops over the chunks itself and keeps the
// 64 x 128 float32 state (32 KB) in shared memory for the whole sequence.
//
// Above the diagonal a_cs[q] - a_cs[k] is positive and exp overflows: L is a
// select (q >= k ? exp(...) : 0), never a multiply by a 0/1 mask, which would
// give inf * 0 = NaN; key tiles wholly above the diagonal are skipped, which
// is exact (their weights are all 0).
//
// What bounds it.  At the serving path's prefill shape (B = 8, S = 2048,
// nh = 24, P = 64, N = 128, Q = 256) one launch does, per (bh, chunk), the
// causal half of the two Q x Q products (2 * Q(Q+1)/2 * (N + P) FLOP) plus
// 4 * Q * P * N for y_inter and the state: 21.0 MFLOP, 32.3 GFLOP in all,
// against 118 MB of traffic (x and y in bf16, dt, da, B, C, the state): about
// 270 FLOP per byte, so float32 operations bound it (0.48 ms at the card's
// 67 TFLOP/s outside the tensor cores, 35 us for the bytes).
//
// Design.  256 threads per block, as a 16 x 16 grid; every product is cut
// into 64 x 64 output tiles of which each thread owns 4 x 4 (the state
// update: 4 x 8), accumulated in registers from operands staged in shared
// memory as float32 (bfloat16 inputs are widened once on load).  The Q x Q
// weight block of a 256-token chunk would be 256 KB of float32, more than a
// block's 227 KB of shared memory, so query rows go in tiles of 64: per query
// tile, the C tile (64 x 128) stays staged while the key tiles at or below
// the diagonal stream through (B tile 64 x 128, x tile 64 x 64); their 64 x 64
// weight tile goes through shared memory into the W x product.  Rows of
// the staged tiles are padded to 129 (65) floats so that the column walks of
// the products hit 16 distinct banks.  About 134 KB of shared memory: one
// block per SM, 192 blocks at the path's shape.
//
// Not yet: the C B^T score tiles are the same for the 24 heads of a batch row
// and are recomputed per head here, as the TPU kernel does; the products run
// on the CUDA cores in float32 (no tensor cores, which would give TF32); the
// tile loads are not pipelined.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PT = 64;      // max head dim P
constexpr int NT = 128;     // max state dim N
constexpr int QMAX = 256;   // max chunk
constexpr int TQ = 64;      // query rows per tile
constexpr int TK = 64;      // key rows per tile
constexpr int NS = NT + 1;  // padded row strides (floats)
constexpr int WS = TK + 1;

constexpr int SMEM_FLOATS = TQ * NS      // sC
                          + TK * NS      // sB
                          + TK * PT      // sX
                          + TQ * WS      // sW
                          + PT * NS      // sState
                          + 2 * QMAX     // sAcs, sDt
                          + THREADS / 32;  // warp sums
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// rows [k0, k0 + nk) of a (*, ld) matrix into a (rows, stride) float tile,
// columns < ncols; the rest of the tile is zero.  `scale`, when given, is a
// per-row factor (indexed by the tile row) applied after widening.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst, int rows, int cols, int stride,
                                      const T* __restrict__ src, int nk, int ncols, int ld,
                                      const float* __restrict__ scale) {
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int r = i / cols, c = i % cols;
    float v = 0.f;
    if (r < nk && c < ncols) {
      v = to_f(src[(size_t)r * ld + c]);
      if (scale) v = __fmul_rn(v, scale[r]);
    }
    dst[r * stride + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ da, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ st,
                int S, int P, int N, int nheads, int Q) {
  extern __shared__ float smem[];
  float* sC = smem;
  float* sB = sC + TQ * NS;
  float* sX = sB + TK * NS;
  float* sW = sX + TK * PT;
  float* sState = sW + TQ * WS;
  float* sAcs = sState + PT * NS;
  float* sDt = sAcs + QMAX;
  float* sWarp = sDt + QMAX;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / nheads;
  const T* xb = x + (size_t)bh * S * P;
  const float* dtb = dt + (size_t)bh * S;
  const float* dab = da + (size_t)bh * S;
  const T* Bb = Bm + (size_t)b * S * N;
  const T* Cb = Cm + (size_t)b * S * N;
  T* yb = y + (size_t)bh * S * P;

  for (int i = tid; i < PT * NS; i += THREADS) sState[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- dt and the inclusive cumsum of da over the chunk (block scan)
    float v = 0.f;
    if (tid < Q) {
      v = dab[c0 + tid];
      sDt[tid] = dtb[c0 + tid];
    } else {
      sDt[tid] = 0.f;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) sWarp[warp] = v;
    __syncthreads();  // also: every thread's sState zeroing / update is done
    for (int w = 0; w < warp; ++w) v += sWarp[w];
    sAcs[tid] = v;
    __syncthreads();
    const float a_last = sAcs[Q - 1];

    // ---- y = y_inter + y_diag, one tile of 64 query rows at a time
    for (int q0 = 0; q0 < Q; q0 += TQ) {
      const int nq = min(TQ, Q - q0);
      stage(sC, TQ, NT, NS, Cb + (size_t)(c0 + q0) * N, nq, N, N, (const float*)nullptr);
      __syncthreads();

      float acc[4][4];
      // y_inter: (C state^T) * exp(a_cs[q])
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[4], s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sC[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = sState[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], s[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(sAcs[q0 + ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmul_rn(acc[i][j], e);
      }

      // y_diag over the key tiles at or below the diagonal
      for (int k0 = 0; k0 <= q0; k0 += TK) {
        const int nk = min(TK, Q - k0);
        __syncthreads();  // the previous tile's sB / sX / sW readers are done
        stage(sB, TK, NT, NS, Bb + (size_t)(c0 + k0) * N, nk, N, N, (const float*)nullptr);
        stage(sX, TK, PT, PT, xb + (size_t)(c0 + k0) * P, nk, P, P, (const float*)nullptr);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float a[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sC[(ty + 16 * i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = sB[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty + 16 * i;
          const float aq = sAcs[q];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            // a select, never a multiply by a mask: exp overflows for q < k
            const float w = (q >= k && k < Q)
                ? __fmul_rn(__fmul_rn(s[i][j], expf(aq - sAcs[k])), sDt[k])
                : 0.f;
            sW[(ty + 16 * i) * WS + tx + 16 * j] = w;
          }
        }
        __syncthreads();
        for (int k = 0; k < nk; ++k) {
          float a[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sW[(ty + 16 * i) * WS + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = sX[k * PT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < nq) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            if (p < P) yb[(size_t)(c0 + q0 + r) * P + p] = from_f<T>(acc[i][j]);
          }
        }
      }
      __syncthreads();  // sC and sW readers are done before the next tile
    }

    // ---- state = state * exp(a_last) + x^T (B * exp(a_last - a_cs) * dt)
    float up[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) up[i][j] = 0.f;
    for (int k0 = 0; k0 < Q; k0 += TK) {
      const int nk = min(TK, Q - k0);
      // per-row decay of this key tile, staged in sW's first row
      if (tid < TK) {
        const int k = k0 + tid;
        sW[tid] = k < Q ? __fmul_rn(expf(a_last - sAcs[k]), sDt[k]) : 0.f;
      }
      __syncthreads();
      stage(sB, TK, NT, NS, Bb + (size_t)(c0 + k0) * N, nk, N, N, (const float*)sW);
      stage(sX, TK, PT, PT, xb + (size_t)(c0 + k0) * P, nk, P, P, (const float*)nullptr);
      __syncthreads();
      for (int k = 0; k < nk; ++k) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[k * PT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sB[k * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) up[i][j] = fmaf(xv[i], bv[j], up[i][j]);
      }
      __syncthreads();  // sB / sX / sW readers are done before the next tile
    }
    const float e_last = expf(a_last);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* s = &sState[(ty + 16 * i) * NS + tx + 16 * j];
        *s = __fadd_rn(__fmul_rn(*s, e_last), up[i][j]);
      }
    // the next chunk's first barrier orders these writes before their reads
  }
  __syncthreads();
  float* stb = st + (size_t)bh * P * N;
  for (int i = tid; i < P * N; i += THREADS) stb[i] = sState[(i / N) * NS + i % N];
}

template <typename T>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

}  // namespace

// Lift the dynamic shared-memory limit of both instantiations on the current
// device.  Returns the CUDA error (0: done).
extern "C" int ssd_init() {
  int err = set_smem<float>();
  if (err == 0) err = set_smem<__nv_bfloat16>();
  return err;
}

// One block per (b, h).  Returns the CUDA error of the launch (0: launched).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* da, const void* B,
                               const void* C, void* y, void* state, int BH, int S, int P,
                               int N, int nheads, int Q, int bf16, void* stream) {
  if (P > PT || N > NT || Q > QMAX || Q <= 0 || S % Q) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(BH), block(THREADS);
  const float* dtf = static_cast<const float*>(dt);
  const float* daf = static_cast<const float*>(da);
  float* stf = static_cast<float*>(state);
  if (bf16) {
    using T = __nv_bfloat16;
    ssd_scan_kernel<T><<<grid, block, SMEM_BYTES, s>>>(
        static_cast<const T*>(x), dtf, daf, static_cast<const T*>(B), static_cast<const T*>(C),
        static_cast<T*>(y), stf, S, P, N, nheads, Q);
  } else {
    ssd_scan_kernel<float><<<grid, block, SMEM_BYTES, s>>>(
        static_cast<const float*>(x), dtf, daf, static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<float*>(y), stf, S, P, N, nheads, Q);
  }
  return static_cast<int>(cudaGetLastError());
}
