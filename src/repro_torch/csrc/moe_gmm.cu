// Grouped (per-expert) matmul on the card, CUDA C++ for sm_90a with a plain C
// interface (bound with ctypes by repro_torch/kernels/moe_gmm/kernel.py).
//
// Replaces the Pallas TPU kernel grouped_matmul_fwd of
// repro/kernels/moe_gmm/kernel.py (:37, pallas_call at :54, _gmm_kernel):
// y[e] = x[e] @ w[e] for x (E, C, d), w (E, d, f), y (E, C, f), with a float32
// accumulator over d and one rounding to the type of x at the end.  x, w and
// y share one type, bfloat16 or float32; all three are contiguous.
//
// Two designs:
//
//   bfloat16: the tensor cores through warp-level mma.sync.m16n8k16 (bf16 in,
//   float32 accumulate), as csrc/flash_attention.cu's products.  A block owns
//   a BM x 128 output tile of one expert and loops over d in steps of 32:
//   the x tile (BM x 32) and the w tile (32 x 128) go into shared memory with
//   cp.async (16 bytes a copy, a 3-stage ring, so two tiles are in flight
//   while one is multiplied), and ldmatrix loads the mma fragments from
//   there (.trans for w, which is k-major as flash's V tile is).  Rows of x
//   past C are copied as zeros (cp.async with a source size of 0) and never
//   stored, so any C works; columns past f likewise, in steps of 8.
//
//   float32: the CUDA cores (no TF32: the reference's float32 tolerance is
//   3e-4).  A block owns a 64 x 64 output tile and loops over d in steps of
//   16 through shared memory; each thread accumulates a 4 x 4 sub-tile with
//   fmaf in ascending d.  Rows, columns and the tail of d are predicated.
//
// One order of summation per output element.  In both designs an element's
// sum over d runs in one fixed order that depends on d alone: ascending
// k-steps of 16 (one mma each, float32 accumulator) for bfloat16, ascending
// d for float32.  There is no split of d chosen by shape, and the tile
// height BM (128, 64 or 16 rows, picked from C so that a decode's few rows
// do not pay for 128) changes which rows share a block, never how a row is
// summed.  So a row of the output is bitwise the same whatever C is and
// wherever the row sits in its tile: the serving engine's batched decode
// (C = 8) and a request decoded alone (C = 6) compute the same rows.
//
// What bounds it.  At the MoE prefill shape (64 experts, 1984 rows, d 2048,
// f 1408, bf16) the work is 732 GFLOP on 1.25 GB: operations bound it (0.74
// ms at 989 TFLOP/s).  At a decode shape (C = 8) it reads every expert's
// weights (369 MB) for 3 GFLOP: bytes bound it (0.11 ms at 3.35 TB/s), and
// the small tile keeps the wasted mma work below the byte time.  Not yet:
// wgmma, TMA, a warp-specialised pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 8 warps
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // d per pipeline stage (two mma k-steps)
constexpr int STAGES = 3;
constexpr int LDA = BK + 8;   // padded row strides (bf16): 80 B and 272 B rows
constexpr int LDB = BN + 8;   //   keep every ldmatrix phase free of bank conflicts

template <int BM>
constexpr int smem_bytes() {
  return STAGES * (BM * LDA + BK * LDB) * (int)sizeof(bf16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // a source size of 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the four 8x8 b16 matrices whose rows lanes 0-7, 8-15, 16-23, 24-31 address
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a * b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (k-major fragment) and a 16x8 float32 C
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// BM rows per block; the 8 warps tile the BM x 128 output as WM x (8 / WM)
template <int BM, int WM>
__global__ void __launch_bounds__(THREADS)
gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
               int C, int d, int f) {
  constexpr int WN = 8 / WM;
  constexpr int TM = BM / WM, TN = BN / WN;  // one warp's output tile
  constexpr int MF = TM / 16, NF = TN / 8;   // its mma fragments
  static_assert(MF >= 1 && NF % 2 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BM][LDA]
  bf16* Bs = As + STAGES * BM * LDA;             // [STAGES][BK][LDB]

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const bf16* xe = x + (size_t)e * C * d;
  const bf16* we = w + (size_t)e * d * f;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + stage * BM * LDA;
    bf16* bs = Bs + stage * BK * LDB;
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = row0 + r < C;
      cp_async16(as + r * LDA + c, ok ? xe + (size_t)(row0 + r) * d + k0 + c : xe, ok);
    }
    for (int i = tid; i < BK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = col0 + c < f;
      cp_async16(bs + r * LDB + c, ok ? we + (size_t)(k0 + r) * f + col0 + c : we, ok);
    }
  };

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = d / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and stage kt-1 is free again
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_tile(nk % STAGES, nk);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * BM * LDA + (wm * TM) * LDA;
    const bf16* bs = Bs + (kt % STAGES) * BK * LDB + wn * TN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MF][4], b[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        ldmatrix_x4(a[i], as + (i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        const int mi = lane / 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (mi & 1) * 8 + lane % 8) * LDB + j * 8 + (mi >> 1) * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, tig = lane % 4;
  bf16* ye = y + (size_t)e * C * f;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    const int r = row0 + wm * TM + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int c = col0 + wn * TN + j * 8 + 2 * tig;
      if (c >= f) continue;
      if (r < C)
        *reinterpret_cast<uint32_t*>(ye + (size_t)r * f + c) = pack_bf16(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < C)
        *reinterpret_cast<uint32_t*>(ye + (size_t)(r + 8) * f + c) =
            pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FT = 64;  // output tile (rows and columns)
constexpr int FK = 16;  // d per step

__global__ void __launch_bounds__(THREADS)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
               int C, int d, int f) {
  __shared__ float As[FK][FT + 4];  // [k][row]
  __shared__ float Bs[FK][FT];      // [k][col]
  const int e = blockIdx.z;
  const int row0 = blockIdx.y * FT, col0 = blockIdx.x * FT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* xe = x + (size_t)e * C * d;
  const float* we = w + (size_t)e * d * f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += FK) {
#pragma unroll
    for (int q = 0; q < FT * FK / THREADS; ++q) {
      const int i = tid + q * THREADS;
      const int ar = i / FK, ak = i % FK;  // x: 16 consecutive d of one row
      const int bk = i / FT, bc = i % FT;  // w: 64 consecutive columns of one d
      As[ak][ar] = (row0 + ar < C && k0 + ak < d) ? xe[(size_t)(row0 + ar) * d + k0 + ak] : 0.f;
      Bs[bk][bc] = (k0 + bk < d && col0 + bc < f) ? we[(size_t)(k0 + bk) * f + col0 + bc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* ye = y + (size_t)e * C * f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < f) ye[(size_t)r * f + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <int BM, int WM>
int launch_mma(const void* x, const void* w, void* y, int E, int C, int d, int f,
               cudaStream_t st) {
  const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  gmm_mma_kernel<BM, WM><<<grid, THREADS, smem_bytes<BM>(), st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), C, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Lift the dynamic shared-memory limit of the bf16 kernels above 48 KB (56
// KB for the 128-row tile): once per device, before the first launch.
int moe_gmm_init() {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int errs[3] = {
      (int)cudaFuncSetAttribute(gmm_mma_kernel<128, 2>, a, smem_bytes<128>()),
      (int)cudaFuncSetAttribute(gmm_mma_kernel<64, 2>, a, smem_bytes<64>()),
      (int)cudaFuncSetAttribute(gmm_mma_kernel<16, 1>, a, smem_bytes<16>()),
  };
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

// x (E, C, d), w (E, d, f), y (E, C, f), contiguous, one type (bf16 != 0:
// bfloat16, with d % 32 == 0, f % 8 == 0 and 16-byte aligned bases; else
// float32, any sizes).  Returns the CUDA error of the launch (0: launched).
int moe_gmm_launch(const void* x, const void* w, void* y, int E, int C, int d, int f, int bf16_,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E == 0 || C == 0 || f == 0) return 0;
  if (bf16_) {
    if (d % BK || f % 8 || d == 0) return (int)cudaErrorInvalidValue;
    if (C <= 16) return launch_mma<16, 1>(x, w, y, E, C, d, f, st);
    if (C <= 64) return launch_mma<64, 2>(x, w, y, E, C, d, f, st);
    return launch_mma<128, 2>(x, w, y, E, C, d, f, st);
  }
  const dim3 grid((f + FT - 1) / FT, (C + FT - 1) / FT, E);
  gmm_f32_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w), static_cast<float*>(y),
                                           C, d, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
