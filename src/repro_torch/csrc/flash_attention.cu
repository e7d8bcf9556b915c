// Flash attention on the card: the forward pass and the two backward passes,
// CUDA C++ for sm_90a with a plain C interface (bound with ctypes by
// repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention/kernel.py
// (each in two designs, below: *_mma_kernel for bfloat16, *_kernel for
// float32):
//   flash_fwd        <- flash_attention_fwd (:79; _fwd_kernel :31)
//   flash_bwd_dq     <- flash_attention_bwd's first pallas_call (:235;
//                       _bwd_dq_kernel :137)
//   flash_bwd_dkv    <- flash_attention_bwd's second pallas_call (:255;
//                       _bwd_dkv_kernel :176)
//
// Layout, as the reference's kernels take it: q, o, dO (B*H, Sq, hd); k, v
// (B*KV, Sk, hd); lse, delta (B*H, Sq) float32; query head bh reads kv head
// bh / group.  Inputs are bfloat16 or float32, all of one type; o, dq, dk, dv
// come out in that type.  hd is 16, 32, 64 or 128; Sq and Sk are multiples
// of 64.
//
// Arithmetic follows the reference's rounding points: scores in float32 and
// scaled after the product, masked to -1e30 (causal: key col > query row,
// top-left aligned as the Pallas kernel), an online softmax with its running
// max, sum and accumulator in float32, p rounded to the input type before
// P.V (p.astype(v.dtype)), o = acc / max(l, 1e-30) and lse = m + log(max(l,
// 1e-30)).  The backward recomputes p = exp(s - lse) and uses
// ds = p * (dO.V^T - delta) * scale, in float32 (bf16: p and ds are rounded
// to bf16 as operands of the second products, see below).  Key tiles that lie
// wholly above the causal diagonal are skipped: there p = 0 and the running
// max is unchanged, so the skip is exact.
//
// What bounds them.  At the training path's shape (B*H = 72, S = 2048,
// hd = 64, bf16, causal) the forward does 4*S*(S+1)/2*hd = 0.54 GFLOP per head
// against 1.4 MB of traffic per head: about 750 FLOP per byte, far above the
// H100's 295 FLOP/byte ridge, so the bound is operations (989 TFLOP/s of
// bf16 tensor-core work); the backward passes likewise.  Two designs:
//
// * bfloat16 (the training path): the products run on the tensor cores as
//   warp-level mma.sync.m16n8k16 (bf16 in, float32 accumulate), FlashAttention-2
//   style.  A block of 4 warps owns 64 query rows (dkv: 64 key rows), 16 per
//   warp; the streamed K/V (dkv: Q/dO) tile of 64 rows is staged in shared
//   memory once per block, row-major and, where a product needs it as the
//   k-major operand, transposed, both with rows padded by 8 elements so the
//   fragment loads are conflict-free.  The score tile stays in registers; its
//   float32 accumulator layout is re-packed as bf16 A fragments for P.V (and
//   dS.K, P^T.dO, dS^T.Q), so no score ever reaches shared or device memory.
//   p and ds are rounded to bf16 as operands of those second products (the
//   reference's p.astype(v.dtype) in the forward; a bf16 rounding the
//   reference's float32 backward does not have).  Not yet: wgmma, TMA, a
//   pipelined ring of tiles — the tile loads stall the warps.
// * float32: the products run on the CUDA cores in float32 (67 TFLOP/s
//   peak), to keep float32 accuracy (the tensor cores' TF32 would not).  K/V
//   (or Q/dO) tiles are staged in shared memory as float32 and reused by 32
//   query (or key) rows; each row is split over 8 lanes that hold hd/8
//   interleaved dims in registers, so shared-memory reads are conflict-free
//   and a dot product is 3 warp shuffles; the score row of a 64-key tile lives
//   in registers.
//
// Both dkv passes loop over the query heads of their kv head inside the
// block, so dk/dv are summed over the GQA group in float32 and written once
// per kv head, with no atomics (deterministic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int TPR = 8;              // lanes per row
constexpr int ROWS = 32;            // rows (query or key) per block
constexpr int THREADS = ROWS * TPR; // 256
constexpr int TILE = 64;            // rows of the streamed operand per tile
constexpr float NEG_INF = -1e30f;

// sum over the TPR lanes that share a row (consecutive lanes of one warp)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// n consecutive floats of src -> shared memory, by the whole block
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int group,
    float scale, int causal) {
  constexpr int D = HD / TPR;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = smem + TILE * HD;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int lane = threadIdx.x % TPR;
  const int row = qt * ROWS + threadIdx.x / TPR;
  const size_t kv0 = (size_t)(bh / group) * Sk * HD;
  const float* qrow = q + ((size_t)bh * Sq + row) * HD;

  float qr[D], acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = qrow[lane + TPR * i];
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  int n_tiles = Sk / TILE;
  if (causal) n_tiles = min(n_tiles, (qt * ROWS + ROWS - 1) / TILE + 1);

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    stage(Ks, k + kv0 + (size_t)t * TILE * HD, TILE * HD);
    stage(Vs, v + kv0 + (size_t)t * TILE * HD, TILE * HD);
    __syncthreads();
    float s[TILE];
    float mx = m;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float* kr = Ks + j * HD + lane;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) part += qr[i] * kr[TPR * i];
      float sj = row_sum(part) * scale;
      if (causal && t * TILE + j > row) sj = NEG_INF;
      s[j] = sj;
      mx = fmaxf(mx, sj);
    }
    const float alpha = expf(m - mx);
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - mx);
      psum += p;  // p.astype(v.dtype) is exact in float32
      const float* vr = Vs + j * HD + lane;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] += p * vr[TPR * i];
    }
    l = alpha * l + psum;
    m = mx;
  }
  const float lc = fmaxf(l, 1e-30f);
  float* orow = o + ((size_t)bh * Sq + row) * HD;
#pragma unroll
  for (int i = 0; i < D; ++i) orow[lane + TPR * i] = acc[i] / lc;
  if (lane == 0) lse[(size_t)bh * Sq + row] = m + logf(lc);
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk,
    int group, float scale, int causal) {
  constexpr int D = HD / TPR;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = smem + TILE * HD;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int lane = threadIdx.x % TPR;
  const int row = qt * ROWS + threadIdx.x / TPR;
  const size_t kv0 = (size_t)(bh / group) * Sk * HD;
  const size_t r0 = ((size_t)bh * Sq + row) * HD;

  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = q[r0 + lane + TPR * i];
    dor[i] = dout[r0 + lane + TPR * i];
    acc[i] = 0.f;
  }
  const float lse_r = lse[(size_t)bh * Sq + row];
  const float delta_r = delta[(size_t)bh * Sq + row];
  int n_tiles = Sk / TILE;
  if (causal) n_tiles = min(n_tiles, (qt * ROWS + ROWS - 1) / TILE + 1);

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    stage(Ks, k + kv0 + (size_t)t * TILE * HD, TILE * HD);
    stage(Vs, v + kv0 + (size_t)t * TILE * HD, TILE * HD);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      const float* kr = Ks + j * HD + lane;
      const float* vr = Vs + j * HD + lane;
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        sp += qr[i] * kr[TPR * i];
        dpp += dor[i] * vr[TPR * i];
      }
      const float s = row_sum(sp) * scale;
      const float dp = row_sum(dpp);
      const float p = (causal && t * TILE + j > row) ? 0.f : expf(s - lse_r);
      const float ds = p * (dp - delta_r) * scale;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] += ds * kr[TPR * i];
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) dq[r0 + lane + TPR * i] = acc[i];
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    int Sq, int Sk, int group, float scale, int causal) {
  constexpr int D = HD / TPR;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ds = Qs + TILE * HD;
  float* Ls = Ds + TILE * HD;
  float* Es = Ls + TILE;
  const int bkv = blockIdx.x;
  const int kt = blockIdx.y;  // key tile 0 has the most causal rows: first
  const int lane = threadIdx.x % TPR;
  const int col = kt * ROWS + threadIdx.x / TPR;
  const size_t c0 = ((size_t)bkv * Sk + col) * HD;

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    kr[i] = k[c0 + lane + TPR * i];
    vr[i] = v[c0 + lane + TPR * i];
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  // query tiles before the first one holding a row >= this block's first key
  // see only masked scores under the causal mask
  const int t0 = causal ? (kt * ROWS) / TILE : 0;
  const int n_tiles = Sq / TILE;

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)bkv * group + g;
    for (int t = t0; t < n_tiles; ++t) {
      __syncthreads();
      stage(Qs, q + (bh * Sq + (size_t)t * TILE) * HD, TILE * HD);
      stage(Ds, dout + (bh * Sq + (size_t)t * TILE) * HD, TILE * HD);
      if (threadIdx.x < TILE) {
        Ls[threadIdx.x] = lse[bh * Sq + t * TILE + threadIdx.x];
        Es[threadIdx.x] = delta[bh * Sq + t * TILE + threadIdx.x];
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < TILE; ++r) {
        const float* qv = Qs + r * HD + lane;
        const float* dov = Ds + r * HD + lane;
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          sp += qv[TPR * i] * kr[i];
          dpp += dov[TPR * i] * vr[i];
        }
        const float s = row_sum(sp) * scale;
        const float dp = row_sum(dpp);
        const float p = (causal && col > t * TILE + r) ? 0.f : expf(s - Ls[r]);
        const float ds = p * (dp - Es[r]) * scale;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          dv_acc[i] += p * dov[TPR * i];
          dk_acc[i] += ds * qv[TPR * i];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    dk[c0 + lane + TPR * i] = dk_acc[i];
    dv[c0 + lane + TPR * i] = dv_acc[i];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync.m16n8k16
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MMA_THREADS = 128;  // 4 warps, 16 rows each
constexpr int MT = 64;            // rows per block, and rows per streamed tile
constexpr int TS = MT + 8;        // row stride of a transposed (k-major) tile

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// A fragment of rows [r, r+16) x cols [c, c+16) of a row-major matrix with
// row stride ld (global or shared memory)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m, int ld, int g, int tig) {
  const bf16* p0 = m + (size_t)g * ld + 2 * tig;
  const bf16* p1 = p0 + (size_t)8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// A fragment from a 16x16 tile held as two 16x8 float32 accumulators
// (columns [0, 8) in c0, [8, 16) in c1), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// c += A * B where B's column n (8 of them) is row n of a row-major matrix
// m (stride ld) over k = [k0, k0+16): the K^T / V^T / Q^T / dO^T operand
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t (&a)[4], const bf16* m,
                                         int ld, int g, int tig) {
  const bf16* p = m + g * ld + 2 * tig;
  mma16816(c, a, ld32(p), ld32(p + 8));
}

// MT rows of HD bf16 from device memory into shared memory, row-major with
// row stride HD + 8 ...
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < MT * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH;
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c * 8);
  }
}

// ... or transposed: dst[d * TS + r] = src[r][d]
template <int HD>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* __restrict__ src) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < MT * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH;
    const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)r * HD + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * TS + r] = e[j];
  }
}

constexpr int rows_bytes(int hd) { return MT * (hd + 8) * 2; }
constexpr int cols_bytes(int hd) { return hd * TS * 2; }
constexpr int smem_fwd_mma(int hd) { return rows_bytes(hd) + cols_bytes(hd); }
constexpr int smem_dq_mma(int hd) { return 2 * rows_bytes(hd) + cols_bytes(hd); }
constexpr int smem_dkv_mma(int hd) { return 4 * rows_bytes(hd) + 2 * cols_bytes(hd) + 2 * MT * 4; }

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int group, float scale,
    int causal) {
  constexpr int KD = HD / 16, ND = HD / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [key][dim]
  bf16* Vt = Ks + MT * LD;                       // [dim][key]
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int w0 = qt * MT + warp * 16;  // this warp's first row
  const int r0 = w0 + g;               // this thread's rows: r0, r0 + 8
  const size_t kv0 = (size_t)(bh / group) * Sk * HD;

  uint32_t qa[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) load_a(qa[d], q + ((size_t)bh * Sq + w0) * HD + 16 * d, HD, g, tig);
  float acc[ND][4];
#pragma unroll
  for (int e = 0; e < ND; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  int n_tiles = Sk / MT;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    stage_rows<HD>(Ks, k + kv0 + (size_t)t * MT * HD);
    stage_cols<HD>(Vt, v + kv0 + (size_t)t * MT * HD);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int d = 0; d < KD; ++d) mma_rows(s[j], qa[d], Ks + 8 * j * LD + 16 * d, LD, g, tig);
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t * MT + 8 * j + 2 * tig + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        float x = s[j][e] * scale;
        if (causal && col > row) x = NEG_INF;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the 4 lanes of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = a0 * l0 + ps0;  // this lane's part of the row sum
    l1 = a1 * l1 + ps1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      acc[e][0] *= a0;
      acc[e][1] *= a0;
      acc[e][2] *= a1;
      acc[e][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);  // p rounded to bf16
#pragma unroll
      for (int e = 0; e < ND; ++e) mma_rows(acc[e], pa, Vt + 8 * e * TS + 16 * kk, TS, g, tig);
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  bf16* o0 = o + ((size_t)bh * Sq + r0) * HD + 2 * tig;
  bf16* o1 = o0 + (size_t)8 * HD;
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    *reinterpret_cast<uint32_t*>(o0 + 8 * e) = pack_bf16(acc[e][0] / lc0, acc[e][1] / lc0);
    *reinterpret_cast<uint32_t*>(o1 + 8 * e) = pack_bf16(acc[e][2] / lc1, acc[e][3] / lc1);
  }
  if (tig == 0) {
    lse[(size_t)bh * Sq + r0] = m0 + logf(lc0);
    lse[(size_t)bh * Sq + r0 + 8] = m1 + logf(lc1);
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int group,
    float scale, int causal) {
  constexpr int KD = HD / 16, ND = HD / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [key][dim]
  bf16* Vs = Ks + MT * LD;                       // [key][dim]
  bf16* Kt = Vs + MT * LD;                       // [dim][key]
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int w0 = qt * MT + warp * 16;
  const int r0 = w0 + g;
  const size_t kv0 = (size_t)(bh / group) * Sk * HD;

  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d) {
    load_a(qa[d], q + ((size_t)bh * Sq + w0) * HD + 16 * d, HD, g, tig);
    load_a(da[d], dout + ((size_t)bh * Sq + w0) * HD + 16 * d, HD, g, tig);
  }
  float acc[ND][4];
#pragma unroll
  for (int e = 0; e < ND; ++e) acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
  const float lse0 = lse[(size_t)bh * Sq + r0], lse1 = lse[(size_t)bh * Sq + r0 + 8];
  const float dl0 = delta[(size_t)bh * Sq + r0], dl1 = delta[(size_t)bh * Sq + r0 + 8];
  int n_tiles = Sk / MT;
  if (causal) n_tiles = min(n_tiles, qt + 1);

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    stage_rows<HD>(Ks, k + kv0 + (size_t)t * MT * HD);
    stage_rows<HD>(Vs, v + kv0 + (size_t)t * MT * HD);
    stage_cols<HD>(Kt, k + kv0 + (size_t)t * MT * HD);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys at a time
      float ds[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          mma_rows(s, qa[d], Ks + 8 * j * LD + 16 * d, LD, g, tig);
          mma_rows(dp, da[d], Vs + 8 * j * LD + 16 * d, LD, g, tig);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t * MT + 8 * j + 2 * tig + (e & 1);
          const int row = r0 + 8 * (e >> 1);
          const float l_ = e < 2 ? lse0 : lse1, dl = e < 2 ? dl0 : dl1;
          const float p = (causal && col > row) ? 0.f : expf(s[e] * scale - l_);
          ds[jj][e] = p * (dp[e] - dl) * scale;
        }
      }
      uint32_t dsa[4];
      acc_to_a(dsa, ds[0], ds[1]);
#pragma unroll
      for (int e = 0; e < ND; ++e) mma_rows(acc[e], dsa, Kt + 8 * e * TS + 16 * kk, TS, g, tig);
    }
  }
  bf16* d0 = dq + ((size_t)bh * Sq + r0) * HD + 2 * tig;
  bf16* d1 = d0 + (size_t)8 * HD;
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    *reinterpret_cast<uint32_t*>(d0 + 8 * e) = pack_bf16(acc[e][0], acc[e][1]);
    *reinterpret_cast<uint32_t*>(d1 + 8 * e) = pack_bf16(acc[e][2], acc[e][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
    int Sk, int group, float scale, int causal) {
  constexpr int KD = HD / 16, ND = HD / 8, LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // this block's keys [key][dim]
  bf16* Vs = Ks + MT * LD;                       // [key][dim]
  bf16* Qs = Vs + MT * LD;                       // streamed queries [query][dim]
  bf16* Ds = Qs + MT * LD;                       // dO [query][dim]
  bf16* Qt = Ds + MT * LD;                       // [dim][query]
  bf16* Dt = Qt + HD * TS;                       // [dim][query]
  float* Ls = reinterpret_cast<float*>(Dt + HD * TS);
  float* Es = Ls + MT;
  const int bkv = blockIdx.x;
  const int kt = blockIdx.y;  // key tile 0 has the most causal rows: first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int c0 = kt * MT + warp * 16 + g;  // this thread's keys: c0, c0 + 8
  const size_t kv0 = ((size_t)bkv * Sk + kt * MT) * HD;

  stage_rows<HD>(Ks, k + kv0);
  stage_rows<HD>(Vs, v + kv0);
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    dk_acc[e][0] = dk_acc[e][1] = dk_acc[e][2] = dk_acc[e][3] = 0.f;
    dv_acc[e][0] = dv_acc[e][1] = dv_acc[e][2] = dv_acc[e][3] = 0.f;
  }
  // query tiles before the one holding query kt*MT see only masked scores
  const int t0 = causal ? kt : 0;
  const int n_tiles = Sq / MT;

  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = (size_t)bkv * group + gi;
    for (int t = t0; t < n_tiles; ++t) {
      const size_t q0 = (bh * Sq + (size_t)t * MT) * HD;
      __syncthreads();
      stage_rows<HD>(Qs, q + q0);
      stage_rows<HD>(Ds, dout + q0);
      stage_cols<HD>(Qt, q + q0);
      stage_cols<HD>(Dt, dout + q0);
      if (threadIdx.x < MT) {
        Ls[threadIdx.x] = lse[bh * Sq + t * MT + threadIdx.x];
        Es[threadIdx.x] = delta[bh * Sq + t * MT + threadIdx.x];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 queries at a time
        float p[2][4], ds[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 0; d < KD; ++d) {
            uint32_t ka[4], va[4];
            load_a(ka, Ks + warp * 16 * LD + 16 * d, LD, g, tig);
            load_a(va, Vs + warp * 16 * LD + 16 * d, LD, g, tig);
            mma_rows(st, ka, Qs + 8 * j * LD + 16 * d, LD, g, tig);   // S^T = K Q^T
            mma_rows(dpt, va, Ds + 8 * j * LD + 16 * d, LD, g, tig);  // dP^T = V dO^T
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + 2 * tig + (e & 1);  // query within the tile
            const int key = c0 + 8 * (e >> 1);
            const float pe =
                (causal && key > t * MT + qi) ? 0.f : expf(st[e] * scale - Ls[qi]);
            p[jj][e] = pe;
            ds[jj][e] = pe * (dpt[e] - Es[qi]) * scale;
          }
        }
        uint32_t pa[4], dsa[4];
        acc_to_a(pa, p[0], p[1]);
        acc_to_a(dsa, ds[0], ds[1]);
#pragma unroll
        for (int e = 0; e < ND; ++e) {
          mma_rows(dv_acc[e], pa, Dt + 8 * e * TS + 16 * kk, TS, g, tig);   // dV += P^T dO
          mma_rows(dk_acc[e], dsa, Qt + 8 * e * TS + 16 * kk, TS, g, tig);  // dK += dS^T Q
        }
      }
    }
  }
  bf16* k0p = dk + ((size_t)bkv * Sk + c0) * HD + 2 * tig;
  bf16* v0p = dv + ((size_t)bkv * Sk + c0) * HD + 2 * tig;
#pragma unroll
  for (int e = 0; e < ND; ++e) {
    *reinterpret_cast<uint32_t*>(k0p + 8 * e) = pack_bf16(dk_acc[e][0], dk_acc[e][1]);
    *reinterpret_cast<uint32_t*>(k0p + 8 * HD + 8 * e) = pack_bf16(dk_acc[e][2], dk_acc[e][3]);
    *reinterpret_cast<uint32_t*>(v0p + 8 * e) = pack_bf16(dv_acc[e][0], dv_acc[e][1]);
    *reinterpret_cast<uint32_t*>(v0p + 8 * HD + 8 * e) = pack_bf16(dv_acc[e][2], dv_acc[e][3]);
  }
}

// ---------------------------------------------------------------------------
// dispatch and the C interface
// ---------------------------------------------------------------------------

constexpr int smem_two_tiles(int hd) { return 2 * TILE * hd * (int)sizeof(float); }
constexpr int smem_dkv(int hd) { return smem_two_tiles(hd) + 2 * TILE * (int)sizeof(float); }

// calls f(std::integral_constant<int, hd>{}); an unsupported hd is
// cudaErrorInvalidValue
template <typename F> int dispatch(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int HD> int set_smem_limits() {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int limits[6] = {
      (int)cudaFuncSetAttribute(flash_fwd_kernel<HD>, a, smem_two_tiles(HD)),
      (int)cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, a, smem_two_tiles(HD)),
      (int)cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>, a, smem_dkv(HD)),
      (int)cudaFuncSetAttribute(flash_fwd_mma_kernel<HD>, a, smem_fwd_mma(HD)),
      (int)cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HD>, a, smem_dq_mma(HD)),
      (int)cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<HD>, a, smem_dkv_mma(HD)),
  };
  for (int e : limits)
    if (e != 0) return e;
  return 0;
}

}  // namespace

extern "C" {

// Lift the dynamic shared-memory limit of every kernel above 48 KB (up to
// 107 KB for the bf16 dkv kernel at hd = 128): once per device, before the
// first launch.
int flash_init() {
  const int hds[4] = {16, 32, 64, 128};
  for (int hd : hds) {
    const int e = dispatch(hd, [](auto hdc) { return set_smem_limits<decltype(hdc)::value>(); });
    if (e != 0) return e;
  }
  return 0;
}

int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                     int BH, int BKV, int Sq, int Sk, int hd, int bf16_, float scale,
                     int causal, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int group = BH / BKV;
  return dispatch(hd, [&](auto hdc) {
    constexpr int HD = decltype(hdc)::value;
    if (bf16_) {
      flash_fwd_mma_kernel<HD><<<dim3(BH, Sq / MT), MMA_THREADS, smem_fwd_mma(HD), st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, Sq, Sk,
          group, scale, causal);
    } else {
      flash_fwd_kernel<HD><<<dim3(BH, Sq / ROWS), THREADS, smem_two_tiles(HD), st>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Sq, Sk,
          group, scale, causal);
    }
    return (int)cudaGetLastError();
  });
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int BH, int BKV,
                        int Sq, int Sk, int hd, int bf16_, float scale, int causal,
                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int group = BH / BKV;
  return dispatch(hd, [&](auto hdc) {
    constexpr int HD = decltype(hdc)::value;
    if (bf16_) {
      flash_bwd_dq_mma_kernel<HD><<<dim3(BH, Sq / MT), MMA_THREADS, smem_dq_mma(HD), st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          (const float*)lse, (const float*)delta, (bf16*)dq, Sq, Sk, group, scale, causal);
    } else {
      flash_bwd_dq_kernel<HD><<<dim3(BH, Sq / ROWS), THREADS, smem_two_tiles(HD), st>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
          (const float*)lse, (const float*)delta, (float*)dq, Sq, Sk, group, scale, causal);
    }
    return (int)cudaGetLastError();
  });
}

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int BH,
                         int BKV, int Sq, int Sk, int hd, int bf16_, float scale, int causal,
                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int group = BH / BKV;
  return dispatch(hd, [&](auto hdc) {
    constexpr int HD = decltype(hdc)::value;
    if (bf16_) {
      flash_bwd_dkv_mma_kernel<HD><<<dim3(BKV, Sk / MT), MMA_THREADS, smem_dkv_mma(HD), st>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Sk, group, scale,
          causal);
    } else {
      flash_bwd_dkv_kernel<HD><<<dim3(BKV, Sk / ROWS), THREADS, smem_dkv(HD), st>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
          (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Sq, Sk, group,
          scale, causal);
    }
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
