// Flash attention on the card: the forward pass and the two backward passes,
// CUDA C++ for sm_90a with a plain C interface (bound with ctypes by
// repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention/kernel.py,
// each in a bfloat16 design (tensor cores) and a float32 one (CUDA cores):
//   flash_fwd        <- flash_attention_fwd (:79; _fwd_kernel :31):
//                       bf16 flash_fwd_wgmma_kernel, f32 flash_fwd_kernel
//   flash_bwd_dq     <- flash_attention_bwd's first pallas_call (:235;
//                       _bwd_dq_kernel :137): bf16 flash_bwd_dq_mma_kernel,
//                       f32 flash_bwd_dq_kernel
//   flash_bwd_dkv    <- flash_attention_bwd's second pallas_call (:255;
//                       _bwd_dkv_kernel :176): bf16 flash_bwd_dkv_wgmma_kernel,
//                       f32 flash_bwd_dkv_kernel
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
// to bf16 as operands of the second products, a rounding the reference's
// float32 backward does not have).  The bf16 forward and dK/dV take exp as
// exp2 with log2(e) folded into the scale; the forward's exponent is one
// FMA, s * (scale log2 e) - m, its running max m kept in those units (the
// max of c s is c times the max of s for c > 0).  Key (dK/dV: query) tiles that
// lie wholly above the causal diagonal are skipped: there p = 0 and the
// running max is unchanged, so the skip is exact.
//
// What bounds them.  At the training path's shape (B*H = 72, S = 2048,
// hd = 64, bf16, causal) the forward does 4*S*(S+1)/2*hd = 0.54 GFLOP per head
// against 1.4 MB of traffic per head: about 750 FLOP per byte, far above the
// H100's 295 FLOP/byte ridge, so the bound is operations (989 TFLOP/s of
// bf16 tensor-core work); the backward passes likewise.  So what matters is
// how fully the tensor cores are fed.  The designs:
//
// * bfloat16 forward and dK/dV (flash_*_wgmma_kernel): built for Hopper.  A
//   block has two consumer warpgroups of 64 rows each and a producer, one
//   thread of which issues TMA loads into a ring of 3 shared-memory stages
//   guarded by mbarrier full/empty pairs, so the next tiles are in flight
//   while the tensor cores work.  The consumers run wgmma.m64nNk16 (bf16 in,
//   float32 accumulate).  Tiles lie in shared memory as the tensor maps
//   write them, swizzled (128 B rows for hd 64 and 128, hd 128 as two
//   64-column chunks; 64 B for hd 32, 32 B for hd 16), and wgmma reads every
//   operand as stored through descriptors: K-major where the product
//   reduces over the head dim, MN-major (the transpose bit) where it reduces
//   over the tile's rows, so no tile is transposed or staged through
//   registers.  The score accumulator's layout is wgmma's register-A layout,
//   so P (dK/dV: P^T and dS^T) is re-packed to bf16 in registers and never
//   reaches shared or device memory.
//   Forward: a block owns 128 query rows of one head, loads them once and
//   streams K/V tiles of 64 keys (128 at hd 128), longest causal rows
//   first; its producer is one warp.  dK/dV: a block owns 128 keys of one
//   kv head, loads its K and V once as the A operands of S^T = K.Q^T and
//   dP^T = V.dO^T, and streams tiles of 64 queries (32 at hd 128) of Q, dO,
//   lse and delta over every query head of its group, so dk/dv are summed
//   over the group in float32 in registers and written once, with no
//   atomics (deterministic); its producer is a warpgroup that gives its
//   registers to the consumers (setmaxnreg).  Tile sizes, stages and the
//   two producers are the faster of the variants timed on the card.  Tried
//   and slower there: overlapping a tile's softmax with the previous
//   tile's P.V inside a warpgroup (ptxas then serialises the wgmmas),
//   making the two consumers take turns at the tensor cores through named
//   barriers, a third consumer warpgroup (192-row forward blocks) and two
//   forward blocks per SM.  At
//   hd 128 dK/dV still spills some registers.
// * bfloat16 dQ (flash_bwd_dq_mma_kernel): warp-level mma.sync.m16n8k16,
//   FlashAttention-2 style.  A block of 4 warps owns 64 query rows, 16 per
//   warp; each streamed K/V tile of 64 rows is staged through registers into
//   shared memory, row-major and, for dS.K, transposed, with rows padded by
//   8 elements.
// * float32: the products run on the CUDA cores in float32 (67 TFLOP/s
//   peak), to keep float32 accuracy (the tensor cores' TF32 would not).  K/V
//   (or Q/dO) tiles are staged in shared memory as float32 and reused by 32
//   query (or key) rows; each row is split over 8 lanes that hold hd/8
//   interleaved dims in registers, so shared-memory reads are conflict-free
//   and a dot product is 3 warp shuffles; the score row of a 64-key tile lives
//   in registers.  The float32 dK/dV loops over the query heads of its kv
//   head inside the block as the bf16 one does.

#include <cuda.h>
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
// bfloat16 dQ: tensor cores through mma.sync.m16n8k16
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
constexpr int smem_dq_mma(int hd) { return 2 * rows_bytes(hd) + cols_bytes(hd); }

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

// ---------------------------------------------------------------------------
// bfloat16 forward and dK/dV: TMA, an mbarrier ring of tiles and wgmma
// ---------------------------------------------------------------------------

// Both kernels: consumer warpgroups 0 and 1 (64 rows each), then the
// producer.  The forward's producer is one warp (288 threads, 224 registers
// each at launch, which its consumers fit in); dK/dV's consumers hold two
// 64 x hd float32 accumulators beside two score tiles and need 240, so its
// producer is a whole warpgroup that hands its registers over (setmaxnreg
// 24 / 240; at 288 threads hd 64 spills).
constexpr int FWD_THREADS = 288;
constexpr int DKV_THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int FWD_BM = 128;  // query rows per forward block
// keys per streamed K/V tile of the forward: 64 measured faster than 128
// at hd 64 (its score tile is half the registers); 128 at hd 128
template <int HD> constexpr int fwd_bn() { return HD == 128 ? 128 : 64; }
constexpr int DKV_BN = 128;  // keys per dK/dV block
// queries per streamed Q/dO tile of dK/dV: 32 at hd 128, where two 64 x hd
// float32 accumulators leave too few registers for 64-query score tiles
template <int HD> constexpr int dkv_bm() { return HD == 128 ? 32 : 64; }
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A tile of ROWS rows of HD bf16 lies in shared memory as NCH column chunks
// of CW columns, each ROWS rows of ROWB bytes, in the swizzle the tensor map
// writes and the wgmma descriptor reads: 128 B for hd 64 and 128 (hd 128 as
// two 64-column chunks), 64 B for hd 32, 32 B for hd 16.
template <int HD> struct Geo {
  static constexpr int ROWB = HD >= 64 ? 128 : HD * 2;
  static constexpr int CW = ROWB / 2;
  static constexpr int NCH = HD / CW;
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // B128, B64, B32
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of the given parity has completed; a wait that outlasts
// about 10 s of clock traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// box (c0, c1, c2) of a 3-d tensor map into shared memory, counted on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// bytes (a multiple of 16) of contiguous device memory into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// rows [row, row + ROWS) of head `head` of a (heads, S, HD) tensor map
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int head) {
  using G = Geo<HD>;
#pragma unroll
  for (int c = 0; c < G::NCH; ++c) tma_load_3d(dst + c * ROWS * G::ROWB, map, bar, c * G::CW, row, head);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching accumulators across an asynchronous wgmma
template <int R> __device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R> __device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// K-major operand (the reduced dimension is the tile's columns): rows [r, r +
// 8n) of a ROWS-row tile at `base`, columns [16 d, 16 d + 16)
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int r, int d) {
  using G = Geo<HD>;
  const uint32_t a = base + (16 * d / G::CW) * ROWS * G::ROWB + r * G::ROWB + (16 * d % G::CW) * 2;
  return make_desc(a, 16, 8 * G::ROWB, G::LAYOUT);
}

// MN-major operand (the reduced dimension is the tile's rows): rows [16 kk,
// 16 kk + 16) of a ROWS-row tile at `base`, all HD columns; 8-row groups
// SBO apart, column chunks LBO apart
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk) {
  using G = Geo<HD>;
  return make_desc(base + 16 * kk * G::ROWB, ROWS * G::ROWB, 8 * G::ROWB, G::LAYOUT);
}

// A fragment (16 reduced columns 16 kk..) of a 64-row wgmma from a float32
// accumulator over those columns, rounded to bf16
template <int R> __device__ __forceinline__ void acc_to_a16(uint32_t (&a)[4], const float (&c)[R], int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// d = A * B + (scale_d ? d : 0) on the tensor cores, for one warpgroup:
// m64nNk16, bf16 in, float32 accumulate; N = 2 * (registers of d).  ss: A
// and B from shared memory; rs: A from registers.  TB = 1 reads B MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int HD> struct FwdCfg {
  static constexpr int ST = 3;  // stages of the K/V ring
  static constexpr int Q_BYTES = FWD_BM * HD * 2;
  static constexpr int BN = fwd_bn<HD>();
  static constexpr int KV_BYTES = BN * HD * 2;   // one of K, V
  static constexpr int SMEM = 1024 + Q_BYTES + ST * 2 * KV_BYTES + (1 + 2 * ST) * 8;
};

template <int HD>
__global__ void __launch_bounds__(FWD_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, float* __restrict__ lse, int Sq,
    int Sk, int group, float scale_log2, int causal) {
  using C = FwdCfg<HD>;
  constexpr int ST = C::ST, FWD_BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* KVs = Qs + C::Q_BYTES;  // stage s: K at KVs + 2 s KV_BYTES, V after it
  uint64_t* q_full = (uint64_t*)(KVs + ST * 2 * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BM;  // longest causal rows first
  int n_tiles = (Sk + FWD_BN - 1) / FWD_BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + FWD_BM, Sq) - 1) / FWD_BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == 256) {
      const int kvh = bh / group;
      mbar_expect_tx(q_full, C::Q_BYTES);
      load_tile<HD, FWD_BM>(Qs, &tq, q_full, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
        unsigned char* ks = KVs + 2 * s * C::KV_BYTES;
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        load_tile<HD, FWD_BN>(ks, &tk, &full[s], t * FWD_BN, kvh);
        load_tile<HD, FWD_BN>(ks + C::KV_BYTES, &tv, &full[s], t * FWD_BN, kvh);
      }
    }
  } else {  // consumers: 64 query rows each
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int r0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    const uint32_t q_addr = smem_u32(Qs);
    float acc[HD / 2];
    zero(acc);
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // max in log2 units
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      const uint32_t k_addr = smem_u32(KVs + 2 * s * C::KV_BYTES);
      const uint32_t v_addr = k_addr + C::KV_BYTES;
      float sc[FWD_BN / 2];  // S = Q K^T: rows r0 (+8), keys 8 j + 2 tig (+1)
      wg_fence();
#pragma unroll
      for (int d = 0; d < HD / 16; ++d)  // the first product overwrites sc
        wgmma_ss<0>(sc, desc_k<HD, FWD_BM>(q_addr, wg * 64, d), desc_k<HD, FWD_BN>(k_addr, 0, d),
                    d > 0);
      wg_commit();
      wg_wait<0>();
      hold(sc);

      const bool mask = (causal && (t + 1) * FWD_BN - 1 > q0) || (t + 1) * FWD_BN > Sk;
      float rx0 = NEG_INF, rx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < FWD_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if (mask) {
            const int col = t * FWD_BN + 8 * j + 2 * tig + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if ((causal && col > row) || col >= Sk) x = NEG_INF;
          }
          sc[4 * j + e] = x;
          if (e < 2) rx0 = fmaxf(rx0, x); else rx1 = fmaxf(rx1, x);
        }
      }
      rx0 = fmaxf(rx0, __shfl_xor_sync(0xffffffffu, rx0, 1));
      rx0 = fmaxf(rx0, __shfl_xor_sync(0xffffffffu, rx0, 2));
      rx1 = fmaxf(rx1, __shfl_xor_sync(0xffffffffu, rx1, 1));
      rx1 = fmaxf(rx1, __shfl_xor_sync(0xffffffffu, rx1, 2));
      const float mx0 = fmaxf(m0, rx0 * scale_log2), mx1 = fmaxf(m1, rx1 * scale_log2);
      const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < FWD_BN / 8; ++j) {
        sc[4 * j + 0] = ex2(fmaf(sc[4 * j + 0], scale_log2, -mx0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -mx0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -mx1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -mx1));
        ps0 += sc[4 * j + 0] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = a0 * l0 + ps0;  // this lane's part of the row sum
      l1 = a1 * l1 + ps1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[4 * i + 0] *= a0;
        acc[4 * i + 1] *= a0;
        acc[4 * i + 2] *= a1;
        acc[4 * i + 3] *= a1;
      }
      // O += P V: P from registers (p rounded to bf16), V as stored, MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_BN / 16; ++kk) {
        uint32_t pa[4];
        acc_to_a16(pa, sc, kk);
        wgmma_rs<1>(acc, pa, desc_mn<HD, FWD_BN>(v_addr, kk), 1);
      }
      wg_commit();
      wg_wait<0>();
      hold(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (r0 < Sq) {  // a block's second 64 rows lie past Sq when Sq % 128 == 64
      const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
      bf16* o0 = o + ((size_t)bh * Sq + r0) * HD + 2 * tig;
      bf16* o1 = o0 + (size_t)8 * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<uint32_t*>(o0 + 8 * i) = pack_bf16(acc[4 * i] / lc0, acc[4 * i + 1] / lc0);
        *reinterpret_cast<uint32_t*>(o1 + 8 * i) =
            pack_bf16(acc[4 * i + 2] / lc1, acc[4 * i + 3] / lc1);
      }
      if (tig == 0) {
        lse[(size_t)bh * Sq + r0] = m0 * LN2 + logf(lc0);
        lse[(size_t)bh * Sq + r0 + 8] = m1 * LN2 + logf(lc1);
      }
    }
  }
}

template <int HD> struct DkvCfg {
  static constexpr int ST = 3;  // stages of the Q/dO ring
  static constexpr int BM = dkv_bm<HD>();
  static constexpr int KV_BYTES = DKV_BN * HD * 2;      // one of K, V
  static constexpr int T_BYTES = BM * HD * 2;           // one of Q, dO
  static constexpr int STAGE = 2 * T_BYTES + 1024;      // Q, dO, lse and delta (512 B)
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + ST * STAGE + (1 + 2 * ST) * 8;
};

template <int HD>
__global__ void __launch_bounds__(DKV_THREADS, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Sk, int group, float scale, int causal) {
  using C = DkvCfg<HD>;
  constexpr int ST = C::ST, BM = C::BM;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* Vs = Ks + C::KV_BYTES;
  unsigned char* Ts = Vs + C::KV_BYTES;  // stage s at Ts + s STAGE: Q, dO, lse, delta
  uint64_t* kv_full = (uint64_t*)(Ts + ST * C::STAGE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * DKV_BN;  // key block 0 has the most causal rows: first
  // query tiles before the one holding query k0 see only masked scores
  const int t0 = causal ? k0 / BM : 0;
  const int n_t = max(Sq / BM - t0, 0);
  const int n_iter = group * n_t;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      load_tile<HD, DKV_BN>(Ks, &tk, kv_full, k0, bkv);
      load_tile<HD, DKV_BN>(Vs, &tv, kv_full, k0, bkv);
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        const int bh = bkv * group + i / n_t;
        const int qr = (t0 + i % n_t) * BM;
        unsigned char* ts = Ts + s * C::STAGE;
        mbar_expect_tx(&full[s], 2 * C::T_BYTES + 2 * BM * 4);
        load_tile<HD, BM>(ts, &tq, &full[s], qr, bh);
        load_tile<HD, BM>(ts + C::T_BYTES, &tdo, &full[s], qr, bh);
        bulk_load(ts + 2 * C::T_BYTES, lse + (size_t)bh * Sq + qr, BM * 4, &full[s]);
        bulk_load(ts + 2 * C::T_BYTES + BM * 4, delta + (size_t)bh * Sq + qr, BM * 4,
                  &full[s]);
      }
    }
  } else {  // consumers: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int c0 = k0 + wg * 64 + warp * 16 + g;  // this thread's keys: c0, c0 + 8
    const float scale_log2 = scale * LOG2E;
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    float dk_acc[HD / 2], dv_acc[HD / 2];
    zero(dk_acc);
    zero(dv_acc);
    mbar_wait(kv_full, 0);

    for (int i = 0; i < n_iter; ++i) {
      const int s = i % ST;
      const int t = t0 + i % n_t;
      mbar_wait(&full[s], (i / ST) & 1);
      unsigned char* ts = Ts + s * C::STAGE;
      const uint32_t q_addr = smem_u32(ts), do_addr = q_addr + C::T_BYTES;
      const float* Ls = reinterpret_cast<const float*>(ts + 2 * C::T_BYTES);
      const float* Es = Ls + BM;
      // S^T = K Q^T and dP^T = V dO^T: keys c0 (+8), queries 8 j + 2 tig (+1)
      float st[BM / 2], dpt[BM / 2];
      zero(st);
      zero(dpt);
      wg_fence();
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        wgmma_ss<0>(st, desc_k<HD, DKV_BN>(k_addr, wg * 64, d), desc_k<HD, BM>(q_addr, 0, d), 1);
        wgmma_ss<0>(dpt, desc_k<HD, DKV_BN>(v_addr, wg * 64, d), desc_k<HD, BM>(do_addr, 0, d),
                    1);
      }
      wg_commit();
      wg_wait<0>();
      hold(st);
      hold(dpt);

      const bool mask = causal && t * BM < k0 + DKV_BN - 1;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tig + (e & 1);  // query within the tile
          const int key = c0 + 8 * (e >> 1);
          float p = exp2f(st[4 * j + e] * scale_log2 - Ls[qi] * LOG2E);
          if (mask && key > t * BM + qi) p = 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - Es[qi]) * scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q: A from registers (rounded to bf16),
      // dO and Q as stored, MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        acc_to_a16(pa, st, kk);
        acc_to_a16(dsa, dpt, kk);
        wgmma_rs<1>(dv_acc, pa, desc_mn<HD, BM>(do_addr, kk), 1);
        wgmma_rs<1>(dk_acc, dsa, desc_mn<HD, BM>(q_addr, kk), 1);
      }
      wg_commit();
      wg_wait<0>();
      hold(dk_acc);
      hold(dv_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    if (c0 < Sk) {  // a block's second 64 keys lie past Sk when Sk % 128 == 64
      bf16* kp = dk + ((size_t)bkv * Sk + c0) * HD + 2 * tig;
      bf16* vp = dv + ((size_t)bkv * Sk + c0) * HD + 2 * tig;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<uint32_t*>(kp + 8 * i) = pack_bf16(dk_acc[4 * i], dk_acc[4 * i + 1]);
        *reinterpret_cast<uint32_t*>(kp + 8 * HD + 8 * i) =
            pack_bf16(dk_acc[4 * i + 2], dk_acc[4 * i + 3]);
        *reinterpret_cast<uint32_t*>(vp + 8 * i) = pack_bf16(dv_acc[4 * i], dv_acc[4 * i + 1]);
        *reinterpret_cast<uint32_t*>(vp + 8 * HD + 8 * i) =
            pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
      }
    }
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
      (int)cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD>, a, FwdCfg<HD>::SMEM),
      (int)cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<HD>, a, smem_dq_mma(HD)),
      (int)cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<HD>, a, DkvCfg<HD>::SMEM),
  };
  for (int e : limits)
    if (e != 0) return e;
  return 0;
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint),
// so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

int load_encode_tiled() {
  if (encode_tiled != nullptr) return 0;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  const cudaError_t e =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
  if (e != cudaSuccess) return (int)e;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
  encode_tiled = (EncodeTiled)fn;
  return 0;
}

// The tensor map of a (heads, S, HD) bf16 tensor read in boxes of `rows` rows
// and one swizzle chunk of columns (Geo<HD>); rows past S read as zeros.
template <int HD> int tile_map(CUtensorMap* map, const void* p, int heads, int S, int rows) {
  using G = Geo<HD>;
  if (encode_tiled == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)G::CW, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = G::ROWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
                                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Lift the dynamic shared-memory limit of every kernel above 48 KB and fetch
// the tensor-map encoder: once per device, before the first launch.
int flash_init() {
  const int e = load_encode_tiled();
  if (e != 0) return e;
  const int hds[4] = {16, 32, 64, 128};
  for (int hd : hds) {
    const int e2 = dispatch(hd, [](auto hdc) { return set_smem_limits<decltype(hdc)::value>(); });
    if (e2 != 0) return e2;
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
      CUtensorMap tq, tk, tv;
      int e = tile_map<HD>(&tq, q, BH, Sq, FWD_BM);
      if (e == 0) e = tile_map<HD>(&tk, k, BKV, Sk, fwd_bn<HD>());
      if (e == 0) e = tile_map<HD>(&tv, v, BKV, Sk, fwd_bn<HD>());
      if (e != 0) return e;
      const dim3 grid(BH, (Sq + FWD_BM - 1) / FWD_BM);
      flash_fwd_wgmma_kernel<HD><<<grid, FWD_THREADS, FwdCfg<HD>::SMEM, st>>>(
          tq, tk, tv, (bf16*)o, (float*)lse, Sq, Sk, group, scale * LOG2E, causal);
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
      CUtensorMap tq, tk, tv, tdo;
      int e = tile_map<HD>(&tq, q, BH, Sq, dkv_bm<HD>());
      if (e == 0) e = tile_map<HD>(&tdo, dout, BH, Sq, dkv_bm<HD>());
      if (e == 0) e = tile_map<HD>(&tk, k, BKV, Sk, DKV_BN);
      if (e == 0) e = tile_map<HD>(&tv, v, BKV, Sk, DKV_BN);
      if (e != 0) return e;
      const dim3 grid(BKV, (Sk + DKV_BN - 1) / DKV_BN);
      flash_bwd_dkv_wgmma_kernel<HD><<<grid, DKV_THREADS, DkvCfg<HD>::SMEM, st>>>(
          tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Sk,
          group, scale, causal);
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
