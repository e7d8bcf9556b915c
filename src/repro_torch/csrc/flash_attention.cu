// Flash attention on the card: the forward pass and the two backward passes,
// CUDA C++ for sm_90a with a plain C interface (bound with ctypes by
// repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention/kernel.py,
// each in a bfloat16 design (tensor cores) and a float32 one (CUDA cores):
//   flash_fwd        <- flash_attention_fwd (:79; _fwd_kernel :31):
//                       bf16 flash_fwd_wgmma_kernel, f32 flash_fwd_kernel
//   flash_bwd_dq     <- flash_attention_bwd's first pallas_call (:235;
//                       _bwd_dq_kernel :137): bf16 flash_bwd_dq_wgmma_kernel,
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
// float32 backward does not have).  The bf16 kernels take exp as exp2 with
// log2(e) folded into the scale, one ex2.approx.ftz instruction (a result
// below 2^-126 is zero) of one FMA: the forward's s * (scale log2 e) - m,
// its running max m kept in those units (the max of c s is c times the max
// of s for c > 0), the backward's s * (scale log2 e) - lse log2 e, the same
// in dQ and dK/dV, so that both see the same p and dS.  Key (dK/dV: query) tiles that
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
// * bfloat16 (flash_*_wgmma_kernel): built for Hopper.  A block has two
//   consumer warpgroups of 64 rows each and a producer, one thread of which
//   issues TMA loads into a ring of 3 shared-memory stages guarded by
//   mbarrier full/empty pairs, so the next tiles are in flight while the
//   tensor cores work.  The consumers run wgmma.m64nNk16 (bf16 in, float32
//   accumulate).  Tiles lie in shared memory as the tensor maps write them,
//   swizzled (128 B rows for hd 64 and 128, hd 128 as two 64-column chunks;
//   64 B for hd 32, 32 B for hd 16), and wgmma reads every operand as stored
//   through descriptors (hopper.cuh): K-major where the product reduces over
//   the head dim, MN-major (the transpose bit) where it reduces over the
//   tile's rows, so no tile is transposed or staged through registers.  The
//   score accumulator's layout is wgmma's register-A layout, so P and dS
//   (dK/dV: P^T and dS^T) are re-packed to bf16 in registers and never reach
//   shared or device memory.
//   Forward: a block owns 128 query rows of one head, loads them once and
//   streams K/V tiles of 64 keys (128 at hd 128), longest causal rows
//   first; its producer is one warp.  dQ: the forward's layout with dO
//   beside Q: a block owns 128 query rows, loads their Q, dO, lse and delta
//   once (Q and dO as the A operands of S = Q.K^T and dP = dO.V^T) and
//   streams K/V tiles of 64 keys of its kv head, longest causal rows first;
//   dQ += dS.K reads the same K tile MN-major, so one copy of K serves both
//   products, and dq is summed in float32 registers and written once.
//   dK/dV: a block owns 128 keys of one kv head, loads its K and V once as
//   the A operands of S^T = K.Q^T and dP^T = V.dO^T, and streams tiles of
//   64 queries (32 at hd 128) of Q, dO, lse and delta over every query head
//   of its group, so dk/dv are summed over the group in float32 in
//   registers and written once, with no atomics (deterministic).  The
//   backward kernels' producer is a warpgroup that gives its registers to
//   the consumers (setmaxnreg).  Tile sizes, stages and the producers are
//   the faster of the variants timed on the card.  Tried and slower there:
//   overlapping a tile's softmax with the previous tile's P.V inside a
//   warpgroup (ptxas then serialises the wgmmas), making the two consumers
//   take turns at the tensor cores through named barriers, a third consumer
//   warpgroup (192-row forward blocks) and two forward blocks per SM.  At
//   hd 128 dK/dV still spills some registers.
// * float32: the products run on the CUDA cores in float32 (67 TFLOP/s
//   peak), to keep float32 accuracy (the tensor cores' TF32 would not).  K/V
//   (or Q/dO) tiles are staged in shared memory as float32 and reused by 32
//   query (or key) rows; each row is split over 8 lanes that hold hd/8
//   interleaved dims in registers, so shared-memory reads are conflict-free
//   and a dot product is 3 warp shuffles; the score row of a 64-key tile lives
//   in registers.  The float32 dK/dV loops over the query heads of its kv
//   head inside the block as the bf16 one does.

#include <type_traits>

#include "hopper.cuh"

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
// bfloat16 forward, dQ and dK/dV: TMA, an mbarrier ring of tiles and wgmma
// ---------------------------------------------------------------------------

// Every kernel: consumer warpgroups 0 and 1 (64 rows each), then the
// producer.  The forward's producer is one warp (288 threads, 224 registers
// each at launch, which its consumers fit in); the backward kernels'
// consumers hold a float32 accumulator (dK/dV: two) beside two score tiles,
// so their producer is a whole warpgroup that hands its registers over
// (setmaxnreg 24 / 240; at 288 threads dK/dV spills at hd 64).
constexpr int FWD_THREADS = 288;
constexpr int BWD_THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int FWD_BM = 128;  // query rows per forward block
// keys per streamed K/V tile of the forward: 64 measured faster than 128
// at hd 64 (its score tile is half the registers); 128 at hd 128
template <int HD> constexpr int fwd_bn() { return HD == 128 ? 128 : 64; }
constexpr int DKV_BN = 128;  // keys per dK/dV block
// queries per streamed Q/dO tile of dK/dV: 32 at hd 128, where two 64 x hd
// float32 accumulators leave too few registers for 64-query score tiles
template <int HD> constexpr int dkv_bm() { return HD == 128 ? 32 : 64; }
constexpr int DQ_BM = 128;  // query rows per dQ block
// keys per streamed K/V tile of dQ: 128 spilled below hd 128 and was slower,
// and at hd 128 a 128-key ring would not fit in shared memory
constexpr int DQ_BN = 64;
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
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row, row + ROWS) of head `head` of a (heads, S, HD) tensor map
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int head) {
  using G = Geo<HD>;
#pragma unroll
  for (int c = 0; c < G::NCH; ++c) tma_load_3d(dst + c * ROWS * G::ROWB, map, bar, c * G::CW, row, head);
}

// K-major operand (the reduced dimension is the tile's columns): rows [r, r +
// 8n) of a ROWS-row tile at `base`, columns [16 d, 16 d + 16)
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int r, int d) {
  return desc_kmajor<Geo<HD>::ROWB, ROWS>(base, r, d);
}

// MN-major operand (the reduced dimension is the tile's rows): rows [16 kk,
// 16 kk + 16) of a ROWS-row tile at `base`, all HD columns
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk) {
  return desc_mnmajor<Geo<HD>::ROWB, ROWS>(base, kk);
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
__global__ void __launch_bounds__(BWD_THREADS, 1) flash_bwd_dkv_wgmma_kernel(
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
      // lse log2 e of this thread's 16 queries of the tile, taken once (as dQ
      // takes its rows'): read inside the loop below, they cost 8 B of spill
      float lq[BM / 4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        lq[2 * j] = Ls[8 * j + 2 * tig] * LOG2E;
        lq[2 * j + 1] = Ls[8 * j + 2 * tig + 1] * LOG2E;
      }
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
          float p = ex2(fmaf(st[4 * j + e], scale_log2, -lq[2 * j + (e & 1)]));
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

template <int HD> struct DqCfg {
  static constexpr int BN = DQ_BN;
  static constexpr int Q_BYTES = DQ_BM * HD * 2;  // one of Q, dO
  static constexpr int KV_BYTES = BN * HD * 2;    // one of K, V
  // stages of the K/V ring (a tile's K stays until its dS K is done): 4, or
  // 3 where 4 do not fit
  static constexpr int FIXED = 1024 + 2 * Q_BYTES + 2 * DQ_BM * 4 + 9 * 8;
  static constexpr int ST = FIXED + 4 * 2 * KV_BYTES <= 232448 ? 4 : 3;
  static constexpr int SMEM = FIXED + ST * 2 * KV_BYTES;
};

template <int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, int Sq,
    int Sk, int group, float scale, int causal) {
  using C = DqCfg<HD>;
  constexpr int ST = C::ST, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  unsigned char* DOs = Qs + C::Q_BYTES;
  unsigned char* KVs = DOs + C::Q_BYTES;  // stage s: K at KVs + 2 s KV_BYTES, V after it
  float* Ls = reinterpret_cast<float*>(KVs + ST * 2 * C::KV_BYTES);  // lse, then delta
  float* Es = Ls + DQ_BM;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Es + DQ_BM);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BM;  // longest causal rows first
  const int rows = min(DQ_BM, Sq - q0);  // 64 when Sq % 128 == 64 and this is the last block
  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + rows - 1) / BN + 1);

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
  if (wg == 2) {  // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const int kvh = bh / group;
      // lse and delta of this block's rows only: a 128-row copy would read
      // into the next head (or past the tensor) when rows == 64
      mbar_expect_tx(q_full, 2 * C::Q_BYTES + 2 * rows * 4);
      load_tile<HD, DQ_BM>(Qs, &tq, q_full, q0, bh);
      load_tile<HD, DQ_BM>(DOs, &tdo, q_full, q0, bh);
      bulk_load(Ls, lse + (size_t)bh * Sq + q0, rows * 4, q_full);
      bulk_load(Es, delta + (size_t)bh * Sq + q0, rows * 4, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], ((t / ST) & 1) ^ 1);
        unsigned char* ks = KVs + 2 * s * C::KV_BYTES;
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        load_tile<HD, BN>(ks, &tk, &full[s], t * BN, kvh);
        load_tile<HD, BN>(ks + C::KV_BYTES, &tv, &full[s], t * BN, kvh);
      }
    }
  } else {  // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int w0 = q0 + wg * 64;               // this warpgroup's first row
    const int lr = wg * 64 + warp * 16 + g;    // this thread's rows in the block: lr, lr + 8
    const int r0 = q0 + lr;
    const bool live = w0 < Sq;  // a block's second 64 rows lie past Sq when Sq % 128 == 64
    const float scale_log2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(Qs), do_addr = smem_u32(DOs);
    float dq_acc[HD / 2];
    zero(dq_acc);
    mbar_wait(q_full, 0);
    const float l0 = live ? Ls[lr] * LOG2E : 0.f, l1 = live ? Ls[lr + 8] * LOG2E : 0.f;
    const float e0 = live ? Es[lr] : 0.f, e1 = live ? Es[lr + 8] : 0.f;

    // Both warpgroups run every tile, the second one on zeros when its rows
    // lie past Sq, and the first one on a last tile that its causal mask
    // zeroes: a branch around the wgmmas (uniform per warpgroup, which ptxas
    // cannot see) makes ptxas serialise them (C7520).
    uint32_t dsa[BN / 16][4];  // the previous tile's dS, as wgmma A fragments
    uint32_t k_prev = 0;       // and its K tile
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % ST;
      mbar_wait(&full[s], (t / ST) & 1);
      const uint32_t k_addr = smem_u32(KVs + 2 * s * C::KV_BYTES);
      const uint32_t v_addr = k_addr + C::KV_BYTES;
      wg_fence();
      // dQ += dS K for the previous tile: dS from registers (rounded to
      // bf16), its K tile read MN-major
      if (t > 0) {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<1>(dq_acc, dsa[kk], desc_mn<HD, BN>(k_prev, kk), 1);
      }
      // S = Q K^T and dP = dO V^T: rows r0 (+8), keys 8 j + 2 tig (+1)
      float sc[BN / 2], dp[BN / 2];
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {  // the first products overwrite sc and dp
        wgmma_ss<0>(sc, desc_k<HD, DQ_BM>(q_addr, wg * 64, d), desc_k<HD, BN>(k_addr, 0, d),
                    d > 0);
        wgmma_ss<0>(dp, desc_k<HD, DQ_BM>(do_addr, wg * 64, d), desc_k<HD, BN>(v_addr, 0, d),
                    d > 0);
      }
      wg_commit();
      wg_wait<0>();
      hold(sc);
      hold(dp);
      hold(dq_acc);
      // the previous tile's dS K is done: its slot goes back to the producer
      if (t > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(t - 1) % ST]);
      }

      // p and dS by flash_bwd_dkv_wgmma_kernel's formula and rounding points
      const bool mask = (causal && (t + 1) * BN - 1 > w0) || (t + 1) * BN > Sk;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t * BN + 8 * j + 2 * tig + (e & 1);
          const int row = r0 + 8 * (e >> 1);
          float p = ex2(fmaf(sc[4 * j + e], scale_log2, -(e < 2 ? l0 : l1)));
          if (mask && ((causal && col > row) || col >= Sk)) p = 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? e0 : e1)) * scale;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a16(dsa[kk], dp, kk);
      k_prev = k_addr;
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs<1>(dq_acc, dsa[kk], desc_mn<HD, BN>(k_prev, kk), 1);
    wg_commit();
    wg_wait<0>();
    hold(dq_acc);

    if (live) {
      bf16* d0 = dq + ((size_t)bh * Sq + r0) * HD + 2 * tig;
      bf16* d1 = d0 + (size_t)8 * HD;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<uint32_t*>(d0 + 8 * i) = pack_bf16(dq_acc[4 * i], dq_acc[4 * i + 1]);
        *reinterpret_cast<uint32_t*>(d1 + 8 * i) = pack_bf16(dq_acc[4 * i + 2], dq_acc[4 * i + 3]);
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
      (int)cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<HD>, a, DqCfg<HD>::SMEM),
      (int)cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<HD>, a, DkvCfg<HD>::SMEM),
  };
  for (int e : limits)
    if (e != 0) return e;
  return 0;
}

// The tensor map of a (heads, S, HD) bf16 tensor read in boxes of `rows` rows
// and one swizzle chunk of columns (Geo<HD>); rows past S read as zeros.
template <int HD> int tile_map(CUtensorMap* map, const void* p, int heads, int S, int rows) {
  return tensor_map_3d(map, p, HD, S, heads, Geo<HD>::CW, rows);
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
      CUtensorMap tq, tk, tv, tdo;
      int e = tile_map<HD>(&tq, q, BH, Sq, DQ_BM);
      if (e == 0) e = tile_map<HD>(&tdo, dout, BH, Sq, DQ_BM);
      if (e == 0) e = tile_map<HD>(&tk, k, BKV, Sk, DqCfg<HD>::BN);
      if (e == 0) e = tile_map<HD>(&tv, v, BKV, Sk, DqCfg<HD>::BN);
      if (e != 0) return e;
      const dim3 grid(BH, (Sq + DQ_BM - 1) / DQ_BM);
      flash_bwd_dq_wgmma_kernel<HD><<<grid, BWD_THREADS, DqCfg<HD>::SMEM, st>>>(
          tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, Sq, Sk, group,
          scale, causal);
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
      flash_bwd_dkv_wgmma_kernel<HD><<<grid, BWD_THREADS, DkvCfg<HD>::SMEM, st>>>(
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
