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
// P <= 64, N <= 128, Q <= 256 and Q divides S.
//
// Above the diagonal a_cs[q] - a_cs[k] is positive and exp overflows: L is a
// select (q >= k ? exp(...) : 0), never a multiply by a 0/1 mask, which would
// give inf * 0 = NaN; key tiles wholly above every query row of a block are
// skipped, which is exact (their weights are all 0).
//
// What bounds it.  At the serving path's prefill shape (B = 8, S = 2048,
// nh = 24, P = 64, N = 128, Q = 256, bfloat16) the function needs, per
// (b, chunk), the causal half of C B^T (2 * Q(Q+1)/2 * N FLOP, shared by the
// heads) and per (bh, chunk) the causal half of the W x product plus
// 4 * Q * P * N for y_inter and the state: 19.9 GFLOP in all against 118 MB of
// inputs and outputs.  On the bf16 tensor cores that is 20 us of operations
// and 35 us of bytes, so bytes bound it.  The three stages below move about
// 250 MB more at the path: the chunk states written and read (101 MB), the
// entering states written and read by both query-tile pairs (76 MB), and x
// read again by the chunk outputs, 1.5 times (76 MB).
//
// Two designs:
//
//   bfloat16: three kernels a call, chunk-parallel, every product on wgmma
//   (bf16 in, float32 accumulate; hopper.cuh), after the chunk_state /
//   state_passing / chunk_scan split of Mamba-2's own GPU kernels.
//   1. ssd_chunk_state_kernel, one block (one warpgroup) per (bh, chunk),
//      two blocks an SM: x and B arrive by TMA while the threads take the
//      chunk's a_cs (written out for stages 2 and 3) and s = exp(a_last -
//      a_cs) * dt; then S_c = x^T (B * s) = (x * s)^T B, with x~ = x * s
//      formed in registers as wgmma's A fragments, a bf16 pair hi + lo
//      (hi = bf16(x~), lo = bf16(x~ - hi)): two wgmma.m64n128k16 chains on
//      the same B tile, read MN-major as it lies.  Scaling x rather than B
//      (the reference's order) keeps the split out of shared memory: x is
//      half of B's bytes, and the block needs 99 KB instead of 163 KB.  S_c
//      (64 x 128 float32, zero-padded) goes to a temporary (BH, chunks, 64,
//      128).
//   2. ssd_state_pass_kernel, one thread per four state elements of a row
//      bh, walking the chunks: H_0 = 0, H_{c+1} = H_c * exp(a_last_c) + S_c
//      in float32; it writes the state entering each chunk, rounded to
//      bf16, to a second temporary (2, BH, chunks, 64, 128), and the last H
//      as the final state.  From the first chunk of the row where a_cs rises
//      (stage 1 flags each chunk with some da > 0) on, it also writes lo =
//      bf16(H - hi) beside it: there H and W enter stage 3 as bf16 pairs.
//   3. ssd_chunk_out_kernel, one block per (b, chunk, pair of 64-row query
//      tiles 2 z and 2 z + 1, group of heads): two consumer warpgroups, one
//      a query tile, and a producer warpgroup (setmaxnreg 24 / 240).  One
//      producer thread loads by TMA both C tiles and the B tiles at or below
//      the pair's diagonal once, then keeps a 2-slot mbarrier ring of each
//      head's x tiles and entering state H, which both consumers read.  Each
//      consumer computes G = C B^T once for the whole group (wgmma
//      m64n64k16 per 64-key tile, K-major both) and keeps it in registers;
//      per head, y = (C H^T) (wgmma from shared memory) scaled by
//      exp(a_cs[q]) row by row, then y += W x with W = G o L o dt packed to
//      bf16 in registers as wgmma's A (the accumulator's layout is the A
//      fragment's) and x read MN-major; y is stored in bf16.  Both consumers
//      run the pair's key tiles, so the first's last tile is wholly above
//      its diagonal (zero weights): the same instructions for both, no
//      branch around a wgmma.  Below the diagonal a key tile's weights need
//      no exponential an element: L = exp(a_q - a_k1) exp(a_k1 - a_k) with
//      k1 the tile's last key, one exponential a row and one a key, taken
//      when the block starts (the per-element exponential, whose latency the
//      consumers could not hide, led the kernel's time).  Where da <= 0 (the
//      model's dt > 0 and A < 0) a_cs does not rise and each factor is at
//      most 1.  With da > 0 a factor can exceed 1; it overflows only where
//      a_cs rises by more than 88 within the chunk, and then the plain
//      version's own weight exp(a_q - a_k1) or exp(a_k1 - a_k) overflows
//      too, so its y is not finite in that chunk either.  Where a_cs has
//      risen (in the chunk or an earlier one of the row) the state and y
//      grow past what one bf16 rounding of W and H keeps within the y
//      tolerance: there (a flag uniform over the block, broadcast from lane 0
//      so that no wgmma is serialised) the producer loads H's lo tiles into
//      the B tiles' place once G is done with them, C Hlo^T is added, and a
//      second pass over the key tiles adds W's lo parts; where da <= 0 (the
//      models) no chunk takes the pair and the kernel does what it did.
//      The caller's plan (kernel.py ssd_plan) gives every kernel's grid, and
//      the launch refuses it unless its threads and shared memory are the
//      kernel's.  It takes the largest head group, at most 8, that still
//      gives every SM of the card a block (8 of 24 heads at the path: 384
//      blocks; groups 2, 4, 6 and 8 timed within 5% of each other there),
//      the pairs with the most keys first.
//   Where P or N is not a multiple of 8 or a pointer is not 16-byte aligned,
//   TMA cannot address the tensors: the threads stage the same tiles element
//   by element (zeros past P, N and the chunk); the products are the same.
//   Temporaries of one call: the chunk states (float32) and the entering
//   states (bf16), BH * chunks * 64 * 128 * 6 bytes, and a_cs, BH * S * 4:
//   50.3 + 25.2 + 1.6 MB at the path.
//
//   float32 (ssd_scan_f32_kernel): the CUDA cores, the first port's design, one
//   block per (b, h) walking the chunks with the 64 x 128 float32 state in
//   shared memory; products in float32 from 4 x 4 register tiles.  Its
//   tolerance (2e-3 against the plain version) admits no bf16 or TF32
//   product.
//
// Rounding points of the bfloat16 design.  Products of bf16 operands are
// exact in the tensor cores and sum in float32: C B^T (G), C H^T, hi^T B,
// lo^T B and W x.  Rounded operands: x~ = x * s (one float32 product) to the
// pair hi + lo (about 16 bits: the scaled operand wholly in bf16 would use
// most of the state's 2e-3 tolerance); the state entering a chunk, for
// y_inter only, to bf16, or to the pair hi + lo in a chunk where a_cs has
// risen (the carried state stays float32); W, to bf16 (a pair likewise): on
// the diagonal tile (G * L) * dt with L from __expf (ex2.approx of a
// multiply), below it (G * exp(a_q - a_k1)) * (exp(a_k1 - a_k) * dt), each
// product rounded in float32.  exp(a_last - a_cs), exp(a_last) and exp(a_cs[q]) use
// expf; y_inter is scaled in float32 before W x is added, and y is rounded
// once to bf16.  The cumsum runs in another order than the reference's,
// once, and every stage reads it.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: chunk states, state passing, chunk outputs
// ---------------------------------------------------------------------------

constexpr int QMAX = 256;              // longest chunk
constexpr int ROWB = 128;              // bytes of a swizzled tile row: 64 bf16
constexpr int TILE = 64 * ROWB;        // 64 rows of one 64-column chunk: 8 KB
constexpr int PP = 64, NP = 128;       // a chunk state's padded (P, N)
constexpr int WG = 128;                // threads of a warpgroup
constexpr int NST = 2;                 // ring slots (heads in flight) of stage 3
constexpr int MAX_GROUP = 8;           // heads of one stage-3 block

// stage 1: x (QMAX keys x 64 P) and B (QMAX keys, two 64-column chunks) as
// TMA writes them, a_cs and the keys' scale, four warp sums, an mbarrier
constexpr int S1_X = QMAX * ROWB;
constexpr int S1_B = 2 * QMAX * ROWB;
constexpr int S1_SMEM = 1024 + S1_X + S1_B + 2 * QMAX * 4 + 16 + 8;
// stage 3: C (two query tiles of 64, two chunks each), B (QMAX keys, two
// chunks), NST slots of x (QMAX keys x 64 P) and H (64 P, two chunks), a_cs,
// dt and exp(a_k1 - a_cs) * dt of the group's heads, five mbarriers
constexpr int S3_C = 2 * 2 * TILE;
constexpr int S3_B = 2 * QMAX * ROWB;
constexpr int S3_X = QMAX * ROWB;
constexpr int S3_SLOT = S3_X + 2 * TILE;
constexpr int S3_SMEM = 1024 + S3_C + S3_B + NST * S3_SLOT + 3 * MAX_GROUP * QMAX * 4 + 64;
constexpr int S3_THREADS = 3 * WG;  // two consumer warpgroups and a producer
constexpr int S2_THREADS = 256;     // state passing
static_assert(S1_SMEM <= 232448 / 2 && S3_SMEM <= 232448, "shared memory of a block");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return (unsigned char*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

// byte offset of the bf16 at row r, column col (< 64) of a tile of 128-byte
// rows at a 1024-byte boundary, swizzled at 128 B as TMA writes it
__device__ __forceinline__ uint32_t swz(int r, int col) {
  return r * ROWB + ((((col >> 3) ^ r) & 7) << 4) + 2 * (col & 7);
}

// shared-memory writes of the threads, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the first `threads` threads of the block (named barrier 1)
__device__ __forceinline__ void sync_threads(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// rows [0, rows) x columns [0, 64 nch) of a row-major bf16 matrix (leading
// dimension ld) into nch 64-column chunks of 128-byte swizzled rows, chunk j
// at dst + j * chunk_bytes, zeros at rows >= nr or columns >= nc: threads
// [0, threads), an element each, where TMA cannot address the tensor
__device__ void stage_tile(unsigned char* dst, int chunk_bytes, int rows, int nch,
                           const bf16* __restrict__ src, int ld, int nr, int nc, int threads) {
  const int cols = 64 * nch;
  for (int i = threadIdx.x; i < rows * cols; i += threads) {
    const int r = i / cols, col = i % cols;
    bf16 v = __float2bfloat16_rn(0.f);
    if (r < nr && col < nc) v = src[(size_t)r * ld + col];
    *reinterpret_cast<bf16*>(dst + (col >> 6) * chunk_bytes + swz(r, col & 63)) = v;
  }
}

// the inclusive cumsum of a chunk's Q <= 256 values of da (zeros past Q), two
// a thread, by the 128 threads of the block; returns whether a_cs rises (some
// da > 0), the block's answer
__device__ int chunk_cumsum(const float* __restrict__ da, int Q, float* acs, float* ws) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float d0 = 2 * t < Q ? da[2 * t] : 0.f;
  const float d1 = 2 * t + 1 < Q ? da[2 * t + 1] : 0.f;
  float v = d0 + d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) ws[warp] = v;
  float before = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) before = 0.f;
  const int up = __syncthreads_or(d0 > 0.f || d1 > 0.f);
  for (int w = 0; w < warp; ++w) before += ws[w];
  const float a0 = before + d0;
  acs[2 * t] = a0;
  acs[2 * t + 1] = a0 + d1;
  return up;
}

// v = hi + lo to about 16 bits, for two neighbouring values of a fragment
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(v0, __low2float(h)), __fsub_rn(v1, __high2float(h)));
}

// Stage 1.  Block bh * chunks + c: a_cs of the chunk, and its state
// S_c = x^T (B * s) = (x * s)^T B with s = exp(a_last - a_cs) * dt.  TMA: x
// and B arrive by TMA while the threads take the cumsum; else the threads
// stage them element by element.  x~ = x * s is formed in registers as
// wgmma's A fragments, a bf16 pair hi + lo; B is read MN-major as it lies.
template <bool TMA>
__global__ void __launch_bounds__(WG, 2)
ssd_chunk_state_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                       const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ da, const bf16* __restrict__ Bm,
                       float* __restrict__ acs_out, float* __restrict__ states,
                       int* __restrict__ rising, int S, int P, int N, int nheads, int Q) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sx = align1024(smem_raw);
  unsigned char* sb = sx + S1_X;
  float* sacs = reinterpret_cast<float*>(sb + S1_B);
  float* sscale = sacs + QMAX;
  float* ws = sscale + QMAX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws + 4);

  const int tid = threadIdx.x;
  const int chunks = S / Q;
  const int bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const size_t row0 = (size_t)bh * S + (size_t)c * Q;  // the chunk's first row of (BH, S)
  const int KT = (Q + 63) / 64;  // key tiles of 64
  if (TMA && tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 3 * KT * TILE);
    for (int kt = 0; kt < KT; ++kt) {
      tma_load_3d(sx + kt * TILE, &tx, bar, 0, c * Q + 64 * kt, bh);
      for (int j = 0; j < 2; ++j)
        tma_load_3d(sb + j * QMAX * ROWB + kt * TILE, &tb, bar, 64 * j, c * Q + 64 * kt,
                    bh / nheads);
    }
  }

  const int up = chunk_cumsum(da + row0, Q, sacs, ws);
  __syncthreads();
  if (tid == 0) rising[blockIdx.x] = up;
  const float a_last = sacs[Q - 1];
  for (int k = tid; k < QMAX; k += WG) {
    float s = 0.f;  // zero past the chunk: those rows of the tiles are the next chunk's
    if (k < Q) {
      s = __fmul_rn(expf(a_last - sacs[k]), dt[row0 + k]);
      acs_out[row0 + k] = sacs[k];
    }
    sscale[k] = s;
  }
  if constexpr (TMA) {
    __syncthreads();
    mbar_wait(bar, 0);
  } else {
    stage_tile(sx, S1_X, 64 * KT, 1, x + row0 * P, P, Q, P, WG);
    stage_tile(sb, QMAX * ROWB, 64 * KT, 2, Bm + ((size_t)(bh / nheads) * S + (size_t)c * Q) * N,
               N, Q, N, WG);
    fence_async_shared();
    __syncthreads();
  }

  // S_c (64 P x 128 N): rows p0 (+8) of x~^T, keys 16 kk + 2 tig (+1, +8, +9)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int p0 = warp * 16 + g;
  float acc[64];
  zero(acc);
  const uint32_t b_addr = smem_u32(sb);
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 64 * kt + 16 * kk + 2 * tig;
      const float2 s01 = *reinterpret_cast<const float2*>(sscale + k);
      const float2 s89 = *reinterpret_cast<const float2*>(sscale + k + 8);
      const float sk[4] = {s01.x, s01.y, s89.x, s89.y};
      const int keys[4] = {k, k + 1, k + 8, k + 9};
      float v[2][4];  // rows p0, p0 + 8
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          v[h][e] = __fmul_rn(
              __bfloat162float(*reinterpret_cast<const bf16*>(sx + swz(keys[e], p0 + 8 * h))),
              sk[e]);
      split_pair(v[0][0], v[0][1], hi[kk][0], lo[kk][0]);
      split_pair(v[1][0], v[1][1], hi[kk][1], lo[kk][1]);
      split_pair(v[0][2], v[0][3], hi[kk][2], lo[kk][2]);
      split_pair(v[1][2], v[1][3], hi[kk][3], lo[kk][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = desc_mnmajor<ROWB, QMAX>(b_addr, 4 * kt + kk);
      wgmma_rs<1>(acc, hi[kk], bd, 1);
      wgmma_rs<1>(acc, lo[kk], bd, 1);
    }
    wg_commit();
    wg_wait<0>();
  }
  hold(acc);

  float* out = states + (size_t)blockIdx.x * (PP * NP);
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(out + p0 * NP + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (p0 + 8) * NP + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// the four values as bf16 pairs: hi = bf16(v) and lo = bf16(v - hi)
__device__ __forceinline__ void split4(const float4& v, uint2& hi, uint2& lo) {
  split_pair(v.x, v.y, hi.x, lo.x);
  split_pair(v.z, v.w, hi.y, lo.y);
}

// Stage 2.  Thread (bh, p, 4 n): the state entering each chunk in bf16, hi
// (and lo = bf16(H - hi) from the first chunk of the row where a_cs rises
// on, for which the row's first thread sets pairs[]), and the final state.
__global__ void __launch_bounds__(S2_THREADS)
ssd_state_pass_kernel(const float* __restrict__ states, const float* __restrict__ acs,
                      const int* __restrict__ rising, int* __restrict__ pairs,
                      bf16* __restrict__ entering,
                      bf16* __restrict__ entering_lo, float* __restrict__ final_state, int BH,
                      int S, int P, int N, int Q) {
  constexpr int V = PP * NP / 4;  // float4s of a state
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)BH * V) return;
  const int chunks = S / Q;
  const int bh = (int)(i / V), e = (int)(i % V);
  const float4* s = reinterpret_cast<const float4*>(states) + (size_t)bh * chunks * V + e;
  uint2* o = reinterpret_cast<uint2*>(entering) + (size_t)bh * chunks * V + e;
  uint2* o_lo = reinterpret_cast<uint2*>(entering_lo) + (size_t)bh * chunks * V + e;
  const int* up = rising + (size_t)bh * chunks;
  const float* a_last = acs + (size_t)bh * S + Q - 1;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  int pair = 0;  // from the row's first chunk where a_cs rises on
#pragma unroll 4
  for (int c = 0; c < chunks; ++c) {
    const float4 sc = s[(size_t)c * V];
    o[(size_t)c * V] = make_uint2(pack_bf16(h.x, h.y), pack_bf16(h.z, h.w));
    pair |= up[c];
    if (e == 0) pairs[(size_t)bh * chunks + c] = pair;
    if (pair) {
      uint2 hi, lo;
      split4(h, hi, lo);
      o_lo[(size_t)c * V] = lo;
    }
    const float d = expf(a_last[(size_t)c * Q]);
    h.x = __fadd_rn(__fmul_rn(h.x, d), sc.x);
    h.y = __fadd_rn(__fmul_rn(h.y, d), sc.y);
    h.z = __fadd_rn(__fmul_rn(h.z, d), sc.z);
    h.w = __fadd_rn(__fmul_rn(h.w, d), sc.w);
  }
  const int p = e / (NP / 4), n = 4 * (e % (NP / 4));
  if (p >= P) return;
  float* fs = final_state + ((size_t)bh * P + p) * N;
  const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (n + k < N) fs[n + k] = hv[k];
}

struct OutArgs {
  const bf16* x;
  const float* dt;
  const float* acs;
  const bf16* Bm;
  const bf16* Cm;
  const bf16* entering;
  const bf16* entering_lo;  // (entering's tensor map: rows from lo_row on)
  const int* pairs;         // (bh, chunk): W and H as bf16 pairs
  bf16* y;
  int S, P, N, nheads, Q, group, lo_row;
};

// bit i: W and the entering state as bf16 pairs for head bh0 + i of the
// group's ng in chunk c (a_cs has risen in it or an earlier chunk of the
// row), asked by lane i of a whole warp and broadcast from lane 0, so that
// the compiler sees a warp-uniform value (it is the block's): a branch around
// a wgmma it cannot prove uniform serialises every wgmma of the kernel
__device__ __forceinline__ unsigned pair_mask(const int* pairs, int bh0, int ng, int c,
                                              int chunks) {
  const int lane = threadIdx.x & 31;
  const unsigned m =
      __ballot_sync(0xffffffffu, lane < ng && pairs[(size_t)(bh0 + lane) * chunks + c]);
  return __shfl_sync(0xffffffffu, m, 0);
}

// W's bf16 operand for two neighbouring weights: hi = bf16(w), or with LO
// the pair's lo = bf16(w - hi)
template <bool LO>
__device__ __forceinline__ uint32_t pack_w(float v0, float v1) {
  if constexpr (LO) {
    uint32_t hi, lo;
    split_pair(v0, v1, hi, lo);
    return lo;
  } else {
    return pack_bf16(v0, v1);
  }
}

// the weight of key k for query q, G o L o dt; L is a select, never a
// multiply by a mask (exp overflows above the diagonal)
__device__ __forceinline__ float weight(float gv, int q, int k, float aq, float ak, float dk) {
  return q >= k ? __fmul_rn(__fmul_rn(gv, __expf(aq - ak)), dk) : 0.f;
}

// y's elements (q, p) and (q, p + 1) of a chunk, those inside it
__device__ __forceinline__ void store_pair(bf16* yc, int q, int p, float v0, float v1, int Q,
                                           int P) {
  if (q >= Q) return;
  bf16* row = yc + (size_t)q * P;
  if (p + 1 < P && P % 2 == 0) {
    *reinterpret_cast<uint32_t*>(row + p) = pack_bf16(v0, v1);
  } else {
    if (p < P) row[p] = __float2bfloat16_rn(v0);
    if (p + 1 < P) row[p + 1] = __float2bfloat16_rn(v1);
  }
}

// W's A fragments for key tile kt (keys 64 kt + 16 kk + 2 tig, +1, +8, +9)
// and this thread's query rows q0, q1 of query tile qt, hi or (LO) the
// pair's lo.  Below the diagonal (kt < qt) every q > k1 >= k, k1 = 64 kt +
// 63, and L = exp(a_q - a_k1) exp(a_k1 - a_k), each factor at most 1 where
// da <= 0 (the header note says what da > 0 gives): two exponentials a row
// and one a key (cks) for the tile, none an element.  On the diagonal tile
// (and the first warpgroup's tile above it, all zeros) L is the select of
// one exponential an element.
template <bool LO>
__device__ __forceinline__ void w_frags(uint32_t (&w)[4][4], const float (&G)[32], int kt,
                                        int qt, int q0, int q1, float a0, float a1,
                                        const float* acs, const float* dts, const float* cks,
                                        int tig) {
  if (kt < qt) {
    const float ak1 = acs[64 * kt + 63];
    const float r0 = expf(a0 - ak1), r1 = expf(a1 - ak1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 64 * kt + 16 * kk + 2 * tig;
      const float2 c = *reinterpret_cast<const float2*>(cks + k);
      const float2 c8 = *reinterpret_cast<const float2*>(cks + k + 8);
      const float* gv = &G[8 * kk];
      w[kk][0] = pack_w<LO>(__fmul_rn(__fmul_rn(gv[0], r0), c.x),
                            __fmul_rn(__fmul_rn(gv[1], r0), c.y));
      w[kk][1] = pack_w<LO>(__fmul_rn(__fmul_rn(gv[2], r1), c.x),
                            __fmul_rn(__fmul_rn(gv[3], r1), c.y));
      w[kk][2] = pack_w<LO>(__fmul_rn(__fmul_rn(gv[4], r0), c8.x),
                            __fmul_rn(__fmul_rn(gv[5], r0), c8.y));
      w[kk][3] = pack_w<LO>(__fmul_rn(__fmul_rn(gv[6], r1), c8.x),
                            __fmul_rn(__fmul_rn(gv[7], r1), c8.y));
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 64 * kt + 16 * kk + 2 * tig;
      const float2 ak = *reinterpret_cast<const float2*>(acs + k);
      const float2 ak8 = *reinterpret_cast<const float2*>(acs + k + 8);
      const float2 dk = *reinterpret_cast<const float2*>(dts + k);
      const float2 dk8 = *reinterpret_cast<const float2*>(dts + k + 8);
      const float* gv = &G[8 * kk];
      w[kk][0] = pack_w<LO>(weight(gv[0], q0, k, a0, ak.x, dk.x),
                            weight(gv[1], q0, k + 1, a0, ak.y, dk.y));
      w[kk][1] = pack_w<LO>(weight(gv[2], q1, k, a1, ak.x, dk.x),
                            weight(gv[3], q1, k + 1, a1, ak.y, dk.y));
      w[kk][2] = pack_w<LO>(weight(gv[4], q0, k + 8, a0, ak8.x, dk8.x),
                            weight(gv[5], q0, k + 9, a0, ak8.y, dk8.y));
      w[kk][3] = pack_w<LO>(weight(gv[6], q1, k + 8, a1, ak8.x, dk8.x),
                            weight(gv[7], q1, k + 9, a1, ak8.y, dk8.y));
    }
  }
}

// The chunk outputs of the group's heads, one after another through the ring,
// for this warpgroup's query tile.  PAIR: some head of the group takes W and
// H as bf16 pairs (bit i of pairs; a block-uniform branch chooses the
// instance, so the blocks where no head does run the code without them).
template <int NKT, bool TMA, bool PAIR>
__device__ __forceinline__ void heads(const float (&G)[NKT][32], const OutArgs& a,
                                      unsigned char* ring, unsigned char* sb, const float* sacs,
                                      const float* sdt, const float* sck, uint64_t* full,
                                      uint64_t* empty, uint32_t c_addr, uint32_t b_addr, int z,
                                      int c, int chunks, int bh0, int ng, int crow,
                                      unsigned pairs) {
  constexpr int KEYS = 64 * NKT;
  const int tid = threadIdx.x, wg = tid / WG;
  const int warp = (tid / 32) % 4, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int qt = 2 * z + wg;  // this warpgroup's query tile
  const int q0 = 64 * qt + warp * 16 + g, q1 = q0 + 8;  // this thread's rows
  for (int i = 0; i < ng; ++i) {
    const int s = TMA ? i % NST : 0;
    const bool pair = PAIR && ((pairs >> i) & 1);
    unsigned char* slot = ring + s * S3_SLOT;
    if constexpr (TMA) {
      mbar_wait(&full[s], (i / NST) & 1);
    } else {
      sync_threads(2 * WG);  // the previous head's readers of the slot are done
      stage_tile(slot, S3_X, KEYS, 1, a.x + ((size_t)(bh0 + i) * a.S + crow) * a.P, a.P, a.Q,
                 a.P, 2 * WG);
      stage_tile(slot + S3_X, TILE, 64, 2,
                 a.entering + ((size_t)(bh0 + i) * chunks + c) * (PP * NP), NP, PP, NP, 2 * WG);
      if (PAIR && pair)
        stage_tile(sb, TILE, 64, 2,
                   a.entering_lo + ((size_t)(bh0 + i) * chunks + c) * (PP * NP), NP, PP, NP,
                   2 * WG);
      fence_async_shared();
      sync_threads(2 * WG);
    }
    const uint32_t x_addr = smem_u32(slot), h_addr = x_addr + S3_X;
    const uint32_t lo_addr = b_addr + 2 * s * TILE;
    const float* acs = sacs + i * QMAX;
    const float* dts = sdt + i * QMAX;
    const float* cks = sck + i * QMAX;

    // y = (C H^T) * exp(a_cs[q]), H = hi (+ lo where the pair is taken)
    float y[32];
    zero(y);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_ss<0>(y, desc_kmajor<ROWB, 64>(c_addr, 0, kk), desc_kmajor<ROWB, 64>(h_addr, 0, kk),
                  1);
    if (PAIR && pair) {
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk)
        wgmma_ss<0>(y, desc_kmajor<ROWB, 64>(c_addr, 0, kk),
                    desc_kmajor<ROWB, 64>(lo_addr, 0, kk), 1);
    }
    wg_commit();
    wg_wait<0>();
    hold(y);
    const float a0 = acs[q0], a1 = acs[q1];
    const float e0 = expf(a0), e1 = expf(a1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[4 * j] = __fmul_rn(y[4 * j], e0);
      y[4 * j + 1] = __fmul_rn(y[4 * j + 1], e0);
      y[4 * j + 2] = __fmul_rn(y[4 * j + 2], e1);
      y[4 * j + 3] = __fmul_rn(y[4 * j + 3], e1);
    }

    // y += W x, key tile by key tile, W packed to bf16 as wgmma's A (w_frags);
    // where the pair is taken, a second pass adds W's lo parts
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
      uint32_t w[4][4];
      w_frags<false>(w, G[kt], kt, qt, q0, q1, a0, a1, acs, dts, cks, tig);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(y, w[kk], desc_mnmajor<ROWB, 64>(x_addr + kt * TILE, kk), 1);
      wg_commit();
      wg_wait<0>();
    }
    if (PAIR && pair) {
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        uint32_t w[4][4];
        w_frags<true>(w, G[kt], kt, qt, q0, q1, a0, a1, acs, dts, cks, tig);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(y, w[kk], desc_mnmajor<ROWB, 64>(x_addr + kt * TILE, kk), 1);
        wg_commit();
        wg_wait<0>();
      }
    }
    hold(y);
    if constexpr (TMA) {  // the slot is free for the producer
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    bf16* yc = a.y + ((size_t)(bh0 + i) * a.S + crow) * a.P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * tig;
      store_pair(yc, q0, p, y[4 * j], y[4 * j + 1], a.Q, a.P);
      store_pair(yc, q1, p, y[4 * j + 2], y[4 * j + 3], a.Q, a.P);
    }
  }
}

// Stage 3 for the query tiles 2 z and 2 z + 1 (one a consumer warpgroup) and
// the NKT = min(2 z + 2, ceil(Q / 64)) key tiles of 64 at or below the
// second's diagonal (the first warpgroup's last tile is wholly above its
// diagonal when NKT = 2 z + 2: its weights are zeros).
template <int NKT, bool TMA>
__device__ __forceinline__ void chunk_out(const CUtensorMap* tx, const CUtensorMap* tb,
                                          const CUtensorMap* tc, const CUtensorMap* th,
                                          const OutArgs& a, int z) {
  constexpr int KEYS = 64 * NKT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sc = align1024(smem_raw);  // warpgroup w's C tile at sc + 2 w TILE
  unsigned char* sb = sc + S3_C;
  unsigned char* ring = sb + S3_B;
  float* sacs = reinterpret_cast<float*>(ring + NST * S3_SLOT);  // [MAX_GROUP][QMAX]
  float* sdt = sacs + MAX_GROUP * QMAX;
  float* sck = sdt + MAX_GROUP * QMAX;  // exp(a_k1 - a_cs) * dt, k1 the key tile's last key
  uint64_t* cb = reinterpret_cast<uint64_t*>(sck + MAX_GROUP * QMAX);
  uint64_t* full = cb + 1;
  uint64_t* empty = full + NST;
  uint64_t* gdone = empty + NST;  // the consumers are done with the B tiles

  const int tid = threadIdx.x, wg = tid / WG;
  const int chunks = a.S / a.Q;
  const int b = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int h0 = blockIdx.y * a.group;
  const int ng = min(a.group, a.nheads - h0);
  const int bh0 = b * a.nheads + h0;
  const int crow = c * a.Q;  // the chunk's first row of S

  if (TMA && tid == 0) {
    mbar_init(cb, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG / 32);
    }
    mbar_init(gdone, 2 * WG / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if constexpr (TMA) {
      if (tid == 2 * WG) {
        unsigned pairs = 0;  // its loads in flight while C and B are issued
        for (int i = 0; i < ng; ++i) pairs |= (unsigned)a.pairs[(size_t)(bh0 + i) * chunks + c] << i;
        mbar_expect_tx(cb, (4 + 2 * NKT) * TILE);
        for (int w = 0; w < 2; ++w)
          for (int j = 0; j < 2; ++j)
            tma_load_3d(sc + (2 * w + j) * TILE, tc, cb, 64 * j, crow + 64 * (2 * z + w), b);
        for (int kt = 0; kt < NKT; ++kt)
          for (int j = 0; j < 2; ++j)
            tma_load_3d(sb + j * QMAX * ROWB + kt * TILE, tb, cb, 64 * j, crow + 64 * kt, b);
        bool b_free = false;
        for (int i = 0; i < ng; ++i) {
          const int s = i % NST;
          if (i >= NST) mbar_wait(&empty[s], ((i / NST) & 1) ^ 1);
          const int pair = (pairs >> i) & 1;
          unsigned char* slot = ring + s * S3_SLOT;
          mbar_expect_tx(&full[s], (NKT + 2 + 2 * pair) * TILE);
          for (int kt = 0; kt < NKT; ++kt)
            tma_load_3d(slot + kt * TILE, tx, &full[s], 0, crow + 64 * kt, bh0 + i);
          for (int j = 0; j < 2; ++j)
            tma_load_3d(slot + S3_X + j * TILE, th, &full[s], 64 * j, 0,
                        (bh0 + i) * chunks + c);
          if (pair) {  // H's lo into the B tiles' place, once G is done with them
            if (!b_free) mbar_wait(gdone, 0);
            b_free = true;
            for (int j = 0; j < 2; ++j)
              tma_load_3d(sb + (2 * s + j) * TILE, th, &full[s], 64 * j, 0,
                          a.lo_row + (bh0 + i) * chunks + c);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const unsigned pairs = pair_mask(a.pairs, bh0, ng, c, chunks);

  // a_cs, dt and exp(a_k1 - a_cs) * dt of the group's heads at the chunk's
  // first KEYS keys (zeros past Q)
  for (int i = tid; i < ng * KEYS; i += 2 * WG) {
    const int h = i / KEYS, k = i % KEYS;
    float av = 0.f, dv = 0.f, cv = 0.f;
    if (k < a.Q) {
      const size_t at = (size_t)(bh0 + h) * a.S + crow;
      av = a.acs[at + k];
      dv = a.dt[at + k];
      cv = __fmul_rn(expf(a.acs[at + min(k | 63, a.Q - 1)] - av), dv);
    }
    sacs[h * QMAX + k] = av;
    sdt[h * QMAX + k] = dv;
    sck[h * QMAX + k] = cv;
  }
  if constexpr (!TMA) {
    for (int w = 0; w < 2; ++w)
      stage_tile(sc + 2 * w * TILE, TILE, 64, 2,
                 a.Cm + ((size_t)b * a.S + crow + 64 * (2 * z + w)) * a.N, a.N,
                 a.Q - 64 * (2 * z + w), a.N, 2 * WG);
    stage_tile(sb, QMAX * ROWB, KEYS, 2, a.Bm + ((size_t)b * a.S + crow) * a.N, a.N, a.Q, a.N,
               2 * WG);
    fence_async_shared();
  }
  sync_threads(2 * WG);
  if constexpr (TMA) mbar_wait(cb, 0);

  const int lane = tid & 31;
  const uint32_t c_addr = smem_u32(sc) + 2 * wg * TILE, b_addr = smem_u32(sb);

  // G = C B^T for the group's heads: queries q0 (+8), keys 64 kt + 8 j + 2 tig (+1)
  float G[NKT][32];
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) zero(G[kt]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt)
      wgmma_ss<0>(G[kt], desc_kmajor<ROWB, 64>(c_addr, 0, kk),
                  desc_kmajor<ROWB, QMAX>(b_addr, 64 * kt, kk), 1);
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) hold(G[kt]);
  if constexpr (TMA) {  // the B tiles may take H's lo parts
    __syncwarp();
    if (lane == 0) mbar_arrive(gdone);
  }

  if (pairs)
    heads<NKT, TMA, true>(G, a, ring, sb, sacs, sdt, sck, full, empty, c_addr, b_addr, z, c,
                          chunks, bh0, ng, crow, pairs);
  else
    heads<NKT, TMA, false>(G, a, ring, sb, sacs, sdt, sck, full, empty, c_addr, b_addr, z, c,
                           chunks, bh0, ng, crow, 0);
}

// Stage 3.  Block (b * chunks + c, head group, pair of query tiles from the
// last): the chunk's outputs y for 128 query rows and a group of heads.
template <bool TMA>
__global__ void __launch_bounds__(S3_THREADS, 1)
ssd_chunk_out_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap th,
                     const OutArgs a) {
  // the pairs with the most keys go first
  const int z = gridDim.z - 1 - blockIdx.z;
  switch (min(2 * z + 2, (a.Q + 63) / 64)) {
    case 1: chunk_out<1, TMA>(&tx, &tb, &tc, &th, a, z); break;
    case 2: chunk_out<2, TMA>(&tx, &tb, &tc, &th, a, z); break;
    case 3: chunk_out<3, TMA>(&tx, &tb, &tc, &th, a, z); break;
    default: chunk_out<4, TMA>(&tx, &tb, &tc, &th, a, z); break;
  }
}

// the caller's plan: grid x, y, z, threads and dynamic shared memory of each
// kernel; false unless the threads and shared memory are the kernel's own
bool plan_grids(const int* plan, int n, const int (*own)[2], dim3* grids) {
  for (int i = 0; i < n; ++i) {
    const int* k = plan + 5 * i;
    if (k[0] < 1 || k[1] < 1 || k[2] < 1 || k[3] != own[i][0] || k[4] != own[i][1])
      return false;
    grids[i] = dim3(k[0], k[1], k[2]);
  }
  return true;
}

template <bool TMA>
int launch_bf16(const void* x, const void* dt, const void* da, const void* B, const void* C,
                void* y, void* state, void* acs, void* states, void* entering, void* rising,
                int BH, int S, int P, int N, int nheads, int Q, int group, const dim3* grids,
                cudaStream_t st) {
  const int chunks = S / Q, Bb = BH / nheads;
  const int lo_row = BH * chunks;  // entering's lo tiles follow its hi tiles
  bf16* entering_lo = static_cast<bf16*>(entering) + (size_t)lo_row * (PP * NP);
  int* pairs = static_cast<int*>(rising) + lo_row;  // stage 2's, after stage 1's flags
  CUtensorMap tx{}, tb{}, tc{}, th{};
  if (TMA) {
    int err = tensor_map_3d(&tx, x, P, S, BH, 64, 64);
    if (err == 0) err = tensor_map_3d(&tb, B, N, S, Bb, 64, 64);
    if (err == 0) err = tensor_map_3d(&tc, C, N, S, Bb, 64, 64);
    if (err == 0) err = tensor_map_3d(&th, entering, NP, PP, 2 * (uint64_t)lo_row, 64, 64);
    if (err != 0) return err;
  }
  const bf16* xb = static_cast<const bf16*>(x);
  ssd_chunk_state_kernel<TMA><<<grids[0], WG, S1_SMEM, st>>>(
      tx, tb, xb, static_cast<const float*>(dt), static_cast<const float*>(da),
      static_cast<const bf16*>(B), static_cast<float*>(acs), static_cast<float*>(states),
      static_cast<int*>(rising), S, P, N, nheads, Q);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_state_pass_kernel<<<grids[1], S2_THREADS, 0, st>>>(
      static_cast<const float*>(states), static_cast<const float*>(acs),
      static_cast<const int*>(rising), pairs, static_cast<bf16*>(entering), entering_lo,
      static_cast<float*>(state), BH, S, P, N, Q);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const OutArgs args{xb, static_cast<const float*>(dt), static_cast<const float*>(acs),
                     static_cast<const bf16*>(B), static_cast<const bf16*>(C),
                     static_cast<const bf16*>(entering), entering_lo,
                     pairs, static_cast<bf16*>(y),
                     S, P, N, nheads, Q, group, lo_row};
  ssd_chunk_out_kernel<TMA><<<grids[2], S3_THREADS, S3_SMEM, st>>>(tx, tb, tc, th, args);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int PT = 64;      // max head dim P
constexpr int NT = 128;     // max state dim N
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

// rows [k0, k0 + nk) of a (*, ld) matrix into a (rows, stride) float tile,
// columns < ncols; the rest of the tile is zero.  `scale`, when given, is a
// per-row factor (indexed by the tile row) applied after loading.
__device__ __forceinline__ void stage(float* __restrict__ dst, int rows, int cols, int stride,
                                      const float* __restrict__ src, int nk, int ncols, int ld,
                                      const float* __restrict__ scale) {
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int r = i / cols, c = i % cols;
    float v = 0.f;
    if (r < nk && c < ncols) {
      v = src[(size_t)r * ld + c];
      if (scale) v = __fmul_rn(v, scale[r]);
    }
    dst[r * stride + c] = v;
  }
}

// Design.  256 threads per block, as a 16 x 16 grid; every product is cut
// into 64 x 64 output tiles of which each thread owns 4 x 4 (the state
// update: 4 x 8), accumulated in registers from operands staged in shared
// memory.  The Q x Q weight block of a 256-token chunk would be 256 KB of
// float32, more than a block's 227 KB of shared memory, so query rows go in
// tiles of 64: per query tile, the C tile (64 x 128) stays staged while the
// key tiles at or below the diagonal stream through (B tile 64 x 128, x tile
// 64 x 64); their 64 x 64 weight tile goes through shared memory into the
// W x product.  Rows of the staged tiles are padded to 129 (65) floats so
// that the column walks of the products hit 16 distinct banks.  About 134 KB
// of shared memory: one block per SM, one block per (b, h).
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ da, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ st,
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
  const float* xb = x + (size_t)bh * S * P;
  const float* dtb = dt + (size_t)bh * S;
  const float* dab = da + (size_t)bh * S;
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  float* yb = y + (size_t)bh * S * P;

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
            if (p < P) yb[(size_t)(c0 + q0 + r) * P + p] = acc[i][j];
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

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// Fetch the tensor-map encoder and lift the dynamic shared-memory limit of
// every kernel on the current device.  Returns the CUDA error (0: done).
int ssd_init() {
  const int errs[6] = {load_encode_tiled(),
                       set_smem(ssd_scan_f32_kernel, SMEM_BYTES),
                       set_smem(ssd_chunk_state_kernel<true>, S1_SMEM),
                       set_smem(ssd_chunk_state_kernel<false>, S1_SMEM),
                       set_smem(ssd_chunk_out_kernel<true>, S3_SMEM),
                       set_smem(ssd_chunk_out_kernel<false>, S3_SMEM)};
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

// float32: one block per (b, h), the grid of the caller's plan (five ints:
// grid x, y, z, threads, shared memory).  Returns the CUDA error of the
// launch (0: launched); an invalid value for a plan that is not the kernel's.
int ssd_scan_f32_launch(const void* x, const void* dt, const void* da, const void* B,
                        const void* C, void* y, void* state, int BH, int S, int P, int N,
                        int nheads, int Q, const int* plan, void* stream) {
  const int own[1][2] = {{THREADS, SMEM_BYTES}};
  dim3 grid;
  if (P > PT || N > NT || Q > QMAX || Q <= 0 || S % Q || !plan_grids(plan, 1, own, &grid))
    return (int)cudaErrorInvalidValue;
  ssd_scan_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(da), static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(state), S, P, N, nheads, Q);
  return (int)cudaGetLastError();
}

// bfloat16: the three kernels, on the caller's temporaries acs (BH, S) float32,
// states (BH, S / Q, 64, 128) float32, entering (2, BH, S / Q, 64, 128)
// bfloat16 (hi, then lo) and rising (2, BH, S / Q) int32 (stage 1's flags,
// then stage 2's pairs); `group` heads a chunk-output block; tma != 0 when P % 8 == 0,
// N % 8 == 0 and x, B, C are 16-byte aligned; `plan`, five ints a kernel
// (grid x, y, z, threads, shared memory), the grids of the caller's plan
// (kernel.py ssd_plan).  Returns the CUDA error of the launches (0:
// launched); an invalid value for a plan whose threads or shared memory are
// not the kernels'.
int ssd_scan_bf16_launch(const void* x, const void* dt, const void* da, const void* B,
                         const void* C, void* y, void* state, void* acs, void* states,
                         void* entering, void* rising, int BH, int S, int P, int N,
                         int nheads, int Q, int group, int tma, const int* plan, void* stream) {
  const int own[3][2] = {{WG, S1_SMEM}, {S2_THREADS, 0}, {S3_THREADS, S3_SMEM}};
  dim3 grids[3];
  if (P > PP || N > NP || Q > QMAX || Q <= 0 || S % Q || group < 1 || group > MAX_GROUP ||
      !plan_grids(plan, 3, own, grids))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tma)
    return launch_bf16<true>(x, dt, da, B, C, y, state, acs, states, entering, rising, BH, S,
                             P, N, nheads, Q, group, grids, st);
  return launch_bf16<false>(x, dt, da, B, C, y, state, acs, states, entering, rising, BH, S,
                            P, N, nheads, Q, group, grids, st);
}

}  // extern "C"
