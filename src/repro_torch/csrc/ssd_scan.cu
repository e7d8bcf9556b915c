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
//
// Backward (bfloat16; the reference has none: JAX differentiates its plain
// chunked scan).  From y's cotangent dy and the final state's (or zero) it
// gives dx, ddt, dA, dB and dC.  Per chunk, with H the state entering it, D
// the cotangent of the state leaving it, G = C B^T, W = G o L o dt, dW = dy
// x^T and dS = dW o L o dt:
//   dx = W^T dy + s o (B D^T)                 s = exp(a_last - a_cs) * dt
//   dB = sum_h [dS^T C + s o (x D)]           dC = sum_h [dS B + exp(a_cs) o (dy H)]
//   D_{c-1} = D_c exp(a_last_c) + E_c         E_c = (dy o exp(a_cs))^T C
// and a_cs's cotangent: sum_k dW o W - sum_q dW o W (L's), exp(a_cs) sum_n C
// o (dy H) (y's carried part), -Z s with Z = sum_p x o (B D^T) (s's), and at
// the chunk's last position sum_k Z s and exp(a_last) sum(H o D); reversed
// through the cumsum it is da's, whence ddt = d(da) A + sum_q dW o G o L + Z
// exp(a_last - a_cs) and dA = sum d(da) dt.  What bounds it: at the training
// cell's call (B = 24, S = 2048, nh = 24, P = 64, N = 128, Q = 256) x, dy, dt,
// B, C in and dx, ddt, dB, dC out are 513 MB, 153 us at the HBM rate; the
// products it needs once (the causal halves of C B^T, dS B, dS^T C per batch
// row and of dy x^T, W^T dy per row, five Q x P x N products per row) are
// 1.4e11 FLOP, 142 us on the bf16 tensor cores: bytes bound it, barely.
// The design computes about six times those products (operands as pairs, G
// and dW taken again where a kernel needs them) and moves about 3 GB, most
// of it through L2: stage 2's float32 states, the key and query kernels'
// loads of each head's tiles.
//
// Five kernels a call (ssd_bwd_plan in kernel.py), none of them the forward's:
//   1. ssd_bwd_chunk_state_kernel, block (bh * chunks + c, 0 or 1), stage 1's
//      code (chunk_state): a_cs, the rising flags and S_c as the forward
//      takes them (bit for bit), and E_c, dy scaled by exp(a_cs) as the pair
//      hi + lo, against C read MN-major.
//   2. ssd_bwd_state_pass_kernel, four blocks a row bh, two float4s of the
//      state a thread: back from the last chunk D_c (float32; written as the
//      pair hi + lo for kernel 3), then forward over the chunks H_c, as stage
//      2 passes it (its bf16 hi, and lo from the row's first rising chunk on,
//      for kernel 4), and exp(a_last_c) sum(H_c o D_c) with D_c read back as
//      its pair, summed over each block in a fixed order (kernel 5 adds the
//      four blocks' parts in order).  H_c never goes to memory in float32.
//   3. ssd_bwd_keys_kernel, block (b * chunks + c, key tile kt), 64 keys and
//      every head of the batch row, the query tiles at or below the
//      diagonal; TMA and a 2-slot mbarrier ring of each head's x, dy and D,
//      issued by one thread once both warpgroups are done with the slot; the
//      next head's scalars (a_cs, dt, the pair flag) load while a head
//      computes.  x, dy and dx lie in the model's layout (B, S, nheads, P), so
//      the call makes no transposed copies (rows_map: boxes of one head).
//      Warpgroup 0: B D^T (keys x P, D as hi + lo), Z and dx = s o B D^T;
//      per query tile G^T = B C^T and dW^T = x dy^T (wgmma, K-major both),
//      W^T in registers as wgmma's A, dx += W^T dy (dy MN-major), the key's
//      sum_q dW o G o L.  Warpgroup 1: dB += s o (x D) (D MN-major, hi + lo),
//      then per query tile dW^T and dS^T as the pair hi + lo in registers,
//      dB += dS^T C (C MN-major); dB is summed over the heads in registers and
//      stored once.  Below the diagonal L = exp(a_q - a_k1) exp(a_k1 - a_k),
//      k1 the key tile's last key (one exponential a query, a head, in shared
//      memory, and one a key); on it L is a select before the exponential.
//   4. ssd_bwd_queries_kernel, block (b * chunks + c, query tile, the most
//      keys first), 64 queries and every head; the same ring of dy, x and H
//      (hi, and lo where the pair is taken).  Warpgroup w takes dC's columns
//      64 w ...: dy H (H MN-major), dC += exp(a_q) o dy H and its half of
//      sum_n C o dy H; per key tile dW = dy x^T, dS as the pair hi + lo, dC +=
//      dS B (B MN-major), issued with the next tile's products; warpgroup 0
//      also G = C B^T, W as the forward forms it and sum_k dW o W.  dC is
//      summed over the heads in registers and stored once.
//   5. ssd_bwd_dda_kernel, block bh * chunks + c, a position a thread: a_cs's
//      cotangent, its suffix sums (da's), ddt, and the chunk's part of dA;
//      kernel.py sums the parts over batch rows and chunks.
// Every sum runs in a fixed order (no atomics; the key and query blocks own
// their rows of dB and dC), so one input gives the same bits on every run.
// A wgmma's branch turns on the warpgroup index and the pair flag broadcast
// from lane 0, which ptxas sees as warp-uniform.  The key and query kernels
// avoid two slow forms: shared memory addressed through a pointer rounded as
// an integer (align1024) is read generically (LD, not LDS; shared_align1024
// keeps the address space), and a select around __expf can compile to a
// branch that diverges within the warp on the diagonal tile (exp_where runs
// the exponential on every lane).  Temporaries at the cell:
// states and E_c (float32) 302 MB, H and D (bf16 hi, lo) 151 MB, and 14 MB
// of per-position sums.
//
// Rounding points of the backward.  Products of bf16 operands go to the
// tensor cores as they are: G, dW, B D^T's and x D's B, dy H's dy, C and B
// against dS.  Rounded operands, each at most as the forward rounds its
// counterpart: W to bf16 (the pair hi + lo in a chunk where a_cs has risen);
// H to bf16 (a pair there too); dy * exp(a_cs), like x * s, to the pair hi +
// lo.  Float32 intermediates the forward never rounds go as pairs: D (B D^T,
// x D) and dS (dS^T C, dS B).  The recurrence of D, Z, the L, dW o W and dW
// o G o L sums, a_cs's cotangent and its suffix sums stay float32; dx, dB and
// dC are rounded once to bf16.

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

// offset of row bh = b nheads + h, position s, of a (B, S, nheads, P) tensor
__device__ __forceinline__ size_t row_base(int bh, int s, int S, int P, int nheads) {
  return (((size_t)(bh / nheads) * S + s) * nheads + bh % nheads) * P;
}

// v = hi + lo to about 16 bits, for two neighbouring values of a fragment
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(v0, __low2float(h)), __fsub_rn(v1, __high2float(h)));
}

// A chunk's state product, out = (v * s)^T M with s a scale per key: block
// bh * chunks + c (one warpgroup) of stage 1, and of the backward's first
// stage.  COT = false: v = x, M = B and s = exp(a_last - a_cs) * dt, the
// chunk's state S_c; it writes a_cs and whether it rises.  COT = true: v =
// dy, M = C and s = exp(a_cs), the cotangent y sends into the state entering
// the chunk (csrc header note, backward).  TMA: v and M arrive by TMA while
// the threads take the cumsum; else the threads stage them element by
// element.  v~ = v * s is formed in registers as wgmma's A fragments, a bf16
// pair hi + lo; M is read MN-major as it lies.  ROWS: v lies in the model's
// layout (B, S, nheads, P) (rows_map), else (BH, S, P).  sx: the block's
// shared memory at a 1024-byte boundary.
template <bool TMA, bool COT, bool ROWS = false>
__device__ __forceinline__ void chunk_state(unsigned char* sx, const CUtensorMap* tx,
                                            const CUtensorMap* tb,
                                            const bf16* __restrict__ x,
                                            const float* __restrict__ dt,
                                            const float* __restrict__ da,
                                            const bf16* __restrict__ Bm,
                                            float* __restrict__ acs_out,
                                            float* __restrict__ states,
                                            int* __restrict__ rising, int S, int P, int N,
                                            int nheads, int Q) {
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
      if (ROWS)
        tma_load_3d(sx + kt * TILE, tx, bar, 0, bh % nheads, (bh / nheads) * S + c * Q + 64 * kt);
      else
        tma_load_3d(sx + kt * TILE, tx, bar, 0, c * Q + 64 * kt, bh);
      for (int j = 0; j < 2; ++j)
        tma_load_3d(sb + j * QMAX * ROWB + kt * TILE, tb, bar, 64 * j, c * Q + 64 * kt,
                    bh / nheads);
    }
  }

  const int up = chunk_cumsum(da + row0, Q, sacs, ws);
  __syncthreads();
  if (!COT && tid == 0) rising[blockIdx.x] = up;
  const float a_last = sacs[Q - 1];
  for (int k = tid; k < QMAX; k += WG) {
    float s = 0.f;  // zero past the chunk: those rows of the tiles are the next chunk's
    if (k < Q) {
      if constexpr (COT) {
        s = expf(sacs[k]);
      } else {
        s = __fmul_rn(expf(a_last - sacs[k]), dt[row0 + k]);
        acs_out[row0 + k] = sacs[k];
      }
    }
    sscale[k] = s;
  }
  if constexpr (TMA) {
    __syncthreads();
    mbar_wait(bar, 0);
  } else {
    if (ROWS)
      stage_tile(sx, S1_X, 64 * KT, 1, x + row_base(bh, c * Q, S, P, nheads), nheads * P, Q, P, WG);
    else
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

// Stage 1.  Block bh * chunks + c: a_cs of the chunk, and its state
// S_c = x^T (B * s) = (x * s)^T B with s = exp(a_last - a_cs) * dt
// (chunk_state).
template <bool TMA>
__global__ void __launch_bounds__(WG, 2)
ssd_chunk_state_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
                       const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ da, const bf16* __restrict__ Bm,
                       float* __restrict__ acs_out, float* __restrict__ states,
                       int* __restrict__ rising, int S, int P, int N, int nheads, int Q) {
  extern __shared__ unsigned char smem_raw[];
  chunk_state<TMA, false>(align1024(smem_raw), &tx, &tb, x, dt, da, Bm, acs_out, states, rising,
                          S, P, N, nheads, Q);
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
// bfloat16 backward: chunk states and cotangents, the reverse state pass,
// the keys and the queries of each chunk, the cumsum's reverse
// ---------------------------------------------------------------------------

constexpr int BW_THREADS = 2 * WG;  // the key and query kernels: two warpgroups
constexpr int BP_THREADS = 256;     // the reverse state pass: a quarter row a block
constexpr int BP_SPLIT = 4;         // blocks of a row
constexpr int BA_THREADS = 256;     // the cumsum's reverse: a chunk a block
// keys: B (one key tile, two chunks), C (QMAX queries, two chunks) and NST
// slots of x (the key tile), dy (QMAX queries) and D (hi and lo, two chunks
// each); the head's exp(a_q - a_k1) and a_cs of the diagonal tile's
// queries; three mbarriers
constexpr int BK_B = 2 * TILE;
constexpr int BK_C = 2 * QMAX * ROWB;
constexpr int BW_SLOT = TILE + QMAX * ROWB + 4 * TILE;
constexpr int BK_SMEM = 1024 + BK_B + BK_C + NST * BW_SLOT + QMAX * 4 + 64 * 4 + 24;
// queries: C (one query tile, two chunks), B (QMAX keys, two chunks) and NST
// slots of dy (the query tile), x (QMAX keys) and H (hi and lo); the head's
// exp(a_k1 - a_k) * dt, warpgroup 1's half of y's share of d a_cs, a_cs and dt
// of the diagonal tile's keys, a_k1 of the key tiles; three mbarriers
constexpr int BQ_SMEM = 1024 + BK_B + BK_C + NST * BW_SLOT + QMAX * 4 + 64 * 4 + 2 * 64 * 4 +
                        4 * 4 + 24;
static_assert(BK_SMEM <= 232448 && BQ_SMEM <= 232448, "shared memory of a block");
static_assert(QMAX == BW_THREADS, "a thread a query of the key kernel's exp(a_q - a_k1)");

// the first 1024-byte boundary at or after p, a pointer into p's shared
// memory: arithmetic on the pointer itself, so that the compiler keeps its
// address space and reads and writes it as shared memory, not generically
__device__ __forceinline__ unsigned char* shared_align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Backward stage 1.  Block (bh * chunks + c, 0): a_cs, the rising flag and
// the chunk state S_c, as stage 1; block (bh * chunks + c, 1): E_c = (dy *
// exp(a_cs))^T C, the cotangent that y sends into the state entering the chunk.
// x and dy lie in the model's layout (B, S, nheads, P).
template <bool TMA>
__global__ void __launch_bounds__(WG, 2)
ssd_bwd_chunk_state_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tdy,
                           const __grid_constant__ CUtensorMap tb,
                           const __grid_constant__ CUtensorMap tc, const bf16* __restrict__ x,
                           const bf16* __restrict__ dy, const float* __restrict__ dt,
                           const float* __restrict__ da, const bf16* __restrict__ Bm,
                           const bf16* __restrict__ Cm, float* __restrict__ acs_out,
                           float* __restrict__ states, float* __restrict__ cot,
                           int* __restrict__ rising, int S, int P, int N, int nheads, int Q) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sx = shared_align1024(smem_raw);
  if (blockIdx.y == 0)
    chunk_state<TMA, false, true>(sx, &tx, &tb, x, dt, da, Bm, acs_out, states, rising, S, P, N,
                                  nheads, Q);
  else
    chunk_state<TMA, true, true>(sx, &tdy, &tc, dy, dt, da, Cm, acs_out, cot, rising, S, P, N,
                                 nheads, Q);
}

// exp(v) where in, else 0, with no branch: the argument is selected before
// the exponential (so that it is finite) and the result after it, and the
// exponential (__expf's) runs on every lane: a branch around it would
// diverge within the warp
__device__ __forceinline__ float exp_where(bool in, float v) {
  float e;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(in ? v * 1.4426950408889634f : 0.f));
  return in ? e : 0.f;
}

// the first and second bf16 of a packed pair, as float32
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// the block's sum of v, in a fixed order (ws: 8 floats of shared memory)
__device__ __forceinline__ float block_sum(float v, float* ws) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // the previous sum's readers are done
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += ws[w];
  return t;
}

// Backward stage 2.  Block (bh, quarter j), two float4s of the (64, 128)
// state a thread.  Back from the last chunk: D_c, the cotangent of the state
// leaving chunk c (D_last = the final state's cotangent, or zero; D_{c-1} =
// D_c exp(a_last_c) + E_c, float32), as the bf16 pair hi + lo that the key
// kernel takes.  Then forward over the chunks: H_c entering each chunk, as
// stage 2 passes it (bf16 hi, and lo from the row's first rising chunk on,
// for the query kernel), and the quarter's part of a_last's share
// exp(a_last_c) sum(H_c o D_c), D_c read back as its pair.
__global__ void __launch_bounds__(BP_THREADS)
ssd_bwd_state_pass_kernel(const float* __restrict__ states, const float* __restrict__ cot,
                          const float* __restrict__ acs, const int* __restrict__ rising,
                          int* __restrict__ pairs, const float* __restrict__ dstate,
                          bf16* __restrict__ rows4, float* __restrict__ dlast, int BH, int S,
                          int P, int N, int Q) {
  constexpr int V = PP * NP / 4;  // float4s of a state
  constexpr int E = V / (BP_THREADS * BP_SPLIT);
  __shared__ float ws[BP_THREADS / 32];
  const int chunks = S / Q, bh = blockIdx.x, t = threadIdx.x + blockIdx.y * (V / BP_SPLIT);
  const size_t lo_row = (size_t)BH * chunks;  // rows4: H hi, H lo, D hi, D lo
  const float4* st = reinterpret_cast<const float4*>(states) + (size_t)bh * chunks * V;
  const float4* ct = reinterpret_cast<const float4*>(cot) + (size_t)bh * chunks * V;
  uint2* out = reinterpret_cast<uint2*>(rows4) + (size_t)bh * chunks * V;
  const float* a_last = acs + (size_t)bh * S + Q - 1;
  float4 g[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = t + j * BP_THREADS, p = e / (NP / 4), n = 4 * (e % (NP / 4));
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (dstate != nullptr && p < P)
      for (int k = 0; k < 4; ++k)
        if (n + k < N) v[k] = dstate[((size_t)bh * P + p) * N + n + k];
    g[j] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int c = chunks - 1; c >= 0; --c) {
    const float d = expf(a_last[(size_t)c * Q]);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const size_t i = (size_t)c * V + t + j * BP_THREADS;
      uint2 hi, lo;
      split4(g[j], hi, lo);
      out[2 * lo_row * V + i] = hi;
      out[3 * lo_row * V + i] = lo;
      const float4 e = ct[i];
      g[j].x = __fadd_rn(__fmul_rn(g[j].x, d), e.x);
      g[j].y = __fadd_rn(__fmul_rn(g[j].y, d), e.y);
      g[j].z = __fadd_rn(__fmul_rn(g[j].z, d), e.z);
      g[j].w = __fadd_rn(__fmul_rn(g[j].w, d), e.w);
    }
  }
  float4 h[E];
#pragma unroll
  for (int j = 0; j < E; ++j) h[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  int pair = 0;
  for (int c = 0; c < chunks; ++c) {
    pair |= rising[(size_t)bh * chunks + c];
    if (t == 0) pairs[(size_t)bh * chunks + c] = pair;  // the row's first thread
    const float d = expf(a_last[(size_t)c * Q]);
    float hd = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const size_t i = (size_t)c * V + t + j * BP_THREADS;
      const float4 sc = st[i];
      const uint2 dh = out[2 * lo_row * V + i], dl = out[3 * lo_row * V + i];
      uint2 hi, lo;
      split4(h[j], hi, lo);
      out[i] = hi;
      if (pair) out[lo_row * V + i] = lo;
      const float dv[4] = {bf_lo(dh.x) + bf_lo(dl.x), bf_hi(dh.x) + bf_hi(dl.x),
                           bf_lo(dh.y) + bf_lo(dl.y), bf_hi(dh.y) + bf_hi(dl.y)};
      hd = fmaf(h[j].x, dv[0], hd);
      hd = fmaf(h[j].y, dv[1], hd);
      hd = fmaf(h[j].z, dv[2], hd);
      hd = fmaf(h[j].w, dv[3], hd);
      h[j].x = __fadd_rn(__fmul_rn(h[j].x, d), sc.x);
      h[j].y = __fadd_rn(__fmul_rn(h[j].y, d), sc.y);
      h[j].z = __fadd_rn(__fmul_rn(h[j].z, d), sc.z);
      h[j].w = __fadd_rn(__fmul_rn(h[j].w, d), sc.w);
    }
    hd = block_sum(hd, ws);
    if (threadIdx.x == 0)
      dlast[((size_t)bh * chunks + c) * BP_SPLIT + blockIdx.y] = __fmul_rn(d, hd);
  }
}

struct BwdArgs {
  const bf16* x;
  const bf16* dy;
  const float* dt;
  const float* acs;
  const bf16* Bm;
  const bf16* Cm;
  const bf16* rows4;  // (4, BH, chunks, 64, 128): H hi, H lo, D hi, D lo
  const int* pairs;   // (bh, chunk): W and H as bf16 pairs (stage 2's)
  bf16* dx;
  bf16* dB;
  bf16* dC;
  float* Z;     // per key: sum_p x o (B D^T), s's cotangent
  float* colT;  // per key: sum_q dW o G o L, dt's through W
  float* dq;    // per query: sum_k dW o W + exp(a_q) sum_n C o (dy H)
  int S, P, N, nheads, Q, lo_row;
};

// v0 + v1 over the four lanes of a quad (one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// two neighbouring values (r, col), (r, col + 1) of a row-major bf16 matrix
// of leading dimension ld, those inside rows < nr and columns < nc
__device__ __forceinline__ void store2(bf16* out, int ld, int r, int col, float v0, float v1,
                                       int nr, int nc) {
  if (r >= nr) return;
  bf16* row = out + (size_t)r * ld;
  if (col + 1 < nc && reinterpret_cast<uintptr_t>(row + col) % 4 == 0) {
    *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(v0, v1);
  } else {
    if (col < nc) row[col] = __float2bfloat16_rn(v0);
    if (col + 1 < nc) row[col + 1] = __float2bfloat16_rn(v1);
  }
}

// a 64-row accumulator's rows r, r + 8 and columns 8 j + 2 tig (+1) as bf16
template <int R>
__device__ __forceinline__ void store_acc(bf16* out, int ld, const float (&d)[R], int r, int tig,
                                          int nr, int nc) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = 8 * j + 2 * tig;
    store2(out, ld, r, col, d[4 * j], d[4 * j + 1], nr, nc);
    store2(out, ld, r + 8, col, d[4 * j + 2], d[4 * j + 3], nr, nc);
  }
}

// Backward keys.  Block (b * chunks + c, key tile kt): for the 64 keys of the
// tile and every head of the batch row, the query tiles kt ... QT - 1 (those
// at or past the diagonal).  Warpgroup 0: G^T = B C^T and dW^T = x dy^T, dx
// = s o (B D^T) + W^T dy, Z and the key's sum_q dW o G o L; warpgroup 1: dW^T
// again, dS = dW o L o dt and dB = sum_h s o (x D) + dS^T C.
template <bool TMA>
__global__ void __launch_bounds__(BW_THREADS, 1)
ssd_bwd_keys_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                    const __grid_constant__ CUtensorMap tr, const BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sb = shared_align1024(smem_raw);  // key tile: chunk j at j TILE
  unsigned char* sc = sb + BK_B;                   // queries: chunk j at j QMAX ROWB
  unsigned char* ring = sc + BK_C;
  float* sq = reinterpret_cast<float*>(ring + NST * BW_SLOT);  // exp(a_q - a_k1)
  float* sdq = sq + QMAX;  // a_cs of the diagonal tile's queries
  uint64_t* cb = reinterpret_cast<uint64_t*>(sdq + 64);
  uint64_t* full = cb + 1;

  // the warpgroup, broadcast from lane 0 so that ptxas sees a warp-uniform
  // value: a branch around a wgmma it cannot prove uniform serialises them all
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int chunks = a.S / a.Q, QT = (a.Q + 63) / 64;
  const int b = blockIdx.x / chunks, c = blockIdx.x % chunks, kt = blockIdx.y;
  const int crow = c * a.Q, k0 = 64 * kt;
  const int bh0 = b * a.nheads;
  const int ld = a.nheads * a.P;  // x, dy and dx: (B, S, nheads, P)

  if (TMA && tid == 0) {
    mbar_init(cb, 1);
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(cb, (2 + 2 * (QT - kt)) * TILE);
    for (int j = 0; j < 2; ++j) {
      tma_load_3d(sb + j * TILE, &tb, cb, 64 * j, crow + k0, b);
      for (int qt = kt; qt < QT; ++qt)
        tma_load_3d(sc + j * QMAX * ROWB + qt * TILE, &tc, cb, 64 * j, crow + 64 * qt, b);
    }
  }
  // one thread issues a head's x, dy and D (hi and lo)
  auto issue = [&](int i) {
    const int s = i % NST, bh = bh0 + i;
    unsigned char* slot = ring + s * BW_SLOT;
    mbar_expect_tx(&full[s], (1 + (QT - kt) + 4) * TILE);
    tma_load_3d(slot, &tx, &full[s], 0, i, b * a.S + crow + k0);
    for (int qt = kt; qt < QT; ++qt)
      tma_load_3d(slot + TILE + qt * TILE, &tdy, &full[s], 0, i, b * a.S + crow + 64 * qt);
    for (int j = 0; j < 4; ++j)
      tma_load_3d(slot + TILE + QMAX * ROWB + j * TILE, &tr, &full[s], 64 * (j & 1), 0,
                  (2 + j / 2) * a.lo_row + bh * chunks + c);
  };
  if (TMA && tid == 0)
    for (int i = 0; i < NST && i < a.nheads; ++i) issue(i);
  __syncthreads();
  if constexpr (TMA) {
    mbar_wait(cb, 0);
  } else {
    stage_tile(sb, TILE, 64, 2, a.Bm + ((size_t)b * a.S + crow + k0) * a.N, a.N, a.Q - k0, a.N,
               BW_THREADS);
    stage_tile(sc, QMAX * ROWB, 64 * QT, 2, a.Cm + ((size_t)b * a.S + crow) * a.N, a.N, a.Q, a.N,
               BW_THREADS);
  }

  const int warp = (tid / 32) % 4, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows r0, r0 + 8 of the key tile
  const uint32_t b_addr = smem_u32(sb), c_addr = smem_u32(sc);
  const int k1 = min(k0 + 63, a.Q - 1);  // the tile's last key
  float dB[64];  // warpgroup 1: the batch row's dB over the heads
  zero(dB);

  // a head's scalars, loaded a head ahead so that their latency hides behind
  // the previous head's work: a_k1, a_last, this thread's query (tid) of sq
  // and (tid < 64) of the diagonal tile, its key rows' a_cs and dt, and the
  // pair flag
  float nk1 = 0.f, nlast = 0.f, naq = 0.f, ndq = 0.f, nar[2] = {0.f, 0.f}, ndr[2] = {0.f, 0.f};
  int npair = 0;
  auto fetch = [&](int bh) {
    const size_t at = (size_t)bh * a.S + crow;
    nk1 = a.acs[at + k1];
    nlast = a.acs[at + a.Q - 1];
    naq = tid < a.Q ? a.acs[at + tid] : 0.f;
    ndq = tid < 64 && k0 + tid < a.Q ? a.acs[at + k0 + tid] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + r0 + 8 * h;
      nar[h] = k < a.Q ? a.acs[at + k] : 0.f;
      ndr[h] = k < a.Q ? a.dt[at + k] : 0.f;
    }
    npair = a.pairs[(size_t)bh * chunks + c];
  };
  fetch(bh0);

  for (int i = 0; i < a.nheads; ++i) {
    const int s = TMA ? i % NST : 0;
    const int bh = bh0 + i;
    unsigned char* slot = ring + s * BW_SLOT;
    const float ak1 = nk1, a_last = nlast;
    const float ar[2] = {nar[0], nar[1]}, dr[2] = {ndr[0], ndr[1]};
    sq[tid] = tid < a.Q ? expf(naq - ak1) : 0.f;  // QMAX == BW_THREADS queries
    if (tid < 64) sdq[tid] = ndq;
    // broadcast from lane 0: ptxas sees a warp-uniform flag (a branch around
    // a wgmma that it cannot prove uniform serialises every wgmma)
    const int pair = __shfl_sync(0xffffffffu, npair, 0);
    if (i + 1 < a.nheads) fetch(bh + 1);
    if constexpr (!TMA) {
      stage_tile(slot, TILE, 64, 1, a.x + row_base(bh, crow + k0, a.S, a.P, a.nheads), ld,
                 a.Q - k0, a.P, BW_THREADS);
      stage_tile(slot + TILE, QMAX * ROWB, 64 * QT, 1, a.dy + row_base(bh, crow, a.S, a.P, a.nheads),
                 ld, a.Q, a.P, BW_THREADS);
      for (int j = 0; j < 2; ++j)  // D hi, D lo
        stage_tile(slot + TILE + QMAX * ROWB + 2 * j * TILE, TILE, 64, 2,
                   a.rows4 + ((size_t)(2 + j) * a.lo_row + (size_t)bh * chunks + c) * (PP * NP),
                   NP, PP, NP, BW_THREADS);
      fence_async_shared();
    }
    __syncthreads();
    if constexpr (TMA) mbar_wait(&full[s], (i / NST) & 1);
    const uint32_t x_addr = smem_u32(slot), dy_addr = x_addr + TILE;
    const uint32_t dh_addr = dy_addr + QMAX * ROWB, dl_addr = dh_addr + 2 * TILE;

    // the rows' s = exp(a_last - a_cs) * dt and exp(a_k1 - a_cs)
    float sr[2], rk[2], rkd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = k0 + r0 + 8 * h < a.Q;
      sr[h] = in ? __fmul_rn(expf(a_last - ar[h]), dr[h]) : 0.f;
      rk[h] = in ? expf(ak1 - ar[h]) : 0.f;
      rkd[h] = __fmul_rn(rk[h], dr[h]);
    }

    if (wg == 0) {
      // B D^T (keys x P) with D as hi + lo; Z = sum_p x o B D^T; dx = s o B D^T
      float dx[32];
      zero(dx);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
        wgmma_ss<0>(dx, desc_kmajor<ROWB, 64>(b_addr, 0, kk), desc_kmajor<ROWB, 64>(dh_addr, 0, kk), 1);
        wgmma_ss<0>(dx, desc_kmajor<ROWB, 64>(b_addr, 0, kk), desc_kmajor<ROWB, 64>(dl_addr, 0, kk), 1);
      }
      wg_commit();
      wg_wait<0>();
      hold(dx);
      float z[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = dx[4 * j + 2 * h + e];
            const float xv = __bfloat162float(
                *reinterpret_cast<const bf16*>(slot + swz(r0 + 8 * h, 8 * j + 2 * tig + e)));
            z[h] = fmaf(xv, v, z[h]);
            v = __fmul_rn(v, sr[h]);
          }
      float ct[2] = {0.f, 0.f};
      for (int qt = kt; qt < QT; ++qt) {
        float gt[32], dw[32];
        zero(gt);
        zero(dw);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk)
          wgmma_ss<0>(gt, desc_kmajor<ROWB, 64>(b_addr, 0, kk),
                      desc_kmajor<ROWB, QMAX>(c_addr, 64 * qt, kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(dw, desc_kmajor<ROWB, 64>(x_addr, 0, kk),
                      desc_kmajor<ROWB, QMAX>(dy_addr, 64 * qt, kk), 1);
        wg_commit();
        wg_wait<0>();
        hold(gt);
        hold(dw);
        // W^T = G^T o L^T o dt_k (rounded as the forward rounds W) and the
        // column sums of dW o G o L
        float w[32];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 4 * j + 2 * h + e, q = 64 * qt + 8 * j + 2 * tig + e;
              const int k = k0 + r0 + 8 * h;
              float lq, m1, m2;
              if (qt > kt) {  // every q > k: L = exp(a_q - a_k1) exp(a_k1 - a_k)
                lq = sq[q];
                m1 = rkd[h];
                m2 = rk[h];
              } else {
                lq = exp_where(q >= k && q < a.Q, sdq[q - k0] - ar[h]);
                m1 = dr[h];
                m2 = 1.f;
              }
              w[idx] = __fmul_rn(__fmul_rn(gt[idx], lq), m1);
              const float u = __fmul_rn(dw[idx], lq);
              ct[h] = fmaf(__fmul_rn(u, gt[idx]), m2, ct[h]);
            }
        uint32_t wh[4][4], wl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            split_pair(w[8 * kk + 2 * f], w[8 * kk + 2 * f + 1], wh[kk][f], wl[kk][f]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(dx, wh[kk], desc_mnmajor<ROWB, QMAX>(dy_addr, 4 * qt + kk), 1);
        if (pair) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<1>(dx, wl[kk], desc_mnmajor<ROWB, QMAX>(dy_addr, 4 * qt + kk), 1);
        }
        wg_commit();
        wg_wait<0>();
        hold(dx);
      }
      const size_t row = (size_t)bh * a.S + crow + k0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float zs = quad_sum(z[h]), cs = quad_sum(ct[h]);
        if (tig == 0 && k0 + r0 + 8 * h < a.Q) {
          a.Z[row + r0 + 8 * h] = zs;
          a.colT[row + r0 + 8 * h] = cs;
        }
      }
      store_acc(a.dx + row_base(bh, crow + k0, a.S, a.P, a.nheads), ld, dx, r0, tig, a.Q - k0,
                a.P);
    } else {
      // sum_h s o (x D), D as hi + lo (keys x N)
      float xd[64];
      zero(xd);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss<1>(xd, desc_kmajor<ROWB, 64>(x_addr, 0, kk), desc_mnmajor<ROWB, 64>(dh_addr, kk), 1);
        wgmma_ss<1>(xd, desc_kmajor<ROWB, 64>(x_addr, 0, kk), desc_mnmajor<ROWB, 64>(dl_addr, kk), 1);
      }
      wg_commit();
      wg_wait<0>();
      hold(xd);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dB[4 * j] = fmaf(sr[0], xd[4 * j], dB[4 * j]);
        dB[4 * j + 1] = fmaf(sr[0], xd[4 * j + 1], dB[4 * j + 1]);
        dB[4 * j + 2] = fmaf(sr[1], xd[4 * j + 2], dB[4 * j + 2]);
        dB[4 * j + 3] = fmaf(sr[1], xd[4 * j + 3], dB[4 * j + 3]);
      }
      for (int qt = kt; qt < QT; ++qt) {
        float dw[32];
        zero(dw);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(dw, desc_kmajor<ROWB, 64>(x_addr, 0, kk),
                      desc_kmajor<ROWB, QMAX>(dy_addr, 64 * qt, kk), 1);
        wg_commit();
        wg_wait<0>();
        hold(dw);
        // dS^T = dW^T o L^T o dt_k as a bf16 pair
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 8 * kk + 2 * f + e;
              const int j = idx / 4, h = (idx / 2) & 1;
              const int q = 64 * qt + 8 * j + 2 * tig + e, k = k0 + r0 + 8 * h;
              float lq, m1;
              if (qt > kt) {
                lq = sq[q];
                m1 = rkd[h];
              } else {
                lq = exp_where(q >= k && q < a.Q, sdq[q - k0] - ar[h]);
                m1 = dr[h];
              }
              v[e] = __fmul_rn(__fmul_rn(dw[idx], lq), m1);
            }
            split_pair(v[0], v[1], hi[kk][f], lo[kk][f]);
          }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<1>(dB, hi[kk], desc_mnmajor<ROWB, QMAX>(c_addr, 4 * qt + kk), 1);
          wgmma_rs<1>(dB, lo[kk], desc_mnmajor<ROWB, QMAX>(c_addr, 4 * qt + kk), 1);
        }
        wg_commit();
        wg_wait<0>();
        hold(dB);
      }
    }
    __syncthreads();  // both warpgroups are done with the slot and sq
    if (TMA && tid == 0 && i + NST < a.nheads) issue(i + NST);
  }
  if (wg == 1) store_acc(a.dB + ((size_t)b * a.S + crow + k0) * a.N, a.N, dB, r0, tig, a.Q - k0, a.N);
}

// Backward queries.  Block (b * chunks + c, query tile from the last): for the
// 64 queries of the tile and every head of the batch row, the key tiles at
// or below the diagonal.  Warpgroup w takes dC's columns [64 w, 64 w + 64):
// dC = sum_h exp(a_q) (dy H) + dS B, H as the forward's stage 3 takes it
// (bf16, or hi + lo where the pair is taken) and dS = dW o L o dt as a bf16
// pair, dW = dy x^T; per query exp(a_q) sum_n C o (dy H), the two halves
// summed by warpgroup 0, which also takes G = C B^T, W and sum_k dW o W.
template <bool TMA>
__global__ void __launch_bounds__(BW_THREADS, 1)
ssd_bwd_queries_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tdy,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tc,
                       const __grid_constant__ CUtensorMap tr, const BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sc = shared_align1024(smem_raw);  // query tile: chunk j at j TILE
  unsigned char* sb = sc + BK_B;                   // keys: chunk j at j QMAX ROWB
  unsigned char* ring = sb + BK_C;
  float* sck = reinterpret_cast<float*>(ring + NST * BW_SLOT);  // exp(a_k1 - a_k) * dt
  float* sy = sck + QMAX;  // warpgroup 1's half of sum_n C o (dy H)
  float* sdk = sy + 64;    // [2][64]: a_cs and dt of the diagonal tile's keys
  float* sak1 = sdk + 2 * 64;  // a_k1 of the key tiles below the diagonal
  uint64_t* cb = reinterpret_cast<uint64_t*>(sak1 + 4);
  uint64_t* full = cb + 1;

  // the warpgroup, broadcast from lane 0 so that ptxas sees a warp-uniform
  // value: a branch around a wgmma it cannot prove uniform serialises them all
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int chunks = a.S / a.Q, QT = (a.Q + 63) / 64;
  const int b = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int qt = QT - 1 - blockIdx.y, nk = qt + 1;  // the tiles with the most keys first
  const int crow = c * a.Q, q0 = 64 * qt;
  const int bh0 = b * a.nheads;
  const int ld = a.nheads * a.P;  // x, dy and dx: (B, S, nheads, P)

  if (TMA && tid == 0) {
    mbar_init(cb, 1);
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(cb, (2 + 2 * nk) * TILE);
    for (int j = 0; j < 2; ++j) {
      tma_load_3d(sc + j * TILE, &tc, cb, 64 * j, crow + q0, b);
      for (int kt = 0; kt < nk; ++kt)
        tma_load_3d(sb + j * QMAX * ROWB + kt * TILE, &tb, cb, 64 * j, crow + 64 * kt, b);
    }
  }
  // one thread issues a head's dy, x and H (hi, and lo where the pair is taken)
  auto issue = [&](int i, int pair) {
    const int s = i % NST, bh = bh0 + i;
    unsigned char* slot = ring + s * BW_SLOT;
    mbar_expect_tx(&full[s], (1 + nk + 2 + 2 * pair) * TILE);
    tma_load_3d(slot, &tdy, &full[s], 0, i, b * a.S + crow + q0);
    for (int kt = 0; kt < nk; ++kt)
      tma_load_3d(slot + TILE + kt * TILE, &tx, &full[s], 0, i, b * a.S + crow + 64 * kt);
    for (int j = 0; j < 2 + 2 * pair; ++j)
      tma_load_3d(slot + TILE + QMAX * ROWB + j * TILE, &tr, &full[s], 64 * (j & 1), 0,
                  (j / 2) * a.lo_row + bh * chunks + c);
  };
  if (TMA && tid == 0)
    for (int i = 0; i < NST && i < a.nheads; ++i) issue(i, a.pairs[(size_t)(bh0 + i) * chunks + c]);
  __syncthreads();
  if constexpr (TMA) {
    mbar_wait(cb, 0);
  } else {
    stage_tile(sc, TILE, 64, 2, a.Cm + ((size_t)b * a.S + crow + q0) * a.N, a.N, a.Q - q0, a.N,
               BW_THREADS);
    stage_tile(sb, QMAX * ROWB, 64 * nk, 2, a.Bm + ((size_t)b * a.S + crow) * a.N, a.N, a.Q, a.N,
               BW_THREADS);
  }

  const int warp = (tid / 32) % 4, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows r0, r0 + 8 of the query tile
  const uint32_t c_addr = smem_u32(sc), b_addr = smem_u32(sb);
  float dC[32];  // this warpgroup's half of the batch row's dC over the heads
  zero(dC);

  // a head's scalars, loaded a head ahead so that their latency hides behind
  // the previous head's work: this thread's key (tid < 64 nk) of sck and
  // (tid < 64) of the diagonal tile, a_k1 of key tile tid (< qt), its query
  // rows' a_cs, the pair flag, and (the issuing thread) the flag of the head
  // its next loads are for
  const bool key_in = tid < 64 * nk && tid < a.Q;
  float nk1 = 0.f, nka = 0.f, nkd = 0.f, naq[2] = {0.f, 0.f}, nda = 0.f, ndd = 0.f, nt1 = 0.f;
  int npair = 0, ipair = 0;
  auto fetch = [&](int bh) {
    const size_t at = (size_t)bh * a.S + crow;
    if (key_in) {
      nk1 = a.acs[at + min(tid | 63, a.Q - 1)];
      nka = a.acs[at + tid];
      nkd = a.dt[at + tid];
    }
    if (tid < 64 && q0 + tid < a.Q) {
      nda = a.acs[at + q0 + tid];
      ndd = a.dt[at + q0 + tid];
    }
    if (tid < qt) nt1 = a.acs[at + 64 * tid + 63];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + r0 + 8 * h;
      naq[h] = q < a.Q ? a.acs[at + q] : 0.f;
    }
    npair = a.pairs[(size_t)bh * chunks + c];
  };
  fetch(bh0);

  for (int i = 0; i < a.nheads; ++i) {
    const int s = TMA ? i % NST : 0;
    const int bh = bh0 + i;
    unsigned char* slot = ring + s * BW_SLOT;
    if (tid < 64 * nk)  // as the forward's stage 3 takes it
      sck[tid] = key_in ? __fmul_rn(expf(nk1 - nka), nkd) : 0.f;
    if (tid < 64) {
      sdk[tid] = nda;
      sdk[64 + tid] = ndd;
    }
    if (tid < qt) sak1[tid] = nt1;
    const int pair = __shfl_sync(0xffffffffu, npair, 0);  // warp-uniform, as in the keys
    const float aq[2] = {naq[0], naq[1]};
    if (i + 1 < a.nheads) fetch(bh + 1);
    if (TMA && tid == 0 && i + NST < a.nheads) ipair = a.pairs[(size_t)(bh + NST) * chunks + c];
    if constexpr (!TMA) {
      stage_tile(slot, TILE, 64, 1, a.dy + row_base(bh, crow + q0, a.S, a.P, a.nheads), ld,
                 a.Q - q0, a.P, BW_THREADS);
      stage_tile(slot + TILE, QMAX * ROWB, 64 * nk, 1, a.x + row_base(bh, crow, a.S, a.P, a.nheads),
                 ld, a.Q, a.P, BW_THREADS);
      for (int j = 0; j < 1 + pair; ++j)  // H hi, H lo
        stage_tile(slot + TILE + QMAX * ROWB + 2 * j * TILE, TILE, 64, 2,
                   a.rows4 + ((size_t)j * a.lo_row + (size_t)bh * chunks + c) * (PP * NP), NP,
                   PP, NP, BW_THREADS);
      fence_async_shared();
    }
    __syncthreads();
    if constexpr (TMA) mbar_wait(&full[s], (i / NST) & 1);
    const uint32_t dy_addr = smem_u32(slot), x_addr = dy_addr + TILE;
    const uint32_t hh_addr = x_addr + QMAX * ROWB + wg * TILE, hl_addr = hh_addr + 2 * TILE;

    float eq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) eq[h] = q0 + r0 + 8 * h < a.Q ? expf(aq[h]) : 0.f;

    // y's carried part: dy H over this warpgroup's columns of H
    float yh[32];
    zero(yh);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<1>(yh, desc_kmajor<ROWB, 64>(dy_addr, 0, kk), desc_mnmajor<ROWB, 64>(hh_addr, kk), 1);
    if (pair) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1>(yh, desc_kmajor<ROWB, 64>(dy_addr, 0, kk), desc_mnmajor<ROWB, 64>(hl_addr, kk),
                    1);
    }
    wg_commit();
    wg_wait<0>();
    hold(yh);
    float yq[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = yh[4 * j + 2 * h + e];
          const float cv = __bfloat162float(*reinterpret_cast<const bf16*>(
              sc + wg * TILE + swz(r0 + 8 * h, 8 * j + 2 * tig + e)));
          yq[h] = fmaf(cv, v, yq[h]);
          dC[4 * j + 2 * h + e] = fmaf(eq[h], v, dC[4 * j + 2 * h + e]);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      yq[h] = quad_sum(yq[h]);
      if (wg == 1 && tig == 0) sy[r0 + 8 * h] = yq[h];
    }

    // the chunk's own part, key tile by key tile: dW = dy x^T (and, in
    // warpgroup 0, which alone takes sum_k dW o W, G = C B^T) into fresh
    // accumulators, W and dS as a bf16 pair from them, then dC += dS B
    // issued with the next tile's products
    float rr[2] = {0.f, 0.f};
    float gq[32], dw[32];
    auto products = [&](int kt) {
      if (wg == 0) {
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk)
          wgmma_ss<0>(gq, desc_kmajor<ROWB, 64>(c_addr, 0, kk),
                      desc_kmajor<ROWB, QMAX>(b_addr, 64 * kt, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<0>(dw, desc_kmajor<ROWB, 64>(dy_addr, 0, kk),
                    desc_kmajor<ROWB, QMAX>(x_addr, 64 * kt, kk), kk > 0);
    };
    wg_fence();
    products(0);
    wg_commit();
    wg_wait<0>();
    for (int kt = 0; kt < nk; ++kt) {
      if (wg == 0) hold(gq);
      hold(dw);
      float rq[2];  // below the diagonal: exp(a_q - a_k1), k1 the key tile's last key
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rq[h] = (kt < qt && q0 + r0 + 8 * h < a.Q) ? expf(aq[h] - sak1[kt]) : 0.f;
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 8 * kk + 2 * f + e;
            const int j = idx / 4, h = (idx / 2) & 1;
            const int k = 64 * kt + 8 * j + 2 * tig + e, q = q0 + r0 + 8 * h;
            // below the diagonal (G * exp(a_q - a_k1)) * (exp(a_k1 - a_k) *
            // dt), as the forward forms W; on it (G * L) * dt
            const bool in = q >= k && q < a.Q;
            const float l = kt < qt ? rq[h] : exp_where(in, aq[h] - sdk[k - q0]);
            const float m = kt < qt ? sck[k] : in ? sdk[64 + k - q0] : 0.f;
            v[e] = __fmul_rn(__fmul_rn(dw[idx], l), m);
            if (wg == 0) rr[h] = fmaf(dw[idx], __fmul_rn(__fmul_rn(gq[idx], l), m), rr[h]);
          }
          split_pair(v[0], v[1], hi[kk][f], lo[kk][f]);
        }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = desc_mnmajor<ROWB, QMAX>(b_addr + wg * QMAX * ROWB, 4 * kt + kk);
        wgmma_rs<1>(dC, hi[kk], bd, 1);
        wgmma_rs<1>(dC, lo[kk], bd, 1);
      }
      if (kt + 1 < nk) products(kt + 1);
      wg_commit();
      wg_wait<0>();
    }
    hold(dC);
    const float rs[2] = {quad_sum(rr[0]), quad_sum(rr[1])};
    __syncthreads();  // both halves of sy are written
    if (wg == 0 && tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (q0 + r < a.Q)
          a.dq[(size_t)bh * a.S + crow + q0 + r] = rs[h] + __fmul_rn(eq[h], yq[h] + sy[r]);
      }
    }
    __syncthreads();  // both warpgroups are done with the slot, sck and sy
    if (TMA && tid == 0 && i + NST < a.nheads) issue(i + NST, ipair);
  }
  store_acc(a.dC + ((size_t)b * a.S + crow + q0) * a.N + 64 * wg, a.N, dC, r0, tig, a.Q - q0,
            a.N - 64 * wg);
}

// Backward stage 5.  Block bh * chunks + c, a thread a position t: a_cs's
// cotangent d_a = dq - dt colT - Z s (and at the chunk's last position
// a_last's shares: exp(a_last) sum(H o D) and sum_k Z s), then da's, the
// suffix sums of d_a; dt's = d(da) A + colT + Z exp(a_last - a_cs), and this
// chunk's part of A's, sum_t d(da) dt.  Every sum in a fixed order.
__global__ void __launch_bounds__(BA_THREADS)
ssd_bwd_dda_kernel(const float* __restrict__ acs, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Z,
                   const float* __restrict__ colT, const float* __restrict__ dq,
                   const float* __restrict__ dlast, float* __restrict__ ddt,
                   float* __restrict__ dA_part, int S, int nheads, int Q) {
  __shared__ float ws[BA_THREADS / 32];
  const int chunks = S / Q, bh = blockIdx.x / chunks, c = blockIdx.x % chunks;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t i = (size_t)bh * S + (size_t)c * Q + t;
  const bool in = t < Q;
  const float a_last = acs[(size_t)bh * S + (size_t)c * Q + Q - 1];
  const float d = in ? dt[i] : 0.f;
  const float to_end = in ? expf(a_last - acs[i]) : 0.f;
  const float s = __fmul_rn(to_end, d);
  const float z = in ? Z[i] : 0.f, ct = in ? colT[i] : 0.f;
  const float zs = __fmul_rn(z, s);
  const float zs_sum = block_sum(zs, ws);
  float v = in ? dq[i] - __fmul_rn(d, ct) - zs : 0.f;
  if (t == Q - 1) {  // a_last's shares: the state pass's quarters, in order, and Z s
    const float* dl = dlast + (size_t)blockIdx.x * BP_SPLIT;
    float last = 0.f;
    for (int j = 0; j < BP_SPLIT; ++j) last += dl[j];
    v += last + zs_sum;
  }
  // suffix sums: within the warp, then the later warps' totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += n;
  }
  __syncthreads();
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  for (int w = BA_THREADS / 32 - 1; w > warp; --w) v += ws[w];
  if (in) ddt[i] = fmaf(v, A[bh % nheads], ct + __fmul_rn(z, to_end));
  const float part = block_sum(in ? __fmul_rn(v, d) : 0.f, ws);
  if (t == 0) dA_part[blockIdx.x] = part;
}

// The tensor map of a (B, S, nheads, P) bf16 tensor, read in boxes of 64
// positions of one head (dims (P, nheads, B S), box (64, 1, 64)): the same
// 128-byte rows, swizzled at 128 B, as tensor_map_3d's boxes of (BH, S, P).
int rows_map(CUtensorMap* map, const void* p, uint64_t P, uint64_t nheads, uint64_t rows) {
  if (encode_tiled == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[3] = {P, nheads, rows};
  const cuuint64_t strides[2] = {P * 2, P * nheads * 2};
  const cuuint32_t box[3] = {64, 1, 64};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
                                  dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <bool TMA>
int launch_bwd(void* const* p, int BH, int S, int P, int N, int nheads, int Q,
               const dim3* grids, cudaStream_t st) {
  const int chunks = S / Q, Bb = BH / nheads, lo_row = BH * chunks;
  const bf16* x = static_cast<const bf16*>(p[0]);
  const bf16* dy = static_cast<const bf16*>(p[1]);
  const float* dt = static_cast<const float*>(p[2]);
  const float* da = static_cast<const float*>(p[3]);
  const float* A = static_cast<const float*>(p[4]);
  const bf16* B = static_cast<const bf16*>(p[5]);
  const bf16* C = static_cast<const bf16*>(p[6]);
  const float* dstate = static_cast<const float*>(p[7]);
  float* acs = static_cast<float*>(p[13]);
  int* rising = static_cast<int*>(p[14]);
  float* states = static_cast<float*>(p[15]);
  float* cot = static_cast<float*>(p[16]);
  bf16* rows4 = static_cast<bf16*>(p[17]);
  float* Z = static_cast<float*>(p[18]);
  float* colT = static_cast<float*>(p[19]);
  float* dq = static_cast<float*>(p[20]);
  float* dlast = static_cast<float*>(p[21]);
  int* pairs = rising + lo_row;
  CUtensorMap tx{}, tdy{}, tb{}, tc{}, tr{};
  if (TMA) {
    int err = rows_map(&tx, x, P, nheads, (uint64_t)Bb * S);
    if (err == 0) err = rows_map(&tdy, dy, P, nheads, (uint64_t)Bb * S);
    if (err == 0) err = tensor_map_3d(&tb, B, N, S, Bb, 64, 64);
    if (err == 0) err = tensor_map_3d(&tc, C, N, S, Bb, 64, 64);
    if (err == 0) err = tensor_map_3d(&tr, rows4, NP, PP, 4 * (uint64_t)lo_row, 64, 64);
    if (err != 0) return err;
  }
  ssd_bwd_chunk_state_kernel<TMA><<<grids[0], WG, S1_SMEM, st>>>(
      tx, tdy, tb, tc, x, dy, dt, da, B, C, acs, states, cot, rising, S, P, N, nheads, Q);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_bwd_state_pass_kernel<<<grids[1], BP_THREADS, 0, st>>>(
      states, cot, acs, rising, pairs, dstate, rows4, dlast, BH, S, P, N, Q);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const BwdArgs args{x, dy, dt, acs, B, C, rows4, pairs, static_cast<bf16*>(p[8]),
                     static_cast<bf16*>(p[11]), static_cast<bf16*>(p[12]), Z, colT, dq,
                     S, P, N, nheads, Q, lo_row};
  ssd_bwd_keys_kernel<TMA><<<grids[2], BW_THREADS, BK_SMEM, st>>>(tx, tdy, tb, tc, tr, args);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_bwd_queries_kernel<TMA><<<grids[3], BW_THREADS, BQ_SMEM, st>>>(tx, tdy, tb, tc, tr, args);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_bwd_dda_kernel<<<grids[4], BA_THREADS, 0, st>>>(
      acs, dt, A, Z, colT, dq, dlast, static_cast<float*>(p[9]), static_cast<float*>(p[10]), S,
      nheads, Q);
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
  const int errs[12] = {load_encode_tiled(),
                        set_smem(ssd_scan_f32_kernel, SMEM_BYTES),
                        set_smem(ssd_chunk_state_kernel<true>, S1_SMEM),
                        set_smem(ssd_chunk_state_kernel<false>, S1_SMEM),
                        set_smem(ssd_chunk_out_kernel<true>, S3_SMEM),
                        set_smem(ssd_chunk_out_kernel<false>, S3_SMEM),
                        set_smem(ssd_bwd_chunk_state_kernel<true>, S1_SMEM),
                        set_smem(ssd_bwd_chunk_state_kernel<false>, S1_SMEM),
                        set_smem(ssd_bwd_keys_kernel<true>, BK_SMEM),
                        set_smem(ssd_bwd_keys_kernel<false>, BK_SMEM),
                        set_smem(ssd_bwd_queries_kernel<true>, BQ_SMEM),
                        set_smem(ssd_bwd_queries_kernel<false>, BQ_SMEM)};
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

// The bfloat16 backward: five kernels on the caller's tensors, 22 pointers
// in p: x, dy (BH, S, P), dt, da (BH, S) float32, A (nheads) float32, B, C
// (BH / nheads, S, N), the final state's cotangent (BH, P, N) float32 or null;
// dx (BH, S, P), ddt (BH, S) float32, A's parts (BH, S / Q) float32, dB, dC;
// the temporaries acs (BH, S) float32, rising (2, BH, S / Q) int32, states
// and cot (BH, S / Q, 64, 128) float32, rows4 (4, BH, S / Q, 64, 128)
// bfloat16 (H hi, H lo, D hi, D lo), Z, colT, dq (BH, S) float32 and dlast
// (BH, S / Q) float32.  tma and plan as ssd_scan_bf16_launch's.  Returns the
// CUDA error of the launches (0: launched).
int ssd_scan_bwd_launch(void* const* p, int BH, int S, int P, int N, int nheads, int Q, int tma,
                        const int* plan, void* stream) {
  const int own[5][2] = {{WG, S1_SMEM}, {BP_THREADS, 0}, {BW_THREADS, BK_SMEM},
                         {BW_THREADS, BQ_SMEM}, {BA_THREADS, 0}};
  dim3 grids[5];
  if (P > PP || N > NP || Q > QMAX || Q <= 0 || S % Q || !plan_grids(plan, 5, own, grids) ||
      grids[1].y != BP_SPLIT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tma) return launch_bwd<true>(p, BH, S, P, N, nheads, Q, grids, st);
  return launch_bwd<false>(p, BH, S, P, N, nheads, Q, grids, st);
}

}  // extern "C"
