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
//   bfloat16 (gmm_wgmma_kernel): built for Hopper as the flash kernels are
//   (hopper.cuh).  A block owns one output tile, (64 WGS) rows x 256 columns
//   of one expert: WGS consumer warpgroups of 64 rows each and a producer
//   warpgroup, one thread of which keeps a ring of shared-memory stages (5
//   with one consumer, 4 with two) full through TMA, behind mbarrier
//   full/empty pairs, so the loads of the next stages are in flight while
//   the tensor cores work.  A stage is 64 of d: the x tile through a 3-d
//   tensor map (d, C, E), K-major, whose rows past C inside an expert read
//   as zeros (a decode's 8 rows cost one 64-row tile, with no predicated
//   copies and no read of the next expert), and the w tile through a 3-d
//   map (f, d, E) as stored, f contiguous, in 64-column boxes that wgmma
//   reads MN-major (the transpose bit): nothing is transposed or staged
//   through registers.  Both are swizzled at 128 B rows.  Each consumer runs
//   one wgmma.m64n256k16 (bf16 in, float32 accumulate) a k-step, or
//   m64n128k16 on a last tile of at most 128 columns (f = 1408), keeps one
//   stage's products in flight while it waits for the next, and converts
//   its accumulator to bf16 once, storing rows r < C and columns c < f.
//   Columns and d past the tensor read as zeros too, so d % 8 == 0 and
//   f % 8 == 0 (TMA's 16-byte row strides) are all it needs.  Timed on the
//   card and no faster: 128- and 176-column tiles, two n128 instructions
//   for one n256, a persistent grid (one block per SM walking the tiles),
//   and clusters of two blocks on consecutive row tiles multicasting their
//   w tile.
//
//   float32: the CUDA cores (no TF32: the reference's float32 tolerance is
//   3e-4).  A block owns a 64 x 64 output tile and loops over d in steps of
//   16 through shared memory; each thread accumulates a 4 x 4 sub-tile with
//   fmaf in ascending d.  Rows, columns and the tail of d are predicated.
//
// One order of summation per output element.  In both designs an element's
// sum over d runs in one fixed order that depends on d alone: ascending
// stages of 64 and, inside a stage, ascending wgmma k-steps of 16 into one
// float32 accumulator for bfloat16; ascending d for float32.  There is no
// split of d chosen by shape, and every bf16 tile is 256 columns wide.  The
// caller's tile plan (kernel.py tile_plan) picks from C only how many 64-row
// warpgroups a block has (and so how many blocks there are), and a column's
// instruction (n256, or n128 on a narrow last tile) depends on f alone; a
// row always sits at the same place in its warpgroup's 64 rows.  So a row of the output is
// bitwise the same whatever C is: the serving engine's batched decode (C =
// 8) and a request decoded alone (C = 6) compute the same rows, as do a
// prefill and a decode.
//
// What bounds it.  At the MoE prefill shape (64 experts, 1984 rows, d 2048,
// f 1408, bf16) the work is 732 GFLOP on 1.25 GB: operations bound it (0.74
// ms at 989 TFLOP/s), so the tensor cores have to be fed without a pause:
// the ring and the 256-wide warpgroup instruction, with no wasted half tile
// at f = 1408.  At a decode shape (C = 8) it reads every expert's weights
// (369 MB) for 3 GFLOP: bytes bound it (0.11 ms at 3.35 TB/s), and the
// decode plan (one consumer warpgroup, a 5-stage ring) keeps 160 KB of w in
// flight on every SM; its 64-row instructions do 8x the useful tensor work,
// still under the byte time.

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: TMA, an mbarrier ring and wgmma
// ---------------------------------------------------------------------------

constexpr int GMM_BN = 256;             // output columns per tile: one wgmma.m64n256k16 a k-step
constexpr int GMM_BK = 64;              // d per stage
constexpr int GMM_ROWB = 128;           // bytes of a 64-wide bf16 row chunk (the swizzle)
constexpr int GMM_BOX = 64 * GMM_ROWB;  // one 64 x 64 box of w: 8 KB
constexpr int GMM_SMEM_MAX = 232448;    // dynamic shared memory a block can have

// WGS consumer warpgroups of 64 rows
template <int WGS> struct GmmCfg {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int A_BYTES = BM * GMM_ROWB;                // x: BM rows of 64
  static constexpr int B_BYTES = (GMM_BN / 64) * GMM_BOX;      // w: 64 rows of 256, in 64-column boxes
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the deepest ring that fits, at most 8 stages: 5 (one warpgroup), 4 (two)
  static constexpr int ST = (GMM_SMEM_MAX - 2048) / STAGE < 8 ? (GMM_SMEM_MAX - 2048) / STAGE : 8;
  static constexpr int SMEM = 1024 + ST * STAGE + 2 * ST * 8;
};

// One output tile a block: block (x, y, z) owns columns [256 x, 256 x + 256)
// and rows [BM y, BM y + BM) of expert z.
template <int WGS>
__global__ void __launch_bounds__(GmmCfg<WGS>::THREADS, 1) gmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    bf16* __restrict__ y, int C, int d, int f) {
  using G = GmmCfg<WGS>;
  constexpr int ST = G::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = (unsigned char*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(ring + ST * G::STAGE);  // stage s: x at ring + s STAGE, w after it
  uint64_t* empty = full + ST;

  const int n0 = blockIdx.x * GMM_BN, m0 = blockIdx.y * G::BM, e = blockIdx.z;
  const int KT = (d + GMM_BK - 1) / GMM_BK;
  // a last tile of at most 128 columns (f = 1408 = 5.5 x 256) takes the n128
  // instruction and loads half the w boxes: a column's instruction depends
  // on f, never on C
  const bool narrow = f - n0 <= 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WGS) {  // the producer warpgroup: one thread keeps the ring full
    if constexpr (WGS > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == WGS * 128) {
      const int boxes = narrow ? 2 : GMM_BN / 64;
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(&empty[s], ((kt / ST) & 1) ^ 1);
        unsigned char* a = ring + s * G::STAGE;
        mbar_expect_tx(&full[s], G::A_BYTES + boxes * GMM_BOX);
        tma_load_3d(a, &tx, &full[s], kt * GMM_BK, m0, e);
        for (int c = 0; c < boxes; ++c)
          tma_load_3d(a + G::A_BYTES + c * GMM_BOX, &tw, &full[s], n0 + 64 * c, kt * GMM_BK, e);
      }
    }
  } else {  // consumers: 64 rows each
    if constexpr (WGS > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const uint32_t ring_addr = smem_u32(ring);
    float acc[GMM_BN / 2];  // rows (warp 16 + g) (+8), columns 8 j + 2 tig (+1)
    zero(acc);
    // the tile's products into d (float[64]: the n128 instruction, which
    // writes the first 128 columns' registers; float[128]: n256)
    auto mainloop = [&](auto& d) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % ST;
        mbar_wait(&full[s], (kt / ST) & 1);
        const uint32_t a = ring_addr + s * G::STAGE, b = a + G::A_BYTES;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < GMM_BK / 16; ++kk)
          wgmma_ss<1>(d, desc_kmajor<GMM_ROWB, G::BM>(a, wg * 64, kk),
                      desc_mnmajor<GMM_ROWB, 64>(b, kk), 1);
        wg_commit();
        // the previous stage's products are done: hand its slot back
        wg_wait<1>();
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(kt - 1) % ST]);
        }
      }
    };
    if (narrow) mainloop(*reinterpret_cast<float(*)[64]>(acc));
    else mainloop(acc);
    wg_wait<0>();
    hold(acc);

    const int r = m0 + wg * 64 + warp * 16 + g;
    bf16* ye = y + (size_t)e * C * f;
#pragma unroll
    for (int j = 0; j < GMM_BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * tig;
      if (c >= f) continue;
      if (r < C)
        *reinterpret_cast<uint32_t*>(ye + (size_t)r * f + c) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < C)
        *reinterpret_cast<uint32_t*>(ye + (size_t)(r + 8) * f + c) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 8 warps
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

template <int WGS>
int launch_wgmma(const void* x, const void* w, void* y, int E, int C, int d, int f,
                 cudaStream_t st) {
  using G = GmmCfg<WGS>;
  CUtensorMap tx, tw;
  int err = tensor_map_3d(&tx, x, d, C, E, GMM_BK, G::BM);
  if (err == 0) err = tensor_map_3d(&tw, w, f, d, E, 64, GMM_BK);
  if (err != 0) return err;
  const dim3 grid((f + GMM_BN - 1) / GMM_BN, (C + G::BM - 1) / G::BM, E);
  gmm_wgmma_kernel<WGS><<<grid, G::THREADS, G::SMEM, st>>>(tx, tw, static_cast<bf16*>(y), C, d, f);
  return (int)cudaGetLastError();
}

template <int WGS> int set_smem_limit() {
  return (int)cudaFuncSetAttribute(gmm_wgmma_kernel<WGS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   GmmCfg<WGS>::SMEM);
}

}  // namespace

extern "C" {

// Fetch the tensor-map encoder and lift the dynamic shared-memory limit of the bf16 kernels above
// 48 KB: once per device, before the first launch.
int moe_gmm_init() {
  const int errs[3] = {load_encode_tiled(), set_smem_limit<1>(), set_smem_limit<2>()};
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

// x (E, C, d), w (E, d, f), y (E, C, f), contiguous, one type (bf16 != 0:
// bfloat16, with d % 8 == 0, f % 8 == 0 and 16-byte aligned bases, with wgs
// = 1 or 2 consumer warpgroups a block; else float32, any sizes).  Returns the CUDA error of the launch (0: launched).
int moe_gmm_launch(const void* x, const void* w, void* y, int E, int C, int d, int f, int bf16_,
                   int wgs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E == 0 || C == 0 || f == 0) return 0;
  if (bf16_) {
    if (d % 8 || f % 8 || d == 0) return (int)cudaErrorInvalidValue;
    if (wgs == 1) return launch_wgmma<1>(x, w, y, E, C, d, f, st);
    if (wgs == 2) return launch_wgmma<2>(x, w, y, E, C, d, f, st);
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((f + FT - 1) / FT, (C + FT - 1) / FT, E);
  gmm_f32_kernel<<<grid, THREADS, 0, st>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w), static_cast<float*>(y),
                                           C, d, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
