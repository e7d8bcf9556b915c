// Fused SDF stream region: the template of the kernel that one StreamProgram
// becomes, and the device helpers its generated body calls.
//
// Replaces repro/kernels/stream_fused/kernel.py::fused_stream_fwd (the Pallas
// TPU kernel, body _stream_kernel), which unrolls a static op list into
// straight-line vector code at trace time.  The CUDA version does the same at
// build time: repro_torch/kernels/stream_fused/kernel.py (plan, emit) writes
// one .cu per program under repro_torch/build/, a struct Program whose run()
// is the op list as straight-line code, one statement per op, each wire a
// C++ local (registers), each parameter a literal written as its float32 bit
// pattern; it includes this header and ends in STREAM_FUSED_ENTRY(Program).
//
// Layout.  A thread holds 4 consecutive tokens of every wire (a W, loaded and
// stored as 16 bytes where the pointers are 16-byte aligned), and K groups
// of them at large N (K * blockDim.x * 4 tokens a block, the groups a block
// apart, so that a warp's 32 lanes always hold 128 consecutive tokens): the
// K loads of every input are in flight together.  No token straddles rows of
// a (B, N) stack differently from a flat wire: N is a multiple of the
// program's block unit (8 and every perm's P), so 8-blocks and P-blocks never
// cross a row, and the stack runs as B * N tokens.  Past the last token a
// thread computes on zeros and stores nothing.
//
// Cross-token ops.  matmul8: an 8-block is the 4 tokens of an even lane and
// the 4 of the next, exchanged with one __shfl_xor_sync each; every lane sums
// its 4 outputs' 8 terms left to right in float32 on the CUDA cores (no tensor
// cores: TF32 and the MMA's own order would break the bitwise invariants).
// perm: a gather through shared memory, staged once: the scope's tokens (a
// warp's 128 when every P divides 128, else the block's, whose token count the
// plan makes a multiple of every P) are stored, the scope synchronises, and
// each lane reads its 4 outputs at the positions the plan's table gives.
//
// Bound: memory.  4 * N * (n_in + n_out) bytes against a few float32
// operations a byte (FIR32 the most: 64 a token, 5.3 a byte).  At N = 16384
// the card moves that in well under a microsecond, so the launch and one
// load-compute-store chain set the time; the grid then gives every SM a
// block (the launch reads the SM count).  At N = 2^22 bytes bound it: K
// groups a thread keep the loads in flight.
//
// Arithmetic matches the plain PyTorch version (ref.py) bit for bit: no FMA
// contraction (__fadd_rn / __fmul_rn, and the build passes --fmad=false),
// affine skips its identity parts as ref.py does (the generator omits them),
// matmul8 sums its 8 terms left to right, perm is a gather, and min / max /
// clip propagate NaN the way torch.minimum / torch.maximum / torch.clamp do
// on CUDA, with -0 < +0 on a tie of signed zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_WIRES 32

namespace {

struct W {  // one wire's 4 consecutive tokens in a thread
  float v[4];
};

struct Ctx {
  float* stage;  // the perm staging buffer of the thread's scope
  int li;        // the thread's index in its scope (lane, or thread of the block)
  bool odd;      // its tokens are the second half of their 8-block
};

// a literal written as its float32 bit pattern: exact for -0, NaN payloads
// and subnormals, which a decimal literal may not be
__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

// torch.minimum on CUDA: NaN from either side wins (a's first), else ::min;
// selects, not branches
__device__ __forceinline__ float nan_min(float a, float b) {
  const float r = b != b ? b : fminf(a, b);
  return a != a ? a : r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  const float r = b != b ? b : fmaxf(a, b);
  return a != a ? a : r;
}

__device__ __forceinline__ W add(const W& x, float c) {
  W o;
#pragma unroll
  for (int m = 0; m < 4; ++m) o.v[m] = __fadd_rn(x.v[m], c);
  return o;
}

__device__ __forceinline__ W mul(const W& x, float c) {
  W o;
#pragma unroll
  for (int m = 0; m < 4; ++m) o.v[m] = __fmul_rn(x.v[m], c);
  return o;
}

__device__ __forceinline__ W clip(const W& x, float lo, float hi) {
  W o;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float v = x.v[m];
    o.v[m] = v == v ? fminf(fmaxf(v, lo), hi) : v;
  }
  return o;
}

// a + c * x, one MAC tap, never fused into an FMA
__device__ __forceinline__ W axpy(const W& x, const W& a, float c) {
  W o;
#pragma unroll
  for (int m = 0; m < 4; ++m) o.v[m] = __fadd_rn(a.v[m], __fmul_rn(c, x.v[m]));
  return o;
}

__device__ __forceinline__ W splat(float c) { return W{{c, c, c, c}}; }

__device__ __forceinline__ W min2(const W& a, const W& b) {
  W o;
#pragma unroll
  for (int m = 0; m < 4; ++m) o.v[m] = nan_min(a.v[m], b.v[m]);
  return o;
}

__device__ __forceinline__ W max2(const W& a, const W& b) {
  W o;
#pragma unroll
  for (int m = 0; m < 4; ++m) o.v[m] = nan_max(a.v[m], b.v[m]);
  return o;
}

struct Basis {  // an 8 x 8 basis, row-major: b[8 i + j] multiplies x_i into y_j
  float b[64];
};

// y_j = x_0 B[0][j] + x_1 B[1][j] + ... + x_7 B[7][j], left to right; the
// 8-block is this lane's 4 tokens and its partner's (lane ^ 1)
__device__ __forceinline__ W matmul8(const W& x, const Ctx& c, const Basis& B) {
  float p[4], blk[8];
#pragma unroll
  for (int m = 0; m < 4; ++m) p[m] = __shfl_xor_sync(0xffffffffu, x.v[m], 1);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    blk[m] = c.odd ? p[m] : x.v[m];
    blk[4 + m] = c.odd ? x.v[m] : p[m];
  }
  W o;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float y = __fmul_rn(blk[0], c.odd ? B.b[4 + m] : B.b[m]);
#pragma unroll
    for (int i = 1; i < 8; ++i)
      y = __fadd_rn(y, __fmul_rn(blk[i], c.odd ? B.b[8 * i + 4 + m] : B.b[8 * i + m]));
    o.v[m] = y;
  }
  return o;
}

// the scope's tokens through shared memory: output token 4 li + m is the
// staged token src[m] of the scope
template <bool BLOCK>
__device__ __forceinline__ W perm(const W& x, const Ctx& c, const int4 src) {
  if (BLOCK) __syncthreads(); else __syncwarp();  // earlier readers of the buffer are done
  *reinterpret_cast<float4*>(c.stage + 4 * c.li) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  if (BLOCK) __syncthreads(); else __syncwarp();
  return W{{c.stage[src.x], c.stage[src.y], c.stage[src.z], c.stage[src.w]}};
}

template <bool VEC>
__device__ __forceinline__ W load(const float* __restrict__ p, long long g, long long n) {
  if (g >= n) return splat(0.f);
  if (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + g));
    return W{{v.x, v.y, v.z, v.w}};
  }
  return W{{__ldg(p + g), __ldg(p + g + 1), __ldg(p + g + 2), __ldg(p + g + 3)}};
}

template <bool VEC>
__device__ __forceinline__ void store(float* __restrict__ p, long long g, long long n,
                                      const W& x) {
  if (g >= n) return;
  if (VEC) {
    *reinterpret_cast<float4*>(p + g) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) p[g + m] = x.v[m];
  }
}

struct Args {
  const float* in[MAX_WIRES];
  float* out[MAX_WIRES];
  long long n;  // tokens per wire (all rows)
};

// Block b takes tokens [b T, (b + 1) T), T = 4 K blockDim.x; thread t its 4
// tokens at 4 (k blockDim.x + t) of it for k < K.  P::kBlockScope: the perm
// scope is the block (P::kStage tokens = 4 blockDim.x), else the warp.
template <class P, int K, bool VEC>
__global__ void __launch_bounds__(P::kMaxThreads) stream_fused_kernel(const Args a) {
  __shared__ __align__(16) float stage[P::kStage];
  const int t = threadIdx.x;
  Ctx c;
  c.li = P::kBlockScope ? t : (t & 31);
  c.stage = stage + (P::kBlockScope ? 0 : 128 * (t >> 5));
  c.odd = t & 1;
  const long long base = (long long)blockIdx.x * blockDim.x * 4 * K + 4 * t;
  W in[K][P::kIn];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < P::kIn; ++i)
      in[k][i] = load<VEC>(a.in[i], base + 4LL * k * blockDim.x, a.n);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    W out[P::kOut];
    P::run(in[k], out, c);
#pragma unroll
    for (int j = 0; j < P::kOut; ++j)
      store<VEC>(a.out[j], base + 4LL * k * blockDim.x, a.n, out[j]);
  }
}

__global__ void stream_empty_kernel() {}

}  // namespace

// The library's C interface.  stream_fused_launch: n tokens a wire (a
// multiple of 8), `k` groups a thread (1 or P::kK), `vec` != 0 when every
// pointer is 16-byte aligned, the caller's grid.  Returns the CUDA error of
// the launch (0: launched); an invalid value for what the kernel does not
// take.  stream_fused_empty launches an empty kernel on the same grid: the
// launch floor the program's time is read beside.
#define STREAM_FUSED_ENTRY(P)                                                                  \
  extern "C" int stream_fused_launch(const void* const* ins, int n_in, void* const* outs,     \
                                     int n_out, long long n, int k, int vec, int threads,     \
                                     int blocks, void* stream) {                              \
    if (n_in != P::kIn || n_out != P::kOut || n % 8 || threads < 32 || threads % 32 ||        \
        threads > P::kMaxThreads || (P::kBlockScope && 4 * threads != P::kStage) ||           \
        blocks < 1 ||                                                                         \
        (k != 1 && k != P::kK) || (vec == 0 && k != 1))                                       \
      return (int)cudaErrorInvalidValue;                                                      \
    Args a;                                                                                   \
    for (int i = 0; i < n_in; ++i) a.in[i] = static_cast<const float*>(ins[i]);               \
    for (int j = 0; j < n_out; ++j) a.out[j] = static_cast<float*>(outs[j]);                  \
    a.n = n;                                                                                  \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                                \
    if (!vec)                                                                                 \
      stream_fused_kernel<P, 1, false><<<blocks, threads, 0, st>>>(a);                        \
    else if (k == 1)                                                                          \
      stream_fused_kernel<P, 1, true><<<blocks, threads, 0, st>>>(a);                         \
    else                                                                                      \
      stream_fused_kernel<P, P::kK, true><<<blocks, threads, 0, st>>>(a);                     \
    return (int)cudaGetLastError();                                                           \
  }                                                                                           \
  extern "C" int stream_fused_empty(int threads, int blocks, void* stream) {                 \
    stream_empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();         \
    return (int)cudaGetLastError();                                                           \
  }
