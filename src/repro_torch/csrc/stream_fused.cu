// Fused SDF stream region: one launch runs a whole StreamProgram over a
// float32 wire stack.
//
// Replaces repro/kernels/stream_fused/kernel.py::fused_stream_fwd (the Pallas
// TPU kernel, body _stream_kernel).  It computes the same function: a static
// program of affine / clip / matmul8 / axpy / const / min2 / max2 / perm ops
// over n_in input wires of N float32 tokens, producing n_out output wires.
//
// Design: a tile interpreter.  The Python side lowers each StreamProgram once
// to a bytecode (kernel.py::lower): an int32 op table, a float32 parameter
// array and an int32 perm-index array, with the program's registers packed
// into a few shared-memory slots by liveness.  One block owns one tile of
// `tile` tokens (a multiple of the program's block unit, so no 8-block or
// P-block straddles a tile): it loads its input wires into shared memory as
// (n_slots, tile), runs the ops in order and stores the output slots.  Every
// thread works on the same token positions for every op, so elementwise ops
// need no barrier; the two cross-token ops (matmul8, perm) are fenced by
// __syncthreads() on both sides.  One build serves every program.
//
// Bound: memory.  The function reads 4*N*n_in bytes and writes 4*N*n_out
// (over 3.35 TB/s on an H100 SXM) and does a few flops per byte.  At the main
// path's N = k*block = 4*4096 = 16384 tokens that is well under a
// microsecond of traffic, so launch latency, not bytes, sets its time.
//
// Arithmetic matches the plain PyTorch version (ref.py) bit for bit: no FMA
// contraction (__fadd_rn / __fmul_rn, and the build passes --fmad=false),
// affine skips its identity parts as ref.py does, matmul8 sums its 8 terms
// left to right, perm is a gather, and min/max/clip propagate NaN the way
// torch.minimum / torch.maximum / torch.clamp do on CUDA.

#include <cuda_runtime.h>

#define MAX_WIRES 32

enum OpKind {
  OP_AFFINE = 0,
  OP_CLIP = 1,
  OP_MATMUL8 = 2,
  OP_AXPY = 3,
  OP_CONST = 4,
  OP_MIN2 = 5,
  OP_MAX2 = 6,
  OP_PERM = 7,
};

// op table row: kind, slot a, slot b, out slot, param offset, aux
// (aux: affine flags bit0 pre, bit1 mul, bit2 post; perm block size P)
#define OP_COLS 6

struct Args {
  const float* in[MAX_WIRES];
  float* out[MAX_WIRES];
  int in_slot[MAX_WIRES];
  int out_slot[MAX_WIRES];
  int n_in;
  int n_out;
  long long n;  // tokens per wire (all rows flattened)
  int tile;     // tokens per block
  int n_ops;
  const int* ops;
  const float* params;
  const int* pidx;
};

__device__ __forceinline__ float nan_min(float a, float b) {
  // torch.minimum on CUDA: NaN from either side wins, else ::min
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__global__ void stream_fused_kernel(Args args) {
  extern __shared__ float sm[];
  const int T = args.tile;
  const long long base = (long long)blockIdx.x * T;

  for (int i = 0; i < args.n_in; ++i) {
    float* s = sm + (long long)args.in_slot[i] * T;
    const float* src = args.in[i];
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const long long g = base + t;
      s[t] = g < args.n ? src[g] : 0.0f;
    }
  }
  __syncthreads();

  for (int k = 0; k < args.n_ops; ++k) {
    const int* op = args.ops + OP_COLS * k;
    const int kind = op[0];
    const float* x = sm + (long long)op[1] * T;
    const float* y = sm + (long long)op[2] * T;
    float* o = sm + (long long)op[3] * T;
    const float* p = args.params + op[4];
    const int aux = op[5];
    const bool cross = kind == OP_MATMUL8 || kind == OP_PERM;
    if (cross) __syncthreads();  // every producer of x has written
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float v;
      switch (kind) {
        case OP_AFFINE:
          v = x[t];
          if (aux & 1) v = __fadd_rn(v, p[0]);
          if (aux & 2) v = __fmul_rn(v, p[1]);
          if (aux & 4) v = __fadd_rn(v, p[2]);
          break;
        case OP_CLIP:
          v = x[t];
          if (v == v) v = fminf(fmaxf(v, p[0]), p[1]);
          break;
        case OP_MATMUL8: {
          const float* xb = x + (t & ~7);
          const int j = t & 7;
          v = __fmul_rn(xb[0], p[j]);
#pragma unroll
          for (int i = 1; i < 8; ++i) v = __fadd_rn(v, __fmul_rn(xb[i], p[8 * i + j]));
          break;
        }
        case OP_AXPY:  // ins (x, a): a + c*x
          v = __fadd_rn(y[t], __fmul_rn(p[0], x[t]));
          break;
        case OP_CONST:
          v = p[0];
          break;
        case OP_MIN2:
          v = nan_min(x[t], y[t]);
          break;
        case OP_MAX2:
          v = nan_max(x[t], y[t]);
          break;
        case OP_PERM: {
          const int P = aux;
          const int j = t % P;
          v = x[t - j + args.pidx[op[4] + j]];
          break;
        }
        default:
          v = 0.0f;
      }
      o[t] = v;
    }
    if (cross) __syncthreads();  // all reads of x done before its slot is reused
  }

  for (int j = 0; j < args.n_out; ++j) {
    const float* s = sm + (long long)args.out_slot[j] * T;
    float* dst = args.out[j];
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const long long g = base + t;
      if (g < args.n) dst[g] = s[t];
    }
  }
}

extern "C" int stream_fused_launch(const void* const* ins, int n_in, void* const* outs, int n_out,
                                   const int* in_slot, const int* out_slot, long long n, int tile,
                                   int threads, int n_slots, const int* ops, int n_ops,
                                   const float* params, const int* pidx, void* stream) {
  if (n_in > MAX_WIRES || n_out > MAX_WIRES || n_in < 1 || n_out < 1) return (int)cudaErrorInvalidValue;
  Args args;
  for (int i = 0; i < n_in; ++i) {
    args.in[i] = static_cast<const float*>(ins[i]);
    args.in_slot[i] = in_slot[i];
  }
  for (int j = 0; j < n_out; ++j) {
    args.out[j] = static_cast<float*>(outs[j]);
    args.out_slot[j] = out_slot[j];
  }
  args.n_in = n_in;
  args.n_out = n_out;
  args.n = n;
  args.tile = tile;
  args.n_ops = n_ops;
  args.ops = ops;
  args.params = params;
  args.pidx = pidx;
  const size_t smem = (size_t)n_slots * tile * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(stream_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (n + tile - 1) / tile;
  stream_fused_kernel<<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
