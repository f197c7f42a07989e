// Loop-overhead microbenchmarks (kernel B8-loops): the cost of one loop
// iteration against its body size, unrolling, nesting, a scalar-to-vector
// broadcast, a reduction across the tile and one small copy from device
// memory into fast memory.
//
// Replaces the TPU kernels of tools/diag_loops.py (pl.pallas_call at :47,
// :70, :85, :103, :119, :136).  On an (8, 128) float32 tile, each arm runs
// a dependent chain on an accumulator a (acc0, zero in the JAX tool) and
// writes a + x:
//   flat 1/4/16/64   n1 iterations of 1/4/16/64 steps a = a * 0.999 + 1e-6;
//   chunk 32/128     n1 iterations of 32/128 such steps, unrolled;
//   nested           n1 x n2 iterations of one step, both loops rolled;
//   bcast            n1 iterations of a = a + float(i);
//   reduce full/lane/sub  n1 iterations of a = a + r * 1e-9, r the max of a
//                    over the tile, over its row of 128, or over its column
//                    of 8;
//   copy             n1 iterations copying the 16 x 128 slice at column
//                    (i % 16) * 128 of a (16, 2048) table in device memory
//                    into shared memory, then c = c + slice[0][0]; writes
//                    x + c;
//   scalar           one thread's n1 iterations of s[c & 7] = i, c += 1 into
//                    shared memory; writes x + float(c).
//
// What bounds it on an H100: latency.  Every arm is one dependent chain
// (a multiply and an add a step, or a reduction, a copy or a store an
// iteration), so the time is the chain's length times the latency of each
// link, not bytes or issue.  Design: one block of 1,024 threads, one tile
// element a thread.  Rolled loops carry `#pragma unroll 1`, so that nvcc
// does not unroll what the TPU arm keeps rolled; the chunk arms unroll
// their inner loop.  The full reduce is a warp-shuffle max then the 32
// warps' maxima through shared memory; the lane reduce a shuffle max over
// the warp, then the 4 warps of a row through shared memory; the sub
// reduce the 8 rows of a column through shared memory (double-buffered, so
// one barrier an iteration).  The copy is cp.async, 16 bytes from each of
// 512 threads, waited on before use.  Built with --fmad=false, so each
// multiply and add rounds on its own, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kCols = 128;
constexpr int kTableCols = 2048;
constexpr int kSliceRows = 16;

enum Arm {
  kFlat1, kFlat4, kFlat16, kFlat64, kChunk32, kChunk128, kNested, kBcast,
  kReduceFull, kReduceLane, kReduceSub, kCopy, kScalar, kArms
};

__device__ __forceinline__ float step(float a) { return a * 0.999f + 1e-6f; }

template <int ADDS>
__global__ void __launch_bounds__(kThreads)
flat_kernel(const float* __restrict__ x, const float* __restrict__ acc0,
            int n1, float* __restrict__ out) {
  const int t = threadIdx.x;
  float a = acc0[t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
#pragma unroll
    for (int k = 0; k < ADDS; ++k) a = step(a);
  }
  out[t] = a + x[t];
}

__global__ void __launch_bounds__(kThreads)
nested_kernel(const float* __restrict__ x, const float* __restrict__ acc0,
              int n1, int n2, float* __restrict__ out) {
  const int t = threadIdx.x;
  float a = acc0[t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i)
#pragma unroll 1
    for (int j = 0; j < n2; ++j) a = step(a);
  out[t] = a + x[t];
}

__global__ void __launch_bounds__(kThreads)
bcast_kernel(const float* __restrict__ x, const float* __restrict__ acc0,
             int n1, float* __restrict__ out) {
  const int t = threadIdx.x;
  float a = acc0[t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) a = a + (float)i;
  out[t] = a + x[t];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// AXIS: 0 the whole tile, 1 the row (128 lanes), 2 the column (8 rows)
template <int AXIS>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ x, const float* __restrict__ acc0,
              int n1, float* __restrict__ out) {
  __shared__ float buf[2][kThreads];
  const int t = threadIdx.x;
  const int warp = t >> 5, row = t / kCols, col = t % kCols;
  float a = acc0[t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    float* s = buf[i & 1];
    float r;
    if (AXIS == 2) {
      s[t] = a;
      __syncthreads();
      r = s[col];
#pragma unroll
      for (int k = 1; k < 8; ++k) r = fmaxf(r, s[k * kCols + col]);
    } else {
      const float w = warp_max(a);
      if ((t & 31) == 0) s[warp] = w;
      __syncthreads();
      if (AXIS == 0) {
        r = s[0];
#pragma unroll
        for (int k = 1; k < kThreads / 32; ++k) r = fmaxf(r, s[k]);
      } else {
        const int w0 = row * (kCols / 32);
        r = fmaxf(fmaxf(s[w0], s[w0 + 1]), fmaxf(s[w0 + 2], s[w0 + 3]));
      }
    }
    a = a + r * 1e-9f;
  }
  out[t] = a + x[t];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const float* __restrict__ x, const float* __restrict__ table,
            int n1, float* __restrict__ out) {
  __shared__ __align__(16) float slice[kSliceRows * kCols];
  const int t = threadIdx.x;
  constexpr int kVecs = kSliceRows * kCols / 4;   // 512 x 16 bytes
  float c = 0.0f;
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    const int col = (i % 16) * kCols;
    if (t < kVecs) {
      const int r = t / (kCols / 4), q = t % (kCols / 4);
      cp_async16(slice + r * kCols + 4 * q,
                 table + (long long)r * kTableCols + col + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    c = c + slice[0];
    __syncthreads();   // the next copy overwrites the slice
  }
  out[t] = x[t] + c;
}

__global__ void __launch_bounds__(kThreads)
scalar_kernel(const float* __restrict__ x, int n1, float* __restrict__ out) {
  __shared__ volatile int s[8];
  __shared__ int count;
  const int t = threadIdx.x;
  if (t == 0) {
    int c = 0;
#pragma unroll 1
    for (int i = 0; i < n1; ++i) {
      s[c & 7] = i;
      c = c + 1;
    }
    count = c;
  }
  __syncthreads();
  out[t] = x[t] + (float)count;
}

}  // namespace

// Launch arm `arm` (the Arm order above) on `stream`; return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for an
// unknown arm or a negative trip count.  x, acc0 and out hold 1,024
// floats; table (16, 2048) floats, read by the copy arm only; n2 is the
// nested arm's inner trip count.
extern "C" int diag_loops_launch(int arm, const float* x, const float* acc0,
                                 const float* table, int n1, int n2,
                                 float* out, void* stream) {
  if (arm < 0 || arm >= kArms || n1 < 0 || n2 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (arm) {
    case kFlat1: flat_kernel<1><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kFlat4: flat_kernel<4><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kFlat16: flat_kernel<16><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kFlat64: flat_kernel<64><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kChunk32: flat_kernel<32><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kChunk128:
      flat_kernel<128><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kNested:
      nested_kernel<<<1, kThreads, 0, st>>>(x, acc0, n1, n2, out);
      break;
    case kBcast: bcast_kernel<<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kReduceFull:
      reduce_kernel<0><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kReduceLane:
      reduce_kernel<1><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kReduceSub:
      reduce_kernel<2><<<1, kThreads, 0, st>>>(x, acc0, n1, out);
      break;
    case kCopy: copy_kernel<<<1, kThreads, 0, st>>>(x, table, n1, out);
      break;
    default: scalar_kernel<<<1, kThreads, 0, st>>>(x, n1, out);
      break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* diag_loops_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
