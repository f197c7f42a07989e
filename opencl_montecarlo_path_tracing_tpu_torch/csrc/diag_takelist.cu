// Take-list primitives on fake blocks (kernel B8-prim): what a per-block
// "does any lane need this block?" decision costs, four ways.
//
// Replaces the TPU kernels of tools/diag_primitives.py (pl.pallas_call at
// :145): kernel_noop, kernel_anycond, kernel_scalarcond and
// kernel_takelist.  On an (8, 128) float32 tile x, with nb fake blocks and
// reps repetitions, the accumulator a (zero at the start) becomes:
//   noop         a += 1e-6 for every block;
//   any+cond     a += 1e-6 for block b where any element has x > b / nb;
//   scalar-cond  a += 1e-6 for block b where flags[b] != 0;
//   take-list    per repetition: the flags of all blocks (one vote each),
//                the list of flagged blocks built without branches, then a
//                loop of run-time trip count adding 1e-6 * b for each
//                listed block b.
// The take-list writes its count (the number of flagged blocks) itself, on
// its only path, every repetition; the other arms write 0, as the TPU
// kernels do.
//
// What bounds it on an H100: latency.  Each arm is one dependent chain of
// float adds (a few per block) behind a block-wide barrier or a
// shared-memory read a block; nothing is large enough to be bound by bytes
// or issue.  Design: one block of 1,024 threads, one tile element a
// thread.  The any-lane vote is __syncthreads_or, the Hopper form of the
// TPU's vector max plus scalar branch; the scalar predicate comes from a
// flag array staged in shared memory (the TPU's SMEM); the take-list's
// flags are votes stored into shared memory, its list is built by one warp
// with __ballot_sync and __popc prefix counts (an unflagged lane writes a
// scratch slot, so no lane branches), and its loop reads the count from
// shared memory at run time.  Loops carry `#pragma unroll 1` so that nvcc
// keeps them rolled, as the TPU kernels keep their fori loops; built with
// --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;          // the (8, 128) tile
constexpr int kMaxBlocks = 4096;        // nb limit (the list's slots)
constexpr unsigned kAll = 0xffffffffu;

enum Arm { kNoop = 0, kAnyCond = 1, kScalarCond = 2, kTakeList = 3 };

__global__ void __launch_bounds__(kThreads)
takelist_kernel(int arm, const float* __restrict__ x,
                const int* __restrict__ flags, int nb, int reps,
                float* __restrict__ out, int* __restrict__ cnt_out) {
  __shared__ int sflags[kMaxBlocks];
  __shared__ int slist[kMaxBlocks + 1];   // slot nb: scratch
  __shared__ int scnt;
  const int t = threadIdx.x;
  const float xv = x[t];
  float a = 0.0f;
  if (arm == kScalarCond) {
    for (int b = t; b < nb; b += kThreads) sflags[b] = flags[b];
    __syncthreads();
  }
  if (arm == kNoop) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r)
#pragma unroll 1
      for (int b = 0; b < nb; ++b) a = a + 1e-6f;
  } else if (arm == kAnyCond) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r)
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const float thr = (float)b / (float)nb;
        if (__syncthreads_or(xv > thr)) a = a + 1e-6f;
      }
  } else if (arm == kScalarCond) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r)
#pragma unroll 1
      for (int b = 0; b < nb; ++b)
        if (sflags[b] != 0) a = a + 1e-6f;
  } else {
    const int lane = t & 31;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      // flag prepass: one block-wide vote a block
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const float thr = (float)b / (float)nb;
        const int f = __syncthreads_or(xv > thr);
        if (t == 0) sflags[b] = f;
      }
      __syncthreads();
      // the list, by warp 0: 32 flags a step, prefix counts by ballot
      if (t < 32) {
        int base = 0;
#pragma unroll 1
        for (int g = 0; g < nb; g += 32) {
          const int b = g + lane;
          const int f = b < nb ? sflags[b] : 0;
          const unsigned mask = __ballot_sync(kAll, f != 0);
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          slist[f != 0 ? pos : nb] = b;
          base += __popc(mask);
        }
        if (lane == 0) scnt = base;
      }
      __syncthreads();
      const int n = scnt;
#pragma unroll 1
      for (int i = 0; i < n; ++i) a = a + 1e-6f * (float)slist[i];
      if (t == 0) *cnt_out = n;
      __syncthreads();   // the next repetition rewrites the flags and list
    }
  }
  out[t] = a;
  if (arm != kTakeList && t == 0) *cnt_out = 0;
}

}  // namespace

// Launch arm `arm` (0 noop, 1 any+cond, 2 scalar-cond, 3 take-list) on
// `stream`; return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an arm or nb out of range.  x and out hold
// 1,024 floats, flags nb ints (read by scalar-cond only), cnt_out one int.
extern "C" int diag_takelist_launch(int arm, const float* x, const int* flags,
                                    int nb, int reps, float* out,
                                    int* cnt_out, void* stream) {
  if (arm < kNoop || arm > kTakeList || nb < 0 || nb > kMaxBlocks ||
      reps < 0)
    return (int)cudaErrorInvalidValue;
  takelist_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      arm, x, flags, nb, reps, out, cnt_out);
  return (int)cudaGetLastError();
}

extern "C" const char* diag_takelist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
