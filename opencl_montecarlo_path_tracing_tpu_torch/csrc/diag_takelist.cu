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
// What bounds it on an H100: latency.  Each arm is one chain of float adds
// on a, one a block (noop) or one a flagged block.  The votes, flag reads,
// list builds and loop branches do not depend on a, so they can overlap
// the chain; chip_smoke.py's bound is the adds alone.  Design: one warp
// holds the tile, 32 elements a lane in registers, and decides as the
// port's kernels do, with one warp vote (__any_sync) a (repetition, block).
// A lane's predicate for block b is one compare of the lane's max (fmaxf
// over its elements, taken once a launch) against b / nb: the same
// function as 32 compares, since fmaxf drops a NaN as x > thr is false for
// one, and faster (tools/diag_variants.py times the alternatives).  The
// thresholds b / nb are IEEE divisions made once a launch into a shared
// table; the scalar flags are staged into shared memory (the TPU's SMEM)
// once a launch.  In the loops each shared read (a threshold, a flag, a
// list entry) is issued an iteration before its use, and block b's
// predicate (the compare, the flag's test, the list entry's term) is
// formed in the iteration before b's, so b's vote or add waits on neither.
// What is left is the rolled loop itself: ~29 cycles an iteration with one
// warp (noop's add and branch), ~32-38 with a flag or a vote.  The
// take-list's flags are votes stored into shared memory, its list is built
// with __ballot_sync and __popc prefix counts (an unflagged lane writes a
// scratch slot, so no lane branches), and its loop reads the count from
// shared memory at run time.  Loops carry `#pragma unroll 1` so that nvcc
// keeps them rolled, as the TPU kernels keep their fori loops; built with
// --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;               // one warp holds the tile
constexpr int kPerLane = 1024 / kLanes;  // tile element j * 32 + lane
constexpr int kMaxBlocks = 4096;         // nb limit (the list's slots)
constexpr unsigned kAll = 0xffffffffu;

enum Arm { kNoop = 0, kAnyCond = 1, kScalarCond = 2, kTakeList = 3 };

__global__ void __launch_bounds__(kLanes)
takelist_kernel(int arm, const float* __restrict__ x,
                const int* __restrict__ flags, int nb, int reps,
                float* __restrict__ out, int* __restrict__ cnt_out) {
  // slots past nb: the reads ahead (never used) and the list's scratch
  __shared__ float sthr[kMaxBlocks + 2];
  __shared__ int sflags[kMaxBlocks + 2];
  __shared__ unsigned short slist[kMaxBlocks + 2];
  __shared__ int scnt;
  // the loops read shared memory through volatile pointers, so that the
  // compiler keeps each read an iteration ahead of its use (a read two
  // ahead is no faster: tools/diag_variants.py)
  const volatile float* vthr = sthr;
  volatile int* vflags = sflags;
  volatile unsigned short* vlist = slist;
  const int lane = threadIdx.x;
  float xm = x[lane];
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) xm = fmaxf(xm, x[j * kLanes + lane]);
  if (arm == kAnyCond || arm == kTakeList)
    for (int b = lane; b <= nb + 1; b += kLanes)
      sthr[b] = b < nb ? (float)b / (float)nb : 0.0f;
  if (arm == kScalarCond)
    for (int b = lane; b <= nb + 1; b += kLanes)
      sflags[b] = b < nb ? flags[b] : 0;
  __syncwarp();
  // In the loops below, block b's predicate (the lane's compare, the
  // flag's test, the take-list's term) is formed in the iteration before
  // b's, from a read made the iteration before that, so that b's vote or
  // add waits on neither; each iteration still makes one read, one
  // compare, one vote or flag test and one add.
  float a = 0.0f;
  if (arm == kNoop) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r)
#pragma unroll 1
      for (int b = 0; b < nb; ++b) a = a + 1e-6f;
  } else if (arm == kAnyCond) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      bool above = xm > vthr[0];
      float thr = vthr[1];
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const bool cur = above;
        above = xm > thr;
        thr = vthr[b + 2];
        if (__any_sync(kAll, cur)) a = a + 1e-6f;
      }
    }
  } else if (arm == kScalarCond) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      bool set = vflags[0] != 0;
      int flag = vflags[1];
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const bool cur = set;
        set = flag != 0;
        flag = vflags[b + 2];
        if (cur) a = a + 1e-6f;
      }
    }
  } else {
    const unsigned below = (1u << lane) - 1u;
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      // flag prepass: one warp vote a block
      bool above = xm > vthr[0];
      float thr = vthr[1];
#pragma unroll 1
      for (int b = 0; b < nb; ++b) {
        const bool cur = above;
        above = xm > thr;
        thr = vthr[b + 2];
        const int f = __any_sync(kAll, cur);
        if (lane == 0) vflags[b] = f;
      }
      __syncwarp();
      // the list: 32 flags a step, prefix counts by ballot
      int base = 0;
#pragma unroll 1
      for (int g = 0; g < nb; g += kLanes) {
        const int b = g + lane;
        const int f = b < nb ? vflags[b] : 0;
        const unsigned mask = __ballot_sync(kAll, f != 0);
        vlist[f != 0 ? base + __popc(mask & below) : nb] =
            (unsigned short)b;
        base += __popc(mask);
      }
      if (lane == 0) scnt = base;
      __syncwarp();
      const int n = *(volatile int*)&scnt;
      float term = 1e-6f * (float)vlist[0];
      unsigned short entry = vlist[1];
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        const float cur = term;
        term = 1e-6f * (float)entry;
        entry = vlist[i + 2];
        a = a + cur;
      }
      if (lane == 0) *cnt_out = n;
      __syncwarp();   // the next repetition rewrites the flags and list
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) out[j * kLanes + lane] = a;
  if (arm != kTakeList && lane == 0) *cnt_out = 0;
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
  takelist_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
      arm, x, flags, nb, reps, out, cnt_out);
  return (int)cudaGetLastError();
}

extern "C" const char* diag_takelist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
