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
// What bounds it on an H100: latency.  Every arm is a dependent chain: a
// multiply and an add a step, an add an iteration, plus, where the arm
// puts it on the chain, the full reduce's exchange across warps and the
// copy's round trip to L2 (chip_smoke.py's restated bound).  A rolled
// iteration with one warp to a scheduler also waits on its loop branch:
// ~29 cycles an iteration on the H100, the compare's predicate 13 cycles
// before the branch can read it, then the branch; that, not the 8-cycle
// step, is flat1's and nested's iteration.  More warps to a scheduler
// would hide that wait but cost each step its instructions times the
// warps in issue cycles.  Design (tools/diag_variants.py times the
// alternatives named here):
// - The element-wise arms (flat, chunk, nested, bcast) give every
//   element's chain its own thread and every warp a scheduler: 8 blocks of
//   128 threads, one warp to each of an SM's 4 schedulers, on 8 SMs (32
//   blocks of 32 run flat1 8% slower, bcast 6% faster, the rest within
//   2%).  bcast converts i one iteration ahead, so the conversion is off
//   the add's chain.
// - reduce full: one block of 4 warps, 8 elements a thread; a max tree in
//   the thread, a shuffle tree in the warp, the 4 warps' maxima through
//   shared memory (double-buffered: one barrier an iteration) read as one
//   float4; faster than 1, 8 or 32 warps.  reduce lane: a warp a row, 4
//   elements a lane, a shuffle tree, no barrier (8 warps on 2 SMs).
//   reduce sub: a thread a column, its 8 elements in registers, a max tree
//   and no exchange (4 warps on 1 SM).
// - copy: one warp issues the slice's copy as cp.async, a 512-byte row a
//   step (16 bytes a lane), waits on it, reads slice[0][0], and meets at a
//   warp barrier before the next copy overwrites the slice.  The bulk copy
//   (TMA) of the 16 rows onto an mbarrier, issued by one thread or by 16
//   lanes, is slower: 16 strided rows make 16 requests of the TMA unit.
// - scalar: one thread of a block of 1,024, which write the tile.
// Rolled loops carry `#pragma unroll 1`, so that nvcc does not unroll what
// the TPU arm keeps rolled; the chunk arms unroll their inner loop.  Each
// element's chain runs in one thread in the plain version's order, and a
// max is exact in any order, so the outputs equal the plain version's bit
// for bit whatever the layout.  Built with --fmad=false, so each multiply
// and add rounds on its own, as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;             // the (8, 128) tile
constexpr int kRows = 8;
constexpr int kCols = 128;
constexpr int kBlock = 128;             // threads a block: a warp a scheduler
constexpr int kWarps = kBlock / 32;
constexpr int kFullWarps = 4;           // the full reduce's one block
constexpr int kTableCols = 2048;
constexpr int kSliceRows = 16;
constexpr unsigned kAll = 0xffffffffu;

enum Arm {
  kFlat1, kFlat4, kFlat16, kFlat64, kChunk32, kChunk128, kNested, kBcast,
  kReduceFull, kReduceLane, kReduceSub, kCopy, kScalar, kArms
};

__device__ __forceinline__ float step(float a) { return a * 0.999f + 1e-6f; }

template <int ADDS>
__global__ void __launch_bounds__(kBlock)
loops_flat(const float* __restrict__ x, const float* __restrict__ acc0,
           int n1, float* __restrict__ out) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  float a = acc0[t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
#pragma unroll
    for (int k = 0; k < ADDS; ++k) a = step(a);
  }
  out[t] = a + x[t];
}

__global__ void __launch_bounds__(kBlock)
loops_nested(const float* __restrict__ x, const float* __restrict__ acc0,
             int n1, int n2, float* __restrict__ out) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  float a = acc0[t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i)
#pragma unroll 1
    for (int j = 0; j < n2; ++j) a = step(a);
  out[t] = a + x[t];
}

__global__ void __launch_bounds__(kBlock)
loops_bcast(const float* __restrict__ x, const float* __restrict__ acc0,
            int n1, float* __restrict__ out) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  float a = acc0[t];
  float f = 0.0f;   // float(i), converted one iteration ahead
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    const float next = (float)(i + 1);
    a = a + f;
    f = next;
  }
  out[t] = a + x[t];
}

// the max of v[0..N) as a tree (N a power of two)
template <int N>
__device__ __forceinline__ float tree_max(const float* v) {
  float m[N];
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = v[k];
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) m[k] = fmaxf(m[k], m[k + w]);
  return m[0];
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, s));
  return v;
}

// one block of kFullWarps warps; thread t holds elements j * threads + t
__global__ void __launch_bounds__(kFullWarps * 32)
loops_reduce_full(const float* __restrict__ x,
                  const float* __restrict__ acc0, int n1,
                  float* __restrict__ out) {
  constexpr int kT = kFullWarps * 32, kE = kTile / kT;
  static_assert(kFullWarps == 4, "the warps' maxima are read as a float4");
  __shared__ __align__(16) float part[2][kFullWarps];
  const int t = threadIdx.x;
  float a[kE];
#pragma unroll
  for (int j = 0; j < kE; ++j) a[j] = acc0[j * kT + t];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    float* s = part[i & 1];
    const float w = warp_max(tree_max<kE>(a));
    if ((t & 31) == 0) s[t >> 5] = w;
    __syncthreads();
    const float4 m = *reinterpret_cast<const float4*>(s);
    const float d = fmaxf(fmaxf(m.x, m.y), fmaxf(m.z, m.w)) * 1e-9f;
#pragma unroll
    for (int j = 0; j < kE; ++j) a[j] = a[j] + d;
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) out[j * kT + t] = a[j] + x[j * kT + t];
}

// a warp a row: lane l holds the row's elements k * 32 + l
__global__ void __launch_bounds__(kBlock)
loops_reduce_rows(const float* __restrict__ x,
                  const float* __restrict__ acc0, int n1,
                  float* __restrict__ out) {
  constexpr int kE = kCols / 32;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int base = row * kCols + (threadIdx.x & 31);
  float a[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) a[k] = acc0[base + k * 32];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    const float d = warp_max(tree_max<kE>(a)) * 1e-9f;
#pragma unroll
    for (int k = 0; k < kE; ++k) a[k] = a[k] + d;
  }
#pragma unroll
  for (int k = 0; k < kE; ++k)
    out[base + k * 32] = a[k] + x[base + k * 32];
}

// a thread a column: its kRows elements in registers
__global__ void __launch_bounds__(kBlock)
loops_reduce_cols(const float* __restrict__ x,
                  const float* __restrict__ acc0, int n1,
                  float* __restrict__ out) {
  const int col = blockIdx.x * kBlock + threadIdx.x;
  float a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) a[r] = acc0[r * kCols + col];
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    const float d = tree_max<kRows>(a) * 1e-9f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = a[r] + d;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    out[r * kCols + col] = a[r] + x[r * kCols + col];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// one warp copies the slice, a row a step, 16 bytes a lane; every lane
// keeps the same c
__global__ void __launch_bounds__(32)
loops_copy(const float* __restrict__ x, const float* __restrict__ table,
           int n1, float* __restrict__ out) {
  __shared__ __align__(16) float slice[kSliceRows * kCols];
  const int lane = threadIdx.x;
  float c = 0.0f;
#pragma unroll 1
  for (int i = 0; i < n1; ++i) {
    const float* src = table + (i % 16) * kCols + 4 * lane;
#pragma unroll
    for (int r = 0; r < kSliceRows; ++r)
      cp_async16(slice + r * kCols + 4 * lane, src + r * kTableCols);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    c = c + *(volatile float*)slice;
    __syncwarp();   // the next copy overwrites the slice
  }
  for (int j = lane; j < kTile; j += 32) out[j] = x[j] + c;
}

// one block of kTile threads: thread 0 loops, all write the tile
__global__ void __launch_bounds__(kTile)
loops_scalar(const float* __restrict__ x, int n1, float* __restrict__ out) {
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
// floats; table (16, 2048) floats, 16-byte aligned, read by the copy arm
// only; n2 is the nested arm's inner trip count.
extern "C" int diag_loops_launch(int arm, const float* x, const float* acc0,
                                 const float* table, int n1, int n2,
                                 float* out, void* stream) {
  if (arm < 0 || arm >= kArms || n1 < 0 || n2 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int kGrid = kTile / kBlock;
  switch (arm) {
    case kFlat1: loops_flat<1><<<kGrid, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kFlat4: loops_flat<4><<<kGrid, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kFlat16:
      loops_flat<16><<<kGrid, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kFlat64:
      loops_flat<64><<<kGrid, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kChunk32:
      loops_flat<32><<<kGrid, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kChunk128:
      loops_flat<128><<<kGrid, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kNested:
      loops_nested<<<kGrid, kBlock, 0, st>>>(x, acc0, n1, n2, out);
      break;
    case kBcast: loops_bcast<<<kGrid, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kReduceFull:
      loops_reduce_full<<<1, kFullWarps * 32, 0, st>>>(x, acc0, n1, out);
      break;
    case kReduceLane:
      loops_reduce_rows<<<kRows / kWarps, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kReduceSub:
      loops_reduce_cols<<<kCols / kBlock, kBlock, 0, st>>>(x, acc0, n1, out);
      break;
    case kCopy: loops_copy<<<1, 32, 0, st>>>(x, table, n1, out);
      break;
    default: loops_scalar<<<1, kTile, 0, st>>>(x, n1, out);
      break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* diag_loops_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
