// The per-tile cell-list walk of the grid diagnostic: closest hit of the
// pinhole primary rays (kernel B8-dda-closest) and any-hit occlusion of
// given segments (kernel B8-dda-occ), each over a per-tile list of boxes
// whose triangle rows it scans.
//
// Replaces the TPU kernels of tools/diag_dda_pallas.py: make_pallas_fn ->
// _dda_kernel and make_occ_fn -> _occ_kernel.  Per 64x32 pixel tile the
// host lists the boxes (occupied grid cells, or Morton blocks, or every
// 128-row block for the dense twin) that any of the tile's rays crosses;
// the kernel walks the list and tests each listed box's rows against every
// ray of the tile: the division-free closest-hit row test with the running
// minimum carried det-scaled as (bn, bd) and a strict < (_tri_closest_row,
// ops/pallas_super.py:181-216), or the occlusion row test against the
// per-ray limit tl (_tri_occ_row, :271-295).  One change from the TPU
// kernel: an exact tie of the cross-multiplied comparison goes to the
// lowest original triangle index (the large-mesh kernel's rule,
// _tri_closest_row_blocked, :222-264), so the map does not depend on the
// order in which a structure lists the triangles - the cell, Morton and
// dense walks give the same t map bit for bit, where the TPU kernel's
// differ by an ulp at a few shared edges.  The closest kernel makes its
// rays itself: the thin-lens camera with all four uniforms at 0.5 (a
// pinhole through the pixel centre); it returns t = bn / bd where a
// triangle was hit (m = 4), else 3e38, and m.  The occlusion kernel returns
// 0/1.
//
// What bounds it on an H100: FP32 issue in the row tests (48 operations a
// (ray, triangle) pair, ~70 instructions with the compares, selects and
// shared-memory reads); the rows (64 bytes a triangle) come from L2, the
// rays' inputs and the maps are 4-28 bytes a pixel.  Design:
// - A block of 256 threads, one ray each, takes an eighth of a tile's
//   2,048 rays, as the parent design did: when few tiles have work (the
//   demo scene lists rows in 4 of 128 tiles), a tile's rays need the 8
//   warps a block and the 8 SMs a tile to hide the row test's latency.
//   Two rays a thread issue fewer instructions a pair but halve those
//   warps, and ran such lists up to 2.8x slower.  Each ray's chain runs
//   in list order, then row order, in one thread, so the maps equal the
//   plain versions' bit for bit whatever the staging and the schedule.
// - The tile's rows, in walk order, pass through a ring of three 128-row
//   stages that cp.async (16 bytes) fills from the table while the block
//   tests the stage before: a barrier belongs to a stage of 128 rows and
//   not to a box of ~10, and no copy is exposed but the first.  A stage is
//   a gather of the boxes' row runs: the block holds up to 256 list
//   entries at a time in shared memory as running row totals, and a
//   thread copies one row, found by a binary search of its position.
// - Tiles list 0.7-1.25x their mean rows (20k sheet, 512x512).  Block b
//   takes tile order[b / 8], where `order` is the tiles by descending
//   listed rows (ops/diag_dda.py::ranked, made once per set of lists): the
//   hardware dispatches blocks in index order, so the longest tiles start
//   first and the short ones fill the tail (longest-processing-time
//   order).  Without an order block b takes tile b / 8.
// - The occlusion kernel leaves a stage when every ray of its warp is
//   occluded (a warp vote every second row) and the walk when every ray
//   of its block is (a vote at each stage's barrier).
// The row math is pt_device.cuh's row_quads / quads_valid, the JAX
// package's operation order, built with --fmad=false.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 64;             // the TPU's 64 x 32 pixel tile
constexpr int kTileH = 32;
constexpr int kTileRays = kTileW * kTileH;
constexpr int kThreads = 256;          // a block, a ray a thread
constexpr int kUnitsPerTile = kTileRays / kThreads;
constexpr int kMinBlocks = 4;          // resident an SM (<= 64 registers)
constexpr int kStage = 128;            // rows a stage
constexpr int kRing = 3;               // stages in flight
constexpr int kListChunk = 256;        // list entries held at a time
constexpr float kMissT = 3e38f;        // _BIGF
static_assert(kStage <= kThreads, "a stage is at most a row a thread");

struct Walk {
  const int* llen;    // (n_tiles,) list lengths
  const int* ids;     // (n_tiles, lmax) box ids
  int lmax;
  const int* start;   // (n_boxes,) first row of each box
  const int* count;   // (n_boxes,) rows of each box
  const float4* rows; // (n_rows, 4) float4: v0.xyz e0.x | e0.yz e2.xy |
                      // e2.z n.xyz | original index, 3 zeros
};

// The pinhole camera, by value: up, right, eye_offset, pos.
struct Cam {
  float v[12];
};

// Work tally of the counting instantiation (kStats), one set a warp (lane
// 0's clock64 readings; the pair counts over its 32 lanes), added to the
// stats buffer at the end.  [0] (ray, row) pairs the warp tests (32 x the
// rows it runs), [1] pairs needed (closest: every listed pair; occlusion:
// each ray's rows up to its first occluder), [2] rows copied into shared
// memory and [3] stages, summed over blocks; clock64 cycles [4] loading
// the list and issuing copies, [5] waiting for copies, [6] in barriers,
// [7] in row tests, [8] in the whole kernel.  The timed instantiation
// keeps none of it.
constexpr int kStatSlots = 9;

template <bool kStats>
struct Tally {
  unsigned long long v[kStatSlots] = {};
  __device__ __forceinline__ long long clock() { return clock64(); }
  __device__ __forceinline__ void add(int slot, long long n) { v[slot] += n; }
  // slot += the lanes for which `lane` holds
  __device__ __forceinline__ void lanes(int slot, bool lane) {
    v[slot] += (unsigned)__popc(__ballot_sync(kAll, lane));
  }
  __device__ __forceinline__ void flush(unsigned long long* stats) {
    if ((threadIdx.x & 31) != 0) return;
    for (int i = 0; i < kStatSlots; ++i) atomicAdd(stats + i, v[i]);
  }
};

template <>
struct Tally<false> {
  __device__ __forceinline__ long long clock() { return 0; }
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ void lanes(int, bool) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A block's shared memory: the ring of stages, and one chunk of its tile's
// list as running row totals (end) and each box's first table row less
// its first position in the chunk's walk (base).
struct Smem {
  float4 ring[kRing][4 * kStage];
  int end[kListChunk];
  int base[kListChunk];
};

// This block's tile (block b takes rays [(b % kUnitsPerTile) * kThreads,
// ...) of tile order[b / kUnitsPerTile], or of tile b / kUnitsPerTile
// without an order) and this thread's pixel (row-major index).
__device__ __forceinline__ int tile_pixel(const int* order, int tiles_x,
                                          int width, int& tile) {
  const int u = blockIdx.x / kUnitsPerTile;
  tile = order ? order[u] : u;
  const int idx = (blockIdx.x % kUnitsPerTile) * kThreads + threadIdx.x;
  const int px = (tile % tiles_x) * kTileW + idx % kTileW;
  const int py = (tile / tiles_x) * kTileH + idx / kTileW;
  return py * width + px;
}

// Load list entries [k0, k0 + kListChunk) of `tile` into the chunk arrays
// (entries past the list's n_list count no rows); returns the chunk's
// rows.  The ids are read whether or not the list reaches them (the
// table is lmax wide), so their loads overlap the list length's; the
// boxes they name are read only for listed entries.  Begins and ends
// with a barrier.
__device__ int load_chunk(const Walk& W, int tile, int k0, int n_list,
                          Smem& S) {
  __syncthreads();   // the previous chunk is no longer read
  const int width = min(kListChunk, W.lmax - k0);
  for (int i = threadIdx.x; i < width; i += kThreads) {
    const int box = W.ids[(size_t)tile * W.lmax + k0 + i];
    const bool listed = k0 + i < n_list;   // padding ids name no box read
    S.end[i] = listed ? W.count[box] : 0;
    S.base[i] = listed ? W.start[box] : 0;
  }
  __syncthreads();
  const int nk = min(kListChunk, n_list - k0);
  if (nk <= 0) return 0;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int b = 0; b < nk; b += 32) {
      const int i = b + lane;
      const int cnt = i < nk ? S.end[i] : 0;
      int v = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kAll, v, off);
        if (lane >= off) v += u;
      }
      if (i < nk) {
        const int end = carry + v;
        S.base[i] -= end - cnt;
        S.end[i] = end;
      }
      carry += __shfl_sync(kAll, v, 31);
    }
  }
  __syncthreads();
  return S.end[nk - 1];
}

// Copy stage st of the chunk (its positions [st * kStage, ...) < total)
// into its ring slot, a row a thread, each row found by a binary search of
// its position among the chunk's nk entries, and commit the group (empty
// past the end, so that every thread commits one group a stage).
__device__ __forceinline__ void issue(const Walk& W, Smem& S, int nk,
                                      int total, int st) {
  const int p = st * kStage + (int)threadIdx.x;
  if (threadIdx.x < kStage && p < total) {
    int lo = 0, hi = nk - 1;   // the first entry whose end exceeds p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (S.end[mid] > p) hi = mid;
      else lo = mid + 1;
    }
    const float4* src = W.rows + 4 * (size_t)(S.base[lo] + p);
    float4* dst = S.ring[st % kRing] + 4 * threadIdx.x;
#pragma unroll
    for (int q = 0; q < 4; ++q) cp_async16(dst + q, src + q);
  }
  cp_async_commit();
}

// The walk over the tile's rows shared by both kernels: for each stage,
// `test(rows, n)` on its n rows in shared memory; `barrier()` is the
// stage's barrier and returns true to leave the walk (the occlusion
// kernel's block vote).
template <bool kStats, typename Test, typename Barrier>
__device__ __forceinline__ void walk(const Walk& W, int tile, Smem& S,
                                     Tally<kStats>& T, Test test,
                                     Barrier barrier) {
  const int n_list = W.llen[tile];
  bool left = false;
  int k0 = 0;
  do {   // the first chunk's loads go out with the list length's
    long long c0 = T.clock();
    const int total = load_chunk(W, tile, k0, n_list, S);
    const int nk = min(kListChunk, n_list - k0);
    const int n_st = (total + kStage - 1) / kStage;
    for (int s = 0; s < kRing - 1; ++s) issue(W, S, nk, total, s);
    T.add(4, T.clock() - c0);
    for (int st = 0; st < n_st; ++st) {
      c0 = T.clock();
      cp_async_wait<kRing - 2>();
      const long long c1 = T.clock();
      left = barrier();
      const long long c2 = T.clock();
      T.add(5, c1 - c0);
      T.add(6, c2 - c1);
      if (left) break;
      issue(W, S, nk, total, st + kRing - 1);
      const long long c3 = T.clock();
      T.add(4, c3 - c2);
      const int n = min(kStage, total - st * kStage);
      if (threadIdx.x < 32) {
        T.add(2, n);
        T.add(3, 1);
      }
      test(S.ring[st % kRing], n);
      T.add(7, T.clock() - c3);
    }
    k0 += kListChunk;
  } while (k0 < n_list && !left);
  cp_async_wait<0>();
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dda_closest_kernel(Walk W, const int* __restrict__ order, Cam cam,
                   int tiles_x, int width, float* __restrict__ t_out,
                   int* __restrict__ m_out,
                   unsigned long long* __restrict__ stats) {
  Tally<kStats> T;
  const long long k0 = T.clock();
  __shared__ Smem S;
  int tile;
  const int p = tile_pixel(order, tiles_x, width, tile);
  const Ray r = camera_ray(cam.v, (float)(p % width), (float)(p / width),
                           0.5f, 0.5f, 0.5f, 0.5f);
  float bn = kMissT, bd = 1.0f, bi = -1.0f;
  int m = 0;
  walk(W, tile, S, T,
       [&](const float4* sr, int n) {
#pragma unroll 8
         for (int j = 0; j < n; ++j) {
           const Quads q = row_quads(sr[4 * j], sr[4 * j + 1], sr[4 * j + 2],
                                     r.ox, r.oy, r.oz, r.dx, r.dy, r.dz);
           const float idx = sr[4 * j + 3].x;
           const float num = q.tn_s * bd, den = bn * q.dd;
           // selects, not a branch: the update is rare, and a branch a row
           // costs more than the four selects
           const bool upd = quads_valid(q, false) &&
                            (num < den || (num == den && idx < bi));
           bn = upd ? q.tn_s : bn;
           bd = upd ? q.dd : bd;
           bi = upd ? idx : bi;
           m = upd ? 4 : m;
         }
         T.add(0, 32 * n);
         T.add(1, 32 * n);
       },
       [&]() {
         __syncthreads();
         return false;
       });
  t_out[p] = m == 4 ? bn / bd : kMissT;
  m_out[p] = m;
  T.add(8, T.clock() - k0);
  T.flush(stats);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dda_occ_kernel(Walk W, const int* __restrict__ order,
               const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ tl,
               int tiles_x, int width, int* __restrict__ occ_out,
               unsigned long long* __restrict__ stats) {
  Tally<kStats> T;
  const long long k0 = T.clock();
  __shared__ Smem S;
  int tile;
  const int p = tile_pixel(order, tiles_x, width, tile);
  const float ox = o[3 * p], oy = o[3 * p + 1], oz = o[3 * p + 2];
  const float dx = d[3 * p], dy = d[3 * p + 1], dz = d[3 * p + 2];
  const float lim = tl[p];
  bool occ = false;
  walk(W, tile, S, T,
       [&](const float4* sr, int n) {
         int j = 0;
#pragma unroll 8
         for (; j < n; ++j) {
           // the warp is done: a vote every second row (one a row costs
           // more than the rows it saves)
           if (!(j & 1) && __all_sync(kAll, occ)) break;
           T.lanes(1, !occ);
           const Quads q = row_quads(sr[4 * j], sr[4 * j + 1], sr[4 * j + 2],
                                     ox, oy, oz, dx, dy, dz);
           occ = occ | (quads_valid(q, false) && q.tn_s < lim * q.dd);
         }
         T.add(0, 32 * j);
       },
       [&]() { return __syncthreads_and(occ) != 0; });
  occ_out[p] = occ ? 1 : 0;
  T.add(8, T.clock() - k0);
  T.flush(stats);
}

// The walk kernel: kUnitsPerTile blocks a tile.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Walk& W, int n_tiles, const int* order,
           cudaStream_t stream, Args... args) {
  kernel<<<n_tiles * kUnitsPerTile, kThreads, 0, stream>>>(W, order,
                                                           args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 on success).  The image
// is tiles_x x tiles_y tiles of 64 x 32 pixels; maps are row-major
// (height, width).  `cam` is 12 floats in host memory (the closest
// kernel takes them by value); `rows` is 16-byte aligned (cp.async);
// `order`, when not null, is a permutation of the tiles_x * tiles_y tiles,
// the order in which the blocks take them.  `stats`, when not null, is a
// zeroed buffer of kStatSlots 64-bit counters: the counting instantiation
// runs and adds its tally there.
extern "C" int diag_dda_closest_launch(const int* llen, const int* ids,
                                       int lmax, const int* start,
                                       const int* count, const float* rows,
                                       const float* cam, int tiles_x,
                                       int tiles_y, float* t_out, int* m_out,
                                       const int* order, void* stats,
                                       void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return 0;
  const Walk W{llen, ids, lmax, start, count,
               reinterpret_cast<const float4*>(rows)};
  Cam c;
  for (int i = 0; i < 12; ++i) c.v[i] = cam[i];
  auto* st = reinterpret_cast<unsigned long long*>(stats);
  return stats ? launch(dda_closest_kernel<true>, W, n_tiles, order,
                        (cudaStream_t)stream, c, tiles_x, tiles_x * kTileW,
                        t_out, m_out, st)
               : launch(dda_closest_kernel<false>, W, n_tiles, order,
                        (cudaStream_t)stream, c, tiles_x, tiles_x * kTileW,
                        t_out, m_out, st);
}

extern "C" int diag_dda_occ_launch(const int* llen, const int* ids, int lmax,
                                   const int* start, const int* count,
                                   const float* rows, const float* o,
                                   const float* d, const float* tl,
                                   int tiles_x, int tiles_y, int* occ_out,
                                   const int* order, void* stats,
                                   void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return 0;
  const Walk W{llen, ids, lmax, start, count,
               reinterpret_cast<const float4*>(rows)};
  auto* st = reinterpret_cast<unsigned long long*>(stats);
  return stats ? launch(dda_occ_kernel<true>, W, n_tiles, order,
                        (cudaStream_t)stream, o, d, tl, tiles_x,
                        tiles_x * kTileW, occ_out, st)
               : launch(dda_occ_kernel<false>, W, n_tiles, order,
                        (cudaStream_t)stream, o, d, tl, tiles_x,
                        tiles_x * kTileW, occ_out, st);
}

// Resident blocks an SM of the timed closest (which = 0) or occlusion (1)
// kernel, and its threads a block in *threads.
extern "C" int diag_dda_occupancy(int which, int* threads) {
  int n = 0;
  *threads = kThreads;
  if (which == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, dda_closest_kernel<false>, kThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, dda_occ_kernel<false>, kThreads, 0);
  return n;
}

extern "C" const char* diag_dda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
