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
// (ray, triangle) pair); the rows (48 bytes a triangle) come from L2, the
// rays' inputs and the maps are 4-28 bytes a pixel.  Design: one thread
// per ray; a tile's 2,048 rays are spread over 8 blocks of 256 threads,
// and every block of a tile reads the same list.  For each listed box the
// block copies the box's rows (at most 128 at a time) into shared memory
// with a plain cooperative load between two barriers, then every lane
// tests them (a broadcast read: every lane the same row).  The table keeps
// each box's rows contiguous, 16 floats a row, so a box of 10-15 grid
// triangles costs 10-15 rows and not the TPU's 128-lane column; exactly
// `count` rows are scanned, no NaN padding row is needed (CUDA's
// fminf/fmaxf would drop a NaN).  A lane stops testing once it is
// occluded, and a block leaves the walk when all its lanes are.  The row
// math is pt_device.cuh's row_quads / quads_valid, the JAX package's
// operation order, built with --fmad=false.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 64;             // the TPU's 64 x 32 pixel tile
constexpr int kTileH = 32;
constexpr int kTileRays = kTileW * kTileH;
constexpr int kThreads = 256;
constexpr int kBlocksPerTile = kTileRays / kThreads;
constexpr int kStage = 128;            // rows staged per shared-memory pass
constexpr float kMissT = 3e38f;        // _BIGF

struct Walk {
  const int* llen;    // (n_tiles,) list lengths
  const int* ids;     // (n_tiles, lmax) box ids
  int lmax;
  const int* start;   // (n_boxes,) first row of each box
  const int* count;   // (n_boxes,) rows of each box
  const float4* rows; // (n_rows, 4) float4: v0.xyz e0.x | e0.yz e2.xy |
                      // e2.z n.xyz | original index, 3 zeros
};

// The pixel of this thread: tile-major, 64 pixels a row inside the tile.
__device__ __forceinline__ int pixel(int tiles_x, int width, int& tile) {
  tile = blockIdx.x / kBlocksPerTile;
  const int idx = (blockIdx.x % kBlocksPerTile) * kThreads + threadIdx.x;
  const int px = (tile % tiles_x) * kTileW + idx % kTileW;
  const int py = (tile / tiles_x) * kTileH + idx / kTileW;
  return py * width + px;
}

// Stage rows [s, s + n) of the table (one linear copy of 4n float4s).
__device__ __forceinline__ void stage(float4* srows, const float4* rows,
                                      int s, int n) {
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * n; i += kThreads)
    srows[i] = rows[4 * s + i];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
dda_closest_kernel(Walk W, const float* __restrict__ cam, int tiles_x,
                   int width, float* __restrict__ t_out,
                   int* __restrict__ m_out) {
  __shared__ float4 srows[4 * kStage];
  __shared__ float scam[12];
  if (threadIdx.x < 12) scam[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();
  int tile;
  const int p = pixel(tiles_x, width, tile);
  const float ii = (float)(p % width), jj = (float)(p / width);
  const Ray r = camera_ray(scam, ii, jj, 0.5f, 0.5f, 0.5f, 0.5f);
  float bn = kMissT, bd = 1.0f, bi = -1.0f;
  int m = 0;
  const int n_list = W.llen[tile];
  for (int k = 0; k < n_list; ++k) {
    const int box = W.ids[tile * W.lmax + k];
    const int s = W.start[box], cnt = W.count[box];
    for (int c0 = 0; c0 < cnt; c0 += kStage) {
      const int cn = min(kStage, cnt - c0);
      stage(srows, W.rows, s + c0, cn);
      for (int j = 0; j < cn; ++j) {
        const Quads q = row_quads(srows[4 * j], srows[4 * j + 1],
                                  srows[4 * j + 2], r.ox, r.oy, r.oz, r.dx,
                                  r.dy, r.dz);
        const float idx = srows[4 * j + 3].x;
        const float num = q.tn_s * bd, den = bn * q.dd;
        if (quads_valid(q, false) &&
            (num < den || (num == den && idx < bi))) {
          bn = q.tn_s;
          bd = q.dd;
          bi = idx;
          m = 4;
        }
      }
    }
  }
  t_out[p] = m == 4 ? bn / bd : kMissT;
  m_out[p] = m;
}

__global__ void __launch_bounds__(kThreads)
dda_occ_kernel(Walk W, const float* __restrict__ o,
               const float* __restrict__ d, const float* __restrict__ tl,
               int tiles_x, int width, int* __restrict__ occ_out) {
  __shared__ float4 srows[4 * kStage];
  int tile;
  const int p = pixel(tiles_x, width, tile);
  const float ox = o[3 * p], oy = o[3 * p + 1], oz = o[3 * p + 2];
  const float dx = d[3 * p], dy = d[3 * p + 1], dz = d[3 * p + 2];
  const float lim = tl[p];
  bool occ = false;
  const int n_list = W.llen[tile];
  for (int k = 0; k < n_list; ++k) {
    if (__syncthreads_and(occ)) break;   // uniform: every lane occluded
    const int box = W.ids[tile * W.lmax + k];
    const int s = W.start[box], cnt = W.count[box];
    for (int c0 = 0; c0 < cnt; c0 += kStage) {
      const int cn = min(kStage, cnt - c0);
      stage(srows, W.rows, s + c0, cn);
      for (int j = 0; j < cn && !occ; ++j) {
        const Quads q = row_quads(srows[4 * j], srows[4 * j + 1],
                                  srows[4 * j + 2], ox, oy, oz, dx, dy, dz);
        occ = quads_valid(q, false) && q.tn_s < lim * q.dd;
      }
    }
  }
  occ_out[p] = occ ? 1 : 0;
}

}  // namespace

// Launch on `stream`; return cudaGetLastError() (0 on success).  The image
// is tiles_x x tiles_y tiles of 64 x 32 pixels; maps are row-major
// (height, width).
extern "C" int diag_dda_closest_launch(const int* llen, const int* ids,
                                       int lmax, const int* start,
                                       const int* count, const float* rows,
                                       const float* cam, int tiles_x,
                                       int tiles_y, float* t_out, int* m_out,
                                       void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return 0;
  const Walk W{llen, ids, lmax, start, count,
               reinterpret_cast<const float4*>(rows)};
  dda_closest_kernel<<<n_tiles * kBlocksPerTile, kThreads, 0,
                       (cudaStream_t)stream>>>(W, cam, tiles_x,
                                               tiles_x * kTileW, t_out,
                                               m_out);
  return (int)cudaGetLastError();
}

extern "C" int diag_dda_occ_launch(const int* llen, const int* ids, int lmax,
                                   const int* start, const int* count,
                                   const float* rows, const float* o,
                                   const float* d, const float* tl,
                                   int tiles_x, int tiles_y, int* occ_out,
                                   void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (n_tiles <= 0) return 0;
  const Walk W{llen, ids, lmax, start, count,
               reinterpret_cast<const float4*>(rows)};
  dda_occ_kernel<<<n_tiles * kBlocksPerTile, kThreads, 0,
                   (cudaStream_t)stream>>>(W, o, d, tl, tiles_x,
                                           tiles_x * kTileW, occ_out);
  return (int)cudaGetLastError();
}

extern "C" const char* diag_dda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
