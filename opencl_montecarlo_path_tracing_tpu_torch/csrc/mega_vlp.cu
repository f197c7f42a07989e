// VLP megakernel: the whole render pass of the bidirectional / metropolis /
// metropolis_vlpgrid family, all spp, in one kernel (kernel B4 of the port).
//
// Replaces the TPU kernel opencl_montecarlo_path_tracing_tpu/ops/
// pallas_bpt.py::film_vlp_mega -> _vlp_mega_kernel.  For every pixel of the
// band [row_offset, row_offset+rows) x [0, W) it sums `spp` samples with
// global sample index s + spp_offset of spp_total and writes the
// pre-ambient film * EXPOSURE once.  Per sample: B1's camera and closest
// hit (csrc/pt_device.cuh); on floor and diffuse hits the VLP gather
// sum_v max(n.(p-x), 0)/d * min(I/d^2, 1) over the first n_live rows of the
// live-first compacted VLP table (in grid mode only the VLPs whose clipped
// cell-index box holds the shading point's cell, an uncapped masked scan),
// min(., 1), minus 1/nlights for every light whose jittered shadow ray is
// occluded before the UN-jittered light distance, times 1/4; then the
// 4-material shading.  There is no lamb < 0 skip on the shadow rays: the
// correction is subtracted whatever the facing (bidirectional.py:77-81).
//
// What bounds it on an H100: FP32 issue.  A sample costs ~48 FLOP per
// (ray, triangle) pair its primary trace and capped occlusion scans test
// (~80 SASS instructions a row test), plus ~20 FLOP and a square root and
// a division per (lit sample, live VLP) pair; typical tables are ~1% live
// (the demo scene emits 6 live rows of 1024), the dense_vlp_scene's ~47%.
// Memory traffic is the table (32 or 48 bytes a row) and the 12-byte film
// write per pixel.
//
// Design.  One thread per pixel, the film sum in registers across the spp
// loop; a warp on a compact 8x4 pixel patch (a block of 4 warps on 16x8),
// so that its rays are coherent.  The scene is staged once per block in
// shared memory.  The triangles are scanned in index-order blocks of 32
// rows, each with a padded box (ops/mega_vlp.py::tri_block_boxes): the
// warp votes with __any_sync over the conservative predicates of
// pt_device.cuh (box_closest against the running best for the camera
// rays, box_occ against the light distance for each light's shadow rays),
// first on the mesh's box (the union of the blocks'), then on each block,
// and scans a block only when some lane may hit in it.  Lanes that do not
// trace (ghost pixels past the film edge) or cast (sky, facing-ratio and
// mirror hits) vote no, and every lane reaches every vote.  A block that no lane's
// ray can enter cannot change a running best or an any-hit, and the blocks
// keep index order (an exact tie keeps the earlier triangle), so the film
// is bit-equal to the same kernel without the cull (the kCull = false
// instantiation, every block scanned, the parent design's scans).  The VLP
// table's live rows are staged in shared memory once per launch when they
// fit `chunk` rows (the wrapper's budget), else streamed chunk by chunk
// every sample; every thread of the block scans them in the same order (a
// broadcast read per row).  n_live is read on the device, so the host never
// waits.  An occlusion walk ends when every casting lane is occluded.  The
// arithmetic keeps the JAX kernel's operation order, with 1.0f / sqrtf
// where it uses rsqrt; built with --fmad=false and without fast math.
//
// Past 512 triangles (the kWalk instantiation; `force_walk` in the wrapper
// picks it on any mesh) the table does not fit shared memory beside a VLP
// chunk: shared memory holds only the scene without triangles, the grid's
// frame and the VLP chunk, and the camera ray's closest hit and each
// light's capped shadow ray walk an exact uniform grid of the mesh
// (ops/exact_grid.py: every (cell, triangle) overlap, the rows cell-major
// with their original indices, an occupancy bitmap; built once per
// prepared scene) in device memory, one lane a ray, through
// pt_device.cuh::exact_walk: a 3-D DDA that ends when the running best
// lies before the current cell's exit (a shadow ray at its first hit, or
// past its cap), exact ties to the lowest original index, carried from -1.
// The walks step over runs of empty cells in an inner loop, each lane at
// its own pace, so that a warp's lanes test their occupied cells
// together.  Why a grid: on the 20,736-triangle sheet a walk tests ~32
// pairs, where a walk of the Morton block tables behind per-warp votes
// tested ~326 a sample (PERF.md, B9).  The lanes that walk are those
// that voted above (inside pixels for the camera rays, lit samples for
// the shadow rays), and the gather, shading, RNG sites and spp loop are
// the same code.  The film is the same function; the walk visits the
// triangles in another order, so it is held to the plain version under
// the CRN contract, not bit for bit.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 16;      // block tile: 16 x 8 pixels,
constexpr int kTileH = 8;       // warp w on the 8 x 4 patch (w&1, w>>1)
constexpr int kBlock = kTileW * kTileH;
constexpr int kTriRows = 32;    // triangle rows a culled block

// Work tally of the counting instantiation (kStats).  Cycle slots
// (clock64, the warp's: lane 0's reading) [kCamRest] the camera trace's
// floor, squares and spheres, [kCamTri] its triangles (the shared-memory
// route's votes and scans, or the walk), [kGather] the VLP gather,
// [kShadowRest] the shadow rays' floor, squares and spheres, [kShadowTri]
// their triangles, [kStage] the VLP table's staging with its
// __syncthreads, [kKernel] the whole kernel; count slots (summed over
// lanes) [kLit] lit hits (floor, diffuse), [kCasts] shadow rays cast (a
// lit hit and a light), [kCastsTri] casts that reach the triangles (not
// occluded by the floor, squares or spheres), [kTested] (ray, triangle)
// pairs the warps pay (32 lanes x the rows a warp scans, or on the walk x
// its pair iterations), [kGatherPairs] (lit sample, VLP) terms gathered
// (in grid mode those in the shading point's cell); on the walk route (0
// on the other), summed over lanes, [kWalks] grid walks (camera rays of
// inside pixels, casts that reach the triangles), [kEntered] walks that
// enter the grid, [kCells] cells visited, [kEmpty] visited cells with no
// triangle, [kPairs] (ray, triangle) pairs the lanes test (the bound's
// work); lane 0's clock64 split of the walks' cycles (warp-uniform stamps
// of the lockstep walk, pt_device.cuh's WalkStage): [kClkSetup] the DDA
// set-up, [kClkEmpty] iterations in which no lane tests a pair (empty
// cells and their steps), [kClkLoads] the occupied cells' row loads,
// [kClkPairs] the pair arithmetic, [kClkStep] the occupied cells' end
// tests and steps.  The timed instantiations keep none of it.
enum Slot {
  kCamRest, kCamTri, kGather, kShadowRest, kShadowTri, kStage, kKernel,
  kLit, kCasts, kCastsTri, kTested, kGatherPairs,
  kWalks, kEntered, kCells, kEmpty, kPairs,
  kClkSetup, kClkEmpty, kClkLoads, kClkPairs, kClkStep, kStatSlots
};

template <bool kStats>
struct Tally {
  static constexpr bool kLockstep = true;
  unsigned long long v[kStatSlots] = {};
  long long last = 0;   // the last stamp of the walk's clock split
  __device__ __forceinline__ void add(int slot, long long n) { v[slot] += n; }
  __device__ __forceinline__ long long clock() { return clock64(); }
  // the hooks of pt_device.cuh::exact_walk
  __device__ __forceinline__ void begin() {
    __syncwarp();
    last = clock64();
  }
  __device__ __forceinline__ void walk(bool live, bool go) {
    v[kWalks] += live;
    v[kEntered] += go;
  }
  __device__ __forceinline__ void cell(bool full) {
    v[kCells] += 1;
    v[kEmpty] += !full;
  }
  __device__ __forceinline__ void pairs(int n) { v[kPairs] += n; }
  __device__ __forceinline__ void round() { v[kTested] += 1; }
  __device__ __forceinline__ void stamp(int stage) {
    __syncwarp();
    const long long now = clock64();
    v[kClkSetup + stage] += (unsigned long long)(now - last);
    last = now;
  }
  __device__ __forceinline__ void loaded(unsigned x) {
    wait_for(x);
    stamp(kStageLoads);
  }
  // every lane of the warp calls it once, at the end
  __device__ __forceinline__ void flush(unsigned long long* stats) {
    for (int i = kLit; i <= kPairs; ++i)
      for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(kAll, v[i], o);
    if ((threadIdx.x & 31) != 0) return;
    for (int i = 0; i < kStatSlots; ++i) atomicAdd(stats + i, v[i]);
  }
};

template <>
struct Tally<false> {
  static constexpr bool kLockstep = false;
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ long long clock() { return 0; }
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void walk(bool, bool) {}
  __device__ __forceinline__ void cell(bool) {}
  __device__ __forceinline__ void pairs(int) {}
  __device__ __forceinline__ void round() {}
  __device__ __forceinline__ void stamp(int) {}
  __device__ __forceinline__ void loaded(unsigned) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

// The triangle blocks: 2 float4 a record (lo.xyz row count | hi.xyz 0),
// record 0 the mesh (the union of the blocks' boxes), then the n blocks.
struct TriBlocks {
  const float4* boxes;
  int n;
};

// The triangles of an instantiation: the shared-memory table's blocks, or
// past 512 triangles (kWalk) the exact grid in device memory.
template <bool kWalk> struct TriSource { using type = TriBlocks; };
template <> struct TriSource<true> { using type = XGrid; };
template <bool kWalk> using Tris = typename TriSource<kWalk>::type;

// Closest hit over floor, squares, spheres and the triangle blocks
// (pt_device.cuh::trace's arithmetic and order), or the walk.  `active`
// lanes vote and update; the others vote no and return the non-triangle
// hit.
template <bool kStats, bool kCull, bool kWalk>
__device__ Hit trace_vlp(const Scene& S, const Tris<kWalk>& B, float ox,
                         float oy, float oz, float dx, float dy, float dz,
                         bool neg_t, bool active, Tally<kStats>& T) {
  const long long c0 = T.clock();
  PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, kBig, neg_t, 3);
  const long long c1 = T.clock();
  if constexpr (kWalk) {
    float bn = h.t, bd = 1.0f;
    int bi = -1;
    exact_walk<false, true>(B, active, ox, oy, oz, dx, dy, dz, neg_t, 0.0f,
                            bn, bd, bi, h, T);
    h.t = bn / bd;
  } else if (S.ntp) {
    const RayInv ri = ray_inv(ox, oy, oz, dx, dy, dz);
    float bn = h.t, bd = 1.0f;
    const float4* rows = reinterpret_cast<const float4*>(S.tri);
    // a warp none of whose rays enters the mesh's box skips its blocks
    int nb = B.n;
    if (kCull && nb > 1 &&
        !__any_sync(kAll, active && box_closest(__ldg(B.boxes),
                                                __ldg(B.boxes + 1), ri, bn,
                                                bd, neg_t)))
      nb = 0;
    for (int b = 0; b < nb; ++b) {
      const float4 lo = __ldg(B.boxes + 2 * b + 2);
      bool need = active;
      if constexpr (kCull)
        need = need && box_closest(lo, __ldg(B.boxes + 2 * b + 3), ri, bn,
                                   bd, neg_t);
      if (!__any_sync(kAll, need)) continue;
      const int r0 = kTriRows * b, r1 = r0 + __float_as_int(lo.w);
      T.add(kTested, r1 - r0);
      if (!active) continue;
#pragma unroll 2
      for (int i = r0; i < r1; ++i) {
        const float4 a = rows[3 * i];      // v0.xyz, e0.x
        const float4 c = rows[3 * i + 1];  // e0.yz, e2.xy
        const float4 e = rows[3 * i + 2];  // e2.z, n.xyz
        const Quads q = row_quads(a, c, e, ox, oy, oz, dx, dy, dz);
        if (quads_valid(q, neg_t) && q.tn_s * bd < bn * q.dd) {
          bn = q.tn_s;
          bd = q.dd;
          h.m = 4;
          h.nx = e.y;
          h.ny = e.z;
          h.nz = e.w;
          h.needs = false;
        }
      }
    }
    h.t = bn / bd;
  }
  T.add(kCamRest, c1 - c0);
  T.add(kCamTri, T.clock() - c1);
  return finish(h);
}

// Any-hit occlusion below t_limit over floor, squares, spheres and the
// triangle blocks (pt_device.cuh::occluded's arithmetic), or the walk, for
// `cast` lanes (the others return false).  The block scan ends when every
// casting lane is occluded, a lane's walk at its first hit.
template <bool kStats, bool kCull, bool kWalk>
__device__ bool occluded_vlp(const Scene& S, const Tris<kWalk>& B, float ox,
                             float oy, float oz, float dx, float dy,
                             float dz, float t_limit, bool neg_t, bool cast,
                             Tally<kStats>& T) {
  const long long c0 = T.clock();
  bool occ = cast && occluded_pre(S, ox, oy, oz, dx, dy, dz, t_limit, neg_t);
  const long long c1 = T.clock();
  T.add(kCastsTri, cast && !occ);
  if constexpr (kWalk) {
    float bn = 0.0f, bd = 1.0f;
    int bi = -1;
    PreHit unused{};
    occ = exact_walk<true, true>(B, cast && !occ, ox, oy, oz, dx, dy, dz,
                                  neg_t, t_limit, bn, bd, bi, unused, T) ||
          occ;
  } else if (S.ntp) {
    const RayInv ri = ray_inv(ox, oy, oz, dx, dy, dz);
    const float4* rows = reinterpret_cast<const float4*>(S.tri);
    int nb = B.n;
    if (kCull && nb > 1 &&
        !__any_sync(kAll, cast && !occ &&
                              box_occ(__ldg(B.boxes), __ldg(B.boxes + 1), ri,
                                      t_limit, neg_t)))
      nb = 0;
    for (int b = 0; b < nb; ++b) {
      if (!__any_sync(kAll, cast && !occ)) break;
      const float4 lo = __ldg(B.boxes + 2 * b + 2);
      bool need = cast && !occ;
      if constexpr (kCull)
        need = need &&
               box_occ(lo, __ldg(B.boxes + 2 * b + 3), ri, t_limit, neg_t);
      if (!__any_sync(kAll, need)) continue;
      const int r0 = kTriRows * b, r1 = r0 + __float_as_int(lo.w);
      T.add(kTested, r1 - r0);
      if (!cast || occ) continue;
#pragma unroll 2
      for (int i = r0; i < r1; ++i) {
        const Quads q = row_quads(rows[3 * i], rows[3 * i + 1],
                                  rows[3 * i + 2], ox, oy, oz, dx, dy, dz);
        if (quads_valid(q, neg_t) && q.tn_s < t_limit * q.dd) {
          occ = true;
          break;
        }
      }
    }
  }
  T.add(kShadowRest, c1 - c0);
  T.add(kShadowTri, T.clock() - c1);
  return occ;
}

// Copy n4 float4 from device memory to shared memory, all threads of the
// block taking part.
__device__ __forceinline__ void stage_rows(const float4* __restrict__ src,
                                           float4* dst, int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
}

// Floats of shared memory the walk's grid frame takes (its 9, padded to
// 16 bytes), between the scene and the VLP rows.
constexpr int kFrameFloats = 12;

template <bool kWalk>
__host__ __device__ __forceinline__ int frame_floats() {
  return kWalk ? kFrameFloats : 0;
}

template <bool kStats, bool kCull, bool kWalk>
__global__ void __launch_bounds__(kBlock)
mega_vlp_kernel(const float* __restrict__ scene, int ntp, int nl, int ns,
                int nq, Tris<kWalk> B, uint32_t k0, uint32_t k1,
                uint32_t spp_offset, uint32_t spp_total, uint32_t row_offset,
                int rows, int width, int spp, int neg_t_flag,
                const float* __restrict__ vlp, int nvp, int stride,
                int chunk, const int* __restrict__ n_live_ptr,
                const float* __restrict__ gridp, float inv_nl,
                float* __restrict__ out,
                unsigned long long* __restrict__ stats) {
  Tally<kStats> T;
  const long long k_start = T.clock();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Scene S = stage_scene(scene, smem, ntp, nl, ns, nq);
  // the walk's grid frame follows the scene, float4-aligned, then the VLP
  // rows
  float* fsm = smem + ((scene_floats(ntp, nl, ns, nq) + 3) & ~3);
  if constexpr (kWalk) {
    if (threadIdx.x < 9) fsm[threadIdx.x] = __ldg(B.g.frame + threadIdx.x);
    B.g.frame = fsm;
  }
  float* vsm = fsm + frame_floats<kWalk>();
  const float4* vsm4 = reinterpret_cast<const float4*>(vsm);
  const float4* vlp4 = reinterpret_cast<const float4*>(vlp);
  const int n_live = min(max(*n_live_ptr, 0), nvp);
  const int n_chunks = (n_live + chunk - 1) / chunk;
  // live rows that fit one chunk are staged once, here
  if (n_chunks == 1)
    stage_rows(vlp4, reinterpret_cast<float4*>(vsm), n_live * stride / 4);
  const bool grid_mode = gridp != nullptr;
  // grid mode: vmin (3), cell size (3), resolution (3) as floats
  float gv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) gv[i] = grid_mode ? gridp[i] : 0.0f;
  const bool neg_t = neg_t_flag != 0;
  __syncthreads();
  T.add(kStage, T.clock() - k_start);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ii_i = blockIdx.x * kTileW + (warp & 1) * 8 + (lane & 7);
  const int jj_row = blockIdx.y * kTileH + (warp >> 1) * 4 + (lane >> 3);
  // ghost pixels past the film edge run every loop (they vote no and
  // stage table chunks with the block) and are not written
  const bool inside = ii_i < width && jj_row < rows;
  const uint32_t row_u = (uint32_t)jj_row + row_offset;
  // the pixel index wraps like the JAX kernel's int32 arithmetic
  const uint32_t pixel_index = row_u * (uint32_t)width + (uint32_t)ii_i;
  const float ii = (float)ii_i;
  const float jj = (float)(int)row_u;

  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t s32 = (uint32_t)s + spp_offset;
    const uint32_t ray_id = pixel_index * spp_total + s32;
    const Ray ry = primary_ray(S, k0, k1, ray_id, ii, jj);
    const Hit h = trace_vlp<kStats, kCull, kWalk>(
        S, B, ry.ox, ry.oy, ry.oz, ry.dx, ry.dy, ry.dz, neg_t, inside, T);
    const bool lit = inside && (h.m == 1 || h.m == 3);
    T.add(kLit, lit);
    const float x = ry.ox + ry.dx * h.t;
    const float y = ry.oy + ry.dy * h.t;
    const float z = ry.oz + ry.dz * h.t;

    // gather state of the shading point: n.x, |x|^2 and, in grid mode, its
    // cell (true division, as the JAX kernel) and in-box flag
    const long long g0 = T.clock();
    long long staged = 0;
    const float ndx = h.nx * x + h.ny * y + h.nz * z;
    const float x2 = x * x + y * y + z * z;
    float cxf = 0.0f, cyf = 0.0f, czf = 0.0f;
    bool in_box = false;
    if (grid_mode) {
      cxf = floorf((x - gv[0]) / gv[3]);
      cyf = floorf((y - gv[1]) / gv[4]);
      czf = floorf((z - gv[2]) / gv[5]);
      in_box = cxf >= 0.0f && cxf < gv[6] && cyf >= 0.0f && cyf < gv[7] &&
               czf >= 0.0f && czf < gv[8];
    }
    float gsum = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int r0 = c * chunk;
      const int nr = min(chunk, n_live - r0);
      if (n_chunks > 1) {
        const long long t0 = T.clock();
        __syncthreads();   // every thread is done with the previous chunk
        stage_rows(vlp4 + (long long)r0 * stride / 4,
                   reinterpret_cast<float4*>(vsm), nr * stride / 4);
        __syncthreads();
        staged += T.clock() - t0;
      }
      if (!lit || (grid_mode && !in_box)) continue;
      if (grid_mode) {
        // row: px py pz I | |p|^2 clo.xyz | chi.xyz pad
        for (int r = 0; r < nr; ++r) {
          const float4 b = vsm4[3 * r + 1];
          const float4 e = vsm4[3 * r + 2];
          if (!(b.y <= cxf && cxf <= e.x && b.z <= cyf && cyf <= e.y &&
                b.w <= czf && czf <= e.z))
            continue;
          T.add(kGatherPairs, 1);
          const float4 a = vsm4[3 * r];
          const float lamb_num = (h.nx * a.x + h.ny * a.y + h.nz * a.z) - ndx;
          const float dist2 = fmaxf(
              b.x - 2.0f * (x * a.x + y * a.y + z * a.z) + x2, 1e-12f);
          const float rs = 1.0f / sqrtf(dist2);
          gsum = gsum +
                 fmaxf(lamb_num, 0.0f) * rs * fminf(a.w * (rs * rs), 1.0f);
        }
      } else {
        // row: px py pz I | |p|^2 pad pad pad
        T.add(kGatherPairs, nr);
        for (int r = 0; r < nr; ++r) {
          const float4 a = vsm4[2 * r];
          const float p2s = vsm[8 * r + 4];
          const float lamb_num = (h.nx * a.x + h.ny * a.y + h.nz * a.z) - ndx;
          const float dist2 = fmaxf(
              p2s - 2.0f * (x * a.x + y * a.y + z * a.z) + x2, 1e-12f);
          const float rs = 1.0f / sqrtf(dist2);
          gsum = gsum +
                 fmaxf(lamb_num, 0.0f) * rs * fminf(a.w * (rs * rs), 1.0f);
        }
      }
    }
    T.add(kStage, staged);
    T.add(kGather, T.clock() - g0 - staged);

    // gather -> clamp 1 -> soft-shadow corrections -> / 4; every lane of a
    // warp with a lit lane runs the light loop, for the votes
    float ti = fminf(gsum, 1.0f);
    if (__any_sync(kAll, lit)) {
      for (int i = 0; i < S.nl; ++i) {
        const float lx = S.lights[4 * i], ly = S.lights[4 * i + 1];
        const float lz = S.lights[4 * i + 2];
        uint32_t u0, u1;
        threefry(k0, k1, ray_id, (uint32_t)(kSiteLight0 + i) * kSiteStride,
                 u0, u1);
        float ldx = lx + unit(u0) - x;
        float ldy = ly + unit(u1) - y;
        float ldz = lz - z;
        const float inv = 1.0f / sqrtf(ldx * ldx + ldy * ldy + ldz * ldz);
        ldx *= inv;
        ldy *= inv;
        ldz *= inv;
        // capped at the UN-jittered light distance (ocl:195-197)
        const float dqx = lx - x, dqy = ly - y, dqz = lz - z;
        const float tl = sqrtf(dqx * dqx + dqy * dqy + dqz * dqz);
        T.add(kCasts, lit);
        if (occluded_vlp<kStats, kCull, kWalk>(S, B, x, y, z, ldx, ldy, ldz,
                                               tl, neg_t, lit, T))
          ti = ti - inv_nl;
      }
    }

    float sr, sgc, sb;
    if (h.m == 0) {
      shade_sky(ry.dz, sr, sgc, sb);
    } else if (h.m == 4) {
      const float facing =
          fmaxf(0.0f, -(h.nx * ry.dx + h.ny * ry.dy + h.nz * ry.dz));
      sr = sgc = sb = facing;
    } else {
      ti = ti * 0.25f;
      shade_lit(h.m, x, y, ti, sr, sgc, sb);
    }
    fr = fr + sr;
    fg = fg + sgc;
    fb = fb + sb;
  }
  if (inside) {
    float* o = out + 3 * ((long long)jj_row * width + ii_i);
    o[0] = fr * kExposure;
    o[1] = fg * kExposure;
    o[2] = fb * kExposure;
  }
  T.add(kKernel, T.clock() - k_start);
  T.flush(stats);
}

template <bool kStats, bool kCull, bool kWalk>
int launch(const float* scene, int ntp, int nl, int ns, int nq,
           Tris<kWalk> B, unsigned k0, unsigned k1, unsigned spp_offset,
           unsigned spp_total, unsigned row_offset, int rows, int width,
           int spp, int neg_t, const float* vlp, int nvp, int stride,
           int chunk, const int* n_live, const float* gridp, float inv_nl,
           float* out, unsigned long long* stats, cudaStream_t stream) {
  const int scene_n = ntp * 12 + 12 + nl * 4 + ns * 3 + 2 * nq;
  const size_t smem =
      sizeof(float) * ((size_t)((scene_n + 3) & ~3) + frame_floats<kWalk>() +
                       (size_t)min(chunk, nvp) * stride);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_vlp_kernel<kStats, kCull, kWalk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((rows + kTileH - 1) / kTileH));
  mega_vlp_kernel<kStats, kCull, kWalk><<<grid, kBlock, smem, stream>>>(
      scene, ntp, nl, ns, nq, B, k0, k1, spp_offset, spp_total, row_offset,
      rows, width, spp, neg_t, vlp, nvp, stride, chunk, n_live, gridp,
      inv_nl, out, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `vlp` is
// the (nvp, stride) float32 table, stride 8 (dense) or 12 (grid mode, with
// `gridp` the 9 grid floats; NULL in dense mode); `n_live` a device int32;
// `chunk` the rows staged in shared memory at a time (all of them once a
// launch when n_live <= chunk).  The triangles: with `grid_rows` NULL, the
// shared-memory route - `scene` holds ntp triangle rows and `boxes`
// n_boxes records of 2 float4 (lo.xyz and a row count as int bits, hi.xyz
// and 0): the mesh's box, then its blocks of 32 rows; `cull` 0 scans every
// triangle block (the cull-free instantiation, the same film).  With
// `grid_rows` set, the walk: `scene` holds no triangles (ntp 0, `boxes`
// unused) and the grid_* arguments are ops/exact_grid.py::ExactGrid's
// tables - the cell-major rows (12 floats each), each cell's (first row,
// rows), the occupancy bitmap, each row's original index, the 9-float
// frame - over rx x ry x rz cells; `cull` must be 1.  `stats`, when not
// null, points to kStatSlots zeroed uint64 counters: the counting
// instantiation runs and adds its Tally there.
extern "C" int mega_vlp_launch(const float* scene, int ntp, int nl, int ns,
                               int nq, const float* boxes, int n_boxes,
                               const float* grid_rows, const int* grid_span,
                               const int* grid_occ, const int* grid_ids,
                               const float* grid_frame, int rx, int ry,
                               int rz, unsigned k0, unsigned k1,
                               unsigned spp_offset, unsigned spp_total,
                               unsigned row_offset, int rows, int width,
                               int spp, int neg_t, const float* vlp, int nvp,
                               int stride, int chunk, const int* n_live,
                               const float* gridp, float inv_nl, int cull,
                               float* out, void* stats, void* stream) {
  if ((long long)rows * width <= 0) return 0;
  if ((stride != 8 && stride != 12) || chunk < 1 || nvp < 1)
    return (int)cudaErrorInvalidValue;
  auto* st = reinterpret_cast<unsigned long long*>(stats);
  auto* s = (cudaStream_t)stream;
  if (grid_rows != nullptr) {
    if (ntp != 0 || !cull || rx < 1 || ry < 1 || rz < 1 ||
        grid_span == nullptr || grid_occ == nullptr || grid_ids == nullptr ||
        grid_frame == nullptr)
      return (int)cudaErrorInvalidValue;
    XGrid X;
    X.g.rows = reinterpret_cast<const float4*>(grid_rows);
    X.g.span = reinterpret_cast<const int2*>(grid_span);
    X.g.occ = reinterpret_cast<const unsigned*>(grid_occ);
    X.g.frame = grid_frame;
    X.g.rx = rx;
    X.g.ry = ry;
    X.g.rz = rz;
    X.ids = grid_ids;
    auto kernel = stats ? launch<true, true, true> : launch<false, true, true>;
    return kernel(scene, ntp, nl, ns, nq, X, k0, k1, spp_offset, spp_total,
                  row_offset, rows, width, spp, neg_t, vlp, nvp, stride,
                  chunk, n_live, gridp, inv_nl, out, st, s);
  }
  if (boxes == nullptr || n_boxes < 1 || (n_boxes - 1) * kTriRows < ntp)
    return (int)cudaErrorInvalidValue;
  const TriBlocks B{reinterpret_cast<const float4*>(boxes), n_boxes - 1};
  auto kernel =
      stats ? (cull ? launch<true, true, false> : launch<true, false, false>)
            : (cull ? launch<false, true, false> : launch<false, false, false>);
  return kernel(scene, ntp, nl, ns, nq, B, k0, k1, spp_offset, spp_total,
                row_offset, rows, width, spp, neg_t, vlp, nvp, stride, chunk,
                n_live, gridp, inv_nl, out, st, s);
}

extern "C" const char* mega_vlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
