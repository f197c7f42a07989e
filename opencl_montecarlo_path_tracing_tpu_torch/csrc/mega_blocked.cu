// Super megakernel for large meshes: the whole mirror-free `super` sample
// step, all spp, in one kernel, each ray's triangles found by a walk of an
// exact uniform grid (kernels B2 and B3 of the port).
//
// Replaces the TPU kernel opencl_montecarlo_path_tracing_tpu/ops/
// pallas_super.py::film_super_mega -> _mega_kernel in its blocked tier
// (513-65,536 triangles) and its stream tier (65,537-2^20).  The TPU split
// the two only to fit its ~32 KB scalar memory; here one structure serves
// both.  The film is B1's (csrc/mega_super.cu): threefry camera draws, the
// thin-lens primary ray, the closest hit over floor -> squares -> spheres
// -> triangles (division-free Moller-Trumbore, det-scaled running
// minimum), one jittered shadow ray per light (uncapped any-hit, or under
// shadow_carry_t sequential closest-hit traces seeded with the carried
// distance), the 4-material shading, spp accumulation.
//
// The triangles are the exact uniform grid of ops/exact_grid.py (the one
// B4's walk route reads past 512 triangles): every (cell, triangle) pair
// whose AABB overlaps the cell, no per-cell cap, the rows cell-major with
// their original indices, an occupancy bitmap and a padded frame, built
// once per prepared scene and device.  Shared memory holds the scene
// without triangles and the grid's frame; the tables stay in device
// memory (the 20,736-triangle sheet's take 6.1 MB, read through L1/L2).
// Each camera ray and each shadow ray walks the grid, one lane a ray,
// through pt_device.cuh::exact_walk: a 3-D DDA that tests each occupied
// cell's pairs in slot order and ends when the running best lies before
// the current cell's exit less a margin (a shadow ray at its first hit).
//
// Exactness.  A triangle is in every cell its box overlaps and a hit's
// point lies in its box, so a hit that could beat the running best lies
// in a cell the walk has yet to visit; the margin keeps rounding from
// ending a walk early.  An exact cross-multiplied tie goes to the lowest
// original index, carried as an int from -1, so a tie against a floor or
// sphere hit is never stolen: the rule the JAX kernel's Morton-ordered
// blocks keep (_tri_closest_row_blocked, pallas_super.py:222-264), so the
// film is the block walk's that this grid replaced.
//
// What bounds it on an H100: FP32 issue in the pair tests (~48
// operations, ~60 instructions, per tested (ray, triangle) pair) and the
// DDA's steps; the device-memory traffic is the grid's rows (48 B a
// pair), spans and bitmap, re-read from L1/L2, and the 12-byte film write
// per pixel.  One thread per pixel, a warp on a compact 8x4 pixel patch (a
// block of 4 warps on 16x8), so that the lanes' DDAs cross the same cells
// and their row loads hit the same lines.  The camera walks step over
// runs of empty cells in an inner loop, each lane at its own pace, so
// that a warp's lanes test their occupied cells together (B4's
// schedule); the shadow walks, a few lanes a warp from scattered hit
// points, step a cell at a time without it, which took a sheet frame's
// kernel from 15.1 to 10.9 ms on an H100 (PERF.md, B2).  Only the
// film's pixels walk their camera rays, and only the shadow rays the
// shading reads walk (lit hits facing the light, not occluded by the
// floor, squares or spheres).  Built with --fmad=false and without fast
// math, like B1.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 16;            // block tile: 16 x 8 pixels,
constexpr int kTileH = 8;             // warp w on the 8 x 4 patch (w&1, w>>1)
constexpr int kBlock = kTileW * kTileH;
// Floats of shared memory the grid's frame takes (its 9, padded to 16
// bytes), after the scene.
constexpr int kFrameFloats = 12;

// Work tally of the counting instantiation (kStats).  Cycle slots
// (clock64, the warp's: lane 0's reading) [kCamRest] the camera trace's
// floor, squares and spheres, [kCamTri] its walk, [kShadowRest] the shadow
// rays' floor, squares and spheres, [kShadowTri] their walks, [kKernel]
// the whole kernel; count slots (summed over lanes) [kCasts] shadow rays
// cast (a lit hit facing a light), [kCastsTri] casts that walk the grid
// (any-hit: those the floor, squares and spheres do not occlude; under
// shadow_carry_t every cast), [kTested] pair iterations of the warps (32
// lanes each), [kWalks] walks (camera rays of the film's pixels and the
// casts that walk), [kEntered] walks that enter the grid, [kCells] cells
// visited, [kEmpty] visited cells with no triangle, [kPairs] (ray,
// triangle) pairs the lanes test (the bound's work); lane 0's clock64
// split of the walks' cycles (warp-uniform stamps of the lockstep walk,
// pt_device.cuh's WalkStage): [kClkSetup] the DDA set-up, [kClkEmpty]
// iterations in which no lane tests a pair (empty cells and their steps),
// [kClkLoads] the occupied cells' row loads, [kClkPairs] the pair
// arithmetic, [kClkStep] the occupied cells' end tests and steps.  The
// timed instantiation keeps none of it.
enum Slot {
  kCamRest, kCamTri, kShadowRest, kShadowTri, kKernel,
  kCasts, kCastsTri, kTested, kWalks, kEntered, kCells, kEmpty, kPairs,
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
    for (int i = kCasts; i <= kPairs; ++i)
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

// Closest hit over floor, squares, spheres and the grid's triangles,
// seeded with t0, for `active` lanes (the others return the non-triangle
// hit); kNest is exact_walk's.  `rest` and `tri` are the tally's cycle
// slots of the two stages.
template <bool kNest, bool kStats>
__device__ Hit trace_grid(const Scene& S, const XGrid& X, float ox,
                          float oy, float oz, float dx, float dy, float dz,
                          float t0, bool neg_t, bool active, int rest,
                          int tri, Tally<kStats>& T) {
  const long long c0 = T.clock();
  PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, t0, neg_t, 3);
  const long long c1 = T.clock();
  float bn = h.t, bd = 1.0f;
  int bi = -1;
  exact_walk<false, kNest>(X, active, ox, oy, oz, dx, dy, dz, neg_t, 0.0f,
                           bn, bd, bi, h, T);
  h.t = bn / bd;
  T.add(rest, c1 - c0);
  T.add(tri, T.clock() - c1);
  return finish(h);
}

// Any-hit occlusion below t_limit over floor, squares, spheres and the
// grid's triangles, for `cast` lanes (the others return false); a lane's
// walk ends at its first hit.
template <bool kStats>
__device__ bool occluded_grid(const Scene& S, const XGrid& X, float ox,
                              float oy, float oz, float dx, float dy,
                              float dz, float t_limit, bool neg_t,
                              bool cast, Tally<kStats>& T) {
  const long long c0 = T.clock();
  const bool occ =
      cast && occluded_pre(S, ox, oy, oz, dx, dy, dz, t_limit, neg_t);
  const long long c1 = T.clock();
  T.add(kCastsTri, cast && !occ);
  float bn = 0.0f, bd = 1.0f;
  int bi = -1;
  PreHit unused{};
  const bool hit = exact_walk<true, false>(X, cast && !occ, ox, oy, oz, dx,
                                           dy, dz, neg_t, t_limit, bn, bd,
                                           bi, unused, T);
  T.add(kShadowRest, c1 - c0);
  T.add(kShadowTri, T.clock() - c1);
  return occ || hit;
}

// kCarry: the shadow_carry_t quirk's closest-hit shadow traces, an
// instantiation of its own so that the other one carries no third walk.
template <bool kStats, bool kCarry>
__global__ void __launch_bounds__(kBlock)
mega_blocked_kernel(const float* __restrict__ scene, int nl, int ns, int nq,
                    XGrid X, uint32_t k0, uint32_t k1, uint32_t spp_offset,
                    uint32_t spp_total, uint32_t row_offset, int rows,
                    int width, int spp, int neg_t_flag,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ stats) {
  Tally<kStats> T;
  const long long k_start = T.clock();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Scene S = stage_scene(scene, smem, 0, nl, ns, nq);
  // the grid's frame follows the scene, float4-aligned
  float* fsm = smem + ((scene_floats(0, nl, ns, nq) + 3) & ~3);
  if (threadIdx.x < 9) fsm[threadIdx.x] = __ldg(X.g.frame + threadIdx.x);
  X.g.frame = fsm;
  __syncthreads();
  const bool neg_t = neg_t_flag != 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ii_i = blockIdx.x * kTileW + (warp & 1) * 8 + (lane & 7);
  const int jj_row = blockIdx.y * kTileH + (warp >> 1) * 4 + (lane >> 3);
  // ghost pixels past the film edge run every loop (every lane reaches
  // every warp-wide step of the walks) but walk nothing and are not
  // written
  const bool inside = ii_i < width && jj_row < rows;
  const uint32_t row_u = (uint32_t)jj_row + row_offset;
  const uint32_t pixel_index = row_u * (uint32_t)width + (uint32_t)ii_i;
  const float ii = (float)ii_i;
  const float jj = (float)(int)row_u;

  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t s32 = (uint32_t)s + spp_offset;
    const uint32_t ray_id = pixel_index * spp_total + s32;
    const Ray ry = primary_ray(S, k0, k1, ray_id, ii, jj);
    const float ox = ry.ox, oy = ry.oy, oz = ry.oz;
    const float dx = ry.dx, dy = ry.dy, dz = ry.dz;

    const Hit h = trace_grid<true>(S, X, ox, oy, oz, dx, dy, dz, kBig,
                                   neg_t, inside, kCamRest, kCamTri, T);

    // direct light for floor (1) and diffuse (3) hits: one shadow ray
    // per light, cast only where the shading uses it
    const bool lit = inside && (h.m == 1 || h.m == 3);
    const float x = ox + dx * h.t;
    const float y = oy + dy * h.t;
    const float z = oz + dz * h.t;
    float ti = 0.0f;
    float t_run = h.t;
    for (int i = 0; i < S.nl; ++i) {
      const float lx = S.lights[4 * i], ly = S.lights[4 * i + 1];
      const float lz = S.lights[4 * i + 2], li = S.lights[4 * i + 3];
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
      const float lamb = ldx * h.nx + ldy * h.ny + ldz * h.nz;
      // lamb < 0 zeroes the contribution; the reference short-circuits
      // the shadow trace there, so the carried t is left as it was
      const bool cast = lit && lamb >= 0.0f;
      T.add(kCasts, cast);
      bool occ;
      if constexpr (kCarry) {
        T.add(kCastsTri, cast);
        const Hit hs = trace_grid<false>(S, X, x, y, z, ldx, ldy, ldz,
                                         t_run, neg_t, cast, kShadowRest,
                                         kShadowTri, T);
        occ = hs.m != 0;
        if (cast) t_run = hs.t;
      } else {
        occ = occluded_grid(S, X, x, y, z, ldx, ldy, ldz, kBig, neg_t, cast,
                            T);
      }
      if (cast && !occ) {
        const float dqx = lx - x, dqy = ly - y, dqz = lz - z;
        const float dist2 = dqx * dqx + dqy * dqy + dqz * dqz;
        ti = ti + lamb * fminf(li / dist2, 1.0f);
      }
    }
    float sr, sgc, sb;
    if (h.m == 0) {
      shade_sky(dz, sr, sgc, sb);
    } else if (h.m == 4) {
      const float facing =
          fmaxf(0.0f, -(h.nx * dx + h.ny * dy + h.nz * dz));
      sr = sgc = sb = facing;
    } else {
      ti = fminf(ti, 1.0f) * 0.25f;
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `scene`
// is ops/mega_super.py::pack_scene's buffer without triangles; the grid_*
// arguments are ops/exact_grid.py::ExactGrid's tables - the cell-major
// rows (12 floats each), each cell's (first row, rows), the occupancy
// bitmap, each row's original index, the 9-float frame - over rx x ry x rz
// cells.  `stats`, when not null, points to kStatSlots zeroed uint64
// counters: the counting instantiation runs and adds its Tally there.
extern "C" int mega_blocked_launch(const float* scene, int nl, int ns, int nq,
                                   const float* grid_rows,
                                   const int* grid_span, const int* grid_occ,
                                   const int* grid_ids,
                                   const float* grid_frame, int rx, int ry,
                                   int rz, unsigned k0, unsigned k1,
                                   unsigned spp_offset, unsigned spp_total,
                                   unsigned row_offset, int rows, int width,
                                   int spp, int neg_t, int carry_t,
                                   float* out, void* stats, void* stream) {
  if ((long long)rows * width <= 0) return 0;
  if (rx < 1 || ry < 1 || rz < 1 || grid_rows == nullptr ||
      grid_span == nullptr || grid_occ == nullptr || grid_ids == nullptr ||
      grid_frame == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) *
      ((size_t)((12 + nl * 4 + ns * 3 + 2 * nq + 3) & ~3) + kFrameFloats);
  auto kernel =
      stats ? (carry_t ? mega_blocked_kernel<true, true>
                       : mega_blocked_kernel<true, false>)
            : (carry_t ? mega_blocked_kernel<false, true>
                       : mega_blocked_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  XGrid X;
  X.g.rows = reinterpret_cast<const float4*>(grid_rows);
  X.g.span = reinterpret_cast<const int2*>(grid_span);
  X.g.occ = reinterpret_cast<const unsigned*>(grid_occ);
  X.g.frame = grid_frame;
  X.g.rx = rx;
  X.g.ry = ry;
  X.g.rz = rz;
  X.ids = grid_ids;
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((rows + kTileH - 1) / kTileH));
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, nl, ns, nq, X, k0, k1, spp_offset, spp_total, row_offset, rows,
      width, spp, neg_t, out, reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

extern "C" const char* mega_blocked_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
