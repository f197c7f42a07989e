// The trianglegrid variant's uniform-grid DDA on the card: the whole
// mirror-free `super` sample step, all spp, in one launch over the
// triangle grid (kernel B11, `accel="dda"`), and the grid walk alone, one
// thread a ray, for the tier-1 wavefront (kernel B11w).
//
// Replaces no pl.pallas_call: the JAX package compiles the route as one XLA
// program (models/trianglegrid.py:85-91 puts build_and_render under
// jax.jit, with ops/grid.py:261 traverse_triangles inside a fori_loop),
// which the port ran as a Python loop of eager torch ops, ~2x10^5 launches
// a trace on the 20,736-triangle sheet.  B11 is kernel B2/B3's sample step
// (csrc/mega_blocked.cu) with the reference's grid in place of the Morton
// blocks: the triangle-free scene staged in shared memory, pre_tri, then
// pt_device.cuh::grid_closest (the 3-D DDA of TraceRay,
// trianglegrid/pathtracer.ocl:157-198, testing each visited cell's
// triangles in the division form of Moller-Trumbore), one jittered shadow
// ray per light (grid_occluded, the any-hit walk whose boolean equals the
// plain closest-hit trace's material != 0; under shadow_carry_t the
// sequential closest-hit traces seeded with the carried distance), the
// 4-material shading, spp accumulation.  B11w runs grid_closest on given
// (o, d, t, m, n, needs): the arithmetic is ops/grid.py::
// traverse_triangles' in its order, so it equals the plain walk bit for
// bit; B11's film holds to the plain DDA film under the CRN contract
// (utils/crn.py).  Against B2/B3's it holds wherever the walk reaches the
// ray's hit: the reference's break rule (ocl:195) ends some walks before
// it, and the DDA's film keeps that.
//
// What bounds it on an H100: FP32 issue in the pair tests (46 operations a
// (ray, triangle) pair, the division counted once) and the DDA steps; the
// grid (the 20,736 sheet: 58,750 cells x 32 ids, 7.5 MB, and the 1 MB
// triangle table) stays in the 50 MB L2, read through the read-only
// path.  The walk is per lane: no warp votes, each lane ends at its own
// cell, so a warp pays for its longest walk.  One thread a pixel, a warp
// on a compact 8x4 patch (B2/B3's layout) so that its rays cross the same
// cells; B11w takes rays in the caller's order, 256 a block.  The counting
// instantiation (kStats) tallies traces, traces that enter the grid,
// visited cells and tested pairs: the bound's work.  Built with
// --fmad=false and without fast math, like B1-B5.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 16;            // block tile: 16 x 8 pixels,
constexpr int kTileH = 8;             // warp w on the 8 x 4 patch (w&1, w>>1)
constexpr int kBlock = kTileW * kTileH;
constexpr int kWalkBlock = 256;       // B11w: rays a block

// Work tally of the counting instantiation: [0] grid walks, [1] walks
// that enter the grid, [2] cells visited, [3] (ray, triangle) pairs
// tested; each thread adds its counts to the stats buffer at the end.
constexpr int kStatSlots = 4;

template <bool kStats>
struct Tally {
  unsigned long long v[kStatSlots] = {};
  __device__ __forceinline__ void walk() { v[0] += 1; }
  __device__ __forceinline__ void enter() { v[1] += 1; }
  __device__ __forceinline__ void cell() { v[2] += 1; }
  __device__ __forceinline__ void pair() { v[3] += 1; }
  __device__ __forceinline__ void flush(unsigned long long* stats) {
    for (int i = 0; i < kStatSlots; ++i)
      if (v[i]) atomicAdd(stats + i, v[i]);
  }
};

template <>
struct Tally<false> {
  __device__ __forceinline__ void walk() {}
  __device__ __forceinline__ void enter() {}
  __device__ __forceinline__ void cell() {}
  __device__ __forceinline__ void pair() {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

// The kernel's parameters of the grid: the frame lies in device memory
// (the wrapper computes vmax there) and is read into the Grid at entry.
struct GridArgs {
  const float4* tri;
  const int* items;
  const int* counts;
  const float* frame;   // vmin.xyz, vmax.xyz, cell size.xyz
  int rx, ry, rz, cap;
};

__device__ __forceinline__ Grid load_grid(const GridArgs& a) {
  Grid G;
  G.tri = a.tri;
  G.items = a.items;
  G.counts = a.counts;
  for (int i = 0; i < 3; ++i) {
    G.vmin[i] = __ldg(a.frame + i);
    G.vmax[i] = __ldg(a.frame + 3 + i);
    G.cs[i] = __ldg(a.frame + 6 + i);
  }
  G.rx = a.rx;
  G.ry = a.ry;
  G.rz = a.rz;
  G.cap = a.cap;
  return G;
}

// Closest hit over floor, squares, spheres and the grid's triangles,
// seeded with t0; lanes that are not `active` skip the walk.
template <bool kStats>
__device__ Hit trace_grid(const Scene& S, const Grid& G, float ox, float oy,
                          float oz, float dx, float dy, float dz, float t0,
                          bool neg_t, bool active, Tally<kStats>& T) {
  PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, t0, neg_t, 3);
  if (active) {
    T.walk();
    grid_closest(G, ox, oy, oz, dx, dy, dz, neg_t, h, T);
  }
  return finish(h);
}

template <bool kStats>
__global__ void __launch_bounds__(kBlock)
mega_grid_kernel(const float* __restrict__ scene, int nl, int ns, int nq,
                 GridArgs ga, uint32_t k0, uint32_t k1, uint32_t spp_offset,
                 uint32_t spp_total, uint32_t row_offset, int rows,
                 int width, int spp, int neg_t_flag, int carry_t_flag,
                 float* __restrict__ out,
                 unsigned long long* __restrict__ stats) {
  Tally<kStats> T;
  extern __shared__ float4 smem4[];
  const Scene S = stage_scene(scene, reinterpret_cast<float*>(smem4), 0, nl,
                              ns, nq);
  const Grid G = load_grid(ga);
  __syncthreads();
  const bool neg_t = neg_t_flag != 0;
  const bool carry_t = carry_t_flag != 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ii_i = blockIdx.x * kTileW + (warp & 1) * 8 + (lane & 7);
  const int jj_row = blockIdx.y * kTileH + (warp >> 1) * 4 + (lane >> 3);
  if (ii_i >= width || jj_row >= rows) return;   // no warp-wide step below
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

    const Hit h = trace_grid(S, G, ox, oy, oz, dx, dy, dz, kBig, neg_t, true,
                             T);

    // direct light for floor (1) and diffuse (3) hits: one shadow ray
    // per light, cast only where the shading uses it
    const bool lit = h.m == 1 || h.m == 3;
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
      bool occ;
      if (carry_t) {
        const Hit hs = trace_grid(S, G, x, y, z, ldx, ldy, ldz, t_run, neg_t,
                                  cast, T);
        occ = hs.m != 0;
        if (cast) t_run = hs.t;
      } else {
        occ = cast && occluded_pre(S, x, y, z, ldx, ldy, ldz, kBig, neg_t);
        if (cast && !occ) {
          T.walk();
          occ = grid_occluded(G, x, y, z, ldx, ldy, ldz, kBig, neg_t, T);
        }
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
  float* o = out + 3 * ((long long)jj_row * width + ii_i);
  o[0] = fr * kExposure;
  o[1] = fg * kExposure;
  o[2] = fb * kExposure;
  T.flush(stats);
}

// B11w: the grid walk of ray i over (o, d) (n, 3) and the running hit (t,
// m, n, needs) (n,), updated in place.
template <bool kStats>
__global__ void __launch_bounds__(kWalkBlock)
grid_walk_kernel(GridArgs ga, const float* __restrict__ o,
                 const float* __restrict__ d, float* __restrict__ t,
                 int* __restrict__ m, float* __restrict__ nx,
                 float* __restrict__ ny, float* __restrict__ nz,
                 unsigned char* __restrict__ needs, int n,
                 int neg_t_flag, unsigned long long* __restrict__ stats) {
  const long long i = (long long)blockIdx.x * kWalkBlock + threadIdx.x;
  if (i >= n) return;
  Tally<kStats> T;
  const Grid G = load_grid(ga);
  PreHit h{t[i], m[i], nx[i], ny[i], nz[i], needs[i] != 0};
  T.walk();
  grid_closest(G, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
               d[3 * i + 1], d[3 * i + 2], neg_t_flag != 0, h, T);
  t[i] = h.t;
  m[i] = h.m;
  nx[i] = h.nx;
  ny[i] = h.ny;
  nz[i] = h.nz;
  needs[i] = h.needs ? 1 : 0;
  T.flush(stats);
}

GridArgs grid_args(const float* tri, const int* items, const int* counts,
                   const float* frame, int rx, int ry, int rz, int cap) {
  GridArgs a;
  a.tri = reinterpret_cast<const float4*>(tri);
  a.items = items;
  a.counts = counts;
  a.frame = frame;
  a.rx = rx;
  a.ry = ry;
  a.rz = rz;
  a.cap = cap;
  return a;
}

}  // namespace

// Launch B11 on `stream`; returns cudaGetLastError() (0 on success).
// `scene` is ops/mega_super.py::pack_scene's buffer without triangles;
// `tri`, `items`, `counts` and `frame` are ops/grid.py::grid_tables' device
// tensors; `stats`, when not null, points to kStatSlots zeroed uint64
// counters: the counting instantiation runs and adds its Tally there.
extern "C" int mega_grid_launch(const float* scene, int nl, int ns, int nq,
                                const float* tri, const int* items,
                                const int* counts, const float* frame,
                                int rx, int ry, int rz, int cap, unsigned k0,
                                unsigned k1, unsigned spp_offset,
                                unsigned spp_total, unsigned row_offset,
                                int rows, int width, int spp, int neg_t,
                                int carry_t, float* out, void* stats,
                                void* stream) {
  if ((long long)rows * width <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(12 + nl * 4 + ns * 3 + 2 * nq);
  auto kernel = stats ? mega_grid_kernel<true> : mega_grid_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((rows + kTileH - 1) / kTileH));
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, nl, ns, nq,
      grid_args(tri, items, counts, frame, rx, ry, rz, cap), k0, k1,
      spp_offset, spp_total, row_offset, rows, width, spp, neg_t, carry_t,
      out, reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

// Launch B11w over n rays on `stream`; the hit arrays are updated in place
// (`needs` is a bool tensor's bytes).  Returns cudaGetLastError().
extern "C" int grid_walk_launch(const float* tri, const int* items,
                                const int* counts, const float* frame,
                                int rx, int ry, int rz, int cap,
                                const float* o, const float* d, float* t,
                                int* m, float* nx, float* ny, float* nz,
                                void* needs, int n, int neg_t,
                                void* stats, void* stream) {
  if (n <= 0) return 0;
  auto kernel = stats ? grid_walk_kernel<true> : grid_walk_kernel<false>;
  const unsigned blocks = (unsigned)((n + kWalkBlock - 1) / kWalkBlock);
  kernel<<<blocks, kWalkBlock, 0, (cudaStream_t)stream>>>(
      grid_args(tri, items, counts, frame, rx, ry, rz, cap), o, d, t, m, nx,
      ny, nz, reinterpret_cast<unsigned char*>(needs), n, neg_t,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

extern "C" const char* mega_grid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
