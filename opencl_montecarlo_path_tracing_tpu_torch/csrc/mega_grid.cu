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
// (csrc/mega_blocked.cu) with the reference's grid and walk in place of
// the exact grid's: the triangle-free scene staged in shared memory,
// pre_tri, then pt_device.cuh::grid_closest (the 3-D DDA of TraceRay,
// trianglegrid/pathtracer.ocl:157-198, testing each visited cell's
// triangles in the division form of Moller-Trumbore), one jittered shadow
// ray per light (grid_occluded, the any-hit walk whose boolean equals the
// plain closest-hit trace's material != 0; under shadow_carry_t the
// sequential closest-hit traces seeded with the carried distance), the
// 4-material shading, spp accumulation.  B11w walks given (o, d, t, m, n,
// needs) (pt_device.cuh::grid_walk): each ray's hit is ops/grid.py::
// traverse_triangles' for it, so it equals the plain walk bit for bit;
// B11's film holds to the plain DDA film under the CRN contract
// (utils/crn.py).  Against B2/B3's it holds wherever the walk reaches the
// ray's hit: the reference's break rule (ocl:195) ends some walks before
// it, and the DDA's film keeps that.
//
// What bounds it on an H100: FP32 issue in the pair tests (46 operations a
// (ray, triangle) pair, the division counted once) and the DDA steps; the
// grid (the 20,736 sheet: 58,750 cells, 108k cell-major rows, 5.2 MB)
// stays in the 50 MB L2, read through the read-only path.  A clock64
// split of the counting launch (PERF.md, PR 16) put 62% of a warp's
// cycles in occupied cells, pair tests and their loads, 26% in empty
// steps, and showed warps paying 2.6x the pair tests they need; the walk
// is residency-bound (a prefetch of the next row, 122 registers, ran
// slower than none).  So the tables are ops/grid.py::grid_tables': an
// occupancy bitmap (an empty cell costs its bit and its step; B11 stages
// it in shared memory) and each cell's triangle rows copied in cell order
// (a pair's row depends on its cell and slot: no item id is loaded).  B11
// walks each lane at its own pace (pt_device.cuh::grid_closest /
// grid_occluded), one thread a pixel, a warp on a compact 8x4 patch
// (B2/B3's layout) so that its rays cross the same cells, 64 registers.
// B11w walks a warp's 32 rays (the caller's order, 256 a block) in
// lockstep and pools the pairs of its lanes' occupied cells, dealt out 32
// a round (pt_device.cuh::grid_walk), so that a warp pays a round for
// each 32 pairs instead of its lanes' largest cell; in B11's register
// budget the pool costs more residency than it saves.  The counting
// instantiation (kStats) runs the lockstep walk on every lane (B11's
// without the pool), tallies the bound's work and the split
// (ops/grid.py::STAT_NAMES), and gives the same film.  Built with
// --fmad=false and without fast math, like B1-B5.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 16;            // block tile: 16 x 8 pixels,
constexpr int kTileH = 8;             // warp w on the 8 x 4 patch (w&1, w>>1)
constexpr int kBlock = kTileW * kTileH;
constexpr int kWalkBlock = 256;       // B11w: rays a block

// Work tally of the counting instantiation (ops/grid.py::STAT_NAMES):
//  [0] grid walks, [1] walks that enter the grid, [2] cells visited, [3]
//  (ray, triangle) pairs the sequential slot-order scan tests (for an
//  any-hit walk up to its first hit) - the bound's work;
//  [4] / [5] warp-paid cell steps of camera / shadow walks (one an
//  iteration of the warp's walk), [6] / [7] the lanes' cells of camera /
//  shadow walks (SIMT efficiency = lane cells / (32 x warp steps));
//  [8] / [9] / [10] the warp steps a per-lane schedule across samples and
//  walks would pay (for each warp, its lanes' largest sum of cells over
//  their camera walks / shadow walks / all walks);
//  [11] visited cells with no triangle (their occupancy bit clear);
//  [12..20] clock64 cycles summed over warps (lane 0's stamps at warp-
//  uniform points of grid_walk): the camera ray and pre_tri (B11w:
//  reading its inputs), the walks' DDA set-up, iterations in which every
//  walking lane's cell is empty (its bit and step), in the others the
//  loads (the cells' spans and rows), the pair arithmetic and the merge
//  and step, the shadow set-up (light sampling, occluded_pre), the
//  shading (B11w: writing its outputs), and the whole kernel;
//  [21] the warps' rounds of pooled pairs (pair SIMT efficiency = pairs /
//  (32 x these)).
constexpr int kStatSlots = 22;
enum StatSlot : int {
  kWalks, kEntered, kCells, kPairs, kCamSteps, kShadowSteps, kCamCells,
  kShadowCells, kSchedCam, kSchedShadow, kSchedAll, kEmpty, kClkCamera,
  kClkSetup, kClkEmpty, kClkOccLoads, kClkPairs, kClkOccStep, kClkShadow,
  kClkShade, kClkKernel, kWarpPairs
};

// The counting instantiation's tally (every lane of the warp runs the
// kernel to its end; lane 0's warp-level slots are the ones flushed).
template <bool kStats>
struct Tally {
  unsigned walks = 0, entered = 0, cells = 0, pairs = 0, empty = 0;
  unsigned cam = 0, shadow = 0;        // this lane's cells, by walk kind
  unsigned long long w[kStatSlots] = {};   // lane 0's warp-level slots
  long long last = 0;                  // the last clock64 stamp
  bool is_shadow = false;              // the kind of the current walk
  // the warp's clock since the last stamp goes to `slot`
  __device__ __forceinline__ void clock_to(int slot) {
    __syncwarp();
    const long long now = clock64();
    w[slot] += (unsigned long long)(now - last);
    last = now;
  }
  __device__ __forceinline__ void start() {
    __syncwarp();
    last = clock64();
    w[kClkKernel] = (unsigned long long)last;
  }
  // a walk of kind `shadow` begins; the time before it goes to `slot`
  __device__ __forceinline__ void begin(bool shadow_walk, int slot) {
    is_shadow = shadow_walk;
    clock_to(slot);
  }
  // grid_walk's hooks
  __device__ __forceinline__ void walk(bool live, bool go) {
    walks += live;
    entered += go;
  }
  __device__ __forceinline__ void step() {
    w[is_shadow ? kShadowSteps : kCamSteps] += 1;
  }
  __device__ __forceinline__ void cell(bool full) {
    cells += 1;
    empty += !full;
    (is_shadow ? shadow : cam) += 1;
  }
  __device__ __forceinline__ void pairs_of_cell(int n) { pairs += n; }
  __device__ __forceinline__ void round() { w[kWarpPairs] += 1; }
  __device__ __forceinline__ void loaded(unsigned v) {
    wait_for(v);
    clock_to(kClkOccLoads);
  }
  __device__ __forceinline__ void stamp(int stage) {
    clock_to(kClkSetup + stage);   // WalkStage's order is the slots'
  }
  // warp sums of the lanes' counts and lane 0's slots into `stats`
  __device__ __forceinline__ void flush(unsigned long long* stats) {
    clock_to(kClkShade);
    w[kClkKernel] = (unsigned long long)last - w[kClkKernel];
    const unsigned lane_sum[] = {walks, entered, cells, pairs, cam, shadow,
                                 empty};
    const int lane_slot[] = {kWalks, kEntered, kCells, kPairs, kCamCells,
                             kShadowCells, kEmpty};
    for (int i = 0; i < 7; ++i)
      w[lane_slot[i]] = __reduce_add_sync(kAll, lane_sum[i]);
    w[kSchedCam] = __reduce_max_sync(kAll, cam);
    w[kSchedShadow] = __reduce_max_sync(kAll, shadow);
    w[kSchedAll] = __reduce_max_sync(kAll, cam + shadow);
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < kStatSlots; ++i)
        if (w[i]) atomicAdd(stats + i, w[i]);
  }
};

template <>
struct Tally<false> {
  __device__ __forceinline__ void enter() {}   // the per-lane walk's
  __device__ __forceinline__ void cell() {}
  __device__ __forceinline__ void pair() {}
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void begin(bool, int) {}
  __device__ __forceinline__ void clock_to(int) {}
  __device__ __forceinline__ void walk(bool, bool) {}
  __device__ __forceinline__ void step() {}
  __device__ __forceinline__ void cell(bool) {}
  __device__ __forceinline__ void pairs_of_cell(int) {}
  __device__ __forceinline__ void round() {}
  __device__ __forceinline__ void loaded(unsigned) {}
  __device__ __forceinline__ void stamp(int) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

// The kernel's parameters of the grid: the frame lies in device memory
// (the wrapper computes vmax there) and is staged in shared memory.
struct GridArgs {
  const float4* rows;
  const int2* span;
  const unsigned* occ;  // the occupancy bitmap, `words` words
  const float* frame;   // vmin.xyz, vmax.xyz, cell size.xyz
  int rx, ry, rz, words;
};

// B11 stages the occupancy bitmap in shared memory up to this many words
// (16 KiB: 131,072 cells; the 20,736-triangle sheet's grid takes 1,836),
// so that the 8 blocks an SM runs keep their residency; a larger grid's
// bitmap, and B11w's (a block walks 256 rays once: staging costs more
// than it saves), is read from device memory (32 cells a word, in L1).
constexpr int kOccSmemWords = 4096;
constexpr int kFrameFloats = 12;   // the frame's 9, padded to 16 bytes

__host__ __device__ __forceinline__ int occ_smem_words(int words) {
  return words <= kOccSmemWords ? words : 0;
}

// The grid of the kernel's arguments with its frame and, when `stage_occ`
// and it fits, its bitmap copied by the block's threads to `smem`
// (kFrameFloats, then the bitmap); the caller syncs the block.
__device__ __forceinline__ Grid load_grid(const GridArgs& a, float* smem,
                                          bool stage_occ) {
  Grid G;
  G.rows = a.rows;
  G.span = a.span;
  G.occ = a.occ;
  if (threadIdx.x < 9) smem[threadIdx.x] = __ldg(a.frame + threadIdx.x);
  G.frame = smem;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + kFrameFloats);
  if (stage_occ && occ_smem_words(a.words)) {
    for (int i = threadIdx.x; i < a.words; i += blockDim.x)
      bits[i] = __ldg(a.occ + i);
    G.occ = bits;
  }
  G.rx = a.rx;
  G.ry = a.ry;
  G.rz = a.rz;
  return G;
}

// B11w's inputs besides the rays: the running hit's columns, each with
// its element stride (0: one value broadcast to every ray).
struct WalkIn {
  const float* t;
  const int* m;
  const float *nx, *ny, *nz;
  const unsigned char* needs;
  int st, sm, snx, sny, snz, sneeds;
};

// B11's walks: the per-lane walk (pt_device.cuh::grid_closest,
// grid_occluded) on the lanes that walk, each at its own pace (kNest: the
// camera walks, whose lanes then test their occupied cells together); the
// counting instantiation runs its lockstep twin (grid_walk without the
// pool) on every lane.
template <bool kNest, bool kStats>
__device__ __forceinline__ void b11_closest(const Grid& G, Tally<kStats>& T,
                                            bool active, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, bool neg_t, PreHit& h) {
  if constexpr (kStats)
    grid_walk<false, false, kNest>(G, nullptr, active, ox, oy, oz, dx, dy,
                                   dz, neg_t, h, T);
  else if (active)
    grid_closest<kNest>(G, ox, oy, oz, dx, dy, dz, neg_t, h, T);
}

template <bool kStats>
__device__ __forceinline__ bool b11_occluded(const Grid& G, Tally<kStats>& T,
                                             bool active, float ox, float oy,
                                             float oz, float dx, float dy,
                                             float dz, bool neg_t) {
  PreHit limit{kBig, 0, 0.0f, 0.0f, 0.0f, false};
  if constexpr (kStats)
    return grid_walk<true, false, false>(G, nullptr, active, ox, oy, oz, dx,
                                         dy, dz, neg_t, limit, T);
  else
    return active &&
           grid_occluded(G, ox, oy, oz, dx, dy, dz, kBig, neg_t, T);
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
  float* smem = reinterpret_cast<float*>(smem4);
  const Scene S = stage_scene(scene, smem, 0, nl, ns, nq);
  const Grid G = load_grid(
      ga, smem + ((scene_floats(0, nl, ns, nq) + 3) & ~3), true);
  __syncthreads();
  const bool neg_t = neg_t_flag != 0;
  const bool carry_t = carry_t_flag != 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ii_i = blockIdx.x * kTileW + (warp & 1) * 8 + (lane & 7);
  const int jj_row = blockIdx.y * kTileH + (warp >> 1) * 4 + (lane >> 3);
  // every lane runs to the end (grid_walk is warp-wide); lanes past the
  // film's edge walk nothing and write nothing
  const bool in_film = ii_i < width && jj_row < rows;
  const uint32_t row_u = (uint32_t)jj_row + row_offset;
  const uint32_t pixel_index = row_u * (uint32_t)width + (uint32_t)ii_i;
  const float ii = (float)ii_i;
  const float jj = (float)(int)row_u;
  T.start();

  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  for (int s = 0; s < spp; ++s) {
    T.clock_to(kClkShade);
    const uint32_t s32 = (uint32_t)s + spp_offset;
    const uint32_t ray_id = pixel_index * spp_total + s32;
    const Ray ry = primary_ray(S, k0, k1, ray_id, ii, jj);
    const float ox = ry.ox, oy = ry.oy, oz = ry.oz;
    const float dx = ry.dx, dy = ry.dy, dz = ry.dz;

    PreHit h0 = pre_tri(S, ox, oy, oz, dx, dy, dz, kBig, neg_t, 3);
    T.begin(false, kClkCamera);
    b11_closest<true>(G, T, in_film, ox, oy, oz, dx, dy, dz, neg_t, h0);
    const Hit h = finish(h0);

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
      const bool cast = in_film && lit && lamb >= 0.0f;
      bool occ;
      if (carry_t) {
        PreHit hs = pre_tri(S, x, y, z, ldx, ldy, ldz, t_run, neg_t, 3);
        T.begin(true, kClkShadow);
        b11_closest<false>(G, T, cast, x, y, z, ldx, ldy, ldz, neg_t, hs);
        occ = hs.m != 0;
        if (cast) t_run = hs.t;
      } else {
        occ = cast && occluded_pre(S, x, y, z, ldx, ldy, ldz, kBig, neg_t);
        T.begin(true, kClkShadow);
        if (b11_occluded(G, T, cast && !occ, x, y, z, ldx, ldy, ldz, neg_t))
          occ = true;
      }
      if (cast && !occ) {
        const float dqx = lx - x, dqy = ly - y, dqz = lz - z;
        const float dist2 = dqx * dqx + dqy * dqy + dqz * dqz;
        ti = ti + lamb * fminf(li / dist2, 1.0f);
      }
    }
    T.clock_to(kClkShadow);
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
  if (in_film) {
    float* o = out + 3 * ((long long)jj_row * width + ii_i);
    o[0] = fr * kExposure;
    o[1] = fg * kExposure;
    o[2] = fb * kExposure;
  }
  T.flush(stats);
}

// B11w: the grid walk of ray i over (o, d) (n, 3) and the running hit (t,
// m, n, needs), each read at element i * its stride (0: one value for
// every ray), into the fresh outputs (n,).
template <bool kStats>
__global__ void __launch_bounds__(kWalkBlock)
grid_walk_kernel(GridArgs ga, const float* __restrict__ o,
                 const float* __restrict__ d, WalkIn in,
                 float* __restrict__ t_out, int* __restrict__ m_out,
                 float* __restrict__ nx_out, float* __restrict__ ny_out,
                 float* __restrict__ nz_out,
                 unsigned char* __restrict__ needs_out, int n,
                 int neg_t_flag, unsigned long long* __restrict__ stats) {
  extern __shared__ float4 smem_grid[];
  __shared__ unsigned long long keys[kWalkBlock];   // grid_walk's
  const Grid G = load_grid(ga, reinterpret_cast<float*>(smem_grid), false);
  __syncthreads();
  // every lane runs to the end (grid_walk is warp-wide); lanes past n walk
  // ray n - 1's input and write nothing
  const long long i0 = (long long)blockIdx.x * kWalkBlock + threadIdx.x;
  const bool live = i0 < n;
  const long long i = live ? i0 : n - 1;
  Tally<kStats> T;
  T.start();
  PreHit h{__ldg(in.t + i * in.st), __ldg(in.m + i * in.sm),
           __ldg(in.nx + i * in.snx), __ldg(in.ny + i * in.sny),
           __ldg(in.nz + i * in.snz), __ldg(in.needs + i * in.sneeds) != 0};
  T.begin(false, kClkCamera);
  grid_walk<false, true, false>(G, keys + (threadIdx.x & ~31), live,
                                o[3 * i], o[3 * i + 1], o[3 * i + 2],
                                d[3 * i], d[3 * i + 1], d[3 * i + 2],
                                neg_t_flag != 0, h, T);
  if (live) {
    t_out[i] = h.t;
    m_out[i] = h.m;
    nx_out[i] = h.nx;
    ny_out[i] = h.ny;
    nz_out[i] = h.nz;
    needs_out[i] = h.needs ? 1 : 0;
  }
  T.flush(stats);
}

GridArgs grid_args(const float* rows, const int* span, const void* occ,
                   const float* frame, int rx, int ry, int rz) {
  GridArgs a;
  a.rows = reinterpret_cast<const float4*>(rows);
  a.span = reinterpret_cast<const int2*>(span);
  a.occ = reinterpret_cast<const unsigned*>(occ);
  a.frame = frame;
  a.rx = rx;
  a.ry = ry;
  a.rz = rz;
  a.words = (int)(((long long)rx * ry * rz + 31) / 32);
  return a;
}

// Raises a kernel's dynamic shared memory limit where `smem` passes 48 KiB.
template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Launch B11 on `stream`; returns cudaGetLastError() (0 on success).
// `scene` is ops/mega_super.py::pack_scene's buffer without triangles;
// `tri_rows`, `span`, `occ` and `frame` are ops/grid.py::grid_tables' device
// tensors; `stats`, when not null, points to kStatSlots zeroed uint64
// counters: the counting instantiation runs and adds its Tally there.
extern "C" int mega_grid_launch(const float* scene, int nl, int ns, int nq,
                                const float* tri_rows, const int* span,
                                const void* occ, const float* frame, int rx,
                                int ry, int rz, unsigned k0, unsigned k1,
                                unsigned spp_offset, unsigned spp_total,
                                unsigned row_offset, int rows, int width,
                                int spp, int neg_t, int carry_t, float* out,
                                void* stats, void* stream) {
  if ((long long)rows * width <= 0) return 0;
  const GridArgs ga = grid_args(tri_rows, span, occ, frame, rx, ry, rz);
  // the triangle-free scene (pt_device.cuh::scene_floats(0, ...)) to a
  // 16-byte boundary, the frame, the bitmap
  const size_t smem =
      sizeof(float) * (size_t)(((12 + nl * 4 + ns * 3 + 2 * nq + 3) & ~3) +
                               kFrameFloats + occ_smem_words(ga.words));
  auto kernel = stats ? mega_grid_kernel<true> : mega_grid_kernel<false>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((rows + kTileH - 1) / kTileH));
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, nl, ns, nq, ga, k0, k1, spp_offset, spp_total, row_offset,
      rows, width, spp, neg_t, carry_t, out,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

// Launch B11w over n rays on `stream`: (t, m, nx, ny, nz, needs) are read
// at element i * their stride (`needs` a bool tensor's bytes), the walk's
// hit is written to the fresh (n,) outputs.  Returns cudaGetLastError().
extern "C" int grid_walk_launch(const float* tri_rows, const int* span,
                                const void* occ, const float* frame, int rx,
                                int ry, int rz, const float* o,
                                const float* d, const float* t, int st,
                                const int* m, int sm, const float* nx,
                                int snx, const float* ny, int sny,
                                const float* nz, int snz, const void* needs,
                                int sneeds, float* t_out, int* m_out,
                                float* nx_out, float* ny_out, float* nz_out,
                                void* needs_out, int n, int neg_t,
                                void* stats, void* stream) {
  if (n <= 0) return 0;
  const GridArgs ga = grid_args(tri_rows, span, occ, frame, rx, ry, rz);
  const size_t smem = sizeof(float) * kFrameFloats;   // the bitmap unstaged
  auto kernel = stats ? grid_walk_kernel<true> : grid_walk_kernel<false>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  const WalkIn in{t, m, nx, ny, nz,
                  reinterpret_cast<const unsigned char*>(needs), st, sm, snx,
                  sny, snz, sneeds};
  const unsigned blocks = (unsigned)((n + kWalkBlock - 1) / kWalkBlock);
  kernel<<<blocks, kWalkBlock, smem, (cudaStream_t)stream>>>(
      ga, o, d, in,
      t_out, m_out, nx_out, ny_out, nz_out,
      reinterpret_cast<unsigned char*>(needs_out), n, neg_t,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

extern "C" const char* mega_grid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
