// Super megakernel for large meshes: the whole mirror-free `super` sample
// step, all spp, in one kernel, over a Morton-blocked triangle table walked
// behind conservative AABB culls (kernels B2 and B3 of the port).
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
// distance), the 4-material shading, spp accumulation.  The triangles come
// from ops/tri_blocks.py::walk_tables: the JAX package's Morton blocks of
// 128 rows, live blocks only (no NaN padding box reaches the kernel, so
// CUDA's NaN-dropping fminf/fmaxf never meet one), each block with four
// 32-row sub-blocks, and above the macros of <= 8 blocks a tree of union
// boxes (8 Morton-consecutive children a node, siblings near to far).
//
// Exactness.  A node, block or sub-block is skipped only when no ray of the
// warp can hit a triangle in it closer than its running best: the per-lane
// slab test against the padded box, the eps/forward check, and the
// running-t prune with the TPU kernel's relative slack (_PRUNE_SLACK,
// pallas_super.py:301-350), all conservative; a 0 * inf in the slab (an
// axis-parallel ray whose origin lies on a box plane) leaves that axis
// unconstrained.  Every box lies inside its parent's and a sub-block is
// padded by its block's pad, so a lane that passes a box passes every box
// above it.  Scanning rows a lane did not need re-tests them against its
// strictly closer running minimum, so a warp may scan more than each lane
// needs and the result does not change.  Blocks are Morton-reordered, so
// exact cross-multiplied ties (shared mesh edges) go to the lowest
// original index (_tri_closest_row_blocked, pallas_super.py:222-264),
// carried as an int starting at -1, so a tie against a floor or sphere hit
// is never stolen.
//
// What bounds it on an H100: FP32 issue in the row scans (~48 operations,
// ~60 instructions, per tested (ray, triangle) pair) and the slab tests of
// the walk; the only device-memory traffic is the block table (64 B a
// triangle, re-read from L1/L2) and the 12-byte film write per pixel.  A
// warp pays for the union of its lanes' work, so the design keeps that
// union small.  One thread per pixel, a warp on a compact 8x4 pixel patch
// (a block of 4 warps on 16x8) so that its rays are coherent and its votes
// cull.  Per trace the warp walks the node tree without a stack: a node no
// lane needs is skipped with its subtree (the node stores the index after
// it), so the walk grows with the tree's depth, not with the macro count.
// In a taken macro the warp votes on each block, in a taken block on each
// 32-row sub-block, and scans only the sub-blocks some lane needs
// (broadcast float4 loads, every lane the same row).  Shadow rays the
// shading ignores (sky, facing-ratio, back-facing lights) do not vote, and
// an occlusion walk ends when every voting lane is occluded.  Every lane of
// a warp runs every walk (ghost pixels past the film edge included), so the
// votes see all 32 lanes.  Built with --fmad=false and without fast math,
// like B1.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 16;            // block tile: 16 x 8 pixels,
constexpr int kTileH = 8;             // warp w on the 8 x 4 patch (w&1, w>>1)
constexpr int kBlock = kTileW * kTileH;
constexpr int kRowsPerBlock = 128;    // triangles per Morton block
constexpr int kSubRows = 32;          // rows per sub-block
constexpr int kSubs = kRowsPerBlock / kSubRows;

// The block tables (ops/tri_blocks.py::walk_tables): 4 float4 per row
// (v0.xyz e0.x | e0.yz e2.xy | e2.z n.xyz | index bits, pad), 2 per block
// box (lo.xyz 0 | hi.xyz 0), 2 per sub-block (lo.xyz row count | hi.xyz
// 0), 2 per tree node in depth-first order: a macro leaf (lo.xyz block
// count | hi.xyz first block) or an internal node (lo.xyz index of the
// node after its subtree | hi.xyz -1).
struct Mesh {
  const float4* rows;
  const float4* boxes;
  const float4* subs;
  const float4* nodes;
  int n_blocks;
  int n_nodes;
};

// Closest-hit predicate: may a triangle in the box beat (bn / bd)?
__device__ __forceinline__ bool box_closest(float4 lo, float4 hi,
                                            const RayInv& r, float bn,
                                            float bd, bool neg_t) {
  float tmin, tmax;
  slab(lo, hi, r, tmin, tmax);
  bool hit = tmax >= tmin;
  if (!neg_t)
    hit = hit && tmax >= kEps && fmaxf(tmin, 0.0f) * bd <= bn * kSlack;
  return hit;
}

// Occlusion predicate: may a triangle in the box hit below t_limit?
__device__ __forceinline__ bool box_occ(float4 lo, float4 hi,
                                        const RayInv& r, float tl,
                                        bool neg_t) {
  float tmin, tmax;
  slab(lo, hi, r, tmin, tmax);
  bool hit = tmax >= tmin;
  if (!neg_t) hit = hit && tmax >= kEps && tmin <= tl * kSlack;
  return hit;
}

// Warp-wide work tally of the counting instantiation (kStats): every lane
// keeps the same counts (they follow warp votes), lane 0 adds them to the
// stats buffer at the end.  [0] the yardstick's (ray, triangle) pairs: in
// the 128-row blocks whose box the ray's own test passes when the parent
// design's near-to-far block walk tests it (replayed for the count:
// yard_closest, yard_occ), [1] pairs the warp tests (32 lanes x the rows
// it scans), [2] tree-node box tests (the macro level and above), [3]
// block and [4] sub-block box tests, clock64 cycles [5] in the walks (box
// tests, votes and scans) and [6] in the row scans, [7] in the whole
// kernel less the replays, [8] this walk's own need: the real rows of the
// 32-row sub-blocks whose box the ray's own test passes.  The timed
// instantiation keeps none of it.
constexpr int kStatSlots = 9;

template <bool kStats>
struct Tally {
  unsigned long long v[kStatSlots] = {};
  // slot += rows for each lane whose own test passes
  __device__ __forceinline__ void need(int slot, bool lane_need, int rows) {
    v[slot] += (unsigned long long)__popc(__ballot_sync(kAll, lane_need)) *
               (unsigned)rows;
  }
  __device__ __forceinline__ void add(int slot, long long n) { v[slot] += n; }
  __device__ __forceinline__ long long clock() { return clock64(); }
  __device__ __forceinline__ void flush(unsigned long long* stats) {
    if ((threadIdx.x & 31) != 0) return;
    for (int i = 0; i < kStatSlots; ++i) atomicAdd(stats + i, v[i]);
  }
};

template <>
struct Tally<false> {
  __device__ __forceinline__ void need(int, bool, int) {}
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ long long clock() { return 0; }
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

// The closest-hit row test of the kRows rows from `rows`: updates the
// det-scaled running minimum (bn, bd), its original index bi and the
// hit's material and normal, for `active` lanes.  The row pointer steps
// by one row, so a row's four loads take immediate offsets from it (rows
// past the mesh are zero: det = 0 never hits).
template <int kRows>
__device__ __forceinline__ void scan_closest(const float4* rows, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, bool neg_t,
                                             bool active, float& bn,
                                             float& bd, int& bi, PreHit& h) {
#pragma unroll 2
  for (int i = 0; i < kRows; ++i, rows += 4) {
    const float4 a = __ldg(rows);
    const float4 c = __ldg(rows + 1);
    const float4 e = __ldg(rows + 2);
    const int idx = __float_as_int(__ldg(rows + 3).x);
    const Quads q = row_quads(a, c, e, ox, oy, oz, dx, dy, dz);
    const float num = q.tn_s * bd;
    const float den = bn * q.dd;
    if (active && quads_valid(q, neg_t) &&
        (num < den || (num == den && idx < bi))) {
      bn = q.tn_s;
      bd = q.dd;
      bi = idx;
      h.m = 4;
      h.nx = e.y;
      h.ny = e.z;
      h.nz = e.w;
      h.needs = false;
    }
  }
}

// The yardstick's count of a closest-hit trace (counting instantiation
// only): the parent design's walk, replayed from the running distance
// t_pre of the non-triangle stages - every live block in the tables'
// near-to-far order voted, a taken block's 128 rows scanned.  (That walk
// also tested each macro of 8 blocks first; a macro box holds its blocks'
// boxes, so a macro no lane passes holds no block a lane passes, and
// skipping it changed no count.)  It tallies the pairs of the blocks each
// lane's own test passes; its scans only evolve the running minimum the
// prune reads, exactly as that walk did.
template <bool kStats>
__device__ void yard_closest(const Mesh& M, const RayInv& ri, float ox,
                             float oy, float oz, float dx, float dy,
                             float dz, float t_pre, bool neg_t, bool active,
                             Tally<kStats>& T) {
  float bn = t_pre, bd = 1.0f;
  int bi = -1;
  PreHit h{};
  for (int b = 0; b < M.n_blocks; ++b) {
    const bool need =
        active && box_closest(__ldg(M.boxes + 2 * b),
                              __ldg(M.boxes + 2 * b + 1), ri, bn, bd, neg_t);
    if (!__any_sync(kAll, need)) continue;
    T.need(0, need, kRowsPerBlock);
    scan_closest<kRowsPerBlock>(M.rows + 4ll * kRowsPerBlock * b, ox, oy, oz,
                                dx, dy, dz, neg_t, active, bn, bd, bi, h);
  }
}

// The yardstick's count of an occlusion walk (counting instantiation
// only), from `occ` = the lane's non-triangle result: as yard_closest,
// each lane's scan ending at its first occluder, the walk when every
// active lane is occluded.
template <bool kStats>
__device__ void yard_occ(const Mesh& M, const RayInv& ri, float ox,
                         float oy, float oz, float dx, float dy, float dz,
                         float t_limit, bool neg_t, bool active, bool occ,
                         Tally<kStats>& T) {
  for (int b = 0; b < M.n_blocks; ++b) {
    if (!__any_sync(kAll, active && !occ)) break;
    const bool need =
        active && !occ &&
        box_occ(__ldg(M.boxes + 2 * b), __ldg(M.boxes + 2 * b + 1), ri,
                t_limit, neg_t);
    if (!__any_sync(kAll, need)) continue;
    T.need(0, need, kRowsPerBlock);
    if (!active || occ) continue;
    const float4* rows = M.rows + 4ll * kRowsPerBlock * b;
    for (int i = 0; i < kRowsPerBlock; ++i, rows += 4) {
      const Quads q = row_quads(__ldg(rows), __ldg(rows + 1), __ldg(rows + 2),
                                ox, oy, oz, dx, dy, dz);
      if (quads_valid(q, neg_t) && q.tn_s < t_limit * q.dd) {
        occ = true;
        break;
      }
    }
  }
}

// Closest hit over floor, squares, spheres and the blocked triangles,
// seeded with t0.  `active` lanes vote and update; the others run the
// walk for the votes' sake and return garbage.
template <bool kStats>
__device__ Hit trace_blocked(const Scene& S, const Mesh& M, float ox,
                             float oy, float oz, float dx, float dy,
                             float dz, float t0, bool neg_t, bool active,
                             Tally<kStats>& T) {
  PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, t0, neg_t, 3);
  const RayInv ri = ray_inv(ox, oy, oz, dx, dy, dz);
  const float t_pre = h.t;
  float bn = h.t, bd = 1.0f;
  int bi = -1;
  const long long w0 = T.clock();
  int ni = 0;
  while (ni < M.n_nodes) {
    const float4 lo = __ldg(M.nodes + 2 * ni);
    const float4 hi = __ldg(M.nodes + 2 * ni + 1);
    const int first = __float_as_int(hi.w);   // -1: an internal node
    T.add(2, 1);
    if (!__any_sync(kAll, active && box_closest(lo, hi, ri, bn, bd,
                                                neg_t))) {
      ni = first < 0 ? __float_as_int(lo.w) : ni + 1;
      continue;
    }
    ++ni;
    if (first < 0) continue;                   // descend
    const int last = first + __float_as_int(lo.w);
    for (int b = first; b < last; ++b) {
      const bool need =
          active && box_closest(__ldg(M.boxes + 2 * b),
                                __ldg(M.boxes + 2 * b + 1), ri, bn, bd,
                                neg_t);
      T.add(3, 1);
      if (!__any_sync(kAll, need)) continue;
      for (int k = 0; k < kSubs; ++k) {
        const float4 slo = __ldg(M.subs + 2 * (kSubs * b + k));
        const float4 shi = __ldg(M.subs + 2 * (kSubs * b + k) + 1);
        if (__float_as_int(slo.w) == 0) break;  // past the mesh's last row
        T.add(4, 1);
        const bool sneed = need && box_closest(slo, shi, ri, bn, bd, neg_t);
        T.need(8, sneed, __float_as_int(slo.w));
        if (!__any_sync(kAll, sneed)) continue;
        const long long s0 = T.clock();
        scan_closest<kSubRows>(
            M.rows + 4 * ((long long)kRowsPerBlock * b + kSubRows * k), ox,
            oy, oz, dx, dy, dz, neg_t, active, bn, bd, bi, h);
        T.add(1, 32 * kSubRows);
        T.add(6, T.clock() - s0);
      }
    }
  }
  T.add(5, T.clock() - w0);
  if constexpr (kStats) {
    const long long y0 = T.clock();
    yard_closest(M, ri, ox, oy, oz, dx, dy, dz, t_pre, neg_t, active, T);
    T.add(7, y0 - T.clock());                 // not the kernel's own work
  }
  h.t = bn / bd;
  return finish(h);
}

// Any-hit occlusion below t_limit over floor, squares, spheres and the
// blocked triangles, for `active` lanes (the others return false).  The
// walk ends when every active lane is occluded.
template <bool kStats>
__device__ bool occluded_blocked(const Scene& S, const Mesh& M, float ox,
                                 float oy, float oz, float dx, float dy,
                                 float dz, float t_limit, bool neg_t,
                                 bool active, Tally<kStats>& T) {
  bool occ = active && occluded_pre(S, ox, oy, oz, dx, dy, dz, t_limit,
                                    neg_t);
  const RayInv ri = ray_inv(ox, oy, oz, dx, dy, dz);
  if constexpr (kStats) {
    const long long y0 = T.clock();
    yard_occ(M, ri, ox, oy, oz, dx, dy, dz, t_limit, neg_t, active, occ, T);
    T.add(7, y0 - T.clock());                 // not the kernel's own work
  }
  const long long w0 = T.clock();
  int ni = 0;
  while (ni < M.n_nodes) {
    if (!__any_sync(kAll, active && !occ)) break;
    const float4 lo = __ldg(M.nodes + 2 * ni);
    const float4 hi = __ldg(M.nodes + 2 * ni + 1);
    const int first = __float_as_int(hi.w);
    T.add(2, 1);
    if (!__any_sync(kAll, active && !occ &&
                              box_occ(lo, hi, ri, t_limit, neg_t))) {
      ni = first < 0 ? __float_as_int(lo.w) : ni + 1;
      continue;
    }
    ++ni;
    if (first < 0) continue;
    const int last = first + __float_as_int(lo.w);
    for (int b = first; b < last; ++b) {
      const bool need =
          active && !occ &&
          box_occ(__ldg(M.boxes + 2 * b), __ldg(M.boxes + 2 * b + 1), ri,
                  t_limit, neg_t);
      T.add(3, 1);
      if (!__any_sync(kAll, need)) continue;
      for (int k = 0; k < kSubs; ++k) {
        const float4 slo = __ldg(M.subs + 2 * (kSubs * b + k));
        const float4 shi = __ldg(M.subs + 2 * (kSubs * b + k) + 1);
        if (__float_as_int(slo.w) == 0) break;
        T.add(4, 1);
        const bool sneed =
            need && !occ && box_occ(slo, shi, ri, t_limit, neg_t);
        T.need(8, sneed, __float_as_int(slo.w));
        if (!__any_sync(kAll, sneed)) continue;
        const long long s0 = T.clock();
        if (active && !occ) {
          const float4* rows =
              M.rows + 4 * ((long long)kRowsPerBlock * b + kSubRows * k);
#pragma unroll 2
          for (int i = 0; i < kSubRows; ++i, rows += 4) {
            const float4 a = __ldg(rows);
            const float4 c = __ldg(rows + 1);
            const float4 e = __ldg(rows + 2);
            const Quads q = row_quads(a, c, e, ox, oy, oz, dx, dy, dz);
            if (quads_valid(q, neg_t) && q.tn_s < t_limit * q.dd) {
              occ = true;
              break;
            }
          }
        }
        T.add(1, 32 * kSubRows);
        T.add(6, T.clock() - s0);
      }
    }
  }
  T.add(5, T.clock() - w0);
  return occ;
}

template <bool kStats>
__global__ void __launch_bounds__(kBlock)
mega_blocked_kernel(const float* __restrict__ scene, int nl, int ns, int nq,
                    Mesh M, uint32_t k0, uint32_t k1, uint32_t spp_offset,
                    uint32_t spp_total, uint32_t row_offset, int rows,
                    int width, int spp, int neg_t_flag, int carry_t_flag,
                    float* __restrict__ out,
                    unsigned long long* __restrict__ stats) {
  Tally<kStats> T;
  const long long k_start = T.clock();
  extern __shared__ float4 smem4[];
  const Scene S = stage_scene(scene, reinterpret_cast<float*>(smem4), 0, nl,
                              ns, nq);
  __syncthreads();
  const bool neg_t = neg_t_flag != 0;
  const bool carry_t = carry_t_flag != 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ii_i = blockIdx.x * kTileW + (warp & 1) * 8 + (lane & 7);
  const int jj_row = blockIdx.y * kTileH + (warp >> 1) * 4 + (lane >> 3);
  // ghost pixels past the film edge render (their lanes vote) and are
  // not written
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

    const Hit h =
        trace_blocked(S, M, ox, oy, oz, dx, dy, dz, kBig, neg_t, true, T);

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
        const Hit hs = trace_blocked(S, M, x, y, z, ldx, ldy, ldz, t_run,
                                     neg_t, cast, T);
        occ = hs.m != 0;
        if (cast) t_run = hs.t;
      } else {
        occ = occluded_blocked(S, M, x, y, z, ldx, ldy, ldz, kBig, neg_t,
                               cast, T);
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
  T.add(7, T.clock() - k_start);
  T.flush(stats);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `scene`
// is ops/mega_super.py::pack_scene's buffer without triangles; `stats`,
// when not null, points to kStatSlots zeroed uint64 counters: the counting
// instantiation runs and adds its Tally there.
extern "C" int mega_blocked_launch(const float* scene, int nl, int ns, int nq,
                                   const float* rows_tbl, const float* boxes,
                                   int n_blocks, const float* subs,
                                   const float* nodes, int n_nodes,
                                   unsigned k0, unsigned k1,
                                   unsigned spp_offset, unsigned spp_total,
                                   unsigned row_offset, int rows, int width,
                                   int spp, int neg_t, int carry_t,
                                   float* out, void* stats, void* stream) {
  if ((long long)rows * width <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(12 + nl * 4 + ns * 3 + 2 * nq);
  auto kernel = stats ? mega_blocked_kernel<true> : mega_blocked_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Mesh M;
  M.rows = reinterpret_cast<const float4*>(rows_tbl);
  M.boxes = reinterpret_cast<const float4*>(boxes);
  M.subs = reinterpret_cast<const float4*>(subs);
  M.nodes = reinterpret_cast<const float4*>(nodes);
  M.n_blocks = n_blocks;
  M.n_nodes = n_nodes;
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((rows + kTileH - 1) / kTileH));
  kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, nl, ns, nq, M, k0, k1, spp_offset, spp_total, row_offset, rows,
      width, spp, neg_t, carry_t, out,
      reinterpret_cast<unsigned long long*>(stats));
  return (int)cudaGetLastError();
}

extern "C" const char* mega_blocked_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
