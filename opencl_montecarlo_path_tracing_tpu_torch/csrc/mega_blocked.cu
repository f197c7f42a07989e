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
// from ops/tri_blocks.py::kernel_tables: the JAX package's Morton blocks
// of 128 rows in near-to-far macro order, live blocks only (no NaN padding
// box reaches the kernel, so CUDA's NaN-dropping fminf/fmaxf never meet
// one), macros of <= 8 blocks with their union boxes.
//
// Exactness.  A block is skipped only when no ray of the warp can hit a
// triangle in it closer than its running best: the per-lane slab test
// against the padded box, the eps/forward check, and the running-t prune
// with the TPU kernel's relative slack (_PRUNE_SLACK, pallas_super.py:
// 301-350), all conservative; a 0 * inf in the slab (an axis-parallel ray
// whose origin lies on a box plane) leaves that axis unconstrained.
// Scanning a block a lane did not need re-tests rows against its strictly
// closer running minimum, so a warp may scan more than each lane needs and
// the result does not change.  Blocks are Morton-reordered, so exact
// cross-multiplied ties (shared mesh edges) go to the lowest original
// index (_tri_closest_row_blocked, pallas_super.py:222-264), carried as an
// int starting at -1, so a tie against a floor or sphere hit is never
// stolen.
//
// What bounds it on an H100: FP32 issue in the row scans (~48 operations
// per tested (ray, triangle) pair) and, on the largest meshes, the
// per-macro slab tests every trace runs; the only device-memory traffic
// is the block table (64 B a triangle, re-read from L1/L2) and the 12-byte
// film write per pixel.  Design: one thread per pixel, a warp on a compact
// 8x4 pixel patch (a block of 4 warps on 16x8) so its rays are coherent
// and its votes cull; per trace the warp walks the macros, takes a macro
// when __any_sync says any lane needs it, then each of its blocks the same
// way, and scans a taken block's 128 rows (broadcast float4 loads, every
// lane the same row); shadow rays the shading ignores (sky, facing-ratio,
// back-facing lights) do not vote, and an occlusion walk ends when every
// voting lane is occluded.  Every lane of a warp runs every walk (ghost
// pixels past the film edge included), so the votes see all 32 lanes.
// Built with --fmad=false and without fast math, like B1.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 16;            // block tile: 16 x 8 pixels,
constexpr int kTileH = 8;             // warp w on the 8 x 4 patch (w&1, w>>1)
constexpr int kBlock = kTileW * kTileH;
constexpr int kRowsPerBlock = 128;    // triangles per Morton block
constexpr float kSlack = 1.001f;      // _PRUNE_SLACK = float32(1 + 1e-3)
constexpr unsigned kAll = 0xffffffffu;

// The block tables (ops/tri_blocks.py::kernel_tables): 4 float4 per row
// (v0.xyz e0.x | e0.yz e2.xy | e2.z n.xyz | index bits, pad), 2 per block
// box (lo.xyz 0 | hi.xyz 0), 2 per macro (lo.xyz first | hi.xyz count).
struct Mesh {
  const float4* rows;
  const float4* boxes;
  const float4* macros;
  int n_macros;
  // optional work tally, per render: [0] (ray, triangle) pairs in blocks
  // the ray needs, [1] pairs the warps test (32 lanes x 128 rows a taken
  // block), [2] macro box tests and [3] block box tests, per warp
  unsigned long long* stats;
};

struct RayInv {
  float ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ RayInv ray_inv(float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  return RayInv{ox, oy, oz, 1.0f / dx, 1.0f / dy, 1.0f / dz};
}

// One slab axis; NaN (0 * inf) leaves the axis unconstrained.
__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float inv, float& tn, float& tf) {
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  if (t0 != t0 || t1 != t1) {
    tn = __int_as_float(0xff800000);   // -inf
    tf = __int_as_float(0x7f800000);   // +inf
  } else {
    tn = fminf(t0, t1);
    tf = fmaxf(t0, t1);
  }
}

__device__ __forceinline__ void slab(float4 lo, float4 hi, const RayInv& r,
                                     float& tmin, float& tmax) {
  float nx, fx, ny, fy, nz, fz;
  slab_axis(lo.x, hi.x, r.ox, r.ix, nx, fx);
  slab_axis(lo.y, hi.y, r.oy, r.iy, ny, fy);
  slab_axis(lo.z, hi.z, r.oz, r.iz, nz, fz);
  tmin = fmaxf(fmaxf(nx, ny), nz);
  tmax = fminf(fminf(fx, fy), fz);
}

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

// Warp-wide work tally (all 32 lanes call it; lane 0 adds).
__device__ __forceinline__ void tally(const Mesh& M, int slot, bool need) {
  if (M.stats == nullptr) return;
  const unsigned n = __popc(__ballot_sync(kAll, need));
  if ((threadIdx.x & 31) != 0) return;
  if (slot == 0) {
    atomicAdd(M.stats, (unsigned long long)n * kRowsPerBlock);
    atomicAdd(M.stats + 1, 32ull * kRowsPerBlock);
  } else {
    atomicAdd(M.stats + slot, 1ull);
  }
}

// Closest hit over floor, squares, spheres and the blocked triangles,
// seeded with t0.  `active` lanes vote and update; the others run the
// walk for the votes' sake and return garbage.
__device__ Hit trace_blocked(const Scene& S, const Mesh& M, float ox,
                             float oy, float oz, float dx, float dy,
                             float dz, float t0, bool neg_t, bool active) {
  PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, t0, neg_t, 3);
  const RayInv ri = ray_inv(ox, oy, oz, dx, dy, dz);
  float bn = h.t, bd = 1.0f;
  int bi = -1;
  for (int mi = 0; mi < M.n_macros; ++mi) {
    const float4 mlo = __ldg(M.macros + 2 * mi);
    const float4 mhi = __ldg(M.macros + 2 * mi + 1);
    const bool mneed = active && box_closest(mlo, mhi, ri, bn, bd, neg_t);
    tally(M, 2, true);
    if (!__any_sync(kAll, mneed)) continue;
    const int b0 = __float_as_int(mlo.w);
    const int b1 = b0 + __float_as_int(mhi.w);
    for (int b = b0; b < b1; ++b) {
      const bool need =
          active && box_closest(__ldg(M.boxes + 2 * b),
                                __ldg(M.boxes + 2 * b + 1), ri, bn, bd,
                                neg_t);
      tally(M, 3, true);
      if (!__any_sync(kAll, need)) continue;
      tally(M, 0, need);
      const float4* rows = M.rows + (long long)b * kRowsPerBlock * 4;
#pragma unroll 2
      for (int i = 0; i < kRowsPerBlock; ++i) {
        const float4 a = __ldg(rows + 4 * i);
        const float4 c = __ldg(rows + 4 * i + 1);
        const float4 e = __ldg(rows + 4 * i + 2);
        const int idx = __float_as_int(__ldg(rows + 4 * i + 3).x);
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
  }
  h.t = bn / bd;
  return finish(h);
}

// Any-hit occlusion below t_limit over floor, squares, spheres and the
// blocked triangles, for `active` lanes (the others return false).  The
// walk ends when every active lane is occluded.
__device__ bool occluded_blocked(const Scene& S, const Mesh& M, float ox,
                                 float oy, float oz, float dx, float dy,
                                 float dz, float t_limit, bool neg_t,
                                 bool active) {
  bool occ = active && occluded_pre(S, ox, oy, oz, dx, dy, dz, t_limit,
                                    neg_t);
  const RayInv ri = ray_inv(ox, oy, oz, dx, dy, dz);
  for (int mi = 0; mi < M.n_macros; ++mi) {
    const bool open = active && !occ;
    if (!__any_sync(kAll, open)) break;
    const float4 mlo = __ldg(M.macros + 2 * mi);
    const float4 mhi = __ldg(M.macros + 2 * mi + 1);
    tally(M, 2, true);
    if (!__any_sync(kAll, open && box_occ(mlo, mhi, ri, t_limit, neg_t)))
      continue;
    const int b0 = __float_as_int(mlo.w);
    const int b1 = b0 + __float_as_int(mhi.w);
    for (int b = b0; b < b1; ++b) {
      const bool need =
          active && !occ &&
          box_occ(__ldg(M.boxes + 2 * b), __ldg(M.boxes + 2 * b + 1), ri,
                  t_limit, neg_t);
      tally(M, 3, true);
      if (!__any_sync(kAll, need)) continue;
      tally(M, 0, need);
      if (active && !occ) {
        const float4* rows = M.rows + (long long)b * kRowsPerBlock * 4;
#pragma unroll 2
        for (int i = 0; i < kRowsPerBlock; ++i) {
          const float4 a = __ldg(rows + 4 * i);
          const float4 c = __ldg(rows + 4 * i + 1);
          const float4 e = __ldg(rows + 4 * i + 2);
          const Quads q = row_quads(a, c, e, ox, oy, oz, dx, dy, dz);
          if (quads_valid(q, neg_t) && q.tn_s < t_limit * q.dd) {
            occ = true;
            break;
          }
        }
      }
    }
  }
  return occ;
}

__global__ void __launch_bounds__(kBlock)
mega_blocked_kernel(const float* __restrict__ scene, int nl, int ns, int nq,
                    Mesh M, uint32_t k0, uint32_t k1, uint32_t spp_offset,
                    uint32_t spp_total, uint32_t row_offset, int rows,
                    int width, int spp, int neg_t_flag, int carry_t_flag,
                    float* __restrict__ out) {
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
        trace_blocked(S, M, ox, oy, oz, dx, dy, dz, kBig, neg_t, true);

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
                                     neg_t, cast);
        occ = hs.m != 0;
        if (cast) t_run = hs.t;
      } else {
        occ = occluded_blocked(S, M, x, y, z, ldx, ldy, ldz, kBig, neg_t,
                               cast);
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
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `scene`
// is ops/mega_super.py::pack_scene's buffer without triangles; `stats`,
// when not null, points to 4 zeroed uint64 counters that receive the work
// tally of Mesh::stats.
extern "C" int mega_blocked_launch(const float* scene, int nl, int ns, int nq,
                                   const float* rows_tbl, const float* boxes,
                                   const float* macros, int n_macros,
                                   unsigned k0, unsigned k1,
                                   unsigned spp_offset, unsigned spp_total,
                                   unsigned row_offset, int rows, int width,
                                   int spp, int neg_t, int carry_t,
                                   float* out, void* stats, void* stream) {
  if ((long long)rows * width <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)(12 + nl * 4 + ns * 3 + 2 * nq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Mesh M;
  M.rows = reinterpret_cast<const float4*>(rows_tbl);
  M.boxes = reinterpret_cast<const float4*>(boxes);
  M.macros = reinterpret_cast<const float4*>(macros);
  M.n_macros = n_macros;
  M.stats = reinterpret_cast<unsigned long long*>(stats);
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((rows + kTileH - 1) / kTileH));
  mega_blocked_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, nl, ns, nq, M, k0, k1, spp_offset, spp_total, row_offset, rows,
      width, spp, neg_t, carry_t, out);
  return (int)cudaGetLastError();
}

extern "C" const char* mega_blocked_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
