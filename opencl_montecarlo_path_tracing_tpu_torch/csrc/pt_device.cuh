// Device code shared by the megakernels (csrc/mega_super.cu, kernel B1;
// csrc/mega_vlp.cu, kernel B4; csrc/mega_blocked.cu, kernels B2/B3;
// csrc/mega_simple.cu, kernel B5), the light pass (csrc/light_pass.cu,
// kernels L1 and L2) and the cell-walk diagnostic (csrc/diag_dda.cu): the
// threefry stream, the packed scene in shared memory, the thin-lens primary
// ray, the det-scaled triangle row test, the closest-hit trace and its
// non-triangle stage, the capped any-hit occlusion test and its
// non-triangle stage, the NaN-safe slab test of the per-warp culls and
// their box predicates, a large mesh's block tables with the
// warp-cooperative closest hit over them (one ray a warp: the full scan
// and the culled walk; the light pass), the uniform triangle grid's DDA
// walk (B11 and B11w), the exact grid's walk (B2/B3, and B4 past 512
// triangles), and the 4-material shading.
//
// Everything sits in an anonymous namespace, so every translation unit
// that includes this header gets its own internal copy and the kernels
// built into one library never collide on a symbol.  The arithmetic keeps
// the JAX package's operation order (ops/pallas_super.py); the kernels are
// built with --fmad=false and without fast math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 0.01f;
constexpr float kBig = 1e9f;
constexpr float kExposure = 3.5f;
constexpr int kSiteLight0 = 2;       // models/common.py SITE_LIGHT0
constexpr uint32_t kSiteStride = 8;  // core/rng.py _SITE_STRIDE
constexpr float kSlack = 1.001f;     // _PRUNE_SLACK = float32(1 + 1e-3)
constexpr unsigned kAll = 0xffffffffu;

// Packed scene buffer (ops/mega_super.py::pack_scene), float32:
//   [ntp*12 triangle table][12 camera: up, right, eye_offset, pos]
//   [nl*4 lights][ns*3 sphere centres][nq square k][nq square z]
struct Scene {
  const float* tri;
  const float* cam;
  const float* lights;
  const float* spheres;
  const float* sq_k;
  const float* sq_z;
  int ntp, nl, ns, nq;
};

__device__ __forceinline__ int scene_floats(int ntp, int nl, int ns, int nq) {
  return ntp * 12 + 12 + nl * 4 + ns * 3 + 2 * nq;
}

// The packed scene read where it lies: `base` is the buffer, in global
// or in shared memory.
__device__ __forceinline__ Scene scene_view(const float* base, int ntp,
                                            int nl, int ns, int nq) {
  Scene S;
  S.tri = base;
  S.cam = S.tri + ntp * 12;
  S.lights = S.cam + 12;
  S.spheres = S.lights + nl * 4;
  S.sq_k = S.spheres + ns * 3;
  S.sq_z = S.sq_k + nq;
  S.ntp = ntp;
  S.nl = nl;
  S.ns = ns;
  S.nq = nq;
  return S;
}

// Copy the packed scene into shared memory `smem` (all threads of the
// block take part; the caller synchronises before reading it).
__device__ __forceinline__ Scene stage_scene(const float* __restrict__ scene,
                                             float* smem, int ntp, int nl,
                                             int ns, int nq) {
  const int n_floats = scene_floats(ntp, nl, ns, nq);
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) smem[i] = scene[i];
  return scene_view(smem, ntp, nl, ns, nq);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round Threefry-2x32 (core/rng.py::threefry2x32, bit-identical).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rots[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rots[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// top 24 bits -> [0, 1), exact in float32
__device__ __forceinline__ float unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The thin-lens ray (core/camera.py::primary_rays) of pixel (ii, jj) for
// the uniforms r1..r4, on the 12-float camera `cam` (up, right,
// eye_offset, pos).
__device__ __forceinline__ Ray camera_ray(const float* cam, float ii,
                                          float jj, float r1, float r2,
                                          float r3, float r4) {
  const float upx = cam[0], upy = cam[1], upz = cam[2];
  const float rix = cam[3], riy = cam[4], riz = cam[5];
  const float eyx = cam[6], eyy = cam[7], eyz = cam[8];
  const float psx = cam[9], psy = cam[10], psz = cam[11];
  const float e1 = (r1 - 0.5f) * 99.0f;
  const float e2 = (r2 - 0.5f) * 99.0f;
  const float dlx = upx * e1 + rix * e2;
  const float dly = upy * e1 + riy * e2;
  const float dlz = upz * e1 + riz * e2;
  Ray r;
  r.ox = psx + dlx;
  r.oy = psy + dly;
  r.oz = psz + dlz;
  const float ax = r3 + ii;
  const float ay = jj + r4;
  float dx = -dlx + (upx * ax + rix * ay + eyx) * 16.0f;
  float dy = -dly + (upy * ax + riy * ay + eyy) * 16.0f;
  float dz = -dlz + (upz * ax + riz * ay + eyz) * 16.0f;
  const float inv_n = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  r.dx = dx * inv_n;
  r.dy = dy * inv_n;
  r.dz = dz * inv_n;
  return r;
}

// Camera draws (site 0, counters 0 and 1: core/rng.py randn_draws) and
// the thin-lens primary ray of pixel (ii, jj) for sample stream `ray_id`.
__device__ __forceinline__ Ray primary_ray(const Scene& S, uint32_t k0,
                                           uint32_t k1, uint32_t ray_id,
                                           float ii, float jj) {
  uint32_t b0, b1, b2, b3;
  threefry(k0, k1, ray_id, 0u, b0, b1);
  threefry(k0, k1, ray_id, 1u, b2, b3);
  return camera_ray(S.cam, ii, jj, unit(b0), unit(b1), unit(b2), unit(b3));
}

// Det-scaled Moller-Trumbore quantities of one triangle row (v0.xyz e0.x |
// e0.yz e2.xy | e2.z ...), sign-adjusted so that dd >= 0: the operation
// order of ops/pallas_super.py::_tri_closest_row and _tri_occ_row.
struct Quads {
  float dd, un_s, vn_s, tn_s;
};

__device__ __forceinline__ Quads row_quads(float4 a, float4 c, float4 e,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz) {
  const float pvx = dy * e.x - dz * c.w;
  const float pvy = dz * c.z - dx * e.x;
  const float pvz = dx * c.w - dy * c.z;
  const float det = a.w * pvx + c.x * pvy + c.y * pvz;
  const float tvx = ox - a.x, tvy = oy - a.y, tvz = oz - a.z;
  const float un = tvx * pvx + tvy * pvy + tvz * pvz;
  const float qvx = tvy * c.y - tvz * c.x;
  const float qvy = tvz * a.w - tvx * c.y;
  const float qvz = tvx * c.x - tvy * a.w;
  const float vn = dx * qvx + dy * qvy + dz * qvz;
  const float tn = c.z * qvx + c.w * qvy + e.x * qvz;
  const float sg = det >= 0.0f ? 1.0f : -1.0f;
  return Quads{det * sg, un * sg, vn * sg, tn * sg};
}

// Inside the triangle, and in front of the origin unless neg_t.
__device__ __forceinline__ bool quads_valid(const Quads& q, bool neg_t) {
  return q.dd >= kEps && q.un_s >= 0.0f && q.un_s <= q.dd &&
         q.vn_s >= 0.0f && q.un_s + q.vn_s <= q.dd &&
         (neg_t || q.tn_s > kEps * q.dd);
}

// Running closest-hit state of a trace: distance, material, normal, and
// whether the normal is a sphere's (renormalised at the end).
struct PreHit {
  float t;
  int m;
  float nx, ny, nz;
  bool needs;
};

// Unit sphere k against the ray: p = o - c and, where the discriminant q
// is positive (the return value), the nearer root s = -b - sqrt(q).  The
// square root runs only there, the only place s is read.
__device__ __forceinline__ bool sphere_root(const Scene& S, int k, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float& px,
                                            float& py, float& pz, float& s) {
  px = ox - S.spheres[3 * k];
  py = oy - S.spheres[3 * k + 1];
  pz = oz - S.spheres[3 * k + 2];
  const float b = px * dx + py * dy + pz * dz;
  const float cc = px * px + py * py + pz * pz - 1.0f;
  const float q = b * b - cc;
  if (!(q > 0.0f)) return false;
  s = -b - sqrtf(q);
  return true;
}

// The unit spheres [k0, k1) of a closest-hit trace, in index order (an
// exact tie keeps the earlier sphere): a root eps < s < h.t becomes the
// running hit, material m.
__device__ __forceinline__ void spheres_closest(const Scene& S, int k0,
                                                int k1, float ox, float oy,
                                                float oz, float dx, float dy,
                                                float dz, int m, PreHit& h) {
  for (int k = k0; k < k1; ++k) {
    float px, py, pz, s;
    if (sphere_root(S, k, ox, oy, oz, dx, dy, dz, px, py, pz, s) &&
        s < h.t && s > kEps) {
      h.t = s;
      h.m = m;
      h.nx = px + dx * s;
      h.ny = py + dy * s;
      h.nz = pz + dz * s;
      h.needs = true;
    }
  }
}

// Whether a unit sphere of [k0, k1) has a root eps < s < t_limit; stops at
// the first.
__device__ __forceinline__ bool spheres_any(const Scene& S, int k0, int k1,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float t_limit) {
  for (int k = k0; k < k1; ++k) {
    float px, py, pz, s;
    if (sphere_root(S, k, ox, oy, oz, dx, dy, dz, px, py, pz, s) &&
        s < t_limit && s > kEps)
      return true;
  }
  return false;
}

// The floor, squares and spheres of a closest-hit trace seeded with the
// running distance t0 (ops/intersect.py::trace_ray before its triangle
// stage): spheres are material `sphere_m`, 3 (diffuse) in the super
// family, 2 (mirror) in the simple tracer.
__device__ __forceinline__ PreHit pre_tri(const Scene& S, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float t0, bool neg_t,
                                          int sphere_m) {
  PreHit h{t0, 0, 0.0f, 0.0f, 0.0f, false};
  const float inv_dz = 1.0f / dz;

  const float p = -oz * inv_dz;
  if (p > kEps && p < h.t) {
    h.t = p;
    h.m = 1;
    h.nz = 1.0f;
  }
  for (int q = 0; q < S.nq; ++q) {
    const float rd = (S.sq_z[q] - oz) * inv_dz;
    const float ix = ox + dx * rd;
    const float iy = oy + dy * rd;
    if (rd < h.t && fabsf(S.sq_k[q] - ix) < 1.0f && fabsf(iy) < 1.0f &&
        (neg_t || rd > kEps)) {
      h.t = rd;
      h.m = 3;
      h.nx = 0.0f;
      h.ny = 0.0f;
      h.nz = 1.0f;
      h.needs = false;
    }
  }
  spheres_closest(S, 0, S.ns, ox, oy, oz, dx, dy, dz, sphere_m, h);
  return h;
}

struct Hit {
  float t;
  int m;
  float nx, ny, nz;
};

// The finished hit: sphere normals renormalised.
__device__ __forceinline__ Hit finish(const PreHit& h) {
  float nx = h.nx, ny = h.ny, nz = h.nz;
  if (h.needs) {
    const float inv_len =
        1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
    nx *= inv_len;
    ny *= inv_len;
    nz *= inv_len;
  }
  return Hit{h.t, h.m, nx, ny, nz};
}

// The normal renormalised as torch.rsqrt does it on a CUDA tensor
// (rsqrtf), the form the light pass's plain version takes
// (ops/intersect.py::trace_ray); B1-B4 keep finish's 1 / sqrtf.
__device__ __forceinline__ Hit finish_rsqrt(const PreHit& h) {
  float nx = h.nx, ny = h.ny, nz = h.nz;
  if (h.needs) {
    const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
    nx = nx * inv_len;
    ny = ny * inv_len;
    nz = nz * inv_len;
  }
  return Hit{h.t, h.m, nx, ny, nz};
}

// Closest hit (ops/intersect.py::trace_ray, sphere material 3), seeded
// with the running distance t0, over the shared-memory triangle table,
// before its sphere normal is renormalised (trace and the light pass's
// traces finish it their own ways).
__device__ __forceinline__ PreHit trace_open(const Scene& S, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float t0,
                                             bool neg_t) {
  PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, t0, neg_t, 3);
  if (S.ntp) {
    // division-free scan: the running minimum is carried det-scaled as
    // (bn, bd); file order decides exact ties (strict <)
    float bn = h.t, bd = 1.0f;
    const float4* rows = reinterpret_cast<const float4*>(S.tri);
#pragma unroll 2
    for (int i = 0; i < S.ntp; ++i) {
      const float4 a = rows[3 * i];      // v0.xyz, e0.x
      const float4 c = rows[3 * i + 1];  // e0.yz, e2.xy
      const float4 e = rows[3 * i + 2];  // e2.z, n.xyz
      const float pvx = dy * e.x - dz * c.w;
      const float pvy = dz * c.z - dx * e.x;
      const float pvz = dx * c.w - dy * c.z;
      const float det = a.w * pvx + c.x * pvy + c.y * pvz;
      const float tvx = ox - a.x, tvy = oy - a.y, tvz = oz - a.z;
      const float un = tvx * pvx + tvy * pvy + tvz * pvz;
      const float qvx = tvy * c.y - tvz * c.x;
      const float qvy = tvz * a.w - tvx * c.y;
      const float qvz = tvx * c.x - tvy * a.w;
      const float vn = dx * qvx + dy * qvy + dz * qvz;
      const float tn = c.z * qvx + c.w * qvy + e.x * qvz;
      const float sg = det >= 0.0f ? 1.0f : -1.0f;
      const float dd = det * sg;
      const float un_s = un * sg;
      const float vn_s = vn * sg;
      const float tn_s = tn * sg;
      if (dd >= kEps && un_s >= 0.0f && un_s <= dd && vn_s >= 0.0f &&
          un_s + vn_s <= dd && (neg_t || tn_s > kEps * dd) &&
          tn_s * bd < bn * dd) {
        bn = tn_s;
        bd = dd;
        h.m = 4;
        h.nx = e.y;
        h.ny = e.z;
        h.nz = e.w;
        h.needs = false;
      }
    }
    h.t = bn / bd;
  }
  return h;
}

// Closest hit with its sphere normal renormalised (B1-B4).
__device__ Hit trace(const Scene& S, float ox, float oy, float oz,
                     float dx, float dy, float dz, float t0, bool neg_t) {
  return finish(trace_open(S, ox, oy, oz, dx, dy, dz, t0, neg_t));
}

// The floor, squares and spheres of an any-hit occlusion test with
// t < t_limit (ops/intersect.py::any_hit before its triangle stage).
__device__ __forceinline__ bool occluded_pre(const Scene& S, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz,
                                             float t_limit, bool neg_t) {
  const float inv_dz = 1.0f / dz;
  const float p = -oz * inv_dz;
  if (p > kEps && p < t_limit) return true;
  for (int q = 0; q < S.nq; ++q) {
    const float rd = (S.sq_z[q] - oz) * inv_dz;
    const float ix = ox + dx * rd;
    const float iy = oy + dy * rd;
    if (rd < t_limit && fabsf(S.sq_k[q] - ix) < 1.0f && fabsf(iy) < 1.0f &&
        (neg_t || rd > kEps))
      return true;
  }
  return spheres_any(S, 0, S.ns, ox, oy, oz, dx, dy, dz, t_limit);
}

// Any-hit occlusion with t < t_limit (ops/intersect.py::any_hit): kBig
// for the super family's uncapped shadow rays, the light distance for
// the VLP family's.  Stops at the first hit.
__device__ bool occluded(const Scene& S, float ox, float oy, float oz,
                         float dx, float dy, float dz, float t_limit,
                         bool neg_t) {
  if (occluded_pre(S, ox, oy, oz, dx, dy, dz, t_limit, neg_t)) return true;
  const float4* rows = reinterpret_cast<const float4*>(S.tri);
#pragma unroll 2
  for (int i = 0; i < S.ntp; ++i) {
    const float4 a = rows[3 * i];
    const float4 c = rows[3 * i + 1];
    const float e2z = S.tri[12 * i + 8];
    const float pvx = dy * e2z - dz * c.w;
    const float pvy = dz * c.z - dx * e2z;
    const float pvz = dx * c.w - dy * c.z;
    const float det = a.w * pvx + c.x * pvy + c.y * pvz;
    const float tvx = ox - a.x, tvy = oy - a.y, tvz = oz - a.z;
    const float un = tvx * pvx + tvy * pvy + tvz * pvz;
    const float qvx = tvy * c.y - tvz * c.x;
    const float qvy = tvz * a.w - tvx * c.y;
    const float qvz = tvx * c.x - tvy * a.w;
    const float vn = dx * qvx + dy * qvy + dz * qvz;
    const float tn = c.z * qvx + c.w * qvy + e2z * qvz;
    const float sg = det >= 0.0f ? 1.0f : -1.0f;
    const float dd = det * sg;
    const float un_s = un * sg;
    const float vn_s = vn * sg;
    const float tn_s = tn * sg;
    if (dd >= kEps && un_s >= 0.0f && un_s <= dd && vn_s >= 0.0f &&
        un_s + vn_s <= dd && tn_s < t_limit * dd &&
        (neg_t || tn_s > kEps * dd))
      return true;
  }
  return false;
}

// A ray's origin and reciprocal direction, for slab tests against boxes
// (the per-warp culls of B4 and B5, the light pass's culled walk).
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

// The culls' box predicates (kernel B4, the light pass's walk), all
// conservative: the slab of the padded box, the eps/forward check, and the
// running-t prune with the TPU kernel's relative slack (_PRUNE_SLACK).
//
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

// The block tables of a large mesh (ops/tri_blocks.py::walk_tables), walked
// by the light pass's culled trace (warp_walk_closest): 4 float4 per row
// (v0.xyz e0.x | e0.yz e2.xy | e2.z n.xyz | index bits, pad), 2 per
// sub-block (lo.xyz row count | hi.xyz 0), 2 per tree node in depth-first
// order: a macro leaf (lo.xyz block count | hi.xyz first block) or an
// internal node (lo.xyz index of the node after its subtree | hi.xyz -1).
constexpr int kRowsPerBlock = 128;    // triangles per Morton block
constexpr int kSubRows = 32;          // rows per sub-block
constexpr int kSubs = kRowsPerBlock / kSubRows;

struct Mesh {
  const float4* rows;
  const float4* subs;
  const float4* nodes;
  int n_nodes;
};

// Warp-cooperative closest hit (the light pass, csrc/light_pass.cu): the 32
// lanes of a warp trace ONE ray, and every lane ends with the same result.
// Each lane tests its own rows (row_quads and the tests that do not read
// the running minimum); a ballot collects the candidates, and the warp
// applies the running-minimum update to them one at a time in row order,
// each candidate's (tn_s, dd) broadcast by a shuffle.  That is the
// sequential scan's update in the sequential scan's order, so its result
// and rounding are trace_open's scan bit for bit (a min-reduction would
// not be: the cross-multiplied compare is not transitive under rounding).
// Candidates are rare, so the ordered part is short.  `T` is a work tally
// with add(slot, n); the slots it counts:
constexpr int kTalRows = 1;    // triangle rows tested
constexpr int kTalNodes = 2;   // tree-node box tests (culled walk)
constexpr int kTalSubs = 3;    // sub-block box tests (culled walk)
constexpr int kTalCands = 4;   // candidates through the ordered update

// The full scan: row base + j of each 32-row chunk on lane j, in file
// order (strict <: an exact tie keeps the earlier row).  Updates the
// det-scaled minimum (bn, bd); returns the winning row, or -1.
template <class T>
__device__ __forceinline__ int warp_scan_closest(
    const Scene& S, float ox, float oy, float oz, float dx, float dy,
    float dz, bool neg_t, float& bn, float& bd, T& tally) {
  const int lane = threadIdx.x & 31;
  const float4* rows = reinterpret_cast<const float4*>(S.tri);
  int best = -1;
  for (int base = 0; base < S.ntp; base += 32) {
    const int i = base + lane;
    Quads q{0.0f, 0.0f, 0.0f, 0.0f};
    bool cand = false;
    if (i < S.ntp) {
      q = row_quads(rows[3 * i], rows[3 * i + 1], rows[3 * i + 2], ox, oy,
                    oz, dx, dy, dz);
      cand = quads_valid(q, neg_t);
    }
    unsigned m = __ballot_sync(kAll, cand);
    tally.add(kTalRows, min(32, S.ntp - base));
    while (m != 0u) {
      const int k = __ffs(m) - 1;
      m &= m - 1u;
      const float tn = __shfl_sync(kAll, q.tn_s, k);
      const float dd = __shfl_sync(kAll, q.dd, k);
      tally.add(kTalCands, 1);
      if (tn * bd < bn * dd) {
        bn = tn;
        bd = dd;
        best = base + k;
      }
    }
  }
  return best;
}

// The culled walk over a mesh's block tables, one ray a warp.  The node
// tree is walked without a stack: every lane tests the
// same node, and a node whose padded box fails box_closest is skipped
// with its subtree.  In a taken macro, lane j tests the box of the
// macro's sub-block j (<= 8 blocks x 4; a sub-block's box lies inside its
// block's, so the block level adds no cull), and the warp scans the
// sub-blocks that pass, in order, row j on lane j, with the ordered
// update; after an update the macro's later sub-blocks are tested again
// against the closer minimum.  Every test is conservative, so no row that
// could win is skipped.  Rows are in Morton order, so an exact
// cross-multiplied tie goes to the lowest original index, carried from -1
// so that a tie against a floor, square or sphere hit is never stolen.
// Updates (bn, bd); returns the winning row's position in
// M.rows, or -1.
template <class T>
__device__ __forceinline__ int warp_walk_closest(
    const Mesh& M, float ox, float oy, float oz, float dx, float dy,
    float dz, bool neg_t, float& bn, float& bd, T& tally) {
  const int lane = threadIdx.x & 31;
  const RayInv ri = ray_inv(ox, oy, oz, dx, dy, dz);
  int best = -1, bi = -1;
  int ni = 0;
  while (ni < M.n_nodes) {
    const float4 lo = __ldg(M.nodes + 2 * ni);
    const float4 hi = __ldg(M.nodes + 2 * ni + 1);
    const int first = __float_as_int(hi.w);   // -1: an internal node
    tally.add(kTalNodes, 1);
    if (!box_closest(lo, hi, ri, bn, bd, neg_t)) {
      ni = first < 0 ? __float_as_int(lo.w) : ni + 1;
      continue;
    }
    ++ni;
    if (first < 0) continue;                   // descend
    float4 slo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), shi = slo;
    if (lane < kSubs * __float_as_int(lo.w)) {
      slo = __ldg(M.subs + 2 * (kSubs * first + lane));
      shi = __ldg(M.subs + 2 * (kSubs * first + lane) + 1);
    }
    const bool live = __float_as_int(slo.w) != 0;   // rows in it
    tally.add(kTalSubs, __popc(__ballot_sync(kAll, live)));
    unsigned m = __ballot_sync(
        kAll, live && box_closest(slo, shi, ri, bn, bd, neg_t));
    while (m != 0u) {
      const int k = __ffs(m) - 1;
      m &= m - 1u;
      const int s = kSubs * first + k;
      const float4* row = M.rows + 4 * ((long long)kSubRows * s + lane);
      const int idx = __float_as_int(__ldg(row + 3).x);
      const Quads q = row_quads(__ldg(row), __ldg(row + 1), __ldg(row + 2),
                                ox, oy, oz, dx, dy, dz);
      unsigned cm = __ballot_sync(kAll, quads_valid(q, neg_t));
      tally.add(kTalRows, __float_as_int(__shfl_sync(kAll, slo.w, k)));
      bool moved = false;
      while (cm != 0u) {
        const int j = __ffs(cm) - 1;
        cm &= cm - 1u;
        const float tn = __shfl_sync(kAll, q.tn_s, j);
        const float dd = __shfl_sync(kAll, q.dd, j);
        const int id = __shfl_sync(kAll, idx, j);
        tally.add(kTalCands, 1);
        const float num = tn * bd;
        const float den = bn * dd;
        if (num < den || (num == den && id < bi)) {
          bn = tn;
          bd = dd;
          bi = id;
          best = kSubRows * s + j;
          moved = true;
        }
      }
      if (moved)
        m &= __ballot_sync(kAll,
                           live && box_closest(slo, shi, ri, bn, bd, neg_t));
    }
  }
  return best;
}

// The uniform triangle grid of the trianglegrid variant (ops/grid.py::
// triangle_grid) and its per-ray 3-D DDA walk (kernels B11 and B11w,
// csrc/mega_grid.cu), in ops/grid.py::grid_tables' form: the triangle
// rows of every cell's item list copied in cell order (the (N, 12) table's
// v0 e0 | e0 e2 | e2 n as three float4 a row), each cell's (first row,
// rows), its occupancy bit, and the frame: vmin, vmax = vmin +
// cell_size * res (computed as ops/grid.py::traverse_triangles does) and
// the cell size, 9 floats.
struct Grid {
  const float4* rows;
  const int2* span;
  const unsigned* occ;   // bit c set where cell c has a triangle
  const float* frame;
  int rx, ry, rz;
};

// min / max that propagate NaN, as torch.minimum / jnp.minimum do (and as
// ATen's CUDA kernels write them); fminf / fmaxf would drop it.
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// Moller-Trumbore in the division form (ops/intersect.py::_mt_test, the
// reference's own and the DDA's): the reciprocal of det, then u, v and the
// distance rd as products with it, in _mt_test's operation order.  Returns
// whether the pair hits (before the running-t compare); rd is set then.
__device__ __forceinline__ bool mt_div(float4 a, float4 b, float4 c,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       bool neg_t, float& rd) {
  const float e0x = a.w, e0y = b.x, e0z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e0x * pvx + e0y * pvy + e0z * pvz;
  if (!(fabsf(det) >= kEps)) return false;
  const float inv = 1.0f / det;
  const float tvx = ox - a.x, tvy = oy - a.y, tvz = oz - a.z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  const float qvx = tvy * e0z - tvz * e0y;
  const float qvy = tvz * e0x - tvx * e0z;
  const float qvz = tvx * e0y - tvy * e0x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  rd = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  return neg_t || rd > kEps;
}

// One axis's cell of a point: floor((p - vmin) / cell), cast, clamped to
// [0, r - 1] (traverse_triangles' cell_of).
__device__ __forceinline__ int grid_cell(float p, float v, float c, int r) {
  return min(max((int)floorf((p - v) / c), 0), r - 1);
}

// One ray's walk state in the 3-D DDA of TraceRay (trianglegrid/
// pathtracer.ocl:157-198): the cell, each axis's next crossing distance
// and crossing step, the direction's signs, and the steps left of the
// rx + ry + rz + 2 the walk may take.
struct Dda {
  int ix, iy, iz;
  float nxx, nxy, nxz;
  float dlx, dly, dlz;
  int left;
  bool posx, posy, posz;
};

// The walk's set-up in ops/grid.py::traverse_triangles' arithmetic: the
// slab entry t0 and exit t1 with NaN-propagating min / max (a ray parallel
// to an axis whose origin lies on a grid plane gets a NaN and never
// enters), the entry cell and the per-axis crossing distances.  Returns
// whether the ray enters the grid.
__device__ __forceinline__ bool dda_start(const Grid& G, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, Dda& W) {
  const float* vmin = G.frame;
  const float* vmax = G.frame + 3;
  const float* cs = G.frame + 6;
  const float invx = 1.0f / dx, invy = 1.0f / dy, invz = 1.0f / dz;
  const float ax = (vmin[0] - ox) * invx, bx = (vmax[0] - ox) * invx;
  const float ay = (vmin[1] - oy) * invy, by = (vmax[1] - oy) * invy;
  const float az = (vmin[2] - oz) * invz, bz = (vmax[2] - oz) * invz;
  const float ex0 = min_nan(ax, bx), ex1 = max_nan(ax, bx);
  const float ey0 = min_nan(ay, by), ey1 = max_nan(ay, by);
  const float ez0 = min_nan(az, bz), ez1 = max_nan(az, bz);
  const float t0 = max_nan(max_nan(ex0, ey0), ez0);
  const float t1 = min_nan(min_nan(ex1, ey1), ez1);
  if (!(t0 <= t1)) return false;
  const bool inside = ox >= vmin[0] && ox <= vmax[0] && oy >= vmin[1] &&
                      oy <= vmax[1] && oz >= vmin[2] && oz <= vmax[2];
  const float px = inside ? ox : ox + dx * t0;
  const float py = inside ? oy : oy + dy * t0;
  const float pz = inside ? oz : oz + dz * t0;
  const int rx = G.rx, ry = G.ry, rz = G.rz;
  W.ix = grid_cell(px, vmin[0], cs[0], rx);
  W.iy = grid_cell(py, vmin[1], cs[1], ry);
  W.iz = grid_cell(pz, vmin[2], cs[2], rz);
  W.dlx = (ex1 - ex0) / (float)rx;
  W.dly = (ey1 - ey0) / (float)ry;
  W.dlz = (ez1 - ez0) / (float)rz;
  W.posx = dx > 0.0f;
  W.posy = dy > 0.0f;
  W.posz = dz > 0.0f;
  W.nxx = W.posx ? ex0 + (float)(W.ix + 1) * W.dlx
                 : ex0 + (float)rx * W.dlx - (float)W.ix * W.dlx;
  W.nxy = W.posy ? ey0 + (float)(W.iy + 1) * W.dly
                 : ey0 + (float)ry * W.dly - (float)W.iy * W.dly;
  W.nxz = W.posz ? ez0 + (float)(W.iz + 1) * W.dlz
                 : ez0 + (float)rz * W.dlz - (float)W.iz * W.dlz;
  W.left = rx + ry + rz + 2;
  return true;
}

// The current cell's index, clamped into the grid.
__device__ __forceinline__ int dda_cell(const Grid& G, const Dda& W) {
  const int plane = G.rx * G.ry;
  return min(max(W.iz * plane + W.iy * G.rx + W.ix, 0), plane * G.rz - 1);
}

// One step after a visit: the axis of the smallest next crossing steps,
// and the walk ends when the running distance `t` (read after the visit)
// lies before that crossing - after the step, so one extra cell may be
// visited - when the index leaves the grid, or after rx + ry + rz + 2
// visits.  Returns whether the walk goes on.
__device__ __forceinline__ bool dda_advance(const Grid& G, Dda& W, float t) {
  const bool selx = W.nxx <= W.nxy && W.nxx <= W.nxz;
  const bool sely = !selx && W.nxy <= W.nxz;
  if (selx) {
    W.nxx = W.nxx + W.dlx;
    if (t < W.nxx) return false;
    W.ix += W.posx ? 1 : -1;
    if (W.ix == (W.posx ? G.rx : -1)) return false;
  } else if (sely) {
    W.nxy = W.nxy + W.dly;
    if (t < W.nxy) return false;
    W.iy += W.posy ? 1 : -1;
    if (W.iy == (W.posy ? G.ry : -1)) return false;
  } else {
    W.nxz = W.nxz + W.dlz;
    if (t < W.nxz) return false;
    W.iz += W.posz ? 1 : -1;
    if (W.iz == (W.posz ? G.rz : -1)) return false;
  }
  return --W.left > 0;
}

// Whether grid cell c holds a triangle: its bit in the occupancy bitmap
// (shared memory when the kernel staged it there, else device memory).
__device__ __forceinline__ bool cell_occupied(const Grid& G, int c) {
  return (G.occ[c >> 5] >> (c & 31)) & 1u;
}

__device__ __forceinline__ void take_hit(PreHit& h, float rd, float4 e) {
  if (rd < h.t) {
    h.t = rd;
    h.m = 4;
    h.nx = e.y;
    h.ny = e.z;
    h.nz = e.w;
    h.needs = false;
  }
}

// The 3-D DDA for one ray (kernel B11's walk, each lane at its own pace):
// set-up, then `visit(cell)` on each occupied cell (true ends the walk)
// and a step after every cell, until the walk ends; an empty cell costs
// its bit and its step.  With kNest an inner loop steps over each run of
// empty cells, so that a warp's lanes cross their runs each at its own
// pace and test their next occupied cells together (each lane's cells
// and steps are the same: an empty cell changes no running distance).
// The plain version's inactive lanes never update, so ending the loop
// there gives the same result.  `T` counts every visited cell (cell()).
// Returns whether the ray entered.
template <bool kNest, class T, class Visit>
__device__ __forceinline__ bool grid_dda(const Grid& G, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, const float& t, T& tally,
                                         Visit&& visit) {
  Dda W;
  if (!dda_start(G, ox, oy, oz, dx, dy, dz, W)) return false;
  if constexpr (kNest) {
    for (;;) {
      int c = dda_cell(G, W);
      tally.cell();
      while (!cell_occupied(G, c)) {
        if (!dda_advance(G, W, t)) return true;
        c = dda_cell(G, W);
        tally.cell();
      }
      if (visit(c) || !dda_advance(G, W, t)) return true;
    }
  } else {
    do {
      const int c = dda_cell(G, W);
      tally.cell();
      if (cell_occupied(G, c) && visit(c)) break;
    } while (dda_advance(G, W, t));
    return true;
  }
}

// The pairs of occupied grid cell c in slot order: each pair's
// division-form test on the cell's copy of the triangle's row, and
// `on_hit(rd, row's last float4: e2.z, normal)` for each pair that hits;
// true from on_hit ends the scan and is returned.  A pair's row depends
// only on (c, slot): no item id is read.
template <class T, class OnHit>
__device__ __forceinline__ bool grid_cell_scan(const Grid& G, int c, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz,
                                               bool neg_t, T& tally,
                                               OnHit&& on_hit) {
  const int2 sp = __ldg(G.span + c);
  const float4* r = G.rows + 3ll * sp.x;
  for (int k = 0; k < sp.y; ++k, r += 3) {
    tally.pair();
    const float4 e = __ldg(r + 2);
    float rd;
    if (mt_div(__ldg(r), __ldg(r + 1), e, ox, oy, oz, dx, dy, dz, neg_t,
               rd) &&
        on_hit(rd, e))
      return true;
  }
  return false;
}

// Closest hit over the grid's triangles (traverse_triangles for one ray):
// a pair replaces the running hit h when its distance is strictly below
// h.t (the first found wins a tie; a triangle spanning cells is tested
// again in each).  kNest as in grid_dda.
template <bool kNest, class T>
__device__ __forceinline__ void grid_closest(const Grid& G, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, bool neg_t,
                                             PreHit& h, T& tally) {
  if (grid_dda<kNest>(G, ox, oy, oz, dx, dy, dz, h.t, tally, [&](int c) {
        return grid_cell_scan(G, c, ox, oy, oz, dx, dy, dz, neg_t, tally,
                              [&](float rd, float4 e) {
                                take_hit(h, rd, e);
                                return false;
                              });
      }))
    tally.enter();
}

// Any hit below t_limit over the grid's triangles: the closest walk from a
// running distance of t_limit ends at its first pair below it, so the walk
// that stops at the first such pair visits the same cells in the same
// order and finds a hit exactly when the closest walk would.
template <class T>
__device__ __forceinline__ bool grid_occluded(const Grid& G, float ox,
                                              float oy, float oz, float dx,
                                              float dy, float dz,
                                              float t_limit, bool neg_t,
                                              T& tally) {
  bool occ = false;
  if (grid_dda<false>(G, ox, oy, oz, dx, dy, dz, t_limit, tally,
                     [&](int c) {
        return occ = grid_cell_scan(
                   G, c, ox, oy, oz, dx, dy, dz, neg_t, tally,
                   [&](float rd, float4) { return rd < t_limit; });
      }))
    tally.enter();
  return occ;
}

// The key of a closest-hit pair (rd below its ray's t, so not NaN) in slot
// k: the smaller key is the smaller distance, then the smaller slot, and
// -0 and +0 are one distance - the order in which the sequential scan's
// `rd < t` keeps the first of equal distances.
__device__ __forceinline__ unsigned long long hit_key(float rd, int k) {
  const unsigned b = __float_as_uint(rd == 0.0f ? 0.0f : rd);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)k;
}

// The stages of a warp's walk, for the counting tally's clock64 stamps.
enum WalkStage : int {
  kStageSetup,   // dda_start
  kStageEmpty,   // an iteration in which every walking lane's cell is empty
  kStageLoads,   // an occupied iteration's spans and rows
  kStagePairs,   // its pair arithmetic
  kStageStep     // its merge and step
};

// Waits for `v` (a loaded value) before a tally's next clock64 stamp: a warp-wide OR
// that reads it, which the compiler cannot drop.
__device__ __forceinline__ void wait_for(unsigned v) {
  unsigned r;
  asm volatile("redux.sync.or.b32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(kAll));
  (void)r;
}

// The DDA walk of the 32 rays of a warp in lockstep, every lane calling it
// (`live` lanes walk; kernel B11w's walk, and the counting instantiation
// of B11's): each iteration each walking lane reads its cell's bit; where
// any lane's cell is occupied the lanes on occupied cells test their
// pairs, then each walking lane steps (dda_advance); with kNest the lanes
// on empty cells first step on, together, until each is on an occupied
// cell or done (grid_dda's inner loop).  With kPool the warp
// pools the pairs of all its lanes' cells and deals them out 32 a round
// (pair p of the pool to lane p % 32, which tests it against its owner's
// ray, shuffled from the owner; the hits merged per owner in `keys`, the
// warp's 32 slots of shared memory - unused without kPool), so that it
// pays a round for each 32
// pairs of its lanes' cells; without, each lane tests its own cell's
// pairs slot by slot, and the warp pays its lanes' largest cell (as B11's
// per-lane walk does).  Closest hit (kAny false): a pair below the
// owner's h.t at the cell hits, the owner keeps the least key (hit_key:
// the smallest distance, then the first slot) and takes that pair - its
// rd recomputed, bit for bit - as the sequential slot-order scan of
// ops/grid.py::traverse_triangles would (its strict `rd < t` keeps the
// first of equal distances).  Any hit (kAny): a pair below h.t ends the
// owner's walk, which the sequential scan would have ended at its first
// such pair.  Each lane's cells and its break decisions are the
// sequential walk's.  `T` is the kernel's tally: walk(), step() (an
// iteration of the warp), cell() (a cell a lane moves onto),
// pairs_of_cell() (the sequential scan's pairs: the cell's, or for kAny
// up to the first hit), round() (a round of pair tests), loaded() and
// stamp() (the counting instantiation's clock split; no-ops elsewhere).
// Returns whether a pair hit (kAny).
template <bool kAny, bool kPool, bool kNest, class T>
__device__ __forceinline__ bool grid_walk(const Grid& G,
                                          unsigned long long* keys,
                                          bool live, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, bool neg_t, PreHit& h,
                                          T& tally) {
  const int lane = threadIdx.x & 31;
  Dda W;
  bool go = live && dda_start(G, ox, oy, oz, dx, dy, dz, W);
  tally.walk(live, go);
  tally.stamp(kStageSetup);
  int c = 0;
  bool full = false;
  auto visit = [&]() {   // the lane moves onto the cell of W
    c = dda_cell(G, W);
    full = cell_occupied(G, c);
    tally.cell(full);
  };
  if (go) visit();
  bool hit = false;
  while (__any_sync(kAll, go)) {
    if constexpr (kNest) {
      while (__any_sync(kAll, go && !full)) {
        tally.step();
        if (go && !full && (go = dda_advance(G, W, h.t))) visit();
        tally.stamp(kStageEmpty);
      }
      if (!__any_sync(kAll, go)) break;
    }
    tally.step();
    const bool mine = go && full;
    const bool any = __any_sync(kAll, mine);
    if (any) {
      int2 sp = make_int2(0, 0);
      if (mine) sp = __ldg(G.span + c);
      const float t = h.t;
      unsigned long long best = ~0ull;
      if constexpr (kPool) {
        // the pool: lane l's pairs are [excl_l, excl_l + n_l) of `total`
        int incl = sp.y;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int v = __shfl_up_sync(kAll, incl, s);
          if (lane >= s) incl += v;
        }
        const int total = __shfl_sync(kAll, incl, 31);
        const int excl = incl - sp.y;
        keys[lane] = ~0ull;
        __syncwarp();
        tally.stamp(kStageLoads);
        for (int base = 0; base < total; base += 32) {
          // pair p's owner: the last lane whose pairs start at or before p
          const int p = base + lane;
          int l = 0;
#pragma unroll
          for (int s = 16; s > 0; s >>= 1)
            if (__shfl_sync(kAll, excl, l + s) <= p) l += s;
          const int k = p - __shfl_sync(kAll, excl, l);
          const int row = __shfl_sync(kAll, sp.x, l) + k;
          const float rox = __shfl_sync(kAll, ox, l);
          const float roy = __shfl_sync(kAll, oy, l);
          const float roz = __shfl_sync(kAll, oz, l);
          const float rdx = __shfl_sync(kAll, dx, l);
          const float rdy = __shfl_sync(kAll, dy, l);
          const float rdz = __shfl_sync(kAll, dz, l);
          const float rt = __shfl_sync(kAll, t, l);
          float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a, e = a;
          if (p < total) {
            const float4* r = G.rows + 3ll * row;
            a = __ldg(r);
            b = __ldg(r + 1);
            e = __ldg(r + 2);
          }
          tally.loaded(__float_as_uint(a.x) ^ __float_as_uint(b.x) ^
                       __float_as_uint(e.x));
          float rd;
          if (p < total && mt_div(a, b, e, rox, roy, roz, rdx, rdy, rdz,
                                  neg_t, rd) &&
              rd < rt)
            atomicMin(keys + l,
                      kAny ? (unsigned long long)k : hit_key(rd, k));
          tally.round();
          tally.stamp(kStagePairs);
        }
        __syncwarp();
        best = keys[lane];
        __syncwarp();   // the slots are set anew at the next occupied cell
      } else {
        const int kmax = __reduce_max_sync(kAll, (unsigned)sp.y);
        tally.stamp(kStageLoads);
        const float4* r = G.rows + 3ll * sp.x;
        for (int k = 0; k < kmax; ++k, r += 3) {
          const bool test = k < sp.y && !(kAny && best != ~0ull);
          float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a, e = a;
          if (test) {
            a = __ldg(r);
            b = __ldg(r + 1);
            e = __ldg(r + 2);
          }
          tally.loaded(__float_as_uint(a.x) ^ __float_as_uint(b.x) ^
                       __float_as_uint(e.x));
          float rd;
          if (test && mt_div(a, b, e, ox, oy, oz, dx, dy, dz, neg_t, rd) &&
              rd < t) {
            const unsigned long long key =
                kAny ? (unsigned long long)k : hit_key(rd, k);
            best = key < best ? key : best;
          }
          tally.round();
          tally.stamp(kStagePairs);
        }
      }
      const int kb = (int)(unsigned)best;
      tally.pairs_of_cell(best == ~0ull || !kAny ? sp.y : kb + 1);
      if (best != ~0ull) {
        if (kAny) {
          hit = true;
          go = false;
        } else {
          const float4* r = G.rows + 3ll * (sp.x + kb);
          const float4 e = __ldg(r + 2);
          float rd;
          mt_div(__ldg(r), __ldg(r + 1), e, ox, oy, oz, dx, dy, dz, neg_t,
                 rd);
          take_hit(h, rd, e);
        }
      }
    }
    if (go && (go = dda_advance(G, W, h.t))) visit();
    tally.stamp(any ? kStageStep : kStageEmpty);
  }
  return hit;
}

// The exact grid of kernels B2/B3 and of B4's walk route (ops/
// exact_grid.py): a Grid's tables over every (cell, triangle) pair, no
// per-cell cap, and each cell-major row's original triangle index.  Its
// walk (exact_walk) is exact where grid_dda keeps the reference's quirks:
// the set-up starts at the line's entry under neg_t (hits behind the
// origin count there), an axis whose slab meets 0 * inf is unconstrained
// (slab_axis), and the walk ends when its running best distance lies
// before the current cell's exit, less a margin of kTermRel (|exit| + 1)
// that keeps rounding from ending it early - not after dda_advance's
// break rule.  A triangle is in every cell its box overlaps, and a hit's
// point lies in its box, so a hit that could still beat the best lies in
// a cell the walk has yet to visit.
struct XGrid {
  Grid g;
  const int* ids;
};

constexpr float kTermRel = 1e-4f;   // ops/exact_grid.py::TERM_REL

// The exact walk's set-up (ops/exact_grid.py::walk_start): the slab entry
// t0 and exit t1, the entry cell (at the origin when it lies in the box,
// except under neg_t; else at the line's entry) and the per-axis crossing
// distances, in dda_start's arithmetic.  An axis with no slab (a zero
// direction component: its entry is -inf) gets a crossing of +inf, not
// dda_start's NaN (-inf + inf), which would break the choice of the axis
// to step.  Returns whether the walk has cells to visit.
__device__ __forceinline__ bool exact_start(const Grid& G, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, bool neg_t, Dda& W) {
  const float* vmin = G.frame;
  const float* vmax = G.frame + 3;
  const float* cs = G.frame + 6;
  float ex0, ex1, ey0, ey1, ez0, ez1;
  slab_axis(vmin[0], vmax[0], ox, 1.0f / dx, ex0, ex1);
  slab_axis(vmin[1], vmax[1], oy, 1.0f / dy, ey0, ey1);
  slab_axis(vmin[2], vmax[2], oz, 1.0f / dz, ez0, ez1);
  const float t0 = fmaxf(fmaxf(ex0, ey0), ez0);
  const float t1 = fminf(fminf(ex1, ey1), ez1);
  if (!(t0 <= t1) || (!neg_t && t1 < 0.0f)) return false;
  const bool from_o = !neg_t && ox >= vmin[0] && ox <= vmax[0] &&
                      oy >= vmin[1] && oy <= vmax[1] && oz >= vmin[2] &&
                      oz <= vmax[2];
  const float px = from_o ? ox : ox + dx * t0;
  const float py = from_o ? oy : oy + dy * t0;
  const float pz = from_o ? oz : oz + dz * t0;
  const int rx = G.rx, ry = G.ry, rz = G.rz;
  W.ix = grid_cell(px, vmin[0], cs[0], rx);
  W.iy = grid_cell(py, vmin[1], cs[1], ry);
  W.iz = grid_cell(pz, vmin[2], cs[2], rz);
  W.dlx = (ex1 - ex0) / (float)rx;
  W.dly = (ey1 - ey0) / (float)ry;
  W.dlz = (ez1 - ez0) / (float)rz;
  W.posx = dx > 0.0f;
  W.posy = dy > 0.0f;
  W.posz = dz > 0.0f;
  W.nxx = W.posx ? ex0 + (float)(W.ix + 1) * W.dlx
                 : ex0 + (float)rx * W.dlx - (float)W.ix * W.dlx;
  W.nxy = W.posy ? ey0 + (float)(W.iy + 1) * W.dly
                 : ey0 + (float)ry * W.dly - (float)W.iy * W.dly;
  W.nxz = W.posz ? ez0 + (float)(W.iz + 1) * W.dlz
                 : ez0 + (float)rz * W.dlz - (float)W.iz * W.dlz;
  const float inf = __int_as_float(0x7f800000);
  if (W.nxx != W.nxx) W.nxx = inf;
  if (W.nxy != W.nxy) W.nxy = inf;
  if (W.nxz != W.nxz) W.nxz = inf;
  return true;
}

// The current cell's exit (the least next crossing) less the margin: a
// hit at or before it beats every cell the walk has not visited.
__device__ __forceinline__ float exact_exit(const Dda& W) {
  const float ex = fminf(fminf(W.nxx, W.nxy), W.nxz);
  return ex - kTermRel * (fabsf(ex) + 1.0f);
}

// One step onto the next cell, along the axis of the smallest next
// crossing (dda_advance's choice, without its break rule).  Returns
// whether the walk is still in the grid; each step moves one index one
// way, so a walk leaves it within rx + ry + rz steps (dda_advance's step
// count is not needed).
__device__ __forceinline__ bool exact_step(const Grid& G, Dda& W) {
  const bool selx = W.nxx <= W.nxy && W.nxx <= W.nxz;
  const bool sely = !selx && W.nxy <= W.nxz;
  if (selx) {
    W.ix += W.posx ? 1 : -1;
    if (W.ix == (W.posx ? G.rx : -1)) return false;
    W.nxx = W.nxx + W.dlx;
  } else if (sely) {
    W.iy += W.posy ? 1 : -1;
    if (W.iy == (W.posy ? G.ry : -1)) return false;
    W.nxy = W.nxy + W.dly;
  } else {
    W.iz += W.posz ? 1 : -1;
    if (W.iz == (W.posz ? G.rz : -1)) return false;
    W.nxz = W.nxz + W.dlz;
  }
  return true;
}

// The exact walk of a warp's rays, one a lane, every lane calling it
// (`active` lanes walk): each lane moves onto its cell, tests the cell's
// pairs in slot order when its bit is set, then ends or steps; with kNest
// the lanes on empty cells first step on, each at its own pace, until
// each is on an occupied cell or done, so that the warp's lanes test their
// occupied cells together.  Closest hit (kAny false): a pair replaces the
// det-scaled running best (bn, bd) when tn_s * bd < bn * dd, or on an
// exact tie when its original index is below bi (carried from -1, so a
// tie with a floor or sphere hit is never stolen); the index is loaded
// only on a tie.  The walk ends once bn <= exact_exit * bd.  Any hit
// (kAny): a pair below t_limit ends the walk; so does a cell whose exit,
// less the margin, is at or past t_limit.  `T` is the kernel's tally:
// kLockstep (the counting instantiation: each occupied step runs its
// lanes' largest pair count, so that the clock64 stamps fall at
// warp-uniform points), begin() (the walk's first stamp), walk(live,
// entered), cell(occupied), pairs(n) (the lane's pairs tested), round()
// (a pair iteration of the warp), loaded(v) and stamp(stage).  Returns
// the any-hit flag (kAny).
template <bool kAny, bool kNest, class T>
__device__ __forceinline__ bool exact_walk(const XGrid& X, bool active,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           bool neg_t, float t_limit,
                                           float& bn, float& bd, int& bi,
                                           PreHit& h, T& tally) {
  const Grid& G = X.g;
  tally.begin();
  Dda W;
  bool go = active && exact_start(G, ox, oy, oz, dx, dy, dz, neg_t, W);
  tally.walk(active, go);
  tally.stamp(kStageSetup);
  int c = 0;
  bool full = false;
  auto visit = [&]() {   // the lane moves onto the cell of W
    c = dda_cell(G, W);
    full = cell_occupied(G, c);
    tally.cell(full);
  };
  // whether the walk goes on past the current cell
  auto onward = [&]() {
    const float thr = exact_exit(W);
    if (kAny ? thr >= t_limit : bn <= thr * bd) return false;
    return exact_step(G, W);
  };
  if (go) visit();
  bool hit = false;
  while (__any_sync(kAll, go)) {
    if constexpr (kNest) {
      while (__any_sync(kAll, go && !full)) {
        if (go && !full && (go = onward())) visit();
        tally.stamp(kStageEmpty);
      }
      if (!__any_sync(kAll, go)) break;
    }
    const bool mine = go && full;
    int2 sp = make_int2(0, 0);
    if (mine) sp = __ldg(G.span + c);
    const int kn = T::kLockstep ? (int)__reduce_max_sync(kAll, (unsigned)sp.y)
                                : sp.y;
    const float4* r = G.rows + 3ll * sp.x;
    for (int k = 0; k < kn; ++k, r += 3) {
      const bool test = k < sp.y && !hit;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a, e = a;
      if (test) {
        a = __ldg(r);
        b = __ldg(r + 1);
        e = __ldg(r + 2);
      }
      tally.loaded(__float_as_uint(a.x) ^ __float_as_uint(b.x) ^
                   __float_as_uint(e.x));
      if (test) {
        tally.pairs(1);
        const Quads q = row_quads(a, b, e, ox, oy, oz, dx, dy, dz);
        if constexpr (kAny) {
          hit = quads_valid(q, neg_t) && q.tn_s < t_limit * q.dd;
        } else {
          const float num = q.tn_s * bd;
          const float den = bn * q.dd;
          if (quads_valid(q, neg_t) &&
              (num < den || (num == den && __ldg(X.ids + sp.x + k) < bi))) {
            bn = q.tn_s;
            bd = q.dd;
            bi = __ldg(X.ids + sp.x + k);
            h.m = 4;
            h.nx = e.y;
            h.ny = e.z;
            h.nz = e.w;
            h.needs = false;
          }
        }
      }
      tally.round();
      tally.stamp(kStagePairs);
      if (!T::kLockstep && hit) break;
    }
    if (go && (go = !hit && onward())) visit();
    tally.stamp(mine ? kStageStep : kStageEmpty);
  }
  return hit;
}

// Sky colour (1 - dz)^4 * (0.7, 0.6, 1) (pathtracer.ocl:160).
__device__ __forceinline__ void shade_sky(float dz, float& r, float& g,
                                          float& b) {
  const float skyf = 1.0f - dz;
  const float sky2 = skyf * skyf;
  const float sky4 = sky2 * sky2;
  r = 0.7f * sky4;
  g = 0.6f * sky4;
  b = 1.0f * sky4;
}

// Floor checker (1) or diffuse (3) shading of the illumination ti
// (pathtracer.ocl:196-200).
__device__ __forceinline__ void shade_lit(int m, float x, float y, float ti,
                                          float& r, float& g, float& b) {
  if (m == 1) {
    const int sel = (int)(ceilf(x * 0.2f) + ceilf(y * 0.2f)) & 1;
    r = 3.0f * ti;
    g = (sel == 1 ? 1.0f : 3.0f) * ti;
    b = g;
  } else {
    r = 2.0f * ti;
    g = 3.0f * ti;
    b = 2.0f * ti;
  }
}

}  // namespace
