// Device code shared by the megakernels (csrc/mega_super.cu, kernel B1;
// csrc/mega_vlp.cu, kernel B4; csrc/mega_blocked.cu, kernels B2/B3;
// csrc/mega_simple.cu, kernel B5) and the cell-walk diagnostic
// (csrc/diag_dda.cu): the threefry stream, the packed scene in shared
// memory, the thin-lens primary ray, the det-scaled triangle row test, the
// closest-hit trace and its non-triangle stage, the capped any-hit
// occlusion test and its non-triangle stage, the NaN-safe slab test of the
// per-warp culls, and the 4-material shading.
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

// Copy the packed scene into shared memory `smem` (all threads of the
// block take part; the caller synchronises before reading it).
__device__ __forceinline__ Scene stage_scene(const float* __restrict__ scene,
                                             float* smem, int ntp, int nl,
                                             int ns, int nq) {
  const int n_floats = scene_floats(ntp, nl, ns, nq);
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) smem[i] = scene[i];
  Scene S;
  S.tri = smem;
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

// Closest hit (ops/intersect.py::trace_ray, sphere material 3), seeded
// with the running distance t0, over the shared-memory triangle table.
__device__ Hit trace(const Scene& S, float ox, float oy, float oz,
                     float dx, float dy, float dz, float t0, bool neg_t) {
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
  return finish(h);
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
// (the per-warp culls of B2/B3 and B5).
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
