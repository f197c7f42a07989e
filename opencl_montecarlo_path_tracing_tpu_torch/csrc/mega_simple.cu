// Simple-tracer megakernel: the whole CLSimplePathTracer sample - up to
// max_bounces chained mirror bounces - all spp, in one kernel (kernel B5 of
// the port).
//
// Replaces the TPU kernel opencl_montecarlo_path_tracing_tpu/ops/
// pallas_simple.py::film_simple_mega -> _simple_mega_kernel.  For every
// pixel of the band [row_offset, row_offset+rows) x [0, W) it sums `spp`
// samples with global sample index s + spp_offset of spp_total and writes
// the pre-ambient film * EXPOSURE once.  Per sample: threefry camera draws
// and the thin-lens primary ray, then up to max_bounces rounds of the
// closest hit over the floor (m = 1) and the mirror spheres (m = 2, normal
// renormalised), the jittered implicit light (9 + u1, 9 + u2, 16) drawn at
// site SITE_LIGHT0 + b * SITE_STRIDE_BOUNCE, the uncapped shadow any-hit,
// and the shading: sky ends the path, the floor checker ends it, a mirror
// adds the signed pow99 highlight to colorFact (times divFact under the
// reference quirk, over it otherwise) and reflects with divFact doubled.
// A path still alive after the last round gives colorFact.
//
// What bounds it on an H100: FP32 instruction issue.  A live ray costs ~19
// operations per sphere test on its trace and on its shadow ray; the only
// memory traffic is the 12-byte film write.  Most rays pass nowhere near
// the spheres, which all lie in one slab (the business card), and a warp
// runs a bounce while any of its lanes is live.  Design: one thread per
// pixel, a warp on a compact 8x4 pixel patch (a block of 4 warps on 16x8)
// so that its rays are coherent; the film sum kept in registers across the
// spp loop and written once; the camera, the sphere centres and the sphere
// groups staged once per block into shared memory (broadcast reads).  The
// spheres are tested behind a two-level per-warp cull: the card's box, then
// each group's (a run of consecutive spheres with one centre x, a column of
// the card; ops/mega_simple.py::sphere_groups), each voted with
// __any_sync, so a warp tests a group's spheres only when some lane's ray
// may hit one.  A sphere's square root and hit arithmetic run only where
// its discriminant is positive.  The shadow ray is cast only where the
// shading reads it (lamb >= 0) and keeps its any-hit early exit.  Not
// carried over from the TPU kernel: the lock-step spp groups (_SPP_GROUP),
// the sphere-row unroll, the stacked ray bundles and the (3*_SUB, 128)
// output tile - mechanisms of the TPU's vreg layout and SMEM scalar reads.
//
// Exactness: bit-equal to the plain version.  The tested spheres keep
// their index order, so an exact tie still goes to the earlier sphere, and
// a group is skipped for a lane only when its ray provably cannot reach a
// hit the plain test would take: the slab test against the group's box of
// unit spheres grown by a per-ray pad.  The pad bounds the float error of
// the discriminant q = b*b - (p.p - 1): with p = o - c and u = 2^-24,
// |q - q_exact| <= 18 u (|p|^2 + 1), so a computed q > 0 puts the centre
// within sqrt(1 + 32 u (P^2 + 1)) of the ray line, and the computed hit
// point within that distance of the centre, where P bounds |o - c| over
// the card; the pad is that radius less 1 plus 0.01 + 1e-5 P of margin
// for the rounding of s and of the slab itself.  The running-t prune keeps
// the super kernels' relative slack (kSlack).
//
// The arithmetic follows the plain version (models/simple.py) line by
// line, since a one-ulp difference at one bounce can flip a later sphere
// hit: reflect is d + n * (dot(n, d) * -2), pow99 is x64*x32*x2*x, sums run
// x + y + z, the light direction divides by its length, and the sphere
// normal is renormalised with rsqrtf, the function torch.rsqrt runs on a
// CUDA tensor.  The highlight divides as spec * (1 / divFact), exact since
// divFact is a power of two.  Built with --fmad=false and no fast math.

#include "pt_device.cuh"

namespace {

constexpr int kTileW = 16;            // block tile: 16 x 8 pixels,
constexpr int kTileH = 8;             // warp w on the 8 x 4 patch (w&1, w>>1)
constexpr int kBlock = kTileW * kTileH;
constexpr uint32_t kSiteStrideBounce = 8;  // models/common.py

// x**99 by binary exponentiation (99 = 64+32+2+1), sign kept
// (models/common.py::pow99).
__device__ __forceinline__ float pow99(float x) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  const float x8 = x4 * x4;
  const float x16 = x8 * x8;
  const float x32 = x16 * x16;
  const float x64 = x32 * x32;
  return x64 * x32 * x2 * x;
}

// The sphere groups (ops/mega_simple.py::sphere_groups), 2 float4 each
// (lo.xyz first sphere | hi.xyz sphere count): the boxes of their unit
// spheres; record 0 is the whole card.
struct Groups {
  const float4* g;
  int n;                 // groups after the card record
  float cx, cy, cz;      // the card's centre
  float half;            // and half its diagonal
};

// The cull of one ray: its reciprocal direction and its pad, the
// discriminant's error bound as a distance (kernel comment).
struct Cull {
  RayInv ri;
  float pad;
};

__device__ __forceinline__ Cull make_cull(const Groups& G, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz) {
  const float qx = ox - G.cx, qy = oy - G.cy, qz = oz - G.cz;
  const float P = sqrtf(qx * qx + qy * qy + qz * qz) + G.half;
  const float E = 2e-6f * (P * P + 1.0f);   // >= 32 u (P^2 + 1)
  const float pad = (sqrtf(1.0f + E) - 1.0f) + 0.01f + 1e-5f * P;
  return Cull{ray_inv(ox, oy, oz, dx, dy, dz), pad};
}

// May a sphere of the group (lo, hi) give this ray a hit below t?
__device__ __forceinline__ bool group_need(float4 lo, float4 hi,
                                           const Cull& c, float t) {
  const float4 l = make_float4(lo.x - c.pad, lo.y - c.pad, lo.z - c.pad, 0.f);
  const float4 h = make_float4(hi.x + c.pad, hi.y + c.pad, hi.z + c.pad, 0.f);
  float tmin, tmax;
  slab(l, h, c.ri, tmin, tmax);
  return tmax >= tmin && tmax >= 0.0f && fmaxf(tmin, 0.0f) <= t * kSlack;
}

// Closest hit over the floor and the mirror spheres (the floor and
// sphere stages of pt_device.cuh::pre_tri, sphere material 2, no squares),
// for `active` lanes; the others run the votes and return garbage.
__device__ PreHit trace_simple(const Scene& S, const Groups& G, float ox,
                               float oy, float oz, float dx, float dy,
                               float dz, bool active) {
  PreHit h{kBig, 0, 0.0f, 0.0f, 0.0f, false};
  const float inv_dz = 1.0f / dz;
  const float p = -oz * inv_dz;
  if (p > kEps && p < h.t) {
    h.t = p;
    h.m = 1;
    h.nz = 1.0f;
  }
  const Cull c = make_cull(G, ox, oy, oz, dx, dy, dz);
  if (!__any_sync(kAll, active && group_need(G.g[0], G.g[1], c, h.t)))
    return h;
  for (int g = 1; g <= G.n; ++g) {
    const float4 lo = G.g[2 * g], hi = G.g[2 * g + 1];
    if (!__any_sync(kAll, active && group_need(lo, hi, c, h.t))) continue;
    const int k0 = __float_as_int(lo.w);
    spheres_closest(S, k0, k0 + __float_as_int(hi.w), ox, oy, oz, dx, dy, dz,
                    2, h);
  }
  return h;
}

// The uncapped shadow any-hit over the floor and the spheres
// (pt_device.cuh::occluded_pre with t_limit = kBig, no squares), for
// `active` lanes (the others return false).  A lane stops at its first
// hit, the warp when every active lane is occluded.
__device__ bool occluded_simple(const Scene& S, const Groups& G, float ox,
                                float oy, float oz, float dx, float dy,
                                float dz, bool active) {
  const float inv_dz = 1.0f / dz;
  const float p = -oz * inv_dz;
  bool occ = active && p > kEps && p < kBig;
  const Cull c = make_cull(G, ox, oy, oz, dx, dy, dz);
  if (!__any_sync(kAll, active && !occ &&
                            group_need(G.g[0], G.g[1], c, kBig)))
    return occ;
  for (int g = 1; g <= G.n; ++g) {
    if (!__any_sync(kAll, active && !occ)) break;
    const float4 lo = G.g[2 * g], hi = G.g[2 * g + 1];
    if (!__any_sync(kAll, active && !occ && group_need(lo, hi, c, kBig)))
      continue;
    const int k0 = __float_as_int(lo.w);
    if (active && !occ)
      occ = spheres_any(S, k0, k0 + __float_as_int(hi.w), ox, oy, oz, dx, dy,
                        dz, kBig);
  }
  return occ;
}

__global__ void __launch_bounds__(kBlock)
mega_simple_kernel(const float* __restrict__ scene, int ns,
                   const float4* __restrict__ groups, int ng, uint32_t k0,
                   uint32_t k1, uint32_t spp_offset, uint32_t spp_total,
                   uint32_t row_offset, int rows, int width, int spp,
                   int max_bounces, int spec_mul_flag,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  // the groups first (float4-aligned), then the camera and the centres
  const int n_g4 = 2 * (ng + 1);
  for (int i = threadIdx.x; i < n_g4; i += blockDim.x) smem4[i] = groups[i];
  const Scene S = stage_scene(scene, reinterpret_cast<float*>(smem4 + n_g4),
                              0, 0, ns, 0);
  __syncthreads();
  Groups G;
  G.g = smem4;
  G.n = ng;
  {
    const float4 lo = smem4[0], hi = smem4[1];
    G.cx = 0.5f * (lo.x + hi.x);
    G.cy = 0.5f * (lo.y + hi.y);
    G.cz = 0.5f * (lo.z + hi.z);
    const float ex = hi.x - lo.x, ey = hi.y - lo.y, ez = hi.z - lo.z;
    G.half = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez) * 1.001f;
  }
  const bool spec_mul = spec_mul_flag != 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ii_i = blockIdx.x * kTileW + (warp & 1) * 8 + (lane & 7);
  const int jj_row = blockIdx.y * kTileH + (warp >> 1) * 4 + (lane >> 3);
  // ghost pixels past the film edge trace nothing (their lanes vote no)
  // and are not written
  const bool inside = ii_i < width && jj_row < rows;
  const uint32_t row_u = (uint32_t)jj_row + row_offset;
  const uint32_t pixel_index = row_u * (uint32_t)width + (uint32_t)ii_i;
  const float ii = (float)ii_i;
  const float jj = (float)(int)row_u;

  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t ray_id = pixel_index * spp_total + ((uint32_t)s + spp_offset);
    const Ray ry = primary_ray(S, k0, k1, ray_id, ii, jj);
    float ox = ry.ox, oy = ry.oy, oz = ry.oz;
    float dx = ry.dx, dy = ry.dy, dz = ry.dz;
    // colorFact only ever gains the grey highlight: one scalar for r, g, b
    float cf = 0.0f, div = 1.0f;
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;  // result
    bool alive = inside;
    for (int b = 0; b < max_bounces; ++b) {
      // every lane runs the bounce's votes while any lane is live
      if (!__any_sync(kAll, alive)) break;
      const PreHit h = trace_simple(S, G, ox, oy, oz, dx, dy, dz, alive);
      float nx = h.nx, ny = h.ny, nz = h.nz;
      float x = 0.0f, y = 0.0f, z = 0.0f;
      float ldx = 0.0f, ldy = 0.0f, ldz = 1.0f, lamb = 0.0f;
      bool cast = false;
      if (alive) {
        if (h.m == 0) {  // miss -> sky (spt.ocl:92-95)
          float sr, sgc, sb;
          shade_sky(dz, sr, sgc, sb);
          rr = cf + sr / div;
          rg = cf + sgc / div;
          rb = cf + sb / div;
          alive = false;
        } else {
          if (h.needs) {
            const float inv_len =
                rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
            nx = nx * inv_len;
            ny = ny * inv_len;
            nz = nz * inv_len;
          }
          x = ox + dx * h.t;
          y = oy + dy * h.t;
          z = oz + dz * h.t;
          uint32_t u0, u1;
          threefry(k0, k1, ray_id,
                   ((uint32_t)kSiteLight0 + (uint32_t)b * kSiteStrideBounce) *
                       kSiteStride,
                   u0, u1);
          const float lx = 9.0f + unit(u0) - x;
          const float ly = 9.0f + unit(u1) - y;
          const float lz = 16.0f - z;
          const float len = sqrtf(lx * lx + ly * ly + lz * lz);
          ldx = lx / len;
          ldy = ly / len;
          ldz = lz / len;
          lamb = ldx * nx + ldy * ny + ldz * nz;
          // lamb < 0 zeroes lamb whatever the shadow ray finds: cast it
          // only where the shading reads it
          cast = !(lamb < 0.0f);
        }
      }
      const bool occ = occluded_simple(S, G, x, y, z, ldx, ldy, ldz, cast);
      if (!alive) continue;
      if (lamb < 0.0f || occ) lamb = 0.0f;
      if (h.m == 1) {  // floor -> checker * (lamb*0.2 + 0.1) (spt.ocl:112-115)
        const int sel = (int)(ceilf(x * 0.2f) + ceilf(y * 0.2f)) & 1;
        const float a = lamb * 0.2f + 0.1f;
        rr = cf + (3.0f * a) / div;
        rg = cf + ((sel == 1 ? 1.0f : 3.0f) * a) / div;
        rb = rg;
        alive = false;
        continue;
      }
      // mirror sphere -> highlight, reflect (spt.ocl:100, 120-125)
      const float k = (nx * dx + ny * dy + nz * dz) * -2.0f;
      const float hx = dx + nx * k;
      const float hy = dy + ny * k;
      const float hz = dz + nz * k;
      const float spec = pow99((ldx * hx + ldy * hy + ldz * hz) *
                               (lamb > 0.0f ? 1.0f : 0.0f));
      cf = cf + spec * (spec_mul ? div : 1.0f / div);
      ox = x;
      oy = y;
      oz = z;
      dx = hx;
      dy = hy;
      dz = hz;
      div = div * 2.0f;
    }
    // recursion-cap exhaustion -> the accumulated highlights
    // (models/simple.py)
    if (alive) rr = rg = rb = cf;
    fr = fr + rr;
    fg = fg + rg;
    fb = fb + rb;
  }
  if (inside) {
    float* o = out + 3 * ((long long)jj_row * width + ii_i);
    o[0] = fr * kExposure;
    o[1] = fg * kExposure;
    o[2] = fb * kExposure;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `groups`
// holds ng + 1 records of 8 floats (ops/mega_simple.py::sphere_groups).
extern "C" int mega_simple_launch(const float* scene, int ns,
                                  const float* groups, int ng, unsigned k0,
                                  unsigned k1, unsigned spp_offset,
                                  unsigned spp_total, unsigned row_offset,
                                  int rows, int width, int spp,
                                  int max_bounces, int spec_mul, float* out,
                                  void* stream) {
  if ((long long)rows * width <= 0) return 0;
  // sphere groups, camera and centres: 49 spheres are < 2 KB, far below
  // 48 KB
  const size_t smem = sizeof(float4) * 2 * (size_t)(ng + 1) +
                      sizeof(float) * (size_t)(12 + 3 * ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_simple_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((width + kTileW - 1) / kTileW),
                  (unsigned)((rows + kTileH - 1) / kTileH));
  mega_simple_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, ns, reinterpret_cast<const float4*>(groups), ng, k0, k1,
      spp_offset, spp_total, row_offset, rows, width, spp, max_bounces,
      spec_mul, out);
  return (int)cudaGetLastError();
}

extern "C" const char* mega_simple_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
