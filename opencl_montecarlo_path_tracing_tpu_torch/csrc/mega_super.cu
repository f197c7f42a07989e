// Super megakernel: the whole mirror-free `super` sample step, all spp, in
// one kernel (kernel B1 of the port).
//
// Replaces the TPU kernel opencl_montecarlo_path_tracing_tpu/ops/
// pallas_super.py::film_super_mega -> _mega_kernel, SMEM tier (<= 512
// triangles).  For every pixel of the band [row_offset, row_offset+rows) x
// [0, W) it sums `spp` samples with global sample index s + spp_offset of
// spp_total and writes the pre-ambient film * EXPOSURE once.  Per sample:
// threefry camera draws, the thin-lens primary ray, the closest hit over
// floor -> squares -> spheres -> triangles (division-free Moller-Trumbore
// with a det-scaled running minimum), one jittered shadow ray per light
// (uncapped any-hit, or under shadow_carry_t sequential closest-hit traces
// seeded with the carried distance), and the 4-material shading.
//
// What bounds it on an H100: FP32 ALU issue.  At the reference scene size
// (~100 triangles) a sample costs ~48 FLOP per (ray, triangle) pair for the
// primary trace plus one occlusion scan per front-facing light, and the
// only memory traffic is the 12-byte film write per pixel at the end.
// Design: one thread per pixel, the film sum kept in registers across the
// spp loop; the scene (triangle table <= 24 KB, camera, lights, spheres,
// squares) staged once per block into shared memory, where every thread of
// a warp reads the same row (a broadcast, no bank conflicts) and triangle
// rows load as three float4s; shadow work is skipped for rays whose shading
// ignores it (sky, facing-ratio, back-facing lights), and an occlusion scan
// stops at its first hit - neither changes the film.  The arithmetic keeps
// the reference's operation order; build with --fmad=false (no FMA
// contraction) and without fast math, so that only the documented
// razor-edge ties differ from other float implementations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 0.01f;
constexpr float kBig = 1e9f;
constexpr float kExposure = 3.5f;
constexpr int kBlock = 128;
constexpr int kSiteLight0 = 2;     // models/common.py SITE_LIGHT0
constexpr uint32_t kSiteStride = 8;  // core/rng.py _SITE_STRIDE

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

struct Hit {
  float t;
  int m;
  float nx, ny, nz;
};

// Closest hit (ops/intersect.py::trace_ray, sphere material 3), seeded
// with the running distance t0; sphere normals are renormalised.
__device__ Hit trace(const Scene& S, float ox, float oy, float oz,
                     float dx, float dy, float dz, float t0, bool neg_t) {
  float t = t0;
  int m = 0;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  bool needs = false;
  const float inv_dz = 1.0f / dz;

  const float p = -oz * inv_dz;
  if (p > kEps && p < t) {
    t = p;
    m = 1;
    nz = 1.0f;
  }
  for (int q = 0; q < S.nq; ++q) {
    const float rd = (S.sq_z[q] - oz) * inv_dz;
    const float ix = ox + dx * rd;
    const float iy = oy + dy * rd;
    if (rd < t && fabsf(S.sq_k[q] - ix) < 1.0f && fabsf(iy) < 1.0f &&
        (neg_t || rd > kEps)) {
      t = rd;
      m = 3;
      nx = 0.0f;
      ny = 0.0f;
      nz = 1.0f;
      needs = false;
    }
  }
  for (int k = 0; k < S.ns; ++k) {
    const float px = ox - S.spheres[3 * k];
    const float py = oy - S.spheres[3 * k + 1];
    const float pz = oz - S.spheres[3 * k + 2];
    const float b = px * dx + py * dy + pz * dz;
    const float cc = px * px + py * py + pz * pz - 1.0f;
    const float q = b * b - cc;
    const float s = -b - sqrtf(fmaxf(q, 0.0f));
    if (q > 0.0f && s < t && s > kEps) {
      t = s;
      m = 3;
      nx = px + dx * s;
      ny = py + dy * s;
      nz = pz + dz * s;
      needs = true;
    }
  }
  if (S.ntp) {
    // division-free scan: the running minimum is carried det-scaled as
    // (bn, bd); file order decides exact ties (strict <)
    float bn = t, bd = 1.0f;
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
        m = 4;
        nx = e.y;
        ny = e.z;
        nz = e.w;
        needs = false;
      }
    }
    t = bn / bd;
  }
  if (needs) {
    const float inv_len =
        1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
    nx *= inv_len;
    ny *= inv_len;
    nz *= inv_len;
  }
  return Hit{t, m, nx, ny, nz};
}

// Uncapped any-hit (ops/intersect.py::any_hit with t_limit 1e9).
__device__ bool occluded(const Scene& S, float ox, float oy, float oz,
                         float dx, float dy, float dz, bool neg_t) {
  const float inv_dz = 1.0f / dz;
  const float p = -oz * inv_dz;
  if (p > kEps && p < kBig) return true;
  for (int q = 0; q < S.nq; ++q) {
    const float rd = (S.sq_z[q] - oz) * inv_dz;
    const float ix = ox + dx * rd;
    const float iy = oy + dy * rd;
    if (rd < kBig && fabsf(S.sq_k[q] - ix) < 1.0f && fabsf(iy) < 1.0f &&
        (neg_t || rd > kEps))
      return true;
  }
  for (int k = 0; k < S.ns; ++k) {
    const float px = ox - S.spheres[3 * k];
    const float py = oy - S.spheres[3 * k + 1];
    const float pz = oz - S.spheres[3 * k + 2];
    const float b = px * dx + py * dy + pz * dz;
    const float cc = px * px + py * py + pz * pz - 1.0f;
    const float q = b * b - cc;
    const float s = -b - sqrtf(fmaxf(q, 0.0f));
    if (q > 0.0f && s < kBig && s > kEps) return true;
  }
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
        un_s + vn_s <= dd && tn_s < kBig * dd && (neg_t || tn_s > kEps * dd))
      return true;
  }
  return false;
}

__global__ void __launch_bounds__(kBlock)
mega_super_kernel(const float* __restrict__ scene, int ntp, int nl, int ns,
                  int nq, uint32_t k0, uint32_t k1, uint32_t spp_offset,
                  uint32_t spp_total, uint32_t row_offset, int rows,
                  int width, int spp, int neg_t_flag, int carry_t_flag,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_floats = ntp * 12 + 12 + nl * 4 + ns * 3 + 2 * nq;
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) smem[i] = scene[i];
  __syncthreads();

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
  const bool neg_t = neg_t_flag != 0;
  const bool carry_t = carry_t_flag != 0;

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)rows * width) return;
  const int ii_i = (int)(p % width);
  const int jj_row = (int)(p / width);
  const uint32_t row_u = (uint32_t)jj_row + row_offset;
  // the pixel index wraps like the JAX kernel's int32 arithmetic
  const uint32_t pixel_index = row_u * (uint32_t)width + (uint32_t)ii_i;
  const float ii = (float)ii_i;
  const float jj = (float)(int)row_u;

  const float upx = S.cam[0], upy = S.cam[1], upz = S.cam[2];
  const float rix = S.cam[3], riy = S.cam[4], riz = S.cam[5];
  const float eyx = S.cam[6], eyy = S.cam[7], eyz = S.cam[8];
  const float psx = S.cam[9], psy = S.cam[10], psz = S.cam[11];

  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t s32 = (uint32_t)s + spp_offset;
    const uint32_t ray_id = pixel_index * spp_total + s32;

    // camera draws: site 0, counters 0 and 1 (core/rng.py randn_draws)
    uint32_t b0, b1, b2, b3;
    threefry(k0, k1, ray_id, 0u, b0, b1);
    threefry(k0, k1, ray_id, 1u, b2, b3);
    const float r1 = unit(b0), r2 = unit(b1), r3 = unit(b2), r4 = unit(b3);

    // thin-lens primary ray (core/camera.py::primary_rays)
    const float e1 = (r1 - 0.5f) * 99.0f;
    const float e2 = (r2 - 0.5f) * 99.0f;
    const float dlx = upx * e1 + rix * e2;
    const float dly = upy * e1 + riy * e2;
    const float dlz = upz * e1 + riz * e2;
    const float ox = psx + dlx, oy = psy + dly, oz = psz + dlz;
    const float ax = r3 + ii;
    const float ay = jj + r4;
    float dx = -dlx + (upx * ax + rix * ay + eyx) * 16.0f;
    float dy = -dly + (upy * ax + riy * ay + eyy) * 16.0f;
    float dz = -dlz + (upz * ax + riz * ay + eyz) * 16.0f;
    const float inv_n = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    dx *= inv_n;
    dy *= inv_n;
    dz *= inv_n;

    const Hit h = trace(S, ox, oy, oz, dx, dy, dz, kBig, neg_t);

    float sr, sgc, sb;
    if (h.m == 0) {
      const float skyf = 1.0f - dz;
      const float sky2 = skyf * skyf;
      const float sky4 = sky2 * sky2;
      sr = 0.7f * sky4;
      sgc = 0.6f * sky4;
      sb = 1.0f * sky4;
    } else if (h.m == 4) {
      const float facing =
          fmaxf(0.0f, -(h.nx * dx + h.ny * dy + h.nz * dz));
      sr = sgc = sb = facing;
    } else {
      // floor (1) or diffuse (3): direct light, one shadow ray per light
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
        if (lamb < 0.0f) continue;
        bool occ;
        if (carry_t) {
          const Hit hs = trace(S, x, y, z, ldx, ldy, ldz, t_run, neg_t);
          occ = hs.m != 0;
          t_run = hs.t;
        } else {
          occ = occluded(S, x, y, z, ldx, ldy, ldz, neg_t);
        }
        if (occ) continue;
        const float dqx = lx - x, dqy = ly - y, dqz = lz - z;
        const float dist2 = dqx * dqx + dqy * dqy + dqz * dqz;
        ti = ti + lamb * fminf(li / dist2, 1.0f);
      }
      ti = fminf(ti, 1.0f) * 0.25f;
      if (h.m == 1) {
        const int sel = (int)(ceilf(x * 0.2f) + ceilf(y * 0.2f)) & 1;
        sr = 3.0f * ti;
        sgc = (sel == 1 ? 1.0f : 3.0f) * ti;
        sb = sgc;
      } else {
        sr = 2.0f * ti;
        sgc = 3.0f * ti;
        sb = 2.0f * ti;
      }
    }
    fr = fr + sr;
    fg = fg + sgc;
    fb = fb + sb;
  }
  float* o = out + 3 * p;
  o[0] = fr * kExposure;
  o[1] = fg * kExposure;
  o[2] = fb * kExposure;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mega_super_launch(const float* scene, int ntp, int nl, int ns,
                                 int nq, unsigned k0, unsigned k1,
                                 unsigned spp_offset, unsigned spp_total,
                                 unsigned row_offset, int rows, int width,
                                 int spp, int neg_t, int carry_t, float* out,
                                 void* stream) {
  const long long n_px = (long long)rows * width;
  if (n_px <= 0) return 0;
  const size_t smem =
      sizeof(float) * (size_t)(ntp * 12 + 12 + nl * 4 + ns * 3 + 2 * nq);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_super_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((n_px + kBlock - 1) / kBlock);
  mega_super_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, ntp, nl, ns, nq, k0, k1, spp_offset, spp_total, row_offset, rows,
      width, spp, neg_t, carry_t, out);
  return (int)cudaGetLastError();
}

extern "C" const char* mega_super_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
