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

#include "pt_device.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
mega_super_kernel(const float* __restrict__ scene, int ntp, int nl, int ns,
                  int nq, uint32_t k0, uint32_t k1, uint32_t spp_offset,
                  uint32_t spp_total, uint32_t row_offset, int rows,
                  int width, int spp, int neg_t_flag, int carry_t_flag,
                  float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const Scene S = stage_scene(scene, reinterpret_cast<float*>(smem4), ntp, nl,
                              ns, nq);
  __syncthreads();
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

  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t s32 = (uint32_t)s + spp_offset;
    const uint32_t ray_id = pixel_index * spp_total + s32;
    const Ray ry = primary_ray(S, k0, k1, ray_id, ii, jj);
    const float ox = ry.ox, oy = ry.oy, oz = ry.oz;
    const float dx = ry.dx, dy = ry.dy, dz = ry.dz;

    const Hit h = trace(S, ox, oy, oz, dx, dy, dz, kBig, neg_t);

    float sr, sgc, sb;
    if (h.m == 0) {
      shade_sky(dz, sr, sgc, sb);
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
          occ = occluded(S, x, y, z, ldx, ldy, ldz, kBig, neg_t);
        }
        if (occ) continue;
        const float dqx = lx - x, dqy = ly - y, dqz = lz - z;
        const float dist2 = dqx * dqx + dqy * dqy + dqz * dqz;
        ti = ti + lamb * fminf(li / dist2, 1.0f);
      }
      ti = fminf(ti, 1.0f) * 0.25f;
      shade_lit(h.m, x, y, ti, sr, sgc, sb);
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
