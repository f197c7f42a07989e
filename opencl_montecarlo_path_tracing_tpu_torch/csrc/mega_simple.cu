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
// What bounds it on an H100: FP32 instruction throughput.  A live ray
// costs ~19 operations per sphere test (49 spheres) on its trace and on
// its shadow ray; the only memory traffic is the 12-byte film write.
// Design, kept simple: one thread per pixel, the film sum kept in registers
// across the spp loop and written once, the camera and the sphere table
// staged once per block into shared memory (every lane of a warp reads the
// same centre: a broadcast), a bounce loop that leaves as soon as the path
// dies, and a shadow ray cast only where the shading reads it (lamb >= 0).
// Not carried over from the TPU kernel: the lock-step spp groups
// (_SPP_GROUP), the sphere-row unroll, the stacked ray bundles and the
// (3*_SUB, 128) output tile - mechanisms of the TPU's vreg layout and SMEM
// scalar reads.
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

constexpr int kBlock = 128;
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

__global__ void __launch_bounds__(kBlock)
mega_simple_kernel(const float* __restrict__ scene, int ns, uint32_t k0,
                   uint32_t k1, uint32_t spp_offset, uint32_t spp_total,
                   uint32_t row_offset, int rows, int width, int spp,
                   int max_bounces, int spec_mul_flag,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const Scene S =
      stage_scene(scene, reinterpret_cast<float*>(smem4), 0, 0, ns, 0);
  __syncthreads();
  const bool spec_mul = spec_mul_flag != 0;

  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)rows * width) return;
  const int ii_i = (int)(p % width);
  const int jj_row = (int)(p / width);
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
    bool alive = true;
    for (int b = 0; b < max_bounces; ++b) {
      const PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, kBig, false, 2);
      if (h.m == 0) {  // miss -> sky (spt.ocl:92-95)
        float sr, sgc, sb;
        shade_sky(dz, sr, sgc, sb);
        rr = cf + sr / div;
        rg = cf + sgc / div;
        rb = cf + sb / div;
        alive = false;
        break;
      }
      float nx = h.nx, ny = h.ny, nz = h.nz;
      if (h.needs) {
        const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
        nx = nx * inv_len;
        ny = ny * inv_len;
        nz = nz * inv_len;
      }
      const float x = ox + dx * h.t;
      const float y = oy + dy * h.t;
      const float z = oz + dz * h.t;
      uint32_t u0, u1;
      threefry(k0, k1, ray_id,
               ((uint32_t)kSiteLight0 + (uint32_t)b * kSiteStrideBounce) *
                   kSiteStride,
               u0, u1);
      const float lx = 9.0f + unit(u0) - x;
      const float ly = 9.0f + unit(u1) - y;
      const float lz = 16.0f - z;
      const float len = sqrtf(lx * lx + ly * ly + lz * lz);
      const float ldx = lx / len, ldy = ly / len, ldz = lz / len;
      float lamb = ldx * nx + ldy * ny + ldz * nz;
      // lamb < 0 zeroes lamb whatever the shadow ray finds: cast it only
      // where the shading reads it
      if (lamb < 0.0f || occluded(S, x, y, z, ldx, ldy, ldz, kBig, false))
        lamb = 0.0f;
      if (h.m == 1) {  // floor -> checker * (lamb*0.2 + 0.1) (spt.ocl:112-115)
        const int sel = (int)(ceilf(x * 0.2f) + ceilf(y * 0.2f)) & 1;
        const float a = lamb * 0.2f + 0.1f;
        rr = cf + (3.0f * a) / div;
        rg = cf + ((sel == 1 ? 1.0f : 3.0f) * a) / div;
        rb = rg;
        alive = false;
        break;
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
  float* o = out + 3 * p;
  o[0] = fr * kExposure;
  o[1] = fg * kExposure;
  o[2] = fb * kExposure;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mega_simple_launch(const float* scene, int ns, unsigned k0,
                                  unsigned k1, unsigned spp_offset,
                                  unsigned spp_total, unsigned row_offset,
                                  int rows, int width, int spp,
                                  int max_bounces, int spec_mul, float* out,
                                  void* stream) {
  const long long n_px = (long long)rows * width;
  if (n_px <= 0) return 0;
  // camera + sphere centres: 49 spheres are < 1 KB, far below 48 KB
  const size_t smem = sizeof(float) * (size_t)(12 + 3 * ns);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_simple_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((n_px + kBlock - 1) / kBlock);
  mega_simple_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, ns, k0, k1, spp_offset, spp_total, row_offset, rows, width, spp,
      max_bounces, spec_mul, out);
  return (int)cudaGetLastError();
}

extern "C" const char* mega_simple_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
