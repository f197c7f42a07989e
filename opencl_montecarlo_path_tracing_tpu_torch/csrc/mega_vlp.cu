// VLP megakernel: the whole render pass of the bidirectional / metropolis /
// metropolis_vlpgrid family, all spp, in one kernel (kernel B4 of the port).
//
// Replaces the TPU kernel opencl_montecarlo_path_tracing_tpu/ops/
// pallas_bpt.py::film_vlp_mega -> _vlp_mega_kernel.  For every pixel of the
// band [row_offset, row_offset+rows) x [0, W) it sums `spp` samples with
// global sample index s + spp_offset of spp_total and writes the
// pre-ambient film * EXPOSURE once.  Per sample: B1's camera and closest
// hit (csrc/pt_device.cuh); on floor and diffuse hits the VLP gather
// sum_v max(n.(p-x), 0)/d * min(I/d^2, 1) over the first n_live rows of the
// live-first compacted VLP table (in grid mode only the VLPs whose clipped
// cell-index box holds the shading point's cell, an uncapped masked scan),
// min(., 1), minus 1/nlights for every light whose jittered shadow ray is
// occluded before the UN-jittered light distance, times 1/4; then the
// 4-material shading.  There is no lamb < 0 skip on the shadow rays: the
// correction is subtracted whatever the facing (bidirectional.py:77-81).
//
// What bounds it on an H100: FP32 ALU issue, as for B1.  A sample costs
// ~48 FLOP per (ray, triangle) pair for the primary trace and the capped
// occlusion scans, plus ~20 FLOP and one square root per (ray, live VLP)
// pair; typical tables are ~1% live (the reference scene emits 6 live
// rows of 1024), the dense_vlp_scene ~100%.  Memory traffic is the table
// (32 or 48 bytes a row, read once per block and chunk) and the 12-byte
// film write per pixel.  Design: one thread per pixel, the film sum in
// registers across the spp loop; the scene staged once per block in shared
// memory; the VLP table streamed through shared memory in chunks of
// `chunk` rows (256 by default) that every thread of the block scans in
// the same order (a broadcast read per row, no bank conflicts), loaded
// once per launch when all live rows fit one chunk; n_live read on the
// device, so the host never waits.  Sky and facing-ratio lanes skip the gather and the shadow
// rays (their shading ignores the illumination), an occlusion scan stops
// at its first hit: neither changes the film.  The arithmetic keeps the
// JAX kernel's operation order, with 1.0f / sqrtf where it uses rsqrt;
// built with --fmad=false and without fast math.

#include "pt_device.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
mega_vlp_kernel(const float* __restrict__ scene, int ntp, int nl, int ns,
                int nq, uint32_t k0, uint32_t k1, uint32_t spp_offset,
                uint32_t spp_total, uint32_t row_offset, int rows, int width,
                int spp, int neg_t_flag, const float* __restrict__ vlp,
                int nvp, int stride, int chunk,
                const int* __restrict__ n_live_ptr,
                const float* __restrict__ gridp, float inv_nl,
                float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Scene S = stage_scene(scene, smem, ntp, nl, ns, nq);
  // the VLP chunk follows the scene, float4-aligned
  float* vsm = smem + ((scene_floats(ntp, nl, ns, nq) + 3) & ~3);
  const float4* vsm4 = reinterpret_cast<const float4*>(vsm);
  const float4* vlp4 = reinterpret_cast<const float4*>(vlp);
  const int n_live = min(max(*n_live_ptr, 0), nvp);
  const int n_chunks = (n_live + chunk - 1) / chunk;
  const bool grid_mode = gridp != nullptr;
  // grid mode: vmin (3), cell size (3), resolution (3) as floats
  float gv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) gv[i] = grid_mode ? gridp[i] : 0.0f;
  const bool neg_t = neg_t_flag != 0;
  __syncthreads();

  // threads past the band's end still stage VLP chunks with the block
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = p < (long long)rows * width;
  const long long pc = active ? p : 0;
  const int ii_i = (int)(pc % width);
  const int jj_row = (int)(pc / width);
  const uint32_t row_u = (uint32_t)jj_row + row_offset;
  // the pixel index wraps like the JAX kernel's int32 arithmetic
  const uint32_t pixel_index = row_u * (uint32_t)width + (uint32_t)ii_i;
  const float ii = (float)ii_i;
  const float jj = (float)(int)row_u;

  bool resident = false;   // the one chunk of a table with <= chunk live rows
  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t s32 = (uint32_t)s + spp_offset;
    const uint32_t ray_id = pixel_index * spp_total + s32;
    const Ray ry = primary_ray(S, k0, k1, ray_id, ii, jj);
    const Hit h = active ? trace(S, ry.ox, ry.oy, ry.oz, ry.dx, ry.dy, ry.dz,
                                 kBig, neg_t)
                         : Hit{kBig, 0, 0.0f, 0.0f, 0.0f};
    const bool lit = h.m == 1 || h.m == 3;
    const float x = ry.ox + ry.dx * h.t;
    const float y = ry.oy + ry.dy * h.t;
    const float z = ry.oz + ry.dz * h.t;

    // gather state of the shading point: n.x, |x|^2 and, in grid mode, its
    // cell (true division, as the JAX kernel) and in-box flag
    const float ndx = h.nx * x + h.ny * y + h.nz * z;
    const float x2 = x * x + y * y + z * z;
    float cxf = 0.0f, cyf = 0.0f, czf = 0.0f;
    bool in_box = false;
    if (grid_mode) {
      cxf = floorf((x - gv[0]) / gv[3]);
      cyf = floorf((y - gv[1]) / gv[4]);
      czf = floorf((z - gv[2]) / gv[5]);
      in_box = cxf >= 0.0f && cxf < gv[6] && cyf >= 0.0f && cyf < gv[7] &&
               czf >= 0.0f && czf < gv[8];
    }
    float gsum = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int r0 = c * chunk;
      const int nr = min(chunk, n_live - r0);
      if (n_chunks > 1 || !resident) {
        __syncthreads();   // every thread is done with the previous chunk
        const int n4 = nr * stride / 4;
        const float4* src = vlp4 + (long long)r0 * stride / 4;
        float4* dst = reinterpret_cast<float4*>(vsm);
        for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
        __syncthreads();
        resident = true;
      }
      if (!lit || (grid_mode && !in_box)) continue;
      if (grid_mode) {
        // row: px py pz I | |p|^2 clo.xyz | chi.xyz pad
        for (int r = 0; r < nr; ++r) {
          const float4 b = vsm4[3 * r + 1];
          const float4 e = vsm4[3 * r + 2];
          if (!(b.y <= cxf && cxf <= e.x && b.z <= cyf && cyf <= e.y &&
                b.w <= czf && czf <= e.z))
            continue;
          const float4 a = vsm4[3 * r];
          const float lamb_num = (h.nx * a.x + h.ny * a.y + h.nz * a.z) - ndx;
          const float dist2 = fmaxf(
              b.x - 2.0f * (x * a.x + y * a.y + z * a.z) + x2, 1e-12f);
          const float rs = 1.0f / sqrtf(dist2);
          gsum = gsum +
                 fmaxf(lamb_num, 0.0f) * rs * fminf(a.w * (rs * rs), 1.0f);
        }
      } else {
        // row: px py pz I | |p|^2 pad pad pad
        for (int r = 0; r < nr; ++r) {
          const float4 a = vsm4[2 * r];
          const float p2s = vsm[8 * r + 4];
          const float lamb_num = (h.nx * a.x + h.ny * a.y + h.nz * a.z) - ndx;
          const float dist2 = fmaxf(
              p2s - 2.0f * (x * a.x + y * a.y + z * a.z) + x2, 1e-12f);
          const float rs = 1.0f / sqrtf(dist2);
          gsum = gsum +
                 fmaxf(lamb_num, 0.0f) * rs * fminf(a.w * (rs * rs), 1.0f);
        }
      }
    }

    float sr, sgc, sb;
    if (h.m == 0) {
      shade_sky(ry.dz, sr, sgc, sb);
    } else if (h.m == 4) {
      const float facing =
          fmaxf(0.0f, -(h.nx * ry.dx + h.ny * ry.dy + h.nz * ry.dz));
      sr = sgc = sb = facing;
    } else {
      // gather -> clamp 1 -> soft-shadow corrections -> / 4
      float ti = fminf(gsum, 1.0f);
      for (int i = 0; i < S.nl; ++i) {
        const float lx = S.lights[4 * i], ly = S.lights[4 * i + 1];
        const float lz = S.lights[4 * i + 2];
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
        // capped at the UN-jittered light distance (ocl:195-197)
        const float dqx = lx - x, dqy = ly - y, dqz = lz - z;
        const float tl = sqrtf(dqx * dqx + dqy * dqy + dqz * dqz);
        if (occluded(S, x, y, z, ldx, ldy, ldz, tl, neg_t)) ti = ti - inv_nl;
      }
      ti = ti * 0.25f;
      shade_lit(h.m, x, y, ti, sr, sgc, sb);
    }
    fr = fr + sr;
    fg = fg + sgc;
    fb = fb + sb;
  }
  if (!active) return;
  float* o = out + 3 * p;
  o[0] = fr * kExposure;
  o[1] = fg * kExposure;
  o[2] = fb * kExposure;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `vlp` is
// the (nvp, stride) float32 table, stride 8 (dense) or 12 (grid mode, with
// `gridp` the 9 grid floats; NULL in dense mode); `n_live` a device int32;
// `chunk` the rows staged in shared memory at a time.
extern "C" int mega_vlp_launch(const float* scene, int ntp, int nl, int ns,
                               int nq, unsigned k0, unsigned k1,
                               unsigned spp_offset, unsigned spp_total,
                               unsigned row_offset, int rows, int width,
                               int spp, int neg_t, const float* vlp, int nvp,
                               int stride, int chunk, const int* n_live,
                               const float* gridp, float inv_nl, float* out,
                               void* stream) {
  const long long n_px = (long long)rows * width;
  if (n_px <= 0) return 0;
  if ((stride != 8 && stride != 12) || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const int scene_n = ntp * 12 + 12 + nl * 4 + ns * 3 + 2 * nq;
  const size_t smem =
      sizeof(float) * ((size_t)((scene_n + 3) & ~3) + (size_t)chunk * stride);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mega_vlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((n_px + kBlock - 1) / kBlock);
  mega_vlp_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      scene, ntp, nl, ns, nq, k0, k1, spp_offset, spp_total, row_offset, rows,
      width, spp, neg_t, vlp, nvp, stride, chunk, n_live, gridp, inv_nl, out);
  return (int)cudaGetLastError();
}

extern "C" const char* mega_vlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
