// The VLP family's light pass (kernels L1 and L2 of the port): the
// bidirectional emission (L1, light_emit_kernel), and the Metropolis seed
// paths (L2a, light_mlt_seed_kernel) and chain with its emission (L2b,
// light_mlt_chain_kernel), each in one launch.
//
// No Pallas kernel is replaced: the JAX package runs its light pass as
// XLA code under one jax.jit (opencl_montecarlo_path_tracing_tpu/ops/
// vlp.py::emit_vlps; models/metropolis.py::mlt_vlps, whose rounds are a
// fori_loop).  The port's plain version of it (ops/vlp.py::emit_vlps,
// models/metropolis.py::mlt_seed and mlt_mutate_emit with plain=True)
// traces every chain at every stage and masks the results, ~1,500 small
// launches a trace.  Here one thread runs one (light, work item) or one
// (light, chain) from its first draw to its table rows.
//
// - L1: one thread per (light l, work item gi) of the window [gi0, gi0 +
//   count): the uniform-sphere direction drawn at site SITE_VLP_DIR (+ l
//   unless reuse_light_direction), one closest-hit trace from the light,
//   and the VLP row vlp[l * count + gi - gi0] (ops/vlp.py::
//   vlp_from_light_sample).
// - L2a: one thread per (light, chain) of the window [chain0, chain0 +
//   chains): GetRandomPath (models/metropolis.py::_random_path) from the
//   light at sites SITE_SEED + 4 l + i; writes the seed state v (4 x 3
//   floats, unused slots zero) and its length.
// - L2b: one thread per (light, chain), its four vertices and its length
//   in registers (local memory where indexed) across every round: the
//   mutation_rounds Mutate rounds (models/metropolis.py::_mutate; round r
//   of light l draws at SITE_MLT + (r + l * rounds) * 16 + purpose), then
//   the emission of <= 4 VLPs, intensity halved a depth, into the
//   [light][slot][chain] table.
//
// Branches take the place of the plain version's masks: a trace whose
// result the plain version masks away is not made.  That is exact, as
// every draw is keyed on (key, chain or work item, site) alone, so a
// skipped trace consumes nothing that another draw reads; the same keying
// makes a thread per chain sound (a chain's rows depend on its own draws
// only).
//
// Exactness: the plain version's float operations in its order, so the
// tables are bit-equal to it on the card.  Built with --fmad=false and no
// fast math: cosf / sinf / sqrtf are libdevice's, as torch's; the
// emission's sphere normals are renormalised with rsqrtf (torch.rsqrt on a
// CUDA tensor: finish_rsqrt); 1 / x, the perturbation's S1 / (...), the
// direction's q / |q| and li / dist2 are IEEE divisions, as torch's tensor
// divisions are; a division by a host float (the intensity scale, the
// depth halving) is a product with the float32 reciprocal the wrapper
// passes, as torch's CUDA division by a scalar is.  Every comparison
// constant is a float literal (torch compares a float32 tensor with a
// Python float in float32); the float constants of the plain modules
// (2 pi, S1, S1 / S2, the perturbation offset) come from the wrapper.
//
// What bounds it on an H100: FP32 issue in the traces - per trace ~48
// operations a triangle of the mesh, ~19 a sphere; a 2-light Metropolis
// pass of 512 chains makes ~50 traces a chain.  The bytes (the scene and
// the table) are negligible.  Design, simple first: the scene
// (ops/mega_super.py::pack_scene, B1's buffer) staged in shared memory
// once a block up to kStageTriangles (B1's and B4's shared-memory tier),
// past it read in place from global memory, where the L1 and L2 caches
// hold it (a 20,736-triangle mesh is ~1 MB); blocks of kBlock = 32
// threads so that the main paths' 1,024 threads spread over 32 SMs; no
// per-warp cull.  Every triangle is scanned with the det-scaled test at
// every size, as B2/B3 scan theirs; past 2,048 triangles the plain
// version's traces take kernel B7's matmul form instead (ops/intersect.py
// ::trace_ray), which agrees with it to rounding, not bit for bit.

#include "pt_device.cuh"

namespace {

constexpr int kBlock = 32;
constexpr int kStageTriangles = 512;   // ops/mega_super.py MAX_SMEM_TRIANGLES
constexpr uint32_t kSiteVlpDir = 64;   // ops/vlp.py SITE_VLP_DIR
constexpr uint32_t kSiteSeed = 192;    // models/metropolis.py _SITE_SEED
constexpr uint32_t kSiteMlt = 256;     // _SITE_MLT
constexpr uint32_t kPDecide = 0, kPPerturb = 2, kPAdd = 6, kPRebuild = 10;

// The float constants of the plain modules, passed by the wrapper.
struct Consts {
  float two_pi;      // ops/vlp.py _TWO_PI
  float s1;          // models/metropolis.py _S1
  float ratio;       // _RATIO
  float dx_offset;   // _DX_OFFSET
};

// VLP base intensity by material (0 miss, 1 floor, 2 mirror sphere, 3
// square / diffuse sphere, 4 triangle): ops/vlp.py _BPT_BASE, _MLT_BASE.
__device__ __forceinline__ float base_intensity(int m, bool mlt) {
  if (m == 1) return mlt ? 400.0f : 70.0f;
  if (m == 2) return mlt ? 10.0f : 5.0f;
  if (m == 3) return 40.0f;
  return 0.0f;
}

// The two uniforms of site `site` for stream `ray_id` (core/rng.py rand2).
__device__ __forceinline__ void rand2(uint32_t k0, uint32_t k1,
                                      uint32_t ray_id, uint32_t site,
                                      float& u1, float& u2) {
  uint32_t b0, b1;
  threefry(k0, k1, ray_id, site * kSiteStride, b0, b1);
  u1 = unit(b0);
  u2 = unit(b1);
}

// ops/vlp.py::uniform_sphere.
__device__ __forceinline__ void uniform_sphere(float u1, float u2,
                                               float two_pi, float& dx,
                                               float& dy, float& dz) {
  const float z = 1.0f - 2.0f * u1;
  float w = 1.0f - z * z;
  w = w < 0.0f ? 0.0f : w;
  const float r = sqrtf(w);
  const float phi = two_pi * u2;
  dx = r * cosf(phi);
  dy = r * sinf(phi);
  dz = z;
}

// torch.clamp_max(x, 1.0): NaN stays NaN.
__device__ __forceinline__ float clamp1(float x) {
  return x > 1.0f ? 1.0f : x;
}

// ops/vlp.py::vlp_from_light_sample for one ray: trace from o along d,
// return (hit position, scaled intensity), zeros on a miss.  `li` is the
// light intensity (already halved per depth in the Metropolis emission),
// `inv_scale` the float32 reciprocal of the scale denominator.
__device__ float4 vlp_from_sample(const Scene& S, float ox, float oy,
                                  float oz, float dx, float dy, float dz,
                                  float li, float inv_scale, bool mlt,
                                  bool neg_t) {
  const Hit h = finish_rsqrt(trace_open(S, ox, oy, oz, dx, dy, dz, kBig,
                                        neg_t));
  if (h.m == 0) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float x = ox + dx * h.t;
  const float y = oy + dy * h.t;
  const float z = oz + dz * h.t;
  float lamb = dx * h.nx + dy * h.ny + dz * h.nz;
  const float qx = ox - x, qy = oy - y, qz = oz - z;
  const float dist2 = qx * qx + qy * qy + qz * qz;
  lamb = lamb < 0.0f ? 0.0f : lamb * clamp1(li / dist2);
  lamb = clamp1(lamb);
  const float intensity = base_intensity(h.m, mlt) * lamb * inv_scale;
  return make_float4(x, y, z, intensity);
}

// A Metropolis chain: its vertices and length.
struct Path {
  float v[4][3];
  int len;
};

// GetRandomPath (models/metropolis.py::_random_path) from (ox, oy, oz):
// up to 4 chained random vertices at sites site_base + i; stops at the
// first miss.  Unused slots are zero.
__device__ void random_path(const Scene& S, uint32_t k0, uint32_t k1,
                            uint32_t chain, float ox, float oy, float oz,
                            uint32_t site_base, float two_pi, bool neg_t,
                            Path& p, unsigned long long& traces) {
#pragma unroll
  for (int i = 0; i < 4; ++i) p.v[i][0] = p.v[i][1] = p.v[i][2] = 0.0f;
  p.len = 0;
  float cx = ox, cy = oy, cz = oz;
  for (int i = 0; i < 4; ++i) {
    float u1, u2, dx, dy, dz;
    rand2(k0, k1, chain, site_base + (uint32_t)i, u1, u2);
    uniform_sphere(u1, u2, two_pi, dx, dy, dz);
    const PreHit h = trace_open(S, cx, cy, cz, dx, dy, dz, kBig, neg_t);
    ++traces;
    if (h.m == 0) break;
    cx = cx + dx * h.t;
    cy = cy + dy * h.t;
    cz = cz + dz * h.t;
    p.v[i][0] = cx;
    p.v[i][1] = cy;
    p.v[i][2] = cz;
    p.len = i + 1;
  }
}

// The perturbed vertex (models/metropolis.py::_perturbation): three
// uniforms of site `site`, one an axis.
__device__ __forceinline__ void perturb(uint32_t k0, uint32_t k1,
                                        uint32_t chain, uint32_t site,
                                        const float* vert, const Consts& K,
                                        float* out) {
  uint32_t b[4];
  threefry(k0, k1, chain, site * kSiteStride, b[0], b[1]);
  threefry(k0, k1, chain, site * kSiteStride + 1u, b[2], b[3]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float r = unit(b[k]);
    const float dx = K.s1 / (K.ratio + fabsf(2.0f * r - 1.0f)) - K.dx_offset;
    const float x = vert[k];
    const float plus = x < 1.0f ? x + dx : x + dx - 1.0f;
    const float minus = x < 0.0f ? x - dx + 1.0f : x - dx;
    out[k] = r < 0.5f ? plus : minus;
  }
}

// VerifyIntersection (models/metropolis.py::_verify): the first hit from
// `o` toward `dest` is `dest`, exactly (exact) or within eps (eps2 the
// float32 eps * eps).
__device__ bool verify(const Scene& S, const float* o, const float* dest,
                       bool exact, float eps2, bool neg_t,
                       unsigned long long& traces) {
  const float qx = dest[0] - o[0], qy = dest[1] - o[1], qz = dest[2] - o[2];
  const float n = sqrtf(qx * qx + qy * qy + qz * qz);
  const float dx = qx / n, dy = qy / n, dz = qz / n;
  const PreHit h = trace_open(S, o[0], o[1], o[2], dx, dy, dz, kBig, neg_t);
  ++traces;
  if (h.m == 0) return false;
  const float x = o[0] + dx * h.t;
  const float y = o[1] + dy * h.t;
  const float z = o[2] + dz * h.t;
  if (exact) return x == dest[0] && y == dest[1] && z == dest[2];
  const float ex = x - dest[0], ey = y - dest[1], ez = z - dest[2];
  return ex * ex + ey * ey + ez * ez < eps2;
}

// One Mutate round (models/metropolis.py::_mutate) of one chain; `lp` the
// light's position, `base` the round's site base.
__device__ void mutate(const Scene& S, uint32_t k0, uint32_t k1,
                       uint32_t chain, const float* lp, uint32_t base,
                       const Consts& K, bool exact, float eps2, bool neg_t,
                       Path& p, unsigned long long& traces) {
  // an empty path: try to build a fresh one
  if (p.len == 0)
    random_path(S, k0, k1, chain, lp[0], lp[1], lp[2], base + kPRebuild,
                K.two_pi, neg_t, p, traces);
  if (p.len == 0) return;
  float r1, r2;
  rand2(k0, k1, chain, base + kPDecide, r1, r2);
  const float mut_prob = 1.0f / ((float)p.len + 0.2f);
  if (!(mut_prob >= r1)) return;

  // perturb and verify each vertex in chain order; replace the path
  // when every vertex passes
  float tv[4][3];
  int tlen = 0;
  const float* cur = lp;
  for (int i = 0; i < p.len; ++i) {
    perturb(k0, k1, chain, base + kPPerturb + (uint32_t)i, p.v[i], K,
            tv[i]);
    if (!verify(S, cur, tv[i], exact, eps2, neg_t, traces)) break;
    cur = tv[i];
    ++tlen;
  }
  if (tlen == p.len) {
    for (int i = 0; i < tlen; ++i) {
      p.v[i][0] = tv[i][0];
      p.v[i][1] = tv[i][1];
      p.v[i][2] = tv[i][2];
    }
  }

  // vertex additions, chosen by the length at entry, chained, stopping at
  // the first failure
  const int e = p.len;
  const bool want[3] = {
      (e == 1 && r2 > 0.3f) || (e == 2 && r2 < 0.3f) || (e == 3 && r2 < 0.2f),
      (e == 1 && r2 > 0.7f) || (e == 2 && r2 < 0.2f),
      e == 1 && r2 > 0.9f};
  for (int j = 0; j < 3; ++j) {
    if (!want[j] || p.len >= 4) continue;
    const float* o = p.v[p.len - 1];
    float u1, u2, dx, dy, dz;
    rand2(k0, k1, chain, base + kPAdd + (uint32_t)j, u1, u2);
    uniform_sphere(u1, u2, K.two_pi, dx, dy, dz);
    const PreHit h = trace_open(S, o[0], o[1], o[2], dx, dy, dz, kBig,
                                neg_t);
    ++traces;
    if (h.m == 0) break;
    const float x = o[0] + dx * h.t;
    const float y = o[1] + dy * h.t;
    const float z = o[2] + dz * h.t;
    p.v[p.len][0] = x;
    p.v[p.len][1] = y;
    p.v[p.len][2] = z;
    ++p.len;
  }
}

// The scene a block reads: copied into shared memory `smem` when `staged`
// (the launcher's choice, the same for every block), else read in place.
__device__ __forceinline__ Scene block_scene(const float* __restrict__ scene,
                                             bool staged, float* smem,
                                             int ntp, int nl, int ns,
                                             int nq) {
  if (!staged) return scene_view(scene, ntp, nl, ns, nq);
  const Scene S = stage_scene(scene, smem, ntp, nl, ns, nq);
  __syncthreads();
  return S;
}

__device__ __forceinline__ void add_traces(unsigned long long* out,
                                           unsigned long long n) {
  if (out != nullptr) atomicAdd(out, n);
}

// L1: rows [0, nl * count); row i = l * count + g, work item gi0 + g.
__global__ void __launch_bounds__(kBlock)
light_emit_kernel(const float* __restrict__ scene, bool staged, int ntp,
                  int nl, int ns, int nq, uint32_t k0, uint32_t k1, uint32_t gi0, int count,
                  bool reuse_dir, bool neg_t, Consts K, float inv_scale,
                  float4* __restrict__ out,
                  unsigned long long* __restrict__ traces) {
  extern __shared__ float4 smem4[];
  const Scene S = block_scene(scene, staged, reinterpret_cast<float*>(smem4),
                              ntp, nl, ns, nq);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nl * count) return;
  const int l = (int)(i / count);
  const uint32_t gi = gi0 + (uint32_t)(i % count);
  const float* lp = S.lights + 4 * l;
  float u1, u2, dx, dy, dz;
  rand2(k0, k1, gi, kSiteVlpDir + (reuse_dir ? 0u : (uint32_t)l), u1, u2);
  uniform_sphere(u1, u2, K.two_pi, dx, dy, dz);
  out[i] = vlp_from_sample(S, lp[0], lp[1], lp[2], dx, dy, dz, lp[3],
                           inv_scale, false, neg_t);
  add_traces(traces, 1);
}

// L2a: rows [0, nl * chains); row i = l * chains + c, chain chain0 + c.
__global__ void __launch_bounds__(kBlock)
light_mlt_seed_kernel(const float* __restrict__ scene, bool staged, int ntp,
                      int nl, int ns, int nq, uint32_t k0, uint32_t k1,
                      uint32_t chain0, int chains, bool neg_t, Consts K,
                      float* __restrict__ v_out, int* __restrict__ len_out,
                      unsigned long long* __restrict__ traces) {
  extern __shared__ float4 smem4[];
  const Scene S = block_scene(scene, staged, reinterpret_cast<float*>(smem4),
                              ntp, nl, ns, nq);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nl * chains) return;
  const int l = (int)(i / chains);
  const uint32_t chain = chain0 + (uint32_t)(i % chains);
  const float* lp = S.lights + 4 * l;
  Path p;
  unsigned long long n = 0;
  random_path(S, k0, k1, chain, lp[0], lp[1], lp[2],
              kSiteSeed + 4u * (uint32_t)l, K.two_pi, neg_t, p, n);
  float* v = v_out + 12 * i;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    v[3 * s] = p.v[s][0];
    v[3 * s + 1] = p.v[s][1];
    v[3 * s + 2] = p.v[s][2];
  }
  len_out[i] = p.len;
  add_traces(traces, n);
}

// L2b: the chain of row i = l * chains + c from its seed state, then its
// emission into rows (l * 4 + slot) * chains + c of `out`.
__global__ void __launch_bounds__(kBlock)
light_mlt_chain_kernel(const float* __restrict__ scene, bool staged,
                       int ntp, int nl, int ns, int nq, uint32_t k0,
                       uint32_t k1, uint32_t chain0, int chains, int rounds,
                       bool neg_t, Consts K, bool exact,
                       float eps2, float inv_scale,
                       const float* __restrict__ v_in,
                       const int* __restrict__ len_in,
                       float4* __restrict__ out,
                       unsigned long long* __restrict__ traces) {
  extern __shared__ float4 smem4[];
  const Scene S = block_scene(scene, staged, reinterpret_cast<float*>(smem4),
                              ntp, nl, ns, nq);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nl * chains) return;
  const int l = (int)(i / chains);
  const int c = (int)(i % chains);
  const uint32_t chain = chain0 + (uint32_t)c;
  const float* lp = S.lights + 4 * l;
  Path p;
  const float* v = v_in + 12 * i;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    p.v[s][0] = v[3 * s];
    p.v[s][1] = v[3 * s + 1];
    p.v[s][2] = v[3 * s + 2];
  }
  p.len = len_in[i];
  unsigned long long n = 0;
  for (int r = 0; r < rounds; ++r) {
    const uint32_t rnd = (uint32_t)r + (uint32_t)l * (uint32_t)rounds;
    mutate(S, k0, k1, chain, lp, kSiteMlt + rnd * 16u, K, exact, eps2,
           neg_t, p, n);
  }

  // emit <= 4 VLPs, intensity halved a depth; stop at the first dead one
  const float inv_depth[4] = {1.0f, 0.5f, 0.25f, 0.125f};
  float ox = lp[0], oy = lp[1], oz = lp[2];
  bool alive = p.len > 0;
  for (int s = 0; s < 4; ++s) {
    float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (alive && s < p.len) {
      const float qx = p.v[s][0] - ox, qy = p.v[s][1] - oy,
                  qz = p.v[s][2] - oz;
      const float len = sqrtf(qx * qx + qy * qy + qz * qz);
      row = vlp_from_sample(S, ox, oy, oz, qx / len, qy / len, qz / len,
                            lp[3] * inv_depth[s], inv_scale, true, neg_t);
      ++n;
      alive = row.w > 0.0f;
      if (!alive) row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      ox = p.v[s][0];
      oy = p.v[s][1];
      oz = p.v[s][2];
    } else {
      alive = false;
    }
    out[((long long)l * 4 + s) * chains + c] = row;
  }
  add_traces(traces, n);
}

// Whether the kernel stages the scene, and its shared memory (the packed
// scene, or none), with the attribute set past 48 KB; returns the error
// or cudaSuccess.
template <typename Kernel>
cudaError_t scene_smem(Kernel kernel, int ntp, int nl, int ns, int nq,
                       bool& staged, size_t& bytes) {
  staged = ntp <= kStageTriangles;
  bytes = staged ? sizeof(float) * (size_t)(ntp * 12 + 12 + nl * 4 + ns * 3
                                            + 2 * nq)
                 : 0;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  return cudaSuccess;
}

unsigned blocks(long long rows) {
  return (unsigned)((rows + kBlock - 1) / kBlock);
}

}  // namespace

// Launches on `stream`; each returns cudaGetLastError() (0 on success).
// `scene` is ops/mega_super.py::pack_scene's buffer; `traces` (nullable)
// a device uint64 to which the launch adds the traces it makes.  consts:
// 2 pi, S1, S1 / S2, the perturbation offset (float32).
//
// L1: out (nl * count, 4) float32.
extern "C" int light_emit_launch(const float* scene, int ntp, int nl, int ns,
                                 int nq, unsigned k0, unsigned k1,
                                 unsigned gi0, int count, int reuse_dir,
                                 int neg_t, float two_pi, float s1,
                                 float ratio, float dx_offset,
                                 float inv_scale, float* out,
                                 unsigned long long* traces, void* stream) {
  const long long rows = (long long)nl * count;
  if (rows <= 0) return 0;
  bool staged;
  size_t smem;
  cudaError_t e =
      scene_smem(light_emit_kernel, ntp, nl, ns, nq, staged, smem);
  if (e != cudaSuccess) return (int)e;
  light_emit_kernel<<<blocks(rows), kBlock, smem, (cudaStream_t)stream>>>(
      scene, staged, ntp, nl, ns, nq, k0, k1, gi0, count, reuse_dir != 0,
      neg_t != 0,
      Consts{two_pi, s1, ratio, dx_offset}, inv_scale,
      reinterpret_cast<float4*>(out), traces);
  return (int)cudaGetLastError();
}

// L2a: v (nl * chains, 4, 3) float32, length (nl * chains,) int32.
extern "C" int light_mlt_seed_launch(const float* scene, int ntp, int nl,
                                     int ns, int nq, unsigned k0,
                                     unsigned k1, unsigned chain0,
                                     int chains, int neg_t, float two_pi,
                                     float s1, float ratio, float dx_offset,
                                     float* v, int* length,
                                     unsigned long long* traces,
                                     void* stream) {
  const long long rows = (long long)nl * chains;
  if (rows <= 0) return 0;
  bool staged;
  size_t smem;
  cudaError_t e =
      scene_smem(light_mlt_seed_kernel, ntp, nl, ns, nq, staged, smem);
  if (e != cudaSuccess) return (int)e;
  light_mlt_seed_kernel<<<blocks(rows), kBlock, smem,
                          (cudaStream_t)stream>>>(
      scene, staged, ntp, nl, ns, nq, k0, k1, chain0, chains, neg_t != 0,
      Consts{two_pi, s1, ratio, dx_offset}, v, length, traces);
  return (int)cudaGetLastError();
}

// L2b: from the seed state (v_in, len_in), out (nl * 4 * chains, 4)
// float32; `exact` is verify_eps == 0, eps2 the float32 eps * eps.
extern "C" int light_mlt_chain_launch(
    const float* scene, int ntp, int nl, int ns, int nq, unsigned k0,
    unsigned k1, unsigned chain0, int chains, int rounds, int neg_t, float two_pi, float s1, float ratio, float dx_offset,
    int exact, float eps2, float inv_scale, const float* v_in,
    const int* len_in, float* out, unsigned long long* traces,
    void* stream) {
  const long long rows = (long long)nl * chains;
  if (rows <= 0) return 0;
  bool staged;
  size_t smem;
  cudaError_t e =
      scene_smem(light_mlt_chain_kernel, ntp, nl, ns, nq, staged, smem);
  if (e != cudaSuccess) return (int)e;
  light_mlt_chain_kernel<<<blocks(rows), kBlock, smem,
                           (cudaStream_t)stream>>>(
      scene, staged, ntp, nl, ns, nq, k0, k1, chain0, chains, rounds,
      neg_t != 0, Consts{two_pi, s1, ratio, dx_offset}, exact != 0, eps2,
      inv_scale, v_in, len_in, reinterpret_cast<float4*>(out), traces);
  return (int)cudaGetLastError();
}

extern "C" const char* light_pass_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
