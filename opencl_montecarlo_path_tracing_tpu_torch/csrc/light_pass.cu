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
// launches a trace.  Here one warp runs one (light, work item) or one
// (light, chain) from its first draw to its table rows.
//
// - L1: one warp per (light l, work item gi) of the window [gi0, gi0 +
//   count): the uniform-sphere direction drawn at site SITE_VLP_DIR (+ l
//   unless reuse_light_direction), one closest-hit trace from the light,
//   and the VLP row vlp[l * count + gi - gi0] (ops/vlp.py::
//   vlp_from_light_sample).
// - L2a: one warp per (light, chain) of the window [chain0, chain0 +
//   chains): GetRandomPath (models/metropolis.py::_random_path) from the
//   light at sites SITE_SEED + 4 l + i; writes the seed state v (4 x 3
//   floats, unused slots zero) and its length.
// - L2b: one warp per (light, chain), its four vertices and its length in
//   registers (local memory where indexed) across every round: the
//   mutation_rounds Mutate rounds (models/metropolis.py::_mutate; round r
//   of light l draws at SITE_MLT + (r + l * rounds) * 16 + purpose), then
//   the emission of <= 4 VLPs, intensity halved a depth, into the
//   [light][slot][chain] table.
//
// Branches take the place of the plain version's masks: a trace whose
// result the plain version masks away is not made.  That is exact, as
// every draw is keyed on (key, chain or work item, site) alone, so a
// skipped trace consumes nothing that another draw reads; the same keying
// makes a warp per chain sound (a chain's rows depend on its own draws
// only).
//
// Design (what bounds it and what the design does about it).  The work is
// FP32 issue in the traces' triangle stage: ~48 operations a (ray,
// triangle) pair, against ~19 a sphere; a 2-light Metropolis pass of 512
// chains makes ~12,800 traces on the demo scene, and the bytes (the scene
// and the table) are negligible.  The main paths run 1,024 chains or work
// items, too few to fill the card one a thread (the parent design: 32
// one-warp blocks on 32 of 132 SMs, each lane a different chain, so
// mutation branches and path lengths diverged, and each trace one
// thread's serial scan of every row).  So a trace gets a whole warp: the
// 1,024 warps, 4 a block, spread over every SM, and a chain's control
// flow is warp-uniform - every lane computes the same draws, path and
// branches on the same data (redundant lanes cost no issue slot), and the
// lanes split only the triangle stage (pt_device.cuh::warp_scan_closest,
// warp_walk_closest):
// - below 2,048 triangles (the wrapper's choice, ops/light_pass.py::
//   triangle_route) the full scan, 32 rows a step with a ballot and the
//   ordered update, which repeats the sequential scan's running minimum,
//   rounding and ties exactly, so the tables stay bit-equal to the plain
//   light pass; the scene staged in shared memory once a block up to
//   kStageTriangles (B1's and B4's tier), past it read in place;
// - from 2,048 triangles the culled walk over the Morton block tables
//   (ops/tri_blocks.py::walk_tables, built once a prepared scene): the
//   node tree, a macro's sub-block boxes one a lane, a taken sub-block's
//   rows one a lane (~120-175 rows a trace on a 20,736-triangle sheet);
//   the plain light pass there takes B7's matmul form, which agrees with
//   any scan to rounding, not bit for bit (exact ties: the lowest
//   original index, the full scan's earliest row).
// What bounds it now: one chain a warp is a dependent chain of draws,
// tests and branches, so the kernels are latency-bound (on the demo L2b
// spends ~44% of its cycles in the chain's own logic and ~28% in the
// floor, squares and spheres), and a 1,024-warp launch is short enough
// that its launch counts.  A counting instantiation (kStats) tallies
// traces, rows tested, box tests, ordered-update candidates and a clock64
// split of the stages, and can log each trace's (t, triangle index).
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

#include "pt_device.cuh"

namespace {

constexpr int kWarps = 4;              // warps a block, one a work unit
constexpr int kBlock = 32 * kWarps;
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

// The counting instantiation's tally of one work unit (a warp), added to
// the stats buffer at the end: [0] traces, [1] triangle rows tested, [2]
// tree-node and [3] sub-block box tests, [4] candidates through the
// ordered update (pt_device.cuh kTal*), clock64 cycles [5] in the floor,
// square and sphere stages, [6] in the triangle stage, [7] in the whole
// kernel (the rest is threefry and the chain's own logic).
constexpr int kStatSlots = 8;

template <bool kStats>
struct Tally {
  unsigned long long v[kStatSlots] = {};
  __device__ __forceinline__ void add(int slot, long long n) { v[slot] += n; }
  __device__ __forceinline__ long long clock() { return clock64(); }
  __device__ __forceinline__ void flush(unsigned long long* stats) {
    for (int i = 0; i < kStatSlots; ++i) atomicAdd(stats + i, v[i]);
  }
};

template <>
struct Tally<false> {
  __device__ __forceinline__ void add(int, long long) {}
  __device__ __forceinline__ long long clock() { return 0; }
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

// What every launch shares: the scene (the packed buffer, staged or read
// in place; without triangles on the culled route), the block tables of
// the culled route, the key, the quirk, the float constants, and the
// counting instantiation's stats buffer and per-trace log (each work unit
// owns log_cap slots of log_t / log_i, from its row).
struct Common {
  const float* scene;
  bool staged;
  int ntp, nl, ns, nq;
  Mesh M;
  bool walk;
  uint32_t k0, k1;
  bool neg_t;
  Consts K;
  unsigned long long* stats;
  float* log_t;
  int* log_i;
  int log_cap;
};

// One work unit's closest-hit traces, each made by the whole warp, counted
// (n) and, in the counting instantiation, tallied and logged.
template <bool kStats>
struct Tracer {
  Scene S;
  Mesh M;
  bool walk, neg_t;
  Tally<kStats> T;
  float* log_t;
  int* log_i;
  int log_cap;
  unsigned long long n = 0;   // traces made

  __device__ Tracer(const Scene& s, const Common& c, long long unit)
      : S(s), M(c.M), walk(c.walk), neg_t(c.neg_t),
        log_t(kStats && c.log_t ? c.log_t + unit * c.log_cap : nullptr),
        log_i(kStats && c.log_i ? c.log_i + unit * c.log_cap : nullptr),
        log_cap(c.log_cap) {}

  // Closest hit from (ox, oy, oz) along (dx, dy, dz): trace_open's result,
  // its sphere normal not yet renormalised.
  __device__ PreHit operator()(float ox, float oy, float oz, float dx,
                               float dy, float dz) {
    const long long c0 = T.clock();
    PreHit h = pre_tri(S, ox, oy, oz, dx, dy, dz, kBig, neg_t, 3);
    const long long c1 = T.clock();
    int tri = -1;
    if (walk || S.ntp) {
      float bn = h.t, bd = 1.0f;
      int row;
      float4 e;
      if (walk) {
        row = warp_walk_closest(M, ox, oy, oz, dx, dy, dz, neg_t, bn, bd, T);
        if (row >= 0) {
          e = __ldg(M.rows + 4 * row + 2);
          tri = __float_as_int(__ldg(M.rows + 4 * row + 3).x);
        }
      } else {
        row = warp_scan_closest(S, ox, oy, oz, dx, dy, dz, neg_t, bn, bd, T);
        if (row >= 0) {
          e = reinterpret_cast<const float4*>(S.tri)[3 * row + 2];
          tri = row;
        }
      }
      if (row >= 0) {
        h.m = 4;
        h.nx = e.y;
        h.ny = e.z;
        h.nz = e.w;
        h.needs = false;
      }
      h.t = bn / bd;
    }
    T.add(5, c1 - c0);
    T.add(6, T.clock() - c1);
    if (log_t != nullptr && n < (unsigned long long)log_cap &&
        (threadIdx.x & 31) == 0) {
      log_t[n] = h.t;
      log_i[n] = tri;
    }
    ++n;
    return h;
  }
};

// ops/vlp.py::vlp_from_light_sample for one ray: trace from o along d,
// return (hit position, scaled intensity), zeros on a miss.  `li` is the
// light intensity (already halved per depth in the Metropolis emission),
// `inv_scale` the float32 reciprocal of the scale denominator.
template <class Tr>
__device__ float4 vlp_from_sample(Tr& trace, float ox, float oy, float oz,
                                  float dx, float dy, float dz, float li,
                                  float inv_scale, bool mlt) {
  const Hit h = finish_rsqrt(trace(ox, oy, oz, dx, dy, dz));
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
template <class Tr>
__device__ void random_path(Tr& trace, uint32_t k0, uint32_t k1,
                            uint32_t chain, float ox, float oy, float oz,
                            uint32_t site_base, float two_pi, Path& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) p.v[i][0] = p.v[i][1] = p.v[i][2] = 0.0f;
  p.len = 0;
  float cx = ox, cy = oy, cz = oz;
  for (int i = 0; i < 4; ++i) {
    float u1, u2, dx, dy, dz;
    rand2(k0, k1, chain, site_base + (uint32_t)i, u1, u2);
    uniform_sphere(u1, u2, two_pi, dx, dy, dz);
    const PreHit h = trace(cx, cy, cz, dx, dy, dz);
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
template <class Tr>
__device__ bool verify(Tr& trace, const float* o, const float* dest,
                       bool exact, float eps2) {
  const float qx = dest[0] - o[0], qy = dest[1] - o[1], qz = dest[2] - o[2];
  const float n = sqrtf(qx * qx + qy * qy + qz * qz);
  const float dx = qx / n, dy = qy / n, dz = qz / n;
  const PreHit h = trace(o[0], o[1], o[2], dx, dy, dz);
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
template <class Tr>
__device__ void mutate(Tr& trace, uint32_t k0, uint32_t k1, uint32_t chain,
                       const float* lp, uint32_t base, const Consts& K,
                       bool exact, float eps2, Path& p) {
  // an empty path: try to build a fresh one
  if (p.len == 0)
    random_path(trace, k0, k1, chain, lp[0], lp[1], lp[2], base + kPRebuild,
                K.two_pi, p);
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
    if (!verify(trace, cur, tv[i], exact, eps2)) break;
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
    const PreHit h = trace(o[0], o[1], o[2], dx, dy, dz);
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

// The scene a block reads: copied into shared memory `smem` when staged
// (the launcher's choice, the same for every block), else read in place.
__device__ __forceinline__ Scene block_scene(const Common& C, float* smem) {
  if (!C.staged) return scene_view(C.scene, C.ntp, C.nl, C.ns, C.nq);
  const Scene S = stage_scene(C.scene, smem, C.ntp, C.nl, C.ns, C.nq);
  __syncthreads();
  return S;
}

// This thread's work unit: its warp.
__device__ __forceinline__ long long work_unit() {
  return (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

// Whether this thread writes its unit's outputs: lane 0 of the warp (every
// lane holds the same values).
__device__ __forceinline__ bool writer() { return (threadIdx.x & 31) == 0; }

template <bool kStats>
__device__ __forceinline__ void finish_unit(Tracer<kStats>& tr,
                                            long long k_start,
                                            unsigned long long* stats) {
  tr.T.add(0, tr.n);
  tr.T.add(7, tr.T.clock() - k_start);
  if (writer()) tr.T.flush(stats);
}

// L1: rows [0, nl * count); row i = l * count + g, work item gi0 + g.
template <bool kStats>
__global__ void __launch_bounds__(kBlock)
light_emit_kernel(Common C, uint32_t gi0, int count, bool reuse_dir,
                  float inv_scale, float4* __restrict__ out) {
  const long long k_start = kStats ? clock64() : 0;
  extern __shared__ float4 smem4[];
  const Scene S = block_scene(C, reinterpret_cast<float*>(smem4));
  const long long i = work_unit();
  if (i >= (long long)C.nl * count) return;
  Tracer<kStats> trace(S, C, i);
  const int l = (int)(i / count);
  const uint32_t gi = gi0 + (uint32_t)(i % count);
  const float* lp = S.lights + 4 * l;
  float u1, u2, dx, dy, dz;
  rand2(C.k0, C.k1, gi, kSiteVlpDir + (reuse_dir ? 0u : (uint32_t)l), u1,
        u2);
  uniform_sphere(u1, u2, C.K.two_pi, dx, dy, dz);
  const float4 row = vlp_from_sample(trace, lp[0], lp[1], lp[2], dx, dy, dz,
                                     lp[3], inv_scale, false);
  if (writer()) out[i] = row;
  finish_unit(trace, k_start, C.stats);
}

// L2a: rows [0, nl * chains); row i = l * chains + c, chain chain0 + c.
template <bool kStats>
__global__ void __launch_bounds__(kBlock)
light_mlt_seed_kernel(Common C, uint32_t chain0, int chains,
                      float* __restrict__ v_out, int* __restrict__ len_out) {
  const long long k_start = kStats ? clock64() : 0;
  extern __shared__ float4 smem4[];
  const Scene S = block_scene(C, reinterpret_cast<float*>(smem4));
  const long long i = work_unit();
  if (i >= (long long)C.nl * chains) return;
  Tracer<kStats> trace(S, C, i);
  const int l = (int)(i / chains);
  const uint32_t chain = chain0 + (uint32_t)(i % chains);
  const float* lp = S.lights + 4 * l;
  Path p;
  random_path(trace, C.k0, C.k1, chain, lp[0], lp[1], lp[2],
              kSiteSeed + 4u * (uint32_t)l, C.K.two_pi, p);
  if (writer()) {
    float* v = v_out + 12 * i;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      v[3 * s] = p.v[s][0];
      v[3 * s + 1] = p.v[s][1];
      v[3 * s + 2] = p.v[s][2];
    }
    len_out[i] = p.len;
  }
  finish_unit(trace, k_start, C.stats);
}

// L2b: the chain of row i = l * chains + c from its seed state, then its
// emission into rows (l * 4 + slot) * chains + c of `out`.
template <bool kStats>
__global__ void __launch_bounds__(kBlock)
light_mlt_chain_kernel(Common C, uint32_t chain0, int chains, int rounds,
                       bool exact, float eps2, float inv_scale,
                       const float* __restrict__ v_in,
                       const int* __restrict__ len_in,
                       float4* __restrict__ out) {
  const long long k_start = kStats ? clock64() : 0;
  extern __shared__ float4 smem4[];
  const Scene S = block_scene(C, reinterpret_cast<float*>(smem4));
  const long long i = work_unit();
  if (i >= (long long)C.nl * chains) return;
  Tracer<kStats> trace(S, C, i);
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
  for (int r = 0; r < rounds; ++r) {
    const uint32_t rnd = (uint32_t)r + (uint32_t)l * (uint32_t)rounds;
    mutate(trace, C.k0, C.k1, chain, lp, kSiteMlt + rnd * 16u, C.K, exact,
           eps2, p);
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
      row = vlp_from_sample(trace, ox, oy, oz, qx / len, qy / len, qz / len,
                            lp[3] * inv_depth[s], inv_scale, true);
      alive = row.w > 0.0f;
      if (!alive) row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      ox = p.v[s][0];
      oy = p.v[s][1];
      oz = p.v[s][2];
    } else {
      alive = false;
    }
    if (writer()) out[((long long)l * 4 + s) * chains + c] = row;
  }
  finish_unit(trace, k_start, C.stats);
}

// The launch's shared arguments; the scene is staged when the buffer's
// triangles (none on the culled route) fit kStageTriangles.
Common common(const float* scene, int ntp, int nl, int ns, int nq,
              const float* rows, const float* subs, const float* nodes,
              int n_nodes, unsigned k0, unsigned k1, int neg_t,
              float two_pi, float s1, float ratio, float dx_offset,
              void* stats, float* log_t, int* log_i, int log_cap) {
  Common C{};
  C.scene = scene;
  C.staged = ntp <= kStageTriangles;
  C.ntp = ntp;
  C.nl = nl;
  C.ns = ns;
  C.nq = nq;
  C.M.rows = reinterpret_cast<const float4*>(rows);
  C.M.subs = reinterpret_cast<const float4*>(subs);
  C.M.nodes = reinterpret_cast<const float4*>(nodes);
  C.M.n_nodes = n_nodes;
  C.walk = rows != nullptr;
  C.k0 = k0;
  C.k1 = k1;
  C.neg_t = neg_t != 0;
  C.K = Consts{two_pi, s1, ratio, dx_offset};
  C.stats = reinterpret_cast<unsigned long long*>(stats);
  C.log_t = log_t;
  C.log_i = log_i;
  C.log_cap = log_cap;
  return C;
}

// Launch `kernel` (the instantiation for stats) over `units` work units,
// kWarps a block, with the scene's shared memory (the packed scene when
// staged, the attribute set past 48 KB); returns the error or cudaSuccess.
template <class Kernel, class... Args>
cudaError_t launch(const Common& C, long long units, Kernel kernel,
                   void* stream, Args... args) {
  const size_t bytes =
      C.staged ? sizeof(float) * (size_t)(C.ntp * 12 + 12 + C.nl * 4 +
                                          C.ns * 3 + 2 * C.nq)
               : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = (unsigned)((units + kWarps - 1) / kWarps);
  kernel<<<grid, kBlock, bytes, (cudaStream_t)stream>>>(C, args...);
  return cudaGetLastError();
}

// The instantiation of a kernel template K for stats.
#define PICK(K, stats) ((stats) ? K<true> : K<false>)

}  // namespace

// Launches on `stream`; each returns cudaGetLastError() (0 on success).
// `scene` is ops/mega_super.py::pack_scene's buffer (without triangles,
// ntp 0, on the culled route); `rows` / `subs` / `nodes` (n_nodes of them)
// the block tables of ops/tri_blocks.py::walk_tables, or null for the full
// scan; `stats` (nullable) kStatSlots zeroed uint64 counters: the
// counting instantiation runs and adds its tally there, and logs each trace's (t, triangle index) into log_t / log_i
// (nullable; log_cap slots a work unit).  consts: 2 pi, S1, S1 / S2, the
// perturbation offset (float32).
//
// L1: out (nl * count, 4) float32.
extern "C" int light_emit_launch(
    const float* scene, int ntp, int nl, int ns, int nq, const float* rows,
    const float* subs, const float* nodes, int n_nodes, unsigned k0,
    unsigned k1, unsigned gi0, int count, int reuse_dir, int neg_t,
    float two_pi, float s1, float ratio, float dx_offset, float inv_scale,
    float* out, void* stats, float* log_t, int* log_i, int log_cap,
    void* stream) {
  const long long units = (long long)nl * count;
  if (units <= 0) return 0;
  const Common C = common(scene, ntp, nl, ns, nq, rows, subs, nodes, n_nodes,
                          k0, k1, neg_t, two_pi, s1, ratio, dx_offset, stats,
                          log_t, log_i, log_cap);
  return (int)launch(C, units, PICK(light_emit_kernel, stats != nullptr),
                     stream, (uint32_t)gi0, count, reuse_dir != 0,
                     inv_scale, reinterpret_cast<float4*>(out));
}

// L2a: v (nl * chains, 4, 3) float32, length (nl * chains,) int32.
extern "C" int light_mlt_seed_launch(
    const float* scene, int ntp, int nl, int ns, int nq, const float* rows,
    const float* subs, const float* nodes, int n_nodes, unsigned k0,
    unsigned k1, unsigned chain0, int chains, int neg_t, float two_pi,
    float s1, float ratio, float dx_offset, float* v, int* length,
    void* stats, float* log_t, int* log_i, int log_cap, void* stream) {
  const long long units = (long long)nl * chains;
  if (units <= 0) return 0;
  const Common C = common(scene, ntp, nl, ns, nq, rows, subs, nodes, n_nodes,
                          k0, k1, neg_t, two_pi, s1, ratio, dx_offset, stats,
                          log_t, log_i, log_cap);
  return (int)launch(
      C, units, PICK(light_mlt_seed_kernel, stats != nullptr), stream,
      (uint32_t)chain0, chains, v, length);
}

// L2b: from the seed state (v_in, len_in), out (nl * 4 * chains, 4)
// float32; `exact` is verify_eps == 0, eps2 the float32 eps * eps.
extern "C" int light_mlt_chain_launch(
    const float* scene, int ntp, int nl, int ns, int nq, const float* rows,
    const float* subs, const float* nodes, int n_nodes, unsigned k0,
    unsigned k1, unsigned chain0, int chains, int rounds, int neg_t,
    float two_pi, float s1, float ratio, float dx_offset, int exact,
    float eps2, float inv_scale, const float* v_in, const int* len_in,
    float* out, void* stats, float* log_t, int* log_i, int log_cap,
    void* stream) {
  const long long units = (long long)nl * chains;
  if (units <= 0) return 0;
  const Common C = common(scene, ntp, nl, ns, nq, rows, subs, nodes, n_nodes,
                          k0, k1, neg_t, two_pi, s1, ratio, dx_offset, stats,
                          log_t, log_i, log_cap);
  return (int)launch(
      C, units, PICK(light_mlt_chain_kernel, stats != nullptr), stream,
      (uint32_t)chain0, chains, rounds, exact != 0, eps2, inv_scale, v_in,
      len_in, reinterpret_cast<float4*>(out));
}

extern "C" const char* light_pass_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
