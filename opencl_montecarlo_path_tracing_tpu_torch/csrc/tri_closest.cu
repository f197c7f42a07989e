// Closest triangle per ray in the matmul formulation (kernel B7 of the
// port).
//
// Replaces the TPU kernel opencl_montecarlo_path_tracing_tpu/ops/
// pallas_tri.py::triangle_closest -> _run -> _kernel.  For each ray r it
// forms det, u*det, v*det and t*det of every triangle j as the dot
// product of the ray's 13 features (ops/intersect.py::_ray_features) with
// the triangle's four 13-weight columns (_triangle_weights), applies the
// validity epilogue (|det| >= 0.01, inv = 1/det, u = un*inv, v = vn*inv,
// rd = tn*inv, u, v in range, rd > 0.01 unless accept_negative_t) and
// keeps the smallest rd, the lowest index on a tie (the TPU kernel's
// first-index argmin within a 512-triangle chunk and strictly-better merge
// across chunks select the same triangle).  A miss writes inf and index 0.
//
// What bounds it on an H100: FP32 issue.  A (ray, triangle) pair costs 52
// multiplies and 48 adds for the four dot products plus ~15 operations of
// epilogue, and the only memory traffic is 52 bytes of features and 8 of
// output per ray plus the weights, 256 bytes per triangle, re-read from L2
// by every block.  Design: one thread per ray, its features in registers;
// the block stages 128 triangles' weights (32 KB, each triangle's 64
// floats contiguous in the (ntp, 4, 16) table) into shared memory with one
// linear copy, and every thread of a warp reads the same triangle (a
// broadcast, as float4s).  Plain FP32 on the CUDA cores: no tensor cores
// and no TF32, because the expanded weights cancel (t*det = o.n - v0.n on
// a sheet far from the origin).  The K sum runs in ascending feature
// order, built with --fmad=false so every multiply and add rounds on its
// own, and the epilogue keeps the TPU kernel's operation order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;      // triangles staged per shared-memory pass
constexpr int kFeat = 13;        // features per ray
constexpr float kEps = 0.01f;

__device__ __forceinline__ float dot13(const float* f, float4 a, float4 b,
                                       float4 c, float4 d) {
  float s = f[0] * a.x;
  s = s + f[1] * a.y;
  s = s + f[2] * a.z;
  s = s + f[3] * a.w;
  s = s + f[4] * b.x;
  s = s + f[5] * b.y;
  s = s + f[6] * b.z;
  s = s + f[7] * b.w;
  s = s + f[8] * c.x;
  s = s + f[9] * c.y;
  s = s + f[10] * c.z;
  s = s + f[11] * c.w;
  s = s + f[12] * d.x;
  return s;
}

__global__ void __launch_bounds__(kThreads)
tri_closest_kernel(const float* __restrict__ feat, int R,
                   const float4* __restrict__ w, int nt, int neg_t_flag,
                   float* __restrict__ t_out, int* __restrict__ i_out) {
  // per triangle: 4 quads x 16 weights = 16 float4
  __shared__ float4 sw[kChunk * 16];
  const bool neg_t = neg_t_flag != 0;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < R;
  float f[kFeat];
#pragma unroll
  for (int k = 0; k < kFeat; ++k)
    f[k] = live ? feat[(long long)r * kFeat + k] : 0.0f;

  float best_t = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int c0 = 0; c0 < nt; c0 += kChunk) {
    const int cn = min(kChunk, nt - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 16; i += kThreads)
      sw[i] = w[(long long)c0 * 16 + i];
    __syncthreads();
    for (int j = 0; j < cn; ++j) {
      const float4* q = sw + j * 16;
      const float det = dot13(f, q[0], q[1], q[2], q[3]);
      const float un = dot13(f, q[4], q[5], q[6], q[7]);
      const float vn = dot13(f, q[8], q[9], q[10], q[11]);
      const float tn = dot13(f, q[12], q[13], q[14], q[15]);
      bool ok = fabsf(det) >= kEps;
      const float inv = 1.0f / (ok ? det : 1.0f);
      const float u = un * inv;
      const float v = vn * inv;
      const float rd = tn * inv;
      ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
           (neg_t || rd > kEps);
      if (ok && rd < best_t) {
        best_t = rd;
        best_i = c0 + j;
      }
    }
  }
  if (live) {
    t_out[r] = best_t;
    i_out[r] = best_i;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `w` is
// the (ntp, 4, 16) float32 weight table, ntp >= nt.
extern "C" int tri_closest_launch(const float* feat, int R, const float* w,
                                  int nt, int neg_t, float* t_out,
                                  int* i_out, void* stream) {
  if (R <= 0) return 0;
  const unsigned grid = (unsigned)((R + kThreads - 1) / kThreads);
  tri_closest_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      feat, R, reinterpret_cast<const float4*>(w), nt, neg_t, t_out, i_out);
  return (int)cudaGetLastError();
}

extern "C" const char* tri_closest_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
