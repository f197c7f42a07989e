// Dense VLP gather (kernel B6 of the port): for every shading point x with
// normal n, the sum over the live VLPs (p, I) of
//
//     a = n.p - n.x,   b = |p|^2 - 2 x.p + |x|^2,   r = 1 / sqrt(max(b, 1e-12))
//     c = max(a, 0) * min(I * r^3, r)
//
// in ascending VLP order.  It is the tier-1 gather of ops/vlp.py::
// gather_vlps for large batches (the configurations the VLP megakernel B4
// turns away).
//
// Replaces the TPU kernel opencl_montecarlo_path_tracing_tpu/ops/
// pallas_vlp.py::gather_vlps_mxu -> _kernel, which computes a and b as two
// K=16 products on the matrix unit.  Here there is no matrix product: the
// expansion of b cancels for close pairs, and the TPU measured a 1e4
// relative error with bf16 inputs (pallas_vlp.py:73-76); TF32's 10-bit
// mantissa fails the same way.  So all arithmetic is scalar FP32, built with
// --fmad=false (no FFMA contraction) and 1.0f / sqrtf in place of rsqrt.
//
// What bounds it on an H100: FP32 issue, ~20 operations, a square root and
// a division per (point, live VLP) pair; memory traffic is 24 bytes in and
// 4 out per point plus the live rows.  Design:
// - the table comes live rows first, with the live count n_live on the
//   device (ops/vlp.py::live_table, built once per VLP table).  A
//   dead row (I <= 0) adds exactly +0.0 to a finite sum, so scanning the
//   first n_live rows in order gives the full table's sum bit for bit;
// - one point per thread, holding x, n, n.x, |x|^2 and its running sum in
//   registers; the live rows staged through shared memory in tiles of
//   kTile rows that every thread of the block reads in the same order
//   (broadcast, no bank conflicts), so the sum is the sequential one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 512;   // VLP rows per shared-memory tile

__global__ void __launch_bounds__(kBlock)
gather_vlp_kernel(const float* __restrict__ x, const float* __restrict__ n,
                  const float4* __restrict__ tab,
                  const int* __restrict__ n_live_ptr, int R, int V,
                  float* __restrict__ out) {
  // tab row v: (px, py, pz, max(I, 0)), (|p|^2, 0, 0, 0)
  __shared__ float4 tile[2 * kTile];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < R;
  const long long k = active ? i : 0;
  const float xx = x[3 * k], xy = x[3 * k + 1], xz = x[3 * k + 2];
  const float nx = n[3 * k], ny = n[3 * k + 1], nz = n[3 * k + 2];
  const float ndx = nx * xx + ny * xy + nz * xz;
  const float x2 = xx * xx + xy * xy + xz * xz;
  const int n_live = min(max(*n_live_ptr, 0), V);
  float acc = 0.0f;
  for (int v0 = 0; v0 < n_live; v0 += kTile) {
    const int nv = min(kTile, n_live - v0);
    __syncthreads();   // every thread is done with the previous tile
    for (int j = threadIdx.x; j < 2 * nv; j += blockDim.x)
      tile[j] = tab[2 * (long long)v0 + j];
    __syncthreads();
    for (int j = 0; j < nv; ++j) {
      const float4 p = tile[2 * j];
      const float p2s = tile[2 * j + 1].x;
      const float a = (nx * p.x + ny * p.y + nz * p.z) - ndx;
      const float b = p2s - 2.0f * (xx * p.x + xy * p.y + xz * p.z) + x2;
      const float r = 1.0f / sqrtf(fmaxf(b, 1e-12f));
      acc = acc + fmaxf(a, 0.0f) * fminf(p.w * (r * r * r), r);
    }
  }
  if (active) out[i] = acc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  x, n:
// (R, 3) float32; tab: (V, 8) float32 rows (px, py, pz, max(I, 0), |p|^2,
// 0, 0, 0), live rows first; n_live: a device int32, the live rows' count;
// out: (R,) float32.
extern "C" int gather_vlp_launch(const float* x, const float* n,
                                 const float* tab, const int* n_live, int R,
                                 int V, float* out, void* stream) {
  if (R <= 0) return 0;
  const unsigned grid = (unsigned)(((long long)R + kBlock - 1) / kBlock);
  gather_vlp_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      x, n, reinterpret_cast<const float4*>(tab), n_live, R, V, out);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_vlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
