// Transpose of the bilinear homography warp (the "splat") for Hopper (sm_90a).
//
// Replaces the two TPU kernels gmpi_tpu/ops/pallas_warp.py:_splat_plane_kernel
// (launched by warp_splat_fat, pallas_warp.py:1609) and :_splat_kernel
// (launched by warp_splat, pallas_warp.py:1762).  The two compute one function
// and differ in how the texture accumulator is partitioned for the TPU's
// VMEM; on this card the accumulator is the output tensor itself, so this one
// kernel stands for both.
//
// What it computes: the exact transpose of the forward kernel's warp
// (fused_fwd.cu).  For every pixel (v, i, j) and plane l, the cotangent
// d_samp[v, l, :, i, j] of the bilinear sample is scattered onto the four
// texels the forward read, with the weights it read them with:
//   fx = Ax_l * rx + Bx_l,  fy = Ay_l * ry + By_l
//   d_tex[v, l, c, y0 + dy, x0 + dx] += wy(dy) * wx(dx) * d_samp[v, l, c, i, j]
// with the same float-compared bounds, so a tap the forward read as zero
// (outside the texture) drops its weight here too.  Planes l >= n_live of a
// pixel are skipped without reading their slots.
//
// Bound on an H100 SXM: memory.  d_samp is read once (live pairs, 16 B each)
// and d_tex written once (plus the memset that zeroes it): 0.27 GB + 0.27 GB
// at V=8, L=32, 256^2, ~0.16 ms at 3.35 TB/s, against ~30 FLOP per pair.
//
// Design: a scatter with atomics.  One thread per pixel loops over its live
// planes and issues up to 16 fp32 atomicAdd per plane (4 taps x 4 channels;
// the result is unused, so they compile to fire-and-forget reductions that
// resolve in L2).  The homography is near identity, so a warp's 32 pixels hit
// ~33 neighbouring texels per tap and the reductions coalesce.  The
// alternative, an owner-computes gather over each texel's inverse footprint,
// is deterministic but needs the inverse homography and a footprint bound per
// plane; the scatter is the simple form that is right.  Its cost: fp32 sums
// whose order changes from run to run, so d_tex is repeatable to rounding
// only, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;

__global__ void splat_kernel(const float* __restrict__ d_samp, const float* __restrict__ rx,
                             const float* __restrict__ ry, const float* __restrict__ scal,
                             const int* __restrict__ n_live, float* __restrict__ d_tex, int L,
                             int Th, int Tw, int H, int W) {
  extern __shared__ float s_scal[];  // [L, 6] of this view
  const int v = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < L * 6; k += blockDim.x * blockDim.y) {
    s_scal[k] = scal[(long long)v * L * 6 + k];
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;

  const long long hw = (long long)H * W;
  const long long pix = (long long)i * W + j;
  const long long p = (long long)v * hw + pix;
  const float rxv = rx[p];
  const float ryv = ry[p];
  const long long plane = (long long)Th * Tw;
  const float* gv = d_samp + (long long)v * L * 4 * hw + pix;
  float* tv = d_tex + (long long)v * L * 4 * plane;

  int limit = L;
  if (n_live) limit = max(0, min(n_live[p], L));
  for (int l = 0; l < limit; ++l) {
    float g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c] = gv[((long long)l * 4 + c) * hw];
    if (g[0] == 0.f && g[1] == 0.f && g[2] == 0.f && g[3] == 0.f) continue;
    const float* s = s_scal + 6 * l;
    const float fx = s[0] * rxv + s[1];
    const float fy = s[2] * ryv + s[3];
    const float x0f = floorf(fx);
    const float y0f = floorf(fy);
    // the forward kernel's bounds, compared in float (NaN fails them all)
    if (!(x0f >= -1.f && x0f <= (float)(Tw - 1) && y0f >= -1.f && y0f <= (float)(Th - 1))) {
      continue;
    }
    const float wx = fx - x0f;
    const float wy = fy - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= Tw - 1;
    const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= Th - 1;
    const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
    const float w10 = wy * (1.f - wx), w11 = wy * wx;
    float* tl = tv + (long long)l * 4 * plane;
    const long long r0 = (long long)y0 * Tw, r1 = r0 + Tw;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* tc = tl + c * plane;
      if (vy0 && vx0) atomicAdd(tc + r0 + x0, w00 * g[c]);
      if (vy0 && vx1) atomicAdd(tc + r0 + x0 + 1, w01 * g[c]);
      if (vy1 && vx0) atomicAdd(tc + r1 + x0, w10 * g[c]);
      if (vy1 && vx1) atomicAdd(tc + r1 + x0 + 1, w11 * g[c]);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: d_samp [V, L, 4, H, W] f32; rx, ry [V, H, W]
// f32; scal [V, L, 6] f32 = (Ax, Bx, Ay, By, dscale, 0); n_live [V, H, W]
// int32 or null; d_tex [V, L, 4, Th, Tw] f32, which the caller has zeroed and
// this kernel adds into.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronize.
extern "C" int gmpi_splat(const float* d_samp, const float* rx, const float* ry,
                          const float* scal, const int* n_live, float* d_tex, int V, int L,
                          int Th, int Tw, int H, int W, void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, V);
  const size_t smem = sizeof(float) * 6 * (size_t)L;
  splat_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      d_samp, rx, ry, scal, n_live, d_tex, L, Th, Tw, H, W);
  return static_cast<int>(cudaGetLastError());
}
