// Fused MPI warp + over-composite forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gmpi_tpu/ops/pallas_warp.py:_fwd_kernel (launched by
// warp_composite_fwd, pallas_warp.py:901) in both of its forms: inference
// (early-out on transmittance, no residual) and training (the VJP residual
// and the grad-safe "grad" early-out with its live-plane count).
//
// What it computes, per output pixel (v, i, j), front to back over L planes:
//   fx = Ax_l * rx + Bx_l,  fy = Ay_l * ry + By_l          (texel coordinates)
//   s  = bilinear(tex[v, l], fx, fy), zeros outside the texture
//   w  = s.a * T;  color += w * s.rgb;  depth += w * dsc_l * q;
//   disp += w * (1 / dsc_l) * (1 / q);  T *= (1 - s.a) + eps
// and stops once T < 1e-6 (the TPU kernel checks per 16-row strip and group of
// 4 planes; per pixel is finer and differs by at most ~1e-6 x the remaining
// weight).  Outputs are the premultiplied partials color [V,3,H,W],
// depth/disp/trans [V,1,H,W].
//
// Training form.  With `warped` the sample s of every plane the pixel reaches
// is stored as the VJP residual [V,L,4,H,W]; slots of planes it does not reach
// stay unwritten.  early_out = 2 ("grad") replaces the T threshold, which is
// wrong under differentiation (a visible opaque plane's alpha gradient needs
// the planes behind it at O(1), amplified by 1/eps): the pixel carries
//   S = prod(max(1 - a, 0) + eps)  and  M = min(max(1 - a, 0) + eps)
// over the planes so far and stops before plane l once S / M < 1e-7.  S / M is
// the transmittance with its one smallest factor removed, which bounds every
// gradient path out of plane l, the amplified one included.  n_live [V,H,W] is
// the number of planes the pixel processed (the TPU kernel counts per 16-row
// strip, its unit of work; a pixel's count is <= its strip's).
//
// Bound on an H100 SXM: memory.  One view reads its texture stack once,
// L*4*Th*Tw*4 B (101 MB at L=96, 256^2), against ~60 fp32 FLOP per pixel and
// plane (0.38 GFLOP per view): ~30 us at 3.35 TB/s versus ~6 us at 67 TFLOP/s.
// Early-out makes the bytes actually needed data-dependent.
//
// Design: the TPU kernel avoids per-pixel gathers (DMA bands, subtile-flat
// layout, MXU hat-matrix contraction).  On Hopper a per-pixel gather through
// L1/L2 is the natural form: one thread per output pixel, 16x16 blocks, the
// plane loop and all accumulators in registers, the per-view plane affine
// table staged once per block in shared memory, the four taps read straight
// from the unpadded texture with explicit bounds checks.  Neighbouring threads
// read neighbouring texels (the homography is near identity), so the loads
// coalesce.  Layout is the port's public [V, C, H, W].

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr float kEarlyOutT = 1e-6f;
constexpr float kGradTau = 1e-7f;
constexpr int kEarlyOutGrad = 2;

template <bool kWithDisp>
__global__ void fused_fwd_kernel(const float* __restrict__ tex, long long tex_view_stride,
                                 const float* __restrict__ rx, const float* __restrict__ ry,
                                 const float* __restrict__ q, const float* __restrict__ scal,
                                 float* __restrict__ color, float* __restrict__ depth,
                                 float* __restrict__ disp, float* __restrict__ trans,
                                 float* __restrict__ warped, int* __restrict__ n_live,
                                 int L, int Th, int Tw, int H, int W, int early_out,
                                 float eps) {
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
  const long long p = (long long)v * hw + (long long)i * W + j;
  const float rxv = rx[p];
  const float ryv = ry[p];
  const float qv = q[p];
  const float qinv = 1.0f / qv;
  const long long plane = (long long)Th * Tw;
  const float* tv = tex + (long long)v * tex_view_stride;

  const long long pix = (long long)i * W + j;
  float* wv = warped ? warped + (long long)v * L * 4 * hw + pix : nullptr;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, acc_d = 0.f, acc_p = 0.f, t = 1.f;
  float s_clamped = 1.f, m_min = 1.f;  // S and M of the "grad" early-out
  int live = L;
  for (int l = 0; l < L; ++l) {
    if (early_out == kEarlyOutGrad) {
      if (s_clamped / m_min < kGradTau) {
        live = l;
        break;
      }
    } else if (early_out && t < kEarlyOutT) {
      break;
    }
    const float* s = s_scal + 6 * l;
    const float fx = s[0] * rxv + s[1];
    const float fy = s[2] * ryv + s[3];
    const float dsc = s[4];
    const float x0f = floorf(fx);
    const float y0f = floorf(fy);
    const float wx = fx - x0f;
    const float wy = fy - y0f;
    float smp[4] = {0.f, 0.f, 0.f, 0.f};
    // comparisons in float: no int overflow for far-off coordinates, and a
    // NaN coordinate fails them all (zeros)
    if (x0f >= -1.f && x0f <= (float)(Tw - 1) && y0f >= -1.f && y0f <= (float)(Th - 1)) {
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= Tw - 1;
      const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= Th - 1;
      const float* tl = tv + (long long)l * 4 * plane;
      const long long r0 = (long long)y0 * Tw, r1 = r0 + Tw;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* tc = tl + c * plane;
        const float t00 = (vy0 && vx0) ? __ldg(tc + r0 + x0) : 0.f;
        const float t01 = (vy0 && vx1) ? __ldg(tc + r0 + x0 + 1) : 0.f;
        const float t10 = (vy1 && vx0) ? __ldg(tc + r1 + x0) : 0.f;
        const float t11 = (vy1 && vx1) ? __ldg(tc + r1 + x0 + 1) : 0.f;
        const float top = t00 * (1.f - wx) + t01 * wx;
        const float bot = t10 * (1.f - wx) + t11 * wx;
        smp[c] = top * (1.f - wy) + bot * wy;
      }
    }
    if (wv) {
#pragma unroll
      for (int c = 0; c < 4; ++c) wv[((long long)l * 4 + c) * hw] = smp[c];
    }
    const float a = smp[3];
    const float w = a * t;
    c0 += w * smp[0];
    c1 += w * smp[1];
    c2 += w * smp[2];
    acc_d += w * (dsc * qv);
    if (kWithDisp) acc_p += w * ((1.f / dsc) * qinv);
    t *= (1.f - a) + eps;
    if (early_out == kEarlyOutGrad) {
      // clamped, and max() before the sum: (1 - a) + eps may be contracted
      // to (1 + eps) - a, which is exactly 0 at a = 1
      const float one_m = fmaxf(1.f - a, 0.f) + eps;
      s_clamped *= one_m;
      m_min = fminf(m_min, one_m);
    }
  }

  color[((long long)v * 3 + 0) * hw + pix] = c0;
  color[((long long)v * 3 + 1) * hw + pix] = c1;
  color[((long long)v * 3 + 2) * hw + pix] = c2;
  depth[p] = acc_d;
  if (kWithDisp) disp[p] = acc_p;
  trans[p] = t;
  if (n_live) n_live[p] = live;
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device pointers
// of float32 tensors the caller allocated; tex is [*, L, 4, Th, Tw] with view
// v at tex + v * tex_view_stride (0 = one stack shared by every view); rx, ry,
// q are [V, H, W]; scal is [V, L, 6] = (Ax, Bx, Ay, By, dscale, 0); disp may
// be null when with_disp is 0.  early_out: 0 off, 1 on transmittance, 2 the
// grad-safe rule.  warped [V, L, 4, H, W] (residual) and n_live [V, H, W]
// int32 may each be null.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronize.
extern "C" int gmpi_fused_fwd(const float* tex, long long tex_view_stride, const float* rx,
                              const float* ry, const float* q, const float* scal, float* color,
                              float* depth, float* disp, float* trans, float* warped,
                              int* n_live, int V, int L, int Th,
                              int Tw, int H, int W, int early_out, int with_disp, float eps,
                              void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, V);
  const size_t smem = sizeof(float) * 6 * (size_t)L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_disp) {
    fused_fwd_kernel<true><<<grid, block, smem, s>>>(tex, tex_view_stride, rx, ry, q, scal,
                                                     color, depth, disp, trans, warped,
                                                     n_live, L, Th, Tw, H, W, early_out, eps);
  } else {
    fused_fwd_kernel<false><<<grid, block, smem, s>>>(tex, tex_view_stride, rx, ry, q, scal,
                                                      color, depth, disp, trans, warped,
                                                      n_live, L, Th, Tw, H, W, early_out, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
