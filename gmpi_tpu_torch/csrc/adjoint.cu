// Texture-space transpose of the bilinear homography warp for Hopper (sm_90a).
//
// Replaces the TPU kernel gmpi_tpu/ops/pallas_warp.py:_adj_kernel (launched
// by warp_adjoint, pallas_warp.py:2167), the texture-space route of the fused
// renderer's backward.
//
// What it computes: the exact transpose of the forward kernel's warp
// (fused_fwd.cu), gathered texel by texel instead of scattered pixel by pixel
// (splat.cu).  For every real texel (u, x) of plane l of view v
//   d_tex[v, l, c, u, x] = sum over pixels (i, j) of
//       max(0, 1 - |fy - u|) * max(0, 1 - |fx - x|) * d_samp[v, l, c, i, j]
//   fx = Ax_l * rx[v, i, j] + Bx_l,  fy = Ay_l * ry[v, i, j] + By_l
// which are the forward's tap weights.  Only real texels exist here, so a tap
// the forward read as zero padding gets no gradient; a NaN coordinate gives
// fmaxf(0, NaN) = 0 and the pixel is skipped.
//
// Bound on an H100 SXM: memory.  d_samp is read once (16 B per live
// pixel-plane pair; dead pairs hold zeros) and d_tex written once, with no
// zero fill: 0.27 GB + 0.27 GB at V=8, L=32, 256^2, ~0.16 ms at 3.35 TB/s.
//
// Design: owner computes.  One thread owns one texel and its four channels,
// visits the pixels of its footprint in a fixed order and writes its sums
// once: no atomics, and the result is bitwise repeatable.  The footprint is
// found from two facts about a pinhole warp with the planes in front of the
// camera: fx does not decrease along an image row and fy does not decrease
// along an image column (each is a Moebius function of the pixel index), and
// the image columns that can touch texel column x start at
// starts[v, l, x] and number at most d_out (planned on the host for the pose
// range, plan_adjoint).  So the thread walks those d_out columns; in each it
// finds the first pixel with fy > u - 1 (bisecting the rows in the first
// column, stepping from the last column's answer after that) and walks down
// while fy < u + 1 (a few pixels).  With scan_cols = 0 the roles of rows and
// columns swap, for pose ranges whose row window is the smaller one.  None of
// the TPU kernel's 16-row strips, diagonal rebase, rolled windows, sentinel
// rows or power-of-two widths carries over.  Neighbouring threads own
// neighbouring texels of a row, so their pixel reads fall in the same few
// lines and are served by L1/L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void adjoint_kernel(const float* __restrict__ d_samp, const float* __restrict__ rx,
                               const float* __restrict__ ry, const float* __restrict__ scal,
                               const int* __restrict__ starts, float* __restrict__ d_tex, int L,
                               int Th, int Tw, int H, int W, int d_out, int scan_cols) {
  const int vl = blockIdx.z;  // view * L + plane
  const int v = vl / L;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int u = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Tw || u >= Th) return;

  const float* s = scal + (long long)vl * 6;
  const long long hw = (long long)H * W;
  const float* g = d_samp + (long long)vl * 4 * hw;
  // "o": the axis whose window is walked; "i": the axis that is bisected
  const float* r_o = (scan_cols ? rx : ry) + (long long)v * hw;
  const float* r_i = (scan_cols ? ry : rx) + (long long)v * hw;
  const float a_o = scan_cols ? s[0] : s[2], b_o = scan_cols ? s[1] : s[3];
  const float a_i = scan_cols ? s[2] : s[0], b_i = scan_cols ? s[3] : s[1];
  const int n_o = scan_cols ? W : H, n_i = scan_cols ? H : W;
  const int s_o = scan_cols ? 1 : W, s_i = scan_cols ? W : 1;
  const float t_o = (float)(scan_cols ? x : u), t_i = (float)(scan_cols ? u : x);
  const int start = starts[(long long)vl * (scan_cols ? Tw : Th) + (scan_cols ? x : u)];
  const int end = min(start + d_out, n_o);
  const float below = t_i - 1.f, above = t_i + 1.f;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int lo = 0;
  for (int o = start; o < end; ++o) {
    const long long base = (long long)o * s_o;
    // lo: the first pixel of this line with f_i > t_i - 1.  Bisected in the
    // window's first line; a neighbouring line's crossing lies a pixel or two
    // from the last one's, so after that lo is stepped from where it stood.
    if (o == start) {
      int hi = n_i;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a_i * r_i[base + (long long)mid * s_i] + b_i > below) hi = mid; else lo = mid + 1;
      }
    } else {
      while (lo > 0 && a_i * r_i[base + (long long)(lo - 1) * s_i] + b_i > below) --lo;
      while (lo < n_i && !(a_i * r_i[base + (long long)lo * s_i] + b_i > below)) ++lo;
    }
    for (int n = lo; n < n_i; ++n) {
      const long long idx = base + (long long)n * s_i;
      const float f_i = a_i * r_i[idx] + b_i;
      if (f_i >= above) break;  // NaN walks on with weight 0
      const float f_o = a_o * r_o[idx] + b_o;
      const float w = fmaxf(0.f, 1.f - fabsf(f_i - t_i)) * fmaxf(0.f, 1.f - fabsf(f_o - t_o));
      if (w > 0.f) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += w * g[c * hw + idx];
      }
    }
  }
  const long long plane = (long long)Th * Tw;
  float* out = d_tex + (long long)vl * 4 * plane + (long long)u * Tw + x;
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c * plane] = acc[c];
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: d_samp [V, L, 4, H, W] f32; rx, ry [V, H, W]
// f32; scal [V, L, 6] f32 = (Ax, Bx, Ay, By, dscale, 0); starts int32
// [V, L, Tw] (scan_cols = 1: first image column of each texel column's window)
// or [V, L, Th] (scan_cols = 0: first image row of each texel row's window);
// d_tex [V, L, 4, Th, Tw] f32, every element of which this kernel writes.
// d_out is the window's length.  V * L must not exceed 65535.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not synchronize.
extern "C" int gmpi_adjoint(const float* d_samp, const float* rx, const float* ry,
                            const float* scal, const int* starts, float* d_tex, int V, int L,
                            int Th, int Tw, int H, int W, int d_out, int scan_cols,
                            void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((Tw + kBlockX - 1) / kBlockX, (Th + kBlockY - 1) / kBlockY, V * L);
  adjoint_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      d_samp, rx, ry, scal, starts, d_tex, L, Th, Tw, H, W, d_out, scan_cols);
  return static_cast<int>(cudaGetLastError());
}
