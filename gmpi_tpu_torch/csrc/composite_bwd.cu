// Backward of the front-to-back over-composite for Hopper (sm_90a).
//
// Replaces the two TPU kernels gmpi_tpu/ops/pallas_warp.py:_composite_bwd_fat_kernel
// (launched by _composite_bwd_fat, pallas_warp.py:2601) and :_composite_bwd_kernel
// (launched by composite_bwd_pallas, pallas_warp.py:2689).  The two compute one
// function and differ only in how they block it for the TPU's VMEM; a thread
// per pixel needs no such blocking, so this one kernel stands for both.
//
// What it computes.  The forward kept the warped per-plane samples
// (r, g, b, a)_l of every pixel (the residual).  With f_l = max(1 - a_l, 0) + eps,
// T_l = prod_{m<l} f_m (exclusive transmittance), w_l = a_l * T_l and
//   e_l = g_color . rgb_l + g_depth * dsc_l * q + g_disp / (dsc_l * q),
// the cotangents on the samples are
//   d rgb_l = w_l * g_color
//   d a_l   = T_l * e_l - (u_l + g_trans * T_total) / f_l,  u_l = sum_{m>l} w_m e_m.
// Planes l >= n_live (never reached by the forward, residual slot unwritten)
// and planes with T_l / M_l < grad_tau (M_l = min_{m<l} f_m: the grad-safe
// occlusion rule, whose every cotangent is bounded by ~grad_tau) get exact
// zeros, written with plain stores and never computed from the slot.
//
// Numerics that matter: f is max(1 - a, 0) + eps, never 1 - a + eps, which a
// compiler may contract to (1 + eps) - a = 0 at a = 1 and then 0 / 0.  u is
// the running sum of the planes behind, added to after use; an inclusive sum
// minus the plane's own term cancels catastrophically behind an opaque plane,
// where the division by f = 1e-10 turns the loss into an O(1) error.  T_l is
// kept from the forward pass over the planes: it cannot be recovered by
// dividing back through an opaque plane.  No fast-math flags.
//
// Bound on an H100 SXM: memory.  The residual of the live (pixel, plane)
// pairs is read once and d_samp written once, 16 B each per pair, against ~25
// FLOP per pair: at V=8, L=32, 256^2 that is 0.54 GB, ~0.16 ms at 3.35 TB/s.
//
// Design: one thread per pixel, two passes over the planes, everything else in
// registers.  Pass 1 runs front to back over the alphas only, finds the count
// of live planes and parks T_l in the alpha slot of d_samp (the same thread
// reads it back, so no scratch tensor and no synchronisation).  Pass 2 runs
// back to front, reads the four samples and T_l, and overwrites the slot.
// Neighbouring threads touch neighbouring addresses in every access.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;

__global__ void composite_bwd_kernel(const float* __restrict__ warped, const float* __restrict__ q,
                                     const float* __restrict__ scal,
                                     const float* __restrict__ g_color,
                                     const float* __restrict__ g_depth,
                                     const float* __restrict__ g_disp,
                                     const float* __restrict__ g_trans,
                                     const int* __restrict__ n_live, float* __restrict__ d_samp,
                                     int L, long long hw, float eps, int use_tau,
                                     float grad_tau) {
  extern __shared__ float s_dsc[];  // [L] dscale of this view
  const int v = blockIdx.y;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_dsc[k] = scal[((long long)v * L + k) * 6 + 4];
  }
  __syncthreads();

  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const long long p = (long long)v * hw + pix;
  const float* wv = warped + (long long)v * L * 4 * hw + pix;
  float* dv = d_samp + (long long)v * L * 4 * hw + pix;

  int limit = L;
  if (n_live) limit = max(0, min(n_live[p], L));

  // pass 1: exclusive transmittance T_l into the alpha slot of d_samp, the
  // count of live planes, and the total transmittance
  float t = 1.f, m = 1.f;
  int live = limit;
  for (int l = 0; l < limit; ++l) {
    if (use_tau && live == limit && t / m < grad_tau) {
      live = l;
      if (!g_trans) break;  // T_total is needed by the g_trans term only
    }
    if (l < live) dv[((long long)l * 4 + 3) * hw] = t;
    const float one_m = fmaxf(1.f - wv[((long long)l * 4 + 3) * hw], 0.f) + eps;
    t *= one_m;
    m = fminf(m, one_m);
  }

  for (int l = L - 1; l >= live; --l) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dv[((long long)l * 4 + c) * hw] = 0.f;
  }
  if (live == 0) return;

  const float qv = q[p];
  const float gc0 = g_color[((long long)v * 3 + 0) * hw + pix];
  const float gc1 = g_color[((long long)v * 3 + 1) * hw + pix];
  const float gc2 = g_color[((long long)v * 3 + 2) * hw + pix];
  const float gd = g_depth ? g_depth[p] : 0.f;
  const float gp = g_disp ? g_disp[p] : 0.f;
  const float qinv = g_disp ? 1.f / qv : 0.f;
  const float gt_term = g_trans ? g_trans[p] * t : 0.f;

  // pass 2: back to front, u = sum of w * e over the planes behind
  float u = 0.f;
  for (int l = live - 1; l >= 0; --l) {
    const long long o = (long long)l * 4 * hw;
    const float r0 = wv[o], r1 = wv[o + hw], r2 = wv[o + 2 * hw], a = wv[o + 3 * hw];
    const float t_excl = dv[o + 3 * hw];
    float e = gc0 * r0 + gc1 * r1 + gc2 * r2;
    if (g_depth) e += gd * (s_dsc[l] * qv);
    if (g_disp) e += gp * ((1.f / s_dsc[l]) * qinv);
    const float one_m = fmaxf(1.f - a, 0.f) + eps;
    const float w = a * t_excl;
    float d_alpha = t_excl * e - u / one_m;
    if (g_trans) d_alpha -= gt_term / one_m;
    dv[o] = w * gc0;
    dv[o + hw] = w * gc1;
    dv[o + 2 * hw] = w * gc2;
    dv[o + 3 * hw] = d_alpha;
    u += w * e;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: warped and d_samp [V, L, 4, H, W] f32; q,
// g_depth, g_disp, g_trans [V, H, W] f32 (the three cotangents may each be
// null); g_color [V, 3, H, W] f32; scal [V, L, 6] f32; n_live [V, H, W] int32
// or null.  use_tau = 0 turns the grad_tau rule off.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronize.
extern "C" int gmpi_composite_bwd(const float* warped, const float* q, const float* scal,
                                  const float* g_color, const float* g_depth,
                                  const float* g_disp, const float* g_trans, const int* n_live,
                                  float* d_samp, int V, int L, int H, int W, float eps,
                                  int use_tau, float grad_tau, void* stream) {
  const long long hw = (long long)H * W;
  const dim3 block(kBlock, 1, 1);
  const dim3 grid((unsigned)((hw + kBlock - 1) / kBlock), V, 1);
  const size_t smem = sizeof(float) * (size_t)L;
  composite_bwd_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      warped, q, scal, g_color, g_depth, g_disp, g_trans, n_live, d_samp, L, hw, eps, use_tau,
      grad_tau);
  return static_cast<int>(cudaGetLastError());
}
