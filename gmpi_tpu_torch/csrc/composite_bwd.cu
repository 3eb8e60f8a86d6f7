// Backward of the front-to-back over-composite for Hopper (sm_90a).
//
// Replaces the two TPU kernels gmpi_tpu/ops/pallas_warp.py:_composite_bwd_fat_kernel
// (launched by _composite_bwd_fat, pallas_warp.py:2601) and :_composite_bwd_kernel
// (launched by composite_bwd_pallas, pallas_warp.py:2689).  The two compute one
// function and differ only in how they block it for the TPU's VMEM; a thread
// that owns its pixels needs no such blocking, so this one kernel stands for both.
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
// a product taken front to back: it cannot be recovered by dividing back
// through an opaque plane, so it is rebuilt forward (below).  No fast-math
// flags.
//
// Bound on an H100 SXM: memory.  The residual of the live (pixel, plane)
// pairs is read once and d_samp written once, 16 B each per pair, against ~25
// FLOP per pair: at V=8, L=32, 256^2 that is 0.54 GB, ~0.16 ms at 3.35 TB/s.
// What held a thread-per-pixel kernel at half of that: it parked T_l in
// d_samp's alpha slot in pass 1 and read it back in pass 2 (~44 B per pair
// moved, not 32), and each of its loads sat behind the data-dependent live
// test of its plane, so about one load per thread was in flight: too few
// bytes per SM to cover device-memory latency.
//
// Design: two pixels a thread (8-byte loads and stores where H*W and the
// addresses allow, else scalar), planes in chunks of kG whose loads are all
// issued before the chunk's serial product.
//  1. Pass 1, front to back over the alphas: the live count (n_live, the
//     grad_tau cut on T/M), the total transmittance, and a checkpoint of T at
//     every S-th plane in shared memory (S a multiple of kG, the smallest that
//     keeps a pixel's checkpoints within kSlots, so any L <= 2048 fits).
//  2. Pass 2, back to front, chunk by chunk: load the chunk's four samples,
//     take T at the chunk's first plane from its checkpoint (for S > kG,
//     multiplied forward from the checkpoint through the planes before the
//     chunk), rebuild T_l over the chunk with the same products in the same
//     order as pass 1, so it is bitwise what pass 1 computed, then run the
//     chunk back to front.
//  3. Slots at and beyond a pixel's live count get zeros; beyond both pixels'
//     as 8-byte stores.
// No scratch round trip: 4 B of alpha in pass 1 (its reread in pass 2 mostly
// hits L1 or L2), 16 B read and 16 B written per live pair.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kG = 4;         // planes of a chunk
constexpr int kSlots = 32;    // transmittance checkpoints a pixel, in shared memory
constexpr int kPix = 2;       // pixels a thread
constexpr int kThreads = 128;
constexpr int kBlockPix = kThreads * kPix;

struct Args {
  const float* warped;
  const float* q;
  const float* scal;
  const float* g_color;
  const float* g_depth;
  const float* g_disp;
  const float* g_trans;
  const int* n_live;
  float* d_samp;
  int L;
  int S;  // planes between checkpoints (a multiple of kG)
  long long hw;
  float eps;
  int use_tau;
  float grad_tau;
};

// The two pixels' values of one [.., H, W] field at element `off` of it (the
// first pixel's); n = 2, or 1 for a last odd pixel.
template <bool VEC>
__device__ __forceinline__ void load2(const float* p, long long off, int n, float (&out)[kPix]) {
  if (VEC) {
    const float2 x = *reinterpret_cast<const float2*>(p + off);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = p[off];
    out[1] = n > 1 ? p[off + 1] : 0.f;
  }
}

// Plane slot `off` of the two pixels where need0 / need1.  The 8-byte form
// reads both slots when either is needed: a slot read and not needed is never
// used.
template <bool VEC>
__device__ __forceinline__ void load_slot(const float* p, long long off, bool need0, bool need1,
                                          float (&out)[kPix]) {
  if (VEC) {
    float2 x = make_float2(0.f, 0.f);
    if (need0 || need1) x = *reinterpret_cast<const float2*>(p + off);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = need0 ? p[off] : 0.f;
    out[1] = need1 ? p[off + 1] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store2(float* p, long long off, int n, float a, float b) {
  if (VEC) {
    *reinterpret_cast<float2*>(p + off) = make_float2(a, b);
  } else {
    p[off] = a;
    if (n > 1) p[off + 1] = b;
  }
}

__device__ __forceinline__ float factor(float a, float eps) { return fmaxf(1.f - a, 0.f) + eps; }

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* s_dsc = smem;                         // [L] dscale of this view
  float* s_ck = smem + ((a.L + 3) & ~3);       // [slots][kBlockPix] checkpoints of T
  const int v = blockIdx.y;
  const int L = a.L;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    s_dsc[k] = a.scal[((long long)v * L + k) * 6 + 4];
  }
  __syncthreads();

  const long long hw = a.hw;
  const long long pix = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (pix >= hw) return;
  const int n = hw - pix >= kPix ? kPix : (int)(hw - pix);
  const long long p = (long long)v * hw + pix;
  const float* wv = a.warped + (long long)v * L * 4 * hw + pix;
  float* dv = a.d_samp + (long long)v * L * 4 * hw + pix;
  float* ck = s_ck + threadIdx.x * kPix;       // slot k of pixel j: ck[k * kBlockPix + j]
  const int S = a.S;

  int limit[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    limit[j] = j < n ? L : 0;
    if (a.n_live && j < n) limit[j] = max(0, min(a.n_live[p + j], L));
  }

  // -- pass 1: live counts, total transmittance, checkpoints of T --------------
  float t[kPix], m[kPix];
  int live[kPix];
  bool run[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    t[j] = 1.f;
    m[j] = 1.f;
    live[j] = limit[j];
    run[j] = limit[j] > 0;
  }
  const int limit_max = max(limit[0], limit[1]);
  for (int c0 = 0; c0 < limit_max && (run[0] || run[1]); c0 += kG) {
    float al[kG][kPix];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int l = c0 + g;
      load_slot<VEC>(wv, ((long long)l * 4 + 3) * hw, run[0] && l < limit[0],
                     run[1] && l < limit[1], al[g]);
    }
    if (c0 % S == 0) {
#pragma unroll
      for (int j = 0; j < kPix; ++j) ck[(c0 / S) * kBlockPix + j] = t[j];
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int l = c0 + g;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (!run[j]) continue;
        if (l >= limit[j]) {
          run[j] = false;
          continue;
        }
        if (a.use_tau && live[j] == limit[j] && t[j] / m[j] < a.grad_tau) {
          live[j] = l;
          if (!a.g_trans) {  // T_total is needed by the g_trans term only
            run[j] = false;
            continue;
          }
        }
        const float one_m = factor(al[g][j], a.eps);
        t[j] *= one_m;
        m[j] = fminf(m[j], one_m);
      }
    }
  }

  const int live_max = max(live[0], live[1]);
  for (int l = live_max; l < L; ++l) {
#pragma unroll
    for (int c = 0; c < 4; ++c) store2<VEC>(dv, ((long long)l * 4 + c) * hw, n, 0.f, 0.f);
  }
  if (live_max == 0) return;

  float qv[kPix], gc0[kPix], gc1[kPix], gc2[kPix], gd[kPix], gp[kPix], gt[kPix];
  load2<VEC>(a.q, p, n, qv);
  load2<VEC>(a.g_color, (long long)v * 3 * hw + pix, n, gc0);
  load2<VEC>(a.g_color, ((long long)v * 3 + 1) * hw + pix, n, gc1);
  load2<VEC>(a.g_color, ((long long)v * 3 + 2) * hw + pix, n, gc2);
  float qinv[kPix], gt_term[kPix], u[kPix];
  if (a.g_depth) load2<VEC>(a.g_depth, p, n, gd);
  if (a.g_disp) load2<VEC>(a.g_disp, p, n, gp);
  if (a.g_trans) load2<VEC>(a.g_trans, p, n, gt);
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    qinv[j] = a.g_disp ? 1.f / qv[j] : 0.f;
    gt_term[j] = a.g_trans ? gt[j] * t[j] : 0.f;
    u[j] = 0.f;
  }

  // -- pass 2: back to front, chunk by chunk -----------------------------------
  for (int c0 = (live_max - 1) / kG * kG; c0 >= 0; c0 -= kG) {
    float r[kG][4][kPix];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int l = c0 + g;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        load_slot<VEC>(wv, ((long long)l * 4 + c) * hw, l < live[0], l < live[1], r[g][c]);
      }
    }
    // T at the chunk's first plane: its checkpoint, then forward through the
    // planes between (S > kG only), in pass 1's order
    const int k0 = c0 / S;
    float tc[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) tc[j] = ck[k0 * kBlockPix + j];
    for (int b0 = k0 * S; b0 < c0; b0 += kG) {
      float al[kG][kPix];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        load_slot<VEC>(wv, ((long long)(b0 + g) * 4 + 3) * hw, b0 + g < live[0],
                       b0 + g < live[1], al[g]);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          if (b0 + g < live[j]) tc[j] *= factor(al[g][j], a.eps);
        }
      }
    }
    float tl[kG][kPix];  // exclusive transmittance of the chunk's planes
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        tl[g][j] = tc[j];
        if (c0 + g < live[j]) tc[j] *= factor(r[g][3][j], a.eps);
      }
    }
#pragma unroll
    for (int g = kG - 1; g >= 0; --g) {
      const int l = c0 + g;
      if (l >= live_max) continue;
      float out[4][kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (l < live[j]) {
          float e = gc0[j] * r[g][0][j] + gc1[j] * r[g][1][j] + gc2[j] * r[g][2][j];
          if (a.g_depth) e += gd[j] * (s_dsc[l] * qv[j]);
          if (a.g_disp) e += gp[j] * ((1.f / s_dsc[l]) * qinv[j]);
          const float one_m = factor(r[g][3][j], a.eps);
          const float w = r[g][3][j] * tl[g][j];
          float d_alpha = tl[g][j] * e - u[j] / one_m;
          if (a.g_trans) d_alpha -= gt_term[j] / one_m;
          out[0][j] = w * gc0[j];
          out[1][j] = w * gc1[j];
          out[2][j] = w * gc2[j];
          out[3][j] = d_alpha;
          u[j] += w * e;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) out[c][j] = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        store2<VEC>(dv, ((long long)l * 4 + c) * hw, n, out[c][0], out[c][1]);
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: warped and d_samp [V, L, 4, H, W] f32; q,
// g_depth, g_disp, g_trans [V, H, W] f32 (the three cotangents may each be
// null); g_color [V, 3, H, W] f32; scal [V, L, 6] f32; n_live [V, H, W] int32
// or null.  use_tau = 0 turns the grad_tau rule off.  L is 1..2048.  Launches
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronize.
extern "C" int gmpi_composite_bwd(const float* warped, const float* q, const float* scal,
                                  const float* g_color, const float* g_depth,
                                  const float* g_disp, const float* g_trans, const int* n_live,
                                  float* d_samp, int V, int L, int H, int W, float eps,
                                  int use_tau, float grad_tau, void* stream) {
  if (L < 1 || L > 2048) return static_cast<int>(cudaErrorInvalidValue);
  const long long hw = (long long)H * W;
  const int chunks = (L + kG - 1) / kG;
  const int S = kG * ((chunks + kSlots - 1) / kSlots);
  const int slots = (L + S - 1) / S;
  const auto aligned = [](const void* p) { return p == nullptr || (reinterpret_cast<size_t>(p) & 7u) == 0; };
  const bool vec = hw % 2 == 0 && aligned(warped) && aligned(d_samp) && aligned(q)
                   && aligned(g_color) && aligned(g_depth) && aligned(g_disp) && aligned(g_trans)
                   && aligned(n_live);
  const Args a{warped, q, scal, g_color, g_depth, g_disp, g_trans, n_live, d_samp, L, S, hw,
               eps, use_tau, grad_tau};
  const dim3 grid((unsigned)((hw + kBlockPix - 1) / kBlockPix), V, 1);
  const size_t smem = sizeof(float) * ((size_t)((L + 3) & ~3) + (size_t)slots * kBlockPix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    composite_bwd_kernel<true><<<grid, kThreads, smem, s>>>(a);
  } else {
    composite_bwd_kernel<false><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
