// Fused MPI warp + over-composite forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gmpi_tpu/ops/pallas_warp.py:_fwd_kernel (launched by
// warp_composite_fwd, pallas_warp.py:901) in both of its forms: inference
// (early-out on transmittance, no residual) and training (the VJP residual
// and the grad-safe "grad" early-out with its live-plane count).
//
// What it computes, per output pixel (v, i, j), front to back over L planes:
//   fx = Ax_l * rx + Bx_l,  fy = Ay_l * ry + By_l          (texel coordinates)
//   s  = bilinear(tex[v / k, l], fx, fy), zeros outside the texture
//   w  = s.a * T;  color += w * s.rgb;  depth += w * dsc_l * q;
//   disp += w * (1 / dsc_l) * (1 / q);  T *= (1 - s.a) + eps
// and stops once T < 1e-6 (the TPU kernel checks per 16-row strip and group of
// 4 planes; per pixel is finer and differs by at most ~1e-6 x the remaining
// weight).  Outputs are the premultiplied partials color [V,3,H,W],
// depth/disp/trans [V,1,H,W].  Views come in groups of k that read one texture
// stack: view v reads stack v / k (k = V: one stack for every view; k = 1: a
// stack per view).
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
// Bound on an H100 SXM: memory.  A stack is read once for all the views of its
// group, L*4*Th*Tw*4 B (101 MB at L=96, 256^2), against ~60 fp32 FLOP per
// pixel and plane: ~30 us at 3.35 TB/s versus ~6 us per view at 67 TFLOP/s.
// Early-out makes the bytes actually needed data-dependent.  What holds a
// thread-per-pixel gather from device memory far above that bound is latency
// and instruction count: 16 scalar loads per plane, each behind a bounds
// test, and a plane loop whose early-out test makes plane l + 1's loads wait
// for plane l's.
//
// Design: a block owns a tile of 32 x 8 pixels of one view.  From the tile's extreme ray coordinates (a block reduction, so any
// ray field is served, and a NaN ray is left out) it computes, for every
// plane, the box of texels its taps can touch, the texture's one-texel
// surround included.  Planes go through in groups of 2: the four channel
// tiles of each plane's box are copied into shared memory with cp.async (16
// bytes a thread where the texture width and the pointers allow, 4 bytes
// otherwise; the surround is filled with zeros), two stages of 24 KB, so
// group g + 1 is in flight while group g is composited from shared memory:
// four blocks fit a multiprocessor.  A pixel first takes the samples of the
// whole group (taps without bounds tests, all loads in flight together),
// then composites them plane by plane under the per-pixel rules above, in
// the order of the arithmetic given above, so values and n_live do not depend
// on the tiling.  Staging stops once every pixel of the block is done
// (__syncthreads_and), so the bytes that early-out saves stay saved.  A plane
// whose box exceeds the staging tile (large shear, a texture much larger than
// the image) is sampled straight from device memory, with bounds tests, by
// that block (sample_direct): correct for every pose.
// The grid runs view by view: putting the views of one stack next to each
// other in launch order was measured and changed nothing (the views of a
// stack run close enough in time for the 50 MB L2 to serve the later ones).
//
// bf16 textures (the TPU kernel's compute_dtype=bfloat16, pallas_warp.py:683-741).
// The kernel is a template on the texel type; the bf16 form is the same design
// with half the bytes: a staged box holds bf16 (a 16-byte cp.async moves 8
// texels, so a box's x origin is a multiple of 8; without 16-byte alignment each
// texel is copied by a plain load), texels are widened with __bfloat162float at
// the tap, and the arithmetic is the TPU kernel's under its bf16x3 contraction:
// the x-hats are computed in fp32 and rounded to bf16 (the coordinates never
// are), hx0 = bf16(1 - wx) and hx1 = bf16(1 - (1 - wx)) as 1 - |fx - i| gives
// them, so each x product of two bf16 values is exact in fp32; the y-hats stay
// fp32, hy0 = 1 - wy and hy1 = 1 - hy0, and the y contraction is rounded product
// by product (no FMA), as the plain version computes it.  Outputs, residual and
// composite are fp32 as in the fp32 form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;   // pixels of a block's tile along a row (= one warp)
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kBoxW = 48;    // staged texels per box row (a multiple of 8)
constexpr int kBoxH = 16;
constexpr int kGroup = 2;    // planes staged together
constexpr int kStages = 2;
constexpr int kChan = kBoxW * kBoxH;                 // texels of one channel tile
constexpr int kStageElems = kGroup * 4 * kChan;      // 6,144 texels: 24 KB (fp32) a stage
constexpr float kEarlyOutT = 1e-6f;
constexpr float kGradTau = 1e-7f;
constexpr int kEarlyOutGrad = 2;
enum BoxMode { kEmpty = 0, kStaged = 1, kDirect = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One texel into shared memory where 16-byte copies do not apply: a 4-byte
// cp.async for fp32; a plain load and store for bf16 (2 bytes, below
// cp.async's least size).
__device__ __forceinline__ void copy_texel(float* smem, const float* gmem) { cp_async4(smem, gmem); }
__device__ __forceinline__ void copy_texel(__nv_bfloat16* smem, const __nv_bfloat16* gmem) {
  *smem = __ldg(gmem);
}

// Texel types: a texel widened to fp32, read through the read-only cache or
// from shared memory.
__device__ __forceinline__ float widen(float t) { return t; }
__device__ __forceinline__ float widen(__nv_bfloat16 t) { return __bfloat162float(t); }
__device__ __forceinline__ float ldg_texel(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_texel(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The bilinear weights of one tap box and their combine, by texel type.  fp32:
// (1 - wx, wx), (1 - wy, wy), contracted freely.  bf16: the TPU kernel's bf16
// hats (see the header).
template <typename T>
struct Lerp {
  float hx0, hx1, hy0, hy1;
  __device__ __forceinline__ Lerp(float wx, float wy)
      : hx0(1.f - wx), hx1(wx), hy0(1.f - wy), hy1(wy) {}
  __device__ __forceinline__ float operator()(float t00, float t01, float t10, float t11) const {
    const float top = t00 * hx0 + t01 * hx1;
    const float bot = t10 * hx0 + t11 * hx1;
    return top * hy0 + bot * hy1;
  }
};

template <>
struct Lerp<__nv_bfloat16> {
  float hx0, hx1, hy0, hy1;
  __device__ __forceinline__ Lerp(float wx, float wy) {
    const float r = 1.f - wx;
    hx0 = __bfloat162float(__float2bfloat16_rn(r));
    hx1 = __bfloat162float(__float2bfloat16_rn(1.f - r));
    hy0 = 1.f - wy;
    hy1 = 1.f - hy0;
  }
  __device__ __forceinline__ float operator()(float t00, float t01, float t10, float t11) const {
    // x products are exact (bf16 x bf16); every rounding as the plain version's
    const float top = __fadd_rn(__fmul_rn(t00, hx0), __fmul_rn(t01, hx1));
    const float bot = __fadd_rn(__fmul_rn(t10, hx0), __fmul_rn(t11, hx1));
    return __fadd_rn(__fmul_rn(top, hy0), __fmul_rn(bot, hy1));
  }
};

// The four channels of the bilinear sample at (fx, fy) of a plane in device
// memory whose real texels are [0, Tw) x [0, Th): zeros outside.  Comparisons
// in float: no int overflow for far-off coordinates, and a NaN coordinate
// fails them all (zeros).
template <typename T>
__device__ __forceinline__ void sample_direct(const T* __restrict__ tl, long long plane,
                                              int Th, int Tw, float fx, float fy, float smp[4]) {
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  smp[0] = smp[1] = smp[2] = smp[3] = 0.f;
  if (x0f >= -1.f && x0f <= (float)(Tw - 1) && y0f >= -1.f && y0f <= (float)(Th - 1)) {
    const Lerp<T> lerp(fx - x0f, fy - y0f);
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= Tw - 1;
    const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= Th - 1;
    const long long r0 = (long long)y0 * Tw, r1 = r0 + Tw;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T* tc = tl + c * plane;
      const float t00 = (vy0 && vx0) ? ldg_texel(tc + r0 + x0) : 0.f;
      const float t01 = (vy0 && vx1) ? ldg_texel(tc + r0 + x0 + 1) : 0.f;
      const float t10 = (vy1 && vx0) ? ldg_texel(tc + r1 + x0) : 0.f;
      const float t11 = (vy1 && vx1) ? ldg_texel(tc + r1 + x0 + 1) : 0.f;
      smp[c] = lerp(t00, t01, t10, t11);
    }
  }
}

// One pixel's running state and the composite of one plane's sample.
struct Pixel {
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, acc_d = 0.f, acc_p = 0.f, t = 1.f;
  float s_clamped = 1.f, m_min = 1.f;  // S and M of the "grad" early-out
  int live;
  bool done = false;
};

// True once the pixel stops before plane l (and records where).
__device__ __forceinline__ bool stops_before(Pixel& px, int l, int early_out) {
  if (early_out == kEarlyOutGrad) {
    if (px.s_clamped / px.m_min < kGradTau) {
      px.live = l;
      return true;
    }
  } else if (early_out && px.t < kEarlyOutT) {
    return true;
  }
  return false;
}

template <bool kWithDisp>
__device__ __forceinline__ void composite(Pixel& px, const float smp[4], float dsc,
                                          float dsc_inv, float qv, float qinv, int early_out,
                                          float eps) {
  const float a = smp[3];
  const float w = a * px.t;
  px.c0 += w * smp[0];
  px.c1 += w * smp[1];
  px.c2 += w * smp[2];
  px.acc_d += w * (dsc * qv);
  if (kWithDisp) px.acc_p += w * (dsc_inv * qinv);
  px.t *= (1.f - a) + eps;
  if (early_out == kEarlyOutGrad) {
    // clamped, and max() before the sum: (1 - a) + eps may be contracted
    // to (1 + eps) - a, which is exactly 0 at a = 1
    const float one_m = fmaxf(1.f - a, 0.f) + eps;
    px.s_clamped *= one_m;
    px.m_min = fminf(px.m_min, one_m);
  }
}

template <typename T>
struct Args {
  const T* tex;
  long long stack_stride;  // texels between the stacks of two groups of views
  const float* rx;
  const float* ry;
  const float* q;
  const float* scal;
  float* color;
  float* depth;
  float* disp;
  float* trans;
  float* warped;
  int* n_live;
  int L, Th, Tw, H, W, views_per_stack, early_out, vec;
  float eps;
};

template <typename T, bool kWithDisp>
__device__ __forceinline__ void store_pixel(const Args<T>& a, const Pixel& px, int v,
                                            long long pix) {
  const long long hw = (long long)a.H * a.W;
  const long long p = (long long)v * hw + pix;
  a.color[((long long)v * 3 + 0) * hw + pix] = px.c0;
  a.color[((long long)v * 3 + 1) * hw + pix] = px.c1;
  a.color[((long long)v * 3 + 2) * hw + pix] = px.c2;
  a.depth[p] = px.acc_d;
  if (kWithDisp) a.disp[p] = px.acc_p;
  a.trans[p] = px.t;
  if (a.n_live) a.n_live[p] = px.live;
}

// The bilinear sample from a staged box whose texel (by0, bx0) is tile[0]: the
// box holds every tap of every pixel of the block, real texels copied and the
// texture's one-texel surround zero-filled, so the four taps are read without
// bounds tests.  The pixel-level test is sample_direct's.
template <typename T>
__device__ __forceinline__ void sample_staged(const T* __restrict__ tile, int by0, int bx0,
                                              int Th, int Tw, float fx, float fy, float smp[4]) {
  const float x0f = floorf(fx);
  const float y0f = floorf(fy);
  smp[0] = smp[1] = smp[2] = smp[3] = 0.f;
  if (x0f >= -1.f && x0f <= (float)(Tw - 1) && y0f >= -1.f && y0f <= (float)(Th - 1)) {
    const Lerp<T> lerp(fx - x0f, fy - y0f);
    const T* t = tile + ((int)y0f - by0) * kBoxW + ((int)x0f - bx0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T* tc = t + c * kChan;
      smp[c] = lerp(widen(tc[0]), widen(tc[1]), widen(tc[kBoxW]), widen(tc[kBoxW + 1]));
    }
  }
}

template <typename T, bool kWithDisp>
__global__ void __launch_bounds__(kThreads) fused_fwd_kernel(const Args<T> a) {
  // [L, 6] plane table (slot 5: 1 / dscale) | [L] boxes (x0, y0, w | h << 16,
  // mode) | kStages x kGroup x 4 channel tiles
  extern __shared__ __align__(16) float s_mem[];
  __shared__ float s_red[kThreads / 32][4];
  const int L = a.L;
  float* s_scal = s_mem;
  int4* s_box = reinterpret_cast<int4*>(s_mem + ((6 * L + 3) & ~3));
  T* s_tiles = reinterpret_cast<T*>(s_box + L);
  constexpr int kVec = 16 / sizeof(T);  // texels of one 16-byte copy

  const int v = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < L * 6; k += kThreads) {
    const float* row = a.scal + (long long)v * L * 6 + (k / 6) * 6;
    s_scal[k] = k % 6 == 5 ? 1.f / row[4] : row[k % 6];
  }

  const int j = tx * kTileW + lane;
  const int i = ty * kTileH + warp;
  const bool inside = i < a.H && j < a.W;
  const long long hw = (long long)a.H * a.W;
  const long long pix = (long long)i * a.W + j;
  const long long p = (long long)v * hw + pix;
  const float rxv = inside ? a.rx[p] : 0.f, ryv = inside ? a.ry[p] : 0.f;
  const float qv = inside ? a.q[p] : 1.f;
  const float qinv = 1.0f / qv;
  const long long plane = (long long)a.Th * a.Tw;
  const T* tv = a.tex + (long long)(v / a.views_per_stack) * a.stack_stride;
  float* wv = a.warped ? a.warped + (long long)v * L * 4 * hw + pix : nullptr;

  // the tile's extreme ray coordinates; fminf / fmaxf drop a NaN
  {
    const float inf = __int_as_float(0x7f800000);
    float lo_x = inside ? fminf(rxv, inf) : inf, hi_x = inside ? fmaxf(rxv, -inf) : -inf;
    float lo_y = inside ? fminf(ryv, inf) : inf, hi_y = inside ? fmaxf(ryv, -inf) : -inf;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo_x = fminf(lo_x, __shfl_xor_sync(0xffffffffu, lo_x, d));
      hi_x = fmaxf(hi_x, __shfl_xor_sync(0xffffffffu, hi_x, d));
      lo_y = fminf(lo_y, __shfl_xor_sync(0xffffffffu, lo_y, d));
      hi_y = fmaxf(hi_y, __shfl_xor_sync(0xffffffffu, hi_y, d));
    }
    if (lane == 0) {
      s_red[warp][0] = lo_x;
      s_red[warp][1] = hi_x;
      s_red[warp][2] = lo_y;
      s_red[warp][3] = hi_y;
    }
  }
  __syncthreads();
  {
    float lo_x = s_red[0][0], hi_x = s_red[0][1], lo_y = s_red[0][2], hi_y = s_red[0][3];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      lo_x = fminf(lo_x, s_red[w][0]);
      hi_x = fmaxf(hi_x, s_red[w][1]);
      lo_y = fminf(lo_y, s_red[w][2]);
      hi_y = fmaxf(hi_y, s_red[w][3]);
    }
    // every plane's texel box: what a tap of this tile can touch of the
    // texture and its one-texel surround, [-1, Tw] x [-1, Th]
    for (int l = tid; l < L; l += kThreads) {
      const float* s = s_scal + 6 * l;
      int4 box = make_int4(0, 0, 0, kEmpty);
      if (lo_x <= hi_x && lo_y <= hi_y) {  // the tile holds a ray that is not NaN
        const float fa = __fmaf_rn(s[0], lo_x, s[1]), fb = __fmaf_rn(s[0], hi_x, s[1]);
        const float ga = __fmaf_rn(s[2], lo_y, s[3]), gb = __fmaf_rn(s[2], hi_y, s[3]);
        // clamped in float (far-off and NaN coordinates), then converted
        const float xa = fmaxf(floorf(fminf(fa, fb)), -1.f);
        const float xb = fminf(floorf(fmaxf(fa, fb)) + 1.f, (float)a.Tw);
        const float ya = fmaxf(floorf(fminf(ga, gb)), -1.f);
        const float yb = fminf(floorf(fmaxf(ga, gb)) + 1.f, (float)a.Th);
        if (xa < xb && ya < yb) {  // else no pixel's taps reach [-1, Tw] x [-1, Th]
          int x0 = (int)xa, w = (int)xb - x0 + 1;
          const int y0 = (int)ya, h = (int)yb - y0 + 1;
          if (a.vec) {  // 16-byte copies: whole groups of kVec texels, from -kVec on
            const int lead = (x0 + kVec) & (kVec - 1);
            x0 -= lead;
            w = (w + lead + kVec - 1) & ~(kVec - 1);
          }
          box = (w <= kBoxW && h <= kBoxH) ? make_int4(x0, y0, w | (h << 16), kStaged)
                                           : make_int4(0, 0, 0, kDirect);
        }
      }
      s_box[l] = box;
    }
  }
  __syncthreads();

  // Copies of group g into its stage.  A thread keeps one slot (row, column
  // or group of kVec columns) of every channel tile, so the index arithmetic
  // is per plane, not per copy.
  const int n_groups = (L + kGroup - 1) / kGroup;
  const int per_row = a.vec ? kBoxW / kVec : kBoxW;
  auto start_copies = [&](int g) {
    T* dst = s_tiles + (g % kStages) * kStageElems;
    for (int slot = tid; slot < kBoxH * per_row; slot += kThreads) {
      const int r = slot / per_row, col = (slot % per_row) * (a.vec ? kVec : 1);
#pragma unroll
      for (int pl = 0; pl < kGroup; ++pl) {
        const int l = g * kGroup + pl;
        if (l >= L) break;
        const int4 box = s_box[l];
        if (box.w != kStaged || r >= (box.z >> 16) || col >= (box.z & 0xffff)) continue;
        const int y = box.y + r, x = box.x + col;
        T* d = dst + pl * 4 * kChan + r * kBoxW + col;
        if (y >= 0 && y < a.Th && x >= 0 && x < a.Tw) {
          const T* src = tv + (long long)l * 4 * plane + (y * a.Tw + x);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (a.vec) cp_async16(d + c * kChan, src + c * plane);
            else copy_texel(d + c * kChan, src + c * plane);
          }
        } else {  // the surround reads as zeros
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (a.vec) *reinterpret_cast<float4*>(d + c * kChan) = make_float4(0.f, 0.f, 0.f, 0.f);
            else d[c * kChan] = T(0.f);
          }
        }
      }
    }
  };

  Pixel px;
  px.live = L;
  px.done = !inside;
  start_copies(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 1
  for (int g = 0; g < n_groups; ++g) {
    if (g + 1 < n_groups) start_copies(g + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // may be empty
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // group g has landed
    __syncthreads();
    if (!px.done) {
      const T* tiles = s_tiles + (g % kStages) * kStageElems;
      const int l0 = g * kGroup;
      // the group's samples first: they do not depend on the composite, so
      // their loads are all in flight together
      float smp[kGroup][4];
#pragma unroll
      for (int pl = 0; pl < kGroup; ++pl) {
        const int l = l0 + pl;
        if (l >= L) break;
        const float* s = s_scal + 6 * l;
        const int4 box = s_box[l];
        const float fx = __fmaf_rn(s[0], rxv, s[1]), fy = __fmaf_rn(s[2], ryv, s[3]);
        if (box.w == kStaged) {
          sample_staged(tiles + pl * 4 * kChan, box.y, box.x, a.Th, a.Tw, fx, fy, smp[pl]);
        } else if (box.w == kDirect) {
          sample_direct(tv + (long long)l * 4 * plane, plane, a.Th, a.Tw, fx, fy, smp[pl]);
        } else {
          smp[pl][0] = smp[pl][1] = smp[pl][2] = smp[pl][3] = 0.f;  // nothing under this tile
        }
      }
      // then the composite, plane by plane, under the per-pixel rules
#pragma unroll
      for (int pl = 0; pl < kGroup; ++pl) {
        const int l = l0 + pl;
        if (l >= L) break;
        if (stops_before(px, l, a.early_out)) {
          px.done = true;
          break;
        }
        if (wv) {
#pragma unroll
          for (int c = 0; c < 4; ++c) wv[((long long)l * 4 + c) * hw] = smp[pl][c];
        }
        const float* s = s_scal + 6 * l;
        composite<kWithDisp>(px, smp[pl], s[4], s[5], qv, qinv, a.early_out, a.eps);
      }
    }
    // every pixel of the block done: stage nothing more.  (The barrier also
    // keeps group g + 2's copies off this stage until all have read it.)
    if (__syncthreads_and(px.done)) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (inside) store_pixel<T, kWithDisp>(a, px, v, pix);
}

template <typename T>
int launch(const T* tex, long long stack_stride, const float* rx, const float* ry,
           const float* q, const float* scal, float* color, float* depth, float* disp,
           float* trans, float* warped, int* n_live, int V, int L, int Th, int Tw, int H, int W,
           int views_per_stack, int early_out, int with_disp, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = Tw % kVec == 0 && (reinterpret_cast<size_t>(tex) & 15u) == 0
                  && stack_stride % kVec == 0;
  const Args<T> a{tex, stack_stride, rx, ry, q, scal, color, depth, disp, trans, warped, n_live,
                  L, Th, Tw, H, W, views_per_stack, early_out, vec, eps};
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, V);
  const size_t smem = sizeof(float) * (size_t)((6 * L + 3) & ~3) + sizeof(int4) * (size_t)L
                      + sizeof(T) * kStages * kStageElems;
  auto kernel = with_disp ? fused_fwd_kernel<T, true> : fused_fwd_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device pointers
// of tensors the caller allocated: float32, except tex, which is bfloat16 when
// tex_bf16 is 1 and float32 when it is 0.  tex holds V / views_per_stack
// stacks [L, 4, Th, Tw], stack s at tex + s * stack_stride (in texels), read by
// the views s * views_per_stack ... (s + 1) * views_per_stack - 1 (V must be a
// multiple of views_per_stack); rx, ry, q are [V, H, W]; scal is [V, L, 6] =
// (Ax, Bx, Ay, By, dscale, 0); disp may be null when with_disp is 0.
// early_out: 0 off, 1 on transmittance, 2 the grad-safe rule.  warped [V, L, 4,
// H, W] (residual) and n_live [V, H, W] int32 may each be null.  Launches on
// `stream` and returns the first error of cudaFuncSetAttribute (the kernel's
// dynamic shared memory exceeds 48 KB) or cudaGetLastError() (0 on success);
// does not synchronize.
extern "C" int gmpi_fused_fwd(const void* tex, long long stack_stride, const float* rx,
                              const float* ry, const float* q, const float* scal, float* color,
                              float* depth, float* disp, float* trans, float* warped,
                              int* n_live, int V, int L, int Th, int Tw, int H, int W,
                              int views_per_stack, int early_out, int with_disp, int tex_bf16,
                              float eps, void* stream) {
  if (views_per_stack < 1 || V % views_per_stack != 0 || (tex_bf16 != 0 && tex_bf16 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tex_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(tex), stack_stride, rx, ry, q, scal, color,
                  depth, disp, trans, warped, n_live, V, L, Th, Tw, H, W, views_per_stack,
                  early_out, with_disp, eps, s);
  }
  return launch(static_cast<const float*>(tex), stack_stride, rx, ry, q, scal, color, depth,
                disp, trans, warped, n_live, V, L, Th, Tw, H, W, views_per_stack, early_out,
                with_disp, eps, s);
}
