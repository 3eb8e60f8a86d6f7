// Transpose of the bilinear homography warp (the "splat") for Hopper (sm_90a).
//
// Replaces the two TPU kernels gmpi_tpu/ops/pallas_warp.py:_splat_plane_kernel
// (launched by warp_splat_fat, pallas_warp.py:1609) and :_splat_kernel
// (launched by warp_splat, pallas_warp.py:1762).  The two compute one function
// and differ in how the texture accumulator is partitioned for the TPU's
// VMEM; this kernel stands for both.
//
// What it computes: the exact transpose of the forward kernel's warp
// (fused_fwd.cu).  For every pixel (v, i, j) and plane l, the cotangent
// d_samp[v, l, :, i, j] of the bilinear sample is scattered onto the four
// texels the forward read, with the weights it read them with:
//   fx = Ax_l * rx + Bx_l,  fy = Ay_l * ry + By_l
//   d_tex[v, l, c, y0 + dy, x0 + dx] += wy(dy) * wx(dx) * d_samp[v, l, c, i, j]
// with the same float-compared bounds, so a tap the forward read as zero
// (outside the texture) drops its weight here too, and a NaN coordinate fails
// them all.  Planes l >= n_live of a pixel are skipped without reading their
// slots; a pixel whose cotangent is all zero adds nothing.
//
// Bound on an H100 SXM: memory.  d_samp is read once (live pairs, 16 B each)
// and d_tex written once: 0.27 GB + 0.27 GB at V=8, L=32, 256^2, ~0.16 ms at
// 3.35 TB/s, against ~30 FLOP per pair.  What held the first kernel (a thread
// per pixel looping over its planes, 16 fp32 atomics into d_tex per plane) at
// 16% of that: 268 M scattered reductions, each a read-modify-write in L2, on
// all 256 planes at once, so d_tex (268 MB, beyond the 50 MB L2) was fetched
// back from device memory and written again line by line.
//
// Design: a block per (view, plane, tile of 32 x 32 pixels), the grid
// plane-major, so the blocks in flight share a dozen planes and their adds
// meet d_tex in L2.  The block finds the box of texels its live pixels tap (a
// block reduction of the taps' extremes; a near-identity warp gives ~35 x 35,
// the training poses at most 1848 texels), sums the taps in that box in shared
// memory, and adds the box into d_tex, which the caller has zeroed, with one
// 16-byte reduction per 4 texels and channel of the box (red.global.add.v4.f32
// where Tw % 4 == 0, else 4-byte ones): about one reduction per 3 texels,
// against 16 scattered ones per pixel.  In the box, a lane whose pixel sits
// one texel right of its neighbour's adds the neighbour's right taps with its
// own left ones (warp shuffles), so near scale 1 most right taps need no add
// of their own.  A box beyond kBoxFloats (a warp that
// magnifies by more than ~1.25) adds each tap into d_tex instead.  The sums'
// order depends on timing, so d_tex is repeatable to rounding only.  What
// this costs against the bound: the zero fill, and the L2 fetching the zeroed
// lines back from device memory before it adds into them.
//
// Tried and not kept (PERF.md, section 6): a thread-block cluster per (view,
// plane) holding the plane's whole accumulator in distributed shared memory,
// written once with no zero fill.  Shared memory has no floating-point atomic
// add on this card (atomicAdd compiles to a compare-and-swap loop,
// ATOMS.CAST.SPIN, one round trip per add), and an add into another block's
// shared memory is the same loop across the cluster; on an H100 its best
// form took about twice this kernel's time.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;        // pixels of a tile along x: a warp, a lane a column
constexpr int kTileH = 32;        // pixel rows of a tile: 8 warps of 4 rows
constexpr int kTileThreads = 256;
constexpr int kTileRows = kTileH / (kTileThreads / 32);
constexpr int kBoxFloats = 8192;  // shared memory of a tile's texel box, 4 channels (32 KB)

// blockIdx.x numbers (view * L + plane, tile row, tile column), the last
// fastest.  A thread owns a column of the tile and kTileRows of its rows.
__global__ void __launch_bounds__(kTileThreads)
splat_tile_kernel(const float* __restrict__ d_samp, const float* __restrict__ rx,
                  const float* __restrict__ ry, const float* __restrict__ scal,
                  const int* __restrict__ n_live, float* __restrict__ d_tex, int L, int Th, int Tw,
                  int H, int W, int tiles_x, int tiles_y, int vec, int box_ok) {
  __shared__ __align__(16) float s_box[kBoxFloats];
  __shared__ int s_ext[4][kTileThreads / 32];

  int b = blockIdx.x;
  const int tx = b % tiles_x;
  b /= tiles_x;
  const int ty = b % tiles_y;
  const int vl = b / tiles_y;  // view * L + plane
  const int v = vl / L, l = vl % L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* s = scal + (long long)vl * 6;
  const float ax = s[0], bx = s[1], ay = s[2], by = s[3];
  const long long hw = (long long)H * W;
  const int j = tx * kTileW + lane;

  // 1. this thread's pixels: coordinates, liveness, and the extremes of their taps
  float fx[kTileRows], fy[kTileRows];
  long long pix[kTileRows];
  bool need[kTileRows];
  int x_lo = INT_MAX, x_hi = INT_MIN, y_lo = INT_MAX, y_hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int i = ty * kTileH + warp + r * (kTileThreads / 32);
    need[r] = i < H && j < W;
    pix[r] = (long long)v * hw + (long long)i * W + j;
    fx[r] = need[r] ? ax * rx[pix[r]] + bx : 0.f;
    fy[r] = need[r] ? ay * ry[pix[r]] + by : 0.f;
    if (need[r] && n_live) need[r] = l < n_live[pix[r]];
  }
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const float x0f = floorf(fx[r]), y0f = floorf(fy[r]);
    // the forward kernel's bounds, compared in float (NaN fails them all)
    need[r] = need[r] && x0f >= -1.f && x0f <= (float)(Tw - 1) && y0f >= -1.f
              && y0f <= (float)(Th - 1);
    if (need[r]) {
      x_lo = min(x_lo, max((int)x0f, 0));
      x_hi = max(x_hi, min((int)x0f + 1, Tw - 1));
      y_lo = min(y_lo, max((int)y0f, 0));
      y_hi = max(y_hi, min((int)y0f + 1, Th - 1));
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x_lo = min(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, d));
    x_hi = max(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, d));
    y_lo = min(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, d));
    y_hi = max(y_hi, __shfl_xor_sync(0xffffffffu, y_hi, d));
  }
  if (lane == 0) {
    s_ext[0][warp] = x_lo;
    s_ext[1][warp] = x_hi;
    s_ext[2][warp] = y_lo;
    s_ext[3][warp] = y_hi;
  }
  __syncthreads();
  x_lo = s_ext[0][0], x_hi = s_ext[1][0], y_lo = s_ext[2][0], y_hi = s_ext[3][0];
#pragma unroll
  for (int w = 1; w < kTileThreads / 32; ++w) {
    x_lo = min(x_lo, s_ext[0][w]);
    x_hi = max(x_hi, s_ext[1][w]);
    y_lo = min(y_lo, s_ext[2][w]);
    y_hi = max(y_hi, s_ext[3][w]);
  }
  if (x_lo > x_hi || y_lo > y_hi) return;  // no live tap in the tile (uniform)
  const int bx0 = x_lo & ~3;                        // the box, 4-texel aligned along x
  const int bw = ((x_hi + 1 - bx0) + 3) & ~3;
  const int bh = y_hi + 1 - y_lo;
  const bool boxed = box_ok && (long long)bw * bh * 4 <= kBoxFloats;
  if (boxed) {
    float4* z = reinterpret_cast<float4*>(s_box);
    for (int k = tid; k < bw * bh; k += kTileThreads) z[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // 2. the cotangents, then their taps into the box (or into d_tex)
  float g[kTileRows][4];
  const float* gv = d_samp + (long long)vl * 4 * hw - (long long)v * hw;  // + pix: this plane
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) g[r][c] = need[r] ? gv[c * hw + pix[r]] : 0.f;
  }
  if (boxed) __syncthreads();  // the box is zero
  const long long plane = (long long)Th * Tw;
  float* tv = d_tex + (long long)vl * 4 * plane;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const bool act = need[r] && !(g[r][0] == 0.f && g[r][1] == 0.f && g[r][2] == 0.f
                                  && g[r][3] == 0.f);
    const float x0f = floorf(fx[r]), y0f = floorf(fy[r]);
    const float wx = fx[r] - x0f, wy = fy[r] - y0f;
    const int x0 = act ? (int)x0f : 0, y0 = act ? (int)y0f : 0;
    const bool vx0 = x0 >= 0, vx1 = x0 + 1 <= Tw - 1;
    const bool vy0 = y0 >= 0, vy1 = y0 + 1 <= Th - 1;
    const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
    const float w10 = wy * (1.f - wx), w11 = wy * wx;
    if (boxed) {
      // A lane's right taps are the next lane's left taps when the two pixels
      // share a texel row and the next sits one texel to the right (a warp
      // near scale 1): the next lane adds both, and this one skips its own.
      const int px0 = __shfl_up_sync(0xffffffffu, x0, 1);
      const int py0 = __shfl_up_sync(0xffffffffu, y0, 1);
      const bool pact = __shfl_up_sync(0xffffffffu, (int)act, 1);
      const bool absorb = act && lane > 0 && pact && py0 == y0 && px0 + 1 == x0;
      const bool absorbed = __shfl_down_sync(0xffffffffu, (int)absorb, 1) && lane < 31;
      const int o0 = (y0 - y_lo) * bw + x0 - bx0, o1 = o0 + bw, cs = bw * bh;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float r0 = w01 * g[r][c], r1 = w11 * g[r][c];
        const float p0 = __shfl_up_sync(0xffffffffu, r0, 1);
        const float p1 = __shfl_up_sync(0xffffffffu, r1, 1);
        if (!act) continue;
        const float l0 = absorb ? w00 * g[r][c] + p0 : w00 * g[r][c];
        const float l1 = absorb ? w10 * g[r][c] + p1 : w10 * g[r][c];
        if (vy0 && vx0) atomicAdd(s_box + c * cs + o0, l0);
        if (vy0 && vx1 && !absorbed) atomicAdd(s_box + c * cs + o0 + 1, r0);
        if (vy1 && vx0) atomicAdd(s_box + c * cs + o1, l1);
        if (vy1 && vx1 && !absorbed) atomicAdd(s_box + c * cs + o1 + 1, r1);
      }
    } else if (act) {
      const long long r0 = (long long)y0 * Tw, r1 = r0 + Tw;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* tc = tv + c * plane;
        if (vy0 && vx0) atomicAdd(tc + r0 + x0, w00 * g[r][c]);
        if (vy0 && vx1) atomicAdd(tc + r0 + x0 + 1, w01 * g[r][c]);
        if (vy1 && vx0) atomicAdd(tc + r1 + x0, w10 * g[r][c]);
        if (vy1 && vx1) atomicAdd(tc + r1 + x0 + 1, w11 * g[r][c]);
      }
    }
  }
  if (!boxed) return;
  __syncthreads();

  // 3. the box into d_tex: 16-byte reductions (Tw % 4 == 0), else 4-byte ones
  const int quads = bw / 4, cs = bw * bh;
  for (int k = tid; k < 4 * bh * quads; k += kTileThreads) {
    const int c = k / (bh * quads);
    const int rem = k - c * bh * quads;
    const int y = rem / quads, x = bx0 + 4 * (rem - y * quads);
    const float4 val = reinterpret_cast<const float4*>(s_box + c * cs + y * bw)[x / 4 - bx0 / 4];
    if (val.x == 0.f && val.y == 0.f && val.z == 0.f && val.w == 0.f) continue;
    float* dst = tv + c * plane + (long long)(y_lo + y) * Tw + x;
    if (vec) {
      atomicAdd(reinterpret_cast<float4*>(dst), val);
    } else {
      const float vals[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (x + q < Tw && vals[q] != 0.f) atomicAdd(dst + q, vals[q]);
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: d_samp [V, L, 4, H, W] f32; rx, ry [V, H, W]
// f32; scal [V, L, 6] f32 = (Ax, Bx, Ay, By, dscale, 0); n_live [V, H, W]
// int32 or null; d_tex [V, L, 4, Th, Tw] f32, which the caller has zeroed and
// this kernel adds into.  boxed = 0 adds every tap into d_tex directly (the
// path of a box beyond the shared memory; for tests and timing).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); more than 2^31 - 1
// blocks are refused (cudaErrorInvalidValue).  Does not synchronize.
extern "C" int gmpi_splat(const float* d_samp, const float* rx, const float* ry,
                          const float* scal, const int* n_live, float* d_tex, int V, int L,
                          int Th, int Tw, int H, int W, int boxed, void* stream) {
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)tiles_x * tiles_y * V * L;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = Tw % 4 == 0 && (reinterpret_cast<size_t>(d_tex) & 15u) == 0;
  splat_tile_kernel<<<static_cast<unsigned>(blocks), kTileThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(d_samp, rx, ry, scal, n_live, d_tex, L,
                                                           Th, Tw, H, W, tiles_x, tiles_y, vec,
                                                           boxed);
  return static_cast<int>(cudaGetLastError());
}
