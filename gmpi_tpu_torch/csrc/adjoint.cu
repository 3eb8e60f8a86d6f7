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
// What holds a texel-by-texel gather back is not those bytes but latency: a
// thread that looks for its few pixels in device memory makes long chains of
// dependent loads, most of which find nothing.
//
// Design: a block owns a tile of 32 x 16 texels of one (view, plane); a thread
// owns two texels, one above the other, and their four channels, sums their
// pixels in a fixed order and writes once: no atomics, no zero fill, bitwise
// repeatable.  (Two texels a thread: they share most of their pixels, so the
// walk below is paid once for both, and the box search once for 512 texels.)
//  1. The block finds the image box that can touch its tile,
//     {x0 - 1 < fx < x1 + 1, u0 - 1 < fy < u1 + 1}.  A pinhole ray field makes
//     fx and fy projective in the pixel index: fx does not decrease along an
//     image row, fy not along a column, and each is monotone along the other
//     axis too (what plan_adjoint checks on the host).  So over an interval
//     of rows the first and last column that can hold such a pixel are found
//     on the interval's two end rows, and likewise for rows on two end
//     columns.  Two rounds shrink the whole image to the box; in a round
//     the block's eight warps run eight searches at once: rows on the box's
//     two end columns, columns on its two end rows, a lower and an upper
//     search each.  A search is cooperative: the 32 lanes of a warp test 32
//     candidates a step, so 256 pixels take two dependent loads, not eight;
//     the whole search is about three.  No work precedes the launch.
//  2. The box is staged in shared memory in chunks of 20 rows x 44 columns:
//     rx, ry and the four d_samp channels, copied with cp.async (16 bytes a
//     thread where the image width and the pointers allow, 4 bytes otherwise),
//     two stages, so the next chunk is in flight while this one is summed.  A
//     near-identity warp needs one chunk; a box of any size (minification, an
//     odd pose) takes more chunks in a fixed order and is never truncated.
//  3. A warp owns two texel rows u, u + 1: its lanes test the staged rows,
//     one each, and drop those whose fy, bounded by the row's two ends,
//     cannot come within a texel of either.  In the others each thread finds
//     the first pixel with fx > x - 1 (a bisection in the first such row, a
//     step from the last answer after that), walks while fx < x + 1 and
//     accumulates weight * d_samp for both texels.  All of these reads are
//     shared memory.
// Every comparison treats a NaN coordinate so that the range grows, never
// shrinks.  None of the TPU kernel's strips, rebase, rolled windows, sentinel
// rows or power-of-two widths carries over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileX = 32;   // texels of a block's tile along x (= one warp)
constexpr int kTileY = 16;   // two texel rows a warp
constexpr int kThreads = kTileX * kTileY / 2;
constexpr int kChunkW = 44;  // staged pixels per chunk row (a multiple of 4)
constexpr int kChunkH = 20;
constexpr int kFields = 6;   // rx, ry, d_samp's four channels
constexpr int kChunk = kChunkW * kChunkH;
// slack of the box thresholds, in texels: absorbs the rounding jitter of a
// ray field that is constant along an axis (a few 1e-4 texel)
constexpr float kSlack = 1.f / 64.f;
constexpr int kRounds = 2;   // of the box search
static_assert(kThreads == 256, "the box search uses eight warps");
static_assert(2 * kFields * kChunk * sizeof(float) <= 48 * 1024, "static shared memory");
static_assert(kChunkH <= 32, "a warp's lanes test the staged rows, one each");

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The first n of [lo, hi) with pred(n), hi if there is none; pred is false up
// to some n and true from it on.  All 32 lanes of the warp call it together
// and get the same answer: each step tests 32 candidates.
template <class Pred>
__device__ __forceinline__ int warp_first(int lo, int hi, int lane, Pred pred) {
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned hit = __ballot_sync(0xffffffffu, pred(p));
    if (hit == 0u) return hi;
    const int k = __ffs(hit) - 1;
    hi = min(lo + (k + 1) * step - 1, hi - 1);
    lo = lo + k * step;
  }
  return lo;
}

// five blocks a multiprocessor: 51 registers a thread, 42 KB of shared memory a block
__global__ void __launch_bounds__(kThreads, 5)
adjoint_kernel(const float* __restrict__ d_samp, const float* __restrict__ rx,
               const float* __restrict__ ry, const float* __restrict__ scal,
               float* __restrict__ d_tex, int L, int Th, int Tw, int H, int W, int tiles_x,
               int tiles_y, int vec) {
  __shared__ __align__(16) float s_buf[2 * kFields * kChunk];  // two stages, 42,240 B
  __shared__ int s_found[8];

  int b = blockIdx.x;
  const int tile_x = b % tiles_x;
  b /= tiles_x;
  const int tile_y = b % tiles_y;
  const int vl = b / tiles_y;  // view * L + plane
  const int v = vl / L;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  const int x0 = tile_x * kTileX, u0 = tile_y * kTileY;
  const int x = x0 + lane, u = u0 + 2 * warp;  // this thread's texels: (u, x) and (u + 1, x)
  const bool own = x < Tw && u < Th, own_b = x < Tw && u + 1 < Th;
  const float* s = scal + (long long)vl * 6;
  const float ax = s[0], bx = s[1], ay = s[2], by = s[3];
  const long long hw = (long long)H * W;
  const float* rxv = rx + (long long)v * hw;
  const float* ryv = ry + (long long)v * hw;
  const float* g = d_samp + (long long)vl * 4 * hw;
  const long long plane = (long long)Th * Tw;
  float* out = d_tex + (long long)vl * 4 * plane + (long long)u * Tw + x;

  // -- 1. the tile's image box [ia, ib) x [ja, jb) -------------------------------
  const float x_lo = (float)x0 - 1.f - kSlack, x_hi = (float)min(x0 + kTileX, Tw) + kSlack;
  const float u_lo = (float)u0 - 1.f - kSlack, u_hi = (float)min(u0 + kTileY, Th) + kSlack;
  int ia = 0, ib = H, ja = 0, jb = W;
  bool empty = false;
#pragma unroll 1
  for (int round = 0; round < kRounds && !empty; ++round) {
    // warps 0-3 narrow the rows on the box's two end columns, warps 4-7 the
    // columns on its two end rows, all eight searches at once
    const bool second = (warp & 1) != 0, upper = (warp & 2) != 0;
    int found;
    if (warp < 4) {
      const float* col = ryv + (second ? jb - 1 : ja);
      found = upper
          ? warp_first(ia, ib, lane, [&](int i) {
              return __fmaf_rn(ay, __ldg(col + (long long)i * W), by) >= u_hi; })
          : warp_first(ia, ib, lane, [&](int i) {
              return !(__fmaf_rn(ay, __ldg(col + (long long)i * W), by) <= u_lo); });
    } else {
      const float* row = rxv + (long long)(second ? ib - 1 : ia) * W;
      found = upper
          ? warp_first(ja, jb, lane, [&](int j) {
              return __fmaf_rn(ax, __ldg(row + j), bx) >= x_hi; })
          : warp_first(ja, jb, lane, [&](int j) {
              return !(__fmaf_rn(ax, __ldg(row + j), bx) <= x_lo); });
    }
    if (lane == 0) s_found[warp] = found;
    __syncthreads();
    ia = min(s_found[0], s_found[1]);
    ib = max(s_found[2], s_found[3]);
    ja = min(s_found[4], s_found[5]);
    jb = max(s_found[6], s_found[7]);
    __syncthreads();
    empty = ia >= ib || ja >= jb;
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc_b[4] = {0.f, 0.f, 0.f, 0.f};
  if (!empty) {
    // -- 2. and 3. stage the box chunk by chunk, sum each chunk --------------------
    if (vec) ja &= ~3;  // 16-byte copies start on a multiple of 4 pixels
    const int n_cc = (jb - ja + kChunkW - 1) / kChunkW;
    const int n_chunks = ((ib - ia + kChunkH - 1) / kChunkH) * n_cc;
    const float xt = (float)x, ut = (float)u;
    const float below = xt - 1.f, above = xt + 1.f;

    // a thread keeps one slot (row, column or group of 4 columns) of all six
    // fields, so the index arithmetic is per slot, not per copy
    const int per_row = vec ? kChunkW / 4 : kChunkW;
    auto start_copies = [&](int q) {
      const int ci = ia + (q / n_cc) * kChunkH, cj = ja + (q % n_cc) * kChunkW;
      const int nr = min(kChunkH, ib - ci), nc = min(kChunkW, jb - cj);
      float* dst = s_buf + (q & 1) * kFields * kChunk;
      for (int slot = tid; slot < kChunkH * per_row; slot += kThreads) {
        const int r = slot / per_row, col = (slot % per_row) * (vec ? 4 : 1);
        if (r >= nr || col >= nc) continue;
        const long long at = (long long)(ci + r) * W + cj + col;
        float* d = dst + r * kChunkW + col;
        if (vec) {
          cp_async16(d, rxv + at);
          cp_async16(d + kChunk, ryv + at);
#pragma unroll
          for (int c = 0; c < 4; ++c) cp_async16(d + (2 + c) * kChunk, g + c * hw + at);
        } else {
          cp_async4(d, rxv + at);
          cp_async4(d + kChunk, ryv + at);
#pragma unroll
          for (int c = 0; c < 4; ++c) cp_async4(d + (2 + c) * kChunk, g + c * hw + at);
        }
      }
    };

    start_copies(0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 1
    for (int q = 0; q < n_chunks; ++q) {
      if (q + 1 < n_chunks) start_copies(q + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // may be empty
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk q has landed
      __syncthreads();
      {
        const int ci = ia + (q / n_cc) * kChunkH, cj = ja + (q % n_cc) * kChunkW;
        const int nr = min(kChunkH, ib - ci), nc = min(kChunkW, jb - cj);
        const float* sx = s_buf + (q & 1) * kFields * kChunk;
        const float* sy = sx + kChunk;
        const float* sg = sy + kChunk;
        // fy is monotone along an image row, so a staged row's two ends
        // bound it: lane r drops row r where it cannot come within a texel
        // of this warp's u or u + 1 (a NaN end bounds nothing; the slack
        // covers a row that is constant up to rounding)
        bool keep = false;
        if (lane < nr) {
          const float e0 = __fmaf_rn(ay, sy[lane * kChunkW], by);
          const float e1 = __fmaf_rn(ay, sy[lane * kChunkW + nc - 1], by);
          const float under = ut - 1.f - kSlack, over = ut + 2.f + kSlack;
          keep = !((e0 <= under && e1 <= under) || (e0 >= over && e1 >= over));
        }
        unsigned rows_left = __ballot_sync(0xffffffffu, keep);
        if (!own) rows_left = 0u;  // a lane past the texture's edge sums nothing
        int lo = 0;
        bool searched = false;
        while (rows_left) {
          const int r = __ffs(rows_left) - 1;
          rows_left &= rows_left - 1;
          const float* row = sx + r * kChunkW;
          // lo: the first pixel of this row with fx > x - 1 (a NaN counts as
          // one).  Bisected in the first row walked; a later row's crossing
          // lies a few pixels from the last one's, so lo is stepped after that.
          if (!searched) {
            searched = true;
            int hi = nc;
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (!(__fmaf_rn(ax, row[mid], bx) <= below)) hi = mid; else lo = mid + 1;
            }
          } else {
            while (lo > 0 && !(__fmaf_rn(ax, row[lo - 1], bx) <= below)) --lo;
            while (lo < nc && !(__fmaf_rn(ax, row[lo], bx) > below)) ++lo;
          }
          for (int n = lo; n < nc; ++n) {
            const float fx = __fmaf_rn(ax, row[n], bx);
            if (fx >= above) break;  // NaN walks on with weight 0
            const float wx = fmaxf(0.f, 1.f - fabsf(fx - xt));
            if (wx > 0.f) {
              const int at = r * kChunkW + n;
              const float fy = __fmaf_rn(ay, sy[at], by);
              const float w = wx * fmaxf(0.f, 1.f - fabsf(fy - ut));
              const float w_b = wx * fmaxf(0.f, 1.f - fabsf(fy - (ut + 1.f)));
              if (w > 0.f || w_b > 0.f) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const float gc = sg[c * kChunk + at];
                  if (w > 0.f) acc[c] += w * gc;
                  if (w_b > 0.f) acc_b[c] += w_b * gc;
                }
              }
            }
          }
        }
      }
      __syncthreads();  // before chunk q + 2 overwrites this stage
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (own) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * plane] = acc[c];
  }
  if (own_b) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * plane + Tw] = acc_b[c];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: d_samp [V, L, 4, H, W] f32; rx, ry [V, H, W]
// f32; scal [V, L, 6] f32 = (Ax, Bx, Ay, By, dscale, 0); d_tex
// [V, L, 4, Th, Tw] f32, every element of which this kernel writes.  One block
// per tile of 32 x 16 texels of a (view, plane), on a one-dimensional grid; more
// than 2^31 - 1 blocks are refused (cudaErrorInvalidValue).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not synchronize.
extern "C" int gmpi_adjoint(const float* d_samp, const float* rx, const float* ry,
                            const float* scal, float* d_tex, int V, int L, int Th, int Tw,
                            int H, int W, void* stream) {
  const int tiles_x = (Tw + kTileX - 1) / kTileX, tiles_y = (Th + kTileY - 1) / kTileY;
  const long long blocks = (long long)tiles_x * tiles_y * V * L;
  if (blocks < 1 || blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15u) == 0; };
  const int vec = W % 4 == 0 && aligned(d_samp) && aligned(rx) && aligned(ry);
  adjoint_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(d_samp, rx, ry, scal, d_tex, L, Th, Tw,
                                                        H, W, tiles_x, tiles_y, vec);
  return static_cast<int>(cudaGetLastError());
}
