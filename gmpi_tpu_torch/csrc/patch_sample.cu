// Bilinear taps of the tile-banded warp, read from its patches, for Hopper
// (sm_90a): K8.
//
// Replaces no TPU kernel.  The JAX package interpolates the tile-banded
// warp's patches with two dense contractions against "hat" matrices
// (gmpi_tpu/ops/tiled_warp.py:_warp_row_tiles), a stage it leaves to XLA and
// the TPU's matrix unit.  Ported as they are, those contractions ran in fp32
// on this card at 2 x B_x x B_y x C FLOPs a pixel, nearly all of them
// products with a zero weight (each hat row has two nonzeros in B_x), and
// built and rewrote gigabytes of hats.  A pixel needs four taps, so this
// kernel reads them straight from the patches that patch_gather.cu (K7)
// wrote and forms no hat.
//
// What it computes, for texture n and each pixel (oy, ox) of the tiles
// first_tile .. first_tile + n_tiles - 1 (row-major over the output's
// tile_r x tile_c tiles; t counts from first_tile):
//   rx = fx[n, oy, ox] - (offs[n, t, 0] - pad_x)
//   ry = fy[n, oy, ox] - (offs[n, t, 1] / C - pad_y)
//   j0 = floor(rx), ax = rx - j0;  i0 = floor(ry), ay = ry - i0
//   m_i = (1 - ax) P[j0, i] + ax P[j0 + 1, i]               (i = i0, i0 + 1)
//   out[n, c, oy, ox] = (1 - ay) m_i0 + ay m_(i0 + 1)
// with P[j, i] = patch[n, t, j, i * C + c] and a tap outside [0, B_x) x
// [0, B_y) read as zero, as the hats' relu drops it: the same bilinear sum as
// the hats' (x first, then y), in fp32.  offs are the clamped band starts K7
// was given (x in texels, y in elements of a row: texel y times C); pad_x and
// pad_y the zero padding of the texture they index.  A NaN coordinate gives
// NaN, as it does through the hats.
//
// Bound on an H100 SXM: memory.  Per pixel it reads its two coordinates and
// writes C values; the taps a tile's pixels touch (about one texel column
// pair per pixel, 32 bytes a column at C = 4) come from the patch K7 has just
// written, mostly out of L2.  Nothing is computed to speak of (~8 FLOP per
// channel).
//
// Design.  The patch (577 KB a tile at 256^2) is larger than shared memory
// and a tile's pixels touch a few percent of it, so nothing is staged: a
// thread takes one pixel and loads its taps from device memory.  Threads run
// tile-major (tile, then row, then column of the tile), so a warp's
// coordinate loads and output stores are consecutive along Wo.  For C = 4 a
// tap pair (i0, i0 + 1) of one column is 32 contiguous bytes: two 16-byte
// loads a column, four a pixel.  Other C loop over the channels with scalar
// loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float wa, float wb) {
  return make_float4(wa * a.x + wb * b.x, wa * a.y + wb * b.y, wa * a.z + wb * b.z,
                     wa * a.w + wb * b.w);
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) patch_sample(
    const float* __restrict__ patches, const int* __restrict__ offs, const float* __restrict__ fx,
    const float* __restrict__ fy, float* __restrict__ out, long long pixels, int n_tiles,
    int band_x, int band_y, int C, int ho, int wo, int tile_r, int tile_c, int first_tile,
    int pad_x, int pad_y) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= pixels) return;
  const int tile_px = tile_r * tile_c;
  const long long patch = q / tile_px;  // n * n_tiles + t
  const int p = static_cast<int>(q - patch * tile_px);
  const long long n = patch / n_tiles;
  const int tg = first_tile + static_cast<int>(patch - n * n_tiles);
  const int ntx = wo / tile_c;
  const int oy = (tg / ntx) * tile_r + p / tile_c;
  const int ox = (tg % ntx) * tile_c + p % tile_c;
  const long long plane = (long long)ho * wo;
  const long long pix = (long long)oy * wo + ox;

  const float rx = fx[n * plane + pix] - static_cast<float>(offs[2 * patch] - pad_x);
  const float ry = fy[n * plane + pix] - static_cast<float>(offs[2 * patch + 1] / C - pad_y);
  const float j0f = floorf(rx), i0f = floorf(ry);
  const float ax = rx - j0f, ay = ry - i0f;
  const float wx0 = 1.f - ax, wy0 = 1.f - ay;
  // taps inside the band (false for a NaN coordinate, whose weights carry the NaN)
  const bool x0 = j0f >= 0.f && j0f < band_x, x1 = j0f >= -1.f && j0f + 1.f < band_x;
  const bool y0 = i0f >= 0.f && i0f < band_y, y1 = i0f >= -1.f && i0f + 1.f < band_y;
  // indices clamped to [-1, B] before the conversion; used only where in the band
  const int j0 = static_cast<int>(fminf(fmaxf(j0f, -1.f), static_cast<float>(band_x)));
  const int i0 = static_cast<int>(fminf(fmaxf(i0f, -1.f), static_cast<float>(band_y)));
  const long long byc = (long long)band_y * C;
  const float* base = patches + patch * band_x * byc;
  float* dst = out + n * C * plane + pix;

  if (kVec4) {  // C == 4: column j's texels (i, i + 1) are float4s j * band_y + i, + 1
    const float4* col = reinterpret_cast<const float4*>(base);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long c0 = (long long)j0 * band_y + i0, c1 = c0 + band_y;
    const float4 a00 = x0 && y0 ? __ldg(col + c0) : zero;
    const float4 a01 = x0 && y1 ? __ldg(col + c0 + 1) : zero;
    const float4 a10 = x1 && y0 ? __ldg(col + c1) : zero;
    const float4 a11 = x1 && y1 ? __ldg(col + c1 + 1) : zero;
    const float4 s = lerp4(lerp4(a00, a10, wx0, ax), lerp4(a01, a11, wx0, ax), wy0, ay);
    dst[0] = s.x;
    dst[plane] = s.y;
    dst[2 * plane] = s.z;
    dst[3 * plane] = s.w;
  } else {
    const long long c0 = (long long)j0 * byc + (long long)i0 * C, c1 = c0 + byc;
    for (int c = 0; c < C; ++c) {
      const float a00 = x0 && y0 ? __ldg(base + c0 + c) : 0.f;
      const float a01 = x0 && y1 ? __ldg(base + c0 + C + c) : 0.f;
      const float a10 = x1 && y0 ? __ldg(base + c1 + c) : 0.f;
      const float a11 = x1 && y1 ? __ldg(base + c1 + C + c) : 0.f;
      dst[c * plane] = wy0 * (wx0 * a00 + ax * a10) + ay * (wx0 * a01 + ax * a11);
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: patches [N, n_tiles, band_x, band_y * C]
// float32 (K7's output); offs [N, n_tiles, 2] int32, the clamped band starts
// K7 was given; fx, fy [N, ho, wo] float32 texel coordinates; out
// [N, C, ho, wo] float32, of which the kernel writes the pixels of tiles
// first_tile .. first_tile + n_tiles - 1.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a shape it does
// not take); does not synchronize.
extern "C" int gmpi_patch_sample(const float* patches, const int* offs, const float* fx,
                                 const float* fy, float* out, int N, int n_tiles, int band_x,
                                 int band_y, int C, int ho, int wo, int tile_r, int tile_c,
                                 int first_tile, int pad_x, int pad_y, void* stream) {
  if (N < 1 || n_tiles < 1 || band_x < 1 || band_y < 1 || C < 1 || tile_r < 1 || tile_c < 1 ||
      ho % tile_r || wo % tile_c || first_tile < 0 ||
      (long long)first_tile + n_tiles > (long long)(ho / tile_r) * (wo / tile_c))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = (long long)N * n_tiles * tile_r * tile_c;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4 && reinterpret_cast<uintptr_t>(patches) % 16 == 0)
    patch_sample<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        patches, offs, fx, fy, out, pixels, n_tiles, band_x, band_y, C, ho, wo, tile_r, tile_c,
        first_tile, pad_x, pad_y);
  else
    patch_sample<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        patches, offs, fx, fy, out, pixels, n_tiles, band_x, band_y, C, ho, wo, tile_r, tile_c,
        first_tile, pad_x, pad_y);
  return static_cast<int>(cudaGetLastError());
}
