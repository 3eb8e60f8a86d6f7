// Bilinear taps of the tile-banded warp, read from the texture itself, for
// Hopper (sm_90a): K10.
//
// Replaces no TPU kernel.  The JAX package cuts one texture patch a tile out
// of a zero-padded, x-major copy of the texture (gmpi_tpu/ops/pallas_patch.py,
// ported as patch_gather.cu, K7) to feed the TPU's matrix unit, and the port
// then read each pixel's four taps from those patches (patch_sample.cu, K8).
// On this card no matrix product reads the patches, and a 1024^2 RGBA plane
// (16.8 MB) fits in L2, so this kernel reads the taps straight from the
// texture: no padded copy, no patches (at 96 planes of 1024^2 with MetFaces'
// bands, K7 wrote 47.5 GB of patches a render to serve 1.61 GB of texture).
//
// What it computes, for texture n and each output pixel (oy, ox) of tile t
// (row-major over the output's tile_r x tile_c tiles), with the tile's band
// origin (x_o, y_o) = origins[n, t] in texels of the unpadded texture:
//   rx = fx[n, oy, ox] - x_o,  ry = fy[n, oy, ox] - y_o
//   j0 = floor(rx), ax = rx - j0;  i0 = floor(ry), ay = ry - i0
//   m_i = (1 - ax) T[j0, i] + ax T[j0 + 1, i]               (i = i0, i0 + 1)
//   out[n, c, oy, ox] = (1 - ay) m_i0 + ay m_(i0 + 1)
// with T[j, i] = tex[n, c, y_o + i, x_o + j], read as zero where the tap
// lies outside the band [0, band_x) x [0, band_y) or outside the texture.
// That is K8's arithmetic on K7's patches (a patch is the band cut from the
// texture padded with zeros, at the same clamped origin), so the output is
// bitwise K7 + K8's for any input, NaN coordinates included (a NaN
// coordinate reads no tap and gives NaN).
//
// Bound on an H100 SXM: memory.  The texture read once (16 B a texel at
// C = 4), the coordinates once (8 B a pixel), the samples written once (16 B
// a pixel): at 96 planes of 1024^2 4.03 GB, 1.20 ms at 3.35 TB/s.  Nothing is
// computed to speak of (~8 FLOP a channel).
//
// Design.  A block covers 8 output rows of 32 columns, a warp a row, so a
// warp's coordinate loads and sample stores are 128 contiguous bytes each and
// the texture rows one warp's taps read are read again by the next warp's
// from the SM's L1.  The grid runs column blocks, then row blocks, then
// textures, so the blocks in flight share one or two planes whose texels
// (16.8 MB at 1024^2) stay in L2 while their pixels are served.  The texture
// is channel-planar, so a tap is one 4-byte load a channel (16 a pixel at
// C = 4, through L1); the coordinates are read and the samples written with
// streaming hints, so that they do not push the texture out of L2.  Offsets
// of a texture are 64-bit (N C H W reaches 2^31 at 512 textures of 1024^2);
// within one, 32-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // output columns a block (a warp's row)
constexpr int kRows = 8;   // output rows a block (its warps)
constexpr int kMaxGridZ = 65535;

template <int kC>  // channels, or 0 for any (a loop)
__global__ void __launch_bounds__(kCols * kRows) texture_sample(
    const float* __restrict__ tex, const int* __restrict__ origins, const float* __restrict__ fx,
    const float* __restrict__ fy, float* __restrict__ out, int N, int C_, int h, int w, int ho,
    int wo, int tile_r, int tile_c, int band_y, int band_x) {
  const int C = kC > 0 ? kC : C_;
  const int ox = blockIdx.x * kCols + threadIdx.x;
  const int oy = blockIdx.y * kRows + threadIdx.y;
  if (ox >= wo || oy >= ho) return;
  const int ntx = wo / tile_c;
  const long long n_tiles = (long long)(ho / tile_r) * ntx;
  const int t = (oy / tile_r) * ntx + ox / tile_c;
  const int pix = oy * wo + ox;
  const long long plane = (long long)ho * wo;
  const int hw = h * w;

  for (long long n = blockIdx.z; n < N; n += gridDim.z) {
    const int* o = origins + 2 * (n * n_tiles + t);
    const int x_o = __ldg(o), y_o = __ldg(o + 1);
    const float rx = __ldcs(fx + n * plane + pix) - static_cast<float>(x_o);
    const float ry = __ldcs(fy + n * plane + pix) - static_cast<float>(y_o);
    const float j0f = floorf(rx), i0f = floorf(ry);
    const float ax = rx - j0f, ay = ry - i0f;
    const float wx0 = 1.f - ax, wy0 = 1.f - ay;
    // taps inside the band (false for a NaN coordinate, whose weights carry the NaN)
    const bool bx0 = j0f >= 0.f && j0f < band_x, bx1 = j0f >= -1.f && j0f + 1.f < band_x;
    const bool by0 = i0f >= 0.f && i0f < band_y, by1 = i0f >= -1.f && i0f + 1.f < band_y;
    // indices clamped to [-1, B] before the conversion; used only where in the band
    const int x0 = x_o + static_cast<int>(fminf(fmaxf(j0f, -1.f), static_cast<float>(band_x)));
    const int y0 = y_o + static_cast<int>(fminf(fmaxf(i0f, -1.f), static_cast<float>(band_y)));
    // ... and inside the texture (the zero padding K7's patches carried)
    const bool vx0 = bx0 && x0 >= 0 && x0 < w, vx1 = bx1 && x0 + 1 >= 0 && x0 + 1 < w;
    const bool vy0 = by0 && y0 >= 0 && y0 < h, vy1 = by1 && y0 + 1 >= 0 && y0 + 1 < h;
    const bool v00 = vx0 && vy0, v01 = vx0 && vy1, v10 = vx1 && vy0, v11 = vx1 && vy1;
    const long long at = (long long)y0 * w + x0;
    const float* src = tex + n * C * hw;
    float* dst = out + n * C * plane + pix;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* s = src + c * hw + at;
      const float a00 = v00 ? __ldg(s) : 0.f;
      const float a01 = v01 ? __ldg(s + w) : 0.f;
      const float a10 = v10 ? __ldg(s + 1) : 0.f;
      const float a11 = v11 ? __ldg(s + w + 1) : 0.f;
      __stcs(dst + c * plane, wy0 * (wx0 * a00 + ax * a10) + ay * (wx0 * a01 + ax * a11));
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: tex [N, C, h, w] float32; origins
// [N, (ho / tile_r) * (wo / tile_c), 2] int32, each tile's band origin (x, y)
// in texels, as the tiled warp clamps it; fx, fy [N, ho, wo] float32 texel
// coordinates; out [N, C, ho, wo] float32, every element written.  Launches
// on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a shape it does not take); does not synchronize.
extern "C" int gmpi_texture_sample(const float* tex, const int* origins, const float* fx,
                                   const float* fy, float* out, int N, int C, int h, int w,
                                   int ho, int wo, int tile_r, int tile_c, int band_y,
                                   int band_x, void* stream) {
  if (N < 1 || C < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || tile_r < 1 || tile_c < 1 ||
      band_y < 1 || band_x < 1 || ho % tile_r || wo % tile_c ||
      (long long)C * h * w > 2147483647LL || (long long)ho * wo > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((wo + kCols - 1) / kCols, (ho + kRows - 1) / kRows, N < kMaxGridZ ? N : kMaxGridZ);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kCols, kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 4)
    texture_sample<4><<<grid, block, 0, st>>>(tex, origins, fx, fy, out, N, C, h, w, ho, wo,
                                              tile_r, tile_c, band_y, band_x);
  else
    texture_sample<0><<<grid, block, 0, st>>>(tex, origins, fx, fy, out, N, C, h, w, ho, wo,
                                              tile_r, tile_c, band_y, band_x);
  return static_cast<int>(cudaGetLastError());
}
