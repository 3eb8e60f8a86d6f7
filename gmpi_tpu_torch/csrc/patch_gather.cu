// Banded patch copy for Hopper (sm_90a).
//
// Replaces the TPU kernel gmpi_tpu/ops/pallas_patch.py:_kernel (launched by
// gather_patches, pallas_patch.py:58), the patch gather of the tile-banded
// warp.
//
// What it computes: for each texture n and output tile t, the copy of one
// window of the x-major fused texture,
//   out[n, t, r, k] = texf[n, x_lo + r, y_lo + k],  r < band_x, k < band_yc
//   (x_lo, y_lo) = offs[n, t]
// for 4-byte (f32) or 2-byte (bf16) elements.
//
// Bound on an H100 SXM: memory; every patch element is read once and written
// once, and nothing is computed.
//
// Design: one thread block per patch.  A patch is band_x rows of band_yc
// contiguous elements, so the block's threads stride over (row, 16-byte
// chunk) pairs with one 16-byte load and store each when the patch's source,
// its destination and both row pitches are 16-byte aligned, and over single
// elements otherwise.  Any in-range offset is taken: the TPU kernel's tile
// alignment of the starts (and the band slack that pays for it) does not
// carry over, nor its two-in-flight DMAs, its patches per grid step or its
// scalar-memory offset block.  Offsets are clamped into range before use, so
// the kernel never reads outside texf whatever it is handed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void patch_gather_kernel(const T* __restrict__ texf, const int* __restrict__ offs,
                                    T* __restrict__ out, int n_tiles, int wp, int hpc,
                                    int band_x, int band_yc) {
  const long long patch = blockIdx.x;  // n * n_tiles + t
  const long long n = patch / n_tiles;
  const int x_lo = min(max(offs[2 * patch], 0), wp - band_x);
  const int y_lo = min(max(offs[2 * patch + 1], 0), hpc - band_yc);
  const T* src = texf + (n * wp + x_lo) * (long long)hpc + y_lo;
  T* dst = out + patch * band_x * (long long)band_yc;

  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dst) % 16 == 0) && (hpc % kVec == 0) &&
                   (band_yc % kVec == 0);
  if (vec) {
    const int chunks = band_yc / kVec;
    const int total = band_x * chunks;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k / chunks, c = k - r * chunks;
      reinterpret_cast<uint4*>(dst + (long long)r * band_yc)[c] =
          reinterpret_cast<const uint4*>(src + (long long)r * hpc)[c];
    }
  } else {
    const int total = band_x * band_yc;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int r = k / band_yc, c = k - r * band_yc;
      dst[(long long)r * band_yc + c] = src[(long long)r * hpc + c];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: texf [N, wp, hpc] of elem_size-byte elements
// (4 or 2); offs [N, n_tiles, 2] int32 = (x_lo, y_lo); out
// [N, n_tiles, band_x, band_yc] of the same element type.  band_x <= wp and
// band_yc <= hpc.  Launches on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for another element size); does not
// synchronize.
extern "C" int gmpi_patch_gather(const void* texf, const int* offs, void* out, int N,
                                 int n_tiles, int wp, int hpc, int band_x, int band_yc,
                                 int elem_size, void* stream) {
  const long long patches = (long long)N * n_tiles;
  if (patches <= 0 || patches > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)patches, 1, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) {
    patch_gather_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(texf), offs, static_cast<uint32_t*>(out), n_tiles, wp, hpc,
        band_x, band_yc);
  } else if (elem_size == 2) {
    patch_gather_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(texf), offs, static_cast<uint16_t*>(out), n_tiles, wp, hpc,
        band_x, band_yc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
