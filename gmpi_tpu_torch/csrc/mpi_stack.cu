// One synthesis block's update of the generator's MPI skip stack, for Hopper
// (sm_90a): K9.
//
// Replaces no TPU kernel.  The JAX package writes this update as array code
// (gmpi_tpu/models/generator.py: SynthesisBlock's upsample2d of `img`, the
// broadcast and concatenation of the RGB and alpha heads, the add; then
// Generator.synthesize's final activation and background alpha) and leaves
// its fusion to XLA.  Ported op by op, it made about twenty passes over the
// stack on this card: the FIR as zero insertion, a pad and a one-channel
// cuDNN convolution over B x L x 4 images, the expanded RGB, a zero alpha,
// two concatenations, the add, and at the last block three passes of the
// activation and one more concatenation.  At 1024^2 and 96 planes the stack
// is 1.61 GB, so those passes were the larger part of a sampled image's
// device time.  This kernel reads the previous stack once and writes the new
// one once.
//
// What it computes, for stack_in [B, L, 4, H, W] float32 (H = W = R / 2) and
// the heads at R x R:
//   v[b, l, c, y, x] = up2(stack_in)[b, l, c, y, x] + head[b, l, c, y, x]
//   out = act(v), and out[b, L - 1, 3] = 1 where alpha_full
// up2 is upfirdn2d's 2x upsample with the 4 x 4 filter f (gain 4, flipped,
// zero insertion, padding (2, 1) on each axis): in polyphase form an output
// pixel (2m + py, 2n + px) sums the 2 x 2 inputs (m - 1 + py + a,
// n - 1 + px + b), a, b in {0, 1}, weighted 4 f[3 - py - 2a][3 - px - 2b],
// an input outside the image read as zero.  head is, for c < 3, the
// plane-shared RGB rgb[b, c] (bg[b, c] on plane L - 1 where there is a
// background); for c = 3 alpha[b * L + l, 0], or zero without one.  Heads
// are read as float32 or bf16 (widened exactly) and added in fp32.  act is
// none (the stack stays raw: not the last block), (clamp(v, -1, 1) + 1) / 2,
// sigmoid(v) or (tanh(v) + 1) / 2.  Without stack_in the result is the head
// alone.
//
// Bound on an H100 SXM: memory.  Per output element it reads a quarter of an
// input element and the heads (the RGB once a pixel, not once a plane) and
// writes one element: at 1024^2 and 96 planes 0.40 GB read and 1.61 GB
// written, ~0.6 ms at 3.35 TB/s.  The FIR costs 4 FMAs an output.
//
// Design.  A thread owns a (batch, channel) pair of output rows (2m, 2m + 1)
// and four columns (4q .. 4q + 3), and walks the planes: it loads the
// head's RGB of its pixels once and keeps it in registers across the
// planes, then per plane loads its 3 x 4 input window (a float2 and two
// scalars a row, the window's neighbours' loads served by L1) and stores two
// 16-byte rows, streamed past L2.  Threads run column-major within a row
// pair, so a warp's stores are 512 contiguous bytes a row.  Where the
// pixels alone give too few threads to keep the card's memory busy (96
// planes of 256^2 at batch 1 give 32,768), the planes are cut into chunks,
// one chunk a grid row.  Nothing is staged in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 64 registers a thread: 1,024 threads an SM keep enough loads in flight.  At
// the 80 to 110 the compiler takes unbounded, 512 to 768 fit and the kernel
// reached 50% of its byte bound at 1024^2 on an H100, against 72% here.
constexpr int kBlocksPerSM = 4;

// four consecutive head values from element idx, as float
__device__ __forceinline__ float4 load4(const void* base, long long idx, int bf16) {
  if (bf16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(base) + idx));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(base) + idx));
}

// Generator.synthesize's final activation (act: -1 none, 0 clamp, 1 sigmoid,
// 2 tanh), as PyTorch computes it in fp32; a NaN stays NaN
__device__ __forceinline__ float finish(float v, int act) {
  if (act == 0) {
    v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
    return (v + 1.f) / 2.f;
  }
  if (act == 1) return 1.f / (1.f + expf(-v));
  if (act == 2) return (tanhf(v) + 1.f) / 2.f;
  return v;
}

__device__ __forceinline__ float4 finish4(float4 v, int act) {
  return make_float4(finish(v.x, act), finish(v.y, act), finish(v.z, act), finish(v.w, act));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) mpi_stack(
    const float* __restrict__ in, const float* __restrict__ filt, const void* __restrict__ rgb,
    const void* __restrict__ bg, const void* __restrict__ alpha, float* __restrict__ out, int B,
    int L, int R, int planes_per_chunk, int rgb_bf16, int bg_bf16, int alpha_bf16, int act,
    int alpha_full) {
  const int quads = R / 4, pairs = R / 2;
  const long long cells = (long long)B * 4 * pairs * quads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= cells) return;
  const int q = static_cast<int>(t % quads);
  long long r = t / quads;
  const int m = static_cast<int>(r % pairs);
  r /= pairs;
  const int ch = static_cast<int>(r % 4);
  const int b = static_cast<int>(r / 4);
  const int l0 = blockIdx.y * planes_per_chunk;
  const int l1 = min(L, l0 + planes_per_chunk);

  const long long R2 = (long long)R * R;
  const long long pix0 = (long long)(2 * m) * R + 4 * q, pix1 = pix0 + R;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 fg0 = zero, fg1 = zero;  // the plane-shared RGB of the thread's pixels
  if (ch < 3) {
    const long long o = ((long long)b * 3 + ch) * R2;
    fg0 = load4(rgb, o + pix0, rgb_bf16);
    fg1 = load4(rgb, o + pix1, rgb_bf16);
  }

  // w[py][px][a][b]: the polyphase taps of the flipped filter, gain 4
  float w[2][2][2][2];
  const int H = R / 2;
  if (in) {
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int px = 0; px < 2; ++px)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
            w[py][px][a][bb] = 4.f * __ldg(filt + (3 - py - 2 * a) * 4 + (3 - px - 2 * bb));
  }
  // the input window: rows m - 1 .. m + 1, columns 2q - 1 .. 2q + 2
  const bool row_ok[3] = {m > 0, true, m + 1 < H};
  const bool left = q > 0, right = 2 * q + 2 < H;

#pragma unroll 2
  for (int l = l0; l < l1; ++l) {
    float4 v0, v1;  // rows 2m and 2m + 1
    if (ch < 3) {
      if (bg && l == L - 1) {
        const long long o = ((long long)b * 3 + ch) * R2;
        v0 = load4(bg, o + pix0, bg_bf16);
        v1 = load4(bg, o + pix1, bg_bf16);
      } else {
        v0 = fg0;
        v1 = fg1;
      }
    } else if (alpha) {
      const long long o = ((long long)b * L + l) * R2;
      v0 = load4(alpha, o + pix0, alpha_bf16);
      v1 = load4(alpha, o + pix1, alpha_bf16);
    } else {
      v0 = zero;
      v1 = zero;
    }
    if (in) {
      const float* p = in + (((long long)b * L + l) * 4 + ch) * ((long long)H * H);
      float x[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* row = p + (long long)(m - 1 + i) * H + 2 * q;
        float2 mid = make_float2(0.f, 0.f);
        float lo = 0.f, hi = 0.f;
        if (row_ok[i]) {
          mid = __ldg(reinterpret_cast<const float2*>(row));
          if (left) lo = __ldg(row - 1);
          if (right) hi = __ldg(row + 2);
        }
        x[i][0] = lo;
        x[i][1] = mid.x;
        x[i][2] = mid.y;
        x[i][3] = hi;
      }
      float u[2][4];
#pragma unroll
      for (int py = 0; py < 2; ++py)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int px = k & 1, j = (k >> 1) + px;
          float s = x[py][j] * w[py][px][0][0];
          s = fmaf(x[py][j + 1], w[py][px][0][1], s);
          s = fmaf(x[py + 1][j], w[py][px][1][0], s);
          u[py][k] = fmaf(x[py + 1][j + 1], w[py][px][1][1], s);
        }
      v0 = add4(make_float4(u[0][0], u[0][1], u[0][2], u[0][3]), v0);
      v1 = add4(make_float4(u[1][0], u[1][1], u[1][2], u[1][3]), v1);
    }
    if (act >= 0) {
      v0 = finish4(v0, act);
      v1 = finish4(v1, act);
    }
    if (alpha_full && ch == 3 && l == L - 1) {
      v0 = make_float4(1.f, 1.f, 1.f, 1.f);
      v1 = v0;
    }
    float* o = out + (((long long)b * L + l) * 4 + ch) * R2;
    __stcs(reinterpret_cast<float4*>(o + pix0), v0);
    __stcs(reinterpret_cast<float4*>(o + pix1), v1);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: in [B, L, 4, R/2, R/2] float32 or null (the
// first block); filt the block's 4 x 4 float32 resample filter (null with no
// `in`); rgb [B, 3, R, R] and bg [B, 3, R, R] (null: no background plane),
// alpha [B * L, 1, R, R] (null: zero), each float32 or bf16 as its flag says;
// out [B, L, 4, R, R] float32, every element written.  act: -1 raw, 0 clamp,
// 1 sigmoid, 2 tanh; alpha_full sets plane L - 1's alpha to 1 after it.
// planes_per_chunk: the planes one thread walks.  Launches on `stream` and
// returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for a shape
// or pointer it does not take); does not synchronize.
extern "C" int gmpi_mpi_stack(const float* in, const float* filt, const void* rgb, const void* bg,
                              const void* alpha, float* out, int B, int L, int R,
                              int planes_per_chunk, int rgb_bf16, int bg_bf16, int alpha_bf16,
                              int act, int alpha_full, void* stream) {
  auto misaligned = [](const void* p, int bf16) {
    return reinterpret_cast<uintptr_t>(p) % (bf16 ? 8 : 16) != 0;
  };
  if (B < 1 || L < 1 || R < 4 || R % 4 || planes_per_chunk < 1 || act < -1 || act > 2 ||
      !rgb || !out || (in && !filt) || misaligned(rgb, rgb_bf16) || misaligned(out, 0) ||
      (bg && misaligned(bg, bg_bf16)) || (alpha && misaligned(alpha, alpha_bf16)) ||
      (in && misaligned(in, 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = (long long)B * 4 * (R / 2) * (R / 4);
  const long long blocks = (cells + kThreads - 1) / kThreads;
  const long long chunks = (L + planes_per_chunk - 1) / planes_per_chunk;
  if (blocks > 2147483647LL || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  mpi_stack<<<dim3((unsigned)blocks, (unsigned)chunks), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(in, filt, rgb, bg, alpha, out, B, L, R,
                                                   planes_per_chunk, rgb_bf16, bg_bf16,
                                                   alpha_bf16, act, alpha_full);
  return static_cast<int>(cudaGetLastError());
}
