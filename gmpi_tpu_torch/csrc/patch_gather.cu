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
// for 4-byte (f32) or 2-byte (bf16) elements.  Offsets are clamped into range
// before use, so the kernel never reads outside texf whatever it is handed.
//
// Bound on an H100 SXM: memory.  Every patch element is written once; the
// texels the patches cover are read (patches of one texture overlap, so the
// re-reads should come from L2).  Nothing is computed.
//
// Design.  A patch is band_x rows of band_yc contiguous elements; at 1024^2 a
// few hundred KB.  The work is cut into equal jobs: one job is a box of
// `rows` rows (one row chunk of a patch) by `box_cols` elements (one of
// `boxes` boxes across the row), numbered texture-major (patch, then row
// chunk, then box across), so the overlapping patches of one texture are in
// flight together.  Two paths, chosen by the caller by shape
// (ops/patch_gather.py:launch_geometry):
//
// - "tma" (any shape whose row pitches and base address the Tensor Memory
//   Accelerator takes: 16-byte multiples).  A persistent grid of one-warp
//   blocks, as many as fit on the SMs, walks the jobs; one thread of a block
//   issues each job's copy as a TMA load (cp.async.bulk.tensor.3d) into a
//   ring of `stages` shared-memory stages, each completing on its mbarrier,
//   then a TMA store of the stage to `out`, and reloads a stage only once its
//   store has read it, keeping the `lag` newest stores in flight.  So each
//   block keeps stages-1-lag loads and lag+1 stores of whole boxes in flight
//   without registers or per-element instructions.  The texture is a 3-D
//   tensor map [N][wp][hpc] and `out` one of [N*T][band_x][band_yc], both
//   with the job's box; a box that runs past a patch's last row or column
//   reads texels it does not need (zeros past the texture) and its store is
//   clipped at the patch's edge by the hardware.  The TMA takes only starts
//   on 16 bytes (another innermost start faults with an illegal
//   instruction), so a box whose start is not (a bf16 patch at y_lo = 4 mod
//   8, or any unaligned start) is loaded one 16-byte word wider from the
//   boundary below it, and the warp moves it onto the stored box in shared
//   memory before the store.
// - "loop" (shapes the TMA does not take: a row pitch that is not a
//   multiple of 16 bytes, as bf16 with an odd padded height or band, or an
//   unaligned base address).  A block per (patch, row chunk); its threads
//   copy each row with four independent 16-byte loads ahead of their stores
//   where a row's source and destination are 16-byte aligned, else element
//   by element, four at a time.
//
// Nothing of the TPU kernel's shape carries over: not its tile alignment of
// the starts (and the band slack that pays for it), its two DMAs in flight,
// its patches per grid step or its scalar-memory offset block.

#include <cuda.h>  // CUtensorMap and the encoder's types only: no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTmaThreads = 32;    // one warp; its first thread issues every copy
constexpr int kLoopThreads = 256;
constexpr int kMaxStages = 8;
constexpr int kAlign = 128;        // TMA's shared-memory alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of parity `parity` of the mbarrier at `bar` to complete.
// A copy that never completes traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

struct Job {
  long long patch;
  int row0, col0;
};

// Move a box loaded from below an unaligned start onto the box as stored, in
// place: `rows` rows of `wide` bytes whose data starts `shift` bytes in become
// rows of `narrow` (= wide - 16) bytes, in W-sized words, by one warp.  Each
// row's target ends before the next row's source begins, so groups of kRows
// rows are read into registers and then written, in order.
template <typename W>
__device__ __forceinline__ void shift_in_place(uint32_t stage, int rows, int narrow, int shift,
                                               int lane) {
  constexpr int kRows = 4;
  constexpr int kWords = sizeof(W) == 8 ? 4 : 8;  // a lane's words of a row: <= 1008 B, or
                                                  // <= 496 B for 2-byte words (bf16 only)
  const int words = narrow / (int)sizeof(W), wide = narrow + 16;
  unsigned char* p = reinterpret_cast<unsigned char*>(__cvta_shared_to_generic(stage));
  for (int r = 0; r < rows; r += kRows) {
    W v[kRows][kWords];
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const W* src = reinterpret_cast<const W*>(p + (r + g) * wide + shift);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        if (r + g < rows && lane + 32 * i < words) v[g][i] = src[lane + 32 * i];
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      W* dst = reinterpret_cast<W*>(p + (r + g) * narrow);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        if (r + g < rows && lane + 32 * i < words) dst[lane + 32 * i] = v[g][i];
    }
    __syncwarp();
  }
}

// cp.async.bulk.wait_group.read with the count as an immediate: the bulk
// store groups but the newest `lag` have read their shared memory
__device__ __forceinline__ void wait_stores_read(int lag) {
  switch (lag) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.bulk.wait_group.read 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.bulk.wait_group.read 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.bulk.wait_group.read 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 6;\n" ::: "memory"); break;
  }
}

__global__ void __launch_bounds__(kTmaThreads) patch_gather_tma(
    const __grid_constant__ CUtensorMap tex_map, const __grid_constant__ CUtensorMap wide_map,
    const __grid_constant__ CUtensorMap out_map, const int* __restrict__ offs, long long n_jobs,
    int n_tiles, int wp, int hpc, int band_x, int band_yc, int rows, int box_cols, int boxes,
    int per_patch, int stages, int lag, int elem_size, int stage_stride) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int vec = 16 / elem_size;  // elements of the TMA's 16-byte start alignment
  const int narrow = box_cols * elem_size;  // bytes of a box row as stored
  // the mbarriers, then the stages, from the first 128-byte boundary
  const uint32_t base = (smem_u32(smem_raw) + kAlign - 1) & ~uint32_t(kAlign - 1);
  const uint32_t bars = base, buf0 = base + kAlign;
  if (lane == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();

  const uint64_t tex_desc = reinterpret_cast<uint64_t>(&tex_map);
  const uint64_t wide_desc = reinterpret_cast<uint64_t>(&wide_map);
  const uint64_t out_desc = reinterpret_cast<uint64_t>(&out_map);
  const long long first = blockIdx.x, step = gridDim.x;
  const long long mine = first < n_jobs ? (n_jobs - 1 - first) / step + 1 : 0;
  auto job_of = [&](long long k) {
    const long long j = first + k * step;
    Job jb;
    jb.patch = j / per_patch;
    const int rem = static_cast<int>(j - jb.patch * per_patch);
    const int chunk = rem / boxes;
    jb.row0 = chunk * rows;
    jb.col0 = (rem - chunk * boxes) * box_cols;
    return jb;
  };
  // the clamped start of the patch last loaded and of the patch last stored
  long long load_patch = -1, store_patch = -1;
  int x_lo = 0, y_lo = 0, y_store = 0;
  auto load = [&](long long k) {  // lane 0
    const Job jb = job_of(k);
    if (jb.patch != load_patch) {
      load_patch = jb.patch;
      x_lo = min(max(offs[2 * jb.patch], 0), wp - band_x);
      y_lo = min(max(offs[2 * jb.patch + 1], 0), hpc - band_yc);
    }
    const int s = static_cast<int>(k % stages);
    const uint32_t bar = bars + 8 * s;
    const int n = static_cast<int>(jb.patch / n_tiles);
    // a start that is not 16-byte aligned is loaded from the boundary below
    // it, one 16-byte word wider
    const int y = y_lo + jb.col0, m = y % vec;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(rows * (m == 0 ? narrow : narrow + 16))
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(buf0 + s * stage_stride),
        "l"(m == 0 ? tex_desc : wide_desc), "r"(bar), "r"(y - m), "r"(x_lo + jb.row0), "r"(n)
        : "memory");
  };

  long long issued = 0;
  if (lane == 0)
    for (; issued < mine && issued < stages; ++issued) load(issued);
  for (long long k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % stages);
    const uint32_t stage = buf0 + s * stage_stride;
    mbar_wait(bars + 8 * s, static_cast<uint32_t>((k / stages) & 1));
    const Job jb = job_of(k);
    if (jb.patch != store_patch) {
      store_patch = jb.patch;
      y_store = min(max(offs[2 * jb.patch + 1], 0), hpc - band_yc);
    }
    const int shift = ((y_store + jb.col0) % vec) * elem_size;
    if (shift != 0) {  // the warp moves the wide box onto the box as stored
      if (shift % 8 == 0)
        shift_in_place<uint2>(stage, rows, narrow, shift, lane);
      else if (shift % 4 == 0)
        shift_in_place<uint32_t>(stage, rows, narrow, shift, lane);
      else
        shift_in_place<uint16_t>(stage, rows, narrow, shift, lane);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
    }
    if (lane == 0) {
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
          ::"l"(out_desc), "r"(stage), "r"(jb.col0), "r"(jb.row0),
          "r"(static_cast<int>(jb.patch))
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // refill the stage whose store was committed `lag` jobs ago, once that
      // store has read it; the `lag` newer stores stay in flight
      if (k >= lag && issued < mine) {
        wait_stores_read(lag);
        load(issued++);
      }
    }
    __syncwarp();
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kLoopThreads) patch_gather_loop(
    const T* __restrict__ texf, const int* __restrict__ offs, T* __restrict__ out, int n_tiles,
    int wp, int hpc, int band_x, int band_yc, int rows) {
  const long long patch = blockIdx.x;  // n * n_tiles + t
  const long long n = patch / n_tiles;
  const int x_lo = min(max(offs[2 * patch], 0), wp - band_x);
  const int y_lo = min(max(offs[2 * patch + 1], 0), hpc - band_yc);
  const int r0 = blockIdx.y * rows, r1 = min(r0 + rows, band_x);
  constexpr int kVec = 16 / sizeof(T);
  for (int r = r0; r < r1; ++r) {
    const T* src = texf + (n * wp + x_lo + r) * (long long)hpc + y_lo;
    T* dst = out + (patch * band_x + r) * (long long)band_yc;
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
        band_yc % kVec == 0) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
      uint4* d = reinterpret_cast<uint4*>(dst);
      const int m = band_yc / kVec;
      int c = threadIdx.x;
      for (; c + 3 * kLoopThreads < m; c += 4 * kLoopThreads) {
        const uint4 a = s[c], b = s[c + kLoopThreads], e = s[c + 2 * kLoopThreads],
                    f = s[c + 3 * kLoopThreads];
        d[c] = a, d[c + kLoopThreads] = b, d[c + 2 * kLoopThreads] = e,
        d[c + 3 * kLoopThreads] = f;
      }
      for (; c < m; c += kLoopThreads) d[c] = s[c];
    } else {
      int c = threadIdx.x;
      for (; c + 3 * kLoopThreads < band_yc; c += 4 * kLoopThreads) {
        const T a = src[c], b = src[c + kLoopThreads], e = src[c + 2 * kLoopThreads],
                f = src[c + 3 * kLoopThreads];
        dst[c] = a, dst[c + kLoopThreads] = b, dst[c + 2 * kLoopThreads] = e,
        dst[c + 3 * kLoopThreads] = f;
      }
      for (; c < band_yc; c += kLoopThreads) dst[c] = src[c];
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers of contiguous
// tensors the caller allocated: texf [N, wp, hpc] of elem_size-byte elements
// (4 or 2); offs [N, n_tiles, 2] int32 = (x_lo, y_lo); out
// [N, n_tiles, band_x, band_yc] of the same element type.  band_x <= wp and
// band_yc <= hpc.  The launch geometry comes from the caller
// (ops/patch_gather.py:launch_geometry): jobs of `rows` rows, `chunks` of
// them a patch; with stages > 0 the TMA path, `boxes` boxes of `box_cols`
// elements across a row through `stages` (2 to 8) shared-memory stages with
// the `lag` (0 to stages - 2) newest stores in flight; with stages == 0 the
// loop path.  Launches on `stream` and returns cudaGetLastError() (0 on
// success; cudaErrorInvalidValue for a geometry
// that does not cover the patch, a shape the TMA path cannot take, or
// another element size), or -CUresult if a tensor map cannot be encoded;
// does not synchronize.
extern "C" int gmpi_patch_gather(const void* texf, const int* offs, void* out, int N,
                                 int n_tiles, int wp, int hpc, int band_x, int band_yc,
                                 int elem_size, int rows, int chunks, int box_cols, int boxes,
                                 int stages, int lag, void* stream) {
  const long long patches = (long long)N * n_tiles;
  if (patches <= 0 || patches > 2147483647LL || (elem_size != 4 && elem_size != 2) ||
      rows < 1 || chunks < 1 || (long long)rows * chunks < band_x ||
      (long long)rows * (chunks - 1) >= band_x)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages == 0) {
    if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((unsigned)patches, (unsigned)chunks, 1);
    if (elem_size == 4)
      patch_gather_loop<uint32_t><<<grid, kLoopThreads, 0, st>>>(
          static_cast<const uint32_t*>(texf), offs, static_cast<uint32_t*>(out), n_tiles, wp, hpc,
          band_x, band_yc, rows);
    else
      patch_gather_loop<uint16_t><<<grid, kLoopThreads, 0, st>>>(
          static_cast<const uint16_t*>(texf), offs, static_cast<uint16_t*>(out), n_tiles, wp, hpc,
          band_x, band_yc, rows);
    return static_cast<int>(cudaGetLastError());
  }

  // the TMA's rules: 16-byte base and pitches, boxes of at most 256 elements a
  // side whose rows are 16-byte multiples (and one 16-byte word more, for a
  // box loaded from below an unaligned start)
  const long long narrow = (long long)box_cols * elem_size;
  if (stages < 2 || stages > kMaxStages || lag < 0 || lag > stages - 2 || rows > 256 ||
      box_cols < 1 || narrow + 16 > 256LL * elem_size || narrow % 16 || boxes < 1 ||
      (long long)box_cols * boxes < band_yc || (long long)box_cols * (boxes - 1) >= band_yc ||
      reinterpret_cast<uintptr_t>(texf) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      ((long long)hpc * elem_size) % 16 || ((long long)band_yc * elem_size) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stage_stride = static_cast<int>(((narrow + 16) * rows + kAlign - 1) / kAlign * kAlign);
  const size_t smem = 2 * kAlign + (size_t)stages * stage_stride;  // barriers, alignment slack

  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CUtensorMapDataType type =
      elem_size == 4 ? CU_TENSOR_MAP_DATA_TYPE_UINT32 : CU_TENSOR_MAP_DATA_TYPE_UINT16;
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1};
  const cuuint32_t wide_box[3] = {(cuuint32_t)(box_cols + 16 / elem_size), (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap tex_map, wide_map, out_map;
  const cuuint64_t tex_dim[3] = {(cuuint64_t)hpc, (cuuint64_t)wp, (cuuint64_t)N};
  const cuuint64_t tex_pitch[2] = {(cuuint64_t)hpc * elem_size,
                                   (cuuint64_t)hpc * elem_size * wp};
  CUresult res = encode(&tex_map, type, 3, const_cast<void*>(texf), tex_dim, tex_pitch, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  res = encode(&wide_map, type, 3, const_cast<void*>(texf), tex_dim, tex_pitch, wide_box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const cuuint64_t out_dim[3] = {(cuuint64_t)band_yc, (cuuint64_t)band_x, (cuuint64_t)patches};
  const cuuint64_t out_pitch[2] = {(cuuint64_t)band_yc * elem_size,
                                   (cuuint64_t)band_yc * elem_size * band_x};
  res = encode(&out_map, type, 3, out, out_dim, out_pitch, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);

  // the SM count and the blocks an SM holds at this shared memory, asked once
  // a (device, size): the queries cost more host time than the encodes
  static thread_local int last_device = -1, sms = 0, per_sm = 0;
  static thread_local size_t last_smem = 0;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if (device != last_device || smem != last_smem) {
    last_device = -1;
    if ((err = cudaFuncSetAttribute(patch_gather_tma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, patch_gather_tma,
                                                             kTmaThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    last_device = device, last_smem = smem;
  }
  const long long jobs = patches * chunks * boxes;
  const long long blocks = jobs < (long long)sms * per_sm ? jobs : (long long)sms * per_sm;
  patch_gather_tma<<<(unsigned)blocks, kTmaThreads, smem, st>>>(
      tex_map, wide_map, out_map, offs, jobs, n_tiles, wp, hpc, band_x, band_yc, rows, box_cols,
      boxes, chunks * boxes, stages, lag, elem_size, stage_stride);
  return static_cast<int>(cudaGetLastError());
}
