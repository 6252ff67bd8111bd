// solve_rows.cu — packed Cholesky factor and forward/back substitution per
// pixel as one CUDA kernel: persistent CTAs, a shared-memory ring fed by
// a producer warpgroup, consumer warpgroups that factor and solve.
//
// Replaces the Pallas TPU kernel kafka_tpu/core/pallas_solve.py:
// _solve_kernel (:72-93, driven by solve_rows :96-121 and
// solve_spd_packed_pallas :616-630): x = A^-1 b for n independent SPD
// p x p systems, A as packed lower-triangle rows (tri(p), n), b and x as
// (p, n) rows.
//
// What bounds it on an H100: bytes.  A pixel reads tri(p) + p floats and
// writes p (75 floats, 300 B at p = 10) against about 0.6 kFLOP of
// float32 arithmetic, far under the operations-per-byte balance.  But
// each pixel's factor is one long serial chain (p IEEE square roots, p
// reciprocals, 2p divisions), and a design in which every thread loads
// its own column, factors, then stores, keeps no bytes in flight while
// its warps walk that chain: it waits on load latency once per wave.
//
// What the ring does about it.  One CTA per SM walks the pixel tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...  Its last warpgroup is the
// producer: it keeps Config<P>::kStages tiles of coefficients in flight
// into a ring in shared memory, so HBM streams while the consumers
// compute.  On the TMA route one thread issues two 2-D tensor copies
// (cp.async.bulk.tensor: A rows and b rows, box 128 px wide) per 128-px
// chunk and arms the stage's full mbarrier with the bytes to expect; the
// copies cost the consumers no registers and no instructions, and TMA
// zero-fills a ragged last tile.  A tensor map needs 16-byte aligned
// bases and a row pitch n * 4 that is a multiple of 16, so for any other
// n or base the same kernel fills the same ring with 4-byte cp.async
// copies: producer thread t copies column t of every chunk (zero-filled
// past n) and hands their completion to the full mbarrier with
// cp.async.mbarrier.arrive.noinc.  Consumer warpgroup g takes chunk g of
// the tile, one pixel per thread: thread t reads row r of its column at
// chunk[r * 128 + t % 128] (bank-conflict free, no swizzle), releases
// the stage on its empty mbarrier as soon as its column sits in
// registers, then factors and solves with packed_chol.cuh (the fused
// update's code, unchanged) and stores its p outputs coalesced.  Pixels
// past n are never written.  Built with -fmad=false, as the plain
// version rounds: the arithmetic, and so every bit of x, is that of the
// one-thread-per-pixel design.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "packed_chol.cuh"

namespace {

using kafka::tri;

// Pixels per consumer warpgroup and per TMA box (the box's inner
// extent); also the producer warpgroup's threads.
constexpr int kChunk = 128;
// Dynamic shared memory ahead of the ring: the full and empty mbarriers.
constexpr int kBarrierBytes = 128;

// Per instance: consumer warpgroups (128-px chunks per tile) and ring
// stages.  core/solve_rows.py:GEOMETRY mirrors this table.
template <int P>
struct Config;
template <>
struct Config<2> {
  static constexpr int kGroups = 4, kStages = 8;
};
template <>
struct Config<7> {
  static constexpr int kGroups = 4, kStages = 3;
};
template <>
struct Config<10> {
  static constexpr int kGroups = 2, kStages = 3;
};

template <int P>
struct Ring {
  static constexpr int kTri = tri(P);
  static constexpr int kRows = kTri + P;  // floats per pixel read
  static constexpr int kGroups = Config<P>::kGroups;
  static constexpr int kStages = Config<P>::kStages;
  static constexpr int kTile = kGroups * kChunk;
  static constexpr int kConsumerWarps = 4 * kGroups;
  static constexpr int kThreads = 32 * kConsumerWarps + kChunk;
  static constexpr int kChunkFloats = kRows * kChunk;
  static constexpr int kStageFloats = kGroups * kChunkFloats;
  static constexpr int kSmemBytes = kBarrierBytes + kStages * kStageFloats * 4;
  static_assert(2 * kStages * 8 <= kBarrierBytes, "barriers overflow");
  static_assert(kSmemBytes <= 232448, "ring exceeds a CTA's shared memory");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA route, one thread: the valid chunks of `tile` (those starting below
// n) into `stage`, A rows then b rows per chunk, counted on `full`.
template <int P>
__device__ __forceinline__ void fill_tma(const CUtensorMap* map_a,
                                         const CUtensorMap* map_b,
                                         float* stage, unsigned full,
                                         long long tile, long long n) {
  using R = Ring<P>;
  const long long x0 = tile * R::kTile;
  const int chunks = (int)min((long long)R::kGroups,
                              (n - x0 + kChunk - 1) / kChunk);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(full), "r"(chunks * R::kChunkFloats * 4)
               : "memory");
  for (int c = 0; c < chunks; ++c) {
    const int col = (int)(x0 + c * kChunk);
    float* dst = stage + c * R::kChunkFloats;
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(smem_addr(dst)), "l"((uint64_t)map_a), "r"(col), "r"(0),
        "r"(full)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(smem_addr(dst + R::kTri * kChunk)), "l"((uint64_t)map_b),
        "r"(col), "r"(0), "r"(full)
        : "memory");
  }
}

// cp.async route, producer thread `t` of kChunk: column t of every chunk
// of `tile` into `stage`, one 4-byte copy per row (zero-filled past n),
// then this thread's arrival on `full` once its copies have landed.
template <int P>
__device__ __forceinline__ void fill_cp_async(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              float* stage, unsigned full,
                                              long long tile, long long n,
                                              int t) {
  using R = Ring<P>;
#pragma unroll 1
  for (int c = 0; c < R::kGroups; ++c) {
    const long long px = tile * R::kTile + c * kChunk + t;
    const long long at = px < n ? px : 0;
    const unsigned bytes = px < n ? 4 : 0;
    unsigned dst = smem_addr(stage + c * R::kChunkFloats + t);
    const float* src = a + at;
#pragma unroll
    for (int r = 0; r < R::kRows; ++r) {
      if (r == R::kTri) src = b + at;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   ::"r"(dst), "l"(src), "r"(bytes)
                   : "memory");
      dst += kChunk * 4;
      src += n;
    }
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(full)
               : "memory");
}

template <int P>
__global__ void __launch_bounds__(Ring<P>::kThreads, 1) solve_rows_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ a_rows, const float* __restrict__ b_rows,
    float* __restrict__ x_out, long long n, int use_tma) {
  using R = Ring<P>;
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned full0 = smem_addr(smem);
  const unsigned empty0 = full0 + R::kStages * 8;
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
  const long long tiles = (n + R::kTile - 1) / R::kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full0 + 8 * s, use_tma ? 1 : kChunk);
      mbar_init(empty0 + 8 * s, R::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  unsigned phase = 0;
  if (warp >= R::kConsumerWarps) {
    // Producer (one thread on the TMA route, the warpgroup on the
    // cp.async route): wait until the consumers have released the stage
    // (the first pass through the ring finds every stage free), then
    // fill it.
    const int t = threadIdx.x - 32 * R::kConsumerWarps;
    if (use_tma && t != 0) return;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      float* dst = ring + stage * R::kStageFloats;
      if (use_tma) {
        fill_tma<P>(&map_a, &map_b, dst, full0 + 8 * stage, tile, n);
      } else {
        fill_cp_async<P>(a_rows, b_rows, dst, full0 + 8 * stage, tile, n, t);
      }
      if (++stage == R::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // Consumers: thread t owns pixel tile * kTile + t, in chunk t / 128.
  const int off = (threadIdx.x >> 7) * R::kChunkFloats + (threadIdx.x & 127);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    mbar_wait(full0 + 8 * stage, phase);
    const float* col = ring + stage * R::kStageFloats + off;
    float a[R::kTri];
#pragma unroll
    for (int r = 0; r < R::kTri; ++r) a[r] = col[r * kChunk];
    float b[P];
#pragma unroll
    for (int k = 0; k < P; ++k) b[k] = col[(R::kTri + k) * kChunk];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    const long long px = tile * R::kTile + threadIdx.x;
    if (px < n) {
      kafka::cholesky_packed<P>(a);
      float x[P];
      kafka::solve_chol<P>(a, b, x);
#pragma unroll
      for (int k = 0; k < P; ++k) x_out[k * n + px] = x[k];
    }
    if (++stage == R::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (no -lcuda;
// cudaGetDriverEntryPointByVersion needs CUDA 12.5 or later).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || sym == nullptr)
      return cudaErrorSymbolNotFound;
    cached = (EncodeTiled)sym;
  }
  *fn = cached;
  return cudaSuccess;
}

// A 2-D map over the row-major (rows, n) float32 array at `base`, boxes
// of `rows` x kChunk, zero fill out of bounds.
cudaError_t row_map(CUtensorMap* map, const float* base, int rows,
                    long long n) {
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)n * sizeof(float)};
  const cuuint32_t box[2] = {kChunk, (cuuint32_t)rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)base, dims, pitch, box,
      step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of the last kMapCache arrays launched on.  A map is a pure
// function of (base, rows, n), and encoding one costs about 10 us of
// host time, more than the kernel at small n.
constexpr int kMapCache = 16;
struct CachedMap {
  const float* base;
  int rows;
  long long n;
  CUtensorMap map;
};
std::mutex cache_lock;
CachedMap map_cache[kMapCache];
int map_next = 0;

cudaError_t cached_row_map(CUtensorMap* map, const float* base, int rows,
                           long long n) {
  std::lock_guard<std::mutex> hold(cache_lock);
  for (const CachedMap& e : map_cache) {
    if (e.base == base && e.rows == rows && e.n == n) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = row_map(map, base, rows, n);
  if (err != cudaSuccess) return err;
  map_cache[map_next] = {base, rows, n, *map};
  map_next = (map_next + 1) % kMapCache;
  return cudaSuccess;
}

// Allows the p instance its ring of dynamic shared memory, once per
// device.
template <int P>
cudaError_t allow_ring() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(cache_lock);
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(solve_rows_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<P>::kSmemBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

bool tma_ok(const float* a, const float* b, long long n) {
  return n % 4 == 0 && n <= 0x7fffffffLL && ((uintptr_t)a & 15) == 0 &&
         ((uintptr_t)b & 15) == 0;
}

template <int P>
int launch(const float* a, const float* b, float* x, long long n, int use_tma,
           int grid, cudaStream_t stream) {
  using R = Ring<P>;
  const long long tiles = (n + R::kTile - 1) / R::kTile;
  if (grid < 1 || grid > tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a = {}, map_b = {};
  if (use_tma) {
    if (!tma_ok(a, b, n)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cached_row_map(&map_a, a, R::kTri, n);
    if (err == cudaSuccess) err = cached_row_map(&map_b, b, P, n);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err = allow_ring<P>();
  if (err != cudaSuccess) return (int)err;
  solve_rows_kernel<P><<<grid, R::kThreads, R::kSmemBytes, stream>>>(
      map_a, map_b, a, b, x, n, use_tma);
  return (int)cudaGetLastError();
}

template <int P>
int attributes(long long n, int* out) {
  using R = Ring<P>;
  cudaError_t err = allow_ring<P>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, solve_rows_kernel<P>);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, solve_rows_kernel<P>, R::kThreads, R::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + R::kTile - 1) / R::kTile;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = R::kSmemBytes;
  out[4] = R::kThreads;
  out[5] = R::kConsumerWarps;
  out[6] = R::kTile;
  out[7] = R::kStages;
  out[8] = sms;
  out[9] = per_sm;
  out[10] = (int)(tiles < sms ? tiles : sms);
  return 0;
}

}  // namespace

extern "C" {

// Launch the p instance (2, 7 or 10) on `stream` with `grid` CTAs (at
// most one per tile of the instance): a (tri(p), n), b (p, n) and
// x (p, n) row-major float32 on the device.  use_tma = 1 fills the ring
// by TMA (n % 4 == 0 and a, b 16-byte aligned, else refused), 0 by
// cp.async.  Returns the CUDA error code of the launch (0 on success).
int kafka_solve_rows(int p, const float* a, const float* b, float* x,
                     long long n, int use_tma, int grid, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
    case 2: return launch<2>(a, b, x, n, use_tma, grid, s);
    case 7: return launch<7>(a, b, x, n, use_tma, grid, s);
    case 10: return launch<10>(a, b, x, n, use_tma, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The compiled p instance for n pixels on the current device: out =
// [registers per thread, local (spill) bytes per thread, static shared
// bytes, dynamic shared bytes, threads per CTA, consumer warps, tile
// (px), ring stages, SMs, CTAs one SM holds, grid (min(SMs, tiles))].
int kafka_solve_rows_attributes(int p, long long n, int* out) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  switch (p) {
    case 2: return attributes<2>(n, out);
    case 7: return attributes<7>(n, out);
    case 10: return attributes<10>(n, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kafka_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
