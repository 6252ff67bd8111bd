// gp_rows.cu — the value and Jacobian of a bank of Gaussian-process
// emulators (one GP per band) at every pixel in one CUDA kernel, written
// in the row layout of the fused update.
//
// Replaces no Pallas kernel: the JAX package leaves the GP bank's
// linearisation to jax.jacfwd under XLA (kafka_tpu/obsops/protocol.py,
// over kafka_tpu/obsops/gp.py:GPBankOperator).  The port ran it eagerly
// as torch.func.vmap(jacfwd(forward_pixel)) in 262,144-px blocks, then
// relaid the (B, n, p) Jacobian to rows (core/fused_update.py:
// jac_to_rows).  Under jacfwd the tangent of (x_train - x*) / ell is a
// (block, p, m, k) tensor: at m = 250 training points, k = 10 inputs and
// 10 bands that is tens of GB a block.  This kernel is one launch per
// Gauss-Newton trip over the whole batch.
//
// Per pixel, band b (its GP: training inputs X (m, k), weights alpha
// (m), log lengthscales (k), log amplitude, target mean y_mean) and its
// state mapper map_b (k indices into the p state entries):
//
//     x*_d          = x[map_b[d]]
//     e_i           = exp(-1/2 sum_d ((x*_d - X_id) / ell_d)^2)
//     h0[b]         = amp * sum_i alpha_i e_i + y_mean
//     dh0[b]/dx*_d  = -amp * sum_i alpha_i e_i (x*_d - X_id) / ell_d^2
//     jac[b*p + j]  = sum over d with map_b[d] == j of dh0[b]/dx*_d
//
// gp_emulator's GaussianProcess.predict(..., do_deriv) in closed form,
// in the layout core/fused_update.py:jac_to_rows produces.
//
// What bounds it on an H100: operations.  A pixel reads p floats and
// writes bands * (p + 1); each (pixel, band, training point) costs k
// subtractions, k fused multiply-adds for the squared distance, one
// exponential, two products and a sum, and k fused multiply-adds for the
// gradient.  The design:
//
// - One thread, PX pixels.  The band's training inputs and weights are
//   staged in shared memory, tiled over m (kTile points a tile), and read
//   as broadcasts: every thread of the block reads the same point at
//   once, as float4s, and uses it for each of its PX pixels.
// - Direct differences.  Inputs and training inputs are scaled once
//   (a band's inputs at its start, its training points as they are
//   staged) by c / ell_d (c = sqrt(log2(e) / 2)), so that
//   e_i = exp2(-sum_d d_d^2)
//   with d_d = x*_d - X_id of the scaled values: k subtractions and k
//   fused multiply-adds.  The expansion |x|^2 + |X|^2 - 2 x.X would save
//   the subtractions but cancels in float32 where x* lies near a
//   training point, which is where the weights are largest.
// - Two-level sums.  The weights alpha_i e_i alternate in sign and
//   cancel: a running float32 sum over m points would be about twice as
//   far off float64 as the plain version's tree reduction.  So each
//   group of kGroup points is summed apart and then added to the
//   total, which keeps the kernel as close to float64 as the plain
//   version (its gate in chip_smoke.py) for k + 1 additions a group.
// - Every training point of every band is evaluated; nothing is skipped
//   for a small kernel value.  float32 throughout, no tensor cores.
// - k is a template parameter (1..16), so the pixel's inputs and its
//   gradient accumulators live in registers; bands (<= 32), m and p are
//   runtime sizes.  The mapper is an index table on the device (the
//   identity where the operator has none).
//
// The arithmetic is plain C++ (gp_point, stage_tile, write_band):
// compiled without nvcc it is the same on the host (kafka_gp_rows_host),
// which the CPU tests hold against the plain version.

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KAFKA_HD __host__ __device__ __forceinline__
#else
#define KAFKA_HD inline
#endif

namespace {

constexpr int kMaxInputs = 16;
constexpr int kMaxBands = 32;
constexpr int kGroup = 8;     // points a partial sum
// sqrt(log2(e) / 2): exp(-s / 2) == exp2(-s * kScale^2).
constexpr float kScale = 0.84932180028801904272f;
// log2(e) / 2 = kScale^2: a scaled difference d is c (x - X) / ell, so
// the gradient's (x - X) / ell^2 is (c / ell) d / c^2.
constexpr float kScaleSq = 0.72134752044448170368f;

// Padded row width of a staged training point: k inputs and alpha,
// rounded up to whole float4s.
template <int K>
struct Row {
  static constexpr int kWidth = ((K + 1 + 3) / 4) * 4;
};

// One staged point r (its k scaled inputs, then alpha) against one
// pixel's scaled inputs xs: adds alpha e to acc and alpha e d_d to g_d.
template <int K>
KAFKA_HD void gp_point(const float* r, const float* xs, float& acc,
                       float* g) {
  float d[K];
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    d[c] = xs[c] - r[c];
    s = fmaf(d[c], d[c], s);
  }
  const float w = r[K] * exp2f(-s);
  acc += w;
#pragma unroll
  for (int c = 0; c < K; ++c) g[c] = fmaf(w, d[c], g[c]);
}

// Input d's scale factor c / ell_d of band b.  Recomputed where it is
// needed (at the band's start, in staging, in the write), so no scale
// stays live in registers across the points.
template <int K>
KAFKA_HD float input_scale(const float* log_ell, int b, int c) {
  return kScale * expf(-log_ell[b * K + c]);
}

// Adds a group's partial sums (pa, pg) to the totals and clears them.
template <int K>
KAFKA_HD void fold_group(float& pa, float* pg, float& acc, float* g) {
  acc += pa;
  pa = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    g[c] += pg[c];
    pg[c] = 0.0f;
  }
}

// Stage points [i0, i0 + count) of band b, scaled, into `tile`
// (entries `first`, `first + stride`, ... of the count * W floats).
template <int K>
KAFKA_HD void stage_tile(const float* x_train, const float* alpha, int m,
                         int b, int i0, int count, const float* log_ell,
                         float* tile, int first, int stride) {
  constexpr int W = Row<K>::kWidth;
  for (int e = first; e < count * W; e += stride) {
    const int i = e / W, c = e - i * W;
    const long long pt = (long long)b * m + i0 + i;
    float v = 0.0f;
    if (c < K) {
      v = x_train[pt * K + c] * input_scale<K>(log_ell, b, c);
    } else if (c == K) {
      v = alpha[pt];
    }
    tile[e] = v;
  }
}

// Write pixel px's band-b value and its p Jacobian rows.
template <int K>
KAFKA_HD void write_band(const int* map_b, int b, int p,
                         const float* log_ell, const float* log_amp,
                         float y_mean, float acc, const float* g, float* h0,
                         float* jac, long long n, long long px) {
  const float amp = expf(log_amp[b]);
  h0[(long long)b * n + px] = fmaf(amp, acc, y_mean);
  float grad[K];
#pragma unroll
  for (int c = 0; c < K; ++c)
    grad[c] = -amp * (input_scale<K>(log_ell, b, c) * g[c]) / kScaleSq;
  float* jb = jac + (long long)b * p * n + px;
  for (int j = 0; j < p; ++j) {
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < K; ++c) v += map_b[c] == j ? grad[c] : 0.0f;
    jb[(long long)j * n] = v;
  }
}

// Calls F<K>(args...) for the runtime k in 1..16; -1 for any other k.
#define KAFKA_GP_DISPATCH(F, k, ...)                                      \
  switch (k) {                                                            \
    case 1: return F<1>(__VA_ARGS__);                                     \
    case 2: return F<2>(__VA_ARGS__);                                     \
    case 3: return F<3>(__VA_ARGS__);                                     \
    case 4: return F<4>(__VA_ARGS__);                                     \
    case 5: return F<5>(__VA_ARGS__);                                     \
    case 6: return F<6>(__VA_ARGS__);                                     \
    case 7: return F<7>(__VA_ARGS__);                                     \
    case 8: return F<8>(__VA_ARGS__);                                     \
    case 9: return F<9>(__VA_ARGS__);                                     \
    case 10: return F<10>(__VA_ARGS__);                                   \
    case 11: return F<11>(__VA_ARGS__);                                   \
    case 12: return F<12>(__VA_ARGS__);                                   \
    case 13: return F<13>(__VA_ARGS__);                                   \
    case 14: return F<14>(__VA_ARGS__);                                   \
    case 15: return F<15>(__VA_ARGS__);                                   \
    case 16: return F<16>(__VA_ARGS__);                                   \
    default: return -1;                                                   \
  }

#ifdef __CUDACC__

constexpr int kThreads = 128;
constexpr int kPx = 2;        // pixels a thread
constexpr int kTile = 256;    // training points a staged tile
static_assert(kTile % kGroup == 0, "a tile holds whole groups");

template <int K>
__global__ void __launch_bounds__(kThreads) gp_rows_kernel(
    const float* __restrict__ x, int p, const float* __restrict__ x_train,
    const float* __restrict__ alpha, const float* __restrict__ log_ell,
    const float* __restrict__ log_amp, const float* __restrict__ y_mean,
    const int* __restrict__ mappers, int bands, int m,
    float* __restrict__ h0, float* __restrict__ jac, long long n) {
  constexpr int W = Row<K>::kWidth;
  __shared__ __align__(16) float tile[kTile * W];
  __shared__ int map_s[kMaxBands * K];
  for (int e = threadIdx.x; e < bands * K; e += kThreads)
    map_s[e] = mappers[e];
  __syncthreads();
  const long long base = (long long)blockIdx.x * (kThreads * kPx)
      + threadIdx.x;
  long long px[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    // Pixels past the end compute on the last pixel and store nothing.
    const long long at = base + (long long)q * kThreads;
    px[q] = at < n ? at : n - 1;
  }
  for (int b = 0; b < bands; ++b) {
    const int* map_b = map_s + b * K;
    float xs[kPx][K], g[kPx][K], acc[kPx], pg[kPx][K], pa[kPx];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float scale = input_scale<K>(log_ell, b, c);
#pragma unroll
      for (int q = 0; q < kPx; ++q) {
        xs[q][c] = x[(long long)map_b[c] * n + px[q]] * scale;
        g[q][c] = pg[q][c] = 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kPx; ++q) acc[q] = pa[q] = 0.0f;
    for (int i0 = 0; i0 < m; i0 += kTile) {
      const int count = m - i0 < kTile ? m - i0 : kTile;
      __syncthreads();
      stage_tile<K>(x_train, alpha, m, b, i0, count, log_ell, tile,
                    threadIdx.x, kThreads);
      __syncthreads();
      for (int g0 = 0; g0 < count; g0 += kGroup) {
        const int end = count - g0 < kGroup ? count : g0 + kGroup;
        for (int i = g0; i < end; ++i) {
          float r[W];
          const float4* row4 =
              reinterpret_cast<const float4*>(tile + i * W);
#pragma unroll
          for (int v = 0; v < W / 4; ++v) {
            const float4 t = row4[v];
            r[4 * v] = t.x;
            r[4 * v + 1] = t.y;
            r[4 * v + 2] = t.z;
            r[4 * v + 3] = t.w;
          }
#pragma unroll
          for (int q = 0; q < kPx; ++q)
            gp_point<K>(r, xs[q], pa[q], pg[q]);
        }
#pragma unroll
        for (int q = 0; q < kPx; ++q)
          fold_group<K>(pa[q], pg[q], acc[q], g[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPx; ++q) {
      if (base + (long long)q * kThreads < n)
        write_band<K>(map_b, b, p, log_ell, log_amp, y_mean[b], acc[q], g[q],
                      h0, jac, n, px[q]);
    }
  }
}

template <int K>
int launch_k(const float* x, int p, const float* x_train,
             const float* alpha, const float* log_ell, const float* log_amp,
             const float* y_mean, const int* mappers, int bands, int m,
             float* h0, float* jac, long long n, cudaStream_t stream) {
  const long long per_block = kThreads * kPx;
  const long long blocks = (n + per_block - 1) / per_block;
  gp_rows_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, p, x_train, alpha, log_ell, log_amp, y_mean, mappers, bands, m,
      h0, jac, n);
  return (int)cudaGetLastError();
}

template <int K>
int attributes_k(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gp_rows_kernel<K>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kThreads;
  return 0;
}

#else

// The kernel's arithmetic on the host, pixel after pixel, one tile of
// kHostTile points at a time (the order of the card's sums).
constexpr int kHostTile = 256;

template <int K>
int host_k(const float* x, int p, const float* x_train, const float* alpha,
           const float* log_ell, const float* log_amp, const float* y_mean,
           const int* mappers, int bands, int m, float* h0, float* jac,
           long long n) {
  constexpr int W = Row<K>::kWidth;
  static float tile[kHostTile * W];
  for (int b = 0; b < bands; ++b) {
    const int* map_b = mappers + b * K;
    for (long long px = 0; px < n; ++px) {
      float xs[K], g[K], acc = 0.0f, pg[K], pa = 0.0f;
      for (int c = 0; c < K; ++c) {
        xs[c] = x[(long long)map_b[c] * n + px]
            * input_scale<K>(log_ell, b, c);
        g[c] = pg[c] = 0.0f;
      }
      for (int i0 = 0; i0 < m; i0 += kHostTile) {
        const int count = m - i0 < kHostTile ? m - i0 : kHostTile;
        stage_tile<K>(x_train, alpha, m, b, i0, count, log_ell, tile, 0,
                      1);
        for (int g0 = 0; g0 < count; g0 += kGroup) {
          const int end = count - g0 < kGroup ? count : g0 + kGroup;
          for (int i = g0; i < end; ++i)
            gp_point<K>(tile + i * W, xs, pa, pg);
          fold_group<K>(pa, pg, acc, g);
        }
      }
      write_band<K>(map_b, b, p, log_ell, log_amp, y_mean[b], acc, g, h0, jac,
                    n, px);
    }
  }
  return 0;
}

#endif

int check_sizes(int p, int bands, int m, int k, long long n) {
  if (k < 1 || k > kMaxInputs || bands < 1 || bands > kMaxBands || m < 1 ||
      p < 1 || n < 0)
    return -1;
  return 0;
}

}  // namespace

extern "C" {

#ifdef __CUDACC__

// Launch on `stream`: x (p, n) float32 rows; the bank's x_train (bands,
// m, k), alpha (bands, m), log_lengthscales (bands, k), log_amplitude
// and y_mean (bands,), all float32, and mappers (bands, k) int32, each a
// contiguous device array; outputs h0 (bands, n) and jac (bands * p, n).
// Returns the CUDA error code of the launch (0 on success), or -1 for
// sizes outside k in 1..16, bands in 1..32.
int kafka_gp_rows(const float* x, int p, const float* x_train,
                  const float* alpha, const float* log_ell,
                  const float* log_amp, const float* y_mean,
                  const int* mappers, int bands, int m, int k, float* h0,
                  float* jac, long long n, void* stream) {
  if (check_sizes(p, bands, m, k, n) != 0) return -1;
  if (n == 0) return 0;
  KAFKA_GP_DISPATCH(launch_k, k, x, p, x_train, alpha, log_ell, log_amp,
                    y_mean, mappers, bands, m, h0, jac, n,
                    (cudaStream_t)stream)
}

// Registers, local bytes, static shared bytes and threads per block of
// the instance for k inputs.
int kafka_gp_rows_attributes(int k, int* out) {
  KAFKA_GP_DISPATCH(attributes_k, k, out)
}

const char* kafka_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#else

// The same arithmetic on the host (the CPU tests' build of this file):
// the arguments of kafka_gp_rows, host pointers, no stream.
int kafka_gp_rows_host(const float* x, int p, const float* x_train,
                       const float* alpha, const float* log_ell,
                       const float* log_amp, const float* y_mean,
                       const int* mappers, int bands, int m, int k,
                       float* h0, float* jac, long long n) {
  if (check_sizes(p, bands, m, k, n) != 0) return -1;
  KAFKA_GP_DISPATCH(host_k, k, x, p, x_train, alpha, log_ell, log_amp,
                    y_mean, mappers, bands, m, h0, jac, n)
}

#endif

}  // extern "C"
