// fused_update.cu — one linearised Gauss-Newton update per pixel as one
// CUDA kernel.
//
// Replaces the Pallas TPU kernel kafka_tpu/core/pallas_solve.py:
// _fused_update_kernel (:124-213, driven by _fused_update_rows :216-252).
// Per pixel, from Jacobian lane rows J (B*P, n) and the linearisation
// point x_lin:
//
//     y~  = where(mask, y + J x_lin - H0, 0)
//     A   = P_f^-1 + sum_b w_b J_b J_b^T            (packed lower triangle)
//     rhs = P_f^-1 x_f + sum_b w_b y~_b J_b
//     x   = chol(A, LM-inflated diagonal) \ rhs
//
// storing the uninflated A, inn = where(mask, y - H0, 0) and hb: row 0
// Cholesky breakdown or non-finite x, row 1 non-finite x
// (solver_health.chol_breakdown / nonfinite_any).
//
// What bounds it on an H100: bytes.  At (P, B) = (10, 10) a pixel reads
// B*P + 4B + 2P + tri(P) + 1 = 216 floats (J, H0, y, w, mask, x_lin, x_f,
// P_f^-1, esc) and writes P + tri(P) + B + 2 = 77 (x, A, inn, hb):
// 1,172 B/px, against about 1.6 kFLOP/px of float32 arithmetic, well
// under the card's operations-per-byte balance.  The other instances move
// 328 floats/px at (11, 10), 200 at (11, 2), 104 at (7, 2) and 29 at
// (2, 2), and the one-band instances of band-sequential assimilation 184
// at (11, 1), 158 at (10, 1), 92 at (7, 1) and 22 at (2, 1), all bound by
// bytes too.  So the design is about reading each
// byte once, coalesced:
//
// - Nothing couples pixels (the TPU kernel's gcd(n, 2048) block is only
//   tiling), so one thread owns one pixel over the (rows, n) layout:
//   neighbouring threads read neighbouring pixels of each row, every load
//   and store is coalesced, and results do not depend on the block size.
// - The bands are streamed: per band the thread loads J_b (P floats),
//   forms J_b . x_lin and y~_b by select (masked y holds NaN nodata),
//   and adds w_b J_b[i] J_b[j] into A and w_b J_b[i] y~_b into rhs.  The
//   whole Jacobian (100 floats at (10, 10)) is never held: about 90
//   floats stay live (A 55, rhs 10, J_b 10, x_lin 10); at (11, B) about
//   110 (A 66), so the joint state's instances may spill.
// - Accumulation follows the JAX kernel: A starts from P_f^-1 and adds
//   the bands in ascending order as (w_b J_b[i]) J_b[j]; rhs starts from
//   sum_q P_f^-1(max(i,q), min(i,q)) x_f[q], then adds the bands.  Built
//   with -fmad=false (core/_build.py SOURCE_FLAGS), so each product and
//   sum rounds on its own, as in the plain version.
// - A is stored before the diagonal is inflated (a_ii (1 + esc (DAMP_DIAG
//   - 1)) + esc DAMP_ABS, exactly * 1 + 0 for healthy pixels) and factored
//   in place with the shared packed Cholesky (packed_chol.cuh).

#include <cuda_runtime.h>
#include <math.h>

#include "packed_chol.cuh"

namespace {

using kafka::idx;
using kafka::tri;

constexpr int kThreads = 128;
constexpr float kDampDiag = 10.0f;
constexpr float kDampAbs = 1e-3f;

template <int P, int NB>
__global__ void __launch_bounds__(kThreads) fused_update_kernel(
    const float* __restrict__ jac, const float* __restrict__ h0,
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ m, const float* __restrict__ xl,
    const float* __restrict__ xf, const float* __restrict__ pf,
    const float* __restrict__ esc, float* __restrict__ x_out,
    float* __restrict__ a_out, float* __restrict__ inn_out,
    float* __restrict__ hb_out, long long n) {
  constexpr int T = tri(P);
  const long long px = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (px >= n) return;

  float a[T];
#pragma unroll
  for (int r = 0; r < T; ++r) a[r] = pf[r * n + px];
  float rhs[P];
  {
    float xfv[P];
#pragma unroll
    for (int k = 0; k < P; ++k) xfv[k] = xf[k * n + px];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float s = a[idx(i, 0)] * xfv[0];
#pragma unroll
      for (int q = 1; q < P; ++q)
        s = s + a[idx(i > q ? i : q, i > q ? q : i)] * xfv[q];
      rhs[i] = s;
    }
  }
  float xlv[P];
#pragma unroll
  for (int k = 0; k < P; ++k) xlv[k] = xl[k * n + px];

#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float jb[P];
#pragma unroll
    for (int k = 0; k < P; ++k) jb[k] = jac[(b * P + k) * n + px];
    const float hv = h0[b * n + px];
    const float yv = y[b * n + px];
    const float wv = w[b * n + px];
    const bool mb = m[b * n + px] > 0.0f;
    float jx = jb[0] * xlv[0];
#pragma unroll
    for (int k = 1; k < P; ++k) jx = jx + jb[k] * xlv[k];
    // Selects, never mask multiplications: masked y may hold NaN.
    const float yt = mb ? (yv + jx - hv) : 0.0f;
    inn_out[b * n + px] = mb ? (yv - hv) : 0.0f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float wj = wv * jb[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) a[idx(i, j)] = a[idx(i, j)] + wj * jb[j];
      rhs[i] = rhs[i] + wj * yt;
    }
  }

  // The stored information matrix is the uninflated Hessian.
#pragma unroll
  for (int r = 0; r < T; ++r) a_out[r * n + px] = a[r];
  const float e = esc[px];
#pragma unroll
  for (int i = 0; i < P; ++i)
    a[idx(i, i)] = a[idx(i, i)] * (1.0f + e * (kDampDiag - 1.0f)) +
                   e * kDampAbs;
  const bool breakdown = kafka::cholesky_packed<P>(a);
  float x[P];
  kafka::solve_chol<P>(a, rhs, x);
  bool nonfin = false;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    x_out[k * n + px] = x[k];
    nonfin = nonfin || !isfinite(x[k]);
  }
  hb_out[px] = (breakdown || nonfin) ? 1.0f : 0.0f;
  hb_out[n + px] = nonfin ? 1.0f : 0.0f;
}

template <int P, int NB>
int launch(const float* jac, const float* h0, const float* y, const float* w,
           const float* m, const float* xl, const float* xf, const float* pf,
           const float* esc, float* x_out, float* a_out, float* inn_out,
           float* hb_out, long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  fused_update_kernel<P, NB><<<(unsigned)blocks, kThreads, 0, stream>>>(
      jac, h0, y, w, m, xl, xf, pf, esc, x_out, a_out, inn_out, hb_out, n);
  return (int)cudaGetLastError();
}

template <int P, int NB>
int attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fused_update_kernel<P, NB>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kThreads;
  return 0;
}

}  // namespace

// The (P, NB) instances, each once: X(P, NB) expands to one dispatch case.
#define KAFKA_FUSED_UPDATE_INSTANCES(X) \
  X(10, 10)                             \
  X(7, 2)                               \
  X(2, 2)                               \
  X(11, 10)                             \
  X(11, 2)                              \
  X(2, 1)                               \
  X(7, 1)                               \
  X(10, 1)                              \
  X(11, 1)

extern "C" {

// Launch the (p, n_bands) instance on `stream`: (10, 10) for PROSAIL on
// Sentinel-2 and the emulators of its bands, (7, 2) for TIP, (2, 2) for
// the SAR-only WCM state, (11, 10) and (11, 2) for the joint S2 + S1
// state's S2 and S1 dates, and (2, 1), (7, 1), (10, 1), (11, 1) for one
// band of the WCM, TIP, S2 and joint states (band-sequential mode).  Arrays are row-major (rows, n) float32 on
// the device: jac (n_bands * p), h0 / y / w / m (n_bands), xl / xf (p),
// pf (tri(p)), esc (1); outputs x (p), a (tri(p)), inn (n_bands), hb (2).
// Returns the CUDA error code of the launch (0 on success).
int kafka_fused_update(int p, int n_bands, const float* jac, const float* h0,
                       const float* y, const float* w, const float* m,
                       const float* xl, const float* xf, const float* pf,
                       const float* esc, float* x_out, float* a_out,
                       float* inn_out, float* hb_out, long long n,
                       void* stream) {
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define KAFKA_LAUNCH_CASE(P, NB)                                          \
  if (p == P && n_bands == NB)                                            \
    return launch<P, NB>(jac, h0, y, w, m, xl, xf, pf, esc, x_out, a_out, \
                         inn_out, hb_out, n, s);
  KAFKA_FUSED_UPDATE_INSTANCES(KAFKA_LAUNCH_CASE)
#undef KAFKA_LAUNCH_CASE
  return (int)cudaErrorInvalidValue;
}

// Registers per thread, local (spill) bytes per thread, static shared
// bytes and threads per block of the (p, n_bands) instance.
int kafka_fused_update_attributes(int p, int n_bands, int* out) {
#define KAFKA_ATTRIBUTES_CASE(P, NB) \
  if (p == P && n_bands == NB) return attributes<P, NB>(out);
  KAFKA_FUSED_UPDATE_INSTANCES(KAFKA_ATTRIBUTES_CASE)
#undef KAFKA_ATTRIBUTES_CASE
  return (int)cudaErrorInvalidValue;
}

const char* kafka_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
