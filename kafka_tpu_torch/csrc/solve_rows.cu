// solve_rows.cu — packed Cholesky factor and forward/back substitution per
// pixel as one CUDA kernel.
//
// Replaces the Pallas TPU kernel kafka_tpu/core/pallas_solve.py:
// _solve_kernel (:72-93, driven by solve_rows :96-121 and
// solve_spd_packed_pallas :616-630): x = A^-1 b for n independent SPD
// p x p systems, A as packed lower-triangle rows (tri(p), n), b and x as
// (p, n) rows.
//
// What bounds it on an H100: bytes.  A pixel reads tri(p) + p floats and
// writes p (75 floats, 300 B at p = 10) against about 0.6 kFLOP of
// float32 arithmetic, far under the operations-per-byte balance.  One
// thread owns one pixel, so every row load and store is coalesced, the
// factor and the substitution stay in registers (packed_chol.cuh, shared
// with the fused update), and each byte crosses HBM once.  Built with
// -fmad=false, as the plain version rounds.

#include <cuda_runtime.h>

#include "packed_chol.cuh"

namespace {

using kafka::tri;

constexpr int kThreads = 128;

template <int P>
__global__ void __launch_bounds__(kThreads) solve_rows_kernel(
    const float* __restrict__ a_rows, const float* __restrict__ b_rows,
    float* __restrict__ x_out, long long n) {
  constexpr int T = tri(P);
  const long long px = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (px >= n) return;
  float a[T];
#pragma unroll
  for (int r = 0; r < T; ++r) a[r] = a_rows[r * n + px];
  float b[P];
#pragma unroll
  for (int k = 0; k < P; ++k) b[k] = b_rows[k * n + px];
  kafka::cholesky_packed<P>(a);
  float x[P];
  kafka::solve_chol<P>(a, b, x);
#pragma unroll
  for (int k = 0; k < P; ++k) x_out[k * n + px] = x[k];
}

template <int P>
int launch(const float* a, const float* b, float* x, long long n,
           cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  solve_rows_kernel<P><<<(unsigned)blocks, kThreads, 0, stream>>>(a, b, x, n);
  return (int)cudaGetLastError();
}

template <int P>
int attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, solve_rows_kernel<P>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kThreads;
  return 0;
}

}  // namespace

extern "C" {

// Launch the p instance (2, 7 or 10) on `stream`: a (tri(p), n), b (p, n)
// and x (p, n) row-major float32 on the device.  Returns the CUDA error
// code of the launch (0 on success).
int kafka_solve_rows(int p, const float* a, const float* b, float* x,
                     long long n, void* stream) {
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
    case 2: return launch<2>(a, b, x, n, s);
    case 7: return launch<7>(a, b, x, n, s);
    case 10: return launch<10>(a, b, x, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers per thread, local (spill) bytes per thread, static shared
// bytes and threads per block of the p instance.
int kafka_solve_rows_attributes(int p, int* out) {
  switch (p) {
    case 2: return attributes<2>(out);
    case 7: return attributes<7>(out);
    case 10: return attributes<10>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* kafka_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
