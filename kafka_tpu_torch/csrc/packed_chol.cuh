// packed_chol.cuh — per-pixel packed Cholesky factor and substitution as
// device code, shared by the fused update (fused_update.cu) and the
// packed solve (solve_rows.cu), as the JAX package shares
// kafka_tpu/core/linalg.py:cholesky_packed / solve_chol_vectors across its
// Pallas kernels.
//
// Layout: entry (i, j), j <= i, of a symmetric p x p matrix sits at
// idx(i, j) = i (i + 1) / 2 + j.  The loops are those of linalg.py, in
// the same order, so a kernel built without FMA contraction
// (-fmad=false) rounds as the plain PyTorch version does; sqrtf and the
// divisions are IEEE-rounded (no fast-math).
#pragma once

#include <math.h>

namespace kafka {

__host__ __device__ constexpr int tri(int p) { return p * (p + 1) / 2; }
__host__ __device__ constexpr int idx(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// Factor the packed matrix `a` in place into its lower Cholesky factor.
// Returns the breakdown flag of solver_health.chol_breakdown: some
// diagonal entry of the factor is not > 0 or not finite.
template <int P>
__device__ __forceinline__ bool cholesky_packed(float (&a)[tri(P)]) {
  bool breakdown = false;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float d = a[idx(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - a[idx(j, k)] * a[idx(j, k)];
    const float ljj = sqrtf(d);
    a[idx(j, j)] = ljj;
    breakdown = breakdown || !(ljj > 0.0f) || !isfinite(ljj);
    const float inv = 1.0f / ljj;
#pragma unroll
    for (int i = j + 1; i < P; ++i) {
      float s = a[idx(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - a[idx(i, k)] * a[idx(j, k)];
      a[idx(i, j)] = s * inv;
    }
  }
  return breakdown;
}

// Forward and back substitution against the packed lower factor `l`:
// x = (l l^T)^-1 b.
template <int P>
__device__ __forceinline__ void solve_chol(const float (&l)[tri(P)],
                                           const float (&b)[P],
                                           float (&x)[P]) {
  float z[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - l[idx(i, k)] * z[k];
    z[i] = s / l[idx(i, i)];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    float s = z[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s = s - l[idx(k, i)] * x[k];
    x[i] = s / l[idx(i, i)];
  }
}

}  // namespace kafka
