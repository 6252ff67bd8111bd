// fused_gn.cu — the whole per-date Gauss-Newton solve as one CUDA kernel.
//
// Replaces the Pallas TPU kernel kafka_tpu/core/pallas_solve.py:
// _fused_gn_kernel (:255-471, driven by fused_gn_rows :474-568).  It
// computes what that kernel computes, for the two-stream (JRC-TIP)
// operator: per pixel, for up to max_iters + 1 trips,
//
//     H0, J = twostream(x)              (value + Jacobian, dual numbers)
//     y~    = where(mask, y + J x - H0, 0)
//     A     = sum_b w_b J_b J_b^T + P_f^-1       (packed lower triangle)
//     x*    = chol(A, LM-inflated diagonal) \ (sum_b w_b y~_b J_b + P_f^-1 x_f)
//     x    <- clip(x + relax_eff (retreat(x*) - x), lo, hi)
//
// with the solve-health steps of kafka_tpu/core/solver_health.py
// (breakdown / non-finite detection, LM retreat, quarantine, verdicts).
//
// What bounds it on an H100: bytes.  Per pixel the function must read
// 41 floats (y, r_inv, mask per band; x_f; packed P_f^-1) and write 40
// (x, packed A, fwd, inn, the verdict): 324 B/px, against about
// 1.4 kFLOP/px per trip of float32 arithmetic — a few trips stay under
// the card's operations-per-byte balance, so the floor is HBM bandwidth.
// This layout moves 50 output floats, not 40: the group's trip count and
// step norm broadcast over its pixels (2 rows) and the ever-non-finite
// and clipped-every-trip rows (1 + p) that the wrapper reduces to counts.
// The corruption row is read only when one is given (`cor` non-null).
//
// Design.  Convergence is tested per group of `blk` pixels (the TPU
// kernel's gcd(n, 2048) grid block): the group stops once its squared
// step sum is under thresh_sq = (tol * numel * blk / n)^2.  The grouping
// is semantic — other groupings change iteration counts — so one CUDA
// block runs one group.  A block holds at most 1024 threads and
// registers are scarce, so kThreads threads stride over the group's
// pixels, and the per-pixel carry (x, last step^2 and one flag word:
// clipped-every-trip bits, escalated, ever-non-finite, bad on the last
// step, A non-finite) lives in shared memory: (p + 2) words per pixel,
// 72 KiB at 2048 px, so three groups share an SM.  Each thread owns the
// same pixels on every trip, so the carry needs no synchronisation; a
// trip ends with one block reduction of the squared step and one skip
// decision the whole group shares.  The inputs are re-read from global
// memory on each trip (L2 absorbs part of that), and each executed
// trip's A, fwd and inn are written straight to the outputs, so the last
// executed trip's values are what remains — bytes beyond the bound that
// a later version can remove.
//
// Arithmetic follows the JAX kernel term for term; no fast-math, so
// sqrtf and division are IEEE-rounded.  nvcc contracts a*b+c into FMAs,
// so results differ from the plain PyTorch version in the last bits.
// NaN nodata under the mask stays inert by select, never multiplication.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

constexpr float kEps = 1e-6f;
constexpr float kOneMinusEps = (float)(1.0 - 1e-6);
constexpr float kEpsSq = (float)1e-12;
constexpr float kDampDiag = 10.0f;
constexpr float kDampAbs = 1e-3f;
constexpr float kDampRelax = 0.25f;
constexpr float kQuarantineScale = 0.25f;

constexpr int kQaConverged = 1;
constexpr int kQaCapBailout = 2;
constexpr int kQaDampedRecovered = 4;
constexpr int kQaQuarantined = 8;
constexpr int kQaNodata = 16;

// Carry flag word: bits 0..p-1 clipped on every trip; then these.
constexpr unsigned kEscalated = 1u << 16;
constexpr unsigned kNonfinite = 1u << 17;
constexpr unsigned kBadNow = 1u << 18;
constexpr unsigned kANonfinite = 1u << 19;

__host__ __device__ constexpr int tri(int p) { return p * (p + 1) / 2; }
__host__ __device__ constexpr int idx(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// NaN-propagating max/min (jnp.maximum / jnp.minimum semantics).
__device__ __forceinline__ float max_nan(float x, float c) {
  return (x != x) ? x : fmaxf(x, c);
}
__device__ __forceinline__ float min_nan(float x, float c) {
  return (x != x) ? x : fminf(x, c);
}

// ---- forward-mode dual numbers: value + N tangents ------------------------
// Each rule is JAX's JVP rule for the same primitive, including the
// balanced tie of max/min (half the tangent at an exact tie).

template <int N>
struct Dual {
  float v;
  float d[N];
};

template <int N>
__device__ __forceinline__ Dual<N> operator+(Dual<N> a, Dual<N> b) {
  Dual<N> r; r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(Dual<N> a, Dual<N> b) {
  Dual<N> r; r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(float c, Dual<N> a) {
  Dual<N> r; r.v = c - a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator+(float c, Dual<N> a) {
  Dual<N> r; r.v = c + a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator-(Dual<N> a) {
  Dual<N> r; r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(Dual<N> a, Dual<N> b) {
  Dual<N> r; r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator*(float c, Dual<N> a) {
  Dual<N> r; r.v = c * a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = c * a.d[k];
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(Dual<N> a, Dual<N> b) {
  Dual<N> r; r.v = a.v / b.v;
  const float inv_sq = 1.0f / (b.v * b.v);
#pragma unroll
  for (int k = 0; k < N; ++k)
    r.d[k] = a.d[k] / b.v + (-b.d[k] * a.v) * inv_sq;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float c, Dual<N> b) {
  Dual<N> r; r.v = c / b.v;
  const float inv_sq = 1.0f / (b.v * b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (-b.d[k] * c) * inv_sq;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(Dual<N> a, float c) {
  Dual<N> r; r.v = a.v / c;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / c;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dsq(Dual<N> a) {  // a**2
  Dual<N> r; r.v = a.v * a.v;
  const float two_a = 2.0f * a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * two_a;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dsqrt(Dual<N> a) {
  Dual<N> r; r.v = sqrtf(a.v);
  const float s = 0.5f / r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * s;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dexp(Dual<N> a) {
  Dual<N> r; r.v = expf(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * r.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dlog(Dual<N> a) {
  Dual<N> r; r.v = logf(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / a.v;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dmax(Dual<N> a, float c) {
  Dual<N> r; r.v = max_nan(a.v, c);
  const float s = (a.v == r.v) ? ((c == r.v) ? 0.5f : 1.0f) : 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * s;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dmin(Dual<N> a, float c) {
  Dual<N> r; r.v = min_nan(a.v, c);
  const float s = (a.v == r.v) ? ((c == r.v) ? 0.5f : 1.0f) : 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * s;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> dclip(Dual<N> a, float lo, float hi) {
  return dmin(dmax(a, lo), hi);
}

// ---- the two-stream operator (kafka_tpu/obsops/twostream.py:52-87) --------

template <int N>
__device__ __forceinline__ Dual<N> twostream_albedo(Dual<N> omega, Dual<N> d,
                                                    Dual<N> soil_albedo,
                                                    Dual<N> lai) {
  omega = dclip(omega, kEps, kOneMinusEps);
  const Dual<N> g = dclip(1.0f - 1.0f / dmax(d, 0.1f), -0.95f, 0.95f);
  const Dual<N> b = (1.0f - g) / 2.0f;
  const Dual<N> soil = dclip(soil_albedo, 0.0f, 1.0f);
  lai = dmax(lai, kEps);

  const Dual<N> alpha = 1.0f - omega * (1.0f - b);
  const Dual<N> beta = omega * b;
  const Dual<N> gamma = dsqrt(dmax(dsq(alpha) - dsq(beta), kEpsSq));
  const Dual<N> r_inf = beta / (alpha + gamma);

  const Dual<N> e_m = dexp(-gamma * lai);
  const Dual<N> ratio = dsq(e_m) * (r_inf - soil) / (soil - 1.0f / r_inf);
  const Dual<N> c1 = 1.0f / (1.0f + ratio);
  const Dual<N> c2 = ratio * c1;
  return r_inf * c1 + c2 / r_inf;
}

struct TwoStream {
  static constexpr int P = 7;
  static constexpr int NB = 2;

  // Value and Jacobian of both bands; each band reads 4 mapped
  // parameters [omega, d, tlai, soil] (VIS 0,1,6,2; NIR 3,4,6,5) and its
  // other Jacobian entries are zero.
  __device__ static __forceinline__ void linearize(const float x[P],
                                                   float h0[NB],
                                                   float jac[NB][P]) {
    constexpr int kMap[NB][4] = {{0, 1, 6, 2}, {3, 4, 6, 5}};
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      Dual<4> s[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k].v = x[kMap[b][k]];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[k].d[j] = (j == k) ? 1.0f : 0.0f;
      }
      // tlai -> lai = -2 log(clip(tlai, eps, 1 - eps))
      const Dual<4> lai = -2.0f * dlog(dclip(s[2], kEps, kOneMinusEps));
      const Dual<4> r = twostream_albedo(s[0], s[1], s[3], lai);
      h0[b] = r.v;
#pragma unroll
      for (int k = 0; k < P; ++k) jac[b][k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) jac[b][kMap[b][k]] = r.d[k];
    }
  }
};

template <int P>
struct Bounds {
  float lo[P];
  float hi[P];
};

// Sum over the block; every thread gets the same value.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* sred) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) sred[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < THREADS / 32; ++k) s += sred[k];
    sred[THREADS / 32] = s;
  }
  __syncthreads();
  return sred[THREADS / 32];
}

// One Gauss-Newton step for one pixel: reads its carry from shared
// memory, writes the new carry back, writes A/fwd/inn to the outputs and
// returns the squared step.
template <class Op>
__device__ __forceinline__ float gn_step(
    long long px, int i, int blk, long long n,
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ m, const float* __restrict__ xf,
    const float* __restrict__ pf, const float* __restrict__ cor,
    float* __restrict__ a_out, float* __restrict__ fwd_out,
    float* __restrict__ inn_out, float* sx, float* sssq, unsigned* sflag,
    int has_bounds, float relax, const Bounds<Op::P>& bnd) {
  constexpr int P = Op::P;
  constexpr int NB = Op::NB;
  constexpr int T = tri(P);
  constexpr unsigned kClipAll = (1u << P) - 1u;

  float x[P];
#pragma unroll
  for (int k = 0; k < P; ++k) x[k] = sx[k * blk + i];
  const unsigned fl = sflag[i];
  const float esc = (fl & kEscalated) ? 1.0f : 0.0f;

  float h0[NB];
  float jac[NB][P];
  Op::linearize(x, h0, jac);
  const bool corrupt = cor != nullptr && cor[px] > 0.0f;

  float yb[NB], wb[NB];
  bool mb[NB];
  float yt[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    yb[b] = y[b * n + px];
    wb[b] = w[b * n + px];
    mb[b] = m[b * n + px] > 0.0f;
    if (corrupt) h0[b] = NAN;
    float jx = jac[b][0] * x[0];
#pragma unroll
    for (int k = 1; k < P; ++k) jx = jx + jac[b][k] * x[k];
    // A select, never a mask multiplication: masked y may hold NaN.
    yt[b] = mb[b] ? (yb[b] + jx - h0[b]) : 0.0f;
  }

  float a[T];
#pragma unroll
  for (int r = 0; r < P; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      float s = pf[idx(r, c) * n + px];
#pragma unroll
      for (int b = 0; b < NB; ++b) s = s + (wb[b] * jac[b][r]) * jac[b][c];
      a[idx(r, c)] = s;
    }
  }
  float xfv[P];
#pragma unroll
  for (int k = 0; k < P; ++k) xfv[k] = xf[k * n + px];
  float rhs[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float s = pf[idx(r, 0) * n + px] * xfv[0];
#pragma unroll
    for (int q = 1; q < P; ++q)
      s = s + pf[idx(r > q ? r : q, r > q ? q : r) * n + px] * xfv[q];
#pragma unroll
    for (int b = 0; b < NB; ++b) s = s + (wb[b] * jac[b][r]) * yt[b];
    rhs[r] = s;
  }

  // The stored information matrix is the uninflated Hessian.
  bool a_nonfin = false;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    a_out[r * n + px] = a[r];
    a_nonfin = a_nonfin || !isfinite(a[r]);
  }
  // LM inflation of the factored diagonal: exactly *1 + 0 when healthy.
#pragma unroll
  for (int r = 0; r < P; ++r)
    a[idx(r, r)] = a[idx(r, r)] * (1.0f + esc * (kDampDiag - 1.0f)) +
                   esc * kDampAbs;

  // Packed Cholesky in place (linalg.cholesky_packed) + breakdown test.
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
    for (int r = j + 1; r < P; ++r) {
      float s = a[idx(r, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - a[idx(r, k)] * a[idx(j, k)];
      a[idx(r, j)] = s * inv;
    }
  }
  // Forward + back substitution (linalg.solve_chol_vectors).
  float z[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float s = rhs[r];
#pragma unroll
    for (int k = 0; k < r; ++k) s = s - a[idx(r, k)] * z[k];
    z[r] = s / a[idx(r, r)];
  }
  float xr[P];
#pragma unroll
  for (int r = P - 1; r >= 0; --r) {
    float s = z[r];
#pragma unroll
    for (int k = r + 1; k < P; ++k) s = s - a[idx(k, r)] * xr[k];
    xr[r] = s / a[idx(r, r)];
  }
  bool x_nonfin = false;
#pragma unroll
  for (int k = 0; k < P; ++k) x_nonfin = x_nonfin || !isfinite(xr[k]);
  const bool step_bad = breakdown || x_nonfin;
  const float esc_now = fmaxf(esc, step_bad ? 1.0f : 0.0f);
  const float relax_eff = relax * (1.0f + esc_now * (kDampRelax - 1.0f));

  unsigned clip = fl & kClipAll;
  float xn[P];
  float ssq = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float tgt = step_bad ? x[k] : xr[k];  // LM retreat
    float v = x[k] + relax_eff * (tgt - x[k]);
    if (has_bounds) {
      v = min_nan(max_nan(v, bnd.lo[k]), bnd.hi[k]);
      if (!(v <= bnd.lo[k] || v >= bnd.hi[k])) clip &= ~(1u << k);
    }
    xn[k] = v;
    const float dx = v - x[k];
    ssq = (k == 0) ? dx * dx : ssq + dx * dx;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float s = jac[b][0] * (xn[0] - xfv[0]);
#pragma unroll
    for (int k = 1; k < P; ++k) s = s + jac[b][k] * (xn[k] - xfv[k]);
    fwd_out[b * n + px] = s + h0[b];
    inn_out[b * n + px] = mb[b] ? (yb[b] - h0[b]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) sx[k * blk + i] = xn[k];
  sssq[i] = ssq;
  sflag[i] = clip | (esc_now > 0.0f ? kEscalated : 0u) |
             (((fl & kNonfinite) || x_nonfin) ? kNonfinite : 0u) |
             (step_bad ? kBadNow : 0u) | (a_nonfin ? kANonfinite : 0u);
  return ssq;
}

template <class Op, int THREADS>
__global__ void __launch_bounds__(THREADS) fused_gn_kernel(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ m, const float* __restrict__ xf,
    const float* __restrict__ pf, const float* __restrict__ cor,
    float* __restrict__ x_out, float* __restrict__ a_out,
    float* __restrict__ fwd_out, float* __restrict__ inn_out,
    float* __restrict__ st_out, float* __restrict__ hl_out, long long n,
    int blk, int min_iters, int max_iters, int has_bounds, float relax,
    float thresh_sq, float moving_sq, Bounds<Op::P> bnd) {
  constexpr int P = Op::P;
  constexpr int NB = Op::NB;
  constexpr int T = tri(P);
  constexpr unsigned kClipAll = (1u << P) - 1u;

  extern __shared__ float smem[];
  float* sx = smem;                                       // P * blk
  float* sssq = sx + P * blk;                             // blk
  unsigned* sflag = reinterpret_cast<unsigned*>(sssq + blk);  // blk
  float* sred = reinterpret_cast<float*>(sflag + blk);   // THREADS/32 + 1

  const long long base = (long long)blockIdx.x * blk;
  for (int i = threadIdx.x; i < blk; i += THREADS) {
#pragma unroll
    for (int k = 0; k < P; ++k) sx[k * blk + i] = xf[k * n + base + i];
    sssq[i] = INFINITY;
    sflag[i] = kClipAll;
  }

  // max_iters + 1 trips reproduce the while loop's post-increment cap;
  // a converged group skips every remaining trip (the TPU kernel's
  // lax.cond), which is a break since its carry no longer changes.
  int n_done = 0;
  float normsq = INFINITY;
  for (int trip = 0; trip <= max_iters; ++trip) {
    if (normsq < thresh_sq && n_done >= min_iters) break;
    float part = 0.0f;
    for (int i = threadIdx.x; i < blk; i += THREADS)
      part += gn_step<Op>(base + i, i, blk, n, y, w, m, xf, pf, cor, a_out,
                          fwd_out, inn_out, sx, sssq, sflag, has_bounds,
                          relax, bnd);
    normsq = block_sum<THREADS>(part, sred);
    ++n_done;
  }

  // Quarantine, verdicts and the per-pixel health rows.
  const bool cap_exit = n_done > max_iters;
  for (int i = threadIdx.x; i < blk; i += THREADS) {
    const long long px = base + i;
    const unsigned fl = sflag[i];
    bool observed = false;
#pragma unroll
    for (int b = 0; b < NB; ++b) observed = observed || (m[b * n + px] > 0.0f);
    bool x_nonfin = false;
#pragma unroll
    for (int k = 0; k < P; ++k) x_nonfin = x_nonfin || !isfinite(sx[k * blk + i]);
    const bool quar = ((fl & kBadNow) || x_nonfin || (fl & kANonfinite)) &&
                      observed;
#pragma unroll
    for (int k = 0; k < P; ++k)
      x_out[k * n + px] = quar ? xf[k * n + px] : sx[k * blk + i];
    if (quar) {
#pragma unroll
      for (int r = 0; r < T; ++r)
        a_out[r * n + px] = kQuarantineScale * pf[r * n + px];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        fwd_out[b * n + px] = 0.0f;
        inn_out[b * n + px] = 0.0f;
      }
    }
    const bool moving = sssq[i] >= moving_sq;
    const bool escalated = (fl & kEscalated) != 0u;
    const bool bailout = cap_exit && moving && observed && !quar;
    const bool recovered = escalated && observed && !quar;
    const bool converged = observed && !quar && !bailout;
    const int verdict = (converged ? kQaConverged : 0) +
                        (bailout ? kQaCapBailout : 0) +
                        (recovered ? kQaDampedRecovered : 0) +
                        (quar ? kQaQuarantined : 0) +
                        (observed ? 0 : kQaNodata);
    st_out[px] = (float)n_done;
    st_out[n + px] = normsq;
    hl_out[px] = (float)verdict;
    hl_out[n + px] = ((fl & kNonfinite) && observed) ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k)
      hl_out[(2 + k) * n + px] =
          (has_bounds && (fl & (1u << k)) && observed) ? 1.0f : 0.0f;
  }
}

template <class Op>
size_t smem_bytes(int blk) {
  return (size_t)(Op::P + 2) * blk * sizeof(float) +
         (size_t)(kThreads / 32 + 1) * sizeof(float);
}

}  // namespace

extern "C" {

// Launch the two-stream (p=7, 2 bands) fused Gauss-Newton kernel on
// `stream`.  Arrays are row-major (rows, n) float32 on the device;
// `bounds_host` is a host array [lo_0..lo_6, hi_0..hi_6]; `cor` may be
// null (no corrupted pixels).  Returns the
// CUDA error code of the launch (0 on success).
int kafka_fused_gn_twostream(const float* y, const float* w, const float* m,
                             const float* xf, const float* pf,
                             const float* cor, float* x_out, float* a_out,
                             float* fwd_out, float* inn_out, float* st_out,
                             float* hl_out, long long n, int blk,
                             int min_iters, int max_iters, int has_bounds,
                             float relax, float thresh_sq, float moving_sq,
                             const float* bounds_host, void* stream) {
  using Op = TwoStream;
  if (n <= 0 || blk <= 0 || n % blk != 0) return (int)cudaErrorInvalidValue;
  Bounds<Op::P> bnd;
  for (int k = 0; k < Op::P; ++k) {
    bnd.lo[k] = bounds_host[k];
    bnd.hi[k] = bounds_host[Op::P + k];
  }
  const size_t smem = smem_bytes<Op>(blk);
  auto kernel = fused_gn_kernel<Op, kThreads>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(n / blk), kThreads, smem, (cudaStream_t)stream>>>(
      y, w, m, xf, pf, cor, x_out, a_out, fwd_out, inn_out, st_out, hl_out,
      n, blk, min_iters, max_iters, has_bounds, relax, thresh_sq, moving_sq,
      bnd);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes per thread, static shared
// bytes, and threads per block of the compiled kernel.
int kafka_fused_gn_twostream_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, fused_gn_kernel<TwoStream, kThreads>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kThreads;
  return 0;
}

const char* kafka_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
