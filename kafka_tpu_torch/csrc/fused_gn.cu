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
// What bounds it on an H100.  Per pixel the function must read 41 floats
// (y, r_inv, mask per band; x_f; packed P_f^-1) and write 40 (x, packed
// A, fwd, inn, the verdict): 324 B/px, against about 1.3 kFLOP/px per
// trip.  The design moves each byte once; what remains is instruction
// issue: the trip loop compiles to a few thousand instructions per
// pixel (IEEE division and square root sequences, the dual-number
// tangents, the range checks of the solve-health flags).
// The row layout writes 50 output floats, not 40: the group's trip count
// and step norm broadcast over its pixels (2 rows) and the
// ever-non-finite and clipped-every-trip rows (1 + p) that the wrapper
// reduces to counts.
//
// Design.  Convergence is tested per group of `blk` pixels (the TPU
// kernel's gcd(n, min(2048, n)) grid block: a power of two, or all of n
// under 2048 px): the group stops once its squared step sum is under
// thresh_sq = (tol * numel * blk / n)^2.  The grouping is semantic —
// other groupings change iteration counts — so one group is one
// thread-block cluster of ceil(blk / 256) CTAs (at most 8, the portable
// cluster size), one pixel per thread: 8 CTAs of 256 threads for the
// usual 2048-px group.
// - Inputs staged once.  Each thread copies its pixel's input floats
//   (and the corruption row when one is given) into its own column of
//   the CTA's shared memory with coalesced loads, and computes the
//   trip-invariant prior term P_f^-1 x_f there once.  Every trip and the
//   epilogue read the inputs from shared memory.  A column is kRows
//   floats, an odd count, so the 32 columns of a warp fall into 32
//   different banks.  Only the owning thread touches a column, so the
//   staging needs no barrier.
// - Carry in registers: x, the flag word (clipped-every-trip bits,
//   escalated, ever-non-finite, bad on the last step, A non-finite) and
//   the last squared step.
// - Outputs written once.  Each trip stores its A, fwd and inn in the
//   thread's column; only the last executed trip's survive.  After the
//   loop the epilogue writes x, A, fwd, inn, st and hl once, coalesced.
// - Per-trip group reduction: warp shuffles, the CTA's warps in order,
//   then the cluster without a cluster barrier: each CTA pushes its
//   partial into every CTA's mailbox in distributed shared memory
//   (st.async, counted by an mbarrier per trip parity) and sums the C
//   partials in rank order (see group_sum).  All CTAs of a group hold
//   the same sum and take the same skip decision, and a converged group
//   leaves the loop as a whole cluster.
//
// Arithmetic follows the JAX kernel term for term; no fast-math, so
// sqrtf and division are IEEE-rounded, except that the tangents of a
// dual-number division multiply by one reciprocal of the divisor.  nvcc
// contracts a*b+c into FMAs, so results differ from the plain PyTorch
// version in the last bits.
// NaN nodata under the mask stays inert by select, never multiplication.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size

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
// The value is an IEEE quotient; the tangents multiply by one IEEE
// reciprocal of the divisor instead of dividing each (a last-bit
// difference from JAX's JVP, d/b and d * (1/b)).
template <int N>
__device__ __forceinline__ Dual<N> operator/(Dual<N> a, Dual<N> b) {
  Dual<N> r; r.v = a.v / b.v;
  const float inv = 1.0f / b.v;
  const float inv_sq = inv * inv;
#pragma unroll
  for (int k = 0; k < N; ++k)
    r.d[k] = a.d[k] * inv + (-b.d[k] * a.v) * inv_sq;
  return r;
}
template <int N>
__device__ __forceinline__ Dual<N> operator/(float c, Dual<N> b) {
  Dual<N> r; r.v = c / b.v;
  const float inv = 1.0f / b.v;
  const float inv_sq = inv * inv;
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
  const float inv = 1.0f / a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * inv;
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

// A thread's shared-memory column: the staged inputs, the prior term,
// the last executed trip's outputs.  kRows is odd (bank-conflict free).
template <class Op>
struct Column {
  static constexpr int P = Op::P;
  static constexpr int NB = Op::NB;
  static constexpr int kY = 0;
  static constexpr int kW = kY + NB;
  static constexpr int kM = kW + NB;
  static constexpr int kXf = kM + NB;
  static constexpr int kPf = kXf + P;
  static constexpr int kPrior = kPf + tri(P);  // P_f^-1 x_f
  static constexpr int kA = kPrior + P;
  static constexpr int kFwd = kA + tri(P);
  static constexpr int kInn = kFwd + NB;
  static constexpr int kCor = kInn + NB;  // 0 when no corruption row
  static constexpr int kRows = (kCor + 1) | 1;
};

// Geometry of one launch (core/fused_gn.py:launch_geometry mirrors it):
// a group of blk pixels is a cluster of `ctas` = ceil(blk / 256) CTAs of
// `threads` threads, ceil(blk / ctas) rounded up to whole warps.  Pixel
// i of the group is thread i % threads of the CTA of rank i / threads;
// the few threads past the group's end (blk not a multiple of
// ctas * 32, e.g. groups under a warp) only take part in the sums.
struct Geometry {
  long long clusters;
  int ctas;
  int threads;
  size_t smem;
};

template <class Op>
bool geometry(long long n, int blk, Geometry* g) {
  if (n <= 0 || blk <= 0 || n % blk != 0 ||
      blk > kMaxThreads * kMaxCluster)
    return false;
  g->clusters = n / blk;
  g->ctas = (blk + kMaxThreads - 1) / kMaxThreads;
  const int per_cta = (blk + g->ctas - 1) / g->ctas;
  g->threads = (per_cta + 31) / 32 * 32;
  g->smem = (size_t)g->threads * Column<Op>::kRows * sizeof(float);
  return true;
}

// ---- the per-trip group sum over a cluster ---------------------------------
// Each CTA's thread 0 sends the CTA's partial to every CTA of the cluster
// (itself included) with st.async into slot [parity][sender rank] of the
// receiver's mailbox; the write completes bytes on the receiver's
// mbarrier for that parity, which thread 0 armed to expect ctas * 4
// bytes.  Every thread waits on its own CTA's mbarrier, then sums the
// slots in rank order: the same sum, in the same order, in every CTA.
// Two parities suffice: no CTA can send trip t + 2's partial before every
// CTA has sent trip t + 1's, which each sends only after all its threads
// have read trip t's slots.

struct Mailbox {
  float part[2][kMaxCluster];
  unsigned long long bar[2];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Every thread of the cluster; orders the CTAs' shared-memory writes
// before the barrier against reads after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Thread 0 only, before the cluster barrier that precedes any send.
__device__ __forceinline__ void mailbox_init(Mailbox* mb) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&mb->bar[p]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ float group_sum(float v, int trip, int ctas,
                                           unsigned rank, float* s_warp,
                                           Mailbox* mb) {
  const int parity = trip & 1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  const unsigned bar = smem_addr(&mb->bar[parity]);
  if (threadIdx.x == 0) {
    float s = s_warp[0];
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) s += s_warp[k];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(ctas * 4) : "memory");
    const unsigned slot = smem_addr(&mb->part[parity][rank]);
    for (int r = 0; r < ctas; ++r) {
      unsigned to_slot, to_bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(to_slot) : "r"(slot), "r"(r));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(to_bar) : "r"(bar), "r"(r));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
          "[%0], %1, [%2];\n"
          ::"r"(to_slot), "r"(__float_as_uint(s)), "r"(to_bar)
          : "memory");
    }
  }
  // The (trip / 2)-th completion of this parity's mbarrier.
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"((trip >> 1) & 1)
      : "memory");
  float total = mb->part[parity][0];
  for (int r = 1; r < ctas; ++r) total += mb->part[parity][r];
  return total;
}

// One Gauss-Newton step for one pixel: inputs from its column `c`, carry
// (x, flag word) in registers; writes A/fwd/inn into the column and
// returns the squared step.
template <class Op>
__device__ __forceinline__ float gn_step(float* c, float x[Op::P],
                                         unsigned& fl, int has_bounds,
                                         float relax,
                                         const Bounds<Op::P>& bnd) {
  using L = Column<Op>;
  constexpr int P = Op::P;
  constexpr int NB = Op::NB;
  constexpr int T = tri(P);
  constexpr unsigned kClipAll = (1u << P) - 1u;

  const float esc = (fl & kEscalated) ? 1.0f : 0.0f;
  float h0[NB];
  float jac[NB][P];
  Op::linearize(x, h0, jac);
  const bool corrupt = c[L::kCor] > 0.0f;

  float yb[NB], wb[NB];
  bool mb[NB];
  float yt[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    yb[b] = c[L::kY + b];
    wb[b] = c[L::kW + b];
    mb[b] = c[L::kM + b] > 0.0f;
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
    for (int q = 0; q <= r; ++q) {
      float s = c[L::kPf + idx(r, q)];
#pragma unroll
      for (int b = 0; b < NB; ++b) s = s + (wb[b] * jac[b][r]) * jac[b][q];
      a[idx(r, q)] = s;
    }
  }
  float rhs[P];
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float s = c[L::kPrior + r];
#pragma unroll
    for (int b = 0; b < NB; ++b) s = s + (wb[b] * jac[b][r]) * yt[b];
    rhs[r] = s;
  }

  // The stored information matrix is the uninflated Hessian.
  bool a_nonfin = false;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    c[L::kA + r] = a[r];
    a_nonfin |= !isfinite(a[r]);
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
    breakdown |= !(ljj > 0.0f) | !isfinite(ljj);
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
  for (int k = 0; k < P; ++k) x_nonfin |= !isfinite(xr[k]);
  const bool step_bad = breakdown | x_nonfin;
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
    float s = jac[b][0] * (xn[0] - c[L::kXf]);
#pragma unroll
    for (int k = 1; k < P; ++k) s = s + jac[b][k] * (xn[k] - c[L::kXf + k]);
    c[L::kFwd + b] = s + h0[b];
    c[L::kInn + b] = mb[b] ? (yb[b] - h0[b]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) x[k] = xn[k];
  fl = clip | (esc_now > 0.0f ? kEscalated : 0u) |
       (((fl & kNonfinite) != 0u) | x_nonfin ? kNonfinite : 0u) |
       (step_bad ? kBadNow : 0u) | (a_nonfin ? kANonfinite : 0u);
  return ssq;
}

// One cluster per convergence group, one pixel per thread (see the head
// of this file).  Launched by cudaLaunchKernelEx with the cluster size.
template <class Op>
__global__ void __launch_bounds__(kMaxThreads, 2) fused_gn_kernel(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ m, const float* __restrict__ xf,
    const float* __restrict__ pf, const float* __restrict__ cor,
    float* __restrict__ x_out, float* __restrict__ a_out,
    float* __restrict__ fwd_out, float* __restrict__ inn_out,
    float* __restrict__ st_out, float* __restrict__ hl_out, long long n,
    int blk, int min_iters, int max_iters, int has_bounds, float relax,
    float thresh_sq, float moving_sq, Bounds<Op::P> bnd) {
  using L = Column<Op>;
  constexpr int P = Op::P;
  constexpr int NB = Op::NB;
  constexpr int T = tri(P);
  constexpr unsigned kClipAll = (1u << P) - 1u;

  extern __shared__ float smem[];
  __shared__ float s_warp[kMaxThreads / 32];
  __shared__ Mailbox mailbox;
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  if (threadIdx.x == 0) mailbox_init(&mailbox);
  // Pixel `local` of group blockIdx.x / ctas (see Geometry).
  const int local = (int)rank * blockDim.x + threadIdx.x;
  const bool live = local < blk;
  const long long px = (long long)(blockIdx.x / ctas) * blk + local;
  float* c = smem + threadIdx.x * L::kRows;

  // Stage the inputs (each row a contiguous segment per CTA) and the
  // prior term P_f^-1 x_f, in the JAX kernel's order of terms.
  float x[P];
  if (live) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      c[L::kY + b] = y[b * n + px];
      c[L::kW + b] = w[b * n + px];
      c[L::kM + b] = m[b * n + px];
    }
#pragma unroll
    for (int k = 0; k < P; ++k) c[L::kXf + k] = xf[k * n + px];
#pragma unroll
    for (int r = 0; r < T; ++r) c[L::kPf + r] = pf[r * n + px];
    c[L::kCor] = cor != nullptr ? cor[px] : 0.0f;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      float s = c[L::kPf + idx(r, 0)] * c[L::kXf];
#pragma unroll
      for (int q = 1; q < P; ++q)
        s = s + c[L::kPf + idx(r > q ? r : q, r > q ? q : r)] * c[L::kXf + q];
      c[L::kPrior + r] = s;
    }
#pragma unroll
    for (int k = 0; k < P; ++k) x[k] = c[L::kXf + k];
  }
  unsigned fl = kClipAll;
  float ssq = INFINITY;
  cluster_barrier();  // every mailbox is ready before the first send

  // max_iters + 1 trips reproduce the while loop's post-increment cap;
  // a converged group skips every remaining trip (the TPU kernel's
  // lax.cond), which is a break since its carry no longer changes.
  int n_done = 0;
  float normsq = INFINITY;
  for (int trip = 0; trip <= max_iters; ++trip) {
    if (normsq < thresh_sq && n_done >= min_iters) break;
    if (live) ssq = gn_step<Op>(c, x, fl, has_bounds, relax, bnd);
    normsq = group_sum(live ? ssq : 0.0f, trip, ctas, rank, s_warp,
                       &mailbox);
    ++n_done;
  }
  // No CTA leaves while a send to it may be in flight.
  cluster_barrier();
  if (!live) return;

  // Quarantine, verdicts and the per-pixel health rows, written once.
  const bool cap_exit = n_done > max_iters;
  bool observed = false;
#pragma unroll
  for (int b = 0; b < NB; ++b) observed |= c[L::kM + b] > 0.0f;
  bool x_nonfin = false;
#pragma unroll
  for (int k = 0; k < P; ++k) x_nonfin |= !isfinite(x[k]);
  const bool quar = ((fl & kBadNow) || x_nonfin || (fl & kANonfinite)) &&
                    observed;
#pragma unroll
  for (int k = 0; k < P; ++k) x_out[k * n + px] = quar ? c[L::kXf + k] : x[k];
#pragma unroll
  for (int r = 0; r < T; ++r)
    a_out[r * n + px] = quar ? kQuarantineScale * c[L::kPf + r] : c[L::kA + r];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    fwd_out[b * n + px] = quar ? 0.0f : c[L::kFwd + b];
    inn_out[b * n + px] = quar ? 0.0f : c[L::kInn + b];
  }
  const bool moving = ssq >= moving_sq;
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

// A launch configuration of `g` on `stream` with the cluster size set;
// `attr` must outlive the configuration.
cudaLaunchConfig_t launch_config(const Geometry& g, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.clusters * g.ctas), 1, 1);
  cfg.blockDim = dim3((unsigned)g.threads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)g.ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allows the kernel the dynamic shared memory of its largest CTA (a
// full kMaxThreads CTA's columns), once per device: the attribute
// belongs to the current device, and a mesh may launch on several.
template <class Op>
cudaError_t allow_smem() {
  static std::mutex lock;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      fused_gn_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMaxThreads * Column<Op>::kRows * sizeof(float)));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <class Op>
cudaError_t prepare(long long n, int blk, Geometry* g) {
  if (!geometry<Op>(n, blk, g)) return cudaErrorInvalidValue;
  return allow_smem<Op>();
}

}  // namespace

extern "C" {

// Launch the two-stream (p=7, 2 bands) fused Gauss-Newton kernel on
// `stream`: n / blk clusters, one per convergence group of blk pixels
// (blk divides n and is at most 2048).  Arrays are row-major
// (rows, n) float32 on the device; `bounds_host` is a host array
// [lo_0..lo_6, hi_0..hi_6]; `cor` may be null (no corrupted pixels).
// Returns the CUDA error code of the launch (0 on success).
int kafka_fused_gn_twostream(const float* y, const float* w, const float* m,
                             const float* xf, const float* pf,
                             const float* cor, float* x_out, float* a_out,
                             float* fwd_out, float* inn_out, float* st_out,
                             float* hl_out, long long n, int blk,
                             int min_iters, int max_iters, int has_bounds,
                             float relax, float thresh_sq, float moving_sq,
                             const float* bounds_host, void* stream) {
  using Op = TwoStream;
  Geometry g;
  cudaError_t err = prepare<Op>(n, blk, &g);
  if (err != cudaSuccess) return (int)err;
  Bounds<Op::P> bnd;
  for (int k = 0; k < Op::P; ++k) {
    bnd.lo[k] = bounds_host[k];
    bnd.hi[k] = bounds_host[Op::P + k];
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(g, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, fused_gn_kernel<Op>, y, w, m, xf, pf, cor,
                           x_out, a_out, fwd_out, inn_out, st_out, hl_out, n,
                           blk, min_iters, max_iters, has_bounds, relax,
                           thresh_sq, moving_sq, bnd);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch geometry for n pixels in groups of blk: out = [CTAs per
// cluster, threads per CTA, dynamic shared bytes per CTA, clusters the
// card holds at once (cudaOccupancyMaxActiveClusters)].
int kafka_fused_gn_twostream_geometry(long long n, int blk, int* out) {
  using Op = TwoStream;
  Geometry g;
  cudaError_t err = prepare<Op>(n, blk, &g);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(g, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fused_gn_kernel<Op>, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = g.ctas;
  out[1] = g.threads;
  out[2] = (int)g.smem;
  out[3] = clusters;
  return 0;
}

// Registers per thread, local (spill) bytes per thread, static shared
// bytes, and the most threads per block of the compiled kernel.
int kafka_fused_gn_twostream_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, fused_gn_kernel<TwoStream>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kMaxThreads;
  return 0;
}

const char* kafka_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
