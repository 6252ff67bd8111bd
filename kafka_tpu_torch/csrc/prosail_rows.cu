// prosail_rows.cu — the PROSAIL value and Jacobian of every pixel in one
// CUDA kernel, written in the row layout of the fused update.
//
// Replaces no Pallas kernel: the JAX package leaves this linearisation to
// jax.jacfwd under XLA (kafka_tpu/obsops/protocol.py:101-113, over the
// closed form of kafka_tpu/obsops/prosail.py).  The port ran it eagerly
// as torch.func.vmap(jacfwd(forward_pixel)) (obsops/protocol.py), some
// 2,000 small elementwise kernels per 262,144-px block, then relaid the
// (B, n, p) Jacobian to rows (core/fused_update.py:jac_to_rows): on a
// 1098 x 1098 Sentinel-2 chunk about 10,000 launches per Gauss-Newton
// trip, the host dispatching them nearly all of the date.  This kernel
// is one launch per trip over the whole chunk.
//
// Per pixel, from the transformed state x (10 rows, n) and the geometry
// (sza, vza, raa in degrees, each one value or one per pixel):
//
//     h0[b]          = PROSAIL reflectance of band b      (10 rows)
//     jac[b*10 + k]  = dh0[b] / dx[k]                     (100 rows)
//
// the layout core/fused_update.py:jac_to_rows produces and the fused
// update takes.
//
// What bounds it on an H100: operations.  A pixel reads 10 floats (and
// up to 3 angles) and writes 110: 480 B/px, 0.58 GB at 1,205,760 px,
// ~0.17 ms at 3.35 TB/s; its arithmetic is about ten thousand float32
// operations, the transcendental ones (exp, log, pow, sqrt, the IEEE
// divisions) on the SFUs and in multi-instruction sequences.  The design:
//
// - One thread per pixel over the (rows, n) layout: neighbouring threads
//   read and write neighbouring pixels of each row, every access
//   coalesced; nothing couples pixels, so the launch covers the chunk.
// - Sparse forward mode.  Each physical quantity depends on one state
//   entry through inverse_transforms; leaf optics per band on (k, N)
//   only, k on n, cab, car, cbrown, cw, cm; soil on bsoil, psoil; the
//   canopy on (lai, ala, rho, tau, soil).  So the plate model carries 2
//   tangents, the band-independent canopy terms 2 (lai, ala), the SAIL
//   fluxes 5; the chain rule composes the 100 entries at the end.  Ten
//   dense tangents would carry about four times the arithmetic.
// - The JAX rules at ties: every clip, maximum and minimum against a
//   constant passes half the tangent where both arguments are equal
//   (obsops/_jaxrules.py), since the solver projects iterates onto
//   bounds that coincide with clip limits; every where evaluates both
//   sides on the same clamped inputs and takes the selected side's
//   tangent.
// - Constants are cast to float32 where the port casts them: the
//   per-band spectra (BAND_K, the tav integrals, N_REFRACT, the soil
//   spectra) and the bf cubic in __constant__ memory, set once per
//   device from the host's arrays (kafka_prosail_rows_constants); the
//   scalar literals of the closed form as float literals.
//
// The per-pixel arithmetic is plain C++ (prosail_pixel): compiled
// without nvcc it is the same function on the host
// (kafka_prosail_rows_host), which the CPU tests hold against
// torch.func.

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KAFKA_HD __host__ __device__ __forceinline__
#else
#define KAFKA_HD inline
#endif

namespace {

constexpr int kBands = 10;
constexpr int kParams = 10;
constexpr float kEps = 1e-6f;
constexpr float kOneMinusEps = (float)(1.0 - 1e-6);
constexpr float kOnePlusEps = (float)(1.0 + 1e-6);
constexpr float kEpsSq = (float)(1e-6 * 1e-6);
constexpr float kDeg = (float)(3.14159265358979323846 / 180.0);

struct ProsailConstants {
  float band_k[5][kBands];  // cab, car, cbrown, cw, cm absorption
  float tav40[kBands];
  float tav90[kBands];
  float n_refract[kBands];
  float soil_dry[kBands];
  float soil_wet[kBands];
  float bf_poly[4];  // highest power first
};

#ifdef __CUDACC__
__constant__ ProsailConstants kConst;
#else
ProsailConstants kConst;
#endif

// -- forward-mode numbers ---------------------------------------------------

template <int N>
struct Dual {
  float v;
  float d[N];
};

template <int N>
KAFKA_HD Dual<N> constant(float v) {
  Dual<N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = 0.0f;
  return r;
}

template <int N>
KAFKA_HD Dual<N> seed(float v, int slot) {
  Dual<N> r = constant<N>(v);
  r.d[slot] = 1.0f;
  return r;
}

// Widen a band-independent (lai, ala) number into the SAIL slots, whose
// first two are lai and ala.
template <int N, int M>
KAFKA_HD Dual<N> widen(const Dual<M>& a) {
  Dual<N> r = constant<N>(a.v);
#pragma unroll
  for (int i = 0; i < M; ++i) r.d[i] = a.d[i];
  return r;
}

// r.d = a.d * g, the chain rule of a function of one argument.
template <int N>
KAFKA_HD Dual<N> chain(float v, const Dual<N>& a, float g) {
  Dual<N> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * g;
  return r;
}

template <int N>
KAFKA_HD Dual<N> operator+(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

template <int N>
KAFKA_HD Dual<N> operator-(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

template <int N>
KAFKA_HD Dual<N> operator-(const Dual<N>& a) {
  return chain(-a.v, a, -1.0f);
}

template <int N>
KAFKA_HD Dual<N> operator*(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

// The value divides; the tangents multiply by one reciprocal (a
// division is a multi-instruction sequence, one per tangent otherwise).
template <int N>
KAFKA_HD Dual<N> operator/(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = a.v / b.v;
  const float inv = 1.0f / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = (a.d[i] - r.v * b.d[i]) * inv;
  return r;
}

template <int N>
KAFKA_HD Dual<N> operator+(const Dual<N>& a, float c) {
  Dual<N> r = a;
  r.v = a.v + c;
  return r;
}

template <int N>
KAFKA_HD Dual<N> operator+(float c, const Dual<N>& a) {
  Dual<N> r = a;
  r.v = c + a.v;
  return r;
}

template <int N>
KAFKA_HD Dual<N> operator-(const Dual<N>& a, float c) {
  Dual<N> r = a;
  r.v = a.v - c;
  return r;
}

template <int N>
KAFKA_HD Dual<N> operator-(float c, const Dual<N>& a) {
  return chain(c - a.v, a, -1.0f);
}

template <int N>
KAFKA_HD Dual<N> operator*(const Dual<N>& a, float c) {
  return chain(a.v * c, a, c);
}

template <int N>
KAFKA_HD Dual<N> operator*(float c, const Dual<N>& a) {
  return chain(c * a.v, a, c);
}

template <int N>
KAFKA_HD Dual<N> operator/(const Dual<N>& a, float c) {
  return chain(a.v / c, a, 1.0f / c);
}

template <int N>
KAFKA_HD Dual<N> operator/(float c, const Dual<N>& a) {
  const float v = c / a.v;
  return chain(v, a, -v / a.v);
}

template <int N>
KAFKA_HD Dual<N> dexp(const Dual<N>& a) {
  const float e = expf(a.v);
  return chain(e, a, e);
}

template <int N>
KAFKA_HD Dual<N> dlog(const Dual<N>& a) {
  return chain(logf(a.v), a, 1.0f / a.v);
}

template <int N>
KAFKA_HD Dual<N> dsqrt(const Dual<N>& a) {
  const float v = sqrtf(a.v);
  return chain(v, a, 1.0f / (2.0f * v));
}

// x ** 2 (torch.pow with the exponent 2: x * x, tangent 2 x).
template <int N>
KAFKA_HD Dual<N> sq(const Dual<N>& a) {
  return chain(a.v * a.v, a, 2.0f * a.v);
}

// torch.pow(a, b) of two tensors.
template <int N>
KAFKA_HD Dual<N> dpow(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = powf(a.v, b.v);
  const float ga = b.v == 0.0f ? 0.0f : b.v * powf(a.v, b.v - 1.0f);
  const float gb = (a.v == 0.0f && b.v >= 0.0f) ? 0.0f : r.v * logf(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * ga + b.d[i] * gb;
  return r;
}

// The JAX rule of maximum / minimum against a constant: the whole
// tangent where x wins, half of it at a tie, none where c wins; NaN
// propagates with no tangent.
KAFKA_HD float max_factor(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

KAFKA_HD float min_factor(float x, float c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

KAFKA_HD float max_value(float x, float c) { return x < c ? c : x; }

KAFKA_HD float min_value(float x, float c) { return x > c ? c : x; }

template <int N>
KAFKA_HD Dual<N> dmax(const Dual<N>& a, float c) {
  return chain(max_value(a.v, c), a, max_factor(a.v, c));
}

template <int N>
KAFKA_HD Dual<N> dmin(const Dual<N>& a, float c) {
  return chain(min_value(a.v, c), a, min_factor(a.v, c));
}

template <int N>
KAFKA_HD Dual<N> dclip(const Dual<N>& a, float lo, float hi) {
  return dmin(dmax(a, lo), hi);
}

template <int N>
KAFKA_HD Dual<N> select(bool cond, const Dual<N>& a, const Dual<N>& b) {
  return cond ? a : b;
}

// A clip of a state entry: its value, and into *g the derivative factor.
KAFKA_HD float clip_scalar(float x, float lo, float hi, float* g) {
  const float y = max_value(x, lo);
  *g = max_factor(x, lo) * min_factor(y, hi);
  return min_value(y, hi);
}

// -- the closed form (obsops/prosail.py, term for term) ---------------------

// Exponential integral E1 (Abramowitz & Stegun 5.1.53 / 5.1.56).
template <int N>
KAFKA_HD Dual<N> expint_e1(const Dual<N>& x_in) {
  const Dual<N> x = dmax(x_in, 1e-8f);
  const Dual<N> xs = dmin(x, 1.0f);
  const Dual<N> small =
      (-0.57721566f +
       xs * (0.99999193f +
             xs * (-0.24991055f +
                   xs * (0.05519968f +
                         xs * (-0.00976004f + xs * 0.00107857f))))) -
      dlog(xs);
  const Dual<N> xl = dmax(x, 1.0f);
  const Dual<N> num = xl * xl + 2.334733f * xl + 0.250621f;
  const Dual<N> den = xl * xl + 3.330657f * xl + 1.681534f;
  const Dual<N> large = dexp(-xl) / xl * num / den;
  return select(x.v <= 1.0f, small, large);
}

// Leaf reflectance and transmittance of band b from the per-layer
// absorption k (tangent slot 0) and the layer count n_layers (slot 1).
KAFKA_HD void plate_model(int b, const Dual<2>& k_in, const Dual<2>& n_layers,
                          Dual<2>* refl_out, Dual<2>* tran_out) {
  const Dual<2> k = dmax(k_in, kEps);
  Dual<2> trans = (1.0f - k) * dexp(-k) + sq(k) * expint_e1(k);
  trans = dclip(trans, kEps, kOneMinusEps);

  const float tav90 = kConst.tav90[b];
  const float nr = kConst.n_refract[b];
  const float t21 = tav90 / (nr * nr);
  const float r21 = 1.0f - t21;
  const float r12 = 1.0f - tav90;
  const float talf = kConst.tav40[b];
  const float ralf = 1.0f - talf;
  const Dual<2> denom = 1.0f - (r21 * r21) * sq(trans);
  const Dual<2> ta = talf * trans * t21 / denom;
  const Dual<2> ra = ralf + r21 * trans * ta;
  Dual<2> t = tav90 * trans * t21 / denom;
  Dual<2> r = r12 + r21 * trans * t;

  // Stokes system for the remaining N-1 layers (eigenvalue form).
  t = dclip(t, kEps, kOneMinusEps);
  r = dclip(r, kEps, kOneMinusEps);
  const Dual<2> d = dsqrt(dmax(
      (1.0f + r + t) * (1.0f + r - t) * (1.0f - r + t) * (1.0f - r - t),
      kEpsSq));
  const Dual<2> rq = sq(r);
  const Dual<2> tq = sq(t);
  const Dual<2> a = (1.0f + rq - tq + d) / (2.0f * r);
  const Dual<2> bb = (1.0f - rq + tq + d) / (2.0f * t);
  const Dual<2> m = dmax(n_layers - 1.0f, kEps);
  const Dual<2> bnm1 = dpow(dmax(bb, kOnePlusEps), m);
  const Dual<2> bn2 = sq(bnm1);
  const Dual<2> a2 = sq(a);
  const Dual<2> denom2 = a2 * bn2 - 1.0f;
  const Dual<2> rsub = a * (bn2 - 1.0f) / denom2;
  const Dual<2> tsub = bnm1 * (a2 - 1.0f) / denom2;

  const Dual<2> denom3 = 1.0f - rsub * r;
  const Dual<2> tran = ta * tsub / denom3;
  const Dual<2> refl = ra + ta * rsub * t / denom3;
  *refl_out = dclip(refl, 0.0f, 1.0f);
  *tran_out = dclip(tran, 0.0f, 1.0f);
}

// The canopy's tangent slots: the band-independent terms carry the
// first two.
constexpr int kLai = 0, kAla = 1, kRho = 2, kTau = 3, kSoil = 4;
using Canopy = Dual<5>;
using Structure = Dual<2>;

template <int N>
KAFKA_HD Dual<N> j_exp_integral(const Dual<N>& p, const Dual<N>& q,
                                const Dual<N>& lai) {
  Dual<N> s = p + q;
  s = select(fabsf(s.v) < kEps, constant<N>(kEps), s);
  return (1.0f - dexp(-s * lai)) / s;
}

// Band-independent terms of the canopy: functions of (lai, ala) and the
// geometry only.
struct CanopyStructure {
  Structure lai;      // max(lai, eps)
  Structure ks, ko;   // extinction coefficients
  Structure bf;       // <cos^2 theta_l>
  Structure ss_num;   // 1 - exp(-k_two lai)
  Structure ss_den;   // max(k_two, eps)
  Structure tau_sso;  // exp(-k_two lai)
  Structure tau_oo;   // exp(-ko lai)
  float cos_scatter;
};

KAFKA_HD CanopyStructure canopy_structure(float lai_phys, float ala_phys,
                                          float sza, float vza, float raa,
                                          float hotspot) {
  CanopyStructure s;
  const float ts = sza * kDeg;
  const float to = vza * kDeg;
  const float psi = raa * kDeg;
  const float cos_ts = cosf(ts), cos_to = cosf(to), cos_psi = cosf(psi);
  const float mu_s = min_value(max_value(cos_ts, 0.05f), 1.0f);
  const float mu_o = min_value(max_value(cos_to, 0.05f), 1.0f);
  s.lai = dmax(seed<2>(lai_phys, kLai), kEps);

  const Structure ala = seed<2>(ala_phys, kAla);
  const Structure chi = dclip((57.3f - ala) / 57.3f, -0.4f, 0.6f);
  const Structure phi1 = 0.5f - 0.633f * chi - 0.33f * sq(chi);
  const Structure phi2 = 0.877f * (1.0f - 2.0f * phi1);
  s.ks = (phi1 + phi2 * cos_ts) / mu_s;
  s.ko = (phi1 + phi2 * cos_to) / mu_o;

  const float tan_ts = tanf(ts), tan_to = tanf(to);
  s.cos_scatter = cos_ts * cos_to + sinf(ts) * sinf(to) * cos_psi;
  const float delta = sqrtf(max_value(
      tan_ts * tan_ts + tan_to * tan_to - 2.0f * tan_ts * tan_to * cos_psi,
      0.0f));
  const float hs = max_value(hotspot, 1e-4f);
  const float alpha_h = max_value(delta / hs, 1e-6f);
  const Structure c_hs =
      dsqrt(s.ks * s.ko) * s.lai * (1.0f - expf(-alpha_h)) / alpha_h;
  const Structure f_hs = c_hs / dmax((s.ks + s.ko) * s.lai, kEps);
  const Structure k_two = (s.ks + s.ko) * (1.0f - f_hs);
  s.ss_num = 1.0f - dexp(-k_two * s.lai);
  s.ss_den = dmax(k_two, kEps);
  s.tau_sso = dexp(-k_two * s.lai);
  s.tau_oo = dexp(-s.ko * s.lai);

  const Structure a = dclip(ala, 15.0f, 80.0f);
  const float* c = kConst.bf_poly;
  s.bf = dclip(((c[0] * a + c[1]) * a + c[2]) * a + c[3], 0.02f, 0.98f);
  return s;
}

// Top-of-canopy BRF of one band, tangent slots (lai, ala, rho, tau, soil).
KAFKA_HD Canopy canopy_brf(const CanopyStructure& st, float rho_v,
                           float tau_v, float soil_v) {
  const Canopy rho = seed<5>(rho_v, kRho);
  const Canopy tau = seed<5>(tau_v, kTau);
  const Canopy soil = seed<5>(soil_v, kSoil);
  const Canopy lai = widen<5>(st.lai);
  const Canopy ko = widen<5>(st.ko);
  const Canopy bf = widen<5>(st.bf);
  const float cs = st.cos_scatter;
  const Canopy gamma =
      0.125f * ((rho + tau) * (1.0f + cs) + (rho - tau) * (1.0f - cs));
  const Canopy brf_ss = gamma * widen<5>(st.ss_num) / widen<5>(st.ss_den);

  // sail_fluxes: the exact SAIL two-stream solution with the direct-beam
  // source term.
  Canopy ks = widen<5>(st.ks);
  const Canopy ddb = 0.5f * (1.0f + bf), ddf = 0.5f * (1.0f - bf);
  const Canopy sdb = 0.5f * (ks + bf), sdf = 0.5f * (ks - bf);
  const Canopy dob = 0.5f * (ko + bf), dof = 0.5f * (ko - bf);
  const Canopy sigb = ddb * rho + ddf * tau;
  const Canopy sigf = ddf * rho + ddb * tau;
  const Canopy att = 1.0f - sigf;
  const Canopy m = dsqrt(dmax(sq(att) - sq(sigb), 4e-4f));
  const Canopy sb = sdb * rho + sdf * tau;
  const Canopy sf = sdf * rho + sdb * tau;
  const Canopy vb = dob * rho + dof * tau;
  const Canopy vf = dof * rho + dob * tau;

  // ks = m is a removable resonance: nudge ks off it.
  const float d_res = 0.02f;
  const float diff = ks.v - m.v;
  ks = select(fabsf(diff) < d_res, m + (diff >= 0.0f ? d_res : -d_res), ks);
  const Canopy det = sq(ks) - sq(m);
  const Canopy a_p = (-(att + ks) * sf - sigb * sb) / det;
  const Canopy b_p = (-(att - ks) * sb - sigb * sf) / det;

  const Canopy rinf = sigb / (att + m);
  const Canopy tss = dexp(-ks * lai);
  const Canopy e_m = dexp(-m * lai);

  const Canopy c21 = (rinf - soil) * e_m;
  const Canopy c22 = 1.0f / rinf - soil;
  const Canopy r1 = -a_p;
  const Canopy r2 = (soil * (a_p + 1.0f) - b_p) * tss;
  Canopy det_bc = 1.0f * c22 - e_m * c21;
  det_bc = select(fabsf(det_bc.v) < kEps, constant<5>(kEps), det_bc);
  const Canopy aa = (r1 * c22 - e_m * r2) / det_bc;
  const Canopy bb_s = (1.0f * r2 - c21 * r1) / det_bc;

  const Canopy d_bottom = aa * e_m + bb_s + a_p * tss;
  const Canopy u_bottom = soil * (d_bottom + tss);

  const Canopy j_dec = j_exp_integral(m, ko, lai);
  Canopy s_g = ko - m;
  s_g = select(fabsf(s_g.v) < 1e-4f, constant<5>(1e-4f), s_g);
  const Canopy j_gro = (dexp(-m * lai) - dexp(-ko * lai)) / s_g;
  const Canopy j_par = j_exp_integral(ks, ko, lai);
  const Canopy rad_leaf = (vb * rinf + vf) * aa * j_dec +
                          (vb / rinf + vf) * bb_s * j_gro +
                          (vb * b_p + vf * a_p) * j_par;

  const Canopy tau_oo = widen<5>(st.tau_oo);
  const Canopy brf_diffuse =
      rad_leaf + u_bottom * tau_oo - soil * tss * tau_oo;
  const Canopy brf_soil = soil * widen<5>(st.tau_sso);
  return dclip(brf_ss + brf_diffuse + brf_soil, 0.0f, 1.0f);
}

// One pixel: x its 10 state entries; h0 and jac its first entries of
// rows `stride` apart.
KAFKA_HD void prosail_pixel(const float* x, float sza, float vza, float raa,
                            float hotspot, float* h0, float* jac,
                            long long stride) {
  // inverse_transforms, each quantity with its derivative in its entry.
  float g_n, g1, g2, g_cbrown, g4, g5, g6, g_ala, g_psoil;
  const float nl = clip_scalar(x[0], 1.0f, 3.0f, &g_n);
  const float c1 = clip_scalar(x[1], kEps, kOneMinusEps, &g1);
  const float c2 = clip_scalar(x[2], kEps, kOneMinusEps, &g2);
  const float c4 = clip_scalar(x[4], kEps, kOneMinusEps, &g4);
  const float c5 = clip_scalar(x[5], kEps, kOneMinusEps, &g5);
  const float c6 = clip_scalar(x[6], kEps, kOneMinusEps, &g6);
  const float content[5] = {
      -100.0f * logf(c1), -100.0f * logf(c2),
      clip_scalar(x[3], 0.0f, 1.0f, &g_cbrown), -0.02f * logf(c4),
      -0.01f * logf(c5)};
  const float d_content[5] = {-100.0f * (g1 / c1), -100.0f * (g2 / c2),
                              g_cbrown, -0.02f * (g4 / c4),
                              -0.01f * (g5 / c5)};
  const float lai = -2.0f * logf(c6);
  const float d_lai = -2.0f * (g6 / c6);
  const float ala = 90.0f * clip_scalar(x[7], 0.0f, 1.0f, &g_ala);
  const float d_ala = 90.0f * g_ala;
  const float bsoil = max_value(x[8], 0.0f);
  const float d_bsoil = max_factor(x[8], 0.0f);
  const float psoil = clip_scalar(x[9], 0.0f, 1.0f, &g_psoil);

  // leaf_optics divides by max(n, 1): its derivative in x[0].
  const float n_div = max_value(nl, 1.0f);
  const float d_n_div = max_factor(nl, 1.0f) * g_n;

  const CanopyStructure st = canopy_structure(lai, ala, sza, vza, raa,
                                              hotspot);

#pragma unroll 1
  for (int b = 0; b < kBands; ++b) {
    float s = kConst.band_k[0][b] * content[0];
#pragma unroll
    for (int i = 1; i < 5; ++i) s = s + kConst.band_k[i][b] * content[i];
    const float k = s / n_div;
    Dual<2> rho, tau;
    plate_model(b, seed<2>(k, 0), seed<2>(nl, 1), &rho, &tau);

    const float dry = kConst.soil_dry[b], wet = kConst.soil_wet[b];
    const float mix = psoil * dry + (1.0f - psoil) * wet;
    const float soil_raw = bsoil * mix;
    const float soil = min_value(max_value(soil_raw, 0.0f), 1.0f);
    const float g_soil =
        max_factor(soil_raw, 0.0f) * min_factor(max_value(soil_raw, 0.0f),
                                                1.0f);

    const Canopy brf = canopy_brf(st, rho.v, tau.v, soil);
    h0[b * stride] = brf.v;

    // The chain rule back to the 10 state entries.
    const float g_rho = brf.d[kRho], g_tau = brf.d[kTau];
    const float g_k = g_rho * rho.d[0] + g_tau * tau.d[0];
    const float dk_dn = -(k * d_n_div) / n_div;
    float* jb = jac + (long long)b * kParams * stride;
    jb[0] = g_k * dk_dn + (g_rho * rho.d[1] + g_tau * tau.d[1]) * g_n;
#pragma unroll
    for (int i = 0; i < 5; ++i)
      jb[(1 + i) * stride] =
          g_k * ((kConst.band_k[i][b] * d_content[i]) / n_div);
    jb[6 * stride] = brf.d[kLai] * d_lai;
    jb[7 * stride] = brf.d[kAla] * d_ala;
    jb[8 * stride] = brf.d[kSoil] * (g_soil * mix * d_bsoil);
    jb[9 * stride] =
        brf.d[kSoil] * (g_soil * bsoil * (dry - wet) * g_psoil);
  }
}

int set_constants(const float* values, int count) {
  if (count != (int)(sizeof(ProsailConstants) / sizeof(float))) return -1;
#ifdef __CUDACC__
  return (int)cudaMemcpyToSymbol(kConst, values, sizeof(ProsailConstants));
#else
  memcpy(&kConst, values, sizeof(ProsailConstants));
  return 0;
#endif
}

#ifdef __CUDACC__

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) prosail_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ sza, int sza_step,
    const float* __restrict__ vza, int vza_step,
    const float* __restrict__ raa, int raa_step, float hotspot,
    float* __restrict__ h0, float* __restrict__ jac, long long n) {
  const long long px = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (px >= n) return;
  float xv[kParams];
#pragma unroll
  for (int k = 0; k < kParams; ++k) xv[k] = x[k * n + px];
  prosail_pixel(xv, sza[px * sza_step], vza[px * vza_step],
                raa[px * raa_step], hotspot, h0 + px, jac + px, n);
}

#endif

}  // namespace

extern "C" {

// Copy the per-band constants (ProsailConstants, `count` floats, from
// host memory) to the current device; once per device, before its first
// launch.  Returns 0, the CUDA error code, or -1 for a wrong count.
int kafka_prosail_rows_constants(const float* values, int count) {
  return set_constants(values, count);
}

#ifdef __CUDACC__

// Launch on `stream`: x (10, n) float32 rows on the device; each angle a
// device pointer read at px * step (step 0: one value for all pixels, 1:
// one per pixel); outputs h0 (10, n) and jac (100, n).  Returns the CUDA
// error code of the launch (0 on success).
int kafka_prosail_rows(const float* x, const float* sza, int sza_step,
                       const float* vza, int vza_step, const float* raa,
                       int raa_step, float hotspot, float* h0, float* jac,
                       long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  prosail_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      x, sza, sza_step, vza, vza_step, raa, raa_step, hotspot, h0, jac, n);
  return (int)cudaGetLastError();
}

int kafka_prosail_rows_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, prosail_rows_kernel);
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

#else

// The same arithmetic on the host, pixel after pixel (the CPU tests'
// build of this file): the arguments of kafka_prosail_rows, host
// pointers, no stream.
int kafka_prosail_rows_host(const float* x, const float* sza, int sza_step,
                            const float* vza, int vza_step, const float* raa,
                            int raa_step, float hotspot, float* h0,
                            float* jac, long long n) {
  for (long long px = 0; px < n; ++px) {
    float xv[kParams];
    for (int k = 0; k < kParams; ++k) xv[k] = x[k * n + px];
    prosail_pixel(xv, sza[px * sza_step], vza[px * vza_step],
                  raa[px * raa_step], hotspot, h0 + px, jac + px, n);
  }
  return 0;
}

#endif

}  // extern "C"
