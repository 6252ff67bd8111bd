"""Plain reference of the Sentinel-2 PROSAIL configuration: leaf optics by
the generalized plate model, the canopy BRF by the SAIL two-stream
solution with single scattering and a Kuusk hotspot, and the SAIL prior.

Frozen from the closed form the program implements
(``kafka_tpu_torch/obsops/prosail.py``, ``engine/priors.py``), written
over a pixel batch (pixels on the leading axis, bands on the last) in
any floating dtype.  It imports nothing of the program; its spectral
tables are the frozen copy in ``prospect_data.py``.  Clamps are
``torch.maximum`` / ``torch.minimum`` against tensor constants, which
split the tangent at an exact tie as the program's operator does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .prospect_data import BAND_K, N_REFRACT, SOIL_DRY, SOIL_WET

EPS = 1e-6
DEG = math.pi / 180.0
N_PARAMS = 10
N_BANDS = 10
HOTSPOT = 0.01
LOWER = np.array([1.0, 5e-3, 5e-3, 0.0, 5e-3, 5e-3, 5e-3, 0.02, 0.0, 0.0])
UPPER = np.array([3.0, 0.999, 0.999, 1.0, 0.999, 0.999, 0.999, 0.98, 2.0,
                  1.0])


def _tav(alpha_deg: float, n: np.ndarray) -> np.ndarray:
    """Average Fresnel transmittance within a cone of half-angle
    ``alpha`` (PROSPECT's ``tav``), by numerical integration."""
    theta = np.linspace(0.0, np.deg2rad(alpha_deg), 512)[None, :]
    n = np.asarray(n, np.float64)[:, None]
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_r = np.clip(sin_t / n, 0.0, 1.0)
    cos_r = np.sqrt(1.0 - sin_r ** 2)
    rs = ((cos_t - n * cos_r) / (cos_t + n * cos_r)) ** 2
    rp = ((n * cos_t - cos_r) / (n * cos_t + cos_r)) ** 2
    w = sin_t * cos_t
    return ((1.0 - 0.5 * (rs + rp)) * w).sum(axis=1) / np.maximum(
        w.sum(), 1e-12)


def _bf_polynomial() -> np.ndarray:
    """Cubic fit of <cos^2 theta_l> in the average leaf angle over the
    ellipsoidal (Campbell) leaf-angle family."""
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    theta = np.linspace(1e-4, np.pi / 2 - 1e-4, 2000)
    alas, bfs = [], []
    for chi in np.geomspace(0.08, 12.0, 200):
        g = np.sin(theta) / (np.cos(theta) ** 2
                             + chi ** 2 * np.sin(theta) ** 2) ** 2
        g /= trapezoid(g, theta)
        alas.append(np.rad2deg(trapezoid(theta * g, theta)))
        bfs.append(trapezoid(np.cos(theta) ** 2 * g, theta))
    return np.polyfit(np.asarray(alas), np.asarray(bfs), 3)


TAV40 = _tav(40.0, N_REFRACT)
TAV90 = _tav(90.0, N_REFRACT)
BF_POLY = _bf_polynomial()


def _t(a, like):
    """A host constant (float32, as the operator rounds its tables) on
    ``like``'s device in ``like``'s dtype."""
    return torch.as_tensor(np.asarray(a, np.float32), dtype=like.dtype,
                           device=like.device)


def _max(x, v):
    return torch.maximum(x, _t(v, x))


def _min(x, v):
    return torch.minimum(x, _t(v, x))


def _clip(x, lo, hi):
    return _min(_max(x, lo), hi)


def expint_e1(x):
    """Exponential integral E1(x), x > 0 (Abramowitz & Stegun 5.1.53 and
    5.1.56), both branches on clamped inputs."""
    x = _max(x, 1e-8)
    a = (-0.57721566, 0.99999193, -0.24991055, 0.05519968, -0.00976004,
         0.00107857)
    xs = _min(x, 1.0)
    small = (a[0] + xs * (a[1] + xs * (a[2] + xs * (a[3] + xs * (
        a[4] + xs * a[5]))))) - torch.log(xs)
    xl = _max(x, 1.0)
    num = xl * xl + 2.334733 * xl + 0.250621
    den = xl * xl + 3.330657 * xl + 1.681534
    large = torch.exp(-xl) / xl * num / den
    return torch.where(x <= 1.0, small, large)


def plate_model(k, n_layers):
    """Leaf reflectance and transmittance (n, bands) from the per-layer
    absorption ``k`` and the layer count ``n_layers`` (n, 1)."""
    tav_a, tav90, nr = _t(TAV40, k), _t(TAV90, k), _t(N_REFRACT, k)
    k = _max(k, EPS)
    trans = (1.0 - k) * torch.exp(-k) + k ** 2 * expint_e1(k)
    trans = _clip(trans, EPS, 1.0 - EPS)
    t21 = tav90 / nr ** 2
    r21 = 1.0 - t21
    r12 = 1.0 - tav90
    denom = 1.0 - r21 ** 2 * trans ** 2
    ta = tav_a * trans * t21 / denom
    ra = (1.0 - tav_a) + r21 * trans * ta
    t = tav90 * trans * t21 / denom
    r = r12 + r21 * trans * t
    t = _clip(t, EPS, 1.0 - EPS)
    r = _clip(r, EPS, 1.0 - EPS)
    d = torch.sqrt(_max((1.0 + r + t) * (1.0 + r - t) * (1.0 - r + t)
                        * (1.0 - r - t), EPS ** 2))
    rq, tq = r ** 2, t ** 2
    a = (1.0 + rq - tq + d) / (2.0 * r)
    b = (1.0 - rq + tq + d) / (2.0 * t)
    m = _max(n_layers - 1.0, EPS)
    bnm1 = torch.pow(_max(b, 1.0 + EPS), m)
    bn2 = bnm1 ** 2
    a2 = a ** 2
    denom2 = a2 * bn2 - 1.0
    rsub = a * (bn2 - 1.0) / denom2
    tsub = bnm1 * (a2 - 1.0) / denom2
    denom3 = 1.0 - rsub * r
    tran = ta * tsub / denom3
    refl = ra + ta * rsub * t / denom3
    return _clip(refl, 0.0, 1.0), _clip(tran, 0.0, 1.0)


def _j_exp(p, q, lai):
    s = p + q
    s = torch.where(torch.abs(s) < EPS, _t(EPS, s), s)
    return (1.0 - torch.exp(-s * lai)) / s


def sail_fluxes(rho, tau, soil, lai, ks, ko, bf):
    """The exact SAIL two-stream solution with the direct-beam source."""
    ddb, ddf = 0.5 * (1.0 + bf), 0.5 * (1.0 - bf)
    sdb, sdf = 0.5 * (ks + bf), 0.5 * (ks - bf)
    dob, dof = 0.5 * (ko + bf), 0.5 * (ko - bf)
    sigb = ddb * rho + ddf * tau
    sigf = ddf * rho + ddb * tau
    att = 1.0 - sigf
    m = torch.sqrt(_max(att ** 2 - sigb ** 2, 4e-4))
    sb = sdb * rho + sdf * tau
    sf = sdf * rho + sdb * tau
    vb = dob * rho + dof * tau
    vf = dof * rho + dob * tau
    d_res = 0.02
    diff = ks - m
    ks = torch.where(torch.abs(diff) < d_res,
                     m + torch.where(diff >= 0.0, _t(d_res, m),
                                     _t(-d_res, m)), ks)
    det = ks ** 2 - m ** 2
    a_p = (-(att + ks) * sf - sigb * sb) / det
    b_p = (-(att - ks) * sb - sigb * sf) / det
    rinf = sigb / (att + m)
    tss = torch.exp(-ks * lai)
    e_m = torch.exp(-m * lai)
    c12 = e_m
    c21 = (rinf - soil) * e_m
    c22 = 1.0 / rinf - soil
    r1 = -a_p
    r2 = (soil * (a_p + 1.0) - b_p) * tss
    det_bc = c22 - c12 * c21
    det_bc = torch.where(torch.abs(det_bc) < EPS, _t(EPS, det_bc), det_bc)
    aa = (r1 * c22 - c12 * r2) / det_bc
    bb = (r2 - c21 * r1) / det_bc
    d_bottom = aa * e_m + bb + a_p * tss
    u_bottom = soil * (d_bottom + tss)
    j_dec = _j_exp(m, ko, lai)
    s_g = ko - m
    s_g = torch.where(torch.abs(s_g) < 1e-4, _t(1e-4, s_g), s_g)
    j_gro = (torch.exp(-m * lai) - torch.exp(-ko * lai)) / s_g
    j_par = _j_exp(ks, ko, lai)
    rad_leaf = ((vb * rinf + vf) * aa * j_dec
                + (vb / rinf + vf) * bb * j_gro
                + (vb * b_p + vf * a_p) * j_par)
    return rad_leaf, u_bottom, tss


def canopy_brf(rho, tau, soil, lai, ala, sza, vza, raa):
    """Top-of-canopy BRF (n, bands); the angles are Python floats."""
    ts, to, psi = sza * DEG, vza * DEG, raa * DEG
    mu_s = min(max(math.cos(ts), 0.05), 1.0)
    mu_o = min(max(math.cos(to), 0.05), 1.0)
    lai = _max(lai, EPS)
    chi = _clip((57.3 - ala) / 57.3, -0.4, 0.6)

    def g_fn(theta):
        phi1 = 0.5 - 0.633 * chi - 0.33 * chi ** 2
        return phi1 + 0.877 * (1.0 - 2.0 * phi1) * math.cos(theta)

    ks = g_fn(ts) / mu_s
    ko = g_fn(to) / mu_o
    cos_sc = (math.cos(ts) * math.cos(to)
              + math.sin(ts) * math.sin(to) * math.cos(psi))
    gamma = 0.125 * ((rho + tau) * (1.0 + cos_sc)
                     + (rho - tau) * (1.0 - cos_sc))
    delta = math.sqrt(max(math.tan(ts) ** 2 + math.tan(to) ** 2
                          - 2.0 * math.tan(ts) * math.tan(to)
                          * math.cos(psi), 0.0))
    alpha_h = max(delta / max(HOTSPOT, 1e-4), 1e-6)
    c_hs = torch.sqrt(ks * ko) * lai * (1.0 - math.exp(-alpha_h)) / alpha_h
    f_hs = c_hs / _max((ks + ko) * lai, EPS)
    k_two = (ks + ko) * (1.0 - f_hs)
    brf_ss = gamma * (1.0 - torch.exp(-k_two * lai)) / _max(k_two, EPS)
    tau_sso = torch.exp(-k_two * lai)
    c = [float(v) for v in BF_POLY]
    a = _clip(ala, 15.0, 80.0)
    bf = _clip(((c[0] * a + c[1]) * a + c[2]) * a + c[3], 0.02, 0.98)
    rad_leaf, u_bottom, tss = sail_fluxes(rho, tau, soil, lai, ks, ko, bf)
    tau_oo = torch.exp(-ko * lai)
    brf = (brf_ss + rad_leaf + u_bottom * tau_oo - soil * tss * tau_oo
           + soil * tau_sso)
    return _clip(brf, 0.0, 1.0)


def forward(x, sza: float, vza: float, raa: float):
    """(n, 10) transformed PROSAIL state -> (n, 10) Sentinel-2 BRF."""
    def s(i):
        return x[:, i:i + 1]

    n_layers = _clip(s(0), 1.0, 3.0)
    contents = torch.cat([
        -100.0 * torch.log(_clip(s(1), EPS, 1.0 - EPS)),
        -100.0 * torch.log(_clip(s(2), EPS, 1.0 - EPS)),
        _clip(s(3), 0.0, 1.0),
        -(1.0 / 50.0) * torch.log(_clip(s(4), EPS, 1.0 - EPS)),
        -(1.0 / 100.0) * torch.log(_clip(s(5), EPS, 1.0 - EPS)),
    ], dim=1)
    lai = -2.0 * torch.log(_clip(s(6), EPS, 1.0 - EPS))
    ala = 90.0 * _clip(s(7), 0.0, 1.0)
    bsoil = _max(s(8), 0.0)
    psoil = _clip(s(9), 0.0, 1.0)
    k = contents @ _t(BAND_K, x) / _max(n_layers, 1.0)
    rho, tau = plate_model(k, n_layers)
    soil = _clip(bsoil * (psoil * _t(SOIL_DRY, x)
                          + (1.0 - psoil) * _t(SOIL_WET, x)), 0.0, 1.0)
    return canopy_brf(rho, tau, soil, lai, ala, sza, vza, raa)


def sail_prior():
    """(mean, cov, inv_cov) of the S2 PROSAIL prior, float64 numpy (TLAI
    slot at LAI 2)."""
    mean = np.array([2.1, np.exp(-60.0 / 100.0), np.exp(-7.0 / 100.0), 0.1,
                     np.exp(-50 * 0.0176), np.exp(-100.0 * 0.002),
                     np.exp(-4.0 / 2.0), 70.0 / 90.0, 0.5, 0.9])
    sigma = np.array([0.01, 0.2, 0.01, 0.05, 0.01, 0.01, 0.50, 0.1, 0.1,
                      0.1])
    return mean, np.diag(sigma ** 2), np.diag(1.0 / sigma ** 2)
