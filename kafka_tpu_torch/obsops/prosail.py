"""Differentiable PROSAIL-family canopy reflectance operator (port of
``kafka_tpu/obsops/prosail.py``).

The 10-parameter transformed state of the reference's Sentinel-2 path:

    [n, cab, car, cbrown, cw, cm, lai, ala, bsoil, psoil]

Leaf optics by the generalized plate model (PROSPECT construction) and
the canopy BRF by a SAIL-family two-stream solution with single
scattering and a Kuusk hotspot, all closed form and term for term as in
the JAX package; the value and Jacobian come from ``torch.func``
(``ObservationModel.linearize``).

Three rules keep the derivatives equal to JAX's:

- every ``clip``, ``maximum`` and ``minimum`` goes through ``_jaxrules``
  (half the tangent at an exact tie, as ``jnp.clip`` does).  The solver
  projects iterates onto the state bounds, and the bounds of n, cbrown,
  bsoil and psoil coincide with clip limits in ``inverse_transforms``;
- state-dependent scalars are ``(1,)``-shaped slices, never 0-d tensors:
  under ``torch.func.jacfwd`` a 0-d tensor times a Python float gets a
  float64 tangent;
- guarded branches (``expint_e1``, the determinant guards) evaluate both
  sides of the ``where`` on the same clamped inputs as JAX, so the
  unselected side's tangent stays finite.

Host constants (``_tav_host``, ``_fit_bf_polynomial``) are computed with
numpy exactly as in the JAX package and cast to float32 where it casts.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._jaxrules import _clip, _max, _min
from .prospect_data import BAND_K, N_REFRACT, SOIL_DRY, SOIL_WET
from .protocol import ObservationModel

_EPS = 1e-6
_DEG = math.pi / 180.0


def _tav_host(alpha_deg: float, n: np.ndarray) -> np.ndarray:
    """Average Fresnel transmittance of the air->leaf interface within a
    cone of half-angle ``alpha`` (PROSPECT's ``tav``), by numerical
    integration on the host; per-band constants only."""
    theta = np.linspace(0.0, np.deg2rad(alpha_deg), 512)[None, :]
    n = np.asarray(n, np.float64)[:, None]
    sin_t = np.sin(theta)
    cos_t = np.cos(theta)
    sin_r = np.clip(sin_t / n, 0.0, 1.0)
    cos_r = np.sqrt(1.0 - sin_r**2)
    rs = ((cos_t - n * cos_r) / (cos_t + n * cos_r)) ** 2
    rp = ((n * cos_t - cos_r) / (n * cos_t + cos_r)) ** 2
    t = 1.0 - 0.5 * (rs + rp)
    w = sin_t * cos_t
    return (t * w).sum(axis=1) / np.maximum(w.sum(), 1e-12)


_TAV40 = _tav_host(40.0, N_REFRACT)
_TAV90 = _tav_host(90.0, N_REFRACT)


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    """A host constant as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=like.device)


def expint_e1(x):
    """Exponential integral E1(x) for x > 0 (Abramowitz & Stegun 5.1.53 /
    5.1.56), branch-free."""
    x = _max(x, 1e-8)
    a = (-0.57721566, 0.99999193, -0.24991055, 0.05519968, -0.00976004,
         0.00107857)
    xs = _min(x, 1.0)
    small = (
        a[0] + xs * (a[1] + xs * (a[2] + xs * (a[3] + xs * (a[4] + xs
                                                             * a[5]))))
        - torch.log(xs)
    )
    xl = _max(x, 1.0)
    num = xl * xl + 2.334733 * xl + 0.250621
    den = xl * xl + 3.330657 * xl + 1.681534
    large = torch.exp(-xl) / xl * num / den
    return torch.where(x <= 1.0, small, large)


def plate_model(k, tav_alpha, tav90, n, n_layers):
    """Leaf reflectance/transmittance from per-layer absorption ``k``:
    the generalized plate model in its Stokes closed form."""
    k = _max(k, _EPS)
    trans = (1.0 - k) * torch.exp(-k) + k**2 * expint_e1(k)
    trans = _clip(trans, _EPS, 1.0 - _EPS)

    t21 = tav90 / n**2
    r21 = 1.0 - t21
    r12 = 1.0 - tav90
    talf = tav_alpha
    ralf = 1.0 - talf
    denom = 1.0 - r21**2 * trans**2
    ta = talf * trans * t21 / denom
    ra = ralf + r21 * trans * ta
    t = tav90 * trans * t21 / denom
    r = r12 + r21 * trans * t

    # Stokes system for the remaining N-1 layers (eigenvalue form).
    t = _clip(t, _EPS, 1.0 - _EPS)
    r = _clip(r, _EPS, 1.0 - _EPS)
    d = torch.sqrt(_max(
        ((1.0 + r + t) * (1.0 + r - t) * (1.0 - r + t) * (1.0 - r - t)),
        _EPS**2,
    ))
    rq, tq = r**2, t**2
    a = (1.0 + rq - tq + d) / (2.0 * r)
    b = (1.0 - rq + tq + d) / (2.0 * t)
    m = _max(n_layers - 1.0, _EPS)
    bnm1 = torch.pow(_max(b, 1.0 + _EPS), m)
    bn2 = bnm1**2
    a2 = a**2
    denom2 = a2 * bn2 - 1.0
    rsub = a * (bn2 - 1.0) / denom2
    tsub = bnm1 * (a2 - 1.0) / denom2

    denom3 = 1.0 - rsub * r
    tran = ta * tsub / denom3
    refl = ra + ta * rsub * t / denom3
    return _clip(refl, 0.0, 1.0), _clip(tran, 0.0, 1.0)


def leaf_optics(n_layers, cab, car, cbrown, cw, cm):
    """(rho, tau) per band from the constituent contents (each a
    ``(1,)`` tensor)."""
    kk = _f32(BAND_K, n_layers)
    contents = torch.cat([cab, car, cbrown, cw, cm])
    k = (kk * contents[:, None]).sum(dim=0) / _max(n_layers, 1.0)
    return plate_model(k, _f32(_TAV40, k), _f32(_TAV90, k),
                       _f32(N_REFRACT, k), n_layers)


def g_function(theta, chi_l):
    """Ross-Goudriaan projection function G(theta) for Ross index
    ``chi_l``."""
    phi1 = 0.5 - 0.633 * chi_l - 0.33 * chi_l**2
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    return phi1 + phi2 * torch.cos(theta)


def ala_to_chi(ala_deg):
    """Average leaf angle (deg) -> Ross-Goudriaan index, clipped."""
    return _clip((57.3 - ala_deg) / 57.3, -0.4, 0.6)


def _fit_bf_polynomial() -> np.ndarray:
    """Host-side cubic fit of ``bf = <cos^2 theta_l>`` in the average leaf
    angle (degrees) over the ellipsoidal (Campbell) LIDF family."""
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    theta = np.linspace(1e-4, np.pi / 2 - 1e-4, 2000)
    chis = np.geomspace(0.08, 12.0, 200)
    alas, bfs = [], []
    for chi in chis:
        g = np.sin(theta) / (
            np.cos(theta) ** 2 + chi**2 * np.sin(theta) ** 2
        ) ** 2
        g /= trapezoid(g, theta)
        alas.append(np.rad2deg(trapezoid(theta * g, theta)))
        bfs.append(trapezoid(np.cos(theta) ** 2 * g, theta))
    return np.polyfit(np.asarray(alas), np.asarray(bfs), 3)


_BF_POLY = _fit_bf_polynomial()


def bf_from_ala(ala_deg):
    """Second LIDF moment <cos^2 theta_l> from the average leaf angle."""
    c = [float(v) for v in _BF_POLY]
    a = _clip(ala_deg, 15.0, 80.0)
    return _clip(((c[0] * a + c[1]) * a + c[2]) * a + c[3], 0.02, 0.98)


def _j_exp_integral(p, q, lai):
    """int_0^L e^{-p x} e^{-q x} dx = (1 - e^{-(p+q)L}) / (p+q), guarded."""
    s = p + q
    s = torch.where(torch.abs(s) < _EPS, _EPS, s)
    return (1.0 - torch.exp(-s * lai)) / s


def sail_fluxes(rho_l, tau_l, soil, lai, ks, ko, bf):
    """Exact SAIL two-stream solution with the direct-beam source term
    (the JAX ``sail_fluxes``, term for term)."""
    ddb, ddf = 0.5 * (1.0 + bf), 0.5 * (1.0 - bf)
    sdb, sdf = 0.5 * (ks + bf), 0.5 * (ks - bf)
    dob, dof = 0.5 * (ko + bf), 0.5 * (ko - bf)
    sigb = ddb * rho_l + ddf * tau_l
    sigf = ddf * rho_l + ddb * tau_l
    att = 1.0 - sigf
    m = torch.sqrt(_max(att**2 - sigb**2, 4e-4))
    sb = sdb * rho_l + sdf * tau_l
    sf = sdf * rho_l + sdb * tau_l
    vb = dob * rho_l + dof * tau_l
    vf = dof * rho_l + dob * tau_l

    # ks = m is a removable resonance: nudge ks off it (JAX comment).
    d_res = 0.02
    diff = ks - m
    ks = torch.where(
        torch.abs(diff) < d_res,
        m + torch.where(diff >= 0.0, d_res, -d_res),
        ks,
    )
    det = ks**2 - m**2
    a_p = (-(att + ks) * sf - sigb * sb) / det
    b_p = (-(att - ks) * sb - sigb * sf) / det

    rinf = sigb / (att + m)
    tss = torch.exp(-ks * lai)
    e_m = torch.exp(-m * lai)

    c11, c12 = 1.0, e_m
    c21 = (rinf - soil) * e_m
    c22 = 1.0 / rinf - soil
    r1 = -a_p
    r2 = (soil * (a_p + 1.0) - b_p) * tss
    det_bc = c11 * c22 - c12 * c21
    det_bc = torch.where(torch.abs(det_bc) < _EPS, _EPS, det_bc)
    aa = (r1 * c22 - c12 * r2) / det_bc
    bb_s = (c11 * r2 - c21 * r1) / det_bc

    d_bottom = aa * e_m + bb_s + a_p * tss
    u_bottom = soil * (d_bottom + tss)

    j_dec = _j_exp_integral(m, ko, lai)
    s_g = ko - m
    s_g = torch.where(torch.abs(s_g) < 1e-4, 1e-4, s_g)
    j_gro = (torch.exp(-m * lai) - torch.exp(-ko * lai)) / s_g
    j_par = _j_exp_integral(ks, ko, lai)
    rad_leaf = (
        (vb * rinf + vf) * aa * j_dec
        + (vb / rinf + vf) * bb_s * j_gro
        + (vb * b_p + vf * a_p) * j_par
    )
    return {
        "rad_leaf": rad_leaf,
        "u_bottom": u_bottom,
        "d_bottom": d_bottom,
        "tss": tss,
        "rdd_top": aa * rinf + bb_s / rinf * e_m + b_p,
        "m": m, "rinf": rinf, "a_p": a_p, "b_p": b_p,
        "aa": aa, "bb_scaled": bb_s,
        "sigb": sigb, "sigf": sigf, "sb": sb, "sf": sf,
        "vb": vb, "vf": vf,
    }


def canopy_brf(rho_l, tau_l, soil, lai, ala_deg, sza_deg, vza_deg, raa_deg,
               hotspot: float = 0.01):
    """Top-of-canopy BRF per band: single scattering with a Kuusk
    hotspot, the exact diffuse field (``sail_fluxes``) and the
    hotspot-correlated soil term."""
    ts = sza_deg * _DEG
    to = vza_deg * _DEG
    psi = raa_deg * _DEG
    mu_s = _clip(torch.cos(ts), 0.05, 1.0)
    mu_o = _clip(torch.cos(to), 0.05, 1.0)
    lai = _max(lai, _EPS)

    chi = ala_to_chi(ala_deg)
    gs = g_function(ts, chi)
    go = g_function(to, chi)
    ks = gs / mu_s
    ko = go / mu_o

    cos_scatter = (
        torch.cos(ts) * torch.cos(to)
        + torch.sin(ts) * torch.sin(to) * torch.cos(psi)
    )
    w = rho_l + tau_l
    gamma = 0.125 * (
        w * (1.0 + cos_scatter) + (rho_l - tau_l) * (1.0 - cos_scatter)
    )

    delta = torch.sqrt(
        _max(
            torch.tan(ts) ** 2 + torch.tan(to) ** 2
            - 2.0 * torch.tan(ts) * torch.tan(to) * torch.cos(psi),
            0.0,
        )
    )
    alpha_h = _max(delta / max(hotspot, 1e-4), 1e-6)
    c_hs = torch.sqrt(ks * ko) * lai * (1.0 - torch.exp(-alpha_h)) / alpha_h
    f_hs = c_hs / _max((ks + ko) * lai, _EPS)
    k_two = (ks + ko) * (1.0 - f_hs)
    brf_ss = gamma * (1.0 - torch.exp(-k_two * lai)) / _max(k_two, _EPS)
    tau_sso = torch.exp(-k_two * lai)

    fx = sail_fluxes(rho_l, tau_l, soil, lai, ks, ko, bf_from_ala(ala_deg))
    tau_oo = torch.exp(-ko * lai)
    brf_diffuse = fx["rad_leaf"] + fx["u_bottom"] * tau_oo \
        - soil * fx["tss"] * tau_oo
    brf_soil = soil * tau_sso

    brf = brf_ss + brf_diffuse + brf_soil
    return _clip(brf, 0.0, 1.0)


class ProsailAux(NamedTuple):
    """Per-date acquisition geometry (degrees), broadcast or per pixel."""

    sza: torch.Tensor
    vza: torch.Tensor
    raa: torch.Tensor


#: The 10-parameter transformed state of the reference S2 configuration.
PROSAIL_PARAMETER_LIST = (
    "n", "cab", "car", "cbrown", "cw", "cm", "lai", "ala", "bsoil", "psoil",
)


def inverse_transforms(x):
    """Transformed state -> physical PROSAIL quantities, each a ``(1,)``
    slice of the ``(10,)`` state."""
    def s(i):
        return x[i:i + 1]

    n = _clip(s(0), 1.0, 3.0)
    cab = -100.0 * torch.log(_clip(s(1), _EPS, 1.0 - _EPS))
    car = -100.0 * torch.log(_clip(s(2), _EPS, 1.0 - _EPS))
    cbrown = _clip(s(3), 0.0, 1.0)
    cw = -(1.0 / 50.0) * torch.log(_clip(s(4), _EPS, 1.0 - _EPS))
    cm = -(1.0 / 100.0) * torch.log(_clip(s(5), _EPS, 1.0 - _EPS))
    lai = -2.0 * torch.log(_clip(s(6), _EPS, 1.0 - _EPS))
    ala = 90.0 * _clip(s(7), 0.0, 1.0)
    bsoil = _max(s(8), 0.0)
    psoil = _clip(s(9), 0.0, 1.0)
    return n, cab, car, cbrown, cw, cm, lai, ala, bsoil, psoil


class ProsailOperator(ObservationModel):
    """10-band S2 reflectance operator on the transformed PROSAIL state.
    ``aux`` is a ``ProsailAux`` of angle tensors, each 0-d (broadcast) or
    ``(n_pix,)`` (per pixel), or None for sza 30, vza 0, raa 0."""

    n_bands = 10
    n_params = 10
    state_bounds = (
        np.array([1.0, 5e-3, 5e-3, 0.0, 5e-3, 5e-3, 5e-3, 0.02, 0.0, 0.0],
                 np.float32),
        np.array([3.0, 0.999, 0.999, 1.0, 0.999, 0.999, 0.999, 0.98, 2.0,
                  1.0], np.float32),
    )

    def __init__(self, hotspot: float = 0.01):
        self.hotspot = float(hotspot)

    def forward_pixel(self, aux: Optional[ProsailAux], x_pixel):
        if aux is None:
            aux = ProsailAux(*(torch.tensor(v, dtype=torch.float32,
                                            device=x_pixel.device)
                               for v in (30.0, 0.0, 0.0)))
        n, cab, car, cbrown, cw, cm, lai, ala, bsoil, psoil = (
            inverse_transforms(x_pixel)
        )
        rho_l, tau_l = leaf_optics(n, cab, car, cbrown, cw, cm)
        soil = bsoil * (
            psoil * _f32(SOIL_DRY, x_pixel)
            + (1.0 - psoil) * _f32(SOIL_WET, x_pixel)
        )
        soil = _clip(soil, 0.0, 1.0)
        return canopy_brf(
            rho_l, tau_l, soil, lai, ala, aux.sza, aux.vza, aux.raa,
            hotspot=self.hotspot,
        )
