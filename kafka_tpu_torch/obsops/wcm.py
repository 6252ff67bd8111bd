"""Water-Cloud Model (WCM), the analytic SAR backscatter operator (port of
``kafka_tpu/obsops/wcm.py``):

    tau        = exp(-2 B V / cos(theta))
    sigma_veg  = A * V**E * cos(theta) * (1 - tau)
    sigma_soil = 10 ** ((C + D * SM) / 10)
    sigma_0    = sigma_veg + tau * sigma_soil

with the published per-polarisation fits for VV and VH.  The value and
Jacobian come from ``torch.func`` (``ObservationModel.linearize``), as
they come from ``jax.jacfwd`` in the JAX package.

- The incidence angle reaches the operator per pixel (or broadcast)
  through ``WCMAux``.
- V and SM are clamped to ``_EPS`` through ``_jaxrules._max``: at an
  exact tie the tangent splits half and half, as ``jnp.maximum`` does.
  The solver's lower bound (1e-3) is not ``_EPS``, but a clamp keeps the
  JAX rule wherever an iterate lands.
- VH has E = 0, so ``V ** 0`` is constant: its derivative is
  ``0 * V ** -1``, which is 0 (not NaN) at the clamp, V >= ``_EPS`` > 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ._jaxrules import _max
from .protocol import ObservationModel

# Published WCM fits (A, B, C, D, E) per polarisation.
WCM_PARAMETERS = {
    "VV": (0.0846, 0.0615, -14.8465, 15.907, 1.0),
    "VH": (0.0795, 0.1464, -14.8332, 15.907, 0.0),
}

_EPS = 1e-6


class WCMAux(NamedTuple):
    """Per-pixel auxiliary data: incidence angle in degrees, ``(n_pix,)``
    or 0-d (broadcast)."""

    theta_deg: torch.Tensor


def wcm_sigma0(v, sm, theta_deg, coeffs):
    """Backscatter (linear units, not dB) for vegetation descriptor ``v``
    (e.g. LAI) and soil moisture ``sm``; ``coeffs`` is (A, B, C, D, E)."""
    a, b, c, d, e = (float(np.float32(k)) for k in coeffs)
    mu = torch.cos(theta_deg * (math.pi / 180.0))
    v = _max(v, _EPS)
    sm = _max(sm, _EPS)
    tau = torch.exp(-2.0 * b * v / mu)
    sigma_veg = a * torch.pow(v, e) * mu * (1.0 - tau)
    sigma_soil = torch.pow(10.0, (c + d * sm) / 10.0)
    return sigma_veg + tau * sigma_soil


class WCMOperator(ObservationModel):
    """Dual-polarisation (VV, VH) WCM on a state whose parameters
    ``v_index`` and ``sm_index`` are (vegetation descriptor, soil
    moisture); ``aux`` is a ``WCMAux``."""

    def __init__(self, n_params: int = 2, v_index: int = 0, sm_index: int = 1,
                 polarisations=("VV", "VH")):
        self.n_params = n_params
        if n_params == 2 and (v_index, sm_index) == (0, 1):
            # physical domain: LAI in (0, 10], SM in (0, 0.6] m^3/m^3
            self.state_bounds = (
                np.array([1e-3, 1e-3], np.float32),
                np.array([10.0, 0.6], np.float32),
            )
        self.v_index = v_index
        self.sm_index = sm_index
        self.polarisations = tuple(polarisations)
        for pol in self.polarisations:
            if pol not in WCM_PARAMETERS:
                raise ValueError(
                    f"unsupported polarisation {pol!r}: WCM "
                    "coefficients are calibrated for VV and VH"
                )
        self.n_bands = len(self.polarisations)
        self._coeffs = np.array(
            [WCM_PARAMETERS[p] for p in self.polarisations], np.float32
        )

    def forward_pixel(self, aux: WCMAux, x_pixel):
        # (1,)-shaped slices, not 0-d scalars: under torch.func.jacfwd a
        # 0-d tensor times a Python float gets a float64 tangent.
        v = x_pixel[self.v_index:self.v_index + 1]
        sm = x_pixel[self.sm_index:self.sm_index + 1]
        return torch.cat([wcm_sigma0(v, sm, aux.theta_deg, c)
                          for c in self._coeffs])


def validate_state(x) -> None:
    """Host-side input validation (the reference's eager checks): raises
    on non-positive LAI or SM, or a non-finite state."""
    x = np.asarray(x)
    if np.any(x[:, 0] <= 0.0):
        raise ValueError("Negative LAI!")
    if np.any(x[:, 1] <= 0.0):
        raise ValueError("Negative SM!")
    if np.any(~np.isfinite(x)):
        raise ValueError("Non-finite state!")
