"""Ross-Li BRDF kernels and the linear kernel-weights observation
operator (port of ``kafka_tpu/obsops/kernels.py``).

The MODIS BRDF/albedo model (Lucht, Schaaf & Strahler 2000; the MCD43
ATBD) per band:

    rho(sza, vza, raa) = f_iso + f_vol * K_vol + f_geo * K_geo

linear in the state (f_iso, f_vol, f_geo), so the solver sees a constant
Jacobian ``[1, K_vol, K_geo]`` per band.  The kernels are evaluated in
float32 as the JAX package evaluates them (its default precision), on
the host when a reader prepares the aux.  Angles are degrees at the
public API, radians inside.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .protocol import ObservationModel

#: MODIS LiSparse crown shape: relative height h/b and shape b/r
#: (the ``MODISSPARSE=True`` constants: h/b = 2, b/r = 1).
HB_RATIO = 2.0
BR_RATIO = 1.0


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _phase_cos(cos_t1, sin_t1, cos_t2, sin_t2, cos_phi):
    """cos of the phase angle between the two directions."""
    return cos_t1 * cos_t2 + sin_t1 * sin_t2 * cos_phi


def ross_thick(sza_deg, vza_deg, raa_deg) -> torch.Tensor:
    """RossThick (volumetric) kernel, zero at nadir:
    ``[(pi/2 - xi) cos xi + sin xi] / (cos sza + cos vza) - pi/4``."""
    t_s = torch.deg2rad(_f32(sza_deg))
    t_v = torch.deg2rad(_f32(vza_deg))
    phi = torch.deg2rad(_f32(raa_deg))
    cos_xi = _phase_cos(torch.cos(t_s), torch.sin(t_s), torch.cos(t_v),
                        torch.sin(t_v), torch.cos(phi))
    cos_xi = torch.clamp(cos_xi, -1.0, 1.0)
    xi = torch.acos(cos_xi)
    num = (math.pi / 2.0 - xi) * cos_xi + torch.sin(xi)
    return num / (torch.cos(t_s) + torch.cos(t_v)) - math.pi / 4.0


def li_sparse_reciprocal(sza_deg, vza_deg, raa_deg, hb: float = HB_RATIO,
                         br: float = BR_RATIO) -> torch.Tensor:
    """LiSparse-Reciprocal (geometric-optical) kernel, zero at nadir: the
    MCD43 form with equivalent angles th' = arctan(br tan th), the
    overlap term and the reciprocal sec th_s' sec th_v' closure."""
    t_s = torch.atan(br * torch.tan(torch.deg2rad(_f32(sza_deg))))
    t_v = torch.atan(br * torch.tan(torch.deg2rad(_f32(vza_deg))))
    phi = torch.deg2rad(_f32(raa_deg))
    cos_s, sin_s, tan_s = torch.cos(t_s), torch.sin(t_s), torch.tan(t_s)
    cos_v, sin_v, tan_v = torch.cos(t_v), torch.sin(t_v), torch.tan(t_v)
    cos_phi = torch.cos(phi)
    cos_xi = torch.clamp(_phase_cos(cos_s, sin_s, cos_v, sin_v, cos_phi),
                         -1.0, 1.0)
    sec_sum = 1.0 / cos_s + 1.0 / cos_v
    d2 = tan_s ** 2 + tan_v ** 2 - 2.0 * tan_s * tan_v * cos_phi
    # d2 >= 0 analytically; rounding can dip below.
    d2 = torch.clamp(d2, min=0.0)
    cos_t = hb * torch.sqrt(d2 + (tan_s * tan_v * torch.sin(phi)) ** 2) \
        / sec_sum
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    t = torch.acos(cos_t)
    overlap = (1.0 / math.pi) * (t - torch.sin(t) * cos_t) * sec_sum
    return overlap - sec_sum + 0.5 * (1.0 + cos_xi) / (cos_s * cos_v)


def ross_li_kernels(sza_deg, vza_deg, raa_deg):
    """``(K_vol, K_geo)`` for angles in degrees (scalars or arrays)."""
    return (ross_thick(sza_deg, vza_deg, raa_deg),
            li_sparse_reciprocal(sza_deg, vza_deg, raa_deg))


class KernelsAux(NamedTuple):
    """Per-pixel kernel values of one acquisition, each ``(n_pix,)`` (or a
    scalar for a scene-constant geometry)."""

    k_vol: torch.Tensor
    k_geo: torch.Tensor


class KernelsOperator(ObservationModel):
    """Linear kernel-weights observation operator.

    State per pixel: ``(f_iso, f_vol, f_geo)`` per MODIS band, band-major,
    p = 3 * n_bands (21 for the 7 land bands).  Band b reads only its
    own triplet: ``h_b = x[3b] + K_vol x[3b+1] + K_geo x[3b+2]``.  At
    p = 21 the solver takes the dense large-p path."""

    def __init__(self, n_modis_bands: int = 7):
        self.n_bands = int(n_modis_bands)
        self.n_params = 3 * self.n_bands
        # Kernel weights can be slightly negative (f_geo often is); loose
        # bounds keep Gauss-Newton iterates physical.
        self.state_bounds = (
            np.tile(np.array([-0.2, -1.0, -1.0], np.float32), self.n_bands),
            np.tile(np.array([1.2, 2.0, 2.0], np.float32), self.n_bands),
        )

    def forward_pixel(self, aux: Any, x_pixel: torch.Tensor) -> torch.Tensor:
        w = x_pixel.reshape(self.n_bands, 3)
        return w[:, 0] + aux.k_vol * w[:, 1] + aux.k_geo * w[:, 2]
