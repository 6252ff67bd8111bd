"""Joint optical + SAR observation operators on one shared state (port
of ``kafka_tpu/obsops/joint.py``).

An 11-parameter joint state, the 10 transformed PROSAIL parameters plus
volumetric soil moisture, that Sentinel-2 dates constrain through the
PROSAIL reflectance operator and Sentinel-1 dates through the WCM: LAI
is shared between the sensors and soil moisture rides the SAR signal.

State layout (transformed space, as in ``obsops.prosail``):

    [0..9]  the PROSAIL state (``PROSAIL_PARAMETER_LIST``), slot 6 the
            transformed LAI x6 = exp(-LAI/2)
    [10]    sm: volumetric soil moisture (m^3/m^3)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._jaxrules import _clip
from .prosail import ProsailAux, ProsailOperator
from .protocol import ObservationModel
from .wcm import WCM_PARAMETERS, WCMAux, wcm_sigma0

#: Transformed-LAI floor: exp(-10/2), LAI capped at 10 like the WCM
#: physical domain.
_TLAI_MIN = float(np.exp(-5.0))


def joint_state_bounds():
    """(lower, upper) for the 11-parameter joint state: the PROSAIL
    bounds plus the WCM soil-moisture domain (0, 0.6]."""
    p_lo, p_hi = ProsailOperator.state_bounds
    lo = np.concatenate([p_lo, [1e-3]]).astype(np.float32)
    hi = np.concatenate([p_hi, [0.6]]).astype(np.float32)
    return lo, hi


class ProsailJointOperator(ObservationModel):
    """The PROSAIL S2 operator on the joint state: reads the first 10
    parameters and ignores soil moisture (a zero Jacobian column, so SM
    keeps its prior or SAR-constrained value through optical dates)."""

    n_bands = 10
    n_params = 11
    state_bounds = joint_state_bounds()

    def __init__(self, hotspot: float = 0.01):
        self._prosail = ProsailOperator(hotspot=hotspot)

    def forward_pixel(self, aux: Optional[ProsailAux], x_pixel):
        return self._prosail.forward_pixel(aux, x_pixel[:10])


class WCMJointOperator(ObservationModel):
    """The dual-pol Water-Cloud Model on the joint state: the vegetation
    descriptor is the physical LAI decoded from the transformed slot 6
    (LAI = -2 ln x6), soil moisture is slot 10.  ``torch.func`` carries
    the chain rule through the decode, so SAR dates update the same
    transformed-LAI parameter the optical dates do."""

    n_params = 11
    state_bounds = joint_state_bounds()

    def __init__(self, polarisations=("VV", "VH")):
        self.polarisations = tuple(polarisations)
        for pol in self.polarisations:
            if pol not in WCM_PARAMETERS:
                raise ValueError(
                    f"polarisation {pol!r} has no WCM coefficient set "
                    "(VV and VH are supported)"
                )
        self.n_bands = len(self.polarisations)
        self._coeffs = np.array(
            [WCM_PARAMETERS[p] for p in self.polarisations], np.float32
        )

    def forward_pixel(self, aux: WCMAux, x_pixel):
        # (1,)-shaped slices, as in obsops.wcm.
        tlai = _clip(x_pixel[6:7], _TLAI_MIN, 1.0)
        lai = -2.0 * torch.log(tlai)
        sm = x_pixel[10:11]
        return torch.cat([wcm_sigma0(lai, sm, aux.theta_deg, c)
                          for c in self._coeffs])
