"""Two-stream canopy albedo operator, JRC-TIP style (port of
``kafka_tpu/obsops/twostream.py``).

State layout, the 7-parameter TIP state (band mappers ``[0, 1, 6, 2]``
VIS / ``[3, 4, 6, 5]`` NIR):

    [omega_vis, d_vis, a_soil_vis, omega_nir, d_nir, a_soil_nir, tlai]

Clamps go through ``_jaxrules`` (``torch.maximum`` / ``torch.minimum``
against tensors, not ``torch.clamp``): at an exact tie the former split
the derivative half and half, as ``jnp.maximum`` / ``jnp.clip`` do,
while ``torch.clamp`` passes it whole.  The TIP state bounds put ``d`` exactly
on the ``max(d, 0.1)`` tie when its lower bound is hit, so the rule
matters for parity (the following clip of ``g`` zeroes that derivative
anyway; a test pins the Jacobian at a clipped state).  The CUDA kernel
(``csrc/fused_gn.cu``) evaluates the same closed form with the same
tie rule on forward-mode dual numbers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

from ._jaxrules import _clip, _max
from .protocol import ObservationModel

_EPS = 1e-6

VIS_MAPPER = np.array([0, 1, 6, 2])
NIR_MAPPER = np.array([3, 4, 6, 5])


def tlai_to_lai(tlai):
    """Invert the TIP transform TLAI = exp(-LAI/2)."""
    return -2.0 * torch.log(_clip(tlai, _EPS, 1.0 - _EPS))


def twostream_albedo(omega, d, soil_albedo, lai):
    """White-sky albedo of a homogeneous canopy over a Lambertian soil:
    the closed-form two-flux solution of the JAX package, term for term."""
    omega = _clip(omega, _EPS, 1.0 - _EPS)
    g = _clip(1.0 - 1.0 / _max(d, 0.1), -0.95, 0.95)
    b = (1.0 - g) / 2.0
    soil = _clip(soil_albedo, 0.0, 1.0)
    lai = _max(lai, _EPS)

    alpha = 1.0 - omega * (1.0 - b)
    beta = omega * b
    gamma = torch.sqrt(_max(alpha**2 - beta**2, _EPS**2))
    r_inf = beta / (alpha + gamma)

    e_m = torch.exp(-gamma * lai)
    ratio = e_m**2 * (r_inf - soil) / (soil - 1.0 / r_inf)
    c1 = 1.0 / (1.0 + ratio)
    c2 = ratio * c1
    return r_inf * c1 + c2 / r_inf


def _band(omega, d, tlai, soil):
    return twostream_albedo(omega, d, soil, tlai_to_lai(tlai))


class TwoStreamOperator(ObservationModel):
    """Two-band (VIS/NIR) two-stream albedo operator on the 7-param TIP
    state."""

    n_bands = 2
    n_params = 7
    state_bounds = (
        np.array([1e-3, 0.1, 1e-3, 1e-3, 0.1, 1e-3, 5e-3], np.float32),
        np.array([0.999, 4.0, 0.999, 0.999, 4.0, 0.999, 0.999], np.float32),
    )
    #: the fused CUDA kernel evaluates this operator's value + Jacobian
    #: itself; ``kernel_physics`` names the device implementation
    #: (``csrc/fused_gn.cu``) the kernel wrapper checks for.
    inkernel_linearize = True
    kernel_physics = "twostream"

    def __init__(self):
        self._mappers = [[int(i) for i in VIS_MAPPER],
                         [int(i) for i in NIR_MAPPER]]

    def forward_band_pixel(self, aux, band: int, sub):
        """One band from its mapped 4-vector [omega, d, tlai, a_soil]."""
        return _band(sub[0], sub[1], sub[2], sub[3])

    def forward_pixel(self, aux, x_pixel):
        # (1,)-shaped slices, not 0-d scalars: under torch.func.jacfwd a
        # 0-d tensor times a Python float gets a float64 tangent.
        return torch.cat([
            self.forward_band_pixel(aux, b,
                                    [x_pixel[i:i + 1] for i in mapper])
            for b, mapper in enumerate(self._mappers)
        ])

    def kernel_linearize_rows(self, x_rows):
        """Row-layout value + Jacobian from ``torch.func.jvp`` of the same
        closed form, one one-hot tangent per mapped parameter (as
        ``jax.jvp`` in the JAX package); unmapped rows are zeros."""
        zero = torch.zeros_like(x_rows[0])
        h0_out, jac_out = [], []
        for mapper in self._mappers:
            sub = tuple(x_rows[i] for i in mapper)
            rows = [zero] * len(x_rows)
            val = None
            for k in range(len(sub)):
                tangents = tuple(
                    torch.ones_like(s) if j == k else torch.zeros_like(s)
                    for j, s in enumerate(sub)
                )
                val, dot = jvp(_band, sub, tangents)
                rows[mapper[k]] = dot
            h0_out.append(val)
            jac_out.append(rows)
        return h0_out, jac_out
