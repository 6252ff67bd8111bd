"""Plain reference of the MODIS TIP configuration: the two-stream albedo
operator, the JRC-TIP constants and the TIP/LAI information propagation.

Frozen from the closed form the program implements
(``kafka_tpu_torch/obsops/twostream.py``, ``core/propagators.py``,
``engine/priors.py``), written over a pixel batch in any floating dtype.
It imports nothing of the program.  Clamps are ``torch.maximum`` /
``torch.minimum`` against tensor constants: at an exact tie they split
the tangent half and half, the rule the program's operator follows.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6
N_PARAMS = 7
N_BANDS = 2
#: [omega, d, tlai, a_soil] of each band in the 7-parameter state.
MAPPERS = ((0, 1, 6, 2), (3, 4, 6, 5))
LOWER = np.array([1e-3, 0.1, 1e-3, 1e-3, 0.1, 1e-3, 5e-3])
UPPER = np.array([0.999, 4.0, 0.999, 0.999, 4.0, 0.999, 0.999])


def _c(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _max(x, v):
    return torch.maximum(x, _c(v, x))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, _c(lo, x)), _c(hi, x))


def albedo(omega, d, tlai, soil):
    """White-sky albedo of a homogeneous canopy over a Lambertian soil
    (the two-flux closed form), leaf area from TLAI = exp(-LAI/2)."""
    lai = -2.0 * torch.log(_clip(tlai, EPS, 1.0 - EPS))
    omega = _clip(omega, EPS, 1.0 - EPS)
    g = _clip(1.0 - 1.0 / _max(d, 0.1), -0.95, 0.95)
    b = (1.0 - g) / 2.0
    soil = _clip(soil, 0.0, 1.0)
    lai = _max(lai, EPS)
    alpha = 1.0 - omega * (1.0 - b)
    beta = omega * b
    gamma = torch.sqrt(_max(alpha ** 2 - beta ** 2, EPS ** 2))
    r_inf = beta / (alpha + gamma)
    e_m = torch.exp(-gamma * lai)
    ratio = e_m ** 2 * (r_inf - soil) / (soil - 1.0 / r_inf)
    c1 = 1.0 / (1.0 + ratio)
    c2 = ratio * c1
    return r_inf * c1 + c2 / r_inf


def forward(x):
    """(n, 7) TIP state -> (n, 2) VIS and NIR albedo."""
    return torch.stack([albedo(*(x[:, i] for i in m)) for m in MAPPERS],
                       dim=1)


def tip_prior():
    """(mean, cov, inv_cov) of the JRC-TIP prior, float64 numpy."""
    sigma = np.array([0.12, 0.7, 0.0959, 0.15, 1.5, 0.2, 0.5])
    mean = np.array([0.17, 1.0, 0.1, 0.7, 2.0, 0.18, np.exp(-0.5 * 1.5)])
    cov = np.diag(sigma ** 2)
    cov[5, 2] = cov[2, 5] = 0.8862 * 0.0959 * 0.2
    return mean, cov, np.linalg.inv(cov)


def jrc_prior():
    """The MODIS initial prior: the TIP prior with mean LAI 2."""
    mean, cov, inv_cov = tip_prior()
    mean = mean.copy()
    mean[6] = np.exp(-0.5 * 2.0)
    return mean, cov, inv_cov


def propagate_lai(x_a, a_post, q_diag):
    """The TIP/LAI information propagation: every parameter back to the
    TIP prior except TLAI (slot 6), whose mean is carried and whose
    information is deflated to ``1 / (1 / A_66 + q_6)``."""
    mean, _, inv_cov = tip_prior()
    n = x_a.shape[0]
    x_f = torch.as_tensor(mean, dtype=x_a.dtype, device=x_a.device) \
        .expand(n, N_PARAMS).clone()
    x_f[:, 6] = x_a[:, 6]
    p_f = torch.as_tensor(inv_cov, dtype=x_a.dtype, device=x_a.device) \
        .expand(n, N_PARAMS, N_PARAMS).clone()
    p_f[:, 6, 6] = 1.0 / (1.0 / a_post[:, 6, 6] + float(q_diag[6]))
    return x_f, p_f
