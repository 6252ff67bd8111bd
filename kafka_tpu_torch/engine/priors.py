"""Prior objects (port of ``kafka_tpu/engine/priors.py``): the TIP, S2,
joint S2 + S1, WCM and MOD09 kernel-weight priors."""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.propagators import PixelPrior, broadcast_prior, tip_prior_arrays
from ..obsops.prosail import PROSAIL_PARAMETER_LIST
from .state import PixelGather

# The 7-parameter TIP state of the MODIS drivers (kafka_test.py:159-160).
TIP_PARAMETER_LIST = (
    "w_vis", "x_vis", "a_vis", "w_nir", "x_nir", "a_nir", "TeLAI",
)


def kernel_parameter_list(n_modis_bands: int) -> Tuple[str, ...]:
    """Kernel-weight parameter names: (iso, vol, geo) per MODIS band."""
    return tuple(f"b{b + 1}_{k}" for b in range(n_modis_bands)
                 for k in ("iso", "vol", "geo"))


# The 21-parameter Ross-Li kernel-weight state of the MOD09 driver.
KERNEL_PARAMETER_LIST = kernel_parameter_list(7)


class FixedGaussianPrior:
    """A time-invariant i.i.d.-per-pixel Gaussian prior."""

    date_invariant = True

    def __init__(self, prior: PixelPrior, parameter_list: Sequence[str]):
        self.prior = prior
        self.parameter_list = tuple(parameter_list)

    def process_prior(self, date: Optional[datetime.datetime],
                      gather: PixelGather
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean (n_pad, p) and inverse covariance (n_pad, p, p) as
        expanded views of the per-pixel prior (no per-pixel copies)."""
        return broadcast_prior(self.prior, gather.n_pad)


def jrc_prior(device=None) -> FixedGaussianPrior:
    """The MODIS/TIP prior (``kafka_test.py:110-125``): the TIP prior with
    mean LAI 2.0 in transformed space, on ``device``."""
    from .. import resolve_device

    dev = resolve_device(device)
    mean, cov, inv_cov = tip_prior_arrays()
    mean = mean.copy()
    mean[6] = np.exp(-0.5 * 2.0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return FixedGaussianPrior(
        PixelPrior(mean=t(mean), cov=t(cov), inv_cov=t(inv_cov)),
        TIP_PARAMETER_LIST,
    )


def sail_prior_arrays():
    """The S2/PROSAIL prior's ``(mean, cov, inv_cov)`` as float32 numpy:
    the reference's transformed-space means and sigmas
    (``kafka_test_S2.py:84-92``), ``lai`` slot in TLAI space."""
    mean = np.array([
        2.1, np.exp(-60.0 / 100.0), np.exp(-7.0 / 100.0), 0.1,
        np.exp(-50 * 0.0176), np.exp(-100.0 * 0.002), np.exp(-4.0 / 2.0),
        70.0 / 90.0, 0.5, 0.9,
    ], np.float32)
    sigma = np.array(
        [0.01, 0.2, 0.01, 0.05, 0.01, 0.01, 0.50, 0.1, 0.1, 0.1], np.float32
    )
    cov = np.diag(sigma**2).astype(np.float32)
    inv_cov = np.diag(1.0 / sigma**2).astype(np.float32)
    return mean, cov, inv_cov


def sail_prior(device=None) -> FixedGaussianPrior:
    """The S2/PROSAIL prior (``sail_prior`` of the JAX package) on
    ``device``."""
    from .. import resolve_device

    dev = resolve_device(device)
    mean, cov, inv_cov = (torch.as_tensor(a, device=dev)
                          for a in sail_prior_arrays())
    return FixedGaussianPrior(PixelPrior(mean=mean, cov=cov, inv_cov=inv_cov),
                              PROSAIL_PARAMETER_LIST)


# The 11-parameter joint optical + SAR state (obsops.joint).
JOINT_PARAMETER_LIST = PROSAIL_PARAMETER_LIST + ("sm",)


def joint_prior_arrays():
    """The joint S2 + S1 prior's ``(mean, cov, inv_cov)`` as float32
    numpy: the SAIL prior extended with a broad soil-moisture marginal
    (mean 0.25 m^3/m^3, sigma 0.15)."""
    mean, cov10, inv10 = sail_prior_arrays()
    mean = np.concatenate([mean, [0.25]]).astype(np.float32)
    cov = np.zeros((11, 11), np.float32)
    cov[:10, :10] = cov10
    cov[10, 10] = 0.15**2
    inv_cov = np.zeros((11, 11), np.float32)
    inv_cov[:10, :10] = inv10
    inv_cov[10, 10] = 1.0 / 0.15**2
    return mean, cov, inv_cov


def joint_prior(device=None) -> FixedGaussianPrior:
    """Prior for the joint S2 + S1 state (``joint_prior`` of the JAX
    package): soil moisture is essentially uninformed over the WCM
    domain, so it is learned from the SAR signal.  On ``device``."""
    from .. import resolve_device

    dev = resolve_device(device)
    mean, cov, inv_cov = (torch.as_tensor(a, device=dev)
                          for a in joint_prior_arrays())
    return FixedGaussianPrior(PixelPrior(mean=mean, cov=cov, inv_cov=inv_cov),
                              JOINT_PARAMETER_LIST)


# The 2-parameter WCM state of the SAR-only path (obsops.wcm).
WCM_PARAMETER_LIST = ("lai", "sm")


def wcm_prior_arrays():
    """The SAR-only WCM prior's ``(mean, cov, inv_cov)`` as float32 numpy:
    LAI mean 2, sigma 2; soil moisture mean 0.25, sigma 0.15."""
    mean = np.array([2.0, 0.25], np.float32)
    sigma = np.array([2.0, 0.15], np.float32)
    return (mean, np.diag(sigma**2).astype(np.float32),
            np.diag(1.0 / sigma**2).astype(np.float32))


def wcm_prior(device=None) -> FixedGaussianPrior:
    """Prior for the SAR-only Water-Cloud state (``wcm_prior`` of the JAX
    package), essentially uninformative, on ``device``."""
    from .. import resolve_device

    dev = resolve_device(device)
    mean, cov, inv_cov = (torch.as_tensor(a, device=dev)
                          for a in wcm_prior_arrays())
    return FixedGaussianPrior(PixelPrior(mean=mean, cov=cov, inv_cov=inv_cov),
                              WCM_PARAMETER_LIST)


def kernels_prior_arrays(n_modis_bands: int = 7, sigma: float = 0.2):
    """The MOD09 kernel-weight prior's ``(mean, cov, inv_cov)`` as float32
    numpy: moderate isotropic, smaller volumetric and geometric weights,
    a broad diagonal covariance."""
    mean = np.tile(np.array([0.15, 0.05, 0.02], np.float32), n_modis_bands)
    sig = np.full(3 * n_modis_bands, sigma, np.float32)
    return (mean, np.diag(sig ** 2).astype(np.float32),
            np.diag(1.0 / sig ** 2).astype(np.float32))


def kernels_prior(n_modis_bands: int = 7, sigma: float = 0.2,
                  device=None) -> FixedGaussianPrior:
    """A weak prior for the MOD09 kernel-weight state (``kernels_prior``
    of the JAX package), so the retrieval is observation-driven, on
    ``device``."""
    from .. import resolve_device

    dev = resolve_device(device)
    mean, cov, inv_cov = (torch.as_tensor(a, device=dev)
                          for a in kernels_prior_arrays(n_modis_bands,
                                                        sigma))
    return FixedGaussianPrior(PixelPrior(mean=mean, cov=cov, inv_cov=inv_cov),
                              kernel_parameter_list(n_modis_bands))
