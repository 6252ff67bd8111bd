"""Prior objects (port of the TIP part of ``kafka_tpu/engine/priors.py``)."""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.propagators import PixelPrior, broadcast_prior, tip_prior_arrays
from .state import PixelGather

# The 7-parameter TIP state of the MODIS drivers (kafka_test.py:159-160).
TIP_PARAMETER_LIST = (
    "w_vis", "x_vis", "a_vis", "w_nir", "x_nir", "a_nir", "TeLAI",
)


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
