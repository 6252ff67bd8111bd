"""The filter engine of the port."""

from .checkpoint import Checkpointer
from .filter import KalmanFilter
from .prefetch import ObservationPrefetcher, planned_observation_dates
from .priors import (JOINT_PARAMETER_LIST, KERNEL_PARAMETER_LIST,
                     PROSAIL_PARAMETER_LIST, TIP_PARAMETER_LIST,
                     WCM_PARAMETER_LIST, FixedGaussianPrior, joint_prior,
                     jrc_prior, kernels_prior, sail_prior, wcm_prior)
from .protocols import (DateObservation, ObservationSource, OutputWriter,
                        Prior)
from .state import PixelGather, make_pixel_gather

__all__ = [
    "Checkpointer", "KalmanFilter", "ObservationPrefetcher",
    "planned_observation_dates", "JOINT_PARAMETER_LIST",
    "KERNEL_PARAMETER_LIST", "PROSAIL_PARAMETER_LIST", "TIP_PARAMETER_LIST",
    "WCM_PARAMETER_LIST",
    "FixedGaussianPrior", "joint_prior", "jrc_prior", "kernels_prior",
    "sail_prior", "wcm_prior",
    "DateObservation", "ObservationSource", "OutputWriter", "Prior",
    "PixelGather", "make_pixel_gather",
]
