"""The filter engine of the port."""

from .filter import KalmanFilter
from .priors import (PROSAIL_PARAMETER_LIST, TIP_PARAMETER_LIST,
                     FixedGaussianPrior, jrc_prior, sail_prior)
from .protocols import (DateObservation, ObservationSource, OutputWriter,
                        Prior)
from .state import PixelGather, make_pixel_gather

__all__ = [
    "KalmanFilter", "PROSAIL_PARAMETER_LIST", "TIP_PARAMETER_LIST",
    "FixedGaussianPrior", "jrc_prior", "sail_prior",
    "DateObservation", "ObservationSource", "OutputWriter", "Prior",
    "PixelGather", "make_pixel_gather",
]
