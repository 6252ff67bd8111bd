"""The filter engine of the port."""

from .filter import KalmanFilter
from .priors import TIP_PARAMETER_LIST, FixedGaussianPrior, jrc_prior
from .protocols import (DateObservation, ObservationSource, OutputWriter,
                        Prior)
from .state import PixelGather, make_pixel_gather

__all__ = [
    "KalmanFilter", "TIP_PARAMETER_LIST", "FixedGaussianPrior", "jrc_prior",
    "DateObservation", "ObservationSource", "OutputWriter", "Prior",
    "PixelGather", "make_pixel_gather",
]
