"""Observation operators of the port."""

from .protocol import ObservationModel
from .twostream import TwoStreamOperator

__all__ = ["ObservationModel", "TwoStreamOperator"]
