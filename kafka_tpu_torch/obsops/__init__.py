"""Observation operators of the port."""

from .prosail import ProsailAux, ProsailOperator
from .protocol import ObservationModel
from .twostream import TwoStreamOperator

__all__ = ["ObservationModel", "ProsailAux", "ProsailOperator",
           "TwoStreamOperator"]
