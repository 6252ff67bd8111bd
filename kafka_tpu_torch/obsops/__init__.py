"""Observation operators of the port."""

from .identity import IdentityOperator
from .prosail import ProsailAux, ProsailOperator
from .protocol import ObservationModel
from .twostream import TwoStreamOperator

__all__ = ["IdentityOperator", "ObservationModel", "ProsailAux",
           "ProsailOperator", "TwoStreamOperator"]
