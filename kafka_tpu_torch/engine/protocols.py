"""The engine's injection points as explicit protocols (port of
``kafka_tpu/engine/protocols.py``): an observation source, an output
writer, a prior, plus the operator (inside ``DateObservation``) and the
state propagator (a plain callable, ``core.propagators``)."""

from __future__ import annotations

import datetime
from typing import (Any, NamedTuple, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import torch

from ..core.types import BandBatch
from ..obsops.protocol import ObservationModel
from .state import PixelGather


class DateObservation(NamedTuple):
    """One acquisition date: band batch gathered to the pixel batch, the
    operator mapping state to those bands, and its per-date aux data."""

    bands: BandBatch
    operator: ObservationModel
    aux: Any


@runtime_checkable
class ObservationSource(Protocol):
    """``dates`` lists the acquisitions; ``get_observations`` gathers one
    date into the fixed pixel batch, on the source's device.  The engine
    reads ahead on worker threads (``engine.prefetch``), so
    ``get_observations`` may run concurrently for different dates and
    must tolerate that (pure reads)."""

    @property
    def dates(self) -> Sequence[datetime.datetime]: ...

    def get_observations(self, date: datetime.datetime,
                         gather: PixelGather) -> DateObservation: ...


@runtime_checkable
class OutputWriter(Protocol):
    """The output sink: ``x`` (n_pad, p) and ``p_inv_diag`` (n_pad, p)
    tensors, plus an optional ``dump_qa(timestep, verdicts, gather)``."""

    def dump_data(self, timestep: datetime.datetime, x, p_inv_diag,
                  gather: PixelGather, parameter_list: Sequence[str]) -> None:
        ...


@runtime_checkable
class Prior(Protocol):
    """``process_prior(date, gather)`` -> batched (mean, inverse cov)."""

    def process_prior(self, date: Optional[datetime.datetime],
                      gather: PixelGather
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        ...
