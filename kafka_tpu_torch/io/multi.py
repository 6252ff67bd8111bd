"""Multi-sensor observation composition (port of
``kafka_tpu/io/multi.py``, which imports no JAX; the port keeps its own
copy).

``CompositeObservations`` merges several observation sources into one:
its dates are the sorted union, and each date dispatches to the source
that owns it, so the ``DateObservation`` carries that sensor's own
operator and aux.  Same-day acquisitions of different sources stay
distinct: a later source's duplicate date moves forward by one second
per source index.  The engine's fused blocks never stack dates whose
operators differ (``KalmanFilter._stackable``), so a joint S2 + S1 stream
runs each sensor's dates through that sensor's operator.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List, Sequence

from ..engine.protocols import DateObservation
from ..engine.state import PixelGather


class CompositeObservations:
    """One observation source over several sensors."""

    def __init__(self, sources: Sequence[Any]):
        if not sources:
            raise ValueError("CompositeObservations needs >= 1 source")
        self.sources = list(sources)
        self._owner: Dict[datetime.datetime, Any] = {}
        self._source_date: Dict[datetime.datetime, datetime.datetime] = {}
        for si, src in enumerate(self.sources):
            for d in src.dates:
                key = d
                while key in self._owner:
                    key = key + datetime.timedelta(seconds=si + 1)
                self._owner[key] = src
                self._source_date[key] = d
        self.dates: List[datetime.datetime] = sorted(self._owner)
        self.bands_per_observation = {
            d: self._owner[d].bands_per_observation[self._source_date[d]]
            for d in self.dates
        }

    def define_output(self):
        """The first source defines the output grid (every source must
        have been built against the same state grid)."""
        return self.sources[0].define_output()

    def get_observations(self, date, gather: PixelGather) -> DateObservation:
        return self._owner[date].get_observations(
            self._source_date[date], gather
        )
