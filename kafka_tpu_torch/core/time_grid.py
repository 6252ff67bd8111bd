"""Temporal grid iteration (a copy of ``kafka_tpu/core/time_grid.py``).

Host-side (dates are Python datetimes; nothing here is traced).  Same
windowing semantics as the reference's ``iterate_time_grid``
(KaFKA ``kafka/inference/utils.py:44-65``): for each grid step
``t_k`` (skipping the first), yield the observation dates falling in
``[t_{k-1}, t_k)`` plus a first-step flag.
"""

from __future__ import annotations

import logging
from typing import Iterable, Iterator, List, Sequence, Tuple, TypeVar

LOG = logging.getLogger(__name__)

T = TypeVar("T")


def iterate_time_grid(
    time_grid: Sequence[T], the_dates: Iterable[T], verbose: bool = True
) -> Iterator[Tuple[T, List[T], bool]]:
    """Yield ``(timestep, observation_dates_in_window, is_first)``.

    The window for the step ending at ``time_grid[k]`` is
    ``time_grid[k-1] <= d < time_grid[k]`` — half-open on the right, exactly
    as the reference (``inference/utils.py:49-52``).  ``verbose=False``
    silences the per-window log line (for planning passes that re-walk the
    grid before the run loop does).
    """
    dates = sorted(the_dates)
    istart = time_grid[0]
    is_first = True
    for timestep in time_grid[1:]:
        located = [d for d in dates if istart <= d < timestep]
        if verbose:
            LOG.info(
                "Timestep %s -> %s: %d observation(s)", istart, timestep,
                len(located)
            )
        istart = timestep
        yield timestep, located, is_first
        is_first = False
