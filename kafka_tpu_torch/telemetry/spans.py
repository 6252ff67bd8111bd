"""Timed phase spans (port of ``kafka_tpu/telemetry/spans.py``): one
context manager that lands in three sinks — a
``torch.profiler.record_function`` label (visible in ``torch.profiler``
traces), a wall-time histogram plus a JSONL event in the registry, and a
span on the registry's trace timeline.  The engine's phases (advance /
assimilate / dump / fused_scan) use it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from torch.profiler import record_function

from . import tracing
from .registry import MetricsRegistry, get_registry


class Stopwatch:
    """A raw timer for device-adjacent host code: ``t0`` and :meth:`now`
    are ``time.perf_counter`` readings, directly usable as trace-span
    endpoints."""

    __slots__ = ("t0",)

    def __init__(self):
        self.t0 = time.perf_counter()

    @staticmethod
    def now() -> float:
        """Current ``perf_counter`` reading (a span endpoint)."""
        return time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since construction."""
        return time.perf_counter() - self.t0


def stopwatch() -> Stopwatch:
    """Start a :class:`Stopwatch` (the device-adjacent timing funnel)."""
    return Stopwatch()


@contextlib.contextmanager
def span(phase: str, registry: Optional[MetricsRegistry] = None,
         **fields) -> Iterator[None]:
    """Time the enclosed block as engine phase ``phase``.

    Shows up as a ``kafka/<phase>`` record_function in profiler traces, a
    ``kafka_engine_phase_seconds{phase=...}`` histogram observation, a
    ``phase`` JSONL event (with any extra ``fields`` attached), and a
    ``cat: "phase"`` span on the recording thread's track in
    ``trace.json``.  Nested spans see this one as their ``parent_span``.
    All sinks record on the exception path too — a phase that dies still
    leaves its wall time and its place on the timeline.
    """
    reg = registry if registry is not None else get_registry()
    span_id = tracing.next_span_id()
    token = tracing.push_parent(span_id)
    with record_function(f"kafka/{phase}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            tracing.pop(token)
            dt = t1 - t0
            reg.histogram(
                "kafka_engine_phase_seconds",
                "wall seconds per engine phase (advance/assimilate/"
                "dump/fused_scan)",
            ).observe(dt, phase=phase)
            reg.emit("phase", phase=phase, seconds=round(dt, 6), **fields)
            reg.trace.add_span(
                phase, t0, t1, cat="phase", span_id=span_id, **fields
            )
