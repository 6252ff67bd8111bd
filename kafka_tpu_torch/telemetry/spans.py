"""Timed phase spans (port of ``kafka_tpu/telemetry/spans.py``): one
context manager that lands in three sinks — a
``torch.profiler.record_function`` label (visible in ``torch.profiler``
traces), a wall-time histogram plus a JSONL event in the registry, and a
span on the registry's trace timeline.  The engine's phases (advance /
assimilate / dump / fused_scan) use it.

Sub-date spans (``span(..., per_date=True)``) time the work inside one
date and nest inside ``assimilate`` / ``fused_scan``: ``date_fetch``
(the date's observation), ``date_solve`` (the solve's dispatch, from
its options to its last launch), ``date_record`` (the packed diagnostic
read and the host bookkeeping of the date's record), and inside the
solve ``linearize`` (one linearisation call of a Gauss-Newton round),
``loop_sync`` (a round's loop-condition read), ``row_layout``
(``linalg.pack_rows`` / ``unpack_rows``) and, inside ``linearize``,
``gp_rows`` (a launch of the GP bank's row kernel).  They write no
JSONL event each: their host seconds add up in the date's
:class:`DateSums`, which the engine lands in the date's record and its
one ``solve`` event.
"""

from __future__ import annotations

import contextvars
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from . import tracing
from .registry import MetricsRegistry, get_registry

#: the open :class:`DateSums` of this thread's context (a thread that
#: did not open the date — a prefetch or mesh-shard worker — adds none).
_DATE: contextvars.ContextVar = contextvars.ContextVar(
    "kafka_date_sums", default=None)


class DateSums:
    """The sub-date spans of one date or fused block, open while the
    context manager is: host seconds per phase, the spans themselves
    (their histogram observations and trace spans are written when the
    date closes, in one pass), and the CUDA event pair of each
    device-timed span (``span(..., device=...)``, under a profiler) with
    its phase.
    The pairs are resolved by :meth:`device_ms` after the engine's
    packed read has synchronised the stream, so timing adds no sync."""

    __slots__ = ("seconds", "pairs", "spans", "_token")

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.pairs: List[tuple] = []
        self.spans: List[tuple] = []
        self._token = None

    def __enter__(self) -> "DateSums":
        self._token = _DATE.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _DATE.reset(self._token)
        spans, self.spans = self.spans, []
        if spans:
            _record(spans)

    def ms(self, *phases: str) -> float:
        """Host milliseconds of ``phases``' spans."""
        return 1e3 * sum(self.seconds.get(p, 0.0) for p in phases)

    def device_ms(self, phase: str) -> Optional[float]:
        """Device milliseconds of ``phase``'s device-timed spans whose
        work has completed (``Event.query``, which never blocks); None
        when none was timed (the CPU, no profiler recording, or no such
        span in the date)."""
        pairs = [(start, end) for ph, start, end in self.pairs
                 if ph == phase]
        if not pairs:
            return None
        return sum(start.elapsed_time(end) for start, end in pairs
                   if end.query())


def _record(spans) -> None:
    """The histogram observations and trace spans of a date's closed
    spans ``(registry, phase, t0, t1, span_id, fields)``, in order, in
    the first one's registry (a date runs under one)."""
    reg = spans[0][0]
    hist = _phase_histogram(reg)
    for _, phase, t0, t1, _, _ in spans:
        hist.observe(t1 - t0, phase=phase)
    reg.trace.add_spans([(phase, t0, t1, span_id, fields)
                         for _, phase, t0, t1, span_id, fields in spans],
                        cat="phase")


def _phase_histogram(reg: MetricsRegistry):
    return reg.histogram(
        "kafka_engine_phase_seconds",
        "wall seconds per engine phase (advance/assimilate/"
        "dump/fused_scan, and inside a date date_fetch/"
        "date_solve/date_record/linearize/loop_sync/row_layout/gp_rows)",
    )


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


def _event_pair(device, sums: Optional[DateSums]):
    """A recorded start event on ``device``'s current stream and the end
    event to record, when ``device`` is a card and a date is open."""
    if sums is None or device is None or device.type != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return start, torch.cuda.Event(enable_timing=True), stream


def span(phase: str, registry: Optional[MetricsRegistry] = None,
         per_date: bool = False, device=None, **fields) -> "_Span":
    """Time the enclosed block (``with span(...):``) as engine phase
    ``phase``.

    Shows up as a ``kafka/<phase>`` record_function in profiler traces, a
    ``kafka_engine_phase_seconds{phase=...}`` histogram observation, a
    ``phase`` JSONL event (with any extra ``fields`` attached), and a
    ``cat: "phase"`` span on the recording thread's track in
    ``trace.json``.  Nested spans see this one as their ``parent_span``.
    All sinks record on the exception path too — a phase that dies still
    leaves its wall time and its place on the timeline.

    ``per_date`` makes it a sub-date span, opened several times a date
    and kept cheap: no JSONL event (its seconds add up in the open
    :class:`DateSums` instead, which writes its histogram observation
    and trace span when the date closes), its record_function range
    only while a profiler records this thread (no dispatcher call
    otherwise), and no parent pushed for spans inside it (none nests
    there).  ``device`` (a
    ``torch.device``) also times the block on that card's current
    stream, with a CUDA event pair kept in the open :class:`DateSums` —
    only while a profiler records too: a pair costs tens of microseconds
    of host time, about a MODIS date's whole budget.
    """
    return _Span(phase, registry, per_date, device, fields)


class _Span:
    """:func:`span`'s context manager (a class: a generator-based one
    costs a few microseconds more a span)."""

    __slots__ = ("phase", "reg", "per_date", "device", "fields", "sums",
                 "span_id", "token", "rf", "pair", "t0")

    def __init__(self, phase, registry, per_date, device, fields):
        self.phase, self.per_date, self.device = phase, per_date, device
        self.reg = registry if registry is not None else get_registry()
        self.fields = fields

    def __enter__(self) -> None:
        per_date = self.per_date
        self.sums = _DATE.get() if per_date else None
        self.span_id = tracing.next_span_id()
        self.token = None if per_date else tracing.push_parent(self.span_id)
        ranged = not per_date or torch.autograd._profiler_enabled()
        self.rf = record_function(f"kafka/{self.phase}") if ranged else None
        if self.rf is not None:
            self.rf.__enter__()
        self.pair = _event_pair(self.device, self.sums) if ranged else None
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        t0, phase, reg, sums = self.t0, self.phase, self.reg, self.sums
        try:
            if sums is not None:
                # Inside a date: summed now, written when it closes.
                if self.pair is not None:
                    start, end, stream = self.pair
                    end.record(stream)
                    sums.pairs.append((phase, start, end))
                sums.seconds[phase] = sums.seconds.get(phase, 0.0) \
                    + (t1 - t0)
                sums.spans.append((reg, phase, t0, t1, self.span_id,
                                   self.fields))
                return False
            tracing.pop(self.token)
            _phase_histogram(reg).observe(t1 - t0, phase=phase)
            if not self.per_date:
                reg.emit("phase", phase=phase,
                         seconds=round(t1 - t0, 6), **self.fields)
            reg.trace.add_span(phase, t0, t1, cat="phase",
                               span_id=self.span_id, **self.fields)
        finally:
            if self.rf is not None:
                self.rf.__exit__(*exc)
        return False
