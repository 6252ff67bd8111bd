"""Trace timeline: one Perfetto-openable ``trace.json`` per run (a copy of
``kafka_tpu/telemetry/tracing.py``, which imports no JAX).

- :class:`TraceContext` — ``run_id`` / ``chunk_id`` / ``window_id`` /
  parent span ids, carried in a ``contextvars.ContextVar``.  Threads do
  NOT inherit context vars, so thread owners (prefetcher, writer)
  capture :func:`current_context` at construction and re-install it on
  their worker threads.  ``KAFKA_TPU_RUN_ID`` carries the run id into
  subprocesses.
- :class:`TraceBuffer` — a bounded, thread-safe store of completed spans
  and counter samples.  One buffer lives on every
  :class:`~.registry.MetricsRegistry` (``registry.trace``).
- Chrome trace-event export (:meth:`TraceBuffer.export`): ``ph: "X"``
  complete spans on one named track per thread lane (engine / prefetch /
  writer), ``ph: "C"`` counter tracks (queue depth, writer backlog),
  ``ph: "M"`` metadata naming the tracks.  Open the file at
  https://ui.perfetto.dev or ``chrome://tracing``.

The same spans appear in ``torch.profiler`` traces through
``record_function`` (``telemetry.spans``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

#: process-wide monotonically increasing span ids (unique within a run's
#: process; the crash dump and span args carry them for parentage).
_SPAN_IDS = itertools.count(1)


def new_run_id() -> str:
    """A fresh run id, or the one handed down by a parent process
    (``KAFKA_TPU_RUN_ID`` — how chunk-worker subprocesses join their
    scheduler's trace)."""
    return os.environ.get("KAFKA_TPU_RUN_ID") or uuid.uuid4().hex[:12]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Correlation ids attached to every span/event recorded under it.

    ``request_id`` is the serving layer's per-request trace key (kept
    for the serving slice).
    """

    run_id: str
    chunk_id: Optional[str] = None
    window_id: Optional[int] = None
    request_id: Optional[str] = None
    parent_span: Optional[int] = None

    def fields(self) -> Dict[str, Any]:
        """Non-empty id fields, for span args / crash dumps."""
        return {
            k: v for k, v in dataclasses.asdict(self).items()
            if v is not None
        }


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "kafka_trace_ctx", default=None
)


def current_context() -> Optional[TraceContext]:
    return _CTX.get()


def set_context(ctx: Optional[TraceContext]) -> None:
    """Install ``ctx`` for the CURRENT thread — the re-install half of
    cross-thread propagation (threads start with an empty context)."""
    _CTX.set(ctx)


@contextlib.contextmanager
def push(**fields) -> Iterator[TraceContext]:
    """Enter a child context with ``fields`` overridden (``chunk_id=...``,
    ``window_id=...``).  With no context active, starts a new one (fresh
    ``run_id`` unless given)."""
    fields = {k: v for k, v in fields.items() if v is not None}
    base = _CTX.get()
    if base is None:
        base = TraceContext(run_id=fields.pop("run_id", None) or new_run_id())
    ctx = dataclasses.replace(base, **fields)
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


# ---------------------------------------------------------------------------
# Thread lanes: the named tracks of the timeline.
# ---------------------------------------------------------------------------

def next_span_id() -> int:
    return next(_SPAN_IDS)


def push_parent(span_id: int):
    """Mark ``span_id`` as the parent of spans opened until :func:`pop`.
    Returns a reset token (None when no context is active)."""
    base = _CTX.get()
    if base is None:
        return None
    return _CTX.set(dataclasses.replace(base, parent_span=span_id))


def pop(token) -> None:
    if token is not None:
        _CTX.reset(token)


# ---------------------------------------------------------------------------
# Thread lanes: the named tracks of the timeline.
# ---------------------------------------------------------------------------

_LANE = threading.local()


def set_lane(name: str) -> None:
    """Name the current thread's track (``prefetch``, ``writer``, ...).
    Unnamed threads fall back to ``engine`` for the main thread and the
    thread's own name otherwise."""
    _LANE.name = name


def _current_lane() -> str:
    name = getattr(_LANE, "name", None)
    if name:
        return name
    t = threading.current_thread()
    return "engine" if t is threading.main_thread() else t.name


class TraceBuffer:
    """Bounded, thread-safe span/counter store with Chrome export.

    Timestamps are ``time.perf_counter()`` anchored at buffer creation
    (monotonic — wall-clock steps cannot fold the timeline); the anchor's
    wall time is exported in ``otherData.epoch_unix_s`` so consumers can
    line the trace up with ``events.jsonl``.
    """

    def __init__(self, max_events: int = 65536):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.epoch = time.time()
        self._spans: collections.deque = collections.deque(maxlen=max_events)
        self._counters: collections.deque = collections.deque(
            maxlen=max_events
        )
        #: lane name -> tid (assigned in first-seen order; engine first
        #: so the run's driving thread sorts to the top in Perfetto).
        self._lanes: Dict[str, int] = {}

    def _us(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 1)

    def _tid(self, lane: str) -> int:
        tid = self._lanes.get(lane)
        if tid is None:
            tid = self._lanes[lane] = len(self._lanes) + 1
        return tid

    def add_span(self, name: str, t_start: float, t_end: float,
                 lane: Optional[str] = None, cat: str = "span",
                 span_id: Optional[int] = None, **args) -> int:
        """Record one completed span (``t_start``/``t_end`` are
        ``time.perf_counter()`` readings).  The active :class:`TraceContext`
        ids land in the span args automatically."""
        ctx = current_context()
        if span_id is None:
            span_id = next(_SPAN_IDS)
        if ctx is not None:
            args = {**ctx.fields(), **args}
        rec = {
            "name": name, "cat": cat,
            "ts": self._us(t_start),
            "dur": max(0.0, round((t_end - t_start) * 1e6, 1)),
            "lane": lane or _current_lane(),
            "span_id": span_id,
            "args": args,
        }
        with self._lock:
            rec["tid"] = self._tid(rec["lane"])
            self._spans.append(rec)
        return span_id

    def add_counter(self, name: str, value: float) -> None:
        """Record one counter sample (queue depth, backlog, memory
        watermark) — a ``ph: "C"`` track in the exported timeline."""
        with self._lock:
            self._counters.append(
                {"name": name, "ts": self._us(time.perf_counter()),
                 "value": float(value)}
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans) + len(self._counters)

    # -- export ---------------------------------------------------------

    def to_chrome(self) -> dict:
        """The full artifact as a Chrome trace-event JSON object."""
        pid = os.getpid()
        with self._lock:
            spans = list(self._spans)
            counters = list(self._counters)
            lanes = dict(self._lanes)
        events: List[dict] = [{
            "name": "process_name", "ph": "M", "ts": 0.0,
            "pid": pid, "tid": 0, "args": {"name": "kafka_tpu"},
        }]
        for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
            events.append({
                "name": "thread_name", "ph": "M", "ts": 0.0,
                "pid": pid, "tid": tid, "args": {"name": lane},
            })
            events.append({
                "name": "thread_sort_index", "ph": "M", "ts": 0.0,
                "pid": pid, "tid": tid, "args": {"sort_index": tid},
            })
        for s in spans:
            events.append({
                "name": s["name"], "cat": s["cat"], "ph": "X",
                "ts": s["ts"], "dur": s["dur"],
                "pid": pid, "tid": s["tid"],
                "args": {**s["args"], "span_id": s["span_id"]},
            })
        for c in counters:
            events.append({
                "name": c["name"], "ph": "C", "ts": c["ts"],
                "pid": pid, "tid": 0, "args": {"value": c["value"]},
            })
        run_ids = sorted({
            s["args"].get("run_id") for s in spans
            if s["args"].get("run_id")
        })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix_s": round(self.epoch, 6),
                "run_ids": run_ids,
            },
        }

    def export(self, path: str) -> str:
        """Write the Perfetto-openable ``trace.json`` atomically (unique
        tmp + ``os.replace``): the live publisher re-exports it every
        heartbeat so a SIGKILLed process leaves its last-beat trace
        behind, and a stitching reader must never see a torn file."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome(), f, default=str)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# Default-registry conveniences: instrumented code records through these so
# the active registry's buffer (swapped by configure()/use()) is the sink.
# ---------------------------------------------------------------------------

def _buffer() -> TraceBuffer:
    from .registry import get_registry

    return get_registry().trace


@contextlib.contextmanager
def trace_span(name: str, lane: Optional[str] = None, cat: str = "span",
               **args) -> Iterator[None]:
    """Time the enclosed block as one span in the default registry's
    buffer; nested ``trace_span``s see this span as their
    ``parent_span``."""
    span_id = next_span_id()
    token = push_parent(span_id)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        pop(token)
        _buffer().add_span(
            name, t0, t1, lane=lane, cat=cat, span_id=span_id, **args
        )


def counter(name: str, value: float) -> None:
    """Record one counter sample into the default registry's buffer."""
    _buffer().add_counter(name, value)
