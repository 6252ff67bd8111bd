"""Host-side metrics registry (a copy of ``kafka_tpu/telemetry/registry.py``,
which imports no JAX).

One ``MetricsRegistry`` per process holds three metric kinds, all
thread-safe and label-aware:

- :class:`Counter` — monotonically increasing totals;
- :class:`Gauge` — last-written values (prefetch queue depth, writer
  backlog);
- :class:`Histogram` — bucketed distributions with sum/count/min/max
  (phase wall-times, per-date read times).

Two export surfaces: JSONL events (``events.jsonl`` under the telemetry
directory, one ``{"ts", "event", ...}`` line per ``emit()``, with a
bounded in-memory ring when no directory is configured), and
Prometheus text (``metrics.prom``) plus ``metrics.json`` written by
``dump()``.  Metric names follow ``kafka_<subsystem>_<name>``, the JAX
package's names.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .tracing import TraceBuffer

#: default histogram buckets (seconds-flavoured: spans ~1 ms .. ~2 min,
#: which covers phase walls, reads and chunk runs alike).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 120.0,
)

_NAME_RE = re.compile(r"^kafka_[a-z0-9]+_[a-z0-9_]+$")

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def escape_label_value(value: str) -> str:
    """Prometheus text-exposition label-value escaping (v0.0.4):
    backslash, double-quote and newline must be escaped or the scraped
    line is unparseable — chunk prefixes and error strings end up in
    labels, so this is not theoretical."""
    return (value.replace("\\", "\\\\")
                 .replace('"', '\\"')
                 .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal
    in help text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def format_value(value: float) -> str:
    """One sample value in exposition form.  Python's ``{:g}`` renders
    infinities as ``inf``, which Prometheus parsers reject — the format
    spells them ``+Inf`` / ``-Inf`` (and ``NaN``)."""
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return f"{v:g}"


def _label_text(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in key
    ) + "}"


class _Metric:
    """Shared bookkeeping: one value slot per distinct label combination."""

    kind = "metric"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._values: Dict[LabelKey, Any] = {}

    def value(self, **labels):
        """Current value for this label combination (None if never set)."""
        with self._lock:
            return self._values.get(_label_key(labels))

    def _series(self) -> List[Tuple[LabelKey, Any]]:
        with self._lock:
            return list(self._values.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, lock, buckets: Sequence[float]):
        super().__init__(name, help, lock)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = self._values[key] = {
                    "count": 0, "sum": 0.0,
                    "min": math.inf, "max": -math.inf,
                    "buckets": [0] * len(self.buckets),
                }
            st["count"] += 1
            st["sum"] += float(value)
            st["min"] = min(st["min"], float(value))
            st["max"] = max(st["max"], float(value))
            for i, le in enumerate(self.buckets):
                if value <= le:
                    st["buckets"][i] += 1


class MetricsRegistry:
    """Thread-safe metric store + structured event log.

    ``directory`` (optional) roots the export files: events stream to
    ``events.jsonl`` as they are emitted; ``dump()`` writes
    ``metrics.prom`` and ``metrics.json`` snapshots.  Without a directory
    everything stays in memory (metrics fully usable, events kept in the
    ring only) so instrumented code needs no "is telemetry on" branches.
    """

    #: events.jsonl rotation defaults: segments are size-capped and only
    #: the newest ``keep`` rotated segments survive, so a LONG-LIVED
    #: process (the serving daemon) cannot grow its telemetry without
    #: bound.  Batch runs never reach the cap, so their behaviour is
    #: unchanged.
    EVENTS_ROTATE_BYTES = 32 * 1024 * 1024
    EVENTS_KEEP = 3

    def __init__(self, directory: Optional[str] = None,
                 max_events: int = 4096,
                 events_rotate_bytes: Optional[int] = None,
                 events_keep: Optional[int] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self.directory = directory
        self.events: collections.deque = collections.deque(
            maxlen=max_events
        )
        #: the run's trace timeline (spans + counter samples); exported
        #: as Chrome trace-event JSON by dump().  See telemetry.tracing.
        self.trace = TraceBuffer()
        self._events_fh = None
        self._events_rotate_bytes = (
            events_rotate_bytes if events_rotate_bytes is not None
            else self.EVENTS_ROTATE_BYTES
        )
        self._events_keep = (
            events_keep if events_keep is not None else self.EVENTS_KEEP
        )
        self._events_bytes = 0
        if directory:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, "events.jsonl")
            try:
                self._events_bytes = os.path.getsize(path)
            except OSError:
                self._events_bytes = 0
            self._events_fh = open(path, "a", buffering=1)

    # -- registration ---------------------------------------------------

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} does not follow the "
                "kafka_<subsystem>_<name> convention"
            )
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(
                    name, help, threading.Lock(), **kw
                )
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            elif help and not m.help:
                m.help = help
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def value(self, name: str, **labels):
        """Read one series' current value; None if absent — the accessor
        the bench health layer and tests consume."""
        with self._lock:
            m = self._metrics.get(name)
        return None if m is None else m.value(**labels)

    # -- events ---------------------------------------------------------

    def emit(self, event: str, **fields) -> None:
        """Append one structured event (ring buffer + JSONL when a
        directory is configured).  Values must be JSON-serialisable.
        The JSONL stream rotates when the current segment passes the
        size cap (``events.jsonl`` -> ``events.jsonl.1`` ...), keeping
        the newest ``events_keep`` segments — bounded on-disk growth for
        long-lived processes."""
        rec = {"ts": round(time.time(), 6), "event": event, **fields}
        self.events.append(rec)
        fh = self._events_fh
        if fh is not None:
            line = json.dumps(rec, default=str) + "\n"
            try:
                fh.write(line)
            except ValueError:  # closed file during teardown
                return
            with self._lock:
                self._events_bytes += len(line)
                if self._events_bytes >= self._events_rotate_bytes:
                    self._rotate_events_locked()

    def _rotate_events_locked(self) -> None:
        """Rotate events.jsonl (caller holds ``self._lock``).  The live
        handle is swapped atomically under the lock so concurrent
        emitters at worst write one late line into the segment being
        rotated (buffering=1 keeps lines whole)."""
        fh = self._events_fh
        if fh is None or not self.directory:
            return
        path = os.path.join(self.directory, "events.jsonl")
        try:
            fh.close()
            # Shift the keep-window: .(keep-1) -> dropped, ... .1 -> .2,
            # live -> .1.  keep=0 means "no history": truncate in place.
            for i in range(self._events_keep - 1, 0, -1):
                src = f"{path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{i + 1}")
            if self._events_keep > 0:
                os.replace(path, f"{path}.1")
            else:
                os.unlink(path)
            self._events_fh = open(path, "a", buffering=1)
            self._events_bytes = 0
        except OSError:
            # Rotation is bookkeeping; losing it must not kill the run.
            # Reopen append-mode so events keep flowing either way.
            try:
                self._events_fh = open(path, "a", buffering=1)
                self._events_bytes = os.path.getsize(path)
            except OSError:
                self._events_fh = None

    # -- export ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Full nested snapshot: {name: {"type", "help", "series":
        [{"labels": {...}, "value"|histogram-state}]}}."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            series = []
            for key, val in m._series():
                entry: Dict[str, Any] = {"labels": dict(key)}
                if m.kind == "histogram":
                    entry.update({
                        k: (None if isinstance(v, float)
                            and math.isinf(v) else v)
                        for k, v in val.items() if k != "buckets"
                    })
                    # Bucket state rides the snapshot so cross-process
                    # consumers (telemetry.aggregate, live snapshots)
                    # can merge histograms and derive fleet quantiles —
                    # count/sum alone cannot reconstruct a p99.
                    entry["le"] = list(m.buckets)
                    entry["buckets"] = list(val["buckets"])
                else:
                    entry["value"] = val
                series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def flat(self) -> Dict[str, float]:
        """Compact {name{labels}: value} view of counters and gauges (plus
        histogram count/sum) — the form embedded in bench artifacts."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            for key, val in m._series():
                tag = m.name + _label_text(key)
                if m.kind == "histogram":
                    out[tag + "_count"] = val["count"]
                    out[tag + "_sum"] = round(val["sum"], 6)
                else:
                    out[tag] = val
        return out

    def prom_text(self) -> str:
        """Prometheus text exposition format v0.0.4.

        Histogram ``_bucket{le=}`` lines are CUMULATIVE (each bucket
        counts every observation ``<= le``, the ``+Inf`` bucket equals
        ``_count``) and every series carries ``_sum``/``_count`` —
        scraped latency histograms work with ``histogram_quantile``.
        Label values and HELP text are escaped, non-finite samples are
        spelled ``+Inf``/``-Inf``/``NaN``; the round-trip is pinned by
        the ``telemetry.aggregate.parse_prom_text`` tests."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in m._series():
                if m.kind == "histogram":
                    for le, count in zip(m.buckets, val["buckets"]):
                        k = key + (("le", f"{le:g}"),)
                        lines.append(
                            f"{m.name}_bucket{_label_text(k)} {count}"
                        )
                    inf_key = key + (("le", "+Inf"),)
                    lines.append(
                        f"{m.name}_bucket{_label_text(inf_key)} "
                        f"{val['count']}"
                    )
                    lines.append(
                        f"{m.name}_sum{_label_text(key)} "
                        f"{format_value(val['sum'])}"
                    )
                    lines.append(
                        f"{m.name}_count{_label_text(key)} {val['count']}"
                    )
                else:
                    lines.append(
                        f"{m.name}{_label_text(key)} {format_value(val)}"
                    )
        return "\n".join(lines) + "\n"

    def dump(self, directory: Optional[str] = None) -> Optional[str]:
        """Write ``metrics.prom`` + ``metrics.json`` (and ``trace.json``
        when any spans were recorded) into ``directory`` (default: the
        configured one).  Returns the directory or None when there is
        nowhere to write.  The streamed ``events.jsonl`` is flushed first
        so the three artifacts are mutually consistent on disk."""
        directory = directory or self.directory
        if not directory:
            return None
        fh = self._events_fh
        if fh is not None:
            try:
                fh.flush()
            except ValueError:  # lost the race against close()
                pass
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "metrics.prom"), "w") as f:
            f.write(self.prom_text())
        with open(os.path.join(directory, "metrics.json"), "w") as f:
            json.dump(self.snapshot(), f, indent=2, default=str)
        if len(self.trace):
            self.trace.export(os.path.join(directory, "trace.json"))
        return directory

    def close(self) -> None:
        """Close the events stream.  Idempotent and race-safe: the handle
        is detached under the lock, so concurrent dump()/close() callers
        flush/close it exactly once."""
        with self._lock:
            fh, self._events_fh = self._events_fh, None
        if fh is not None:
            fh.close()


# ---------------------------------------------------------------------------
# Process-default registry.  Instrumented modules call ``get_registry()``
# at record time, so ``configure()`` (CLI drivers) or ``use()`` (tests)
# swap the sink without threading a registry through every constructor.
# ---------------------------------------------------------------------------

_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Replace the process-default registry; returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev


def configure(directory: Optional[str],
              events_rotate_bytes: Optional[int] = None,
              events_keep: Optional[int] = None) -> MetricsRegistry:
    """Point the process-default registry at ``directory`` (the CLI
    drivers' ``--telemetry-dir``).  ``None`` resets to in-memory-only.
    ``events_rotate_bytes``/``events_keep`` tune the events.jsonl
    rotation for long-lived processes (the serving daemon)."""
    return_to = MetricsRegistry(
        directory, events_rotate_bytes=events_rotate_bytes,
        events_keep=events_keep,
    )
    set_registry(return_to)
    return return_to


class use:
    """Context manager: temporarily install ``registry`` as the default —
    the test-isolation hook (``with use(MetricsRegistry()) as reg: ...``)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._prev: Optional[MetricsRegistry] = None

    def __enter__(self) -> MetricsRegistry:
        self._prev = set_registry(self.registry)
        return self.registry

    def __exit__(self, *exc) -> None:
        set_registry(self._prev)
