"""Live telemetry snapshots: the per-process heartbeat of the fleet plane
(port of ``kafka_tpu/telemetry/live.py``).

PRs 2-3 made every run observable POST-MORTEM: ``metrics.prom`` /
``metrics.json`` / ``trace.json`` are written at ``registry.dump()``
time, so an operator watching a live fleet (queue workers, the serving
daemon) has nothing to look at until the processes exit — and a
SIGKILLed worker never writes anything at all.  This module closes that
gap with the cheapest possible live surface, in the repo's
coordinator-free idiom (the shared filesystem is the wire, like the
PR 7 lease markers):

- every instrumented process runs one tracked background
  :class:`LivePublisher` thread that atomically writes a bounded
  ``live_<host>_<pid>.json`` snapshot into its telemetry directory
  every ``interval_s`` seconds (unique tmp + ``os.replace`` — a reader
  can never observe a torn snapshot);
- the snapshot carries the flat counters/gauges, histogram bucket state
  (mergeable into fleet quantiles by ``telemetry.aggregate``), the
  latest health verdict, the :class:`~.tracing.TraceContext` run/chunk
  ids, a crash-dump index, and — critically — a heartbeat timestamp:
  a snapshot whose heartbeat goes stale without a ``final`` marker IS
  the dead-host signal ``tools/fleet_status.py`` flags;
- role-specific facts (queue outdir, serve root, worker id) are
  contributed through :func:`update_status` so fleet aggregation can
  discover the queue a worker serves without extra configuration.

The publisher thread must never block the process it observes: no
sockets, no subprocesses, no unbounded waits.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from . import devprof, perf, quality, slo, tracing
from .registry import MetricsRegistry, _label_text, get_registry

#: snapshot schema version (bumped on breaking changes; consumers skip
#: snapshots they do not understand instead of crashing the fleet view).
SCHEMA_VERSION = 1

#: default publish cadence; override per process via the environment so
#: one knob reaches every subprocess of a fleet command.
DEFAULT_INTERVAL_S = 2.0
INTERVAL_ENV = "KAFKA_TPU_LIVE_INTERVAL_S"

#: bounded snapshot: at most this many metric series are embedded (the
#: overflow is counted, never silently dropped) — a runaway label
#: cardinality must not turn the heartbeat file into a disk hog.
MAX_SERIES = 512


def snapshot_name(host: Optional[str] = None,
                  pid: Optional[int] = None) -> str:
    return f"live_{host or socket.gethostname()}_{pid or os.getpid()}.json"


def crash_dump_index(directory: Optional[str]) -> List[str]:
    """Sorted ``crash_*.json`` filenames in ``directory`` — the forensics
    pointer a fleet view shows next to a dead host."""
    if not directory:
        return []
    try:
        return sorted(
            n for n in os.listdir(directory)
            if n.startswith("crash_") and n.endswith(".json")
        )
    except OSError:
        return []


# ---------------------------------------------------------------------------
# Role-specific status: processes contribute facts (queue outdir, serve
# root, worker id) that ride every subsequent snapshot.
# ---------------------------------------------------------------------------

_status_lock = threading.Lock()
_status: Dict[str, Any] = {}


def update_status(**fields) -> None:
    """Merge JSON-serialisable facts into this process's snapshots
    (``None`` values are ignored)."""
    with _status_lock:
        _status.update(
            {k: v for k, v in fields.items() if v is not None}
        )


def current_status() -> Dict[str, Any]:
    with _status_lock:
        return dict(_status)


def build_snapshot(registry: Optional[MetricsRegistry] = None,
                   role: str = "engine", seq: int = 0,
                   interval_s: float = DEFAULT_INTERVAL_S,
                   final: bool = False) -> dict:
    """One process snapshot as a dict (the publisher writes it; tests
    and ``/statusz`` read it directly)."""
    reg = registry if registry is not None else get_registry()
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    histograms: Dict[str, dict] = {}
    n_series = truncated = 0
    for m in reg.metrics():
        for key, val in m._series():
            if n_series >= MAX_SERIES:
                truncated += 1
                continue
            n_series += 1
            tag = m.name + _label_text(key)
            if m.kind == "counter":
                counters[tag] = val
            elif m.kind == "gauge":
                gauges[tag] = val
            else:
                histograms[tag] = {
                    "le": list(m.buckets),
                    "buckets": list(val["buckets"]),
                    "sum": round(val["sum"], 6),
                    "count": val["count"],
                }
    ctx = tracing.current_context()
    unhealthy = reg.value("kafka_health_unhealthy")
    return {
        "schema": SCHEMA_VERSION,
        "ts": round(time.time(), 6),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "role": role,
        "seq": seq,
        "interval_s": interval_s,
        "final": final,
        "run_id": None if ctx is None else ctx.run_id,
        "chunk_id": None if ctx is None else ctx.chunk_id,
        "health": {
            "unhealthy": None if unhealthy is None else bool(unhealthy),
        },
        # Assimilation-quality verdicts (telemetry.quality): the fleet
        # view folds these into per-host quality columns.
        "quality": quality.summary(reg),
        # Performance attribution (telemetry.perf): throughput / device
        # fraction / roofline utilization, per host in the fleet view.
        "perf": perf.summary(reg),
        # SLO alert state (telemetry.slo): aggregate_fleet folds the
        # firing alerts into the deduped fleet alert view.
        "slo": slo.summary(reg),
        # Device-plane state (telemetry.devprof): captures parsed, top
        # kernel, collective fraction, mesh axes, live-buffer bytes —
        # the fleet view's mesh column.
        "devprof": devprof.summary(reg),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
        "series_truncated": truncated,
        "crash_dumps": crash_dump_index(reg.directory),
        "status": current_status(),
    }


def _metrics(reg: MetricsRegistry) -> dict:
    """Single registration site of the publisher's counters."""
    return {
        "snapshots": reg.counter(
            "kafka_live_snapshots_total",
            "live telemetry snapshots published by this process",
        ),
        "errors": reg.counter(
            "kafka_live_publish_errors_total",
            "live snapshot writes that failed (disk full, "
            "unserialisable status) — the heartbeat degrades, "
            "the run survives",
        ),
    }


def declare(reg: MetricsRegistry) -> None:
    """Register this module's metric families (``httpd``'s /metrics)."""
    _metrics(reg)


class LivePublisher:
    """Tracked background thread publishing ``live_<host>_<pid>.json``
    atomically every ``interval_s`` into ``directory``."""

    def __init__(self, directory: str, role: str = "engine",
                 interval_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.directory = directory
        self.role = role
        env = os.environ.get(INTERVAL_ENV)
        self.interval_s = float(
            interval_s if interval_s is not None
            else (env if env else DEFAULT_INTERVAL_S)
        )
        self.path = os.path.join(directory, snapshot_name())
        self._registry = registry
        self._lock = threading.Lock()
        self._seq = 0
        self._trace_len = -1
        self._stop = threading.Event()
        # Cross-thread trace propagation (PR 3 convention): capture the
        # constructing thread's context, re-install it on the worker.
        self._ctx = tracing.current_context()
        self._thread = threading.Thread(
            target=self._run, name="live-publisher", daemon=True,
        )

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    def start(self) -> "LivePublisher":
        os.makedirs(self.directory, exist_ok=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        tracing.set_context(self._ctx)
        tracing.set_lane("telemetry")
        self.publish_now()
        while not self._stop.wait(self.interval_s):
            self.publish_now()

    def publish_now(self, final: bool = False) -> Optional[str]:
        """Write one snapshot immediately (also the flight recorder's
        hook: a crash dump refreshes the live file so the fleet view
        points at the forensics without waiting out the interval).
        Returns the snapshot path, or None when the write failed —
        a full disk must degrade the heartbeat, never kill the run."""
        reg = self._reg()
        with self._lock:
            self._seq += 1
            snap = build_snapshot(
                reg, role=self.role, seq=self._seq,
                interval_s=self.interval_s, final=final,
            )
            tmp = f"{self.path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(snap, f, default=str)
                os.replace(tmp, self.path)
            except (OSError, TypeError) as exc:
                _metrics(reg)["errors"].inc()
                reg.emit("live_publish_failed", error=repr(exc)[:200])
                try:
                    os.unlink(tmp)
                except OSError:  # tmp never materialised — nothing held
                    pass
                return None
            # Trace persistence rides the heartbeat: re-export the
            # span timeline whenever it grew, so a SIGKILLed process
            # (which never reaches registry.dump()) still leaves its
            # last-beat trace.json behind for per-request stitching —
            # the victim track of a failover forensics session.
            n_trace = len(reg.trace)
            if n_trace != self._trace_len and n_trace and \
                    reg.directory:
                try:
                    reg.trace.export(
                        os.path.join(reg.directory, "trace.json")
                    )
                    self._trace_len = n_trace
                except OSError:
                    pass  # same contract as the snapshot: degrade, never kill
        _metrics(reg)["snapshots"].inc()
        return self.path

    def stop(self) -> None:
        """Stop the thread and publish one FINAL snapshot (the clean-
        shutdown marker that distinguishes an exited worker from a dead
        one in the fleet view)."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.publish_now(final=True)


# ---------------------------------------------------------------------------
# Process-level publisher: one per process, started by the CLI drivers.
# ---------------------------------------------------------------------------

_active: Optional[LivePublisher] = None


def start_publisher(directory: Optional[str] = None, role: str = "engine",
                    interval_s: Optional[float] = None,
                    ) -> Optional[LivePublisher]:
    """Start (or return) the process publisher.  ``directory`` defaults
    to the registry's telemetry directory; with neither configured this
    is a no-op returning None — a run without ``--telemetry-dir`` opted
    out of run artifacts, heartbeats included."""
    global _active
    if _active is not None:
        return _active
    directory = directory or get_registry().directory
    if not directory:
        return None
    _active = LivePublisher(
        directory, role=role, interval_s=interval_s
    ).start()
    return _active


def active_publisher() -> Optional[LivePublisher]:
    return _active


def publish_now(final: bool = False) -> Optional[str]:
    """Best-effort immediate publish through the process publisher
    (no-op when none is running)."""
    p = _active
    return None if p is None else p.publish_now(final=final)


def stop_publisher() -> None:
    """Stop the process publisher, writing the final snapshot."""
    global _active
    if _active is not None:
        _active.stop()
        _active = None
