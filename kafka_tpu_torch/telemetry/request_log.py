"""Per-request "wide events": one structured record per served request
(copy of ``kafka_tpu/telemetry/request_log.py``, which imports no JAX).

The serving replica (``serve.service``) appends one JSON line per
finished request to ``request_log.jsonl`` under its telemetry
directory, carrying everything a tail-latency investigation needs in
one place:

- identity: ``request_id`` (the per-request trace key), tile, date,
  role (``serve``), run id;
- outcome: status, ``served_from``, ``replayed``;
- attribution: ``e2e_ms`` and the named phase durations
  (``admission_wait_ms`` / ``queue_wait_ms`` / ``resume_ms`` /
  ``solve_ms`` / ``dump_ms``) — the same numbers the response's
  ``trace`` block carries;
- quality: the response's ``solver_health`` / ``quality`` summaries.

A bounded in-process ring of the same records (plus the in-flight set)
backs :func:`requestz` and the compact ``recent_requests`` status fact.
The on-disk log rotates like ``events.jsonl`` (size-capped segments,
keep-N).  Records and file names are the JAX package's, so either
package's tools read the other's logs.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import live, tracing
from .registry import MetricsRegistry, get_registry

LOG_FILENAME = "request_log.jsonl"

#: rotation defaults (the events.jsonl discipline: size-capped segments,
#: newest ``keep`` survive — bounded on-disk growth for daemons).
ROTATE_BYTES = 32 * 1024 * 1024
KEEP_SEGMENTS = 3

#: bounded in-process history backing requestz().
RECENT_MAX = 256

#: phase-coverage bar: a request whose named phases attribute less than
#: this fraction of its end-to-end wall time has unexplained latency.
COVERAGE_TARGET = 0.95

#: absolute slack below which an unattributed remainder is noise, not
#: a finding: a 0.7 ms cache hit with 40 µs of glue fails a 95%
#: FRACTION check while being perfectly explained — the bar is
#: "no unexplained latency", and microseconds are not latency.
UNATTRIBUTED_FLOOR_MS = 1.0


class _State:
    """Per-registry request history (ring + in-flight set), so tests
    isolating the registry (``telemetry.use``) isolate this too."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.recent: deque = deque(maxlen=RECENT_MAX)
        self.inflight: Dict[str, dict] = {}
        self.log_bytes: Optional[int] = None


def _state(registry: Optional[MetricsRegistry] = None) -> _State:
    reg = registry if registry is not None else get_registry()
    st = getattr(reg, "_request_log_state", None)
    if st is None:
        st = reg._request_log_state = _State()
    return st


# ---------------------------------------------------------------------------
# In-flight tracking (the live half of requestz()).
# ---------------------------------------------------------------------------

def note_inflight(request_id: str,
                  registry: Optional[MetricsRegistry] = None,
                  **fields) -> None:
    """Mark one request in flight (admission) or update its stage
    (``stage="queued"/"solving"/"forwarded"``)."""
    st = _state(registry)
    with st.lock:
        rec = st.inflight.setdefault(
            request_id,
            {"request_id": request_id, "ts": round(time.time(), 6)},
        )
        rec.update({k: v for k, v in fields.items() if v is not None})


def clear_inflight(request_id: str,
                   registry: Optional[MetricsRegistry] = None) -> None:
    st = _state(registry)
    with st.lock:
        st.inflight.pop(request_id, None)


# ---------------------------------------------------------------------------
# The wide event itself.
# ---------------------------------------------------------------------------

def build_record(role: str, request_id: str, status: str,
                 e2e_ms: Optional[float],
                 phases: Optional[Dict[str, float]] = None,
                 **fields) -> dict:
    """Assemble one wide-event record (JSON-serialisable)."""
    ctx = tracing.current_context()
    rec = {
        "ts": round(time.time(), 6),
        "role": role,
        "request_id": request_id,
        "status": status,
        "e2e_ms": None if e2e_ms is None else round(float(e2e_ms), 3),
        "phases": {
            k: round(float(v), 3) for k, v in (phases or {}).items()
        },
        "run_id": None if ctx is None else ctx.run_id,
    }
    rec.update({k: v for k, v in fields.items() if v is not None})
    return rec


def record(rec: dict, registry: Optional[MetricsRegistry] = None) -> dict:
    """Land one finished-request record in every sink: the on-disk
    ``request_log.jsonl`` (when a telemetry directory is configured),
    the bounded in-process ring (``requestz``), the per-role counter,
    and the compact ``recent_requests`` live-status fact the fleet view
    renders."""
    reg = registry if registry is not None else get_registry()
    st = _state(reg)
    with st.lock:
        st.inflight.pop(rec.get("request_id"), None)
        st.recent.append(rec)
        compact = [
            {"request_id": r.get("request_id"),
             "status": r.get("status"),
             "served_from": r.get("served_from"),
             "e2e_ms": r.get("e2e_ms")}
            for r in list(st.recent)[-5:]
        ]
    reg.counter(
        "kafka_request_log_records_total",
        "per-request wide events recorded, labelled by role (the "
        "request_log.jsonl write side)",
    ).inc(role=str(rec.get("role", "?")))
    live.update_status(recent_requests=compact)
    if reg.directory:
        _append(reg, st, rec)
    return rec


def _append(reg: MetricsRegistry, st: _State, rec: dict) -> None:
    path = os.path.join(reg.directory, LOG_FILENAME)
    line = json.dumps(rec, default=str) + "\n"
    try:
        with st.lock:
            if st.log_bytes is None:
                try:
                    st.log_bytes = os.path.getsize(path)
                except OSError:
                    st.log_bytes = 0
            if st.log_bytes >= ROTATE_BYTES:
                _rotate(path)
                st.log_bytes = 0
            with open(path, "a") as f:
                f.write(line)
            st.log_bytes += len(line)
    except OSError as exc:
        # The record must never kill the serving path — degrade to the
        # in-memory ring only, counted.
        reg.emit("request_log_write_failed", error=repr(exc)[:200])


def _rotate(path: str) -> None:
    """events.jsonl shift discipline: .(keep-1) dropped, live -> .1."""
    for i in range(KEEP_SEGMENTS - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i + 1}")
    if os.path.exists(path):
        os.replace(path, f"{path}.1")


# ---------------------------------------------------------------------------
# Read side.
# ---------------------------------------------------------------------------

def requestz(n: int = 32,
             registry: Optional[MetricsRegistry] = None) -> dict:
    """The requestz payload: in-flight plus the last-``n``
    completed requests, newest first."""
    st = _state(registry)
    with st.lock:
        inflight = sorted(
            st.inflight.values(), key=lambda r: r.get("ts", 0),
        )
        recent = list(st.recent)[-max(0, int(n)):]
    return {"inflight": inflight, "recent": list(reversed(recent))}


def attributed_fraction(rec: dict) -> Optional[float]:
    """Fraction of one record's end-to-end wall time its named phases
    explain (None when the record carries no usable timing)."""
    e2e = rec.get("e2e_ms")
    phases = rec.get("phases") or {}
    if not isinstance(e2e, (int, float)) or e2e <= 0 or not phases:
        return None
    total = sum(v for v in phases.values()
                if isinstance(v, (int, float)) and v > 0)
    return min(1.0, total / float(e2e))


def is_covered(rec: dict,
               target: float = COVERAGE_TARGET) -> Optional[bool]:
    """Whether one record's latency is explained: >= ``target`` of its
    wall time attributed to named phases, OR the unattributed
    remainder below the absolute noise floor
    (:data:`UNATTRIBUTED_FLOOR_MS`).  None when the record carries no
    usable timing."""
    frac = attributed_fraction(rec)
    if frac is None:
        return None
    if frac >= target:
        return True
    return float(rec["e2e_ms"]) * (1.0 - frac) <= UNATTRIBUTED_FLOOR_MS


def log_paths(root: str) -> List[str]:
    """Every ``request_log.jsonl`` (+ rotated segments) under ``root``,
    sorted — rotated segments oldest-first per directory."""
    found: List[str] = []
    if not os.path.isdir(root):
        return found
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        segments = []  # (sort_key, name): rotated .N oldest first, live last
        for fn in filenames:
            if fn == LOG_FILENAME:
                segments.append((0, fn))
            elif fn.startswith(LOG_FILENAME + "."):
                suffix = fn[len(LOG_FILENAME) + 1:]
                if suffix.isdigit():
                    segments.append((-int(suffix), fn))
        found.extend(os.path.join(dirpath, fn)
                     for _, fn in sorted(segments))
    return found


def load_records(root: str) -> Tuple[List[dict], int]:
    """(records, torn_lines) from every request log under ``root``
    (recursive; a torn tail — crash mid-append — is counted and
    skipped, never a crashed report)."""
    records: List[dict] = []
    torn = 0
    for path in log_paths(root):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        torn += 1
                        continue
                    if isinstance(rec, dict) and rec.get("request_id"):
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: r.get("ts", 0))
    return records, torn
