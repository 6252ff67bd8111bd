"""Crash flight recorder: post-mortem forensics for dead runs
(port of ``kafka_tpu/telemetry/flight_recorder.py``).

Before this module, a chunk worker dying mid-run left ONE artifact: a
missing ``.done`` marker.  The flight recorder turns every abnormal end —
unhandled exception, SIGTERM/SIGINT, or an unhealthy health-probe verdict
(``health.probe_health``) — into a readable ``crash_<ts>.json`` next to
the run's telemetry:

- the tail of the registry's bounded event ring (the last solves, phases,
  chunk completions and health probes before death);
- the final metric values (``MetricsRegistry.flat()``);
- the active :class:`~.tracing.TraceContext` (run/chunk/window ids);
- the exception (type, message, traceback) or signal that killed the run;
- a stack snapshot of every live thread (prefetcher stuck in a read?
  writer wedged on disk?).

It also best-effort flushes the registry's normal exports
(``metrics.prom`` / ``metrics.json`` / ``trace.json``) so the timeline
survives the crash too.

Installed by every CLI driver, the chunk worker and ``bench.py``
(module-level :func:`install` — idempotent per process).  Dumps are
written only when a destination exists (the recorder's directory or the
registry's telemetry directory): a run without ``--telemetry-dir`` opted
out of run artifacts, and scattering crash files into random working
directories would be litter, not forensics.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Optional

from .registry import get_registry
from .tracing import current_context


class FlightRecorder:
    """Bounded-ring crash dumper; also a context manager (``with
    recorder:`` dumps on exception and re-raises)."""

    #: events kept in a dump (the registry ring may hold more).
    MAX_DUMP_EVENTS = 256

    #: accumulated ``crash_*.json`` files kept in the destination
    #: directory — after each dump the oldest beyond this cap are
    #: removed, so a long-lived process that keeps hitting (and
    #: surviving) unhealthy-probe or per-request crash dumps cannot fill
    #: the disk.  The filename's timestamp prefix sorts chronologically.
    MAX_CRASH_DUMPS = 16

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self._lock = threading.Lock()
        self._installed = False
        self._prev_excepthook = None
        self._prev_handlers: dict = {}
        #: id() of the last exception dumped — the guard and the
        #: excepthook may both see the same exception; one dump only.
        self._last_exc_id: Optional[int] = None

    # -- dump -----------------------------------------------------------

    def _target_dir(self) -> Optional[str]:
        return self.directory or get_registry().directory

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             ) -> Optional[str]:
        """Write ``crash_<ts>.json``; returns the path (None when no
        destination directory exists or this exception already dumped)."""
        with self._lock:
            if exc is not None:
                if id(exc) == self._last_exc_id:
                    return None
                self._last_exc_id = id(exc)
            directory = self._target_dir()
            if not directory:
                return None
            reg = get_registry()
            ctx = current_context()
            rec = {
                "reason": reason,
                "ts": round(time.time(), 6),
                "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "pid": os.getpid(),
                "context": None if ctx is None else ctx.fields(),
                "exception": None,
                "threads": self._thread_snapshot(),
                "events": list(reg.events)[-self.MAX_DUMP_EVENTS:],
                "metrics": reg.flat(),
            }
            if exc is not None:
                rec["exception"] = {
                    "type": type(exc).__name__,
                    "message": str(exc),
                    "traceback": traceback.format_exception(
                        type(exc), exc, exc.__traceback__
                    ),
                }
                # Device-plane OOM forensics (telemetry.devprof): a
                # torch.cuda.OutOfMemoryError (or injected device.oom) unwind
                # gets the live-buffer census, the newest kernel table
                # and the per-device memory stats attached — the dump
                # names the resident buffers, not just the allocator's
                # apology.  Best effort: the dump itself must survive
                # a forensics failure.
                try:
                    from .devprof import forensics, is_oom

                    if is_oom(exc):
                        rec["device_forensics"] = forensics(reg)
                except Exception:  # noqa: BLE001 — forensics are garnish on the dump
                    pass
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory,
                f"crash_{time.strftime('%Y%m%dT%H%M%S')}_{os.getpid()}.json",
            )
            with open(path, "w") as f:
                json.dump(rec, f, indent=2, default=str)
            # Flush the run's normal exports too — a crash is exactly when
            # the timeline matters most.  Best effort: the dump above is
            # the primary artifact and must survive an export failure.
            try:
                reg.dump(directory)
            except OSError:
                pass
            reg.emit("crash_dump", reason=reason, path=path)
            self._prune_dumps(directory)
        # Refresh the live heartbeat snapshot so the fleet view points
        # at this forensics file NOW, not one publish interval later —
        # for a process about to die, "later" never comes.  Late import:
        # live builds on the registry only, no cycle.
        from .live import publish_now

        publish_now()
        return path

    def _prune_dumps(self, directory: str) -> None:
        """Drop the oldest ``crash_*.json`` beyond MAX_CRASH_DUMPS."""
        try:
            dumps = sorted(
                n for n in os.listdir(directory)
                if n.startswith("crash_") and n.endswith(".json")
            )
            for name in dumps[:-self.MAX_CRASH_DUMPS or None]:
                os.unlink(os.path.join(directory, name))
        except OSError:
            pass  # pruning is hygiene; the dump above is the artifact

    @staticmethod
    def _thread_snapshot() -> list:
        frames = sys._current_frames()
        out = []
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            out.append({
                "name": t.name,
                "daemon": t.daemon,
                "stack": (
                    traceback.format_stack(frame) if frame is not None
                    else None
                ),
            })
        return out

    # -- hooks ----------------------------------------------------------

    def install(self) -> "FlightRecorder":
        """Install the excepthook and SIGTERM/SIGINT handlers (signal
        install degrades gracefully off the main thread)."""
        if self._installed:
            return self
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._on_signal
                )
            except ValueError:
                # signal.signal only works on the main thread; a recorder
                # installed from a worker still gets excepthook + guard.
                pass
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        # == not `is`: attribute access mints a fresh bound method, so
        # identity against the one stored in sys.excepthook never holds.
        if sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_excepthook
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers.clear()
        self._installed = False

    def _excepthook(self, etype, evalue, tb) -> None:
        try:
            self.dump("exception", exc=evalue)
        finally:
            (self._prev_excepthook or sys.__excepthook__)(etype, evalue, tb)

    def _on_signal(self, signum, frame) -> None:
        self.dump(
            "sigterm" if signum == signal.SIGTERM else "sigint"
        )
        # Hand the signal back to whoever owned it: restore the previous
        # handler and re-raise, so default termination semantics (or an
        # outer supervisor's handler) still apply after the dump.
        prev = self._prev_handlers.get(signum)
        signal.signal(
            signum, prev if prev is not None else signal.SIG_DFL
        )
        self._prev_handlers.pop(signum, None)
        signal.raise_signal(signum)

    # -- guard ----------------------------------------------------------

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, etype, evalue, tb) -> bool:
        if evalue is not None:
            self.dump("exception", exc=evalue)
        return False  # never swallow


# ---------------------------------------------------------------------------
# Process-level recorder: one per process, shared by driver + health layer.
# ---------------------------------------------------------------------------

_active: Optional[FlightRecorder] = None


def install(directory: Optional[str] = None) -> FlightRecorder:
    """Install (or return) the process recorder; a later call with a
    directory re-points an already-installed recorder at it."""
    global _active
    if _active is None:
        _active = FlightRecorder(directory).install()
    elif directory:
        _active.directory = directory
    return _active


def active_recorder() -> Optional[FlightRecorder]:
    return _active


def uninstall() -> None:
    """Remove the process recorder's hooks (test teardown)."""
    global _active
    if _active is not None:
        _active.uninstall()
        _active = None
