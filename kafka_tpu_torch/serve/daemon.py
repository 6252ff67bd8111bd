"""The resident serving daemon: filesystem transport + signal handling
(port of ``kafka_tpu/serve/daemon.py``).

Transport follows the repo's coordinator-free idiom (the chunk queue):
the SHARED FILESYSTEM is the wire.  Under one serve root:

``inbox/<name>.json``
    client-submitted requests.  Clients write a tmp file and rename it
    in (``submit_request``), so the daemon never reads a torn request.
    The daemon consumes files in name order and unlinks each after the
    submit decision (the decision itself is durable: admitted requests
    are journaled, rejections are answered).
``requests.jsonl`` / ``responses/<id>.json``
    the crash-safe journal + atomic response store (``serve.journal``).

**Signals** (the handler-chaining convention): the FIRST SIGTERM
requests a graceful drain — the service stops admitting (new inbox
files are answered ``rejected: draining``), in-flight and queued
requests finish, tile state is already checkpointed, and the daemon
exits 0.  The handler restores the previous handler on first use, so a
second SIGTERM terminates through the normal chain (flight recorder
included).  SIGKILL is the crash path: the journal replays unanswered
requests on the next start, resuming from the warm checkpoints.

Fleet awareness (``fleet_dir``): the daemon reads the fleet's live
snapshots under that telemetry root and publishes the dead-host count
as ``kafka_fleet_dead_hosts``, which admission sheds on
(``AdmissionPolicy.max_dead_hosts``).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Optional

from ..telemetry import get_registry
from .journal import RESPONSES_DIR  # noqa: F401  (re-export for clients)
from .request import new_request_id
from .service import AssimilationService

LOG = logging.getLogger(__name__)

INBOX_DIR = "inbox"


# ---------------------------------------------------------------------------
# Client helpers.
# ---------------------------------------------------------------------------

def submit_request(root: str, payload: dict) -> str:
    """Atomically drop one request into a daemon's inbox; returns the
    request id (generated when the payload carries none).  The client
    submission stamp makes the inbox wait attributable: without it the
    server would start the request's clock at parse time and the time
    the file sat in ``inbox/`` would be invisible to the per-request
    trace (its admission_wait)."""
    payload = dict(payload)
    payload.setdefault("request_id", new_request_id())
    payload.setdefault("submitted_ts", round(time.time(), 6))
    inbox = os.path.join(root, INBOX_DIR)
    os.makedirs(inbox, exist_ok=True)
    name = f"{payload['request_id']}.json"
    tmp = os.path.join(inbox, f".{name}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(inbox, name))
    return payload["request_id"]


def read_response(root: str, request_id: str) -> Optional[dict]:
    """One response, or None while unanswered."""
    try:
        with open(os.path.join(
                root, RESPONSES_DIR, f"{request_id}.json")) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# The daemon loop.
# ---------------------------------------------------------------------------

def _install_drain(drain: threading.Event):
    """First SIGTERM sets the drain flag and restores the PREVIOUS
    handler (the second SIGTERM terminates through the normal chain).
    No-op off the main thread."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return None
    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        drain.set()
        get_registry().emit("serve_drain_signal", signal="SIGTERM")
        signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)

    signal.signal(signal.SIGTERM, handler)
    return prev


def _restore_drain(prev) -> None:
    import signal

    if prev is None:
        return
    try:
        signal.signal(signal.SIGTERM, prev)
    except ValueError:  # left the main thread since install — nothing held
        pass


class ServeDaemon:
    """Run an :class:`AssimilationService` against a filesystem inbox
    until drained (SIGTERM / ``drain()``) or — with
    ``exit_when_idle`` — until the queue stays empty for
    ``idle_grace_s`` (the one-shot mode crash-recovery replays and
    batch clients use)."""

    def __init__(
        self,
        service: AssimilationService,
        root: str,
        poll_interval_s: float = 0.05,
        exit_when_idle: bool = False,
        idle_grace_s: float = 1.0,
        fleet_dir: Optional[str] = None,
        fleet_refresh_s: float = 5.0,
        fleet_ttl_s: Optional[float] = None,
    ):
        self.service = service
        self.root = root
        self.inbox = os.path.join(root, INBOX_DIR)
        os.makedirs(self.inbox, exist_ok=True)
        self.poll_interval_s = float(poll_interval_s)
        self.exit_when_idle = bool(exit_when_idle)
        self.idle_grace_s = float(idle_grace_s)
        self._drain = threading.Event()
        #: fleet awareness (optional): a telemetry root holding the
        #: workers' live_<host>_<pid>.json heartbeats.  The daemon
        #: refreshes kafka_fleet_dead_hosts from it so admission can
        #: shed when the fleet degrades (AdmissionPolicy.max_dead_hosts).
        self.fleet_dir = fleet_dir
        self.fleet_refresh_s = float(fleet_refresh_s)
        self.fleet_ttl_s = fleet_ttl_s
        self._fleet_next = 0.0

    def _refresh_fleet_gauge(self) -> None:
        """Read the live snapshots under ``fleet_dir`` and publish the
        dead-host count as the admission gauge.  Runs inline on the poll
        loop (bounded: a directory walk + a few json.loads), throttled
        to ``fleet_refresh_s``."""
        if not self.fleet_dir:
            return
        now = time.monotonic()
        if now < self._fleet_next:
            return
        self._fleet_next = now + self.fleet_refresh_s
        from ..telemetry.aggregate import (
            load_live_snapshots, worker_liveness,
        )

        me = f"{socket.gethostname()}:{os.getpid()}"
        liveness = worker_liveness(
            load_live_snapshots(self.fleet_dir), ttl_s=self.fleet_ttl_s,
        )
        dead = sorted(
            key for key, w in liveness.items()
            if w["dead"] and key != me
        )
        reg = get_registry()
        gauge = reg.gauge(
            "kafka_fleet_dead_hosts",
            "workers whose live-snapshot heartbeat went stale without a "
            "clean-shutdown marker (the fleet view's dead-host count; "
            "admission sheds on it via max_dead_hosts)",
        )
        prev = gauge.value()
        gauge.set(len(dead))
        if len(dead) != (prev or 0) and (dead or prev):
            reg.emit("fleet_dead_hosts_changed", dead=dead)

    def drain(self) -> None:
        """Programmatic SIGTERM equivalent."""
        self._drain.set()

    def _scan_inbox(self) -> int:
        """Submit every parseable inbox file (name order); returns how
        many files were consumed.  Submission is the durability point,
        so each file is unlinked after its decision."""
        try:
            names = sorted(
                n for n in os.listdir(self.inbox) if n.endswith(".json")
            )
        except OSError:
            return 0
        consumed = 0
        for name in names:
            path = os.path.join(self.inbox, name)
            try:
                with open(path) as f:
                    payload = json.load(f)
            except FileNotFoundError:
                continue  # raced another consumer
            except (OSError, ValueError) as exc:
                get_registry().emit(
                    "request_unparseable", file=name,
                    error=repr(exc)[:200],
                )
                LOG.warning("dropping unparseable request file %s: %r",
                            name, exc)
                self._unlink(path)
                consumed += 1
                continue
            self.service.submit(payload)
            self._unlink(path)
            consumed += 1
        return consumed

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:  # raced another consumer — outcome identical
            pass

    def run(self) -> dict:
        """The resident loop; returns the run summary."""
        reg = get_registry()
        prev_handler = _install_drain(self._drain)
        self.service.start()
        reg.emit("serve_started", root=self.root,
                 tiles=sorted(self.service.sessions))
        t0 = time.time()
        idle_since: Optional[float] = None
        try:
            while not self._drain.is_set():
                self._refresh_fleet_gauge()
                consumed = self._scan_inbox()
                if consumed == 0 and self.service.pending() == 0:
                    if self.exit_when_idle:
                        now = time.monotonic()
                        if idle_since is None:
                            idle_since = now
                        elif now - idle_since >= self.idle_grace_s:
                            break
                else:
                    idle_since = None
                # Event.wait doubles as the poll sleep so a SIGTERM
                # interrupts the wait immediately.
                self._drain.wait(self.poll_interval_s)
            drained = self._drain.is_set()
            if drained:
                # Graceful drain: stop admitting FIRST, then keep
                # answering latecomer inbox files with explicit
                # ``rejected: draining`` responses for as long as the
                # already-admitted work is finishing — new requests are
                # rejected, never silently ignored.
                self.service.stop_admitting()
                while not self.service.drain(
                        timeout_s=max(self.poll_interval_s, 0.05)):
                    self._scan_inbox()
                self._scan_inbox()
        finally:
            self.service.close()
            _restore_drain(prev_handler)
        flat = reg.flat()
        summary = {
            "mode": "serve",
            "root": self.root,
            "drained": self._drain.is_set(),
            "wall_s": round(time.time() - t0, 3),
            "admitted": int(flat.get("kafka_serve_admitted_total", 0)),
            "replayed": int(flat.get("kafka_serve_replayed_total", 0)),
            "cancelled": int(flat.get("kafka_serve_cancelled_total", 0)),
            "errors": int(flat.get("kafka_serve_errors_total", 0)),
            "rejected": int(sum(
                v for k, v in flat.items()
                if k.startswith("kafka_serve_rejected_total")
            )),
        }
        reg.emit("serve_stopped", **summary)
        return summary
