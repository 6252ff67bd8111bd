"""Self-healing chunk queue: lease-based claiming, heartbeats and
crash-reclaim (port of ``kafka_tpu/shard/queue.py``; a queue directory
written by either package is read and run by the other: the marker
names, the JSON fields and the manifest are the same).

The static round-robin in ``scheduler.assign_chunks`` strands every chunk
a dead process owns until a human restarts the job.  Here the SHARED
FILESYSTEM is the queue, and the only protocol is three atomic marker
files per chunk:

``.chunk_<prefix>.lease``
    claim marker.  Payload: owner id, hostname, pid, claim time, heartbeat
    ``deadline`` and the chunk's ``requeues`` count.  Created atomically
    (unique tmp + ``os.link``, which fails if a lease exists — the
    exclusive-create half of the protocol); RENEWED by the owner's
    background heartbeat thread (unique tmp + ``os.replace``) before the
    deadline passes.
``.chunk_<prefix>.done``
    commit marker (the restart marker of ``scheduler``).  ``.done`` WINS
    over any lease: a stale lease next to a ``.done`` is garbage and any
    scanner may remove it.
``.chunk_<prefix>.failed``
    quarantine marker.  Honoured by every worker: a poison chunk is never
    re-claimed.

**Reclaim.**  A worker that scans the outdir and finds a lease whose
heartbeat deadline has EXPIRED assumes the owner is dead and reclaims the
chunk: it atomically replaces the lease with its own (requeues + 1) and
re-runs the work.  This gives at-least-once execution; it is made SAFE by
the per-chunk-prefixed atomic outputs — if the "dead" owner was merely
slow, both complete and the second overwrites with identical bytes, and
``.done`` wins over any stale lease.  Clock skew between hosts eats into
the TTL margin, so ``lease_ttl_s`` should stay well above both the skew
bound and the heartbeat interval (default: TTL/3).

**Drain.**  SIGTERM requests a graceful drain: the worker finishes the
chunk it is running, commits it, releases any still-unstarted lease and
exits cleanly — remaining chunks stay PENDING for the next worker.  A
second SIGTERM falls through to the previous handler.

Chaos hooks: ``scheduler.claim`` / ``scheduler.heartbeat`` /
``scheduler.commit`` fault points join ``scheduler.run_one`` in the
``faults`` registry (``KAFKA_TPU_FAULTS``).  Telemetry: live-lease /
active-worker gauges, ``kafka_scheduler_reclaims_total``, per-chunk
requeue counts, and ``chunk_claimed`` / ``chunk_reclaimed`` /
``lease_released`` events.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..io.tiling import Chunk
from ..resilience import (
    FATAL,
    TRANSIENT,
    Deadline,
    RetryPolicy,
    classify_failure,
    faults,
)
from ..telemetry import get_registry, stopwatch, tracing
from ..telemetry import live as live_telemetry
from .scheduler import (
    _write_marker,
    chunk_metrics,
    failed_marker_path,
    mark_done,
    mark_failed,
    marker_path,
    sweep_stale_tmp,
    _tmp_name,
)

LOG = logging.getLogger(__name__)

#: default heartbeat-lease time-to-live.  A worker that misses renewals
#: for this long is presumed dead and its chunk is reclaimed; renewals
#: run every TTL/3, so one missed beat never costs the lease.
DEFAULT_LEASE_TTL_S = 30.0

#: the queue's chunk universe, written once at startup so read-only
#: consumers (``queue_status``) can count PENDING chunks — a chunk
#: nobody touched yet has no marker files at all.
MANIFEST_NAME = ".queue_manifest.json"

#: chunk states reported by :func:`scan_chunk` / :func:`queue_status`.
PENDING = "pending"
LEASED = "leased"
LEASE_EXPIRED = "lease_expired"
DONE = "done"
FAILED = "failed"


def lease_path(outdir: str, prefix: str) -> str:
    return os.path.join(outdir, f".chunk_{prefix}.lease")


def chunk_prefix(chunk: Chunk) -> str:
    """The output filename prefix (same chunk-id trick as
    ``assign_chunks``, ``kafka_test_Py36.py:164-166``)."""
    return f"{chunk.chunk_no:04x}"


def default_worker_id() -> str:
    return f"{socket.gethostname()}:{os.getpid()}"


def read_marker(path: str) -> Optional[dict]:
    """Tolerant marker read: ``None`` when the file is missing, ``{}``
    when it exists but is empty/corrupt (legacy payloads and torn
    pre-atomic writes must degrade, not crash the scan)."""
    try:
        with open(path) as f:
            payload = json.load(f)
        return payload if isinstance(payload, dict) else {}
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return {}


def _lease_payload(prefix: str, owner: str, lease_ttl_s: float,
                   requeues: int, claimed: Optional[float] = None) -> dict:
    now = time.time()
    return {
        "prefix": prefix,
        "owner": owner,
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "claimed": round(claimed if claimed is not None else now, 6),
        "deadline": round(now + lease_ttl_s, 6),
        "requeues": int(requeues),
    }


def _try_claim(outdir: str, prefix: str, owner: str, lease_ttl_s: float,
               requeues: int = 0, reclaim: bool = False) -> Optional[dict]:
    """Atomically claim ``prefix``; returns the lease payload or ``None``
    when another worker won the race.

    Fresh claims use ``os.link`` (exclusive create: fails when a lease
    exists).  Reclaims use ``os.replace`` (the expired lease is
    overwritten in one step — no window with no lease on disk) and then
    verify ownership by re-reading: if a third worker replaced us in the
    gap, we lost and move on.
    """
    faults.fault_point("scheduler.claim", prefix=prefix, owner=owner)
    payload = _lease_payload(prefix, owner, lease_ttl_s, requeues)
    path = lease_path(outdir, prefix)
    tmp = _tmp_name(path)
    with open(tmp, "w") as f:
        json.dump(payload, f)
    if reclaim:
        os.replace(tmp, path)
        current = read_marker(path)
        if not current or current.get("owner") != owner:
            return None
        return payload
    try:
        os.link(tmp, path)
    except FileExistsError:
        return None
    finally:
        try:
            os.unlink(tmp)
        except OSError:  # already consumed by os.replace above
            pass
    return payload


def _renew_lease(outdir: str, payload: dict, lease_ttl_s: float) -> None:
    """Heartbeat: push the deadline out, keeping claim time + requeues."""
    fresh = _lease_payload(
        payload["prefix"], payload["owner"], lease_ttl_s,
        payload.get("requeues", 0), claimed=payload.get("claimed"),
    )
    path = lease_path(outdir, payload["prefix"])
    tmp = _tmp_name(path)
    with open(tmp, "w") as f:
        json.dump(fresh, f)
    os.replace(tmp, path)


def _release_lease(outdir: str, prefix: str, owner: str) -> bool:
    """Remove our own lease (commit, quarantine, or drain).  Only the
    current owner's lease is removed — a reclaimed-from-us lease belongs
    to its new owner now."""
    current = read_marker(lease_path(outdir, prefix))
    if current is None or (current and current.get("owner") != owner):
        return False
    try:
        os.unlink(lease_path(outdir, prefix))
    except OSError:
        return False
    return True


@dataclass(frozen=True)
class ChunkScan:
    """One chunk's queue state at scan time."""

    prefix: str
    state: str
    lease: Optional[dict] = None


def scan_chunk(outdir: str, prefix: str, now: Optional[float] = None,
               cleanup: bool = False) -> ChunkScan:
    """Classify one chunk.  ``.done`` wins over any lease (with
    ``cleanup=True`` the stale lease is removed on sight); a lease with a
    corrupt/absent deadline counts as expired — a torn lease must never
    wedge the queue."""
    now = time.time() if now is None else now
    if os.path.exists(marker_path(outdir, prefix)):
        if cleanup and os.path.exists(lease_path(outdir, prefix)):
            try:
                os.unlink(lease_path(outdir, prefix))
            except OSError:  # raced another cleaner — outcome identical
                pass
        return ChunkScan(prefix, DONE)
    if os.path.exists(failed_marker_path(outdir, prefix)):
        return ChunkScan(prefix, FAILED)
    lease = read_marker(lease_path(outdir, prefix))
    if lease is None:
        return ChunkScan(prefix, PENDING)
    deadline = lease.get("deadline")
    if not isinstance(deadline, (int, float)) or deadline <= now:
        return ChunkScan(prefix, LEASE_EXPIRED, lease)
    return ChunkScan(prefix, LEASED, lease)


def write_manifest(outdir: str, chunks: Sequence[Chunk]) -> str:
    """Persist the chunk universe (idempotent — every worker computes the
    same list, so the first atomic write wins and the rest skip)."""
    path = os.path.join(outdir, MANIFEST_NAME)
    if not os.path.exists(path):
        _write_marker(path, {
            "chunks": [
                {"prefix": chunk_prefix(c), **c._asdict()} for c in chunks
            ],
        })
    return path


def _discover_prefixes(outdir: str) -> List[str]:
    """Chunk prefixes visible from marker files alone (the no-manifest
    fallback: PENDING chunks are invisible without one)."""
    found = set()
    for name in os.listdir(outdir):
        if not name.startswith(".chunk_"):
            continue
        stem, _, suffix = name[len(".chunk_"):].rpartition(".")
        if suffix in ("done", "failed", "lease") and stem:
            found.add(stem)
    return sorted(found)


def queue_status(outdir: str, now: Optional[float] = None) -> dict:
    """Read-only snapshot of a queue outdir for operators and tests
    (the JAX package's ``tools/queue_status.py`` renders the same
    directory).  Never mutates the queue."""
    now = time.time() if now is None else now
    manifest = read_marker(os.path.join(outdir, MANIFEST_NAME))
    if manifest and manifest.get("chunks"):
        prefixes = [c["prefix"] for c in manifest["chunks"]]
    else:
        manifest = None
        prefixes = _discover_prefixes(outdir)
    counts = {PENDING: 0, LEASED: 0, LEASE_EXPIRED: 0, DONE: 0, FAILED: 0}
    chunks: Dict[str, dict] = {}
    workers: Dict[str, dict] = {}
    for prefix in prefixes:
        s = scan_chunk(outdir, prefix, now=now)
        counts[s.state] += 1
        entry = {"state": s.state}
        if s.lease is not None:
            owner = str(s.lease.get("owner", "?"))
            entry["owner"] = owner
            entry["requeues"] = s.lease.get("requeues", 0)
            if isinstance(s.lease.get("deadline"), (int, float)):
                entry["deadline_in_s"] = round(s.lease["deadline"] - now, 3)
            w = workers.setdefault(
                owner, {"live": [], "expired": []}
            )
            w["live" if s.state == LEASED else "expired"].append(prefix)
        chunks[prefix] = entry
    return {
        "outdir": os.path.abspath(outdir),
        "manifest": manifest is not None,
        "n_chunks": len(prefixes),
        "counts": counts,
        "workers": workers,
        "chunks": chunks,
    }


# ---------------------------------------------------------------------------
# Heartbeat thread: renews the owner's current lease until stopped.
# ---------------------------------------------------------------------------

class _Heartbeat:
    """One background renewal thread per worker.  ``watch(payload)``
    points it at the lease just claimed; ``unwatch()`` after
    commit/quarantine.  A failed or lost renewal is recorded and survived
    — the queue's safety net for it is reclaim, not a crashed worker."""

    def __init__(self, outdir: str, owner: str, lease_ttl_s: float,
                 interval_s: Optional[float] = None):
        self._outdir = outdir
        self._owner = owner
        self._ttl = lease_ttl_s
        self._interval = interval_s if interval_s else lease_ttl_s / 3.0
        self._lock = threading.Lock()
        self._payload: Optional[dict] = None
        self._stop = threading.Event()
        self.lost = threading.Event()
        # Cross-thread trace propagation: capture the constructing
        # thread's context, re-install it on the worker.
        self._ctx = tracing.current_context()
        self._thread = threading.Thread(
            target=self._run, name="lease-heartbeat", daemon=True,
        )
        self._thread.start()

    def watch(self, payload: dict) -> None:
        with self._lock:
            self._payload = dict(payload)
        self.lost.clear()

    def unwatch(self) -> None:
        with self._lock:
            self._payload = None

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        tracing.set_context(self._ctx)
        tracing.set_lane("scheduler")
        while not self._stop.wait(self._interval):
            self.beat()

    def beat(self) -> None:
        with self._lock:
            payload = self._payload
        if payload is None:
            return
        prefix = payload["prefix"]
        reg = get_registry()
        try:
            faults.fault_point(
                "scheduler.heartbeat", prefix=prefix, owner=self._owner,
            )
            current = read_marker(lease_path(self._outdir, prefix))
            if not current or current.get("owner") != self._owner:
                # Reclaimed from under us (we were presumed dead).  Keep
                # running: outputs are idempotent and .done wins — but
                # stop renewing and record the takeover.
                self.lost.set()
                self.unwatch()
                reg.emit(
                    "lease_lost", prefix=prefix, worker=self._owner,
                    holder=(current or {}).get("owner"),
                )
                return
            _renew_lease(self._outdir, payload, self._ttl)
        except Exception as exc:
            # A missed beat is survivable (the deadline has 3x headroom);
            # a crashed heartbeat thread is not — record and carry on.
            reg.emit(
                "heartbeat_failed", prefix=prefix, worker=self._owner,
                error=repr(exc)[:300],
            )


# ---------------------------------------------------------------------------
# SIGTERM drain.
# ---------------------------------------------------------------------------

def _install_drain(drain: threading.Event):
    """First SIGTERM sets the drain flag (finish current chunk, release
    unstarted leases, exit 0) and restores the PREVIOUS handler, so a
    second SIGTERM terminates through the normal chain.  No-op off the
    main thread — signal.signal is main-thread-only."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return None
    prev = signal.getsignal(signal.SIGTERM)

    def handler(signum, frame):
        drain.set()
        get_registry().emit("worker_drain", signal="SIGTERM")
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


# ---------------------------------------------------------------------------
# The worker loop.
# ---------------------------------------------------------------------------

def run_queue(
    chunks: Sequence[Chunk],
    run_one: Callable[[Chunk, str], None],
    outdir: str,
    lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
    worker_id: Optional[str] = None,
    heartbeat_interval_s: Optional[float] = None,
    poll_interval_s: Optional[float] = None,
    retry_policy: Optional[RetryPolicy] = None,
    quarantine: bool = False,
    chunk_deadline_s: Optional[float] = None,
    max_requeues: Optional[int] = None,
) -> dict:
    """Run this worker against the shared chunk queue until every chunk
    is ``.done``/``.failed`` (or a SIGTERM drain is requested).

    The self-healing replacement for ``run_chunks``'s static assignment:
    N workers pointed at one ``outdir`` cooperate with no coordinator —
    claims are atomic lease files, liveness is the heartbeat deadline,
    and a worker that dies mid-chunk has its lease EXPIRE and the chunk
    reclaimed by a survivor (at-least-once; safe because the per-chunk
    prefixed outputs are atomic and deterministic, and ``.done`` wins).

    The fault-tolerance options compose unchanged: ``retry_policy`` re-runs transient
    chunk failures in place (the lease stays held, heartbeat running);
    ``quarantine=True`` converts exhausted/poison failures into the
    ``.chunk_<prefix>.failed`` marker all hosts honour;
    ``chunk_deadline_s`` classifies an over-budget chunk poison.
    ``max_requeues`` (with quarantine) bounds crash-loop reclaims: a
    chunk that keeps killing its workers is quarantined rather than
    reclaimed forever.

    Returns stats: ``{"worker", "total", "run", "reclaimed", "failed",
    "skipped", "claim_errors", "drained", "pending_at_exit", "wall_s"}``.
    """
    os.makedirs(outdir, exist_ok=True)
    sweep_stale_tmp(outdir)
    write_manifest(outdir, chunks)
    owner = worker_id or default_worker_id()
    # Queue-state export into the process's live status: the queue this
    # worker serves, under the same host:pid worker id as its leases.
    live_telemetry.update_status(
        queue_outdir=os.path.abspath(outdir), worker_id=owner,
        lease_ttl_s=lease_ttl_s,
    )
    by_prefix = {chunk_prefix(c): c for c in chunks}
    prefixes = list(by_prefix)
    # Stable per-worker rotation: workers start their claim scan at
    # different offsets, so a fleet doesn't fight over chunk 1.
    if prefixes:
        offset = zlib.crc32(owner.encode()) % len(prefixes)
        prefixes = prefixes[offset:] + prefixes[:offset]
    poll = poll_interval_s if poll_interval_s else max(
        0.05, min(5.0, lease_ttl_s / 4.0)
    )

    reg = get_registry()
    metrics = chunk_metrics(reg)
    m_reclaims = reg.counter(
        "kafka_scheduler_reclaims_total",
        "expired leases reclaimed from presumed-dead workers",
    )
    m_requeues = reg.counter(
        "kafka_scheduler_chunk_requeues_total",
        "reclaim count per chunk (labelled by prefix) — how often this "
        "chunk's worker died or stalled before commit",
    )
    m_live = reg.gauge(
        "kafka_scheduler_leases_live",
        "live (unexpired) leases visible at the last queue scan",
    )
    m_workers = reg.gauge(
        "kafka_scheduler_workers_active",
        "distinct owners of live leases at the last queue scan",
    )

    stats = {
        "worker": owner, "total": len(chunks), "run": 0, "reclaimed": 0,
        "failed": 0, "skipped": 0, "claim_errors": 0, "drained": False,
        "pending_at_exit": 0, "wall_s": 0.0,
    }
    drain = threading.Event()
    prev_handler = _install_drain(drain)
    hb = _Heartbeat(outdir, owner, lease_ttl_s, heartbeat_interval_s)
    held: Optional[str] = None
    t0 = time.time()
    try:
        while not drain.is_set():
            now = time.time()
            scans = [scan_chunk(outdir, p, now=now, cleanup=True)
                     for p in prefixes]
            open_scans = [s for s in scans if s.state not in (DONE, FAILED)]
            live = [s for s in open_scans if s.state == LEASED]
            m_live.set(len(live))
            m_workers.set(len({
                str(s.lease.get("owner")) for s in live if s.lease
            }))
            metrics["pending"].set(len(open_scans))
            if not open_scans:
                break
            claimed_scan = None
            lease = None
            for s in open_scans:
                if s.state not in (PENDING, LEASE_EXPIRED) or drain.is_set():
                    continue
                requeues = 0
                if s.state == LEASE_EXPIRED:
                    requeues = int((s.lease or {}).get("requeues", 0)) + 1
                    if (quarantine and max_requeues is not None
                            and requeues > max_requeues):
                        # A chunk that keeps killing workers is poison
                        # for the whole fleet — quarantine it instead of
                        # reclaiming forever.
                        mark_failed(outdir, s.prefix, {
                            "chunk": by_prefix[s.prefix].chunk_no,
                            "failure_class": "poison",
                            "error": (
                                f"requeue budget exhausted "
                                f"({requeues - 1} reclaims > "
                                f"{max_requeues})"
                            ),
                        })
                        try:
                            # The dead owner's expired lease is garbage
                            # now — .failed wins; clear it directly.
                            os.unlink(lease_path(outdir, s.prefix))
                        except OSError:
                            pass
                        stats["failed"] += 1
                        metrics["failed"].inc()
                        reg.emit(
                            "chunk_quarantined", prefix=s.prefix,
                            chunk=by_prefix[s.prefix].chunk_no,
                            failure_class="poison",
                            error="requeue budget exhausted",
                        )
                        continue
                try:
                    lease = _try_claim(
                        outdir, s.prefix, owner, lease_ttl_s,
                        requeues=requeues,
                        reclaim=(s.state == LEASE_EXPIRED),
                    )
                except BaseException as exc:
                    if classify_failure(exc) != TRANSIENT:
                        raise
                    stats["claim_errors"] += 1
                    LOG.warning("claim of %s failed transiently: %r",
                                s.prefix, exc)
                    continue
                if lease is not None:
                    claimed_scan = s
                    break
            if claimed_scan is None:
                if drain.is_set():
                    break
                # Nothing claimable: others hold live leases.  Wake at
                # the earliest heartbeat deadline (reclaim opportunity)
                # or the poll interval, whichever is sooner.
                deadlines = [
                    s.lease["deadline"] for s in live
                    if isinstance((s.lease or {}).get("deadline"),
                                  (int, float))
                ]
                wait_s = poll
                if deadlines:
                    wait_s = min(poll, max(0.05, min(deadlines) - now))
                drain.wait(wait_s)
                continue

            prefix = claimed_scan.prefix
            chunk = by_prefix[prefix]
            reclaimed = claimed_scan.state == LEASE_EXPIRED
            if reclaimed:
                stats["reclaimed"] += 1
                m_reclaims.inc()
                m_requeues.inc(prefix=prefix)
                reg.emit(
                    "chunk_reclaimed", prefix=prefix,
                    chunk=chunk.chunk_no, worker=owner,
                    prev_owner=(claimed_scan.lease or {}).get("owner"),
                    requeues=lease["requeues"],
                )
            reg.emit(
                "chunk_claimed", prefix=prefix, chunk=chunk.chunk_no,
                worker=owner, reclaimed=reclaimed,
                requeues=lease["requeues"],
            )
            held = prefix
            hb.watch(lease)
            try:
                _run_claimed(
                    chunk, prefix, run_one, outdir, owner, stats, metrics,
                    retry_policy, quarantine, chunk_deadline_s, reg,
                )
            finally:
                hb.unwatch()
                if held is not None:
                    _release_lease(outdir, held, owner)
                    held = None
    finally:
        hb.stop()
        if held is not None and _release_lease(outdir, held, owner):
            reg.emit("lease_released", prefix=held, worker=owner,
                     reason="exit")
        _restore_drain(prev_handler)
        stats["drained"] = drain.is_set()
        now = time.time()
        still_open = [
            s for s in (scan_chunk(outdir, p, now=now) for p in prefixes)
            if s.state not in (DONE, FAILED)
        ]
        stats["pending_at_exit"] = len(still_open)
        stats["skipped"] = (stats["total"] - stats["run"]
                            - stats["failed"] - len(still_open))
        stats["wall_s"] = time.time() - t0
    return stats


def _run_claimed(chunk, prefix, run_one, outdir, owner, stats, metrics,
                 retry_policy, quarantine, chunk_deadline_s, reg) -> bool:
    """One claimed chunk through the retry/quarantine machinery, ending in
    the atomic ``.done`` commit.  The ``scheduler.commit`` fault point
    sits INSIDE the attempt, before ``mark_done`` — a transient commit
    failure re-runs the whole chunk under the retry policy, which is
    exactly the at-least-once double-execution path the chaos tests pin
    (second completion overwrites with identical bytes)."""
    sw_chunk = stopwatch()

    def attempt():
        deadline = Deadline(chunk_deadline_s) if chunk_deadline_s else None
        faults.fault_point("scheduler.run_one", prefix=prefix)
        with tracing.push(chunk_id=prefix):
            run_one(chunk, prefix)
        if deadline is not None:
            deadline.check(f"chunk {prefix}")
        faults.fault_point("scheduler.commit", prefix=prefix)
        mark_done(outdir, prefix, {
            "chunk": chunk.chunk_no, "worker": owner,
            "wall_s": round(sw_chunk.elapsed(), 3),
        })

    try:
        if retry_policy is not None:
            retry_policy.call(attempt, site="scheduler.run_one")
        else:
            attempt()
    except BaseException as exc:
        cls = classify_failure(exc)
        if cls == FATAL or not quarantine:
            raise
        stats["failed"] += 1
        mark_failed(outdir, prefix, {
            "chunk": chunk.chunk_no,
            "failure_class": cls,
            "error": repr(exc)[:500],
            "worker": owner,
        })
        metrics["failed"].inc()
        reg.emit(
            "chunk_quarantined", prefix=prefix, chunk=chunk.chunk_no,
            failure_class=cls, error=repr(exc)[:300],
        )
        LOG.error(
            "chunk %s quarantined (%s): %r — queue continues; delete %s "
            "to re-attempt it",
            prefix, cls, exc, failed_marker_path(outdir, prefix),
        )
        return False
    t_end = sw_chunk.now()
    wall = t_end - sw_chunk.t0
    reg.trace.add_span(
        "chunk", sw_chunk.t0, t_end, lane="scheduler", cat="chunk",
        prefix=prefix, chunk=chunk.chunk_no,
    )
    stats["run"] += 1
    metrics["done"].inc()
    metrics["wall"].observe(wall)
    reg.emit(
        "chunk_done", prefix=prefix, chunk=chunk.chunk_no,
        wall_s=round(wall, 3),
    )
    return True
