"""The assimilation service: queue -> admission -> solve -> respond
(port of ``kafka_tpu/serve/service.py``; the serving logic imports no
JAX there and is the same here).

The in-process heart of the serving daemon (``serve.daemon`` wraps it in
a filesystem transport; tests drive it directly).  Robustness is the design surface:

- **Admission first** (``serve.admission``): every submission is decided
  admit-or-shed BEFORE any work happens, against the bounded queue and
  the engine's telemetry gauges.  Shed requests get an immediate
  ``rejected`` response and a counted reason — overload degrades to fast
  rejection, never to queue collapse.
- **Journal before queue** (``serve.journal``): an admitted request is
  durable before it is acked, so a crash at ANY later point is
  recoverable by idempotent replay.
- **Deadlines** (``resilience.policy.Deadline``): a request whose
  wall-clock budget expired before its turn is CANCELLED — counted and
  answered, never silently dropped.
- **Classified failures**: a poison solve answers an ``error`` response
  (the daemon survives bad requests); transient solve/respond failures
  retry under a ``RetryPolicy``; fatal ones kill the process into the
  flight recorder, and the journal replays the in-flight request on
  restart.
- **Chaos hooks**: ``serve.admit`` / ``serve.solve`` / ``serve.respond``
  fault points make the shed, cancel, error and crash-resume paths
  scriptable deterministically on CPU (``KAFKA_TPU_FAULTS``).
- **Drain**: ``drain()`` (the daemon's SIGTERM) finishes in-flight and
  queued work, rejects new submissions with reason ``draining``, and
  returns with every admitted request answered; tile state is already
  durable because every serve ends in a checkpoint.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Dict, Optional

from ..resilience import (
    FATAL,
    DeadlineExceeded,
    RetryPolicy,
    classify_failure,
    faults,
)
from ..telemetry import get_registry, tracing
from ..telemetry import request_log
from ..telemetry.tracing import trace_span
from . import batch as batching
from .admission import AdmissionController, AdmissionPolicy
from .journal import RequestJournal
from .request import BadRequest, ServeRequest, parse_request
from .session import TileSession

LOG = logging.getLogger(__name__)

#: solve/respond retry default: one in-place retry of transient weather,
#: short deterministic backoff — a serving worker must not sit in long
#: backoff while the queue builds behind it.
DEFAULT_SERVE_RETRY = RetryPolicy(
    max_attempts=2, base_delay=0.1, multiplier=2.0, max_delay=1.0,
    jitter=0.0,
)


def _serve_metrics(reg):
    """Single registration site for the service's metric vocabulary."""
    return {
        "admitted": reg.counter(
            "kafka_serve_admitted_total",
            "requests accepted into the serve queue",
        ),
        "rejected": reg.counter(
            "kafka_serve_rejected_total",
            "requests shed at admission, labelled by reason — overload "
            "degrades to fast rejection, never silent queue collapse",
        ),
        "cancelled": reg.counter(
            "kafka_serve_cancelled_total",
            "admitted requests cancelled because their per-request "
            "deadline expired before serving",
        ),
        "errors": reg.counter(
            "kafka_serve_errors_total",
            "admitted requests answered with an error response "
            "(poison solves; the daemon itself survives)",
        ),
        "cache_hits": reg.counter(
            "kafka_serve_cache_hits_total",
            "requests answered from the in-memory result cache",
        ),
        "replayed": reg.counter(
            "kafka_serve_replayed_total",
            "journaled requests re-enqueued by crash-recovery replay",
        ),
        "respond_errors": reg.counter(
            "kafka_serve_respond_errors_total",
            "responses that could not be written after retries (the "
            "journal replays the request on restart)",
        ),
        "depth": reg.gauge(
            "kafka_serve_queue_depth",
            "requests admitted but not yet served (the admission "
            "controller's primary load signal)",
        ),
        "latency": reg.histogram(
            "kafka_serve_latency_seconds",
            "submit-to-response seconds for OK-served requests",
        ),
        "batches": reg.counter(
            "kafka_serve_batches_total",
            "micro-window admission groups of two or more compatible "
            "requests handed to the batch executor together",
        ),
        "batch_requests": reg.counter(
            "kafka_serve_batch_requests_total",
            "requests served as members of a coalesced admission group",
        ),
    }


class AssimilationService:
    """Long-lived serving core over a set of warm tile sessions."""

    def __init__(
        self,
        sessions: Dict[str, TileSession],
        root: str,
        policy: Optional[AdmissionPolicy] = None,
        default_deadline_s: Optional[float] = None,
        retry_policy: Optional[RetryPolicy] = None,
        result_cache_size: int = 256,
        journal_rotate_bytes: Optional[int] = None,
        journal_keep: int = 3,
        batch_window_ms: float = 0.0,
        max_batch: int = 8,
    ):
        self.sessions = dict(sessions)
        self.journal = RequestJournal(
            root, rotate_bytes=journal_rotate_bytes, keep=journal_keep,
        )
        self.admission = AdmissionController(policy)
        self.default_deadline_s = default_deadline_s
        self._retry = retry_policy if retry_policy is not None \
            else DEFAULT_SERVE_RETRY
        # Coalesced serving: 0 ms
        # keeps the classic one-at-a-time worker; a positive window
        # lets the worker hold a dequeued request up to this long while
        # compatible peers arrive, then serves the group as one batch.
        self._batch_window_s = max(0.0, float(batch_window_ms)) / 1e3
        self._max_batch = max(1, int(max_batch))
        self._executor = batching.BatchExecutor()
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self._cache_lock = threading.Lock()
        self._cache_size = int(result_cache_size)
        self._queue: "collections.deque[ServeRequest]" = collections.deque()
        self._cond = threading.Condition()
        self._responded = threading.Condition()
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._busy = False
        reg = get_registry()
        self._m = _serve_metrics(reg)
        # Thread-tracing convention: capture the constructing
        # thread's context, re-install it on the worker.
        self._ctx = tracing.current_context()
        self._worker = threading.Thread(
            target=self._run, name="serve-worker", daemon=True,
        )
        self._started = False

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "AssimilationService":
        """Replay the journal, then start the serving worker."""
        if self._started:
            return self
        replayed = self.journal.replay()
        for payload in replayed:
            try:
                req = parse_request(payload, replayed=True)
            except BadRequest:
                # A journaled line that no longer parses is forensic
                # residue, not recoverable work.
                get_registry().emit(
                    "request_unreplayable",
                    request_id=str(payload.get("request_id")),
                )
                continue
            if req.tile not in self.sessions:
                get_registry().emit(
                    "request_unreplayable", request_id=req.request_id,
                    reason=f"unknown tile {req.tile}",
                )
                continue
            self._m["replayed"].inc()
            get_registry().emit(
                "request_replayed", request_id=req.request_id,
                tile=req.tile, date=req.date.isoformat(),
            )
            # The replay CONTINUES the journaled trace (same request
            # id, original submission/admission stamps) — it does not
            # mint a fresh one; queue_wait restarts at re-enqueue.
            req.admitted_perf = time.perf_counter()
            request_log.note_inflight(
                req.request_id, tile=req.tile,
                date=req.date.isoformat(), stage="queued",
                replayed=True,
            )
            with self._cond:
                self._queue.append(req)
        self._set_depth()
        self._started = True
        self._worker.start()
        with self._cond:
            self._cond.notify_all()
        return self

    def close(self) -> None:
        """Stop the worker (after the queue drains) and release files."""
        self._stopped.set()
        with self._cond:
            self._cond.notify_all()
        if self._started:
            self._worker.join(timeout=60.0)
        self.journal.close()

    def stop_admitting(self) -> None:
        """Flip new submissions to ``rejected: draining`` immediately
        (the drain's first half, split out so the daemon can answer
        latecomers with explicit rejections before the final wait).
        Also wakes the worker: a partially-filled batch window must
        flush NOW — no admitted request sits out the micro-window once
        the drain started."""
        self._draining.set()
        with self._cond:
            self._cond.notify_all()

    def drain(self, timeout_s: Optional[float] = None) -> bool:
        """SIGTERM semantics: reject new work, finish everything already
        admitted.  Returns True when the queue fully drained."""
        if not self._draining.is_set():
            self._draining.set()
            get_registry().emit("serve_drain")
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        with self._cond:
            while self._queue or self._busy:
                wait = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    return False
                self._cond.wait(timeout=wait if wait is not None else 1.0)
        return True

    def set_batch_window(self, batch_window_ms: float) -> None:
        """Re-tune the admission micro-window live (0 disables
        coalescing).  Used by the bench harness to measure batched and
        unbatched serving in ONE run against the same warm sessions."""
        with self._cond:
            self._batch_window_s = max(0.0, float(batch_window_ms)) / 1e3

    def pending(self) -> int:
        with self._cond:
            return len(self._queue) + (1 if self._busy else 0)

    @property
    def draining(self) -> bool:
        """True once new submissions are being rejected (the /statusz
        surface; the internal event stays private)."""
        return self._draining.is_set()

    # -- submission -----------------------------------------------------

    def submit(self, payload: dict) -> dict:
        """Admit-or-shed one raw request payload.  Returns the ack:
        ``{"request_id", "status": "queued"|"rejected", ...}``.  Every
        rejection also lands as a response file so cross-process clients
        see it."""
        rid = payload.get("request_id") if isinstance(payload, dict) \
            else None
        try:
            faults.fault_point("serve.admit", request=str(rid))
            req = parse_request(
                payload, default_deadline_s=self.default_deadline_s,
            )
        except BaseException as exc:
            if classify_failure(exc) == FATAL:
                raise
            reason = "bad_request" if isinstance(exc, BadRequest) \
                else "admit_error"
            return self._reject(rid, reason, detail=repr(exc)[:200])
        if req.tile not in self.sessions:
            return self._reject(req.request_id, "unknown_tile")
        if self._draining.is_set() or self._stopped.is_set():
            return self._reject(req.request_id, "draining")
        with tracing.push(request_id=req.request_id), \
                trace_span("serve_admit", tile=req.tile):
            with self._cond:
                reason = self.admission.decide(
                    queue_depth=len(self._queue)
                )
                if reason is None:
                    # The admission stamp rides the journal line and the
                    # trace: admission_wait attribution survives crash
                    # replay and (via the wire) re-forwarding.
                    req.admitted_ts = time.time()
                    req.admitted_perf = time.perf_counter()
                    self.journal.record(req.payload())
                    # In-flight BEFORE the worker can dequeue it (we
                    # hold the queue lock): a request must never finish
                    # before /requestz saw it start.
                    request_log.note_inflight(
                        req.request_id, tile=req.tile,
                        date=req.date.isoformat(), stage="queued",
                        submitted_ts=req.submitted_ts,
                    )
                    self._queue.append(req)
                    self._m["admitted"].inc()
                    self._set_depth_locked()
                    self._cond.notify_all()
        if reason is not None:
            return self._reject(req.request_id, reason)
        get_registry().emit(
            "request_admitted", request_id=req.request_id,
            tile=req.tile, date=req.date.isoformat(),
        )
        return {"request_id": req.request_id, "status": "queued"}

    def _reject(self, request_id: Optional[str], reason: str,
                detail: Optional[str] = None) -> dict:
        self._m["rejected"].inc(reason=reason)
        get_registry().emit(
            "request_rejected", request_id=str(request_id), reason=reason,
        )
        ack = {"request_id": request_id, "status": "rejected",
               "reason": reason}
        # Load-state rejections carry the backoff hint so clients wait
        # out the overload instead of hammering a shedding replica.
        retry_after = self.admission.retry_after(reason)
        if retry_after is not None:
            ack["retry_after_s"] = retry_after
        if detail:
            ack["detail"] = detail
        if request_id and isinstance(request_id, str):
            # Best-effort: the rejection must reach cross-process
            # clients, but a full disk must not crash admission.
            try:
                self._publish(request_id, ack)
            except OSError as exc:
                LOG.warning("could not write rejection response for %s: "
                            "%r", request_id, exc)
        return ack

    # -- results --------------------------------------------------------

    def result(self, request_id: str,
               timeout_s: Optional[float] = None) -> Optional[dict]:
        """Block until ``request_id`` has a response (or timeout)."""
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        with self._responded:
            while True:
                got = self.journal.response(request_id)
                if got is not None:
                    return got
                wait = 1.0 if deadline is None \
                    else deadline - time.monotonic()
                if wait <= 0:
                    return None
                self._responded.wait(timeout=min(wait, 1.0))

    # -- the worker loop ------------------------------------------------

    def _run(self) -> None:
        tracing.set_context(self._ctx)
        tracing.set_lane("serve")
        while True:
            with self._cond:
                while not self._queue and not self._stopped.is_set():
                    self._cond.wait(timeout=0.5)
                if not self._queue and self._stopped.is_set():
                    return
                req = self._queue.popleft()
                self._busy = True
                self._set_depth_locked()
            try:
                group = self._collect_batch(req)
                if len(group) == 1:
                    self._process(req)
                else:
                    self._process_batch(group)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _collect_batch(self, head: ServeRequest) -> list:
        """The admission micro-window: hold the dequeued ``head`` up to
        ``batch_window_ms`` while compatible peers arrive — same shape
        bucket, a DISTINCT tile (sessions are single-threaded), forward
        kind (smoothed never mixes), not a crash replay.  Flushes
        immediately when the window is off, the head is ineligible, or
        a drain/stop is in progress (no request waits out the window
        during SIGTERM drain or ``--exit-when-idle``)."""
        group = [head]
        if (
            self._batch_window_s <= 0.0 or self._max_batch <= 1
            or head.smoothed or head.replayed
            or self._draining.is_set() or self._stopped.is_set()
        ):
            return group
        key = batching.session_bucket_key(self.sessions[head.tile])
        if key is None:
            return group
        tiles = {head.tile}
        deadline = time.perf_counter() + self._batch_window_s
        with self._cond:
            while len(group) < self._max_batch:
                for peer in list(self._queue):
                    if (
                        peer.smoothed or peer.replayed
                        or peer.tile in tiles
                    ):
                        continue
                    session = self.sessions.get(peer.tile)
                    if session is None:
                        continue
                    if batching.session_bucket_key(session) != key:
                        continue
                    self._queue.remove(peer)
                    group.append(peer)
                    tiles.add(peer.tile)
                    if len(group) >= self._max_batch:
                        break
                if (
                    len(group) >= self._max_batch
                    or self._draining.is_set()
                    or self._stopped.is_set()
                ):
                    break
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                self._cond.wait(timeout=wait)
            self._set_depth_locked()
        return group

    def _process_batch(self, group: list) -> None:
        """Serve one coalesced admission group: every member runs its
        FULL request pipeline concurrently (deadline, cache, solve,
        respond — one thread per member), with the engine dispatches
        meeting in the batch executor's rendezvous.  A member that
        errors, cancels or serves from cache simply leaves the
        rendezvous; its peers batch without it."""
        batch_id = f"batch-{group[0].request_id}"
        size = len(group)
        self._m["batches"].inc()
        self._m["batch_requests"].inc(size)
        get_registry().emit(
            "serve_batch_admitted", batch_id=batch_id, size=size,
            tiles=[r.tile for r in group],
        )
        for req in group:
            req.batch_id = batch_id
            req.batch_size = size
        members = self._executor.open(size)
        ctx = tracing.current_context()
        threads = []
        for req, member in list(zip(group, members))[1:]:
            t = threading.Thread(
                target=self._process_member,
                args=(req, member, ctx),
                name=f"serve-batch-{req.request_id}", daemon=True,
            )
            t.start()
            threads.append(t)
        self._process_member(group[0], members[0], ctx)
        for t in threads:
            t.join()

    def _process_member(self, req: ServeRequest, member, ctx) -> None:
        # Thread-tracing convention: contextvars don't cross
        # thread creation — re-install the worker's context first.
        tracing.set_context(ctx)
        try:
            with tracing.push(request_id=req.request_id):
                self._process_traced(req, member=member)
        finally:
            member.close()

    def _process(self, req: ServeRequest) -> None:
        # Request-scoped trace context: every span from here down —
        # queue_wait, serve_resume, the engine's own phases, the
        # respond write — carries the request id, so the stitched
        # per-request waterfall is one filter away.
        with tracing.push(request_id=req.request_id):
            self._process_traced(req)

    def _wait_phases(self, req: ServeRequest, t_deq: float) -> Dict:
        """The two pre-solve phases: admission_wait (client submit ->
        admission decision, wall clock — cross-process on the
        filesystem transport) and queue_wait (admission -> this
        dequeue).  The queue_wait also lands as a retroactive span so
        the waterfall shows the queue, not a gap."""
        admitted = req.admitted_ts if req.admitted_ts is not None \
            else req.submitted_ts
        phases = {
            "admission_wait_ms":
                max(0.0, admitted - req.submitted_ts) * 1e3,
        }
        if req.admitted_perf is not None:
            phases["queue_wait_ms"] = \
                max(0.0, t_deq - req.admitted_perf) * 1e3
            get_registry().trace.add_span(
                "queue_wait", req.admitted_perf, t_deq, cat="phase",
                tile=req.tile,
            )
        return phases

    def _trace_block(self, req: ServeRequest, phases: Dict) -> dict:
        """The response's ``trace`` stamp (finalised in _respond: the
        dump phase and e2e close when the answer is published)."""
        out = {
            "request_id": req.request_id,
            "phases": {k: round(v, 3) for k, v in phases.items()},
            "admitted_ts": req.admitted_ts,
            "replayed": req.replayed,
            "_anchor_perf": time.perf_counter(),
        }
        if req.batch_id is not None:
            out["batch_id"] = req.batch_id
            out["batch_size"] = req.batch_size
        return out

    def _process_traced(self, req: ServeRequest, member=None) -> None:
        reg = get_registry()
        # The request KIND is part of the response identity: a smoothed
        # (reanalysis) answer and the forward analysis for the same
        # (tile, date) are different products.
        key = (req.tile, req.date.isoformat(), req.smoothed)
        t_deq = time.perf_counter()
        phases = self._wait_phases(req, t_deq)
        request_log.note_inflight(req.request_id, stage="solving")
        try:
            if req.deadline is not None:
                req.deadline.check(f"request {req.request_id}")
        except DeadlineExceeded as exc:
            if member is not None:
                # Leave the rendezvous BEFORE the respond write: batch
                # peers must never wait on a cancelled member's I/O.
                member.close()
            self._m["cancelled"].inc()
            reg.emit(
                "request_cancelled", request_id=req.request_id,
                tile=req.tile, date=req.date.isoformat(),
                waited_s=round(time.time() - req.submitted_ts, 3),
            )
            self._finish(req, {
                "status": "cancelled", "reason": "deadline",
                "detail": str(exc), "tile": req.tile,
                "date": req.date.isoformat(),
            }, phases)
            return
        # A reanalysis answer is a function of the WHOLE chain, and the
        # chain grows with every forward serve — caching one would pin a
        # stale smoothed state past the next checkpoint.  Forward
        # answers are append-only facts; only those are cacheable.
        with self._cache_lock:
            cached = None if req.smoothed else self._cache.get(key)
        if cached is not None:
            if member is not None:
                # A cache-hit member leaves immediately; its batch
                # peers rendezvous without it (mixed hit/miss groups).
                member.close()
            self._m["cache_hits"].inc()
            body = dict(cached)
            body.pop("trace", None)
            body["served_from"] = "cache"
            self._finish_ok(req, body, phases)
            return

        def solve():
            faults.fault_point(
                "serve.solve", request=req.request_id, tile=req.tile,
            )
            session = self.sessions[req.tile]
            # All solve dispatch goes through the batch executor
            # module.  Only a batch member's FIRST
            # attempt is coalesced: whatever its outcome, the member
            # leaves the rendezvous right there (inside the finally —
            # peers never wait on this request's retry backoff or
            # response write), and any retry runs solo.
            if member is not None and not member.used:
                member.used = True
                try:
                    return batching.solve_session(
                        session, req.date, smoothed=req.smoothed,
                        dispatcher=member.dispatcher(),
                    )
                finally:
                    member.close()
            return batching.solve_session(
                session, req.date, smoothed=req.smoothed,
            )

        try:
            if req.replayed:
                # A journal-replayed request shows a visible
                # `replayed` span continuing the original trace — not a
                # fresh waterfall under a fresh id.
                with trace_span("replayed", tile=req.tile):
                    body = self._retry.call(solve, site="serve.solve")
            else:
                body = self._retry.call(solve, site="serve.solve")
        except BaseException as exc:
            if classify_failure(exc) == FATAL:
                raise
            self._m["errors"].inc()
            reg.emit(
                "request_error", request_id=req.request_id,
                tile=req.tile, date=req.date.isoformat(),
                error=repr(exc)[:300],
            )
            self._finish(req, {
                "status": "error", "error": repr(exc)[:300],
                "tile": req.tile, "date": req.date.isoformat(),
            }, phases)
            return
        body = dict(body)
        phases.update(body.pop("trace_phases", {}))
        if member is not None and member.batch_spans:
            # Device time this request spent inside coalesced launches
            # (amortised across the members riding each launch).
            phases["serve_batch_ms"] = round(sum(
                (t1 - t0) * 1e3 for t0, t1 in member.batch_spans
            ), 3)
        if not req.smoothed:
            with self._cache_lock:
                self._cache[key] = body
                self._cache.move_to_end(key)
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
        self._finish_ok(req, body, phases)

    def _finish(self, req: ServeRequest, body: dict,
                phases: Dict) -> None:
        """Terminal path for cancelled/error responses: stamp the
        trace, publish, record the wide event."""
        body = dict(body)
        body.pop("trace_phases", None)
        body["trace"] = self._trace_block(req, phases)
        self._respond(req, body)
        self._record_request(req, body)

    def _finish_ok(self, req: ServeRequest, body: dict,
                   phases: Optional[Dict] = None) -> None:
        latency = time.time() - req.submitted_ts
        body = dict(body)
        body.pop("trace_phases", None)
        body["request_id"] = req.request_id
        body["latency_ms"] = round(latency * 1e3, 3)
        if phases is not None:
            body["trace"] = self._trace_block(req, phases)
        if not req.replayed:
            self._m["latency"].observe(latency)
        get_registry().emit(
            "request_done", request_id=req.request_id, tile=req.tile,
            date=req.date.isoformat(),
            served_from=body.get("served_from"),
            latency_ms=body["latency_ms"],
        )
        self._respond(req, body)
        self._record_request(req, body)

    def _record_request(self, req: ServeRequest, body: dict) -> None:
        """One wide event per finished admitted request (the replica's
        request_log.jsonl record)."""
        trace = body.get("trace") or {}
        request_log.record(request_log.build_record(
            "serve", req.request_id,
            status=body.get("status", "?"),
            e2e_ms=trace.get("e2e_ms", body.get("latency_ms")),
            phases=trace.get("phases"),
            tile=req.tile, date=req.date.isoformat(),
            served_from=body.get("served_from"),
            smoothed=req.smoothed or None,
            replayed=req.replayed or None,
            solver_health=body.get("solver_health"),
            quality=body.get("quality"),
            batch_id=req.batch_id,
            batch_size=req.batch_size,
        ))

    def requestz(self, n: int = 32) -> dict:
        """The ``/requestz`` payload: in-flight + last-N completed."""
        return request_log.requestz(n)

    def _respond(self, req: ServeRequest, body: dict) -> None:
        body.setdefault("request_id", req.request_id)
        trace = body.get("trace")
        if isinstance(trace, dict):
            # Close the attribution window at publish time: dump picks
            # up everything since the solve returned (packing, cache
            # bookkeeping, serialisation prep); e2e_ms is the SERVER's
            # submit->publish wall, the denominator of phase coverage.
            anchor = trace.pop("_anchor_perf", None)
            if anchor is not None:
                trace["phases"]["dump_ms"] = round(
                    trace["phases"].get("dump_ms", 0.0)
                    + max(0.0, time.perf_counter() - anchor) * 1e3, 3,
                )
            now = time.time()
            trace["responded_ts"] = round(now, 6)
            trace["e2e_ms"] = round(
                max(0.0, now - req.submitted_ts) * 1e3, 3,
            )

        def write():
            faults.fault_point("serve.respond", request=req.request_id)
            return self._publish(req.request_id, body)

        try:
            self._retry.call(write, site="serve.respond")
        except BaseException as exc:
            if classify_failure(exc) == FATAL:
                raise
            # The solve's effects are durable (checkpoints); only the
            # answer is lost.  Counted + logged — and because no
            # response file exists, a restart's replay re-serves it.
            self._m["respond_errors"].inc()
            get_registry().emit(
                "respond_failed", request_id=req.request_id,
                error=repr(exc)[:300],
            )
            LOG.error("response write for %s failed: %r",
                      req.request_id, exc)

    def _publish(self, request_id: str, body: dict) -> str:
        path = self.journal.respond(request_id, body)
        with self._responded:
            self._responded.notify_all()
        return path

    def _set_depth(self) -> None:
        with self._cond:
            self._set_depth_locked()

    def _set_depth_locked(self) -> None:
        self._m["depth"].set(len(self._queue))
