"""Multi-worker observation prefetch with ordered delivery (port of
``kafka_tpu/engine/prefetch.py``).

``workers`` threads walk the run's observation dates, each performing the
full host-side read/gather for its claimed date (plus the optional
``transform``), and results are delivered strictly IN ORDER however the
reads complete.  In-flight results are bounded by ``depth`` (a semaphore
slot per undelivered date), so memory holds at most ``max(depth,
workers)`` gathered dates.

Streams: a worker thread's reads create CUDA tensors on its current
stream, which is the device's legacy default stream — the port makes no
side stream for host-to-device copies.  The main thread's solve runs on
that same stream, so every copy a worker enqueued is ordered before any
kernel the main thread enqueues after ``get`` hands the tensors over:
the default stream gives the ordering, and no event is needed.  (A
source that copied on a side stream would have to record an event there
and make the consumer wait on it.)
"""

from __future__ import annotations

import datetime
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .protocols import DateObservation, ObservationSource
from .state import PixelGather
from ..resilience import (
    DEFAULT_READ_POLICY,
    TRANSIENT,
    DegradedDateError,
    RetryPolicy,
    classify_failure,
    faults,
)
from ..telemetry import get_registry, stopwatch, tracing

LOG = logging.getLogger(__name__)


class ObservationPrefetcher:
    """Reads ``dates`` from ``source`` on worker threads.

    ``get(date)`` returns the prefetched ``DateObservation`` for the next
    date in sequence — callers must consume dates in the order given
    (the filter's time loop does).

    Failure semantics: a read that fails
    with a TRANSIENT-class error is retried on the worker thread under
    ``retry_policy``; if retries are exhausted the date is delivered
    *degraded* — ``get`` raises :class:`DegradedDateError` so the engine
    can consume it as a missing observation — and the workers keep
    claiming later dates.  A POISON/FATAL-class error keeps today's
    fail-fast behaviour: it re-raises in the caller at the ``get`` for
    the failing date, and nothing new is claimed after it (later dates
    already in flight may complete).

    With ``workers > 1`` the source's ``get_observations`` is called
    CONCURRENTLY for different dates — sources must tolerate concurrent
    pure reads (all in-repo sources do; see the threading contract on
    ``ObservationSource``).  ``close`` joins every worker.
    """

    def __init__(
        self,
        source: ObservationSource,
        gather: PixelGather,
        dates: Sequence[datetime.datetime],
        depth: int = 2,
        transform=None,
        workers: int = 1,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self._source = source
        self._gather = gather
        self._policy = retry_policy if retry_policy is not None \
            else DEFAULT_READ_POLICY
        # Optional post-read hook run ON THE WORKER thread, so its work
        # overlaps the previous date's solve too.
        self._transform = transform
        self._dates: List[datetime.datetime] = list(dates)
        self._workers = max(1, int(workers))
        self._slots = threading.Semaphore(
            max(1, int(depth), self._workers)
        )
        self._cond = threading.Condition()
        #: idx -> ("ok", obs) | ("error", exc)
        self._results: Dict[int, Tuple[str, Any]] = {}
        self._next_claim = 0
        self._next_emit = 0
        self._stopped = threading.Event()
        # Telemetry handles bound once (registry resolved at construction
        # — the engine builds prefetchers after the driver's configure()).
        reg = get_registry()
        self._trace = reg.trace
        # Cross-thread trace propagation: contextvars do NOT flow into new
        # threads, so the constructing thread's context (run/chunk ids) is
        # captured here and re-installed on every worker.
        self._trace_ctx = tracing.current_context()
        self._m_read = reg.histogram(
            "kafka_prefetch_read_seconds",
            "host-side read/decode/warp/gather seconds per date "
            "(includes the optional transform, e.g. the mesh commit)",
        )
        self._m_wait = reg.histogram(
            "kafka_prefetch_wait_seconds",
            "seconds the engine loop blocked waiting for a prefetched "
            "date (0 when the pipeline is ahead)",
        )
        self._m_reads = reg.counter(
            "kafka_prefetch_reads_total",
            "observation dates read by prefetch workers",
        )
        self._m_depth = reg.gauge(
            "kafka_prefetch_queue_depth",
            "prefetched dates buffered and not yet consumed",
        )
        self._threads = [
            threading.Thread(
                target=self._worker, args=(i,),
                name=f"obs-prefetch-{i}", daemon=True,
            )
            for i in range(self._workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self, worker_index: int) -> None:
        tracing.set_context(self._trace_ctx)
        # One timeline track per worker thread; the single-worker default
        # keeps the canonical "prefetch" lane name.
        tracing.set_lane(
            "prefetch" if worker_index == 0 else f"prefetch-{worker_index}"
        )
        while True:
            self._slots.acquire()
            if self._stopped.is_set():
                return
            with self._cond:
                idx = self._next_claim
                if idx >= len(self._dates):
                    return
                self._next_claim += 1
            date = self._dates[idx]
            sw = stopwatch()

            def read():
                faults.fault_point("prefetch.read_date", date=str(date))
                obs = self._source.get_observations(date, self._gather)
                if self._transform is not None:
                    obs = self._transform(obs)
                return obs

            try:
                item = (
                    "ok",
                    self._policy.call(read, site="prefetch.read_date"),
                )
            except BaseException as exc:  # classified + re-raised at get()
                # Exhausted-transient reads degrade (the engine treats
                # the date as a missing observation); poison/fatal stay
                # fail-fast and abort the run at this date's get().
                if classify_failure(exc) == TRANSIENT:
                    item = ("degraded", exc)
                else:
                    item = ("error", exc)
            if item[0] == "ok":
                t1 = sw.now()
                self._m_read.observe(t1 - sw.t0)
                self._m_reads.inc()
                self._trace.add_span(
                    "prefetch_read", sw.t0, t1, cat="io", date=str(date),
                )
            with self._cond:
                self._results[idx] = item
                self._m_depth.set(len(self._results))
                self._trace.add_counter(
                    "prefetch_queue_depth", len(self._results)
                )
                if item[0] == "error":
                    # Don't claim past a failure: the run is about to
                    # abort at this date's get(); reading further dates
                    # would waste I/O and hold memory.
                    self._next_claim = len(self._dates)
                self._cond.notify_all()
            if item[0] == "error":
                return

    def get(self, date: datetime.datetime) -> DateObservation:
        sw = stopwatch()
        with self._cond:
            idx = self._next_emit
            while idx not in self._results and not self._stopped.is_set():
                self._cond.wait(timeout=0.5)
                # Watchdog: if every worker thread has exited and the
                # awaited index still has no result, no notify is ever
                # coming — fail loudly instead of spinning on the 0.5s
                # wait forever (a worker killed by a fatal error, or a
                # bug that let one exit without posting, used to wedge
                # the engine here).
                if (idx not in self._results
                        and not self._stopped.is_set()
                        and not any(t.is_alive() for t in self._threads)):
                    raise RuntimeError(
                        "prefetch workers died without delivering "
                        f"{date!s}"
                    )
            if idx not in self._results:
                raise RuntimeError("prefetcher closed while waiting")
            kind, payload = self._results.pop(idx)
            self._next_emit += 1
            self._m_depth.set(len(self._results))
            self._trace.add_counter(
                "prefetch_queue_depth", len(self._results)
            )
        self._m_wait.observe(sw.elapsed())
        self._slots.release()
        if kind == "error":
            raise payload
        if self._dates[idx] != date:
            # Out-of-order consumption would silently assimilate the wrong
            # acquisition; fail loudly instead.
            raise RuntimeError(
                f"prefetch order violation: requested {date}, queued "
                f"{self._dates[idx]}"
            )
        if kind == "degraded":
            raise DegradedDateError(date, payload)
        return payload

    def close(self) -> None:
        """Stop the workers; safe to call at any point (early abort)."""
        self._stopped.set()
        with self._cond:
            self._next_claim = len(self._dates)
            self._cond.notify_all()
        # Unblock workers parked on the slot semaphore.
        for _ in self._threads:
            self._slots.release()
        for t in self._threads:
            t.join(timeout=5.0)
        if any(t.is_alive() for t in self._threads):
            # A read longer than the join timeout is still in flight; it
            # holds file handles / host memory until it finishes.
            LOG.warning(
                "observation prefetch worker still running after close() "
                "(a read is in flight); it will exit after the current date"
            )


def planned_observation_dates(
    time_grid, observation_dates
) -> List[datetime.datetime]:
    """The exact, ordered sequence of acquisition dates ``KalmanFilter.run``
    will assimilate for this grid — the prefetcher's work list."""
    from ..core.time_grid import iterate_time_grid

    out: List[datetime.datetime] = []
    for _, locate_times, _ in iterate_time_grid(
        time_grid, observation_dates, verbose=False
    ):
        out.extend(locate_times)
    return out
