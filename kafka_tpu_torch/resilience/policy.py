"""Retry/backoff policies, failure classification and deadlines (a copy
of ``kafka_tpu/resilience/policy.py``, which imports no JAX).

- :func:`classify_failure` sorts an exception into one of three classes:
  ``transient`` (worth retrying: OSError, TimeoutError, ConnectionError),
  ``poison`` (deterministic: ValueError, shape errors, any unknown
  exception) and ``fatal`` (MemoryError, KeyboardInterrupt, SystemExit).
  An exception can override the heuristic by carrying a
  ``kafka_failure_class`` attribute (the fault-injection harness uses
  exactly this hook).
- :class:`RetryPolicy` retries transient failures with exponential
  backoff.  ``jitter=0`` gives a deterministic schedule; the ``sleep``
  callable is injectable so tests never wait wall-clock time.  Every
  retry lands in the telemetry registry
  (``kafka_resilience_retries_total`` + ``retry``/``retry_exhausted``
  events).
- :class:`Deadline` is a monotonic wall-clock budget for one call.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Optional

from ..telemetry import get_registry

LOG = logging.getLogger(__name__)

#: failure classes (the vocabulary every resilience decision speaks).
TRANSIENT = "transient"
POISON = "poison"
FATAL = "fatal"

#: exit code for "the run completed but quarantined some work" — the
#: sysexits EX_TEMPFAIL convention, distinct from 0 (full success) and
#: 1 (hard failure) so schedulers/CI can trigger a targeted rerun.
EXIT_PARTIAL_SUCCESS = 75

_FATAL_TYPES = (MemoryError, KeyboardInterrupt, SystemExit, GeneratorExit)
#: OSError covers IOError, FileNotFoundError, ConnectionError,
#: InterruptedError, TimeoutError (3.10+) — the I/O weather class.
_TRANSIENT_TYPES = (OSError, TimeoutError, ConnectionError)


def classify_failure(exc: BaseException) -> str:
    """``transient`` / ``poison`` / ``fatal`` for one exception.

    An explicit ``kafka_failure_class`` attribute on the exception wins
    (injected faults and :class:`DeadlineExceeded` use it); otherwise
    I/O-flavoured errors are transient, process-compromising errors are
    fatal, and everything unknown is poison — retrying a deterministic
    failure only burns wall-clock and hides the bug.
    """
    explicit = getattr(exc, "kafka_failure_class", None)
    if explicit in (TRANSIENT, POISON, FATAL):
        return explicit
    if isinstance(exc, _FATAL_TYPES):
        return FATAL
    if isinstance(exc, _TRANSIENT_TYPES):
        return TRANSIENT
    return POISON


class DegradedDateError(RuntimeError):
    """An observation date whose read exhausted its transient-failure
    retries.  Raised by ``ObservationPrefetcher.get`` INSTEAD of the
    underlying error so the engine can consume the date as a missing
    observation (predict-only window) — the Kalman structure makes a
    dateless window a plain propagation step (PAPER.md §propagation)."""

    def __init__(self, date, cause: BaseException):
        super().__init__(
            f"observation read for {date} degraded after retries: "
            f"{cause!r}"
        )
        self.date = date
        self.cause = cause


class DeadlineExceeded(RuntimeError):
    """A per-call wall-clock budget ran out.  Classified poison, not
    transient: in-process the hung call cannot be killed, so retrying it
    would wedge the run again — the scheduler quarantines instead."""

    kafka_failure_class = POISON


class Deadline:
    """Monotonic wall-clock budget for one call."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self) -> float:
        return self.seconds - self.elapsed()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, what: str = "call") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"{what} exceeded its {self.seconds:.1f}s deadline "
                f"(elapsed {self.elapsed():.1f}s)"
            )


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential-backoff retry for TRANSIENT failures.

    ``max_attempts`` counts the first try: ``max_attempts=3`` means one
    call plus up to two retries.  Delays follow ``base_delay *
    multiplier**k`` capped at ``max_delay``; ``jitter`` spreads each
    delay by a uniform ±fraction (0 = the deterministic schedule tests
    pin).  ``sleep`` is injectable so tests never wait wall-clock time.

    Poison/fatal failures are NEVER retried — they re-raise on the first
    attempt; a transient failure on the last attempt re-raises the
    ORIGINAL exception (callers classify it again to decide degradation
    vs abort).
    """

    max_attempts: int = 3
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.0
    sleep: Callable[[float], None] = time.sleep

    def delay(self, failures: int) -> float:
        """Backoff before the retry following the Nth failure (1-based)."""
        d = min(self.base_delay * self.multiplier ** (failures - 1),
                self.max_delay)
        if self.jitter:
            d *= 1.0 + random.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def schedule(self) -> list:
        """The full deterministic delay schedule (jitter applied per
        draw, so only meaningful with ``jitter=0`` — the test hook)."""
        return [self.delay(k) for k in range(1, self.max_attempts)]

    def call(self, fn: Callable, *args,
             site: str = "call",
             classify: Callable[[BaseException], str] = classify_failure,
             **kwargs):
        """Run ``fn`` under this policy.  ``site`` labels the telemetry
        (retry counter + events) so chaos forensics attribute every
        retry to its injection/failure point."""
        reg = get_registry()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:
                cls = classify(exc)
                if cls != TRANSIENT:
                    raise
                if attempt >= self.max_attempts:
                    reg.emit(
                        "retry_exhausted", site=site, attempts=attempt,
                        error=repr(exc)[:300],
                    )
                    LOG.warning(
                        "%s: transient failure persisted through %d "
                        "attempt(s): %r", site, attempt, exc,
                    )
                    raise
                d = self.delay(attempt)
                reg.counter(
                    "kafka_resilience_retries_total",
                    "transient failures retried under a RetryPolicy, "
                    "labelled by call site",
                ).inc(site=site)
                reg.emit(
                    "retry", site=site, attempt=attempt,
                    delay_s=round(d, 3), error=repr(exc)[:300],
                )
                LOG.warning(
                    "%s: transient failure on attempt %d/%d, retrying "
                    "in %.2fs: %r", site, attempt, self.max_attempts,
                    d, exc,
                )
                if d > 0:
                    self.sleep(d)


#: production default for host-side observation reads: three attempts,
#: 0.5s/2s backoff with ±10% jitter — generous enough for object-store
#: weather, bounded enough that a dead endpoint degrades in seconds.
DEFAULT_READ_POLICY = RetryPolicy(
    max_attempts=3, base_delay=0.5, multiplier=4.0, max_delay=8.0,
    jitter=0.1,
)
