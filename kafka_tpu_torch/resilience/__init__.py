"""Fault tolerance of the port: retry/backoff policy, failure
classification, deadlines, and deterministic fault injection (copies of
``kafka_tpu/resilience``, which imports no JAX).  The fragile layers
(``engine.prefetch``, ``engine.checkpoint``, ``io.geotiff``) ask these
helpers what to do.
"""

from . import faults  # noqa: F401
from .policy import (  # noqa: F401
    DEFAULT_READ_POLICY,
    EXIT_PARTIAL_SUCCESS,
    FATAL,
    POISON,
    TRANSIENT,
    Deadline,
    DeadlineExceeded,
    DegradedDateError,
    RetryPolicy,
    classify_failure,
)
