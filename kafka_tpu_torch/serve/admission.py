"""Admission control and load shedding for the serving daemon (copy of
``kafka_tpu/serve/admission.py``, which imports no JAX).

Overload must degrade to FAST REJECTION, not queue collapse: a queue
that admits everything turns a 2x overload into unbounded latency for
every request (and unbounded host memory), while a bounded queue plus
cheap up-front rejection keeps the admitted requests' latency flat and
gives the shed requests an immediate, explicit answer they can retry
against another replica.

The controller reads the telemetry gauges as its load signals —
the SAME single-source-of-truth registry the bench health layer and the
Prometheus export read:

=============================== =====================================
``kafka_serve_queue_depth``     requests admitted but not yet served
                                (the primary signal; compared against
                                ``max_queue_depth``)
``kafka_prefetch_queue_depth``  prefetched-but-unconsumed observation
                                dates (host memory held by the input
                                pipeline)
``kafka_io_writer_backlog``     queued async GeoTIFF writes (host
                                memory + disk pressure on the output
                                side)
``kafka_health_unhealthy``      the latest ``probe_health`` verdict —
                                an off-band host serves garbage
                                latency, so shedding beats queueing
``kafka_fleet_dead_hosts``      dead workers in the fleet view (the
                                daemon refreshes it from the live
                                snapshots, ``telemetry.aggregate``) —
                                a degraded fleet sheds load instead of
                                queueing work the dead capacity was
                                meant to absorb
``kafka_quality_drift_active``  per-(tile, band) chi^2-ratio series in
                                a drift-sentinel alarm
                                (``telemetry.quality``) — a
                                statistically inconsistent filter is
                                serving wrong uncertainties, and an
                                operator may prefer explicit rejection
                                (reason ``quality_degraded``) over
                                quietly shipping them
``kafka_slo_alerts_firing``     PAGE-severity SLO alerts currently
                                firing (``telemetry.slo`` burn-rate
                                rules) — a service burning its error
                                budget catastrophically can shed
                                (reason ``slo_burn``) to stop the
                                burn at the front door
=============================== =====================================

Every decision is explicit: admitted requests count into
``kafka_serve_admitted_total``, shed requests into
``kafka_serve_rejected_total`` labelled by reason — overload is an
operator-visible number, never a silent drop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..telemetry import get_registry


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The rejected-vs-queued contract, as data.

    ``max_queue_depth`` bounds the service's own request queue (the
    explicit queue-or-reject line).  The two pipeline bounds shed load
    when the engine's host-side buffers back up; ``None`` disables a
    signal.  ``shed_when_unhealthy`` rejects while the latest health
    probe verdict is off-band.
    """

    max_queue_depth: int = 16
    max_prefetch_queue_depth: Optional[int] = 256
    max_writer_backlog: Optional[int] = 256
    shed_when_unhealthy: bool = True
    #: shed (reason ``fleet_degraded``) while the fleet view counts more
    #: dead hosts than this; None disables the signal (the default — it
    #: only means something when the daemon refreshes the fleet gauge).
    max_dead_hosts: Optional[int] = None
    #: shed (reason ``quality_degraded``) while any quality drift
    #: sentinel is alarming (``kafka_quality_drift_active`` > 0).  Off
    #: by default: most operators want degraded answers SERVED and
    #: labelled (the response's ``quality`` field), not refused.
    shed_on_quality_drift: bool = False
    #: shed (reason ``slo_burn``) while any PAGE-severity SLO alert is
    #: firing (``kafka_slo_alerts_firing{severity="page"}`` > 0,
    #: ``telemetry.slo``).  Off by default (opt in via
    #: ``kafka-serve --shed-slo``): shedding on an availability burn
    #: is itself more rejections, so the operator chooses whether the
    #: front door amplifies or absorbs.
    shed_on_slo: bool = False
    #: backoff hint attached to LOAD-STATE rejections (queue_full,
    #: draining, fleet_degraded, ...): clients that honor it
    #: (a load generator, a routing front door) wait instead of
    #: hammering a shedding replica.  Request-shaped rejections
    #: (bad_request, unknown_tile) never carry it — retrying cannot
    #: make a bad request good.
    retry_after_s: float = 0.5


#: rejection reasons that describe the SERVER's state, not the
#: request's — the ones a client should back off and retry (possibly
#: against another replica).
RETRYABLE_REASONS = frozenset({
    "queue_full", "prefetch_backlog", "writer_backlog", "unhealthy",
    "fleet_degraded", "quality_degraded", "slo_burn", "draining",
})


class AdmissionController:
    """Decides admit-vs-shed for one request; stateless between calls
    (all state lives in the telemetry registry it reads)."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy()

    def retry_after(self, reason: str) -> Optional[float]:
        """The backoff hint for one rejection reason — the policy's
        ``retry_after_s`` for load-state rejections, None for
        request-shaped ones."""
        if reason in RETRYABLE_REASONS:
            return self.policy.retry_after_s
        return None

    def decide(self, queue_depth: int) -> Optional[str]:
        """``None`` to admit, else the rejection reason (a short token
        that labels ``kafka_serve_rejected_total``)."""
        pol = self.policy
        if queue_depth >= pol.max_queue_depth:
            return "queue_full"
        reg = get_registry()
        if pol.max_prefetch_queue_depth is not None:
            depth = reg.value("kafka_prefetch_queue_depth")
            if depth is not None and depth > pol.max_prefetch_queue_depth:
                return "prefetch_backlog"
        if pol.max_writer_backlog is not None:
            backlog = reg.value("kafka_io_writer_backlog")
            if backlog is not None and backlog > pol.max_writer_backlog:
                return "writer_backlog"
        if pol.shed_when_unhealthy:
            # The latest health-probe verdict, read back from its gauge
            # (no probing here; unset while nothing probed).
            if reg.value("kafka_health_unhealthy"):
                return "unhealthy"
        if pol.max_dead_hosts is not None:
            dead = reg.value("kafka_fleet_dead_hosts")
            if dead is not None and dead > pol.max_dead_hosts:
                return "fleet_degraded"
        if pol.shed_on_quality_drift:
            drifting = reg.value("kafka_quality_drift_active")
            if drifting:
                return "quality_degraded"
        if pol.shed_on_slo:
            firing = reg.value(
                "kafka_slo_alerts_firing", severity="page"
            )
            if firing:
                return "slo_burn"
        return None
