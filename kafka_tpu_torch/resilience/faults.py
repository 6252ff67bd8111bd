"""Deterministic fault injection — the chaos half of the resilience layer
(a copy of ``kafka_tpu/resilience/faults.py``, which imports no JAX; the
site names are the same, so one ``KAFKA_TPU_FAULTS`` script drives both
packages).

Production code marks its fragile operations with named *fault points*
(``faults.fault_point("prefetch.read_date", ...)``); this registry counts
every pass through each site and raises a scripted :class:`InjectedFault`
on exactly the call numbers a test (or a CLI chaos run) armed.  With
nothing armed a fault point is one module-global boolean read — safe on
hot paths.

Sites (the port runs ``prefetch.read_date``, ``checkpoint.save``,
``io.read_band``, ``solver.pixel`` and ``device.oom`` so far):

================== ====================================================
``io.read_band``        GeoTIFF reads (``io.geotiff.read_geotiff`` /
                        ``read_geotiff_window``)
``prefetch.read_date``  one observation date's host-side read (prefetch
                        worker thread AND the synchronous
                        ``prefetch_depth=0`` path)
``scheduler.run_one``   one chunk execution attempt in
                        ``shard.scheduler.run_chunks`` and
                        ``shard.queue.run_queue``
``scheduler.claim``     one lease-claim attempt in the multi-host queue
                        (``shard.queue._try_claim`` — fresh claims and
                        reclaims both)
``scheduler.heartbeat`` one lease renewal on the queue worker's
                        background heartbeat thread
``scheduler.commit``    the ``.done`` commit of a queue-run chunk (fires
                        BEFORE ``mark_done``, so a transient commit
                        failure re-runs the chunk — the at-least-once
                        double-execution path)
``checkpoint.save``     one checkpoint shard write in
                        ``engine.checkpoint.Checkpointer.save``
``serve.admit``         one admission decision in
                        ``serve.service.AssimilationService.submit``
                        (an injected fault here sheds the request —
                        counted rejection, never a crashed daemon)
``serve.solve``         one request's incremental solve on the serving
                        worker (transient retries under the service
                        retry policy; poison answers an error response)
``serve.respond``       one atomic response write (a crash between
                        solve and respond is exactly what the request
                        journal's idempotent replay recovers)
``solver.pixel``        deterministic per-PIXEL corruption of the
                        Gauss-Newton linearisation (``h0`` forced NaN)
                        — the calls grammar addresses 0-based pixel
                        index ranges, not call numbers, and nothing is
                        raised: the armed pixels must come back
                        QA-quarantined through the solve-health path
                        (``core.solver_health``)
``obs.bias``            scripted ADDITIVE BIAS on observations — the
                        calls grammar addresses 1-based fetch-order
                        date numbers, and nothing is raised: the armed
                        dates' valid observations gain
                        ``telemetry.quality.OBS_BIAS_VALUE``, which the
                        quality ledger's drift sentinels must flag
                        (verdict flip + ``quality_drift`` event) while
                        unbiased dates stay bit-identical
``device.oom``          one window's solve dispatch in
                        ``engine.filter`` (unfused per-date AND fused
                        block paths) — stands in for XLA's
                        RESOURCE_EXHAUSTED; the flight recorder must
                        attach the devprof buffer census + kernel
                        table to the crash dump (``device_forensics``)
================== ====================================================

Scripting from tests::

    faults.script("prefetch.read_date", "2")        # 2nd call only
    faults.script("scheduler.run_one", "3", POISON)  # poison the 3rd
    faults.script("io.read_band", "2-4")             # calls 2..4
    faults.script("checkpoint.save", "5+")           # every call from 5
    ...
    faults.reset()

Scripting a CLI chaos run — the ``KAFKA_TPU_FAULTS`` env spec is
semicolon-separated ``<site>@<calls>[:<class>]`` items with the same
calls grammar (``N``, ``N-M``, ``N+``, ``*``) and class defaulting to
``transient``::

    KAFKA_TPU_FAULTS='prefetch.read_date@2;scheduler.run_one@3:poison' \
        python -m kafka_tpu_torch.cli.run_synthetic ...

Every fired fault lands in telemetry
(``kafka_resilience_faults_injected_total`` + a ``fault_injected``
event), so the forensic record of a chaos run names exactly what was
injected where.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Dict, List, Optional

from ..telemetry import get_registry
from .policy import FATAL, POISON, TRANSIENT

LOG = logging.getLogger(__name__)

ENV_VAR = "KAFKA_TPU_FAULTS"

_CLASSES = (TRANSIENT, POISON, FATAL)


class InjectedFault(RuntimeError):
    """A scripted failure.  Carries its failure class explicitly, so
    ``classify_failure`` routes it without heuristics."""

    def __init__(self, site: str, call_no: int, failure_class: str):
        super().__init__(
            f"injected {failure_class} fault at {site} (call #{call_no})"
        )
        self.site = site
        self.call_no = call_no
        self.kafka_failure_class = failure_class


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted failure window: calls ``first``..``last`` (1-based,
    inclusive; ``last=None`` = unbounded) at ``site`` raise with
    ``failure_class``."""

    site: str
    first: int
    last: Optional[int]
    failure_class: str = TRANSIENT

    def matches(self, call_no: int) -> bool:
        return self.first <= call_no and (
            self.last is None or call_no <= self.last
        )


_lock = threading.Lock()
_specs: Dict[str, List[FaultSpec]] = {}
_counts: Dict[str, int] = {}
_armed = False


def _parse_calls(text: str):
    text = text.strip()
    if text == "*":
        return 1, None
    if text.endswith("+"):
        return int(text[:-1]), None
    if "-" in text:
        lo, hi = text.split("-", 1)
        return int(lo), int(hi)
    n = int(text)
    return n, n


def parse_spec(text: str) -> List[FaultSpec]:
    """``KAFKA_TPU_FAULTS`` grammar -> specs (see module docstring)."""
    specs: List[FaultSpec] = []
    for item in text.split(";"):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(
                f"fault spec item {item!r}: expected "
                "'<site>@<calls>[:<class>]'"
            )
        site, rest = item.split("@", 1)
        calls, _, cls = rest.partition(":")
        cls = cls.strip() or TRANSIENT
        if cls not in _CLASSES:
            raise ValueError(
                f"fault spec item {item!r}: class {cls!r} not one of "
                f"{_CLASSES}"
            )
        first, last = _parse_calls(calls)
        specs.append(FaultSpec(
            site=site.strip(), first=first, last=last, failure_class=cls,
        ))
    return specs


def script(site: str, calls, failure_class: str = TRANSIENT) -> FaultSpec:
    """Arm one scripted failure.  ``calls`` uses the spec grammar
    (``"2"``, ``"2-4"``, ``"3+"``, ``"*"``) or is a plain int."""
    if failure_class not in _CLASSES:
        raise ValueError(f"failure_class {failure_class!r} not one of "
                         f"{_CLASSES}")
    first, last = _parse_calls(str(calls))
    spec = FaultSpec(site=site, first=first, last=last,
                     failure_class=failure_class)
    install([spec])
    return spec


def install(specs) -> None:
    """Arm a batch of :class:`FaultSpec` (additive)."""
    global _armed
    with _lock:
        for s in specs:
            _specs.setdefault(s.site, []).append(s)
        _armed = bool(_specs)


def install_from_env(environ=None) -> int:
    """Arm the ``KAFKA_TPU_FAULTS`` env spec (CLI chaos runs); returns
    how many spec items were installed (0 when the variable is unset)."""
    text = (environ if environ is not None else os.environ).get(ENV_VAR)
    if not text:
        return 0
    specs = parse_spec(text)
    install(specs)
    LOG.warning(
        "fault injection ARMED from %s: %d spec(s) — %s",
        ENV_VAR, len(specs), text,
    )
    return len(specs)


def reset() -> None:
    """Disarm everything and zero the per-site call counters."""
    global _armed
    with _lock:
        _specs.clear()
        _counts.clear()
        _armed = False


def active() -> bool:
    return _armed


def specs_for(site: str) -> List[FaultSpec]:
    """The armed specs for one site, without counting a call — for
    sites whose "calls" grammar addresses something other than call
    numbers (``solver.pixel`` reads its specs as pixel index ranges)."""
    with _lock:
        return list(_specs.get(site, ()))


def call_count(site: str) -> int:
    """How many times ``site``'s fault point has been passed (only
    counted while armed — an idle registry costs nothing)."""
    with _lock:
        return _counts.get(site, 0)


def fault_point(site: str, **context) -> None:
    """Declare a fragile operation.  No-op unless faults are armed; when
    a spec matches this site's current call number, raises the scripted
    :class:`InjectedFault` (and records it in telemetry first)."""
    if not _armed:
        return
    with _lock:
        n = _counts.get(site, 0) + 1
        _counts[site] = n
        spec = next(
            (s for s in _specs.get(site, ()) if s.matches(n)), None
        )
    if spec is None:
        return
    record_injection(
        site, call=n, failure_class=spec.failure_class,
        **{k: str(v) for k, v in context.items()},
    )
    raise InjectedFault(site, n, spec.failure_class)


def record_injection(site: str, **fields) -> None:
    """Land one fired fault in telemetry — the single registration site
    for the injected-faults counter.  Raising sites go through
    :func:`fault_point`; non-raising sites (``solver.pixel`` corrupts
    arrays instead of raising) call this directly."""
    reg = get_registry()
    reg.counter(
        "kafka_resilience_faults_injected_total",
        "scripted failures raised by the fault-injection harness, "
        "labelled by site",
    ).inc(site=site)
    reg.emit("fault_injected", site=site, **fields)
