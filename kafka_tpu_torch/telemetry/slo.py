"""SLO engine: declarative objectives, burn-rate alerts, error budgets
(port of ``kafka_tpu/telemetry/slo.py``).

The fleet emits every signal a production assimilation service needs —
admission rejections by reason, serve latency histograms, quality-drift
gauges, solver quarantine counters, device-fraction attribution — but
until this module nothing *watched* them: ``fleet_status --watch``
requires a human.  This is the layer between the metrics plane and the
operators, in the SRE idiom:

- **Declarative objectives** (:func:`default_objectives`): each
  :class:`Objective` names a target and a *signal* over the local
  :class:`~.registry.MetricsRegistry` —

  =============== ====================================================
  ``availability`` ok / (ok + rejected + error) from the admission /
                   service counters (``kafka_serve_latency_seconds``
                   count vs ``kafka_serve_rejected_total`` +
                   ``kafka_serve_errors_total``)
  ``latency``      fraction of served requests under the p99 bar,
                   from the serve latency histogram buckets (the
                   window p99 itself is derived with the fleet view's
                   ``quantile_from_buckets`` machinery)
  ``quality``      clean fraction of evaluations with
                   ``kafka_quality_drift_active`` == 0
  ``solver``       non-quarantined pixel fraction
                   (``kafka_solver_quarantined_pixels_total`` over
                   ``kafka_engine_pixels_total``)
  ``perf``         fraction of evaluations with
                   ``kafka_perf_device_fraction`` at or above the
                   floor
  =============== ====================================================

- **Multi-window multi-burn-rate rules**: the burn rate is the window
  error rate over the error budget (``1 - target``).  A burn above
  ``FAST_BURN_THRESHOLD`` over the FAST window raises a ``page``; a
  burn above ``SLOW_BURN_THRESHOLD`` over the SLOW window raises a
  ``warn`` — fast catastrophic burn pages in minutes, slow budget leak
  warns before the budget is gone.  Window lengths are constructor
  knobs so tier-1 chaos tests run in seconds.
- **Alert state machine** per (objective, severity):
  ``ok -> pending -> firing -> resolved(-> ok)``; transitions append to
  the ``alerts.jsonl`` ledger (events.jsonl rotation discipline), emit
  ``slo_alert`` / ``slo_resolved`` events and drive the
  ``kafka_slo_alerts_firing{severity=}`` gauges the admission layer
  (``shed_on_slo`` -> reason ``slo_burn``) and ``/healthz`` read.
- **Error-budget ledger** per objective: budget consumed so far
  (cumulative error rate over the error budget), remaining fraction,
  and a time-to-exhaustion estimate at the current slow burn rate.

Evaluation runs on ONE tracked background thread per process
(:func:`start_engine`, next to the live publisher); the evaluator
READS the health gauges through :func:`~.health.latest_verdict` — the
shared sampling path ``probe_health`` maintains — instead of probing
itself, so no second background prober exists per process.  Surfaces:
``/alertz`` (telemetry.httpd), the live snapshots / ``aggregate_fleet``
/ ``fleet_status`` fleet alert view, ``tools/slo_report.py`` over the
``alerts.jsonl`` ledgers, and the BENCH ``"slo"`` snapshot.  See
BASELINE.md "SLOs & alerting".
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from . import tracing
from .aggregate import quantile_from_buckets
from .registry import MetricsRegistry, get_registry

# ---------------------------------------------------------------------------
# SLO config block — the ONE sanctioned home for objective targets,
# burn-rate thresholds, window lengths and budget literals (kafkalint
# rule 18 ``magic-slo-threshold`` flags numeric SLO literals anywhere
# else).  Everything below is overridable per engine/objective; these
# are the fleet defaults BASELINE.md documents.
# ---------------------------------------------------------------------------

#: availability target: fraction of decided requests (ok + rejected +
#: error) that must be served ok.  Error budget = 1 - target.
AVAILABILITY_TARGET = 0.999
#: latency objective: at least this fraction of OK-served requests must
#: land under the bar below.
LATENCY_TARGET = 0.99
#: the latency bar (ms).  Warm serves measure ~30 ms; the bar leaves
#: room for queueing before the objective burns.
LATENCY_BAR_MS = 250.0
#: quality objective: fraction of evaluation ticks with NO drift
#: sentinel alarming (``kafka_quality_drift_active`` == 0).
CLEAN_FRACTION_TARGET = 0.99
#: solver objective: fraction of assimilated pixels NOT quarantined.
SOLVER_TARGET = 0.999
#: perf objective: fraction of evaluation ticks with the device
#: fraction at or above the floor.  With a 0.90 target the maximum
#: possible burn is 10: the perf objective can WARN (slow threshold 6)
#: but never page — throughput regressions are an operator concern,
#: not a wake-up call.
PERF_TARGET = 0.90
#: ``kafka_perf_device_fraction`` floor below which an evaluation tick
#: counts against the perf objective.
PERF_DEVICE_FRACTION_FLOOR = 0.05

#: multi-window burn-rate rule defaults (the SRE workbook shape): the
#: FAST window catches catastrophic burn and PAGES, the SLOW window
#: catches sustained budget leak and WARNS.  At burn 14.4 a 30-day
#: budget lasts ~2 days; at burn 6 it lasts 5 days.
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
FAST_BURN_THRESHOLD = 14.4
SLOW_BURN_THRESHOLD = 6.0
#: evaluation cadence of the background thread.
EVAL_INTERVAL_S = 5.0
#: a breached rule sits PENDING this long before it FIRES (0 = the
#: next evaluation after the breach confirms it — two consecutive
#: breached evaluations, well inside one fast window).
PENDING_FOR_S = 0.0
#: the error-budget accounting period (time-to-exhaustion horizon).
BUDGET_WINDOW_S = 30 * 24 * 3600.0

#: alerts.jsonl rotation (events.jsonl discipline: size-capped
#: segments, newest ``keep`` survive).
ALERTS_FILENAME = "alerts.jsonl"
ALERTS_ROTATE_BYTES = 8 * 1024 * 1024
ALERTS_KEEP = 3
# -- end of the sanctioned SLO config block ---------------------------------

#: alert severities (the ``kafka_slo_alerts_firing`` label values).
SEVERITY_PAGE = "page"
SEVERITY_WARN = "warn"
SEVERITIES = (SEVERITY_PAGE, SEVERITY_WARN)

#: alert states.
OK = "ok"
PENDING = "pending"
FIRING = "firing"

LEDGER_SCHEMA = 1

#: bounded per-objective sample retention: the budget ledger is
#: computed over at most this many evaluation samples (the slow window
#: at the default cadence fits easily; a 30-day budget window is
#: approximated by the retained horizon on very long runs).
MAX_SAMPLES = 4096

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Registry-reading helpers (the signals' vocabulary).
# ---------------------------------------------------------------------------

def _metric(reg: MetricsRegistry, name: str):
    for m in reg.metrics():
        if m.name == name:
            return m
    return None


def _sum_series(reg: MetricsRegistry, name: str) -> Optional[float]:
    """Sum a counter/gauge over ALL its label series (e.g. every
    rejection reason); None when the metric was never registered."""
    m = _metric(reg, name)
    if m is None:
        return None
    total = 0.0
    for _key, val in m._series():
        total += float(val)
    return total


def _hist_totals(reg: MetricsRegistry, name: str
                 ) -> Optional[Tuple[Tuple[float, ...], List[int], int]]:
    """Histogram state merged over label series: ``(le, cumulative
    buckets, count)``; None when absent or empty."""
    m = _metric(reg, name)
    if m is None or m.kind != "histogram":
        return None
    buckets = [0] * len(m.buckets)
    count = 0
    for _key, st in m._series():
        count += int(st["count"])
        for i, b in enumerate(st["buckets"]):
            buckets[i] += int(b)
    if count == 0 and not any(buckets):
        return m.buckets, buckets, 0
    return m.buckets, buckets, count


# ---------------------------------------------------------------------------
# Objectives.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective.

    ``kind`` is ``"counter"`` (``signal(reg)`` returns CUMULATIVE
    ``(good, bad)`` totals — zeros while the feeding subsystem has
    registered nothing, since in-process counters start at zero) or
    ``"gauge"`` (``signal(reg)`` returns the instantaneous bad
    fraction in [0, 1] — each evaluation tick is one good/bad event —
    or None while the gauge is unset, which reads as ``no_data``).
    ``detail`` optionally contributes display-only context to the
    summary (the latency objective's window p99)."""

    name: str
    kind: str
    target: float
    description: str
    signal: Callable[[MetricsRegistry], Optional[object]]
    detail: Optional[Callable[[MetricsRegistry], dict]] = None

    @property
    def error_budget(self) -> float:
        return max(1.0 - float(self.target), _EPS)


#: the serving path's OK-latency histograms: a replica observes
#: kafka_serve_latency_seconds, the front door kafka_route_latency_
#: seconds — one objective set covers both roles (absent metrics read
#: as zero, see below).
_LATENCY_HISTS = (
    "kafka_serve_latency_seconds",
    "kafka_route_latency_seconds",
)


def _merged_latency(reg: MetricsRegistry
                    ) -> Optional[Tuple[Tuple[float, ...],
                                        List[int], int]]:
    """The serving-path latency histograms merged bucket-wise (they
    share the registry's default layout); the non-empty one when
    layouts ever diverge."""
    merged = None
    for name in _LATENCY_HISTS:
        tot = _hist_totals(reg, name)
        if tot is None:
            continue
        if merged is None:
            merged = (tot[0], list(tot[1]), tot[2])
        elif merged[0] == tot[0]:
            merged = (
                merged[0],
                [a + b for a, b in zip(merged[1], tot[1])],
                merged[2] + tot[2],
            )
        elif tot[2] > merged[2]:
            merged = (tot[0], list(tot[1]), tot[2])
    return merged


def _availability_signal(reg: MetricsRegistry):
    # Counters start at zero in-process, so unregistered metrics read
    # as zero totals — the first evaluation's baseline then predates
    # any traffic instead of swallowing events that land between the
    # first evaluation and the serve layer's first registration.
    ok = _merged_latency(reg)
    bad = 0.0
    for name in ("kafka_serve_rejected_total",
                 "kafka_serve_errors_total",
                 "kafka_route_rejected_total"):
        bad += _sum_series(reg, name) or 0.0
    good = 0.0 if ok is None else float(ok[2])
    return good, bad


def _latency_signal(bar_ms: float):
    def signal(reg: MetricsRegistry):
        tot = _merged_latency(reg)
        if tot is None:
            return 0.0, 0.0
        le, buckets, count = tot
        good = count  # bar beyond the last finite bucket: all good
        for bound, cum in zip(le, buckets):
            if bound * 1e3 >= bar_ms:
                good = cum
                break
        return float(good), float(count - good)
    return signal


def _latency_detail(bar_ms: float):
    def detail(reg: MetricsRegistry) -> dict:
        tot = _merged_latency(reg)
        if tot is None or tot[2] == 0:
            return {"bar_ms": bar_ms, "p99_ms": None}
        le, buckets, count = tot
        p99 = quantile_from_buckets(list(le), buckets, count, 0.99)
        return {
            "bar_ms": bar_ms,
            "p99_ms": None if p99 is None else round(p99 * 1e3, 3),
        }
    return detail


def _quality_signal(reg: MetricsRegistry):
    drifting = reg.value("kafka_quality_drift_active")
    if drifting is None:
        return None
    return 1.0 if drifting else 0.0


def _solver_signal(reg: MetricsRegistry):
    pixels = _sum_series(reg, "kafka_engine_pixels_total") or 0.0
    quarantined = _sum_series(
        reg, "kafka_solver_quarantined_pixels_total"
    ) or 0.0
    return max(0.0, pixels - quarantined), quarantined


def _perf_signal(floor: float):
    def signal(reg: MetricsRegistry):
        frac = reg.value("kafka_perf_device_fraction")
        if frac is None:
            return None
        return 1.0 if float(frac) < floor else 0.0
    return signal


def default_objectives(
    availability_target: float = AVAILABILITY_TARGET,
    latency_target: float = LATENCY_TARGET,
    latency_bar_ms: float = LATENCY_BAR_MS,
    clean_target: float = CLEAN_FRACTION_TARGET,
    solver_target: float = SOLVER_TARGET,
    perf_target: float = PERF_TARGET,
    perf_floor: float = PERF_DEVICE_FRACTION_FLOOR,
) -> List[Objective]:
    """The five fleet objectives over the standard metric vocabulary.
    Targets/bars are keyword-overridable (a CPU test fleet's latency
    bar is not a card's serving fleet's), defaults from the config block."""
    return [
        Objective(
            "availability", "counter", availability_target,
            "fraction of decided requests served ok "
            "(vs rejected + error)",
            _availability_signal,
        ),
        Objective(
            "latency", "counter", latency_target,
            f"fraction of OK-served requests under {latency_bar_ms:g} "
            "ms (serve latency histogram)",
            _latency_signal(latency_bar_ms),
            detail=_latency_detail(latency_bar_ms),
        ),
        Objective(
            "quality", "gauge", clean_target,
            "fraction of evaluations with no quality drift sentinel "
            "alarming",
            _quality_signal,
        ),
        Objective(
            "solver", "counter", solver_target,
            "fraction of assimilated pixels not quarantined",
            _solver_signal,
        ),
        Objective(
            "perf", "gauge", perf_target,
            f"fraction of evaluations with device fraction >= "
            f"{perf_floor:g}",
            _perf_signal(perf_floor),
        ),
    ]


# ---------------------------------------------------------------------------
# The alerts.jsonl sink (events.jsonl rotation discipline).
# ---------------------------------------------------------------------------

class _AlertLedger:
    """Append-only JSONL ledger with size-capped keep-N rotation —
    the same discipline as the registry's events.jsonl, so a resident
    daemon's alert history stays bounded on disk.  Thread-safe; in
    memory only (ring) when no directory is configured."""

    MAX_RECORDS = 1024

    def __init__(self, directory: Optional[str],
                 rotate_bytes: int = ALERTS_ROTATE_BYTES,
                 keep: int = ALERTS_KEEP):
        self.directory = directory
        self.path = os.path.join(directory, ALERTS_FILENAME) \
            if directory else None
        self.rotate_bytes = int(rotate_bytes)
        self.keep = int(keep)
        self._lock = threading.Lock()
        self.records: collections.deque = collections.deque(
            maxlen=self.MAX_RECORDS
        )
        self._bytes = 0
        if self.path is not None:
            try:
                self._bytes = os.path.getsize(self.path)
            except OSError:
                self._bytes = 0

    def append(self, rec: dict) -> None:
        with self._lock:
            self.records.append(rec)
            if self.path is None:
                return
            line = json.dumps(rec, default=str) + "\n"
            try:
                with open(self.path, "a") as f:
                    f.write(line)
                self._bytes += len(line)
                if self._bytes >= self.rotate_bytes:
                    self._rotate_locked()
            except OSError:
                # The ledger degrades, the run survives (the in-memory
                # ring still backs /alertz).
                pass

    def _rotate_locked(self) -> None:
        path = self.path
        for i in range(self.keep - 1, 0, -1):
            src = f"{path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{path}.{i + 1}")
        if self.keep > 0:
            os.replace(path, f"{path}.1")
        else:
            os.unlink(path)
        # Leave an empty live segment behind (the registry's events
        # rotation reopens its handle; we open per append): readers
        # looking for alerts.jsonl must always find it after activity.
        open(path, "a").close()
        self._bytes = 0


# ---------------------------------------------------------------------------
# Per-objective evaluator state.
# ---------------------------------------------------------------------------

class _AlertState:
    """One (objective, severity) rule's state machine."""

    def __init__(self):
        self.state = OK
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None

    def update(self, breached: bool, now: float,
               pending_for_s: float) -> Optional[str]:
        """Fold one evaluation in; returns the transition that happened
        (``"pending"`` / ``"firing"`` / ``"resolved"``) or None."""
        if breached:
            if self.state == OK:
                self.state = PENDING
                self.pending_since = now
                return PENDING
            if self.state == PENDING and \
                    now - self.pending_since >= pending_for_s:
                self.state = FIRING
                self.firing_since = now
                return FIRING
            return None
        if self.state == FIRING:
            self.state = OK
            self.pending_since = None
            return "resolved"
        if self.state == PENDING:
            # A breach that clears before confirmation never alerted —
            # back to ok silently (the SRE pending semantics).
            self.state = OK
            self.pending_since = None
        return None


class _ObjectiveState:
    def __init__(self):
        #: (ts, good_total, bad_total) cumulative samples.
        self.samples: collections.deque = collections.deque(
            maxlen=MAX_SAMPLES
        )
        #: first-ever sample — the budget ledger's origin (kept even
        #: after the deque slides).
        self.origin: Optional[Tuple[float, float, float]] = None
        #: gauge-kind objectives accumulate tick counts here.
        self.gauge_good = 0.0
        self.gauge_bad = 0.0
        self.alerts: Dict[str, _AlertState] = {
            SEVERITY_PAGE: _AlertState(),
            SEVERITY_WARN: _AlertState(),
        }
        self.has_data = False

    def window_rate(self, now: float, window_s: float
                    ) -> Tuple[float, float]:
        """(error_rate, total_events) over the trailing window: the
        baseline is the newest sample at or before ``now - window_s``
        (the first sample when the engine is younger than the window)."""
        if not self.samples:
            return 0.0, 0.0
        cutoff = now - window_s
        base = self.samples[0]
        for s in self.samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        newest = self.samples[-1]
        good_d = newest[1] - base[1]
        bad_d = newest[2] - base[2]
        total = good_d + bad_d
        if total <= 0:
            return 0.0, 0.0
        return bad_d / total, total


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

def _slo_metrics(reg: MetricsRegistry) -> dict:
    """Single registration site for the SLO metric vocabulary."""
    return {
        "firing": reg.gauge(
            "kafka_slo_alerts_firing",
            "SLO alerts currently firing, by severity — the admission "
            "layer sheds reason slo_burn off the page series and "
            "/healthz flips 503 while it is nonzero",
        ),
        "fired": reg.counter(
            "kafka_slo_alerts_fired_total",
            "SLO alert episodes that reached firing, by severity",
        ),
        "evals": reg.counter(
            "kafka_slo_evaluations_total",
            "SLO evaluation rounds run by the background evaluator",
        ),
    }


class SLOEngine:
    """Evaluates the objectives against one registry on a tracked
    background thread (or via :meth:`evaluate_once` under test
    control).  Window lengths, burn thresholds and the evaluation
    cadence are constructor knobs; defaults from the config block."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 directory: Optional[str] = None,
                 objectives: Optional[List[Objective]] = None,
                 fast_window_s: float = FAST_WINDOW_S,
                 slow_window_s: float = SLOW_WINDOW_S,
                 fast_burn: float = FAST_BURN_THRESHOLD,
                 slow_burn: float = SLOW_BURN_THRESHOLD,
                 interval_s: float = EVAL_INTERVAL_S,
                 pending_for_s: float = PENDING_FOR_S,
                 budget_window_s: float = BUDGET_WINDOW_S,
                 alerts_rotate_bytes: int = ALERTS_ROTATE_BYTES,
                 alerts_keep: int = ALERTS_KEEP):
        self._registry = registry
        if directory is None:
            reg = registry if registry is not None else get_registry()
            directory = reg.directory
        self.objectives = list(
            objectives if objectives is not None else default_objectives()
        )
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.interval_s = float(interval_s)
        self.pending_for_s = float(pending_for_s)
        self.budget_window_s = float(budget_window_s)
        self.ledger = _AlertLedger(
            directory, rotate_bytes=alerts_rotate_bytes,
            keep=alerts_keep,
        )
        self._lock = threading.Lock()
        self._state: Dict[str, _ObjectiveState] = {
            o.name: _ObjectiveState() for o in self.objectives
        }
        self._last_eval: Dict[str, dict] = {}
        self.fired_total = 0
        self.resolved_total = 0
        self._stop = threading.Event()
        self._started = False
        # PR 3 thread-tracing convention: capture the constructing
        # thread's context, re-install it on the worker.
        self._ctx = tracing.current_context()
        self._thread = threading.Thread(
            target=self._run, name="slo-evaluator", daemon=True,
        )

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "SLOEngine":
        if self._started:
            return self
        self._started = True
        self._thread.start()
        self._reg().emit(
            "slo_engine_started",
            objectives=[o.name for o in self.objectives],
            fast_window_s=self.fast_window_s,
            slow_window_s=self.slow_window_s,
            interval_s=self.interval_s,
        )
        return self

    @property
    def started(self) -> bool:
        return self._started

    def _run(self) -> None:
        tracing.set_context(self._ctx)
        tracing.set_lane("telemetry")
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception as exc:  # noqa: BLE001 — the evaluator must outlive a bad signal; the error is counted and the next round retries
                self._reg().emit(
                    "slo_eval_failed", error=repr(exc)[:200],
                )

    def stop(self) -> None:
        """Stop the evaluator thread after one final evaluation (so the
        ledger carries the end-of-run state)."""
        if not self._started:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            self.evaluate_once()
        except Exception as exc:  # noqa: BLE001 — best-effort final round; shutdown must not raise
            self._reg().emit("slo_eval_failed", error=repr(exc)[:200])

    # -- evaluation -----------------------------------------------------

    def evaluate_once(self, now: Optional[float] = None) -> dict:
        """One evaluation round (the background thread's body and the
        tests' deterministic hook — inject ``now`` to control window
        arithmetic without sleeping).  Returns :meth:`summary`."""
        now = time.time() if now is None else float(now)
        reg = self._reg()
        m = _slo_metrics(reg)
        transitions: List[dict] = []
        with self._lock:
            for obj in self.objectives:
                st = self._state[obj.name]
                totals = self._sample(obj, st, reg)
                if totals is not None:
                    st.has_data = True
                    sample = (now, float(totals[0]), float(totals[1]))
                    if st.origin is None:
                        st.origin = sample
                    st.samples.append(sample)
                self._evaluate_objective(obj, st, now, transitions)
            firing_by_sev = {sev: 0 for sev in SEVERITIES}
            for name, st in self._state.items():
                for sev, al in st.alerts.items():
                    if al.state == FIRING:
                        firing_by_sev[sev] += 1
        for sev in SEVERITIES:
            m["firing"].set(firing_by_sev[sev], severity=sev)
        m["evals"].inc()
        for t in transitions:
            self.ledger.append(t)
            if t["kind"] == FIRING:
                m["fired"].inc(severity=t["severity"])
                reg.emit(
                    "slo_alert", objective=t["objective"],
                    severity=t["severity"], burn_fast=t["burn_fast"],
                    burn_slow=t["burn_slow"],
                )
            elif t["kind"] == "resolved":
                reg.emit(
                    "slo_resolved", objective=t["objective"],
                    severity=t["severity"],
                    duration_s=t.get("duration_s"),
                )
        return self.summary()

    def _sample(self, obj: Objective, st: _ObjectiveState,
                reg: MetricsRegistry):
        raw = obj.signal(reg)
        if raw is None:
            return None
        if obj.kind == "gauge":
            bad = max(0.0, min(1.0, float(raw)))
            st.gauge_good += 1.0 - bad
            st.gauge_bad += bad
            return st.gauge_good, st.gauge_bad
        return raw

    def _evaluate_objective(self, obj: Objective, st: _ObjectiveState,
                            now: float,
                            transitions: List[dict]) -> None:
        budget = obj.error_budget
        rate_fast, n_fast = st.window_rate(now, self.fast_window_s)
        rate_slow, n_slow = st.window_rate(now, self.slow_window_s)
        burn_fast = rate_fast / budget
        burn_slow = rate_slow / budget
        ledger = self._budget_ledger(obj, st, now, burn_slow)
        ev = {
            "error_rate_fast": round(rate_fast, 6),
            "error_rate_slow": round(rate_slow, 6),
            "burn_fast": round(burn_fast, 3),
            "burn_slow": round(burn_slow, 3),
            "events_fast": n_fast,
            "budget": ledger,
        }
        self._last_eval[obj.name] = ev
        for severity, breached in (
            (SEVERITY_PAGE, burn_fast > self.fast_burn),
            (SEVERITY_WARN, burn_slow > self.slow_burn),
        ):
            al = st.alerts[severity]
            was_firing_since = al.firing_since
            kind = al.update(breached, now, self.pending_for_s)
            if kind is None:
                continue
            rec = {
                "schema": LEDGER_SCHEMA,
                "ts": round(now, 6),
                "kind": kind,
                "objective": obj.name,
                "severity": severity,
                "target": obj.target,
                "burn_fast": ev["burn_fast"],
                "burn_slow": ev["burn_slow"],
                "error_rate_fast": ev["error_rate_fast"],
                "error_rate_slow": ev["error_rate_slow"],
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "budget": ledger,
            }
            if kind == FIRING:
                self.fired_total += 1
            elif kind == "resolved":
                self.resolved_total += 1
                if was_firing_since is not None:
                    rec["duration_s"] = round(
                        now - was_firing_since, 6
                    )
            transitions.append(rec)

    def _budget_ledger(self, obj: Objective, st: _ObjectiveState,
                       now: float, burn_slow: float) -> dict:
        """Budget consumed so far (cumulative error rate over the
        error budget), remaining fraction, and the time-to-exhaustion
        estimate at the current slow burn rate."""
        if st.origin is None or not st.samples:
            return {"consumed": 0.0, "remaining": 1.0, "tte_s": None}
        newest = st.samples[-1]
        good_d = newest[1] - st.origin[1]
        bad_d = newest[2] - st.origin[2]
        total = good_d + bad_d
        rate = bad_d / total if total > 0 else 0.0
        consumed = rate / obj.error_budget
        remaining = max(0.0, 1.0 - consumed)
        tte = None
        if burn_slow > 0 and remaining > 0:
            tte = round(
                self.budget_window_s * remaining / burn_slow, 3
            )
        elif remaining <= 0:
            tte = 0.0
        return {
            "consumed": round(consumed, 6),
            "remaining": round(remaining, 6),
            "tte_s": tte,
        }

    # -- read side ------------------------------------------------------

    def firing(self) -> List[dict]:
        """Currently-firing alerts, page first."""
        out: List[dict] = []
        with self._lock:
            for obj in self.objectives:
                st = self._state[obj.name]
                for sev in SEVERITIES:
                    al = st.alerts[sev]
                    if al.state == FIRING:
                        ev = self._last_eval.get(obj.name) or {}
                        out.append({
                            "objective": obj.name,
                            "severity": sev,
                            "since": al.firing_since,
                            "burn_fast": ev.get("burn_fast"),
                            "burn_slow": ev.get("burn_slow"),
                        })
        return out

    def summary(self) -> dict:
        """The /alertz, live-snapshot and BENCH surface."""
        objectives: Dict[str, dict] = {}
        with self._lock:
            for obj in self.objectives:
                st = self._state[obj.name]
                ev = self._last_eval.get(obj.name) or {}
                states = {
                    sev: st.alerts[sev].state for sev in SEVERITIES
                }
                if FIRING in states.values():
                    status = FIRING
                elif PENDING in states.values():
                    status = PENDING
                elif st.has_data:
                    status = OK
                else:
                    status = "no_data"
                entry = {
                    "target": obj.target,
                    "kind": obj.kind,
                    "status": status,
                    "alerts": states,
                    "burn_fast": ev.get("burn_fast"),
                    "burn_slow": ev.get("burn_slow"),
                    "error_rate_fast": ev.get("error_rate_fast"),
                    "budget": ev.get("budget")
                    or {"consumed": 0.0, "remaining": 1.0,
                        "tte_s": None},
                }
                if obj.detail is not None:
                    try:
                        entry["detail"] = obj.detail(self._reg())
                    except Exception:  # noqa: BLE001 — display-only context must not take /alertz down
                        entry["detail"] = None
                objectives[obj.name] = entry
        return {
            "enabled": True,
            "started": self._started,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "fast_burn": self.fast_burn,
            "slow_burn": self.slow_burn,
            "interval_s": self.interval_s,
            "objectives": objectives,
            "firing": self.firing(),
            "alerts_fired": self.fired_total,
            "alerts_resolved": self.resolved_total,
            # Health context from the SHARED sampling path (the gauges
            # probe_health maintains) — the evaluator never probes.
            "health": _health_context(self._reg()),
            "ledger_path": self.ledger.path,
        }


def _health_context(reg: MetricsRegistry) -> dict:
    from .health import latest_verdict

    v = latest_verdict(reg)
    return {"probed": v["probed"], "unhealthy": v["unhealthy"]}


# ---------------------------------------------------------------------------
# Per-registry engine binding (the quality.get_ledger idiom) + the
# process-level start/stop hooks the CLI drivers call next to
# live.start_publisher.
# ---------------------------------------------------------------------------

_engines: "weakref.WeakKeyDictionary[MetricsRegistry, SLOEngine]" = \
    weakref.WeakKeyDictionary()
_engines_lock = threading.Lock()

#: the summary shape for a process with no engine (live snapshots and
#: /alertz stay schema-stable either way).
DISABLED_SUMMARY = {
    "enabled": False,
    "started": False,
    "objectives": {},
    "firing": [],
    "alerts_fired": 0,
    "alerts_resolved": 0,
}


def get_engine(registry: Optional[MetricsRegistry] = None,
               **kwargs) -> SLOEngine:
    """The engine bound to ``registry`` (default: the process
    registry), created NOT-started on first use with the registry's
    telemetry directory as the ledger home.  ``kwargs`` configure a
    newly-created engine and are ignored for an existing one."""
    reg = registry if registry is not None else get_registry()
    with _engines_lock:
        eng = _engines.get(reg)
        if eng is None:
            eng = _engines[reg] = SLOEngine(registry=reg, **kwargs)
        return eng


def bound_engine(registry: Optional[MetricsRegistry] = None
                 ) -> Optional[SLOEngine]:
    """The engine bound to ``registry`` if one exists — never creates."""
    reg = registry if registry is not None else get_registry()
    with _engines_lock:
        return _engines.get(reg)


def start_engine(registry: Optional[MetricsRegistry] = None,
                 **kwargs) -> SLOEngine:
    """Create-if-needed and start the tracked background evaluator for
    ``registry`` (the CLI drivers' hook, next to live.start_publisher).
    Idempotent."""
    return get_engine(registry, **kwargs).start()


def stop_engine(registry: Optional[MetricsRegistry] = None) -> None:
    """Stop the bound evaluator (final evaluation included); no-op
    when none exists."""
    eng = bound_engine(registry)
    if eng is not None:
        eng.stop()


def summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """The bound engine's summary, or the stable disabled shape."""
    eng = bound_engine(registry)
    if eng is None:
        return dict(DISABLED_SUMMARY)
    return eng.summary()


def firing(registry: Optional[MetricsRegistry] = None) -> List[dict]:
    eng = bound_engine(registry)
    return [] if eng is None else eng.firing()


def firing_pages(registry: Optional[MetricsRegistry] = None
                 ) -> List[str]:
    """Objective names with a PAGE-severity alert firing — the
    /healthz 503 trigger and the admission layer's shed signal."""
    return sorted(
        a["objective"] for a in firing(registry)
        if a["severity"] == SEVERITY_PAGE
    )


# ---------------------------------------------------------------------------
# Ledger loading (tools/slo_report.py, tests).
# ---------------------------------------------------------------------------

def load_alerts(path: str) -> Tuple[List[dict], int]:
    """Parse one ``alerts.jsonl`` (+ its rotated ``.N`` segments,
    oldest first); returns ``(records, skipped)``.  Torn or non-record
    lines are skipped, not fatal."""
    paths: List[str] = []
    directory, base = os.path.split(path)
    try:
        segments = sorted(
            (int(n[len(base) + 1:]), os.path.join(directory or ".", n))
            for n in os.listdir(directory or ".")
            if n.startswith(base + ".")
            and n[len(base) + 1:].isdigit()
        )
    except OSError:
        segments = []
    paths.extend(p for _, p in sorted(segments, reverse=True))
    paths.append(path)
    records: List[dict] = []
    skipped = 0
    for p in paths:
        try:
            f = open(p, encoding="utf-8", errors="replace")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    skipped += 1
                    continue
                if not isinstance(rec, dict) or "kind" not in rec \
                        or "objective" not in rec:
                    skipped += 1
                    continue
                records.append(rec)
    return records, skipped


def episodes_from(records: List[dict]) -> List[dict]:
    """Alert episodes reconstructed from ledger records alone: each
    firing record opens an episode for its (objective, severity), the
    matching resolved record closes it (open episodes have
    ``resolved_ts: None``).  Pending records annotate the episode's
    lead time."""
    open_eps: Dict[Tuple[str, str], dict] = {}
    pending_ts: Dict[Tuple[str, str], float] = {}
    episodes: List[dict] = []
    for rec in records:
        key = (rec["objective"], rec.get("severity", "?"))
        kind = rec.get("kind")
        ts = float(rec.get("ts") or 0.0)
        if kind == PENDING:
            pending_ts[key] = ts
        elif kind == FIRING:
            ep = {
                "objective": key[0],
                "severity": key[1],
                "pending_ts": pending_ts.pop(key, None),
                "firing_ts": ts,
                "resolved_ts": None,
                "duration_s": None,
                "burn_fast": rec.get("burn_fast"),
                "burn_slow": rec.get("burn_slow"),
                "budget": rec.get("budget"),
            }
            open_eps[key] = ep
            episodes.append(ep)
        elif kind == "resolved":
            ep = open_eps.pop(key, None)
            if ep is None:
                # A resolve whose firing rotated away still reports.
                ep = {
                    "objective": key[0], "severity": key[1],
                    "pending_ts": None, "firing_ts": None,
                    "burn_fast": rec.get("burn_fast"),
                    "burn_slow": rec.get("burn_slow"),
                }
                episodes.append(ep)
            ep["resolved_ts"] = ts
            ep["duration_s"] = rec.get("duration_s") if rec.get(
                "duration_s"
            ) is not None else (
                round(ts - ep["firing_ts"], 6)
                if ep.get("firing_ts") else None
            )
            ep["budget"] = rec.get("budget", ep.get("budget"))
    return episodes
