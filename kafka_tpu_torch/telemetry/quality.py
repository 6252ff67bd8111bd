"""Assimilation-quality observability: the innovation-consistency ledger
(copy of ``kafka_tpu/telemetry/quality.py``, which imports no JAX).

The per-band innovation chi-square the solve computes rides the engine's
single packed device->host read per window (normalised per valid
observation, so E[ratio] ~= 1 for a consistent filter).  This module
turns it into a monitored, persisted product surface:

- :func:`verdict_for` — the normalised chi-square ratio against
  configurable bands yields ``CONSISTENT`` / ``OVERCONFIDENT`` /
  ``UNDERCONFIDENT``;
- :class:`DriftSentinel` — rolling EWMA + two-sided CUSUM over one
  per-band ratio series; an excursion flags the date as DRIFTING, emits
  a ``quality_drift`` event and raises ``kafka_quality_drift_active``;
- :class:`QualityLedger` — the durable per-window record: every
  assimilated window appends one JSON line to ``quality.jsonl`` in the
  telemetry directory, with zero added device reads;
- :func:`observation_bias` — the ``obs.bias`` chaos site: scripted
  additive bias on armed observation dates (``KAFKA_TPU_FAULTS``
  grammar, call numbers = 1-based fetch-order date numbers), ``None``
  when disarmed.

The record schema, metric names and thresholds are the JAX package's,
so a ledger written by either package reads in the other.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

from .registry import MetricsRegistry, get_registry

# ---------------------------------------------------------------------------
# Quality thresholds — the one home for consistency / drift threshold
# literals.  Everything below is overridable per-ledger/per-sentinel;
# these are the JAX package's defaults.
# ---------------------------------------------------------------------------

#: consistency band on the ABSOLUTE ratio: worst band ratio above HI ->
#: OVERCONFIDENT (residuals bigger than the assumed R admits), best
#: band ratio below LO -> UNDERCONFIDENT (residuals implausibly small —
#: R inflated by an order of magnitude or more).  The band is
#: deliberately loose: the engine's chi^2 is computed on POSTERIOR
#: innovations, which sit well below 1 for strongly-informed priors
#: (the TIP problem idles near 0.05), so absolute verdicts only flag
#: gross inconsistency; the self-baselining drift sentinels below catch
#: the subtle sustained departures the band cannot.
CONSISTENT_LO = 0.01
CONSISTENT_HI = 2.5
#: sentinel baseline window: each (prefix, band) series' reference is
#: the geometric mean of its last N NON-ALARMING samples.  The first N
#: samples are pure calibration (no alarms can fire), and the window
#: keeps sliding afterwards so a smooth spin-up decay — posterior chi^2
#: starts high while the filter digests its first observations — is
#: absorbed as the series' own moving level instead of read as drift.
#: Alarming samples never enter the window: a fault cannot poison its
#: own reference.
BASELINE_WINDOW = 4
#: EWMA smoothing factor over the log-deviation-from-baseline series.
EWMA_ALPHA = 0.2
#: |EWMA of log-deviation| beyond this flags sustained departure
#: (log units: 1.5 ~= a sustained 4.5x ratio shift; decays back after
#: the cause clears).
EWMA_DRIFT_BAND = 1.5
#: two-sided CUSUM slack on the log-deviation (per-date departures
#: below ~e^0.25 ~= 1.3x are noise).  A date back within the slack
#: flushes BOTH accumulators — suspicion does not linger once the
#: series is back on baseline.
CUSUM_K = 0.25
#: CUSUM decision thresholds (log units), asymmetric by direction: an
#: UPWARD excursion (residuals exceeding what R admits — the filter is
#: shipping overtight uncertainties RIGHT NOW) alarms fast, while the
#: DOWNWARD direction (residuals shrinking — R conservatively inflated,
#: and the shape of benign spin-up decay) gets more accumulation room
#: before alarming.  No reset-after-alarm: a sustained fault keeps the
#: statistic above threshold (every armed date flags) even as the
#: filter partially absorbs the bias, and the flush-on-return rule
#: above ends the episode the first clean date.
CUSUM_H_HIGH = 2.0
CUSUM_H_LOW = 3.5
#: additive observation bias injected by the ``obs.bias`` chaos site
#: (reflectance units).  Deliberately LARGE against the synthetic
#: sigmas: the filter absorbs much of a small bias into the posterior
#: (the chi^2 rides POSTERIOR innovations), so the chaos site injects a
#: bias big enough that the un-absorbed residual still departs by an
#: order of magnitude.
OBS_BIAS_VALUE = 0.25
#: tolerance on the smoother's per-parameter sigma-shrink ratio
#: (``mean(sigma_smoothed / sigma_filter)``).  Smoothing can only add
#: information, so the ratio is <= 1 by construction (the RTS pass
#: clamps float32 roundoff); a ratio above 1 + tol means the backward
#: pass is reporting LESS certainty than the filter it conditions on —
#: a broken reanalysis, scored OVERCONFIDENT.
SMOOTH_SHRINK_TOL = 1e-3
# -- end of the sanctioned threshold block ----------------------------------

#: verdict vocabulary (severity order for :func:`worst_verdict`).
CONSISTENT = "CONSISTENT"
UNDERCONFIDENT = "UNDERCONFIDENT"
OVERCONFIDENT = "OVERCONFIDENT"
NO_OBS = "NO_OBS"
VERDICTS = (CONSISTENT, NO_OBS, UNDERCONFIDENT, OVERCONFIDENT)

#: severity: a window that is OVERCONFIDENT outranks everything (it is
#: shipping overtight uncertainties); UNDERCONFIDENT outranks a missing
#: window; NO_OBS outranks CONSISTENT only in the sense of "not known
#: good".
_SEVERITY = {CONSISTENT: 0, NO_OBS: 1, UNDERCONFIDENT: 2, OVERCONFIDENT: 3}

LEDGER_FILENAME = "quality.jsonl"
LEDGER_SCHEMA = 1

#: the obs.bias chaos fault site (resilience.faults registry).
FAULT_SITE = "obs.bias"


def _finite_ratios(chi2_per_band: Sequence[float]) -> List[Tuple[int, float]]:
    """(band, ratio) pairs carrying signal: finite and strictly positive
    (a fully-masked band reports 0 — no observations, no verdict)."""
    out = []
    for b, v in enumerate(chi2_per_band):
        v = float(v)
        if math.isfinite(v) and v > 0.0:
            out.append((b, v))
    return out


def verdict_for(chi2_per_band: Sequence[float],
                lo: float = CONSISTENT_LO,
                hi: float = CONSISTENT_HI) -> str:
    """The filter-consistency verdict for one window's per-band
    normalised chi^2 ratios (worst band wins; bands without
    observations carry no signal)."""
    ratios = _finite_ratios(chi2_per_band)
    if not ratios:
        return NO_OBS
    values = [v for _, v in ratios]
    if max(values) > hi:
        return OVERCONFIDENT
    if min(values) < lo:
        return UNDERCONFIDENT
    return CONSISTENT


def smoothed_verdict_for(sigma_shrink: Sequence[float],
                         tol: float = SMOOTH_SHRINK_TOL) -> str:
    """The reanalysis verdict for one smoothed window's per-parameter
    sigma-shrink ratios: any finite ratio above ``1 + tol`` means the
    smoothed sigma exceeds the filter's (impossible for a correct RTS
    pass) -> OVERCONFIDENT; no finite signal -> NO_OBS."""
    ratios = _finite_ratios(sigma_shrink)
    if not ratios:
        return NO_OBS
    if max(v for _, v in ratios) > 1.0 + tol:
        return OVERCONFIDENT
    return CONSISTENT


def worst_verdict(verdicts) -> Optional[str]:
    """The most severe verdict of a collection (None when empty)."""
    worst = None
    for v in verdicts:
        if v in _SEVERITY and (worst is None
                               or _SEVERITY[v] > _SEVERITY[worst]):
            worst = v
    return worst


class DriftSentinel:
    """Self-baselining EWMA + two-sided CUSUM over one chi^2-ratio
    series, in log space.

    A filter's posterior chi^2 ratio has a problem-dependent operating
    level (a tight prior idles near 0.05, a diffuse one near 1) AND a
    spin-up transient (the first dates run high while the filter
    digests its first observations), so any fixed absolute target — or
    a baseline frozen over a transient head — false-alarms on healthy
    runs.  The sentinel instead tracks each series against the
    geometric mean of its last ``window`` NON-ALARMING samples (the
    first ``window`` samples are pure calibration) and watches the
    log-deviation ``d = log(ratio) - log(baseline)``:

    - CUSUM (Page's test): ``S+ <- max(0, S+ + d - k)``,
      ``S- <- max(0, S- - d - k)``.  ``S+ > h_high`` or ``S- > h_low``
      alarms (asymmetric: upward — overconfident — is the dangerous
      direction).  No reset after an alarm: a sustained fault stays
      above threshold on every affected date even as the filter
      partially absorbs it.  A date back within the slack
      (``|d| <= k``) flushes both sides — the episode ends the first
      clean date.
    - EWMA over ``d``: ``|ewma| > ewma_band`` flags sustained moderate
      departure and decays naturally after the cause clears.

    Alarming samples never enter the baseline window, so a fault
    cannot poison its own reference; non-alarming ones slide it, so
    smooth level changes (spin-up decay) are absorbed.
    """

    def __init__(self, alpha: float = EWMA_ALPHA,
                 ewma_band: float = EWMA_DRIFT_BAND,
                 k: float = CUSUM_K,
                 h_high: float = CUSUM_H_HIGH,
                 h_low: float = CUSUM_H_LOW,
                 window: int = BASELINE_WINDOW):
        self.alpha = float(alpha)
        self.ewma_band = float(ewma_band)
        self.k = float(k)
        self.h_high = float(h_high)
        self.h_low = float(h_low)
        self.window = max(1, int(window))
        self.n = 0
        self._logs: collections.deque = collections.deque(
            maxlen=self.window
        )
        self.ewma = 0.0
        self.cusum_pos = 0.0
        self.cusum_neg = 0.0

    @property
    def baseline_log(self) -> Optional[float]:
        if not self._logs:
            return None
        return sum(self._logs) / len(self._logs)

    def update(self, ratio: float) -> dict:
        """Fold one per-date ratio in; returns the sentinel state
        (``drifting`` True when any statistic alarmed on this date)."""
        z = math.log(max(float(ratio), 1e-300))  # log-domain guard, not a threshold
        self.n += 1
        if self.n <= self.window:
            # Calibration: the first ``window`` samples seed the
            # baseline unconditionally, no alarms.
            self._logs.append(z)
            return {
                "phase": "calibrating",
                "baseline": round(math.exp(self.baseline_log), 6),
                "ewma": None, "cusum_pos": 0.0, "cusum_neg": 0.0,
                "drifting": False, "trigger": None,
            }
        baseline = self.baseline_log
        d = z - baseline
        self.ewma = self.alpha * d + (1.0 - self.alpha) * self.ewma
        if abs(d) <= self.k:
            # Back on baseline: there is no drift NOW, whatever was
            # accumulated — the episode ends on the first clean date.
            self.cusum_pos = 0.0
            self.cusum_neg = 0.0
        else:
            self.cusum_pos = max(0.0, self.cusum_pos + d - self.k)
            self.cusum_neg = max(0.0, self.cusum_neg - d - self.k)
        trigger = None
        if self.cusum_pos > self.h_high:
            trigger = "cusum_high"
        elif self.cusum_neg > self.h_low:
            trigger = "cusum_low"
        elif abs(self.ewma) > self.ewma_band:
            trigger = "ewma"
        state = {
            "phase": "armed",
            "baseline": round(math.exp(baseline), 6),
            "ewma": round(self.ewma, 6),
            "cusum_pos": round(self.cusum_pos, 6),
            "cusum_neg": round(self.cusum_neg, 6),
            "drifting": trigger is not None,
            "trigger": trigger,
        }
        if trigger is None:
            # Healthy sample: it slides the baseline window (alarming
            # ones are excluded — a fault must not poison its own
            # reference).
            self._logs.append(z)
        return state


class QualityLedger:
    """Per-process quality ledger + drift sentinels.

    One record per assimilated (or degraded) window, appended to
    ``quality.jsonl`` under ``directory`` (in-memory only when no
    telemetry directory is configured — same contract as the metrics
    registry).  Sentinel streams are keyed by ``(prefix, band)`` so a
    chunked run or a multi-tile serving daemon keeps one independent
    series per tile/chunk per band.  Thread-safe; the file is opened
    per append so long-lived daemons hold no extra handles.
    """

    MAX_RECORDS = 4096

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 directory: Optional[str] = None,
                 lo: float = CONSISTENT_LO, hi: float = CONSISTENT_HI,
                 alpha: float = EWMA_ALPHA,
                 ewma_band: float = EWMA_DRIFT_BAND,
                 k: float = CUSUM_K,
                 h_high: float = CUSUM_H_HIGH,
                 h_low: float = CUSUM_H_LOW,
                 window: int = BASELINE_WINDOW):
        self._registry = registry
        self.directory = directory
        self.path = os.path.join(directory, LEDGER_FILENAME) \
            if directory else None
        self.lo, self.hi = float(lo), float(hi)
        self._sentinel_kw = dict(alpha=alpha, ewma_band=ewma_band,
                                 k=k, h_high=h_high, h_low=h_low,
                                 window=window)
        self._lock = threading.Lock()
        self.records: collections.deque = collections.deque(
            maxlen=self.MAX_RECORDS
        )
        self._sentinels: Dict[Tuple[Optional[str], int], DriftSentinel] = {}
        self._drifting: set = set()
        self._verdict_counts: Dict[str, int] = {}
        self._last_verdict: Optional[str] = None

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    # -- recording ------------------------------------------------------

    def record_window(self, date, chi2_per_band: Sequence[float],
                      n_valid: int,
                      solver_health: Optional[dict] = None,
                      prefix: Optional[str] = None,
                      fused: Optional[int] = None,
                      smoothed: bool = False) -> dict:
        """Land one assimilated window in the ledger.  ``chi2_per_band``
        is the engine's normalised per-band innovation chi^2 (already on
        the host via the packed diagnostic read — this call adds zero
        device transfers).  ``smoothed`` marks reanalysis-pass records
        (``quality_report`` scores the passes separately).  Returns the
        appended record."""
        ratios = [round(float(v), 6) for v in chi2_per_band]
        verdict = verdict_for(ratios, self.lo, self.hi)
        with self._lock:
            drift_bands: List[int] = []
            states: List[Optional[dict]] = [None] * len(ratios)
            for b, x in _finite_ratios(ratios):
                key = (prefix, b)
                sent = self._sentinels.get(key)
                if sent is None:
                    sent = self._sentinels[key] = DriftSentinel(
                        **self._sentinel_kw
                    )
                st = sent.update(x)
                states[b] = st
                if st["drifting"]:
                    drift_bands.append(b)
                    self._drifting.add(key)
                else:
                    self._drifting.discard(key)
            rec = self._append_locked({
                "schema": LEDGER_SCHEMA,
                "ts": round(time.time(), 6),
                "date": str(date),
                "prefix": prefix,
                "degraded": False,
                "chi2_per_band": ratios,
                "n_valid": int(n_valid),
                "verdict": verdict,
                "solver_health": solver_health,
                "fused": fused,
                "smoothed": bool(smoothed),
                "drift": {
                    "active": bool(drift_bands),
                    "bands": drift_bands,
                    "state": states,
                },
            })
            n_drifting = len(self._drifting)
        self._publish(rec, n_drifting)
        return rec

    def record_smoothed(self, date, sigma_shrink: Sequence[float],
                        n_valid: int,
                        prefix: Optional[str] = None) -> dict:
        """Land one REANALYSIS window: the RTS smoother's per-parameter
        sigma-shrink ratios (``mean(sigma_smoothed / sigma_filter)``,
        <= 1 for a correct pass) take the place of innovation chi^2 —
        the backward pass never touches observations, so it has no
        innovations to score.  Smoothed records never feed the drift
        sentinels (those watch the FORWARD filter's consistency)."""
        shrink = [round(float(v), 6) for v in sigma_shrink]
        with self._lock:
            rec = self._append_locked({
                "schema": LEDGER_SCHEMA,
                "ts": round(time.time(), 6),
                "date": str(date),
                "prefix": prefix,
                "degraded": False,
                "chi2_per_band": [],
                "sigma_shrink": shrink,
                "n_valid": int(n_valid),
                "verdict": smoothed_verdict_for(shrink),
                "solver_health": None,
                "fused": None,
                "smoothed": True,
                "drift": {"active": False, "bands": [], "state": []},
            })
            n_drifting = len(self._drifting)
        self._publish(rec, n_drifting)
        return rec

    def record_missing(self, date, reason: str = "degraded",
                       prefix: Optional[str] = None) -> dict:
        """Land one DEGRADED/MISSING window (a date whose read exhausted
        its retries and was assimilated as predict-only): the quality
        record keeps the hole visible instead of silently thinning the
        series the sentinels watch."""
        with self._lock:
            rec = self._append_locked({
                "schema": LEDGER_SCHEMA,
                "ts": round(time.time(), 6),
                "date": str(date),
                "prefix": prefix,
                "degraded": True,
                "reason": reason,
                "chi2_per_band": [],
                "n_valid": 0,
                "verdict": NO_OBS,
                "solver_health": None,
                "fused": None,
                "drift": {"active": False, "bands": [], "state": []},
            })
            n_drifting = len(self._drifting)
        self._publish(rec, n_drifting)
        return rec

    def _append_locked(self, rec: dict) -> dict:
        self.records.append(rec)
        self._last_verdict = rec["verdict"]
        self._verdict_counts[rec["verdict"]] = \
            self._verdict_counts.get(rec["verdict"], 0) + 1
        return rec

    def _publish(self, rec: dict, n_drifting: int) -> None:
        """Metrics + events + the JSONL append for one record (outside
        the ledger lock; the registry has its own)."""
        reg = self._reg()
        reg.counter(
            "kafka_quality_windows_total",
            "quality-ledger window records by filter-consistency "
            "verdict (normalised innovation chi^2 against the "
            "CONSISTENT_LO..HI band)",
        ).inc(verdict=rec["verdict"])
        reg.gauge(
            "kafka_quality_drift_active",
            "per-(prefix, band) chi^2-ratio series currently in a "
            "drift-sentinel alarm — nonzero means the filter's "
            "innovation statistics departed from consistency "
            "(admission can shed on it: reason quality_degraded)",
        ).set(n_drifting)
        drift = rec["drift"]
        if drift["active"]:
            c = reg.counter(
                "kafka_quality_drift_events_total",
                "drift-sentinel alarms (EWMA departure or CUSUM "
                "excursion) over per-band chi^2-ratio series",
            )
            for b in drift["bands"]:
                st = drift["state"][b] or {}
                c.inc(band=b)
                reg.emit(
                    "quality_drift", date=rec["date"],
                    prefix=rec["prefix"], band=b,
                    ratio=rec["chi2_per_band"][b],
                    trigger=st.get("trigger"),
                    ewma=st.get("ewma"),
                    cusum_pos=st.get("cusum_pos"),
                    cusum_neg=st.get("cusum_neg"),
                )
        if self.path is not None:
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
            except (OSError, TypeError) as exc:
                reg.counter(
                    "kafka_quality_ledger_errors_total",
                    "quality.jsonl appends that failed (disk full, "
                    "unserialisable record) — the ledger degrades, "
                    "the run survives",
                ).inc()
                reg.emit("quality_ledger_write_failed",
                         error=repr(exc)[:200])

    # -- read side ------------------------------------------------------

    def summary(self) -> dict:
        """Compact process-quality summary (the /statusz, live-snapshot
        and serve-response surface)."""
        with self._lock:
            drifting = sorted(
                f"{key[0] or '-'}:band{key[1]}" for key in self._drifting
            )
            return {
                "last_verdict": self._last_verdict,
                "windows": dict(self._verdict_counts),
                "drift_active": len(self._drifting),
                "drifting": drifting[:16],
                "records": len(self.records),
                "ledger_path": self.path,
            }


# ---------------------------------------------------------------------------
# Per-registry ledger binding: instrumented code calls ``get_ledger()``
# at record time (the registry.get_registry idiom), so test isolation
# (``telemetry.use``) and ``configure(--telemetry-dir)`` both work with
# no extra plumbing.
# ---------------------------------------------------------------------------

_ledgers: "weakref.WeakKeyDictionary[MetricsRegistry, QualityLedger]" = \
    weakref.WeakKeyDictionary()
_ledgers_lock = threading.Lock()


def get_ledger(registry: Optional[MetricsRegistry] = None) -> QualityLedger:
    """The quality ledger bound to ``registry`` (default: the process
    registry), created on first use with the registry's telemetry
    directory as the ledger home."""
    reg = registry if registry is not None else get_registry()
    with _ledgers_lock:
        led = _ledgers.get(reg)
        if led is None:
            led = _ledgers[reg] = QualityLedger(
                registry=reg, directory=reg.directory
            )
        return led


def summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """The bound ledger's compact summary (see
    :meth:`QualityLedger.summary`)."""
    return get_ledger(registry).summary()


# ---------------------------------------------------------------------------
# Ledger loading.
# ---------------------------------------------------------------------------

def load_ledger(path: str) -> Tuple[List[dict], int]:
    """Parse one ``quality.jsonl``; returns ``(records, skipped)``.
    Unparseable or non-record lines are SKIPPED, not fatal — a torn
    tail (the process died mid-append) must not take the scorecard
    down with it."""
    records: List[dict] = []
    skipped = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(rec, dict) or "verdict" not in rec:
                skipped += 1
                continue
            records.append(rec)
    return records, skipped


# ---------------------------------------------------------------------------
# The obs.bias chaos site.
# ---------------------------------------------------------------------------

def observation_bias(date_no: int) -> Optional[float]:
    """Host-side: the additive observation bias for fetch-order date
    number ``date_no`` (1-based) when an armed ``obs.bias`` fault spec
    matches it, else ``None`` — the disarmed path adds NOTHING to the
    fetched observation or the compiled program (the bias rides the
    traced ``y`` data, so the jitted solve is byte-identical either
    way).  The calls grammar addresses date numbers, mirroring
    ``solver.pixel``'s pixel ranges."""
    # Lazy import: resilience.faults imports the telemetry package, so
    # a top-level import here would be a cycle.
    from ..resilience import faults

    if not faults.active():
        return None
    specs = [s for s in faults.specs_for(FAULT_SITE)
             if s.matches(date_no)]
    if not specs:
        return None
    faults.record_injection(
        FAULT_SITE, date_no=date_no, bias=OBS_BIAS_VALUE,
    )
    return OBS_BIAS_VALUE
