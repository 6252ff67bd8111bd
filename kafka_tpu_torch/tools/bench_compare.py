"""Compare two BENCH JSON artifacts and gate on device-time regressions
(port of ``tools/bench_compare.py``, which uses the standard library
only; the rules, thresholds, row patterns, report lines and exit codes
are the JAX tool's, so it reads the port's bench artifact,
``python -m kafka_tpu_torch.bench``, and the JAX package's alike).

- compares every gated timing row (``device_*_ms`` solve rows and the
  ``serve_p50_ms``/``serve_p99_ms`` serving-latency rows) shared by the
  two artifacts and **exits non-zero when any regresses by more than
  the threshold** (default 10%, new > old * 1.10) — the gate for perf
  PRs — or when a row the old artifact carried **disappears** from the
  new one (a dropped measurement is a silent path breakage, not a skip;
  rows appearing in the new artifact stay informational);
- refuses to issue a REGRESSION verdict off artifacts flagged
  ``unhealthy`` (the health probes saw environment weather, not code):
  off-band artifacts downgrade the verdict to UNJUDGEABLE (exit 0 with
  a loud warning) rather than failing a PR on noise;
- diffs the embedded ``"telemetry"`` registry snapshots (compact
  counter/gauge view) and reports the largest relative changes —
  convergence iterations, device reads, build-cache hits — so a timing
  shift arrives with its likely cause attached;
- diffs the embedded ``"quality"`` snapshots (assimilation-quality
  verdict counts + drift-sentinel state) informationally, with a LOUD
  warning when a previously-CONSISTENT benchmark flips verdict or its
  drift sentinels go 0 -> alarming — mirroring the ``solver_health``
  quarantine warning;
- diffs the embedded ``"slo"`` snapshots and ``serve_slo_*`` rows
  informationally, with the same class of LOUD warning when a
  previously-clean artifact (zero SLO alerts) shows fired burn-rate
  alerts — a bench that got faster by burning its error budget must
  not read as a clean win;
- diffs the embedded ``"device_profile"`` snapshots (top kernels,
  collective fraction, device-memory peak) informationally, with a
  LOUD warning when the collective-time fraction grows by more than
  10 points absolute — a mesh-balance shift masquerading as a kernel
  result;
- diffs the embedded ``"program_contracts"`` snapshots (per-program
  census fingerprints), warning LOUDLY on drift.

Usage:
    python -m kafka_tpu_torch.tools.bench_compare OLD.json NEW.json \
        [--threshold 0.10]

Exit codes: 0 ok (or unjudgeable), 1 regression, 2 usage/load error.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import sys
from typing import Dict, List, Optional, Tuple

from .bench_history import unwrap_artifact

#: timing rows gated on regression (smaller is better, milliseconds).
#: ``device_*_ms`` are the solve rows; ``serve_p50_ms``/``serve_p99_ms``
#: are the serving-latency rows (``tools/loadgen``) and
#: ``serve_fleet_p50_ms``/``serve_fleet_p99_ms`` their elastic-fleet
#: twins (N replicas behind the consistent-hash router) — the serving
#: story gates like the solve story.  ``serve_cold_ms``/
#: ``serve_*rejected*``/``serve_fleet_rerouted_total`` stay
#: informational (cold start is setup; rejections and re-routes are
#: policy outcomes, not latencies).
GATED_ROW_PATTERNS = ("device_*_ms", "serve_p50_ms", "serve_p99_ms",
                      "serve_fleet_p50_ms", "serve_fleet_p99_ms",
                      "serve_smoothed_p99_ms")
#: gated throughput rows (LARGER is better): the reanalysis sweep's
#: pixel-windows/s and the coalesced-serving launch throughput at the
#: sweep's top concurrency (``loadgen.bench_concurrency_sweep``).
#: Same disappearance rule; the regression direction is inverted.
GATED_THROUGHPUT_PATTERNS = ("device_smoother_px_s",
                             "serve_batched_px_s")
DEVICE_ROW_PATTERN = GATED_ROW_PATTERNS[0]  # back-compat alias


def device_rows(artifact: dict) -> Dict[str, float]:
    """The artifact's gateable timing rows (nulls — e.g. the kernel rows
    of a CPU run — are dropped; spreads are diagnostics, not gates)."""
    return {
        k: float(v) for k, v in artifact.items()
        if any(fnmatch.fnmatch(k, pat) for pat in
               GATED_ROW_PATTERNS + GATED_THROUGHPUT_PATTERNS)
        and not k.endswith("_spread")
        and isinstance(v, (int, float))
    }


def compare_rows(old: dict, new: dict, threshold: float = 0.10,
                 ) -> Tuple[List[str], List[str]]:
    """(regressions, report_lines) over the device timing rows.

    A row present (non-null) in the old artifact but missing or null in
    the new one is a GATING FAILURE, not a skip: a dropped
    ``device_*_ms`` row means the measurement silently stopped happening
    (the kernel path broke, the device gate mis-fired, a rename), which is
    exactly the regression class "compare only shared rows" cannot see.
    Rows that APPEAR in the new artifact remain informational — growing
    coverage must not fail the gate.
    """
    rows_old, rows_new = device_rows(old), device_rows(new)
    regressions: List[str] = []
    lines: List[str] = []
    for key in sorted(set(rows_old) | set(rows_new)):
        a, b = rows_old.get(key), rows_new.get(key)
        larger_better = any(
            fnmatch.fnmatch(key, pat)
            for pat in GATED_THROUGHPUT_PATTERNS
        )
        unit = "px/s" if larger_better else "ms"
        if a is not None and b is None:
            regressions.append(
                f"{key}: {a:.3f} {unit} -> MISSING (row disappeared "
                "from the new artifact — a dropped measurement gates "
                "like a regression)"
            )
            lines.append(f"  {key}: {a:.3f} -> MISSING  REGRESSION")
            continue
        if a is None or b is None:
            lines.append(f"  {key}: only in {'new' if a is None else 'old'} "
                         "artifact — skipped")
            continue
        delta = (b - a) / a if a else 0.0
        # "worse" is the gate's direction: more milliseconds, or fewer
        # pixel-windows per second.
        worse = -delta if larger_better else delta
        verdict = "ok"
        if worse > threshold:
            verdict = "REGRESSION"
            regressions.append(
                f"{key}: {a:.3f} -> {b:.3f} {unit} "
                f"({100 * delta:+.1f}%, worse by more than "
                f"{100 * threshold:.0f}%)"
            )
        elif worse < -threshold:
            verdict = "improved"
        lines.append(
            f"  {key}: {a:.3f} -> {b:.3f} {unit} ({100 * delta:+.1f}%) "
            f"{verdict}"
        )
    if not rows_old or not rows_new:
        lines.append("  (no shared device_*_ms rows to compare)")
    return regressions, lines


def solver_health_deltas(old: dict, new: dict
                         ) -> Tuple[List[str], List[str]]:
    """(warnings, report_lines) over the embedded ``solver_health``
    snapshots (the bench's compact kafka_solver_* counter view).

    Diffed INFORMATIONALLY like the telemetry snapshots — result
    quality is a property of the data and the solver, not a timing gate
    — with ONE exception loud enough to not scroll past: a NEW nonzero
    ``quarantined_pixels`` count on a previously-clean benchmark is a
    numerical-health break (pixels served as forecast fallbacks), so it
    surfaces as an explicit warning.  Still exit 0: the verdict stays
    with the human, but never silence.
    """
    h_old = old.get("solver_health") or {}
    h_new = new.get("solver_health") or {}
    warnings: List[str] = []
    lines: List[str] = []
    for key in sorted(set(h_old) | set(h_new)):
        a, b = h_old.get(key, 0), h_new.get(key, 0)
        if a == b == 0:
            continue
        lines.append(f"  {key}: {a:g} -> {b:g}")
    old_quar = float(h_old.get("quarantined_pixels") or 0)
    new_quar = float(h_new.get("quarantined_pixels") or 0)
    if new_quar > 0 and old_quar == 0:
        warnings.append(
            f"quarantined_pixels went 0 -> {new_quar:g}: the new "
            "artifact served forecast fallbacks on a previously-clean "
            "benchmark (solve-health break, not a perf question) — "
            "inspect the solver_qa bands before trusting its timings"
        )
    return warnings, lines


def quality_deltas(old: dict, new: dict) -> Tuple[List[str], List[str]]:
    """(warnings, report_lines) over the embedded ``quality`` snapshots
    (the bench's compact assimilation-quality view).

    Diffed INFORMATIONALLY like ``solver_health`` — consistency is a
    property of the data and the filter configuration, not a timing
    gate — with the same class of loud exception: a benchmark whose
    overall verdict FLIPS away from CONSISTENT (or whose drift
    sentinels started alarming on a previously-quiet run) is a
    statistical-consistency break, so it surfaces as an explicit
    warning.  Still exit 0: the verdict stays with the human, but
    never silence.
    """
    q_old = old.get("quality") or {}
    q_new = new.get("quality") or {}
    warnings: List[str] = []
    lines: List[str] = []
    w_old = q_old.get("windows") or {}
    w_new = q_new.get("windows") or {}
    for key in sorted(set(w_old) | set(w_new)):
        a, b = w_old.get(key, 0), w_new.get(key, 0)
        if a == b == 0:
            continue
        lines.append(f"  windows[{key}]: {a:g} -> {b:g}")
    for key in ("drift_events", "drift_active"):
        a, b = q_old.get(key, 0) or 0, q_new.get(key, 0) or 0
        if a or b:
            lines.append(f"  {key}: {a:g} -> {b:g}")
    v_old, v_new = q_old.get("verdict"), q_new.get("verdict")
    if v_old != v_new and (v_old or v_new):
        lines.append(f"  verdict: {v_old} -> {v_new}")
    if v_old == "CONSISTENT" and v_new not in (None, "CONSISTENT"):
        warnings.append(
            f"assimilation-quality verdict flipped CONSISTENT -> "
            f"{v_new}: the new artifact's filter is statistically "
            "inconsistent (innovation chi^2 outside the consistency "
            "band) on a previously-consistent benchmark — inspect "
            "quality.jsonl (python -m "
            "kafka_tpu_torch.tools.quality_report) before trusting "
            "its timings"
        )
    old_drift = float(q_old.get("drift_events") or 0)
    new_drift = float(q_new.get("drift_events") or 0)
    if new_drift > 0 and old_drift == 0:
        warnings.append(
            f"quality drift_events went 0 -> {new_drift:g}: the drift "
            "sentinels started alarming on a previously-quiet "
            "benchmark (sensor/R/Q drift class, not a perf question)"
        )
    return warnings, lines


def slo_deltas(old: dict, new: dict) -> Tuple[List[str], List[str]]:
    """(warnings, report_lines) over the embedded ``slo`` snapshots
    (the bench's compact alert/budget view) plus the serve_slo_* rows.

    Diffed INFORMATIONALLY like ``solver_health``/``quality`` — an
    alert is an operations signal, not a timing gate — with the same
    class of loud exception: a previously-clean artifact (zero alerts
    fired) whose new run FIRED alerts burned error budget to get its
    numbers, so it surfaces as an explicit warning.  Still exit 0.
    """
    s_old = old.get("slo") or {}
    s_new = new.get("slo") or {}
    warnings: List[str] = []
    lines: List[str] = []
    for key in ("alerts_fired", "alerts_resolved"):
        a, b = s_old.get(key, 0) or 0, s_new.get(key, 0) or 0
        if a or b:
            lines.append(f"  {key}: {a:g} -> {b:g}")
    f_old = s_old.get("firing") or []
    f_new = s_new.get("firing") or []
    if f_old or f_new:
        lines.append(
            f"  firing: {','.join(f_old) or '-'} -> "
            f"{','.join(f_new) or '-'}"
        )
    for key in ("serve_slo_alerts_total", "serve_slo_budget_remaining"):
        a, b = old.get(key), new.get(key)
        if a is None and b is None:
            continue
        fmt = (lambda v: "-" if v is None else f"{v:g}")
        lines.append(f"  {key}: {fmt(a)} -> {fmt(b)}")
    old_fired = float(s_old.get("alerts_fired") or 0) + \
        float(old.get("serve_slo_alerts_total") or 0)
    new_fired = float(s_new.get("alerts_fired") or 0) + \
        float(new.get("serve_slo_alerts_total") or 0)
    if new_fired > 0 and old_fired == 0:
        warnings.append(
            f"SLO alerts fired went 0 -> {new_fired:g}: the new "
            "artifact burned error budget (burn-rate alerts fired "
            "during the bench) on a previously-clean benchmark — "
            "inspect alerts.jsonl (python -m "
            "kafka_tpu_torch.tools.slo_report) before trusting its "
            "timings"
        )
    return warnings, lines


#: absolute growth of the collective-time fraction beyond this is the
#: mesh-balance red flag device_profile_deltas warns LOUDLY about.
COLLECTIVE_FRACTION_WARN = 0.10


def device_profile_deltas(old: dict, new: dict,
                          ) -> Tuple[List[str], List[str]]:
    """(warnings, report_lines) over the embedded ``device_profile``
    snapshots (the bench's compact kernel/HBM view).

    Diffed INFORMATIONALLY like the other observability snapshots —
    where device time went is attribution, not a timing gate — with
    one loud exception: the collective-time fraction growing by more
    than :data:`COLLECTIVE_FRACTION_WARN` absolute means the new
    artifact spends materially more of its device time waiting on the
    mesh (a sharding/topology change, not a kernel win), so it
    surfaces as an explicit warning.  Still exit 0.
    """
    d_old = old.get("device_profile") or {}
    d_new = new.get("device_profile") or {}
    warnings: List[str] = []
    lines: List[str] = []
    if not d_old and not d_new:
        return warnings, lines
    a, b = d_old.get("captures_parsed", 0), d_new.get(
        "captures_parsed", 0)
    if a or b:
        lines.append(f"  captures_parsed: {a:g} -> {b:g}")
        lines.append(
            f"  device_ms: {d_old.get('device_ms', 0):g} -> "
            f"{d_new.get('device_ms', 0):g}"
        )
    cf_old = d_old.get("collective_fraction")
    cf_new = d_new.get("collective_fraction")
    if cf_old is not None or cf_new is not None:
        fmt = (lambda v: "-" if v is None else f"{v:.1%}")
        lines.append(
            f"  collective_fraction: {fmt(cf_old)} -> {fmt(cf_new)}"
        )
    top_old = (d_old.get("kernels") or [{}])[0].get("name")
    top_new = (d_new.get("kernels") or [{}])[0].get("name")
    if top_old != top_new and (top_old or top_new):
        lines.append(
            f"  top kernel: {top_old or '-'} -> {top_new or '-'}"
        )
    if cf_new is not None and \
            (cf_new - (cf_old or 0.0)) > COLLECTIVE_FRACTION_WARN:
        warnings.append(
            f"collective-time fraction grew {cf_old or 0.0:.1%} -> "
            f"{cf_new:.1%} (more than "
            f"{COLLECTIVE_FRACTION_WARN:.0%} absolute): the new "
            "artifact spends materially more device time waiting on "
            "the mesh — inspect the kernel table "
            "(python -m kafka_tpu_torch.tools.device_report) for the "
            "collective that grew before reading its timings as a "
            "kernel-level result"
        )
    return warnings, lines


def program_contracts_deltas(old: dict, new: dict,
                             ) -> Tuple[List[str], List[str]]:
    """(warnings, report_lines) over the embedded ``program_contracts``
    snapshots (the bench's per-program census fingerprints).

    Informational lines, but fingerprint drift on a shared program
    warns LOUDLY: the two artifacts compiled DIFFERENT device programs
    under the same name, so their timing rows are not the same
    measurement — accept the drift deliberately (``python -m
    kafka_tpu_torch.cli.programlint --update``) before trusting the
    comparison.  A
    finding count going 0 -> N warns too (the new run's programs
    violate contracts the old run's did not).  Still exit 0.
    """
    c_old = old.get("program_contracts") or {}
    c_new = new.get("program_contracts") or {}
    warnings: List[str] = []
    lines: List[str] = []
    if not c_old and not c_new:
        return warnings, lines
    for side, c in (("old", c_old), ("new", c_new)):
        if c.get("error"):
            lines.append(f"  {side}: analysis error: {c['error']}")
    p_old = c_old.get("programs") or {}
    p_new = c_new.get("programs") or {}
    drifted = sorted(
        name for name in set(p_old) & set(p_new)
        if p_old[name] != p_new[name]
    )
    lines.append(
        f"  programs: {len(p_old)} -> {len(p_new)} "
        f"({len(drifted)} fingerprint(s) drifted)"
    )
    for name in sorted(set(p_new) - set(p_old)):
        lines.append(f"  new program: {name} ({p_new[name]})")
    for name in sorted(set(p_old) - set(p_new)):
        lines.append(f"  removed program: {name}")
    for name in drifted:
        lines.append(
            f"  {name}: fingerprint {p_old[name]} -> {p_new[name]}"
        )
    if drifted:
        warnings.append(
            f"program fingerprint(s) drifted for {', '.join(drifted)}: "
            "the compared artifacts traced DIFFERENT device programs "
            "under the same name, so their timing rows are not the same "
            "measurement — review the drift (python -m "
            "kafka_tpu_torch.cli.programlint) and accept it "
            "deliberately with --update before reading "
            "these rows as a like-for-like comparison"
        )
    f_old, f_new = c_old.get("findings"), c_new.get("findings")
    if f_old is not None or f_new is not None:
        lines.append(f"  contract findings: {f_old} -> {f_new}")
    if not f_old and f_new:
        warnings.append(
            f"contract findings went {f_old or 0} -> {f_new}: the new "
            "artifact's device programs violate contracts the old one "
            "satisfied — run python -m kafka_tpu_torch.cli.programlint "
            "for the finding list before trusting the new numbers"
        )
    return warnings, lines


def live_telemetry_deltas(old: dict, new: dict) -> List[str]:
    """Informational diff of the embedded ``live_telemetry`` mid-run
    scrape series (``tools/loadgen``): per shared series, the peak and the
    final sample side by side.  Never gated — the series show HOW a
    latency shift happened (queue build-up vs admission shedding), they
    are not themselves a timing."""
    s_old = (old.get("live_telemetry") or {}).get("series") or {}
    s_new = (new.get("live_telemetry") or {}).get("series") or {}
    lines: List[str] = []
    for key in sorted(set(s_old) & set(s_new)):
        a, b = s_old[key], s_new[key]
        if not a or not b:
            continue
        try:
            peak_a, peak_b = max(a), max(b)
            last_a, last_b = a[-1], b[-1]
        except TypeError:
            continue
        if (peak_a, last_a) == (peak_b, last_b):
            continue
        lines.append(
            f"  {key}: peak {peak_a:g} -> {peak_b:g}, "
            f"final {last_a:g} -> {last_b:g}"
        )
    only = [
        f"  ({side} artifact carries no live_telemetry scrape)"
        for side, art in (("old", old), ("new", new))
        if not (art.get("live_telemetry") or {}).get("series")
    ]
    if only and (s_old or s_new):
        lines.extend(only)
    return lines


def trace_coverage_deltas(old: dict, new: dict) -> List[str]:
    """Informational diff of the request-tracing rows:
    ``serve_trace_coverage`` (fraction of requests whose per-request
    trace attributes >=95% of wall time) and ``serve_slowest_ms`` (the
    worst single request).  NOT gated yet — the rows establish the
    trend first; a coverage drop is called out loudly because it means
    the tracing itself regressed (latency became unexplainable), which
    is an observability break, not a perf question."""
    lines: List[str] = []
    for key in ("serve_trace_coverage", "serve_slowest_ms"):
        a, b = old.get(key), new.get(key)
        if a is None and b is None:
            continue
        fmt = (lambda v: "-" if v is None else f"{v:g}")
        lines.append(f"  {key}: {fmt(a)} -> {fmt(b)}")
    a, b = old.get("serve_trace_coverage"), \
        new.get("serve_trace_coverage")
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and b < a:
        lines.append(
            f"  WARNING serve_trace_coverage dropped {a:g} -> {b:g}: "
            "requests with unexplained latency appeared (run "
            "python -m kafka_tpu_torch.tools.trace_report "
            "--unattributed on the new run)"
        )
    return lines


def telemetry_deltas(old: dict, new: dict, top: int = 8) -> List[str]:
    """Largest relative changes between the embedded registry snapshots
    (context for a timing shift; never gated on)."""
    t_old = old.get("telemetry") or {}
    t_new = new.get("telemetry") or {}
    changes: List[Tuple[float, str]] = []
    for key in sorted(set(t_old) & set(t_new)):
        a, b = t_old[key], t_new[key]
        if not isinstance(a, (int, float)) or \
                not isinstance(b, (int, float)) or a == b:
            continue
        rel = abs(b - a) / max(abs(a), 1e-12)
        changes.append((rel, f"  {key}: {a:g} -> {b:g}"))
    changes.sort(reverse=True)
    out = [line for _, line in changes[:top]]
    missing = [k for k in ("telemetry",) if k not in old or k not in new]
    if missing:
        out.append("  (one artifact carries no telemetry snapshot)")
    return out


def load(path: str) -> Optional[dict]:
    """One artifact, unwrapping the harness archive wrapper format
    ``{"n","cmd","rc","tail","parsed"}`` (``bench_history`` owns the
    unwrap) — so comparing two archived rounds works directly instead of
    silently finding no rows."""
    try:
        with open(path) as f:
            return unwrap_artifact(json.load(f))
    except (OSError, json.JSONDecodeError) as exc:
        print(f"bench_compare: cannot load {path}: {exc}",
              file=sys.stderr)
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("old", help="baseline BENCH JSON")
    ap.add_argument("new", help="candidate BENCH JSON")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="relative regression gate on device_*_ms rows "
                         "(default 0.10 = 10%%)")
    args = ap.parse_args(argv)
    old, new = load(args.old), load(args.new)
    if old is None or new is None:
        return 2
    regressions, lines = compare_rows(old, new, args.threshold)
    print(f"bench_compare: {args.old} -> {args.new}")
    for line in lines:
        print(line)
    deltas = telemetry_deltas(old, new)
    if deltas:
        print("telemetry deltas (context, not gated):")
        for line in deltas:
            print(line)
    live_lines = live_telemetry_deltas(old, new)
    if live_lines:
        print("live telemetry deltas (mid-run scrape, not gated):")
        for line in live_lines:
            print(line)
    trace_lines = trace_coverage_deltas(old, new)
    if trace_lines:
        print("request-tracing deltas (attribution coverage, "
              "not gated):")
        for line in trace_lines:
            print(line)
    health_warnings, health_lines = solver_health_deltas(old, new)
    if health_lines:
        print("solver-health deltas (result quality, not gated):")
        for line in health_lines:
            print(line)
    for w in health_warnings:
        print(f"bench_compare: WARNING {w}", file=sys.stderr)
    quality_warnings, quality_lines = quality_deltas(old, new)
    if quality_lines:
        print("assimilation-quality deltas (consistency, not gated):")
        for line in quality_lines:
            print(line)
    for w in quality_warnings:
        print(f"bench_compare: WARNING {w}", file=sys.stderr)
    slo_warnings, slo_lines = slo_deltas(old, new)
    if slo_lines:
        print("slo deltas (alerts / error budget, not gated):")
        for line in slo_lines:
            print(line)
    for w in slo_warnings:
        print(f"bench_compare: WARNING {w}", file=sys.stderr)
    devprof_warnings, devprof_lines = device_profile_deltas(old, new)
    if devprof_lines:
        print("device-profile deltas (kernel attribution, not gated):")
        for line in devprof_lines:
            print(line)
    for w in devprof_warnings:
        print(f"bench_compare: WARNING {w}", file=sys.stderr)
    contract_warnings, contract_lines = program_contracts_deltas(
        old, new)
    if contract_lines:
        print("program-contract deltas (traced programs, not gated):")
        for line in contract_lines:
            print(line)
    for w in contract_warnings:
        print(f"bench_compare: WARNING {w}", file=sys.stderr)
    unhealthy = [
        name for name, art in (("old", old), ("new", new))
        if art.get("unhealthy")
    ]
    if regressions and unhealthy:
        print(
            f"bench_compare: UNJUDGEABLE — {' and '.join(unhealthy)} "
            "artifact(s) flagged unhealthy (environment weather, not "
            "code); re-measure in a healthy window",
            file=sys.stderr,
        )
        return 0
    if regressions:
        for r in regressions:
            print(f"bench_compare: REGRESSION {r}", file=sys.stderr)
        return 1
    print("bench_compare: OK — no device timing regression "
          f"beyond {100 * args.threshold:.0f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
