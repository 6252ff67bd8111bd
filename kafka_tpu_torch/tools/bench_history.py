"""bench_history — the multi-artifact BENCH trend ledger (port of
``tools/bench_history.py``, which uses the standard library only).

``bench_compare`` reads exactly two artifacts; this tool reads any
number of them (oldest -> newest) and renders one trend table:

- **wrapper-aware loading** (:func:`unwrap_artifact`): archived rounds
  use the harness wrapper format ``{"n", "cmd", "rc", "tail",
  "parsed"}`` with the real BENCH dict under ``"parsed"`` — both wrapped
  and bare artifacts load, in any mix (``bench_compare`` and
  ``device_report`` unwrap through the same helper);
- **per-row trends** over every shared numeric row (device/serve/oracle
  timings, throughput rows, device fraction), with a ROBUST verdict:
  the newest value against the MEDIAN of the prior rounds, direction-
  aware (``*_ms`` rows regress upward, ``*_px_s``/``*per_s`` rows
  regress downward);
- **spread-aware unjudgeability**: a row that swung BOTH directions by
  more than :data:`NOISY_SWING` across rounds, or whose artifacts' own
  recorded ``*_spread`` rivals its value, is flagged ``unjudgeable``
  instead of trended — environment weather must not be read as a perf
  trajectory (bench_compare's unhealthy-artifact rule, applied
  longitudinally).  A monotone improvement staircase swings one way
  only and stays judgeable.

The rules, thresholds, verdicts and rendered lines are the JAX tool's,
so both read the same artifacts the same way (the port's bench,
``python -m kafka_tpu_torch.bench``, writes the JAX key set).

Usage:
    python -m kafka_tpu_torch.tools.bench_history BENCH_a.json \
        BENCH_b.json ... [--json] [--threshold 0.10]

Exit codes: 0 (report rendered — history is a report, not a gate; use
bench_compare for gating), 2 usage/no-loadable-artifacts.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

#: numeric rows worth trending (higher-better unless matched by
#: LOWER_BETTER); everything else in an artifact is context, not a row.
TREND_ROW_PATTERNS = (
    "value",
    "vs_baseline_at_scale",
    "device_*_ms", "device_*_px_s", "device_px_s_matched",
    "device_ms_matched_median",
    "oracle_ms_median", "oracle_ms_min",
    "e2e_pixel_steps_per_s", "e2e_device_fraction",
    "serve_p50_ms", "serve_p99_ms", "serve_cold_ms",
)

#: rows where smaller is better (milliseconds).
LOWER_BETTER_PATTERNS = ("*_ms", "*_ms_median", "*_ms_min")

#: a row that moved BOTH directions by more than this (relative) across
#: rounds is noise, not a trend.
NOISY_SWING = 0.20

#: artifact-recorded spread rivalling the value itself (spread/value
#: beyond this on a typical round) also flags the row unjudgeable.
NOISY_RECORDED_SPREAD = 0.50

#: |delta| of the newest value vs the prior median below this is flat.
DEFAULT_THRESHOLD = 0.10


def unwrap_artifact(doc):
    """Unwrap the harness archive format ``{"n","cmd","rc","tail",
    "parsed"}`` to the BENCH dict under ``"parsed"``; a bare BENCH dict
    passes through.  Returns ``{}`` for anything else (a wrapper whose
    parse failed is row-less, not an error)."""
    if not isinstance(doc, dict):
        return {}
    if "parsed" in doc and ("cmd" in doc or "tail" in doc or "rc" in doc):
        parsed = doc["parsed"]
        return parsed if isinstance(parsed, dict) else {}
    return doc


def load_artifact(path: str) -> Optional[dict]:
    """One artifact, unwrapped; None (with a stderr note) when the file
    is unreadable."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"bench_history: cannot load {path}: {exc}",
              file=sys.stderr)
        return None
    return unwrap_artifact(doc)


def _is_trend_row(key: str) -> bool:
    return any(fnmatch.fnmatch(key, pat) for pat in TREND_ROW_PATTERNS) \
        and not key.endswith("_spread")


def lower_is_better(key: str) -> bool:
    return any(fnmatch.fnmatch(key, pat) for pat in LOWER_BETTER_PATTERNS)


def _series(artifacts: List[dict], key: str,
            ) -> List[Tuple[int, float]]:
    """(artifact index, value) for every artifact carrying the row as a
    number (nulls — e.g. the kernel rows of a CPU run — are absent
    rounds)."""
    out = []
    for i, art in enumerate(artifacts):
        v = art.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append((i, float(v)))
    return out


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def judge_row(key: str, artifacts: List[dict],
              threshold: float = DEFAULT_THRESHOLD) -> Optional[dict]:
    """One row's trend entry, or None when no artifact carries it.

    Verdicts: ``improving`` / ``flat`` / ``regressing`` (newest vs the
    median of the prior rounds, direction-aware), ``single`` (one data
    point), or ``unjudgeable`` with the reason — the row swung both
    directions beyond :data:`NOISY_SWING`, or its own recorded spread
    rivals its value.
    """
    pts = _series(artifacts, key)
    if not pts:
        return None
    values = [v for _, v in pts]
    entry = {
        "row": key,
        "n": len(values),
        "rounds": [i for i, _ in pts],
        "values": values,
        "lower_is_better": lower_is_better(key),
    }
    if len(values) == 1:
        entry.update(verdict="single", reason="one round only")
        return entry

    # Longitudinal noise: successive relative deltas that swing BOTH
    # ways beyond the band mean the row measures weather, not code.
    deltas = [
        (b - a) / abs(a) if a else 0.0
        for a, b in zip(values, values[1:])
    ]
    swung_up = max(deltas) > NOISY_SWING
    swung_down = min(deltas) < -NOISY_SWING
    if swung_up and swung_down:
        entry.update(
            verdict="unjudgeable",
            reason=(
                f"swung both directions beyond {NOISY_SWING:.0%} "
                f"across rounds ({min(deltas):+.0%} .. "
                f"{max(deltas):+.0%}) — environment noise, not a trend"
            ),
        )
        return entry

    # Artifact-recorded dispersion: a row whose own *_spread rivals its
    # value is not trendable either, whichever way its medians drift.
    spreads = _series(artifacts, key + "_spread")
    if spreads:
        ratios = [
            abs(s) / abs(v)
            for (i, s) in spreads
            for (j, v) in pts if i == j and v
        ]
        if ratios and _median(ratios) > NOISY_RECORDED_SPREAD:
            entry.update(
                verdict="unjudgeable",
                reason=(
                    f"recorded spread is {_median(ratios):.0%} of the "
                    "value (median across rounds) — single-round "
                    "dispersion rivals the signal"
                ),
            )
            return entry

    prior_median = _median(values[:-1])
    last = values[-1]
    delta = (last - prior_median) / abs(prior_median) if prior_median \
        else 0.0
    entry["delta_vs_prior_median"] = delta
    if abs(delta) <= threshold:
        entry.update(verdict="flat",
                     reason=f"{delta:+.1%} vs prior median")
        return entry
    better = (delta < 0) if entry["lower_is_better"] else (delta > 0)
    entry.update(
        verdict="improving" if better else "regressing",
        reason=f"{delta:+.1%} vs prior median of {len(values) - 1}",
    )
    return entry


def build_history(paths: List[str],
                  threshold: float = DEFAULT_THRESHOLD) -> Optional[dict]:
    """The full trend document (the ``--json`` payload): artifact
    metadata in the given order + one entry per trendable row."""
    artifacts: List[dict] = []
    meta: List[dict] = []
    for path in paths:
        art = load_artifact(path)
        if art is None:
            continue
        artifacts.append(art)
        meta.append({
            "path": path,
            "name": os.path.basename(path),
            "rows": sum(1 for k in art if _is_trend_row(k)),
            "unhealthy": bool(art.get("unhealthy")),
        })
    if not artifacts:
        return None
    keys = sorted({
        k for art in artifacts for k in art if _is_trend_row(k)
    })
    rows = {}
    for key in keys:
        entry = judge_row(key, artifacts, threshold)
        if entry is not None:
            rows[key] = entry
    return {
        "n_artifacts": len(artifacts),
        "artifacts": meta,
        "threshold": threshold,
        "rows": rows,
    }


def _fmt(v: float) -> str:
    return f"{v:g}" if abs(v) < 1e5 else f"{v:.4g}"


def render(history: dict) -> str:
    """Human-readable trend table."""
    lines = [
        f"bench_history: {history['n_artifacts']} artifact(s), "
        f"oldest -> newest",
    ]
    for m in history["artifacts"]:
        flag = "  UNHEALTHY" if m["unhealthy"] else ""
        lines.append(f"  {m['name']}: {m['rows']} trend row(s){flag}")
    width = max((len(k) for k in history["rows"]), default=10)
    for key, e in sorted(history["rows"].items()):
        arrow = " -> ".join(_fmt(v) for v in e["values"])
        verdict = e["verdict"].upper() if e["verdict"] in (
            "regressing", "unjudgeable"
        ) else e["verdict"]
        lines.append(
            f"  {key:<{width}}  [{verdict}] {arrow}  ({e['reason']})"
        )
    if not history["rows"]:
        lines.append("  (no trendable rows found)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("artifacts", nargs="+",
                    help="BENCH JSON artifacts, oldest first (wrapped "
                         "archive format or bare bench output)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable trend document instead of "
                         "the table")
    ap.add_argument("--threshold", type=float,
                    default=DEFAULT_THRESHOLD,
                    help="|delta| vs prior median below this is flat "
                         "(default 0.10)")
    args = ap.parse_args(argv)
    history = build_history(args.artifacts, threshold=args.threshold)
    if history is None:
        print("bench_history: no loadable artifacts", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(history, indent=2, sort_keys=True))
    else:
        print(render(history))
    return 0


if __name__ == "__main__":
    sys.exit(main())
