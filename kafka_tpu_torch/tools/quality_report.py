"""quality_report — per-tile assimilation-quality scorecards.

The port of ``tools/quality_report.py``.  Renders the ``quality.jsonl``
ledgers the engine and the serving daemon write
(``kafka_tpu_torch.telemetry.quality``, the JAX package's schema) into
an operator scorecard: per-tile/per-band consistency timelines, drift
episodes, and the worst-N dates — from the ledger ALONE, no live process
required. Verdicts are re-derived from the recorded per-band chi^2
ratios with the same ``verdict_for`` bands the engine used, so the
report doubles as a consistency check of the ledger itself (``verdict``
vs ``recomputed`` per date).

Usage:
    python -m kafka_tpu_torch.tools.quality_report LEDGER_OR_DIR [MORE...]
        [--json] [--worst N]

Arguments may be ``quality.jsonl`` files or directories (searched
recursively).  Torn ledger tails — a process killed mid-append — are
skipped and counted, never fatal.

Exit codes: 0 (report rendered; drift is a report, not an error),
2 usage / no ledger found.  Strictly read-only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, List, Optional

from ..telemetry import quality

#: timeline glyphs per verdict (drifting dates are UPPERCASED already;
#: they additionally carry a trailing ``!``).
_GLYPH = {
    quality.CONSISTENT: "C",
    quality.OVERCONFIDENT: "O",
    quality.UNDERCONFIDENT: "U",
    quality.NO_OBS: ".",
}


def find_ledgers(paths: List[str]) -> List[str]:
    """Resolve CLI arguments to ledger files (dirs searched recursively
    for ``quality.jsonl``), sorted and deduplicated."""
    found: List[str] = []
    for arg in paths:
        if os.path.isfile(arg):
            found.append(arg)
        elif os.path.isdir(arg):
            for dirpath, dirnames, filenames in os.walk(arg):
                dirnames.sort()
                if quality.LEDGER_FILENAME in filenames:
                    found.append(
                        os.path.join(dirpath, quality.LEDGER_FILENAME)
                    )
    return sorted(set(found))


def _tile_key(rec: dict, source: str) -> str:
    """Group records by tile/chunk prefix, falling back to the ledger's
    parent directory name for prefix-less (single-run) ledgers.
    Reanalysis (``smoothed``) records get their own timeline per tile so
    the forward filter and the RTS pass are scored separately."""
    key = rec.get("prefix") or os.path.basename(
        os.path.dirname(os.path.abspath(source))
    ) or "-"
    return f"{key} [smoothed]" if rec.get("smoothed") else key


def _deviation(rec: dict) -> float:
    """Drift-agnostic severity score for worst-N ranking: the largest
    |log ratio| over bands carrying signal (0 for NO_OBS records)."""
    worst = 0.0
    for v in rec.get("chi2_per_band") or ():
        v = float(v)
        if math.isfinite(v) and v > 0.0:
            worst = max(worst, abs(math.log(v)))
    return worst


def build_report(paths: List[str], worst_n: int = 5) -> dict:
    """The scorecard as data (the ``--json`` payload)."""
    sources = []
    tiles: Dict[str, List[dict]] = {}
    for path in paths:
        records, skipped = quality.load_ledger(path)
        sources.append({
            "path": os.path.abspath(path),
            "records": len(records),
            "skipped_lines": skipped,
        })
        for rec in records:
            tiles.setdefault(_tile_key(rec, path), []).append(rec)

    report_tiles: Dict[str, dict] = {}
    for tile in sorted(tiles):
        recs = tiles[tile]
        dates = []
        episodes: List[dict] = []
        open_episode: Optional[dict] = None
        for rec in recs:
            drift = rec.get("drift") or {}
            active = bool(drift.get("active"))
            ratios = [float(v) for v in rec.get("chi2_per_band") or ()]
            entry = {
                "date": rec.get("date"),
                "verdict": rec.get("verdict"),
                # Re-derived from the ratios alone: the ledger must be
                # self-contained (acceptance: the report reproduces
                # per-date verdicts with no live process).  Smoothed
                # records score on sigma-shrink instead of chi^2 (the
                # backward pass has no innovations).
                "recomputed": (
                    quality.NO_OBS if rec.get("degraded")
                    else quality.smoothed_verdict_for(
                        [float(v) for v in rec.get("sigma_shrink") or ()]
                    ) if rec.get("smoothed")
                    else quality.verdict_for(ratios)
                ),
                "degraded": bool(rec.get("degraded")),
                "chi2_per_band": ratios,
                "drift_active": active,
                "drift_bands": list(drift.get("bands") or ()),
                "deviation": round(_deviation(rec), 6),
            }
            dates.append(entry)
            if active:
                if open_episode is None:
                    open_episode = {
                        "start": entry["date"], "end": entry["date"],
                        "dates": 1,
                        "bands": set(entry["drift_bands"]),
                    }
                else:
                    open_episode["end"] = entry["date"]
                    open_episode["dates"] += 1
                    open_episode["bands"].update(entry["drift_bands"])
            elif open_episode is not None:
                open_episode["bands"] = sorted(open_episode["bands"])
                episodes.append(open_episode)
                open_episode = None
        if open_episode is not None:
            open_episode["bands"] = sorted(open_episode["bands"])
            episodes.append(open_episode)
        verdict_counts: Dict[str, int] = {}
        for e in dates:
            verdict_counts[e["verdict"]] = \
                verdict_counts.get(e["verdict"], 0) + 1
        worst = sorted(
            (e for e in dates if not e["degraded"]),
            key=lambda e: e["deviation"], reverse=True,
        )[:max(0, worst_n)]
        report_tiles[tile] = {
            "dates": dates,
            "episodes": episodes,
            "worst": worst,
            "verdicts": verdict_counts,
            "overall": quality.worst_verdict(
                e["verdict"] for e in dates
            ),
            "drift_dates": sum(1 for e in dates if e["drift_active"]),
        }
    return {
        "version": 1,
        "bands": {"lo": quality.CONSISTENT_LO,
                  "hi": quality.CONSISTENT_HI},
        "sources": sources,
        "tiles": report_tiles,
    }


def render(report: dict) -> str:
    """Human one-screen scorecard."""
    lines = []
    n_rec = sum(s["records"] for s in report["sources"])
    n_skip = sum(s["skipped_lines"] for s in report["sources"])
    lines.append(
        f"quality report: {len(report['sources'])} ledger(s), "
        f"{n_rec} record(s)"
        + (f", {n_skip} torn line(s) skipped" if n_skip else "")
    )
    for tile, t in report["tiles"].items():
        timeline = "".join(
            _GLYPH.get(e["verdict"], "?") + ("!" if e["drift_active"]
                                             else "")
            for e in t["dates"]
        )
        lines.append(
            f"  {tile}: overall={t['overall']}  "
            f"drift_dates={t['drift_dates']}  [{timeline}]"
        )
        for ep in t["episodes"]:
            lines.append(
                f"    drift episode: {ep['start']} .. {ep['end']} "
                f"({ep['dates']} date(s), bands {ep['bands']})"
            )
        for e in t["worst"]:
            if e["deviation"] <= 0:
                continue
            ratios = ", ".join(f"{v:.3g}" for v in e["chi2_per_band"])
            lines.append(
                f"    worst: {e['date']}  {e['verdict']}"
                f"{' DRIFT' if e['drift_active'] else ''}  "
                f"chi2/n=[{ratios}]"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="+",
                    help="quality.jsonl file(s) or directories to "
                         "search recursively")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report instead of the "
                         "scorecard")
    ap.add_argument("--worst", type=int, default=5,
                    help="how many worst dates to list per tile")
    args = ap.parse_args(argv)
    ledgers = find_ledgers(args.paths)
    if not ledgers:
        print(
            f"quality_report: no {quality.LEDGER_FILENAME} found under "
            f"{args.paths}", file=sys.stderr,
        )
        return 2
    report = build_report(ledgers, worst_n=args.worst)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
