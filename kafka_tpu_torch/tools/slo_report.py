"""slo_report — error-budget + alert-episode report over alerts.jsonl.

The port of ``tools/slo_report.py``.  Renders the ``alerts.jsonl``
ledgers the SLO engine writes (``kafka_tpu_torch.telemetry.slo``, the
JAX package's schema) into an operator report — from the ledger ALONE,
no live process required:

- per-objective error budget: the last recorded consumed / remaining
  fractions and time-to-exhaustion estimate (full budget when an
  objective never alerted — a clean ledger IS the clean report);
- alert episodes: every pending -> firing -> resolved arc with its
  firing duration (open episodes flagged), reconstructed by
  ``slo.episodes_from`` — the same arithmetic the tier-1 chaos test
  pins against the live engine's state;
- worst burn rates seen per objective (fast and slow window).

Usage:
    python -m kafka_tpu_torch.tools.slo_report LEDGER_OR_DIR [MORE...]
        [--json]

Arguments may be ``alerts.jsonl`` files or directories (searched
recursively); rotated ``alerts.jsonl.N`` segments are folded in
oldest-first automatically.  Torn ledger tails are skipped and
counted, never fatal.

Exit codes: 0 (report rendered; a firing alert is a report, not an
error), 2 usage / no ledger found.  Strictly read-only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

from ..telemetry import slo


def find_ledgers(paths: List[str]) -> List[str]:
    """Resolve CLI arguments to ledger files (dirs searched recursively
    for ``alerts.jsonl``), sorted and deduplicated."""
    found: List[str] = []
    for arg in paths:
        if os.path.isfile(arg):
            found.append(arg)
        elif os.path.isdir(arg):
            for dirpath, dirnames, filenames in os.walk(arg):
                dirnames.sort()
                if slo.ALERTS_FILENAME in filenames:
                    found.append(
                        os.path.join(dirpath, slo.ALERTS_FILENAME)
                    )
    return sorted(set(found))


def build_report(ledgers: List[str]) -> dict:
    """The ``--json`` payload: per-ledger records folded into one
    per-objective budget/episode/burn view."""
    records: List[dict] = []
    skipped = 0
    sources: List[dict] = []
    for path in ledgers:
        recs, n_skipped = slo.load_alerts(path)
        records.extend(recs)
        skipped += n_skipped
        sources.append({"path": path, "records": len(recs),
                        "skipped": n_skipped})
    records.sort(key=lambda r: float(r.get("ts") or 0.0))
    episodes = slo.episodes_from(records)
    objectives: Dict[str, dict] = {}
    for rec in records:
        name = rec["objective"]
        obj = objectives.setdefault(name, {
            "records": 0,
            "worst_burn_fast": 0.0,
            "worst_burn_slow": 0.0,
            "budget": {"consumed": 0.0, "remaining": 1.0,
                       "tte_s": None},
            "episodes": 0,
            "open_episodes": 0,
        })
        obj["records"] += 1
        obj["worst_burn_fast"] = max(
            obj["worst_burn_fast"], float(rec.get("burn_fast") or 0.0)
        )
        obj["worst_burn_slow"] = max(
            obj["worst_burn_slow"], float(rec.get("burn_slow") or 0.0)
        )
        if isinstance(rec.get("budget"), dict):
            # Records are ts-sorted: the last one wins — the budget
            # remaining at the newest ledger write.
            obj["budget"] = rec["budget"]
    for ep in episodes:
        obj = objectives.get(ep["objective"])
        if obj is None:
            continue
        obj["episodes"] += 1
        if ep["resolved_ts"] is None:
            obj["open_episodes"] += 1
    return {
        "sources": sources,
        "records": len(records),
        "skipped_lines": skipped,
        "objectives": objectives,
        "episodes": episodes,
    }


def render(report: dict) -> str:
    lines = [
        f"slo_report: {report['records']} ledger record(s) from "
        f"{len(report['sources'])} ledger(s)"
        + (f", {report['skipped_lines']} torn line(s) skipped"
           if report["skipped_lines"] else ""),
    ]
    if not report["objectives"]:
        lines.append("  no alert activity recorded — every objective "
                     "holds its full error budget")
        return "\n".join(lines)
    lines.append("error budgets (per objective, last recorded):")
    for name, obj in sorted(report["objectives"].items()):
        b = obj["budget"]
        tte = "-" if b.get("tte_s") is None else f"{b['tte_s']:g}s"
        lines.append(
            f"  {name}: consumed={b.get('consumed', 0):g} "
            f"remaining={b.get('remaining', 1):g} tte={tte}  "
            f"worst burn fast={obj['worst_burn_fast']:g} "
            f"slow={obj['worst_burn_slow']:g}  "
            f"episodes={obj['episodes']}"
            + (f" ({obj['open_episodes']} OPEN)"
               if obj["open_episodes"] else "")
        )
    if report["episodes"]:
        lines.append("alert episodes:")
        for ep in report["episodes"]:
            dur = "OPEN" if ep["resolved_ts"] is None else (
                f"{ep['duration_s']:g}s" if ep.get("duration_s")
                is not None else "?"
            )
            lines.append(
                f"  {ep['objective']} [{ep['severity']}] "
                f"firing@{ep['firing_ts']} duration={dur} "
                f"burn fast={ep.get('burn_fast')} "
                f"slow={ep.get('burn_slow')}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="+",
                    help="alerts.jsonl files or directories to search "
                         "recursively")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable dump instead of the report")
    args = ap.parse_args(argv)
    ledgers = find_ledgers(args.paths)
    if not ledgers:
        print("slo_report: no alerts.jsonl found under the given "
              "paths", file=sys.stderr)
        return 2
    report = build_report(ledgers)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
