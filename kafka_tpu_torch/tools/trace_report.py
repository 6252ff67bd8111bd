"""trace_report — slow-request forensics over the per-request wide events.

The port of ``tools/trace_report.py``.  Reads every ``request_log.jsonl``
under a telemetry root (both the router's and the replicas' —
``kafka_tpu_torch.telemetry.request_log``, the JAX package's schema) and
answers the question the latency histograms cannot: *which* requests
were slow, and *where* their time went.

- **slowest-N** (``--slowest``): the worst requests by end-to-end wall
  time, each with its phase-attribution breakdown (admission_wait /
  queue_wait / resume / solve / dump on a replica; + failover / forward
  / relay through the router) and its reroute history;
- **p99 exemplars**: the latency percentiles resolved to CONCRETE
  request ids — the p99 is a real request you can open, and the
  histogram bucket it lands in lists its neighbours;
- **unattributed check** (``--unattributed``): requests whose named
  phases cover less than ``--coverage`` (default 0.95) of their wall
  time have unexplained latency — exit 1 when any are found, the
  tracing-coverage gate;
- **per-request stitch** (``--request ID --stitch OUT.json``): write
  the request's cross-process Chrome-trace waterfall (router + replica
  tracks, flow arrows across the hops) via
  ``telemetry.aggregate.stitch_traces``.

When one request left records in BOTH the router and a replica, the
router's record wins (it carries the merged end-to-end phases); the
replica record still contributes served_from/solver_health when the
router's lacks them.

Usage:
    python -m kafka_tpu_torch.tools.trace_report TELEMETRY --slowest 10
    python -m kafka_tpu_torch.tools.trace_report TELEMETRY --json
    python -m kafka_tpu_torch.tools.trace_report TELEMETRY --unattributed
    python -m kafka_tpu_torch.tools.trace_report TELEMETRY \\
        --request a1b2c3 --stitch OUT.json

Exit codes: 0 report rendered, 1 ``--unattributed`` found requests
below the coverage bar, 2 usage/missing root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from ..telemetry import request_log
from ..telemetry.registry import DEFAULT_BUCKETS

#: latency-histogram bucket bounds (ms) the exemplars are binned into —
#: the serve latency histogram's own buckets (registry.DEFAULT_BUCKETS
#: is in seconds), so a bucket here IS a bucket on /metrics.
BUCKETS_MS = [b * 1e3 for b in DEFAULT_BUCKETS]

#: replica-side phases that the router record supersedes.
PHASE_ORDER = (
    "admission_wait_ms", "failover_ms", "forward_ms", "queue_wait_ms",
    "resume_ms", "solve_ms", "dump_ms", "relay_ms",
)


def merge_records(records: List[dict]) -> List[dict]:
    """One entry per request id: the router record (merged end-to-end
    phases) wins over the replica's; replica-only fields (served_from,
    solver_health, quality) backfill."""
    by_id: Dict[str, dict] = {}
    for rec in records:
        rid = rec["request_id"]
        cur = by_id.get(rid)
        if cur is None:
            by_id[rid] = dict(rec)
            continue
        keep, fill = (rec, cur) if rec.get("role") == "route" \
            else (cur, rec)
        merged = dict(keep)
        for key, val in fill.items():
            if merged.get(key) in (None, {}, []):
                merged[key] = val
        by_id[rid] = merged
    out = list(by_id.values())
    for rec in out:
        rec["coverage"] = request_log.attributed_fraction(rec)
    out.sort(key=lambda r: -(r.get("e2e_ms") or 0))
    return out


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _bucket_le(value_ms: float) -> Optional[float]:
    for le in BUCKETS_MS:
        if value_ms <= le:
            return le
    return None


def exemplars(entries: List[dict]) -> dict:
    """Latency percentiles resolved to concrete requests: for p50 and
    p99 over the OK requests, the exemplar request at that rank plus
    the histogram bucket it falls in (and that bucket's other request
    ids) — the link from a histogram spike to openable traces."""
    ok = sorted(
        (r for r in entries
         if r.get("status") == "ok"
         and isinstance(r.get("e2e_ms"), (int, float))),
        key=lambda r: r["e2e_ms"],
    )
    out: dict = {"n_ok": len(ok)}
    for q, name in ((0.5, "p50"), (0.99, "p99")):
        if not ok:
            out[name] = None
            continue
        idx = min(len(ok) - 1,
                  max(0, int(round(q * (len(ok) - 1)))))
        ex = ok[idx]
        le = _bucket_le(ex["e2e_ms"])
        bucket_ids = [
            r["request_id"] for r in ok
            if _bucket_le(r["e2e_ms"]) == le
        ]
        out[name] = {
            "value_ms": round(ex["e2e_ms"], 3),
            "request_id": ex["request_id"],
            "tile": ex.get("tile"),
            "served_from": ex.get("served_from"),
            "bucket_le_ms": le,
            "bucket_request_ids": bucket_ids[:5],
        }
    return out


def _phase_line(rec: dict) -> str:
    phases = rec.get("phases") or {}
    e2e = rec.get("e2e_ms") or 0
    parts = []
    for key in PHASE_ORDER:
        v = phases.get(key)
        if not isinstance(v, (int, float)) or v <= 0:
            continue
        pct = f" {100 * v / e2e:.0f}%" if e2e else ""
        parts.append(f"{key[:-3]}={v:.1f}ms{pct}")
    for key in sorted(set(phases) - set(PHASE_ORDER)):
        v = phases[key]
        if isinstance(v, (int, float)) and v > 0:
            parts.append(f"{key[:-3]}={v:.1f}ms")
    return "  ".join(parts) or "(no phases recorded)"


def render(entries: List[dict], slowest: int, torn: int,
           coverage_target: float) -> str:
    by_status: Dict[str, int] = {}
    for r in entries:
        by_status[r.get("status", "?")] = \
            by_status.get(r.get("status", "?"), 0) + 1
    lines = [
        f"trace_report: {len(entries)} request(s) "
        + " ".join(f"{k}={v}" for k, v in sorted(by_status.items()))
        + (f"  (skipped {torn} torn line(s))" if torn else ""),
    ]
    ex = exemplars(entries)
    for name in ("p50", "p99"):
        e = ex.get(name)
        if e:
            lines.append(
                f"{name}: {e['value_ms']:.1f}ms — request "
                f"{e['request_id']} (tile={e['tile']}, "
                f"served_from={e['served_from']}, "
                f"bucket le={e['bucket_le_ms']}ms: "
                f"{','.join(e['bucket_request_ids'])})"
            )
    lines.append(f"slowest {min(slowest, len(entries))}:")
    for rec in entries[:slowest]:
        cov = rec.get("coverage")
        cov_txt = "-" if cov is None else f"{100 * cov:.1f}%"
        flag = "  UNATTRIBUTED" if request_log.is_covered(
            rec, target=coverage_target) is False else ""
        e2e = rec.get("e2e_ms")
        lines.append(
            f"  {rec['request_id']} [{rec.get('role')}] "
            f"{rec.get('status')}"
            + (f" {rec['served_from']}" if rec.get("served_from")
               else "")
            + (f" tile={rec['tile']}" if rec.get("tile") else "")
            + (f" replica={rec['replica']}" if rec.get("replica")
               else "")
            + (f"  e2e={e2e:.1f}ms" if isinstance(e2e, (int, float))
               else "")
            + f"  attributed={cov_txt}{flag}"
        )
        lines.append(f"    {_phase_line(rec)}")
        for hop in rec.get("reroutes") or ():
            lines.append(
                f"    reroute: {hop.get('replica')} "
                f"({hop.get('reason')}, held "
                f"{hop.get('held_ms', 0):.0f}ms)"
            )
    return "\n".join(lines)


def build_report(root: str, slowest: int = 10,
                 coverage_target: float = request_log.COVERAGE_TARGET,
                 ) -> dict:
    """The ``--json`` payload, importable for tests and other tools."""
    records, torn = request_log.load_records(root)
    entries = merge_records(records)
    unattributed = [
        {"request_id": r["request_id"], "role": r.get("role"),
         "e2e_ms": r.get("e2e_ms"),
         "coverage": None if r.get("coverage") is None
         else round(r["coverage"], 4)}
        for r in entries
        if request_log.is_covered(r, target=coverage_target) is False
    ]
    covered = [r for r in entries if r.get("coverage") is not None]
    by_status: Dict[str, int] = {}
    for r in entries:
        by_status[r.get("status", "?")] = \
            by_status.get(r.get("status", "?"), 0) + 1
    return {
        "root": os.path.abspath(root),
        "requests_total": len(entries),
        "by_status": by_status,
        "torn_lines": torn,
        "coverage_target": coverage_target,
        "coverage_ok_fraction": (
            round(sum(1 for r in covered
                      if request_log.is_covered(
                          r, target=coverage_target))
                  / len(covered), 4) if covered else None
        ),
        "unattributed": unattributed,
        "exemplars": exemplars(entries),
        "slowest": [
            {k: rec.get(k) for k in (
                "request_id", "role", "status", "tile", "date",
                "served_from", "replica", "e2e_ms", "phases",
                "coverage", "reroutes", "replayed",
                "solver_health", "quality",
            ) if rec.get(k) is not None}
            for rec in entries[:slowest]
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="telemetry root holding "
                                 "request_log.jsonl files (searched "
                                 "recursively)")
    ap.add_argument("--slowest", type=int, default=10, metavar="N",
                    help="how many worst-latency requests to break "
                         "down (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report instead of the "
                         "summary")
    ap.add_argument("--unattributed", action="store_true",
                    help="coverage check: exit 1 when any request's "
                         "named phases attribute less than --coverage "
                         "of its wall time")
    ap.add_argument("--coverage", type=float,
                    default=request_log.COVERAGE_TARGET,
                    help="attribution bar for --unattributed "
                         "(default 0.95)")
    ap.add_argument("--request", default=None, metavar="ID",
                    help="report only this request id")
    ap.add_argument("--stitch", default=None, metavar="OUT",
                    help="with --request: write the request's stitched "
                         "cross-process Chrome trace to OUT")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"trace_report: no such directory: {args.root}",
              file=sys.stderr)
        return 2
    if args.stitch and not args.request:
        print("trace_report: --stitch needs --request",
              file=sys.stderr)
        return 2
    report = build_report(args.root, slowest=args.slowest,
                          coverage_target=args.coverage)
    entries = merge_records(request_log.load_records(args.root)[0])
    if args.request:
        entries = [r for r in entries
                   if r["request_id"] == args.request]
        if not entries:
            print(f"trace_report: no record of request "
                  f"{args.request!r} under {args.root}",
                  file=sys.stderr)
            return 2
        report["slowest"] = [
            {k: rec.get(k) for k in (
                "request_id", "role", "status", "tile", "date",
                "served_from", "replica", "e2e_ms", "phases",
                "coverage", "reroutes", "replayed",
                "solver_health", "quality",
            ) if rec.get(k) is not None}
            for rec in entries
        ]
    if args.stitch:
        from ..telemetry.aggregate import stitch_traces

        doc = stitch_traces(args.root, request_id=args.request)
        with open(args.stitch, "w") as f:
            json.dump(doc, f)
        report["stitched_trace"] = {
            "path": os.path.abspath(args.stitch),
            "sources": doc["otherData"]["sources"],
            "events": len(doc["traceEvents"]),
        }
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render(entries, args.slowest, report["torn_lines"],
                     args.coverage))
        if report.get("stitched_trace"):
            st = report["stitched_trace"]
            print(f"stitched trace: {st['path']} "
                  f"({len(st['sources'])} process track(s), "
                  f"{st['events']} events)")
    if args.unattributed and report["unattributed"]:
        print(
            f"trace_report: {len(report['unattributed'])} request(s) "
            f"below the {args.coverage:.0%} attribution bar",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
