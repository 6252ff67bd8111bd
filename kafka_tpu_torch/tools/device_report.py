"""device_report — the device-plane view over a profiler capture dir.

The port of ``tools/device_report.py``.  ``/kernelz`` answers for a LIVE
process; this tool answers for the artifacts a run left behind.  Point
it at a telemetry root (or straight at a capture/session dir) and it
parses the NEWEST profiler capture session (``telemetry.devprof`` —
stdlib gzip+json over the ``*.trace.json.gz`` Chrome traces that
``torch.profiler`` captures are written as, GPU tracks named
``/device:GPU:<i>``; the JAX package's captures read the same) into:

- the ranked kernel table (slowest first) with
  fusion/collective/transfer/other buckets and per-kernel share of
  total device time;
- the bucket split and the collective-time fraction — the mesh-balance
  red flag a scaled-out run is watched for;
- the per-device-track share of device time (skew reads as unequal
  fractions).

``--mesh-history MULTICHIP_r01.json ...`` additionally renders the
archived multichip round artifacts (loaded through
``bench_history.unwrap_artifact``, so wrapped harness archives and the
bare checked-in dicts both work) as a mesh trajectory: devices, verdict
and the result line per round.

Usage:
    python -m kafka_tpu_torch.tools.device_report TELEMETRY_DIR [--json]
        [--n 16] [--all-sessions] [--mesh-history MULTICHIP_r*.json ...]

Exit codes: 0 (report rendered), 2 usage / nothing parseable and no
mesh history given.  Strictly read-only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..telemetry import devprof
from .bench_history import load_artifact


def build_report(root: str, n: int = 16,
                 all_sessions: bool = False) -> dict:
    """The ``--json`` payload: per-session parse results (newest only
    unless ``all_sessions``), plus the root-level session census."""
    sessions = devprof.find_capture_sessions(root)
    picked = sessions if all_sessions else sessions[-1:]
    parsed = []
    for session in picked:
        table = devprof.parse_capture(session)
        if table is None:
            parsed.append({
                "session_dir": session, "parseable": False,
            })
            continue
        parsed.append({
            "session_dir": session,
            "parseable": True,
            "epoch_unix_s": devprof.capture_epoch(session, stop_at=root),
            "device_ms": table["device_ms"],
            "by_bucket": table["by_bucket"],
            "collective_fraction": table["collective_fraction"],
            "device_split": table["device_split"],
            "parse_errors": table["parse_errors"],
            "truncated_ms": table["truncated_ms"],
            "kernels": table["kernels"][:max(0, n)],
        })
    return {
        "root": os.path.abspath(root),
        "n_sessions": len(sessions),
        "sessions": parsed,
    }


def mesh_history(paths) -> list:
    """Archived multichip rounds (``MULTICHIP_r*.json``) as one row per
    artifact — wrapped or bare, via ``bench_history.unwrap_artifact``."""
    rows = []
    for path in paths:
        art = load_artifact(path)
        if art is None:
            continue
        tail = (art.get("tail") or "").strip().splitlines()
        rows.append({
            "name": os.path.basename(path),
            "n_devices": art.get("n_devices"),
            "ok": art.get("ok"),
            "skipped": art.get("skipped"),
            "rc": art.get("rc"),
            "result": tail[-1] if tail else None,
        })
    return rows


def render(report: dict, history: list) -> str:
    lines = [
        f"device_report: {report['n_sessions']} capture session(s) "
        f"under {report['root']}",
    ]
    for s in report["sessions"]:
        rel = os.path.relpath(s["session_dir"], report["root"])
        if not s["parseable"]:
            lines.append(f"  {rel}: NOT PARSEABLE (no device-lane "
                         "kernel spans)")
            continue
        cf = s["collective_fraction"]
        lines.append(
            f"  {rel}: device {s['device_ms']:.3f}ms"
            + (f", collective {cf:.1%}" if cf is not None else "")
            + (f", {s['parse_errors']} file parse error(s)"
               if s["parse_errors"] else "")
        )
        for b, ms in s["by_bucket"].items():
            lines.append(f"    bucket {b:<10s} {ms:10.3f}ms")
        lines.append("    slowest kernels:")
        for k in s["kernels"]:
            lines.append(
                f"      {k['ms']:10.3f}ms {k['fraction']:6.1%} "
                f"[{k['bucket']:10s}] x{k['count']} {k['name']}"
            )
        if s["truncated_ms"]:
            lines.append(
                f"      ... long tail: {s['truncated_ms']:.3f}ms beyond "
                "the table"
            )
        for track, frac in sorted((s["device_split"] or {}).items()):
            lines.append(f"    time {track}: {frac:.1%}")
    if not report["sessions"]:
        lines.append("  (no capture sessions found — trigger one via "
                     "/profilez or --profile-windows)")
    if history:
        lines.append("mesh history (multichip rounds, oldest -> newest):")
        for r in history:
            verdict = ("skipped" if r["skipped"]
                       else "ok" if r["ok"] else "FAILED")
            lines.append(
                f"  {r['name']}: {r['n_devices']} device(s) [{verdict}]"
                + (f" {r['result']}" if r["result"] else "")
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=None,
                    help="telemetry root / capture dir to scan for "
                         "profiler sessions (optional with "
                         "--mesh-history)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report instead of the table")
    ap.add_argument("--n", type=int, default=16,
                    help="kernel-table rows per session (default 16)")
    ap.add_argument("--all-sessions", action="store_true",
                    help="parse every session under the root, not just "
                         "the newest")
    ap.add_argument("--mesh-history", nargs="+", default=(),
                    metavar="ART",
                    help="archived MULTICHIP_r*.json round artifacts to "
                         "render as a mesh trajectory (wrapped or bare)")
    args = ap.parse_args(argv)
    if args.root is None and not args.mesh_history:
        print("device_report: give a capture root and/or --mesh-history",
              file=sys.stderr)
        return 2
    report = {"root": None, "n_sessions": 0, "sessions": []}
    if args.root is not None:
        if not os.path.isdir(args.root):
            print(f"device_report: no such directory: {args.root}",
                  file=sys.stderr)
            return 2
        report = build_report(args.root, n=args.n,
                              all_sessions=args.all_sessions)
    history = mesh_history(args.mesh_history)
    if not report["sessions"] and not history and args.mesh_history:
        print("device_report: no loadable artifacts", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({**report, "mesh_history": history},
                         indent=2, sort_keys=True))
    else:
        print(render(report, history))
    return 0


if __name__ == "__main__":
    sys.exit(main())
