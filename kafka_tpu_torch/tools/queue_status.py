"""queue_status — read-only view of a multi-host chunk-queue outdir.

The port of ``tools/queue_status.py``.  Renders the lease-queue state
(``kafka_tpu_torch.shard.queue``) for operators and for the chaos tests
to assert against: done / failed / leased-live / leased-expired /
pending counts, plus per-worker lease ownership. Strictly read-only — it
never touches a marker, so it is safe to run against a live fleet.

Usage:
    python -m kafka_tpu_torch.tools.queue_status /path/to/outdir [--json]
        [--telemetry-dir DIR]

``--telemetry-dir`` joins the fleet plane's live heartbeat snapshots
(``kafka_tpu_torch.telemetry.live``) against lease ownership: each worker
line gains its heartbeat age and a DEAD flag when the heartbeat went
stale without a clean shutdown — "who holds this lease" and "is that
worker still breathing" in one view.

Exit codes: 0 (state rendered, whatever it is), 2 usage/missing outdir.
PENDING counts need the ``.queue_manifest.json`` a queue worker writes
at startup; without one, only chunks with marker files are visible and
the render says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _liveness_text(info) -> str:
    if info is None:
        return "  (no live snapshot)"
    if info["dead"]:
        return f"  DEAD (heartbeat {info['age_s']:.1f}s stale)"
    if info["final"]:
        return f"  exited cleanly {info['age_s']:.1f}s ago"
    return f"  heartbeat {info['age_s']:.1f}s ago"


def render(status: dict) -> str:
    """Human-readable one-screen summary of a ``queue_status()`` dict
    (plus the optional ``liveness`` join)."""
    c = status["counts"]
    liveness = status.get("liveness")
    lines = [
        f"queue: {status['outdir']}",
        f"chunks: {status['n_chunks']}"
        + ("" if status["manifest"]
           else "  (no manifest — pending chunks invisible)"),
        f"  done            {c['done']}",
        f"  failed          {c['failed']}",
        f"  leased (live)   {c['leased']}",
        f"  leased (expired){c['lease_expired']:>2}   <- reclaimable",
        f"  pending         {c['pending']}",
    ]
    if status["workers"]:
        lines.append("workers:")
        for owner in sorted(status["workers"]):
            w = status["workers"][owner]
            parts = []
            if w["live"]:
                parts.append(f"live={','.join(w['live'])}")
            if w["expired"]:
                parts.append(f"EXPIRED={','.join(w['expired'])}")
            alive = ""
            if liveness is not None:
                alive = _liveness_text(liveness.get(owner))
            lines.append(f"  {owner}: {' '.join(parts)}{alive}")
    interesting = {
        p: e for p, e in status["chunks"].items()
        if e["state"] not in ("done",)
    }
    if interesting:
        lines.append("open chunks:")
        for prefix in sorted(interesting):
            e = interesting[prefix]
            extra = ""
            if "owner" in e:
                extra = (f"  owner={e['owner']}"
                         f" requeues={e.get('requeues', 0)}")
                if "deadline_in_s" in e:
                    extra += f" deadline_in={e['deadline_in_s']:+.1f}s"
            lines.append(f"  {prefix}: {e['state']}{extra}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", help="queue output directory to inspect")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable dump instead of the summary")
    ap.add_argument("--telemetry-dir", default=None,
                    help="telemetry root holding live_*.json heartbeat "
                         "snapshots; joins worker liveness (heartbeat "
                         "age, dead flag) against lease ownership")
    ap.add_argument("--ttl-s", type=float, default=None,
                    help="heartbeat staleness that flags a worker dead "
                         "(default: 3x each snapshot's own interval)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.outdir):
        print(f"queue_status: no such directory: {args.outdir}",
              file=sys.stderr)
        return 2
    from ..shard.queue import queue_status

    status = queue_status(args.outdir)
    if args.telemetry_dir:
        from ..telemetry.aggregate import (
            load_live_snapshots, worker_liveness,
        )

        status["liveness"] = worker_liveness(
            load_live_snapshots(args.telemetry_dir), ttl_s=args.ttl_s,
        )
    if args.json:
        print(json.dumps(status, indent=2, sort_keys=True))
    else:
        print(render(status))
    return 0


if __name__ == "__main__":
    sys.exit(main())
