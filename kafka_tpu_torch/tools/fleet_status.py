"""fleet_status — one live view over a multi-process kafka_tpu fleet.

The port of ``tools/fleet_status.py``.  Merges every
``live_<host>_<pid>.json`` heartbeat snapshot under a telemetry root
(``kafka_tpu_torch.telemetry.live``, the JAX package's schema) into the
fleet view (``kafka_tpu_torch.telemetry.aggregate``): per-worker
liveness (heartbeat age; a stale heartbeat without a clean-shutdown
marker flags the host DEAD), counters summed across processes, gauges
per host, serve/phase latency histograms merged into fleet p50/p99,
crash-dump pointers, and — when the workers ran the lease queue — the
queue's chunk counts (auto-discovered from worker status, or
``--queue-dir``).

``--stitch-trace OUT.json`` additionally merges the per-process
``trace.json`` fragments under the root into ONE Chrome trace (each
process its own named pid track, timestamps aligned on the shared
wall-clock epoch) — open it at https://ui.perfetto.dev.

``--watch N`` turns the one-shot view into a live dashboard: clear the
screen and re-render every N seconds until Ctrl-C (clean exit 0);
``--watch-count M`` stops after M redraws (the smoke-test hook).

Usage:
    python -m kafka_tpu_torch.tools.fleet_status /path/to/telemetry
        [--json] [--ttl-s 6] [--queue-dir DIR] [--stitch-trace OUT]
        [--run-id ID] [--watch N [--watch-count M]]

Exit codes: 0 (view rendered, dead hosts included — liveness is a
report, not an error), 2 usage/missing root.  Strictly read-only apart
from the optional stitched-trace output file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def render(fleet: dict) -> str:
    """Human-readable one-screen summary of an ``aggregate_fleet``
    view (+ the optional ``queue`` section)."""
    lines = [
        f"fleet: {fleet['n_workers']} worker(s), "
        f"run_ids={','.join(fleet['run_ids']) or '-'}",
    ]
    for w in fleet["workers"]:
        state = "DEAD" if w["dead"] else \
            ("exited" if w["final"] else "live")
        extra = ""
        q = w.get("quality") or {}
        if q.get("last_verdict"):
            extra += f"  quality={q['last_verdict']}" + \
                ("(DRIFT)" if q.get("drift_active") else "")
        p = w.get("perf") or {}
        if p.get("px_steps_per_s"):
            extra += f"  perf={p['px_steps_per_s']:.3g}px/s"
            if p.get("device_fraction") is not None:
                extra += f",df={p['device_fraction']:.2f}"
        # Per-worker device-plane column (telemetry.devprof): mesh
        # axes, collective fraction of the newest parsed capture, and
        # the top kernel — the mesh-balance glance.
        dp = w.get("devprof") or {}
        if dp.get("mesh") and (dp["mesh"].get("axes") or {}):
            axes = ",".join(
                f"{k}={v}" for k, v in dp["mesh"]["axes"].items()
            )
            extra += f"  mesh[{axes}]"
        if dp.get("collective_fraction") is not None:
            extra += f"  coll={dp['collective_fraction']:.0%}"
        elif dp.get("top_kernel"):
            extra += f"  kern={dp['top_kernel']['name'][:24]}"
        # Per-worker SLO alert state (telemetry.slo): name the firing
        # objectives inline; the deduped fleet line renders below.
        s = w.get("slo") or {}
        if s.get("firing"):
            shown = ",".join(
                f"{a.get('objective')}({a.get('severity')})"
                for a in s["firing"][:4]
            )
            extra += f"  slo=FIRING[{shown}]"
        if w["crash_dumps"]:
            extra += f"  crash={w['crash_dumps'][-1]}"
        lines.append(
            f"  {w['key']} [{w['role']}] {state}  "
            f"heartbeat {w['age_s']:.1f}s ago{extra}"
        )
        # Per-request view: the compact recent_requests status fact
        # both kafka-serve and kafka-route publish — the fleet-level
        # echo of their /requestz endpoints.
        recent = (w.get("status") or {}).get("recent_requests") or ()
        if recent:
            shown = ", ".join(
                f"{r.get('request_id')}"
                f"({r.get('status')}"
                + (f",{r['served_from']}" if r.get("served_from")
                   else "")
                + (f",{r['e2e_ms']:.0f}ms"
                   if isinstance(r.get("e2e_ms"), (int, float))
                   else "")
                + ")"
                for r in recent[-3:]
            )
            lines.append(f"    recent: {shown}")
    if fleet["dead_hosts"]:
        lines.append(f"dead hosts: {', '.join(fleet['dead_hosts'])}")
    lines.extend(_render_routers(fleet))
    fq = fleet.get("quality") or {}
    if fq.get("drifting_workers"):
        lines.append(
            "quality drift ACTIVE on: "
            + ", ".join(fq["drifting_workers"])
        )
    # Fleet SLO alert line (telemetry.aggregate roll-up): an objective
    # firing on ANY worker fires fleet-wide, deduped per (objective,
    # severity) with the workers it fires on.
    fs = fleet.get("slo") or {}
    for a in fs.get("firing") or ():
        lines.append(
            f"SLO ALERT FIRING: {a['objective']} [{a['severity']}] "
            f"on {', '.join(a['workers'])}"
        )
    queue = fleet.get("queue")
    if queue:
        c = queue["counts"]
        lines.append(
            f"queue: {queue['outdir']}  done={c['done']} "
            f"failed={c['failed']} leased={c['leased']} "
            f"expired={c['lease_expired']} pending={c['pending']}"
        )
    interesting = [
        (k, v) for k, v in sorted(fleet["counters"].items())
        if not k.startswith("kafka_live_")
    ]
    if interesting:
        lines.append("counters (fleet totals):")
        for k, v in interesting[:24]:
            lines.append(f"  {k} {v:g}")
        if len(interesting) > 24:
            lines.append(f"  ... {len(interesting) - 24} more "
                         "(use --json)")
    hists = {
        k: h for k, h in sorted(fleet["histograms"].items())
        if h["count"]
    }
    if hists:
        lines.append("histograms (fleet-merged):")
        for k, h in hists.items():
            p50 = "-" if h["p50"] is None else f"{h['p50']:.4g}"
            p99 = "-" if h["p99"] is None else f"{h['p99']:.4g}"
            lines.append(
                f"  {k}  n={h['count']} p50={p50} p99={p99}"
            )
    if fleet["crash_dumps"]:
        lines.append("crash dumps:")
        for c in fleet["crash_dumps"]:
            lines.append(f"  {c['worker']}: {c['file']}")
    return "\n".join(lines)


def _render_routers(fleet: dict) -> list:
    """The router view: for every ``kafka-route`` worker in the fleet,
    its ring ownership per replica, tiles in flight, the re-route /
    rebalance counters and the last failover timestamp —
    read from the ``router_*`` status facts the router publishes with
    each live snapshot."""
    import datetime

    lines = []
    for w in fleet.get("workers") or ():
        st = w.get("status") or {}
        if w.get("role") != "route" and "router_ring" not in st:
            continue
        failover = st.get("router_last_failover_ts")
        failover_txt = "-" if not failover else \
            datetime.datetime.fromtimestamp(failover).isoformat(
                timespec="seconds"
            )
        lines.append(
            f"router {w['key']}: "
            f"routable={len(st.get('router_routable') or ())}/"
            f"{len(st.get('router_replicas') or ())} "
            f"inflight={st.get('router_inflight', 0)} "
            f"rerouted={st.get('router_rerouted_total', 0)} "
            f"rebalanced={st.get('router_rebalanced_total', 0)} "
            f"last_failover={failover_txt}"
        )
        dead = st.get("router_dead") or []
        if dead:
            lines.append(f"  dead replicas: {', '.join(dead)}")
        ring = st.get("router_ring") or {}
        for rid in sorted(ring):
            tiles = ring[rid]
            shown = ",".join(tiles[:6]) + \
                (",..." if len(tiles) > 6 else "")
            marker = " DEAD" if rid in dead else ""
            lines.append(
                f"  ring {rid}{marker}: {len(tiles)} tile(s)"
                + (f" [{shown}]" if tiles else "")
            )
    return lines


def build_view(root: str, ttl_s=None, queue_dir=None) -> dict:
    """The fleet view dict (the ``--json`` payload), importable for
    tests and other tools."""
    from ..telemetry.aggregate import (
        aggregate_fleet, discover_queue_outdir, load_live_snapshots,
        worker_liveness,
    )

    snaps = load_live_snapshots(root)
    fleet = aggregate_fleet(snaps, ttl_s=ttl_s)
    fleet["telemetry_root"] = os.path.abspath(root)
    queue_dir = queue_dir or discover_queue_outdir(snaps)
    fleet["queue"] = None
    if queue_dir and os.path.isdir(queue_dir):
        from ..shard.queue import queue_status

        status = queue_status(queue_dir)
        liveness = worker_liveness(snaps, ttl_s=ttl_s)
        for owner, w in status["workers"].items():
            w["liveness"] = liveness.get(owner)
        fleet["queue"] = status
    return fleet


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="telemetry root holding live_*.json "
                                 "snapshots (searched recursively)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable dump instead of the summary")
    ap.add_argument("--ttl-s", type=float, default=None,
                    help="heartbeat staleness beyond which a non-final "
                         "snapshot flags its host dead (default: 3x "
                         "each snapshot's own publish interval)")
    ap.add_argument("--queue-dir", default=None,
                    help="lease-queue outdir to fold in (default: "
                         "auto-discovered from worker snapshots)")
    ap.add_argument("--stitch-trace", default=None, metavar="OUT",
                    help="also merge per-process trace.json fragments "
                         "under the root into OUT (one Chrome trace)")
    ap.add_argument("--run-id", default=None,
                    help="only stitch trace fragments carrying this "
                         "run id")
    ap.add_argument("--request-id", default=None,
                    help="with --stitch-trace: stitch ONE request's "
                         "cross-process waterfall (router + replica "
                         "tracks, flow arrows across the hops)")
    ap.add_argument("--watch", type=float, default=None,
                    metavar="SECONDS",
                    help="live dashboard mode: clear the screen and "
                         "re-render every SECONDS until Ctrl-C")
    ap.add_argument("--watch-count", type=int, default=0,
                    help="with --watch: stop after this many redraws "
                         "(0 = until Ctrl-C; the smoke-test hook)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"fleet_status: no such directory: {args.root}",
              file=sys.stderr)
        return 2
    if args.watch is None:
        return _render_once(args)
    # Live dashboard: fixed-cadence redraw, Ctrl-C = clean exit.  The
    # ANSI clear keeps it dependency-free (no curses).
    import time

    n = 0
    try:
        while True:
            print("\x1b[2J\x1b[H", end="")
            _render_once(args)
            n += 1
            if args.watch_count and n >= args.watch_count:
                return 0
            # kafkalint: disable=ad-hoc-retry — fixed-cadence dashboard
            # redraw, not a retry/backoff loop
            time.sleep(max(0.0, args.watch))
    except (KeyboardInterrupt, BrokenPipeError):
        # Ctrl-C, or the consumer of a piped dashboard went away —
        # both are clean ends of a watch session.
        return 0


def _render_once(args) -> int:
    """One view build + render (the body of the non-watch mode and of
    each watch iteration)."""
    fleet = build_view(args.root, ttl_s=args.ttl_s,
                       queue_dir=args.queue_dir)
    if args.stitch_trace:
        from ..telemetry.aggregate import stitch_traces

        doc = stitch_traces(args.root, run_id=args.run_id,
                            request_id=args.request_id)
        with open(args.stitch_trace, "w") as f:
            json.dump(doc, f)
        fleet["stitched_trace"] = {
            "path": os.path.abspath(args.stitch_trace),
            "sources": doc["otherData"]["sources"],
            "events": len(doc["traceEvents"]),
        }
    if args.json:
        print(json.dumps(fleet, indent=2, sort_keys=True))
    else:
        print(render(fleet))
        if fleet.get("stitched_trace"):
            st = fleet["stitched_trace"]
            print(f"stitched trace: {st['path']} "
                  f"({len(st['sources'])} process track(s), "
                  f"{st['events']} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
