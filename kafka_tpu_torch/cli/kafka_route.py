"""``kafka_route`` — the consistent-hash front door of a kafka_serve
fleet (port of ``kafka_tpu/cli/kafka_route.py``, the same flags).

Partitions the tile keyspace across N ``kafka_serve`` replicas with a
stable consistent-hash ring (``serve.router``): clients drop
``{"tile", "date"}`` JSON files into the ROUTER's ``<root>/inbox/`` and
read the ROUTER's ``<root>/responses/<request_id>.json`` — one serving
surface, N daemons behind it.  Every admitted request is journaled
before it is forwarded (a router crash replays unanswered requests on
restart), and because the replicas share a checkpoint root
(``kafka_serve --ckpt-root``), re-routing a tile to another replica is
warm-state migration for free: the new owner resumes from the bytes
the old owner checkpointed.

Fleet awareness (``--fleet-dir``, the live-snapshot root shared by the
replicas' ``--telemetry-dir``): a replica whose heartbeat goes stale
without a clean-shutdown marker is flagged dead within one heartbeat
TTL — its ring segments rebalance to the survivors and its in-flight
requests are re-forwarded; a replica shedding ``queue_full`` is
deprioritised instead of hammered.  Replicas join/leave a RUNNING
router via ``--replicas-file`` (a ``{"rid": "root"}`` JSON re-read on
mtime change).

The router touches no device, so it takes no ``--device`` flag; the
replicas keep theirs (default CUDA).  The ring is the JAX router's, so
either package's router can front either package's replicas.

Usage:
    python -m kafka_tpu_torch.cli.kafka_serve --root /tmp/rep0 \\
        --ckpt-root /tmp/ckpt --telemetry-dir /tmp/fleet/rep0 &
    python -m kafka_tpu_torch.cli.kafka_serve --root /tmp/rep1 \\
        --ckpt-root /tmp/ckpt --telemetry-dir /tmp/fleet/rep1 &
    python -m kafka_tpu_torch.cli.kafka_route --root /tmp/front \\
        --replicas rep0=/tmp/rep0,rep1=/tmp/rep1 --fleet-dir /tmp/fleet &
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from . import add_telemetry_arg, make_console


def parse_replicas(text: str) -> dict:
    """``rid=path,rid=path`` (or bare paths, auto-named rep0..N-1) into
    the ``{replica_id: serve_root}`` map."""
    out = {}
    for i, part in enumerate(p.strip() for p in text.split(",")):
        if not part:
            continue
        if "=" in part:
            rid, _, root = part.partition("=")
        else:
            rid, root = f"rep{i}", part
        out[rid.strip()] = root.strip()
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True,
                    help="router root (inbox/, responses/, "
                         "requests.jsonl live here)")
    ap.add_argument("--replicas", default=None,
                    help="comma-separated rid=serve_root pairs (or bare "
                         "serve roots, auto-named rep0..N-1)")
    ap.add_argument("--replicas-file", default=None,
                    help='{"rid": "serve_root"} JSON, re-read when its '
                         "mtime changes — replicas join/leave a running "
                         "router without a restart")
    ap.add_argument("--fleet-dir", default=None,
                    help="telemetry root holding the replicas' live "
                         "snapshots; dead/shedding replicas are "
                         "detected from it")
    ap.add_argument("--ttl-s", type=float, default=None,
                    help="heartbeat staleness beyond which a replica is "
                         "dead (default: 3x each snapshot's own publish "
                         "interval)")
    ap.add_argument("--refresh-s", type=float, default=1.0,
                    help="fleet-view refresh cadence")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="deprioritise replicas whose live queue-depth "
                         "gauge is at or past this bound")
    ap.add_argument("--retry-after-s", type=float, default=0.5,
                    help="backoff hint on router-level rejections")
    ap.add_argument("--shed-slo", action="store_true",
                    help="shed new submissions (reason slo_burn) while "
                         "any PAGE-severity SLO alert fires on the "
                         "router's registry (telemetry.slo)")
    ap.add_argument("--poll-interval-s", type=float, default=0.05,
                    help="inbox/response scan cadence")
    ap.add_argument("--exit-when-idle", action="store_true",
                    help="exit 0 once the journal is replayed and the "
                         "inbox/in-flight set stay empty for "
                         "--idle-grace-s")
    ap.add_argument("--idle-grace-s", type=float, default=1.0)
    ap.add_argument("--http-port", type=int, default=0,
                    help="live metrics endpoint port (/metrics, "
                         "/healthz, /statusz with the router view; "
                         "0 = disabled)")
    ap.add_argument("--live-interval-s", type=float, default=None,
                    help="live_<host>_<pid>.json heartbeat cadence")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="kernel build cache directory (default: the "
                         "checkout's build/kafka_tpu_torch; the router "
                         "itself builds nothing, but keeping the flag "
                         "uniform lets one wrapper script configure the "
                         "whole fleet)")
    add_telemetry_arg(ap)
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING
    )
    from ..utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache(cache_dir=args.compile_cache_dir)
    if not args.replicas and not args.replicas_file:
        print("kafka-route: need --replicas and/or --replicas-file",
              file=sys.stderr)
        raise SystemExit(2)
    from ..resilience import faults
    from ..serve.router import RoutePolicy, TileRouter
    from ..telemetry import (
        configure, flight_recorder, get_registry, live, slo, tracing,
    )
    from ..telemetry.httpd import maybe_start

    if args.telemetry_dir:
        configure(args.telemetry_dir)
    recorder = flight_recorder.install(args.telemetry_dir)
    faults.install_from_env()
    os.makedirs(args.root, exist_ok=True)
    replicas = parse_replicas(args.replicas) if args.replicas else {}
    if args.replicas_file and os.path.exists(args.replicas_file):
        with open(args.replicas_file) as f:
            replicas.update(json.load(f))
    policy = RoutePolicy(
        refresh_s=args.refresh_s,
        ttl_s=args.ttl_s,
        max_queue_depth=args.max_queue_depth,
        retry_after_s=args.retry_after_s,
        shed_on_slo=args.shed_slo,
    )
    router = TileRouter(
        replicas, args.root,
        fleet_dir=args.fleet_dir,
        policy=policy,
        poll_interval_s=args.poll_interval_s,
        exit_when_idle=args.exit_when_idle,
        idle_grace_s=args.idle_grace_s,
        replicas_file=args.replicas_file,
    )
    reg = get_registry()
    with tracing.push(run_id=tracing.new_run_id()), recorder:
        live.update_status(router_root=os.path.abspath(args.root))
        live.start_publisher(role="route",
                             interval_s=args.live_interval_s)
        # SLO evaluator over the router's registry: availability here
        # means the whole fleet behind the front door (the router's
        # latency/rejection counters are client-visible totals).
        slo.start_engine()
        httpd = maybe_start(args.http_port,
                            status_provider=router.status,
                            role="route")
        try:
            summary = router.run()
        finally:
            slo.stop_engine()
            live.stop_publisher()
            if httpd is not None:
                httpd.close()
    summary["failed"] = 0
    summary["http_port"] = None if httpd is None else httpd.port
    summary["telemetry_dir"] = reg.dump()
    print(json.dumps(summary))
    return summary


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
