"""``kafka_serve`` — the resident assimilation-as-a-service daemon (port
of ``kafka_tpu/cli/kafka_serve.py``, one daemon).

Serves observation-date requests against warm per-tile filter state on
``--device`` (default CUDA): clients drop ``{"tile", "date"}`` JSON files
into ``<root>/inbox/`` (atomic rename; ``serve.submit_request`` does it
for you) and read ``<root>/responses/<request_id>.json``.  A new
observation date costs only the grid windows after the tile's newest
checkpoint.  Compatible concurrent requests coalesce into one device
round (``--batch-window-ms``, ``--max-batch``).

Robustness surface: admission control + load shedding (``--max-queue``,
``--max-writer-backlog``, ``--max-prefetch-depth``, the health gauge);
per-request deadlines (``--deadline-s``); SIGTERM = graceful drain,
SIGKILL = crash recovered on restart by replaying ``requests.jsonl``;
chaos-scriptable via ``KAFKA_TPU_FAULTS`` at the ``serve.admit`` /
``serve.solve`` / ``serve.respond`` fault points; events.jsonl rotation.

Start-up warms every shape bucket (``serve.batch.aot_compile_buckets``:
the kernel builds and one run of each bucket's program) before the
first request is admitted, unless ``--no-aot``.

Not ported yet, and refused when set away from their defaults: the
flags whose JAX meaning needs the device plane (ROADMAP.md, Queue 1) —
``--http-port``, ``--live-interval-s``, ``--fleet-dir``,
``--max-dead-hosts``, ``--shed-slo``, ``--slo-fast-window-s``,
``--slo-slow-window-s``, ``--slo-interval-s`` — and
``--compile-cache-dir`` (nothing is compiled per shape in the port).
The flight recorder is left out, as ``cli/drivers.py:run_config``
leaves it out.

This driver serves SYNTHETIC tiles (like ``run_synthetic``); production
sources plug into the same ``AssimilationService`` programmatically
with real ``TileSpec``s.

Usage:
    python -m kafka_tpu_torch.cli.kafka_serve --root /tmp/serve \\
        --tiles 2 --operator identity --device cpu --exit-when-idle
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from . import add_device_arg, add_telemetry_arg, make_console

#: flags whose JAX meaning needs a module of the device-plane slice, with
#: the default that passes.
_NOT_PORTED = {
    "http_port": 0,
    "live_interval_s": None,
    "fleet_dir": None,
    "max_dead_hosts": None,
    "shed_slo": False,
    "slo_fast_window_s": None,
    "slo_slow_window_s": None,
    "slo_interval_s": None,
    "compile_cache_dir": None,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True,
                    help="serve root (inbox/, responses/, requests.jsonl,"
                         " ckpt_<tile>/ live here)")
    ap.add_argument("--tiles", type=int, default=1,
                    help="number of synthetic tiles to serve "
                         "(tile0..tileN-1)")
    ap.add_argument("--ckpt-root", default=None,
                    help="directory holding the ckpt_<tile>/ checkpoint "
                         "sets (default: --root)")
    ap.add_argument("--operator", default="identity",
                    choices=("identity", "twostream", "wcm"))
    ap.add_argument("--ny", type=int, default=20)
    ap.add_argument("--nx", type=int, default=20)
    ap.add_argument("--days", type=int, default=16)
    ap.add_argument("--step", type=int, default=4,
                    help="time-grid step in days")
    ap.add_argument("--obs-every", type=int, default=2,
                    help="observation cadence in days")
    ap.add_argument("--scan-window", type=int, default=1,
                    help="temporal fusion window (1 = unfused, the "
                         "bit-exact serving configuration)")
    ap.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="admission micro-window: hold a dequeued "
                         "request up to this long while shape-"
                         "compatible peers arrive, then serve the "
                         "group as one coalesced device round "
                         "(bit-identical to sequential serving; "
                         "0 disables)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="coalesced-round member cap")
    ap.add_argument("--compile-cache-dir", default=None,
                    help="not ported (the JAX package's persistent XLA "
                         "compilation cache)")
    ap.add_argument("--aot-buckets", default="1",
                    help="comma-separated batch sizes to warm per shape "
                         "bucket at startup")
    ap.add_argument("--no-aot", action="store_true",
                    help="skip the startup bucket warm-up (first "
                         "requests pay the kernel builds)")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="admission bound on the request queue; beyond "
                         "it requests are shed with reason queue_full")
    ap.add_argument("--max-writer-backlog", type=int, default=256,
                    help="shed when the async writer backlog gauge "
                         "exceeds this (0 disables)")
    ap.add_argument("--max-prefetch-depth", type=int, default=256,
                    help="shed when the prefetch queue-depth gauge "
                         "exceeds this (0 disables)")
    ap.add_argument("--no-shed-unhealthy", action="store_true",
                    help="keep admitting while the health probe verdict "
                         "is off-band")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request wall-clock budget; "
                         "expired requests are cancelled and counted")
    ap.add_argument("--poll-interval-s", type=float, default=0.05,
                    help="inbox scan cadence")
    ap.add_argument("--exit-when-idle", action="store_true",
                    help="exit 0 once the journal is replayed and the "
                         "inbox/queue stay empty for --idle-grace-s "
                         "(one-shot recovery / batch mode)")
    ap.add_argument("--idle-grace-s", type=float, default=1.0)
    ap.add_argument("--events-rotate-mb", type=float, default=32.0,
                    help="rotate events.jsonl past this size")
    ap.add_argument("--events-keep", type=int, default=3,
                    help="rotated events.jsonl segments kept")
    ap.add_argument("--journal-rotate-mb", type=float, default=64.0,
                    help="compact requests.jsonl past this size "
                         "(0 disables)")
    ap.add_argument("--journal-keep", type=int, default=3,
                    help="rotated requests.jsonl segments kept")
    ap.add_argument("--http-port", type=int, default=0,
                    help="not ported (the live HTTP endpoint); 0 only")
    ap.add_argument("--live-interval-s", type=float, default=None,
                    help="not ported (the live heartbeat publisher)")
    ap.add_argument("--fleet-dir", default=None,
                    help="not ported (the fleet's live snapshots)")
    ap.add_argument("--max-dead-hosts", type=int, default=None,
                    help="not ported (needs --fleet-dir)")
    ap.add_argument("--shed-quality-drift", action="store_true",
                    help="shed requests (reason quality_degraded) "
                         "while any quality drift sentinel is alarming")
    ap.add_argument("--shed-slo", action="store_true",
                    help="not ported (the SLO engine)")
    ap.add_argument("--slo-fast-window-s", type=float, default=None,
                    help="not ported (the SLO engine)")
    ap.add_argument("--slo-slow-window-s", type=float, default=None,
                    help="not ported (the SLO engine)")
    ap.add_argument("--slo-interval-s", type=float, default=None,
                    help="not ported (the SLO engine)")
    add_device_arg(ap)
    add_telemetry_arg(ap)
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    for name, default in _NOT_PORTED.items():
        if getattr(args, name) != default:
            raise SystemExit(
                f"kafka_serve: --{name.replace('_', '-')} is not ported "
                "yet (it needs the device-plane slice, ROADMAP.md "
                "Queue 1); leave it at its default")
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING
    )
    from .. import resolve_device
    from ..resilience import faults
    from ..serve import (
        AdmissionPolicy, AssimilationService, ServeDaemon, TileSession,
        make_synthetic_tile,
    )
    from ..serve import batch as serve_batch
    from ..telemetry import configure, get_registry, live, tracing

    device = resolve_device(args.device)
    if args.telemetry_dir:
        configure(
            args.telemetry_dir,
            events_rotate_bytes=int(args.events_rotate_mb * 1024 * 1024),
            events_keep=args.events_keep,
        )
    faults.install_from_env()
    os.makedirs(args.root, exist_ok=True)
    ckpt_root = args.ckpt_root or args.root
    sessions = {}
    for i in range(max(1, args.tiles)):
        name = f"tile{i}"
        spec = make_synthetic_tile(
            name, ckpt_dir=os.path.join(ckpt_root, f"ckpt_{name}"),
            operator=args.operator, ny=args.ny, nx=args.nx,
            days=args.days, step_days=args.step,
            obs_every=args.obs_every, scan_window=args.scan_window,
            seed=i, device=device,
        )
        sessions[name] = TileSession(spec)
    policy = AdmissionPolicy(
        max_queue_depth=args.max_queue,
        max_prefetch_queue_depth=(
            args.max_prefetch_depth if args.max_prefetch_depth > 0
            else None
        ),
        max_writer_backlog=(
            args.max_writer_backlog if args.max_writer_backlog > 0
            else None
        ),
        shed_when_unhealthy=not args.no_shed_unhealthy,
        shed_on_quality_drift=args.shed_quality_drift,
    )
    # Bucket warm-up: build the kernels and run every resident shape
    # bucket's program (solo plus each --aot-buckets batch size) BEFORE
    # the daemon admits a request.
    aot_manifest = None
    if not args.no_aot:
        sizes = tuple(
            int(s) for s in str(args.aot_buckets).split(",") if s.strip()
        ) or (1,)
        aot_manifest = serve_batch.aot_compile_buckets(
            sessions, batch_sizes=sizes
        )
    service = AssimilationService(
        sessions, args.root, policy=policy,
        default_deadline_s=args.deadline_s,
        journal_rotate_bytes=(
            int(args.journal_rotate_mb * 1024 * 1024)
            if args.journal_rotate_mb > 0 else None
        ),
        journal_keep=args.journal_keep,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
    )
    daemon = ServeDaemon(
        service, args.root,
        poll_interval_s=args.poll_interval_s,
        exit_when_idle=args.exit_when_idle,
        idle_grace_s=args.idle_grace_s,
    )
    reg = get_registry()
    with tracing.push(run_id=tracing.new_run_id()):
        live.update_status(serve_root=os.path.abspath(args.root),
                           tiles=sorted(sessions),
                           serve_aot_buckets=aot_manifest)
        summary = daemon.run()
    # Request-level errors completed the run but lost work — surface the
    # partial-success exit code the other drivers use.
    summary["failed"] = summary["errors"]
    summary["serve_aot_buckets"] = aot_manifest
    summary["telemetry_dir"] = reg.dump()
    print(json.dumps(summary))
    return summary


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
