"""Chunk worker subprocess: one chunk (OOM recovery) or a whole queue
(port of ``kafka_tpu/cli/chunk_worker.py``).

**Single-chunk mode** (positional args — emitted by
``drivers.run_one_chunk_resilient``, not user-facing): after a device
OOM the parent's CUDA context is treated as poisoned, so the failed
chunk and its quarters run in fresh processes with their own contexts.
This module is that fresh process: it runs exactly one chunk via
``run_one_chunk`` and reports the summary as one JSON line on stdout.

Exit codes: 0 success (JSON on stdout; ``null`` for an empty-mask chunk),
17 device OOM (the parent splits and retries), anything else = real error
(propagated by the parent).

    python -m kafka_tpu_torch.cli.chunk_worker <config.json> <x0> <y0> \\
        <nx_valid> <ny_valid> <chunk_no> <prefix> [--device cpu]

**Queue mode** (``--queue``): the process becomes one self-healing worker
claiming chunks from the config's ``output_folder`` via lease files
(``shard.run_queue``).  Run one per host against a shared filesystem; a
worker that dies has its chunks reclaimed by the survivors.
``--num-workers N`` spawns a local N-process fleet from this one command:

    python -m kafka_tpu_torch.cli.chunk_worker --queue config.json \\
        --lease-ttl-s 30 --num-workers 4

Queue-mode exit codes: 0 all chunks done (or a clean SIGTERM drain), 75
when chunks were quarantined (partial success — rerun after fixing).
Every mode runs on CUDA unless ``--device cpu``.  ``--http-port`` serves
the live metrics endpoint of a queue worker (a local fleet gives worker
i port+i).  Both modes install the flight recorder, publish live
snapshots and run the SLO engine when the config names a telemetry
directory (the one-chunk mode under ``chunk_<prefix>/`` of it).
"""

from __future__ import annotations

import json
import os
import sys

OOM_EXIT_CODE = 17


def _queue_main(argv) -> int:
    """``--queue`` worker mode (see module docstring)."""
    import argparse
    import subprocess

    from . import add_device_arg

    ap = argparse.ArgumentParser(
        prog="chunk_worker --queue",
        description="self-healing queue worker over a RunConfig",
    )
    ap.add_argument("config", help="RunConfig JSON")
    ap.add_argument("--lease-ttl-s", type=float, default=None,
                    help="heartbeat-lease TTL; a worker silent this long "
                         "is presumed dead and its chunk is reclaimed")
    ap.add_argument("--num-workers", type=int, default=1,
                    help="local fleet size (N>1 spawns N single-worker "
                         "subprocesses of this command and waits)")
    ap.add_argument("--http-port", type=int, default=0,
                    help="live metrics endpoint port (/metrics /healthz "
                         "/statusz; 0 = disabled; a local fleet gives "
                         "worker i port+i)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    from .. import resolve_device

    resolve_device(args.device)  # CUDA unless asked; raises without it

    if args.num_workers > 1:
        cmd = [sys.executable, "-m", "kafka_tpu_torch.cli.chunk_worker",
               "--queue", args.config, "--num-workers", "1"]
        if args.lease_ttl_s is not None:
            cmd += ["--lease-ttl-s", str(args.lease_ttl_s)]
        if args.device is not None:
            cmd += ["--device", args.device]
        from .drivers import child_env

        env = child_env()
        # All workers join one trace: new_run_id() picks this up.
        env.setdefault("KAFKA_TPU_RUN_ID", os.urandom(6).hex())
        procs = []
        for i in range(args.num_workers):
            worker_cmd = list(cmd)
            if args.http_port:
                # One endpoint per worker process.
                worker_cmd += ["--http-port", str(args.http_port + i)]
            procs.append(subprocess.Popen(worker_cmd, env=env))
        rcs = [p.wait() for p in procs]
        hard = [rc for rc in rcs if rc not in (0, 75)]
        if hard:
            return hard[0]
        return 75 if 75 in rcs else 0

    from ..engine.config import RunConfig
    from ..telemetry.httpd import maybe_start
    from .drivers import resolve_aux_builder, run_config

    cfg = RunConfig.load(args.config)
    httpd = maybe_start(args.http_port, role="queue_worker")
    try:
        stats = run_config(cfg, resolve_aux_builder(cfg, args.device),
                           queue=True, lease_ttl_s=args.lease_ttl_s,
                           device=args.device)
    finally:
        if httpd is not None:
            httpd.close()
    print(json.dumps(stats))
    if stats.get("failed"):
        from ..resilience import EXIT_PARTIAL_SUCCESS

        return EXIT_PARTIAL_SUCCESS
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--queue" in argv:
        argv.remove("--queue")
        return _queue_main(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    cfg_path, x0, y0, nx, ny, chunk_no, prefix = argv
    from ..engine.config import RunConfig
    from ..io.tiling import Chunk
    from ..resilience import faults
    from ..telemetry import (configure, flight_recorder, get_registry,
                             install_compile_listeners, live, slo, tracing)
    from ..utils.compilation_cache import enable_compilation_cache
    from .drivers import (_is_oom, load_state_mask, resolve_aux_builder,
                          run_one_chunk)

    enable_compilation_cache()
    install_compile_listeners()
    # Chaos specs propagate into chunk workers through the environment,
    # so a KAFKA_TPU_FAULTS run exercises the subprocess path too (call
    # counters are per process — spec call numbers are worker-local).
    faults.install_from_env()
    cfg = RunConfig.load(cfg_path)
    # Per-chunk telemetry subdirectory: this fresh process must not
    # interleave its events/trace with the parent scheduler's files.
    tel_dir = None
    if cfg.telemetry_dir:
        tel_dir = os.path.join(cfg.telemetry_dir, f"chunk_{prefix}")
        configure(tel_dir)
    recorder = flight_recorder.install(tel_dir)
    chunk = Chunk(int(x0), int(y0), int(nx), int(ny), int(chunk_no))
    full_mask, geo = load_state_mask(cfg)
    # new_run_id() picks up KAFKA_TPU_RUN_ID from the parent scheduler,
    # so this worker's spans and crash dumps correlate with its trace.
    with tracing.push(run_id=tracing.new_run_id(), chunk_id=prefix):
        live.start_publisher(role="chunk_worker")
        # SLO evaluator: solver/quality burn over this worker's registry,
        # alerts.jsonl next to its chunk telemetry.
        slo.start_engine()
        try:
            with recorder:
                summary = run_one_chunk(
                    cfg, chunk, prefix, full_mask, geo,
                    resolve_aux_builder(cfg, device), device=device,
                )
        except Exception as exc:  # noqa: BLE001 — classified for parent
            if _is_oom(exc):
                print(str(exc)[:500], file=sys.stderr)
                return OOM_EXIT_CODE
            raise
        finally:
            slo.stop_engine()
            live.stop_publisher()
    get_registry().dump()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
