"""End-to-end synthetic driver (port of ``kafka_tpu/cli/run_synthetic.py``).

Runs the complete pipeline — mask, prior, operator, multi-date filter run
through the engine's default configuration (prefetch, temporal fusion,
the exact information-filter propagator), GeoTIFF outputs — on generated
data, and prints one JSON summary line (``n_pixels``, ``mean_iterations``,
``operator``, ``n_dates``, ``n_timesteps``, ``wall_s``,
``pixel_steps_per_s``, ``outputs_written``, ``outdir``,
``telemetry_dir``).  The arguments, the generated mask, grid and
observations are the JAX driver's.

Usage:
    python -m kafka_tpu_torch.cli.run_synthetic --operator twostream \\
        --outdir /tmp/kafka_out --days 16 --step 4

``--device`` defaults to CUDA (and fails without a card); ``--device
cpu`` runs on the CPU.  ``--scan-window`` sets the engine's temporal
fusion (default 8, the engine default; 1 runs every window unfused).
``--operator wcm`` runs the SAR-only Water-Cloud state (2 parameters,
VV and VH at a 23 degree incidence angle).

``--chunk-size N`` routes the run through the restart-safe chunk
scheduler (``shard.run_chunks``) with quarantine on — one KalmanFilter
per NxN chunk, prefixed outputs, per-chunk retry — the chaos harness of
the fault-tolerance layer: script failures with ``KAFKA_TPU_FAULTS`` and
the run completes with exit code 75 (partial success) when chunks were
quarantined, while unaffected chunks produce bit-identical outputs.
``--queue`` makes chunked mode the self-healing lease-based queue
(``shard.run_queue``): workers claim chunks through heartbeat leases and
reclaim a dead worker's expired leases.  ``--num-workers N`` makes a
local N-process fleet of this one command (SIGKILL a worker and the
survivors finish its chunks; SIGTERM drains a worker).  The summary
lines are the JAX driver's (``mode`` "chunked", "queue" or
"queue-fleet").

The device plane as in the JAX driver: ``--http-port`` serves the live
endpoint (``telemetry.httpd``: ``/metrics``, ``/healthz``, ``/statusz``,
``/profilez``, ``/kernelz``, ``/meshz``, ...; a local fleet gives worker
i port+i), ``--profile-windows N`` captures a ``torch.profiler`` trace of
the first N assimilated windows into ``<telemetry-dir>/profile``, and a
run with ``--telemetry-dir`` installs the flight recorder, publishes live
snapshots and runs the SLO engine.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.propagators import PixelPrior, propagate_information_filter
from ..engine.checkpoint import Checkpointer
from ..engine.filter import KalmanFilter
from ..engine.priors import TIP_PARAMETER_LIST, FixedGaussianPrior, jrc_prior
from ..io import GeoTIFFOutput, read_geotiff
from ..obsops import IdentityOperator, TwoStreamOperator, WCMAux, WCMOperator
from ..testing.fixtures import DEFAULT_GEO, make_pivot_mask
from ..testing.synthetic import SyntheticObservations
from . import add_device_arg, add_telemetry_arg, make_console


def build_operator(name: str, device):
    """``(operator, parameter_list, prior, truth_value, aux_fn, sigma)``
    of the JAX driver's ``build_operator``, with the prior and the aux on
    ``device``."""
    dev = resolve_device(device)
    if name == "identity":
        op = IdentityOperator(n_params=2, obs_indices=(0, 1))
        params = ("a", "b")
        prior = FixedGaussianPrior(_iso_prior(2, 0.5, 0.4, dev), params)
        truth_val = np.array([0.3, 0.7], np.float32)
        sigma = 0.02
    elif name == "twostream":
        op = TwoStreamOperator()
        params = TIP_PARAMETER_LIST
        prior = jrc_prior(dev)
        truth_val = prior.prior.mean.cpu().numpy().copy()
        truth_val[6] = 0.5  # TLAI target
        sigma = 0.002
    elif name == "wcm":
        op = WCMOperator()
        params = ("lai", "sm")
        prior = FixedGaussianPrior(
            _mean_prior(np.array([1.5, 0.25], np.float32),
                        np.array([1.0, 0.2], np.float32), dev),
            params,
        )
        truth_val = np.array([2.2, 0.32], np.float32)
        sigma = 0.002
        return op, params, prior, truth_val, _wcm_aux_fn(dev), sigma
    else:
        raise SystemExit(f"unknown operator {name!r}")
    return op, params, prior, truth_val, None, sigma


def _wcm_aux_fn(device):
    """The date's ``WCMAux``: a 23 degree incidence angle on every pixel
    of the batch."""
    def aux_fn(date, gather):
        return WCMAux(theta_deg=torch.full((gather.n_pad,), 23.0,
                                           dtype=torch.float32,
                                           device=device))
    return aux_fn


def _mean_prior(mean, sigma, device):
    cov = np.diag(sigma**2).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return PixelPrior(mean=t(mean), cov=t(cov),
                      inv_cov=t(np.linalg.inv(cov)))


def _iso_prior(p, mean, sigma, device):
    cov = np.diag(np.full(p, sigma**2)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return PixelPrior(mean=t(np.full((p,), mean, np.float32)), cov=t(cov),
                      inv_cov=t(np.linalg.inv(cov)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--operator", default="twostream",
                    choices=("identity", "twostream", "wcm"))
    ap.add_argument("--outdir", default="/tmp/kafka_tpu_synthetic")
    ap.add_argument("--mask", default=None,
                    help="GeoTIFF state mask (default: generated pivots)")
    ap.add_argument("--ny", type=int, default=204)
    ap.add_argument("--nx", type=int, default=235)
    ap.add_argument("--days", type=int, default=16)
    ap.add_argument("--step", type=int, default=4,
                    help="time-grid step in days")
    ap.add_argument("--obs-every", type=int, default=2,
                    help="observation cadence in days")
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="run as NxN chunks through the restart-safe "
                         "scheduler with quarantine on (0 = one run)")
    ap.add_argument("--queue", action="store_true",
                    help="claim chunks from the self-healing lease-based "
                         "queue (shard.run_queue) instead of static "
                         "assignment; requires --chunk-size")
    ap.add_argument("--lease-ttl-s", type=float, default=None,
                    help="queue-mode heartbeat-lease TTL; a worker "
                         "silent this long is presumed dead and its "
                         "chunk is reclaimed")
    ap.add_argument("--num-workers", type=int, default=1,
                    help="queue-mode local fleet size: N>1 spawns N "
                         "single-worker subprocesses of this command "
                         "over one shared queue and waits")
    ap.add_argument("--chunk-attempts", type=int, default=2,
                    help="attempts per chunk under the scheduler retry "
                         "policy (chunked mode)")
    ap.add_argument("--chunk-deadline-s", type=float, default=None,
                    help="per-chunk wall-clock deadline; over-budget "
                         "chunks are quarantined (chunked mode)")
    ap.add_argument("--read-attempts", type=int, default=3,
                    help="attempts per observation read before the date "
                         "degrades to predict-only")
    ap.add_argument("--retry-delay-s", type=float, default=0.25,
                    help="base backoff delay for read retries "
                         "(deterministic, jitter-free schedule)")
    ap.add_argument("--max-degraded-dates", type=int, default=8,
                    help="degraded-date budget per filter run before "
                         "aborting")
    ap.add_argument("--http-port", type=int, default=0,
                    help="live metrics endpoint port (/metrics /healthz "
                         "/statusz /profilez; 0 = disabled; fleet mode "
                         "gives worker i port+i)")
    ap.add_argument("--profile-windows", type=int, default=0,
                    help="capture a torch.profiler trace of the first N "
                         "assimilated windows into <telemetry-dir>/"
                         "profile (0 = off; one capture at a time)")
    ap.add_argument("--scan-window", type=int, default=8,
                    help="temporal fusion: windows per fused block "
                         "(1 = unfused)")
    add_device_arg(ap)
    add_telemetry_arg(ap)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.queue and args.chunk_size <= 0:
        ap.error("--queue requires --chunk-size")
    return args


def main(argv=None):
    from ..resilience import RetryPolicy, faults
    from ..telemetry import (configure, flight_recorder, get_registry,
                             install_compile_listeners, live, perf, slo,
                             tracing)
    from ..telemetry.httpd import maybe_start
    from ..utils.compilation_cache import enable_compilation_cache

    raw_argv = list(sys.argv[1:] if argv is None else argv)
    enable_compilation_cache()
    args = parse_args(raw_argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)
    device = resolve_device(args.device)
    if args.queue and args.num_workers > 1:
        # Local fleet: the parent only spawns, waits and summarises; the
        # children are single-worker copies of this command over the one
        # shared filesystem queue.
        return _run_fleet(args, raw_argv)
    install_compile_listeners()
    if args.telemetry_dir:
        configure(args.telemetry_dir)
    recorder = flight_recorder.install(args.telemetry_dir)
    httpd = maybe_start(args.http_port, role="engine")
    if args.profile_windows > 0:
        # Windowed profiler capture (telemetry.perf): starts now, stops
        # itself after N assimilated windows; the finally below is the
        # safety net for runs shorter than N.
        perf.start_windowed_capture(
            args.profile_windows,
            os.path.join(args.telemetry_dir or args.outdir, "profile"),
        )
    # Fault injection: KAFKA_TPU_FAULTS scripts failures at the fault
    # points (resilience.faults).
    faults.install_from_env()
    read_policy = RetryPolicy(
        max_attempts=max(1, args.read_attempts),
        base_delay=args.retry_delay_s, multiplier=2.0, jitter=0.0,
    )
    if args.mask:
        mask_arr, info = read_geotiff(args.mask)
        mask = mask_arr.astype(bool)
        geo = info.geo
    else:
        mask = make_pivot_mask(args.ny, args.nx)
        geo = DEFAULT_GEO

    os.makedirs(args.outdir, exist_ok=True)
    base = datetime.datetime(2017, 7, 1)
    obs_dates = [base + datetime.timedelta(days=d)
                 for d in range(1, args.days, args.obs_every)]
    time_grid = [base + datetime.timedelta(days=d)
                 for d in range(0, args.days + args.step, args.step)]

    op, params, prior, truth_val, aux_fn, sigma = build_operator(
        args.operator, device)
    truth = np.broadcast_to(
        truth_val, mask.shape + (len(truth_val),)).astype(np.float32)

    t0 = time.time()
    run = _run_chunked if args.chunk_size > 0 else _run_single
    # One trace context for the run; the recorder guard turns a mid-run
    # death into a crash_<ts>.json next to the other telemetry artifacts.
    with tracing.push(run_id=tracing.new_run_id()), recorder:
        # Live heartbeat (no-op without --telemetry-dir) and the SLO
        # evaluator over this run's registry.
        live.start_publisher(
            role="queue_worker" if args.queue else "engine")
        slo.start_engine()
        try:
            summary = run(args, mask, geo, op, params, prior, truth,
                          aux_fn, sigma, obs_dates, time_grid, read_policy,
                          device)
        finally:
            perf.stop_windowed_capture()
            slo.stop_engine()
            live.stop_publisher()
            if httpd is not None:
                httpd.close()
    wall = time.time() - t0

    summary["operator"] = args.operator
    summary["n_dates"] = len(obs_dates)
    summary["n_timesteps"] = len(time_grid) - 1
    summary["wall_s"] = round(wall, 3)
    summary["pixel_steps_per_s"] = round(
        summary["n_pixels"] * len(obs_dates) / wall, 1)
    summary["outputs_written"] = len(
        [f for f in os.listdir(args.outdir) if f.endswith(".tif")])
    summary["outdir"] = args.outdir
    reg = get_registry()
    reg.emit("run_done", **summary)
    summary["telemetry_dir"] = reg.dump()
    print(json.dumps(summary))
    return summary


def _make_filter(args, sub_mask, output, op, params, obs, read_policy,
                 device=None):
    """The driver's filter: the exact information-filter propagator, no
    prior blend, relaxation 0.5, Q = 1e-3 per parameter, the engine's
    defaults otherwise (``--scan-window`` sets the fusion)."""
    kf = KalmanFilter(
        obs, output, sub_mask, params,
        state_propagation=propagate_information_filter,
        prior=None,
        solver_options={"relaxation": 0.5},
        scan_window=getattr(args, "scan_window", 8),
        read_retry_policy=read_policy,
        max_degraded_dates=args.max_degraded_dates,
        device=device,
    )
    kf.set_trajectory_model()
    kf.set_trajectory_uncertainty(np.full(len(params), 1e-3, np.float32))
    return kf


def _run_single(args, mask, geo, op, params, prior, truth, aux_fn, sigma,
                obs_dates, time_grid, read_policy, device) -> dict:
    observations = SyntheticObservations(
        dates=obs_dates, operator=op, truth_fn=lambda date: truth,
        sigma=sigma, aux_fn=aux_fn, mask_prob=0.1, device=device,
    )
    output = GeoTIFFOutput(
        params, geo.geotransform, geo.projection, args.outdir,
        epsg=geo.epsg, async_writes=True,
    )
    try:
        kf = _make_filter(args, mask, output, op, params, observations,
                          read_policy, device)
        x0, p_inv0 = prior.process_prior(None, kf.gather)
        ck = Checkpointer(os.path.join(args.outdir, "ckpt")) \
            if args.checkpoint else None
        kf.run(time_grid, x0, None, p_inv0, checkpointer=ck)
    finally:
        output.close()
    return {
        "n_pixels": int(kf.gather.n_valid),
        "mean_iterations": round(float(np.mean(
            [d["n_iterations"] for d in kf.diagnostics_log] or [0])), 2),
    }


def _run_chunked(args, mask, geo, op, params, prior, truth, aux_fn, sigma,
                 obs_dates, time_grid, read_policy, device) -> dict:
    """The chunk-scheduler path: one filter per NxN chunk with prefixed
    outputs, per-chunk retry and quarantine (exit code 75 when chunks end
    up quarantined), statically assigned or — ``--queue`` — claimed from
    the lease-based queue."""
    from ..io.tiling import chunk_geotransform, chunk_mask, get_chunks
    from ..resilience import RetryPolicy
    from ..shard.scheduler import run_chunks

    ny, nx = mask.shape
    chunks = list(get_chunks(nx, ny, (args.chunk_size, args.chunk_size)))
    # Keyed by prefix, not appended: at-least-once execution (queue-mode
    # commit retries, reclaimed chunks) may run a chunk twice.
    summaries = {}

    def run_one(chunk, prefix):
        sub_mask = chunk_mask(mask, chunk)
        if not sub_mask.any():
            return
        sub_truth = np.ascontiguousarray(
            truth[chunk.y0:chunk.y0 + chunk.ny_valid,
                  chunk.x0:chunk.x0 + chunk.nx_valid])
        obs = SyntheticObservations(
            dates=obs_dates, operator=op,
            truth_fn=lambda date: sub_truth, sigma=sigma, aux_fn=aux_fn,
            mask_prob=0.1, device=device,
        )
        output = GeoTIFFOutput(
            params, chunk_geotransform(geo.geotransform, chunk),
            geo.projection, args.outdir, prefix=prefix, epsg=geo.epsg,
            async_writes=True,
        )
        try:
            kf = _make_filter(args, sub_mask, output, op, params, obs,
                              read_policy, device)
            x0, p_inv0 = prior.process_prior(None, kf.gather)
            ck = Checkpointer(os.path.join(args.outdir, "ckpt"),
                              prefix=f"{prefix}_") \
                if args.checkpoint else None
            kf.run(time_grid, x0, None, p_inv0, checkpointer=ck)
        finally:
            # A failed attempt must not leak the async writer thread into
            # the retry.
            output.close()
        summaries[prefix] = {"prefix": prefix,
                             "n_pixels": int(kf.gather.n_valid)}

    policy = RetryPolicy(
        max_attempts=max(1, args.chunk_attempts),
        base_delay=args.retry_delay_s, multiplier=2.0, jitter=0.0,
    ) if args.chunk_attempts > 1 else None
    if args.queue:
        from ..shard.queue import DEFAULT_LEASE_TTL_S, run_queue

        stats = run_queue(
            chunks, run_one, args.outdir,
            lease_ttl_s=(args.lease_ttl_s if args.lease_ttl_s
                         else DEFAULT_LEASE_TTL_S),
            retry_policy=policy, quarantine=True,
            chunk_deadline_s=args.chunk_deadline_s,
        )
        return {
            "mode": "queue", "worker": stats["worker"],
            "chunks_total": stats["total"], "chunks_run": stats["run"],
            "reclaimed": stats["reclaimed"], "skipped": stats["skipped"],
            "failed": stats["failed"], "drained": stats["drained"],
            "pending": stats["pending_at_exit"],
            "n_pixels": _pixels(summaries),
        }
    stats = run_chunks(
        chunks, run_one, args.outdir, num_processes=1, process_index=0,
        retry_policy=policy, quarantine=True,
        chunk_deadline_s=args.chunk_deadline_s,
    )
    return {
        "mode": "chunked", "chunks_assigned": stats["assigned"],
        "chunks_run": stats["run"], "skipped": stats["skipped"],
        "failed": stats["failed"], "n_pixels": _pixels(summaries),
    }


def _pixels(summaries: dict) -> int:
    return int(sum(s["n_pixels"] for s in summaries.values()))


def _strip_flag(argv, name, has_value=True):
    """Remove ``name <v>`` / ``name=<v>`` occurrences from an argv list."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok == name:
            skip = has_value
            continue
        if tok.startswith(name + "="):
            continue
        out.append(tok)
    return out


def _run_fleet(args, raw_argv) -> dict:
    """``--queue --num-workers N``: the one-command local fleet.  Spawns
    N single-worker copies of this command over the shared queue in
    ``--outdir``, waits, and summarises the queue's final state (SIGKILL
    a worker mid-run and the survivors reclaim its chunks).  A worker's
    hard failure (an exit code other than 0 or 75) raises."""
    import subprocess

    from ..shard.queue import queue_status

    child_argv = raw_argv
    for flag in ("--num-workers", "--telemetry-dir", "--http-port"):
        child_argv = _strip_flag(child_argv, flag)
    from .drivers import child_env

    env = child_env()
    # One run id for the whole fleet: every worker's spans and events
    # join one trace (tracing.new_run_id reads this).
    env.setdefault("KAFKA_TPU_RUN_ID", os.urandom(6).hex())
    procs = []
    for i in range(args.num_workers):
        cmd = [sys.executable, "-m", "kafka_tpu_torch.cli.run_synthetic",
               *child_argv, "--num-workers", "1"]
        if args.telemetry_dir:
            cmd += ["--telemetry-dir",
                    os.path.join(args.telemetry_dir, f"worker_{i}")]
        if args.http_port:
            # One endpoint per worker process: ports cannot be shared.
            cmd += ["--http-port", str(args.http_port + i)]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.DEVNULL))
    rcs = [p.wait() for p in procs]
    hard = [rc for rc in rcs if rc not in (0, 75)]
    if hard:
        raise RuntimeError(
            f"queue worker hard-failed (rc={hard[0]}; all: {rcs})")
    status = queue_status(args.outdir)
    summary = {
        "mode": "queue-fleet",
        "num_workers": args.num_workers,
        "chunks_total": status["n_chunks"],
        "done": status["counts"]["done"],
        "failed": status["counts"]["failed"],
        "pending": status["counts"]["pending"],
        "worker_rcs": rcs,
        "outdir": args.outdir,
    }
    print(json.dumps(summary))
    return summary


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
