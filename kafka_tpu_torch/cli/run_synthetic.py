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
VV and VH at a 23 degree incidence angle).  Not ported yet, and refused
with a message naming the slice that brings them: chunked, queue and
fleet modes (``--chunk-size``, ``--queue``, ``--num-workers``), the live
HTTP endpoint (``--http-port``) and profiler capture
(``--profile-windows``).
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

#: flags of the JAX driver this port does not run yet, with the ROADMAP
#: slice that brings each: (flag, is it set?, slice).
UNPORTED = (
    ("--chunk-size", lambda a: a.chunk_size > 0,
     "slice 5 (distribution: chunked, queue and fleet modes)"),
    ("--queue", lambda a: a.queue,
     "slice 5 (distribution: chunked, queue and fleet modes)"),
    ("--num-workers", lambda a: a.num_workers > 1,
     "slice 5 (distribution: chunked, queue and fleet modes)"),
    ("--http-port", lambda a: a.http_port > 0,
     "slice 7 (device plane and telemetry)"),
    ("--profile-windows", lambda a: a.profile_windows > 0,
     "slice 7 (device plane and telemetry)"),
)


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
                    help="(not ported yet) NxN chunked runs")
    ap.add_argument("--queue", action="store_true",
                    help="(not ported yet) the lease-based chunk queue")
    ap.add_argument("--lease-ttl-s", type=float, default=None,
                    help="queue-mode lease TTL (queue mode only)")
    ap.add_argument("--num-workers", type=int, default=1,
                    help="(not ported yet) queue-mode local fleet size")
    ap.add_argument("--chunk-attempts", type=int, default=2,
                    help="attempts per chunk (chunked mode only)")
    ap.add_argument("--chunk-deadline-s", type=float, default=None,
                    help="per-chunk deadline (chunked mode only)")
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
                    help="(not ported yet) live metrics endpoint port")
    ap.add_argument("--profile-windows", type=int, default=0,
                    help="(not ported yet) profiler capture of N windows")
    ap.add_argument("--scan-window", type=int, default=8,
                    help="temporal fusion: windows per fused block "
                         "(1 = unfused)")
    add_device_arg(ap)
    add_telemetry_arg(ap)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    for flag, is_set, where in UNPORTED:
        if is_set(args):
            ap.error(f"{flag} is not ported to kafka_tpu_torch yet; "
                     f"it comes with {where} (ROADMAP.md)")
    return args


def main(argv=None):
    from ..resilience import RetryPolicy, faults
    from ..telemetry import configure, get_registry, tracing

    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING)
    device = resolve_device(args.device)
    if args.telemetry_dir:
        configure(args.telemetry_dir)
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
    with tracing.push(run_id=tracing.new_run_id()):
        summary = _run_single(args, mask, geo, op, params, prior, truth,
                              aux_fn, sigma, obs_dates, time_grid,
                              read_policy, device)
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


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
