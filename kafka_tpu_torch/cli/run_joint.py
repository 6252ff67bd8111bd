"""Joint Sentinel-2 optical + Sentinel-1 SAR assimilation driver (port of
``kafka_tpu/cli/run_joint.py``).

Both sensors constrain ONE 11-parameter state (the 10 transformed PROSAIL
parameters + volumetric soil moisture, ``obsops.joint``): S2 dates update
the full optical state through PROSAIL, S1 dates update LAI and soil
moisture through the WCM, and the merged date stream is assimilated in
time order by the same filter.  On the card the fused update runs at
(11, 10) on S2 dates and (11, 2) on S1 dates.  The S1 reader decodes
NetCDF4 through ``h5py``, imported when a file is read.

Usage:
    python -m kafka_tpu_torch.cli.run_joint --data-folder /path/s2_tree \
        --s1-folder /path/s1_ncs --state-mask mask.tif --outdir /tmp/joint \
        [--device cpu]

``--device`` defaults to CUDA (and fails without a card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import sys

from ..engine.config import RunConfig
from ..engine.priors import JOINT_PARAMETER_LIST
from . import add_device_arg, add_telemetry_arg, make_console
from .drivers import prosail_aux_builder, run_config


def default_config() -> RunConfig:
    """S2-Barrax constants extended with the SAR stream: same grid and
    chunking as the S2 driver (``kafka_test_S2.py:135-205``), 11-parameter
    joint state.

    Unlike the S2 driver's prior-only advance (which RESETS the state to
    the prior every grid step, ``kf_tools.py:155-158`` semantics — fine
    when one sensor observes every window, fatal when sensors alternate),
    the joint config propagates information through time: the joint prior
    seeds the initial state only, and the information filter carries each
    sensor's constraint forward with a small model error Q, so SAR-derived
    soil moisture survives optical-only windows and vice versa (the
    MODIS-serial pattern, ``kafka_test.py:195-208``)."""
    return RunConfig(
        parameter_list=JOINT_PARAMETER_LIST,
        start=datetime.datetime(2017, 7, 3),
        end=datetime.datetime(2017, 7, 11),
        step_days=2,
        operator="prosail_joint",
        propagator="information_filter",
        prior=None,
        initial_prior="joint",
        # Small per-step model error; soil moisture decorrelates faster
        # than canopy structure, so its Q is an order larger.
        q_diag=[1e-3] * 10 + [1e-2],
        chunk_size=(128, 128),
        observations="joint",
        solver_options={"relaxation": 0.7},
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="RunConfig JSON overriding the defaults")
    ap.add_argument("--data-folder", default=None, help="S2 granule tree")
    ap.add_argument("--s1-folder", default=None, help="S1 NetCDF folder")
    ap.add_argument("--state-mask", default=None)
    ap.add_argument("--outdir", default=None)
    add_device_arg(ap)
    add_telemetry_arg(ap)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING
    )

    cfg = RunConfig.load(args.config) if args.config else default_config()
    if args.data_folder:
        cfg.data_folder = args.data_folder
    if args.s1_folder:
        cfg.extra["s1_folder"] = args.s1_folder
    if args.state_mask:
        cfg.state_mask = args.state_mask
    if args.outdir:
        cfg.output_folder = args.outdir
    if args.telemetry_dir:
        cfg.telemetry_dir = args.telemetry_dir
    if "s1_folder" not in cfg.extra:
        ap.error("--s1-folder (or extra.s1_folder in --config) is required")

    stats = run_config(cfg, aux_builder=prosail_aux_builder,
                       device=args.device)
    print(json.dumps(stats))
    return stats


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
