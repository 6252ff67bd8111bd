"""MOD09 directional-reflectance driver, the kernel-weight retrieval
(port of ``kafka_tpu/cli/run_mod09.py``).

MOD09GA clear-sky directional reflectances assimilated into a per-pixel,
per-band Ross-Li kernel-weight state (21 parameters) through the linear
``KernelsOperator``: the MCD43 kernel inversion recast as a temporal
filter.  The exact information filter (Q = 0) accumulates the angular
sampling across daily dates; the weak kernel prior seeds the initial
state only.  At p = 21 each date takes the dense large-p solve (a
``torch.linalg`` Cholesky on the card), no hand kernel.

Usage:
    python -m kafka_tpu_torch.cli.run_mod09 --data-folder /path/mod09 \\
        --state-mask mask.tif --outdir /tmp/kafka_mod09 [--device cpu]

``--device`` defaults to CUDA (and fails without a card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import sys

from ..engine.config import RunConfig
from ..engine.priors import KERNEL_PARAMETER_LIST
from . import add_device_arg, add_telemetry_arg, make_console
from .drivers import run_config


def default_config() -> RunConfig:
    """The JAX driver's MOD09 constants."""
    return RunConfig(
        parameter_list=KERNEL_PARAMETER_LIST,
        start=datetime.datetime(2017, 6, 1),
        end=datetime.datetime(2017, 6, 30),
        step_days=1,
        operator="kernels",
        propagator="information_filter",
        prior=None,
        initial_prior="kernels",
        q_diag=[0.0] * 21,
        chunk_size=(256, 256),
        observations="mod09",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="RunConfig JSON overriding the defaults")
    ap.add_argument("--data-folder", default=None)
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
    if args.state_mask:
        cfg.state_mask = args.state_mask
    if args.outdir:
        cfg.output_folder = args.outdir
    if args.telemetry_dir:
        cfg.telemetry_dir = args.telemetry_dir

    stats = run_config(cfg, device=args.device)
    print(json.dumps(stats))
    return stats


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
