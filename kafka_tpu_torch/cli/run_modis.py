"""MODIS BHR annual driver, the serial information-filter configuration
(port of ``kafka_tpu/cli/run_modis.py``).

7-parameter TIP state, two-stream observation operator over MCD43
kernel-weight BHR, ``information_filter_lai`` propagation with
Q[TeLAI] = 0.04, JRC prior for the initial state only, 16-day grid over a
year.  The whole tile runs as one chunk.  Each date is one launch of the
fused Gauss-Newton kernel on the card.

Usage:
    python -m kafka_tpu_torch.cli.run_modis --data-folder /path/mcd43 \\
        --state-mask mask.tif --outdir /tmp/kafka_modis [--device cpu]

``--device`` defaults to CUDA (and fails without a card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import sys

from ..engine.config import RunConfig
from ..engine.priors import TIP_PARAMETER_LIST
from . import add_device_arg, add_telemetry_arg, make_console
from .drivers import run_config


def default_config() -> RunConfig:
    """The JAX driver's MODIS-annual constants."""
    return RunConfig(
        parameter_list=TIP_PARAMETER_LIST,
        start=datetime.datetime(2017, 1, 1),
        end=datetime.datetime(2017, 12, 31),
        step_days=16,
        operator="twostream",
        propagator="information_filter_lai",
        prior=None,
        initial_prior="jrc",
        q_diag=[0, 0, 0, 0, 0, 0, 0.04],  # Q on TeLAI only
        chunk_size=(2400, 2400),          # whole tile, one chunk
        observations="bhr",
        extra={"period": 16},
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="RunConfig JSON overriding the annual defaults")
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
