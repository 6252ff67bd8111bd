"""Sentinel-2 PROSAIL driver, the Barrax configuration (port of
``kafka_tpu/cli/run_s2.py``).

10-parameter PROSAIL state, SAIL prior, prior-only advance (zero Q),
2-day time grid, 128x128 chunks over the state mask, per-chunk prefixed
GeoTIFF outputs and restart markers.  All knobs come from a
``RunConfig``; ``--config run.json`` (saved by either package)
overrides them.  Each Gauss-Newton iteration of a chunk-date launches the
fused update at (10, 10) on the card.

Usage:
    python -m kafka_tpu_torch.cli.run_s2 --data-folder /path/s2_tree \\
        --state-mask pivots.tif --outdir /tmp/kafka_s2 [--device cpu]

``--device`` defaults to CUDA (and fails without a card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import sys

from ..engine.config import RunConfig
from ..engine.priors import PROSAIL_PARAMETER_LIST
from . import add_device_arg, add_telemetry_arg, make_console
from .drivers import resolve_aux_builder, run_config


def default_config() -> RunConfig:
    """The JAX driver's S2-Barrax constants."""
    return RunConfig(
        parameter_list=PROSAIL_PARAMETER_LIST,
        start=datetime.datetime(2017, 7, 3),
        end=datetime.datetime(2017, 7, 11),
        step_days=2,
        operator="prosail",
        propagator="none",
        prior="sail",
        q_diag=None,                      # Q = 0
        chunk_size=(128, 128),
        observations="sentinel2",
        solver_options={"relaxation": 0.7},
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="RunConfig JSON overriding the Barrax defaults")
    ap.add_argument("--data-folder", default=None)
    ap.add_argument("--state-mask", default=None)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--emulators", default=None,
                    help="directory of gp_emulator pickles or converted "
                         ".npz banks (import_emulators): runs the "
                         "assimilation through those emulators instead "
                         "of the built-in PROSAIL physics operator")
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
    if args.emulators:
        cfg.operator = "gp_bank"
        cfg.extra["emulator_folder"] = args.emulators

    stats = run_config(cfg, aux_builder=resolve_aux_builder(cfg, args.device),
                       device=args.device)
    print(json.dumps(stats))
    return stats


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
