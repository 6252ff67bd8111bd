"""Sentinel-1 SAR-only assimilation driver, Water-Cloud Model (port of
``kafka_tpu/cli/run_s1.py``).

A 2-parameter (LAI, soil moisture) state retrieved from dual-pol VV/VH
backscatter time series with the per-pixel incidence angle,
information-filter propagation between acquisitions.  Each Gauss-Newton
iteration of a chunk-date launches the fused update at (2, 2) on the
card.  The reader decodes NetCDF4 through ``h5py``, imported when a file
is read.

Usage:
    python -m kafka_tpu_torch.cli.run_s1 --data-folder /path/s1_ncs \
        --state-mask mask.tif --outdir /tmp/kafka_s1 [--device cpu]

``--device`` defaults to CUDA (and fails without a card).
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import sys

from ..engine.config import RunConfig
from ..engine.priors import WCM_PARAMETER_LIST
from . import add_device_arg, add_telemetry_arg, make_console
from .drivers import run_config


def default_config() -> RunConfig:
    """SAR-only defaults: 2-param WCM state, broad prior seeding the
    initial state, information filter carrying it between acquisitions
    (soil moisture decorrelates fast — larger Q)."""
    return RunConfig(
        parameter_list=WCM_PARAMETER_LIST,
        start=datetime.datetime(2017, 7, 1),
        end=datetime.datetime(2017, 7, 31),
        step_days=3,
        operator="wcm",
        propagator="information_filter",
        prior=None,
        initial_prior="wcm",
        q_diag=[5e-3, 2e-2],
        chunk_size=(256, 256),
        observations="sentinel1",
    )


def _enl_arg(text: str):
    """'auto' or a positive look count — ENL <= 0 would silently
    zero-weight every observation (sigma -> inf)."""
    if text == "auto":
        return "auto"
    try:
        value = float(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--enl must be 'auto' or a number, got {text!r}"
        )
    if value <= 0:
        raise argparse.ArgumentTypeError(
            f"--enl must be positive, got {value}"
        )
    return value


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="RunConfig JSON overriding the defaults")
    ap.add_argument("--data-folder", default=None, help="S1 NetCDF folder")
    ap.add_argument("--state-mask", default=None)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--enl", default=None, type=_enl_arg,
                    help="equivalent number of looks for speckle-"
                         "statistics uncertainty: a number, 'auto' "
                         "(estimate per scene from homogeneous-block "
                         "statistics), or omit for the file attribute / "
                         "5%% relative placeholder")
    ap.add_argument("--noise-floor", type=float, default=None,
                    help="noise-equivalent sigma0 (linear power) added "
                         "in quadrature to the speckle term")
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
    if args.enl is not None:
        cfg.extra["s1_enl"] = args.enl
    if args.noise_floor is not None:
        cfg.extra["s1_noise_floor"] = args.noise_floor
    if args.telemetry_dir:
        cfg.telemetry_dir = args.telemetry_dir

    stats = run_config(cfg, device=args.device)
    print(json.dumps(stats))
    return stats


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
