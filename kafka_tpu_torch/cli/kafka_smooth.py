"""Offline reanalysis driver: RTS-smooth a run's checkpoint chain (port
of ``kafka_tpu/cli/kafka_smooth.py``).

Walks a completed (or merely resumable) forward run's checkpoint folder
newest -> oldest, runs the fixed-interval RTS backward pass
(``kafka_tpu_torch.smoother``) on ``--device`` (default CUDA), and
writes the smoothed product alongside the filter's:
``{param}_{A%Y%j}_smoothed.tif`` + ``..._smoothed_unc.tif`` per date,
plus the smoother's QA band (``solver_qa_{A%Y%j}_smoothed.tif``) and
``smoothed`` quality-ledger records.

Usage:
    python -m kafka_tpu_torch.cli.kafka_smooth --ckpt-dir /tmp/out/ckpt \\
        --outdir /tmp/out --operator identity --ny 204 --nx 235

The chain must store the analysis in information form (every checkpoint
the engine writes does).  Checkpoints carrying the forecast sidecar
smooth exactly; pre-sidecar sets fall back to re-deriving the forecast
through ``--propagator``/``--q`` — pass the forward run's configuration
for an exact fallback.  The mask/grid arguments must reproduce the
forward run's (same ``--mask`` or ``--ny/--nx``), or the chain's pixel
rows will not scatter back onto the raster.

The summary JSON includes a ``x_sha256`` per date — the digest the
``smoothed=true`` serve path also reports, so offline and served
reanalysis compare bit for bit.

Left out, as ``cli/drivers.py:run_config`` leaves them out: the flight
recorder (``flight_recorder.install``) and the compilation cache
(nothing is compiled per shape in the port).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

from ..core import (
    propagate_information_filter,
    propagate_information_filter_approx,
    propagate_standard_kalman,
)
from ..engine import Checkpointer, make_pixel_gather
from ..engine.priors import TIP_PARAMETER_LIST
from ..io import GeoTIFFOutput, read_geotiff
from ..smoother import SmootherError, smooth_checkpoints, state_sha256
from ..testing.fixtures import DEFAULT_GEO, make_pivot_mask
from . import add_device_arg, add_telemetry_arg, make_console

#: parameter names per operator, matching ``run_synthetic``'s problems.
_OPERATOR_PARAMS = {
    "identity": ("a", "b"),
    "twostream": TIP_PARAMETER_LIST,
    "wcm": ("lai", "sm"),
}

_PROPAGATORS = {
    "information": propagate_information_filter,
    "approx": propagate_information_filter_approx,
    "standard": propagate_standard_kalman,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True,
                    help="the forward run's checkpoint folder")
    ap.add_argument("--ckpt-prefix", default="",
                    help="checkpoint filename prefix (chunked runs)")
    ap.add_argument("--shards", type=int, default=1,
                    help="the forward run's checkpoint shard count")
    ap.add_argument("--outdir", default=None,
                    help="write *_smoothed.tif products here (omit for "
                         "a summary-only pass)")
    ap.add_argument("--operator", default="identity",
                    choices=sorted(_OPERATOR_PARAMS),
                    help="names the output parameters like run_synthetic")
    ap.add_argument("--params", default=None,
                    help="comma-separated parameter names (overrides "
                         "--operator)")
    ap.add_argument("--mask", default=None,
                    help="GeoTIFF state mask of the forward run "
                         "(default: generated pivots)")
    ap.add_argument("--ny", type=int, default=204)
    ap.add_argument("--nx", type=int, default=235)
    ap.add_argument("--propagator", default="information",
                    choices=sorted(_PROPAGATORS),
                    help="fallback propagator for sidecar-less "
                         "checkpoints (match the forward run)")
    ap.add_argument("--q", type=float, default=1e-3,
                    help="fallback trajectory uncertainty diagonal "
                         "(match the forward run)")
    add_device_arg(ap)
    add_telemetry_arg(ap)
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING
    )
    from .. import resolve_device
    from ..telemetry import configure, get_registry, quality, tracing

    device = resolve_device(args.device)
    if args.telemetry_dir:
        configure(args.telemetry_dir)

    ck = Checkpointer(args.ckpt_dir, prefix=args.ckpt_prefix,
                      n_shards=max(1, args.shards))
    t0 = time.time()
    with tracing.push(run_id=tracing.new_run_id()):
        try:
            result = smooth_checkpoints(
                ck, q_diag=np.float32(args.q),
                state_propagator=_PROPAGATORS[args.propagator],
                device=device,
            )
        except SmootherError as exc:
            print(f"kafka-smooth: {exc}", file=sys.stderr)
            return {"failed": 1, "error": str(exc)}

        t_total, n_pix, p = result.x_smoothed.shape
        if args.params:
            params = tuple(s for s in args.params.split(",") if s)
        else:
            params = tuple(_OPERATOR_PARAMS[args.operator])[:p]
        if len(params) != p:
            print(
                f"kafka-smooth: chain stores {p} parameters but "
                f"{len(params)} names were given ({params})",
                file=sys.stderr,
            )
            return {"failed": 1, "error": "parameter-count mismatch"}

        reg = get_registry()
        ledger = quality.get_ledger(reg)
        prefix = args.ckpt_prefix.rstrip("_") or None
        dates = {}
        for t, ts in enumerate(result.timesteps):
            dates[ts.isoformat()] = {
                "x_sha256": state_sha256(result.x_smoothed[t]),
                "sigma_shrink": [
                    round(v, 6) for v in result.sigma_shrink(t)
                ],
                "rederived": ts in result.rederived,
            }
            ledger.record_smoothed(
                ts.date().isoformat(), result.sigma_shrink(t),
                n_valid=n_pix, prefix=prefix,
            )

        written = 0
        if args.outdir:
            written = _write_outputs(args, result, params, prefix)

        summary = {
            "windows": t_total,
            "n_pixels": n_pix,
            "rederived": len(result.rederived),
            "skipped": len(result.skipped),
            "dates": dates,
            "outputs_written": written,
            "outdir": args.outdir,
            "wall_s": round(time.time() - t0, 3),
        }
        reg.emit(
            "smooth_done", windows=t_total, rederived=len(result.rederived),
            skipped=len(result.skipped), outputs_written=written,
        )
        summary["telemetry_dir"] = reg.dump()
    print(json.dumps(summary))
    return summary


def _write_outputs(args, result, params, prefix) -> int:
    """Scatter the smoothed planes back onto the forward run's raster
    grid and write the ``*_smoothed.tif`` product set."""
    if args.mask:
        mask_arr, info = read_geotiff(args.mask)
        mask = mask_arr.astype(bool)
        geo = info.geo
    else:
        mask = make_pivot_mask(args.ny, args.nx)
        geo = DEFAULT_GEO
    gather = make_pixel_gather(mask)
    n_pix = result.x_smoothed.shape[1]
    if gather.n_pad != n_pix:
        raise SystemExit(
            f"kafka-smooth: mask yields {gather.n_pad} padded pixels "
            f"but the chain stores {n_pix} — pass the forward run's "
            "--mask/--ny/--nx"
        )
    out_prefix = f"{prefix}_smoothed" if prefix else "smoothed"
    os.makedirs(args.outdir, exist_ok=True)
    output = GeoTIFFOutput(
        params, geo.geotransform, geo.projection, args.outdir,
        prefix=out_prefix, epsg=geo.epsg, async_writes=True,
    )
    try:
        for t, ts in enumerate(result.timesteps):
            output.dump_data(ts, result.x_smoothed[t],
                             result.p_inv_diag[t], gather, params)
            output.dump_qa(ts, result.qa[t], gather)
    finally:
        output.close()
    return len([
        f for f in os.listdir(args.outdir)
        if f.endswith("_smoothed.tif") or f.endswith("_smoothed_unc.tif")
    ])


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
