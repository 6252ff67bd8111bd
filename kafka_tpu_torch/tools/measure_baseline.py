"""Measure the driver baseline rows end to end, host I/O included (port
of ``tools/measure_baseline.py``).

Each mode generates a synthetic on-disk data tree at the row's problem
scale (PROSAIL-consistent S2 granules, ``testing.fixtures``), runs the
REAL driver path (chunked ``cli.drivers.run_config`` or the engine
directly) on ``--device`` (default CUDA; raises without a card), and
prints one JSON line.  Data generation is excluded from the timed
window; reading, warping, gathering, solving and GeoTIFF writing are
all inside it.

Modes
-----
- ``barrax``  — the reference's S2-Barrax problem scale (pivot mask,
  204x235 grid, 2-day grid) through ``bench.bench_end_to_end``:
  ``--size`` makes the grid square and ``--dates`` sets its dates;
- ``tile``    — one full Sentinel-2 L2A tile (10980x10980 default),
  single date, chunked;
- ``annual``  — an annual series (~50 acquisitions) on one sub-tile,
  chunked, temporal KF chain;
- ``joint``   — S2 optical + S1 SAR on the 11-parameter joint state
  (``cli.run_joint``); the S1 series is NetCDF4, written and read
  through ``h5py``, so this mode needs ``h5py``;
- ``oracle``  — the reference algorithm (SciPy sparse + SuperLU) on this
  host's CPU for px/s context (same solve, no I/O — generous to it).

Usage:
    python -m kafka_tpu_torch.tools.measure_baseline tile --size 10980 \\
        --chunk 1098 [--device cuda]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def _granule_tree(root, dates, size, noise=0.002, dtype=np.uint16):
    from ..testing.fixtures import DEFAULT_GEO, make_s2_granule_tree

    if os.path.isdir(f"{root}/s2"):
        print(f"reusing existing granule tree {root}/s2", file=sys.stderr)
        return f"{root}/s2", DEFAULT_GEO
    t0 = time.perf_counter()
    make_s2_granule_tree(
        f"{root}/s2", dates, ny=size, nx=size, noise=noise, dtype=dtype
    )
    print(
        f"generated {len(dates)} x {size}x{size} granules "
        f"in {time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    return f"{root}/s2", DEFAULT_GEO


def _mask_tif(root, size, geo):
    from ..io import write_geotiff

    path = f"{root}/mask.tif"
    write_geotiff(path, np.ones((size, size), np.uint8), geo)
    return path


def _s2_config(data_folder, mask_path, outdir, dates, chunk):
    from ..cli.run_s2 import default_config

    cfg = default_config()
    cfg.data_folder = data_folder
    cfg.state_mask = mask_path
    cfg.output_folder = outdir
    cfg.chunk_size = (chunk, chunk)
    # Grid boundaries BRACKET the acquisitions (windows are half-open
    # intervals ending at each grid point, so a grid starting ON the first
    # acquisition date would never assimilate it).
    cfg.start = dates[0] - datetime.timedelta(days=1)
    cfg.end = dates[-1] + datetime.timedelta(days=1)
    # The measured configuration opts into the float16 wire (on-disk
    # rasters stay float32; sigma clamped at 65504 — io.output), the
    # documented performance mode.  The DEFAULT stays bit-exact float32.
    cfg.wire_dtype = "float16"
    # Host-path parallelism scales with cores: N prefetch readers with
    # ordered delivery; the per-band decode pool inside the S2 reader
    # sizes itself from os.cpu_count().
    cfg.prefetch_workers = min(4, os.cpu_count() or 1)
    return cfg


def _run_chunked(size, chunk, n_dates, step_days=2, keep=None, device=None):
    from ..cli.drivers import prosail_aux_builder, run_config

    root = keep or tempfile.mkdtemp(prefix="kafka_baseline_")
    try:
        dates = [
            datetime.datetime(2017, 7, 1) + datetime.timedelta(
                days=step_days * i
            )
            for i in range(n_dates)
        ]
        data, geo = _granule_tree(root, dates, size)
        mask = _mask_tif(root, size, geo)
        cfg = _s2_config(data, mask, f"{root}/out", dates, chunk)
        cfg.step_days = step_days
        t0 = time.perf_counter()
        stats = run_config(cfg, aux_builder=prosail_aux_builder,
                           device=device)
        wall = time.perf_counter() - t0
        n_px = stats["pixels"]
        # GUARD: every chunk must actually have assimilated every date —
        # a mis-built time grid silently yields a no-op run and a garbage
        # throughput figure.
        expected = stats["chunks_with_pixels"] * n_dates
        if stats.get("dates_assimilated", -1) != expected:
            raise RuntimeError(
                f"assimilated {stats.get('dates_assimilated')} chunk-dates, "
                f"expected {expected} — time grid/window mismatch"
            )
        px_steps_s = n_px * n_dates / wall
        return {
            "n_pixels": n_px,
            "n_dates": n_dates,
            "chunks": stats["run"],
            "wall_s": round(wall, 2),
            "pixel_steps_per_s": round(px_steps_s, 1),
        }
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)


def _run_joint(size, chunk, n_s2, n_s1, keep=None, device=None):
    """Multi-sensor row: S2 optical + S1 SAR interleaved on the shared
    11-parameter joint state (``cli.run_joint``)."""
    try:
        import h5py  # noqa: F401 — the S1 series' NetCDF4 codec
    except ImportError as exc:
        raise RuntimeError(
            "measure_baseline joint needs h5py: the S1 series is NetCDF4, "
            "written by testing.fixtures.make_s1_series and read by "
            "io.sentinel1 through h5py (as cli.run_s1 and cli.run_joint "
            "need it)") from exc
    from ..cli.drivers import prosail_aux_builder, run_config
    from ..cli.run_joint import default_config
    from ..testing.fixtures import make_s1_series

    root = keep or tempfile.mkdtemp(prefix="kafka_joint_")
    try:
        s2_dates = [
            datetime.datetime(2017, 7, 1) + datetime.timedelta(days=4 * i)
            for i in range(n_s2)
        ]
        s1_dates = [
            datetime.datetime(2017, 7, 3, 17) +
            datetime.timedelta(days=4 * i)
            for i in range(n_s1)
        ]
        data, geo = _granule_tree(root, s2_dates, size)
        if not os.path.isdir(f"{root}/s1"):
            make_s1_series(
                f"{root}/s1", s1_dates, truth_lai=3.0, truth_sm=0.4,
                ny=size, nx=size, geo=geo, noise=0.01,
            )
        mask = _mask_tif(root, size, geo)
        cfg = default_config()
        cfg.data_folder = data
        cfg.extra["s1_folder"] = f"{root}/s1"
        cfg.state_mask = mask
        cfg.output_folder = f"{root}/out"
        cfg.chunk_size = (chunk, chunk)
        all_dates = sorted(s2_dates + s1_dates)
        cfg.start = all_dates[0] - datetime.timedelta(days=1)
        cfg.end = all_dates[-1] + datetime.timedelta(days=1)
        cfg.step_days = 2
        cfg.wire_dtype = "float16"  # float16-wire opt-in (see _s2_config)
        n_dates = len(all_dates)
        t0 = time.perf_counter()
        stats = run_config(cfg, aux_builder=prosail_aux_builder,
                           device=device)
        wall = time.perf_counter() - t0
        expected = stats["chunks_with_pixels"] * n_dates
        if stats.get("dates_assimilated", -1) != expected:
            raise RuntimeError(
                f"assimilated {stats.get('dates_assimilated')} chunk-dates,"
                f" expected {expected}"
            )
        return {
            "n_pixels": stats["pixels"],
            "n_dates": n_dates,
            "n_s2": len(s2_dates), "n_s1": len(s1_dates),
            "wall_s": round(wall, 2),
            "pixel_steps_per_s": round(
                stats["pixels"] * n_dates / wall, 1
            ),
        }
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode",
                    choices=["barrax", "tile", "annual", "joint", "oracle"])
    ap.add_argument("--size", type=int, default=None)
    # 1098^2 px a chunk, the reference's S2 sub-tile: the chunk that
    # chip_smoke.py's phase cli_s2 runs through run_s2 on the H100.
    ap.add_argument("--chunk", type=int, default=1098)
    ap.add_argument("--dates", type=int, default=None)
    ap.add_argument("--step-days", type=int, default=2)
    ap.add_argument("--oracle-n", type=int, default=16384)
    ap.add_argument("--keep", default=None,
                    help="keep generated tree/outputs in this directory")
    ap.add_argument("--passes", type=int, default=5,
                    help="barrax: measured passes, the median reported "
                         "(default 5)")
    ap.add_argument("--reps", type=int, default=5,
                    help="oracle: timed solves, the median reported "
                         "(default 5)")
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; raises without "
                         "one unless 'cpu' is asked for)")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache()
    if args.mode == "oracle":
        from ..bench import bench_oracle

        px_s, ms_median, ms_spread, ms_min = bench_oracle(
            args.oracle_n, reps=args.reps)
        row = {
            "row": "oracle", "n_pixels": args.oracle_n,
            "px_per_s": round(px_s, 1),
            "ms_median": round(ms_median, 1),
            "ms_spread": round(ms_spread, 1),
            "ms_min": round(ms_min, 1),
        }
        print(json.dumps(row))
        return 0
    dev = resolve_device(args.device)
    if args.mode == "barrax":
        from ..bench import bench_end_to_end

        size = {} if args.size is None else {"ny": args.size,
                                             "nx": args.size}
        px_steps_s, device_frac, n_pix = bench_end_to_end(
            **size, n_dates=args.dates or 3, outdir=args.keep,
            passes=args.passes, device=dev)[:3]
        row = {
            "row": "barrax", "n_pixels": n_pix,
            "pixel_steps_per_s": round(px_steps_s, 1),
            "device_fraction": round(device_frac, 3),
        }
    elif args.mode == "tile":
        row = {"row": "tile", **_run_chunked(
            args.size or 10980, args.chunk, args.dates or 1,
            keep=args.keep, device=dev,
        )}
    elif args.mode == "annual":
        row = {"row": "annual", **_run_chunked(
            args.size or 1098, min(args.chunk, args.size or 1098),
            args.dates or 50, step_days=args.step_days, keep=args.keep,
            device=dev,
        )}
    else:
        size = args.size or 1098
        row = {"row": "joint", **_run_joint(
            size, min(args.chunk, size),
            n_s2=(args.dates or 12) // 2, n_s1=(args.dates or 12) // 2,
            keep=args.keep, device=dev,
        )}
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
