"""Mosaic per-chunk outputs into single-tile rasters (a copy of
``kafka_tpu/cli/mosaic.py`` on the port's ``io.geotiff``).

A chunked run (and the OOM splitter) writes one GeoTIFF per parameter per
timestep PER CHUNK PREFIX — the original KaFKA leaves its users with the
same pile of prefixed files (``hex(chunk)`` prefixes,
``kafka_test_Py36.py:164-166``) and no tool.  This one stitches them:
chunk placement comes from each file's own geotransform relative to the
mosaic grid, so quarters from an OOM split and whole chunks compose
identically.

Usage:
    python -m kafka_tpu_torch.cli.mosaic <folder> [--param lai ...]
        [--date A2017183 ...] [--include-unc] [--outdir <folder>]

Without ``--param``/``--date`` every parameter and timestep discovered in
the folder is mosaicked.  Output naming: ``{param}_{date}[_unc].tif`` in
``--outdir`` (default ``<folder>/mosaic``).
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ..io.geotiff import GeoInfo, read_geotiff, read_info, write_geotiff
from . import make_console

LOG = logging.getLogger(__name__)

#: ``{param}_{A%Y%j}_{prefix}[_unc].tif`` — prefix is the chunk id with
#: optional ``-a``..``-d`` quarter suffixes from OOM splits (the dash
#: separator keeps hex chunk ids unambiguous: chunk ``1000a`` vs split
#: quarter ``1000-a``; recursive splits nest as ``-a-c``...).
_NAME = re.compile(
    r"^(?P<param>.+)_(?P<date>A\d{7})_(?P<prefix>[0-9a-fx]+(?:-[abcd])*)"
    r"(?P<unc>_unc)?\.tif$"
)


def discover(folder: str) -> Dict[Tuple[str, str, bool], List[str]]:
    """Group chunk files by (param, date, is_unc)."""
    groups: Dict[Tuple[str, str, bool], List[str]] = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(folder, "*.tif"))):
        m = _NAME.match(os.path.basename(path))
        if m:
            groups[(
                m.group("param"), m.group("date"), bool(m.group("unc"))
            )].append(path)
    return dict(groups)


def mosaic_files(files: List[str], out_path: str,
                 like=None) -> Tuple[int, int]:
    """Stitch chunk rasters into one grid by their geotransforms.

    All inputs must share resolution and CRS (they come from one run).

    ``like`` — optional raster (typically the run's state mask) whose
    grid becomes the mosaic grid.  Without it the extent is the bounding
    box of the files present, which SHRINKS when edge chunks had empty
    masks and wrote nothing; with it the product always aligns with the
    full tile, and the coverage check becomes exact: a warning fires
    only where the like-raster has VALID (non-zero) pixels that no chunk
    file covers — genuinely missing data, not benign empty chunks.

    Returns the mosaic (height, width)."""
    infos = [read_info(f) for f in files]
    gts = [i.geo.geotransform for i in infos]
    rx, ry = gts[0][1], gts[0][5]

    def crs_key(geo: GeoInfo):
        # EPSG is authoritative when present; projection-name strings
        # are a fallback (files from one run may carry one or the other).
        return geo.epsg if geo.epsg else geo.projection

    crs0 = crs_key(infos[0].geo)
    for f, info, gt in zip(files, infos, gts):
        if (gt[1], gt[5]) != (rx, ry):
            raise ValueError(
                f"{f}: resolution {(gt[1], gt[5])} != {(rx, ry)}"
            )
        if crs_key(info.geo) != crs0:
            raise ValueError(
                f"{f}: CRS {crs_key(info.geo)!r} != {crs0!r} — "
                "mixed-projection chunks cannot share a grid"
            )
    like_arr = None
    if like is not None:
        # ``like`` may be a path or a preloaded (array, TiffInfo) pair
        # (main() reads the raster once for all output groups).
        if isinstance(like, str):
            like_arr, like_info = read_geotiff(like)
        else:
            like_arr, like_info = like
        lgt = like_info.geo.geotransform
        if (lgt[1], lgt[5]) != (rx, ry):
            raise ValueError(
                f"--like: resolution {(lgt[1], lgt[5])} != "
                f"chunk resolution {(rx, ry)}"
            )
        if crs_key(like_info.geo) != crs0:
            raise ValueError(
                f"--like: CRS {crs_key(like_info.geo)!r} != chunk CRS "
                f"{crs0!r} — offsets computed across projections would "
                "be meaningless"
            )
        x0, y0 = lgt[0], lgt[3]
        width, height = like_info.width, like_info.height
    else:
        x0 = min(gt[0] for gt in gts)
        y0 = (max(gt[3] for gt in gts) if ry < 0
              else min(gt[3] for gt in gts))
        width = height = None
    cols = [int(round((gt[0] - x0) / rx)) for gt in gts]
    rows = [int(round((gt[3] - y0) / ry)) for gt in gts]
    if width is None:
        width = max(c + i.width for c, i in zip(cols, infos))
        height = max(r + i.height for r, i in zip(rows, infos))
    out = np.zeros((height, width), np.float32)
    covered = np.zeros((height, width), bool)
    overlap_px = 0
    for path, info, r, c in zip(files, infos, rows, cols):
        if r < 0 or c < 0 or r + info.height > height \
                or c + info.width > width:
            raise ValueError(
                f"{path} lies outside the mosaic grid "
                f"(offset {r},{c}, size {info.height}x{info.width} in "
                f"{height}x{width})"
            )
        arr, _ = read_geotiff(path)
        region = covered[r:r + info.height, c:c + info.width]
        overlap_px += int(region.sum())
        out[r:r + info.height, c:c + info.width] = arr
        region[...] = True
    if overlap_px:
        # Duplicate coverage means conflicting generations of files for
        # the same pixels (e.g. a stale whole-chunk raster next to its
        # OOM-split quarters): last writer wins in the product, which is
        # never the silent outcome the user wants.
        LOG.warning(
            "%s: %d px covered by more than one chunk file — stale and "
            "fresh chunk generations may be mixed (last file wins)",
            out_path, overlap_px,
        )
    if like_arr is not None:
        missing = int(((like_arr != 0) & ~covered).sum())
        if missing:
            LOG.warning(
                "%s: %d valid pixels of the --like raster are covered "
                "by no chunk file — missing or half-written chunks; "
                "those pixels are zero",
                out_path, missing,
            )
    elif not covered.all():
        # Without an authoritative grid this is only a hint: chunks whose
        # state mask was empty legitimately wrote no file.
        LOG.info(
            "%s: chunk files cover %d of %d px (empty-mask chunks are a "
            "benign cause; pass --like <state_mask> for an exact check)",
            out_path, int(covered.sum()), height * width,
        )
    geo = GeoInfo(
        geotransform=(x0, rx, gts[0][2], y0, gts[0][4], ry),
        projection=infos[0].geo.projection,
        epsg=infos[0].geo.epsg,
    )
    write_geotiff(out_path, out, geo)
    return height, width


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("folder")
    ap.add_argument("--param", action="append", default=None)
    ap.add_argument("--date", action="append", default=None)
    ap.add_argument("--include-unc", action="store_true")
    ap.add_argument("--like", default=None,
                    help="raster (e.g. the state mask) defining the "
                         "mosaic grid and enabling an exact coverage "
                         "check")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING
    )
    outdir = args.outdir or os.path.join(args.folder, "mosaic")
    os.makedirs(outdir, exist_ok=True)

    groups = discover(args.folder)
    if not groups:
        raise SystemExit(f"no chunk outputs found in {args.folder}")
    like = read_geotiff(args.like) if args.like else None
    written = []
    for (param, date, unc), files in sorted(groups.items()):
        if args.param and param not in args.param:
            continue
        if args.date and date not in args.date:
            continue
        if unc and not args.include_unc:
            continue
        name = f"{param}_{date}{'_unc' if unc else ''}.tif"
        out_path = os.path.join(outdir, name)
        h, w = mosaic_files(files, out_path, like=like)
        LOG.info("%s: %d chunks -> %dx%d", name, len(files), h, w)
        written.append({"file": name, "chunks": len(files),
                        "shape": [h, w]})
    print(json.dumps({"outdir": outdir, "mosaics": written}))
    return written


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
