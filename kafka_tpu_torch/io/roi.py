"""Pixel-window ROI plumbing shared by native-grid readers (a copy of
``kafka_tpu/io/roi.py``, which imports no JAX).

The MODIS-family readers (BHR, MOD09, Synergy) all work on their product's
native grid and expose the chunked-driver ROI hook the reference implements
as ``apply_roi`` (``kafka/input_output/observations.py:262-267`` of the
original KaFKA, used per chunk at ``kafka_test_Py36.py:162``).  Grid-warping
readers (Sentinel-2/-1) resample to the chunk's state grid instead and do
not use this mixin — the driver dispatches on the presence of
``apply_roi``.
"""

from __future__ import annotations

import datetime
import glob
import logging
from typing import Callable, Dict, List, Optional, Pattern, Tuple

import numpy as np

LOG = logging.getLogger(__name__)


def index_dated_paths(
    pattern: str,
    date_regex: Pattern,
    start_time: Optional[datetime.datetime] = None,
    end_time: Optional[datetime.datetime] = None,
    transform: Optional[Callable[[str], Optional[str]]] = None,
    label: str = "granule",
) -> Dict[datetime.datetime, str]:
    """Glob ``pattern``, parse an ``A%Y%j``-style date from each basename
    with ``date_regex`` (group 1 = ``%Y%j``), filter to the time window and
    return {date: transform(path)} — the discovery loop shared by the
    MODIS-family readers.  ``transform`` may reject a path by returning
    None; duplicate dates keep the first match and warn (one tile per
    folder is assumed)."""
    import os

    out: Dict[datetime.datetime, str] = {}
    for path in sorted(glob.glob(pattern)):
        m = date_regex.search(os.path.basename(path))
        if not m:
            continue
        value = transform(path) if transform is not None else path
        if value is None:
            continue
        d = datetime.datetime.strptime(m.group(1), "%Y%j")
        if start_time is not None and d < start_time:
            continue
        if end_time is not None and d > end_time:
            continue
        if d in out:
            LOG.warning(
                "multiple %ss for %s: keeping %s, ignoring %s "
                "(one tile per folder is assumed)",
                label, d.date(), out[d], value,
            )
            continue
        out[d] = value
    return out


class RoiWindowMixin:
    """``apply_roi`` + raster windowing + geotransform shifting."""

    roi: Optional[Tuple[int, int, int, int]] = None

    def apply_roi(self, ulx: int, uly: int, lrx: int, lry: int) -> None:
        """Pixel-window ROI on the reader's native grid (ul inclusive,
        lr exclusive)."""
        self.roi = (ulx, uly, lrx, lry)

    def _window(self, arr: np.ndarray) -> np.ndarray:
        if self.roi is None:
            return arr
        ulx, uly, lrx, lry = self.roi
        return arr[uly:lry, ulx:lrx]

    def _read_windowed(self, path: str) -> np.ndarray:
        """Read a raster pre-windowed to the ROI: only the intersecting
        TIFF tiles are decoded, so a chunked run over a full tile costs
        chunk-sized I/O per chunk instead of whole-raster decodes (the
        chunk-restartability I/O property of the reference's per-chunk
        ``apply_roi``, ``kafka_test_Py36.py:162``)."""
        from .geotiff import read_geotiff, read_geotiff_window

        if self.roi is None:
            return read_geotiff(path)[0]
        ulx, uly, lrx, lry = self.roi
        return read_geotiff_window(path, uly, ulx, lry - uly, lrx - ulx)[0]

    def _shift_geotransform(self, geotransform) -> List[float]:
        """Geotransform of the ROI window (origin moved by ul offsets)."""
        gt = list(geotransform)
        if self.roi is not None:
            gt[0] += self.roi[0] * gt[1]
            gt[3] += self.roi[1] * gt[5]
        return gt

    def _require_dates(self) -> None:
        dates = getattr(self, "dates", [])
        if not dates:
            raise ValueError(
                f"{type(self).__name__}: no granules indexed under "
                f"{getattr(self, 'data_dir', '?')!r} (wrong folder, naming "
                "pattern, or start/end window)"
            )
