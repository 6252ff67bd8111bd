"""Sentinel-2 MSI surface-reflectance reader (port of
``kafka_tpu/io/sentinel2.py``).

The observation semantics of the original KaFKA ``Sentinel2Observations``
(``kafka/input_output/Sentinel2_Observations.py:85-185``):

- granule discovery by walking the data tree for the ``*aot.tif`` marker,
  with the acquisition date encoded in the ``YYYY/MM/DD`` path components
  (``:116-130``);
- 10-band map B02..B12 (``:93-94``) reading ``B{band}_sur.tif`` per band;
- per-scene ``metadata.xml`` parse to mean SZA/SAA/VZA/VAA (``:23-53``);
- warp of every band onto the state-mask grid (``:56-79,166`` — here via
  ``io.warp`` instead of GDAL);
- reflectance scaling /10000, positivity mask, 5% relative uncertainty
  stored as inverse variance (``:167-179``).

All 10 bands of a date are read, decoded and gathered on a thread pool
(the port's native codec releases the GIL, as the JAX package's does)
and returned at once as a ``BandBatch`` gathered to the pixel batch.
The host chain is the JAX module's line for line; the one change is
the hand-over: the stacked numpy arrays become the ``BandBatch`` with one
``torch.as_tensor(..., device=)`` per field, and the aux builder's
tensors are moved to the reader's device.  An ``aux_builder(metadata,
gather)`` maps the scene's angles to the operator's per-date data (the
scene angles for PROSAIL, a per-geometry GP bank for ``gp_bank``).
"""

from __future__ import annotations

import datetime
import glob
import logging
import os
import xml.etree.ElementTree as ET
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.types import BandBatch
from ..engine.protocols import DateObservation
from ..engine.state import PixelGather
from .geotiff import read_geotiff_window, read_info
from .warp import grid_mapping

LOG = logging.getLogger(__name__)

#: B02..B12 band-number map (``Sentinel2_Observations.py:93-94``).
BAND_MAP = ["02", "03", "04", "05", "06", "07", "08", "8A", "09", "12"]
#: S2 MSI band indices used to key emulators (``:171-173``).
EMULATOR_BAND_MAP = [2, 3, 4, 5, 6, 7, 8, 9, 12, 13]


def _zenith_azimuth(node) -> tuple:
    """(zenith, azimuth) floats of an angle element, None where absent."""
    z = node.findtext("ZENITH_ANGLE")
    a = node.findtext("AZIMUTH_ANGLE")
    return (
        None if z is None else float(z),
        None if a is None else float(a),
    )


def parse_s2_xml(filename: str):
    """Mean solar/viewing angles ``(sza, saa, vza, vaa)`` from a granule
    metadata file.

    Semantics match the reference parser (one mean sun angle per scene;
    viewing angles averaged over all per-band/per-detector entries,
    ``Sentinel2_Observations.py:23-53``), located here by tag search from
    the document root rather than by fixed nesting, and validated: a
    metadata file without a complete sun angle or any viewing-angle entry
    raises ``ValueError`` naming the file instead of silently returning
    ``None``/NaN angles that would surface later as opaque failures in aux
    builders."""
    root = ET.parse(filename).getroot()

    sun = root.find(".//Mean_Sun_Angle")
    sza, saa = _zenith_azimuth(sun) if sun is not None else (None, None)
    if sza is None or saa is None:
        raise ValueError(
            f"{filename}: missing or incomplete Mean_Sun_Angle element"
        )

    pairs = [
        _zenith_azimuth(el)
        for el in root.iter("Mean_Viewing_Incidence_Angle")
    ]
    vzas = [z for z, _ in pairs if z is not None]
    vaas = [a for _, a in pairs if a is not None]
    if not vzas or not vaas:
        raise ValueError(
            f"{filename}: no Mean_Viewing_Incidence_Angle entries"
        )
    return sza, saa, float(np.mean(vzas)), float(np.mean(vaas))


def to_device(aux: Any, device) -> Any:
    """``aux`` with every tensor leaf (through dicts, lists, tuples and
    NamedTuples) moved to ``device``; other leaves pass through."""
    if isinstance(aux, torch.Tensor):
        return aux.to(device)
    if isinstance(aux, dict):
        return {k: to_device(v, device) for k, v in aux.items()}
    if isinstance(aux, (list, tuple)):
        items = [to_device(v, device) for v in aux]
        return type(aux)(*items) if hasattr(aux, "_fields") \
            else type(aux)(items)
    return aux


class Sentinel2Observations:
    """ObservationSource over a tree of preprocessed S2 granules.

    Parameters
    ----------
    parent_folder : root of the granule tree (``.../YYYY/MM/DD/granule/``
        with ``B??_sur.tif`` + ``metadata.xml`` + the ``*aot.tif`` marker).
    operator : the observation model applied to every date (stable callable
        — per-date data flows through ``aux``).
    state_geo : ``(geotransform, crs)`` of the state-mask grid that every
        band is warped onto (the reference warps to the mask file's grid).
    aux_builder : optional ``(metadata, gather) -> aux`` giving the
        operator's per-date traced data from the scene geometry; defaults
        to a dict of angle scalars.
    relative_uncertainty : 5% of reflectance, the reference's choice.
    device : where the ``BandBatch`` and the aux are made (None: CUDA).
    """

    def __init__(
        self,
        parent_folder: str,
        operator: Any,
        state_geo,
        aux_builder: Optional[Callable] = None,
        relative_uncertainty: float = 0.05,
        band_workers: Optional[int] = None,
        device=None,
    ):
        if not os.path.exists(parent_folder):
            raise IOError("S2 data folder doesn't exist")
        self.device = resolve_device(device)
        self.parent = parent_folder
        self.operator = operator
        self.state_geotransform, self.state_crs = state_geo
        self.aux_builder = aux_builder or (
            lambda metadata, gather: metadata
        )
        self.relative_uncertainty = float(relative_uncertainty)
        # Per-date band parallelism: the 10 read->decode->warp->gather
        # chains are independent and the tile codec's inner loops are
        # GIL-free (C++/zlib), so they thread across host cores.  Default:
        # one worker per core up to the band count; 1 = the reference's
        # serial per-band loop (linear_kf.py:225-227).
        if band_workers is None:
            band_workers = min(len(BAND_MAP), os.cpu_count() or 1)
        self.band_workers = max(1, int(band_workers))
        # ONE pool for the source's lifetime (lazily built): an annual
        # run reads hundreds of dates — spawning/joining threads per
        # date, times N prefetch workers, would put thread churn on the
        # exact host path this pool exists to speed up.  submit() is
        # thread-safe, so concurrent prefetch readers share it.
        self._band_pool = None
        self._find_granules()
        self.bands_per_observation = {d: len(BAND_MAP) for d in self.dates}
        # (src_gt, src_crs, dst_shape) -> fractional-pixel warp mapping.
        # The CRS transform over the full state grid is the expensive part
        # of a warp; all 10 bands of a granule share one source grid, so
        # the mapping is computed once and reused.
        self._mapping_cache: Dict[tuple, tuple] = {}
        # path -> parsed TiffInfo, so repeated windowed reads of one band
        # file parse its header/IFD once.
        self._info_cache: Dict[str, Any] = {}
        # (source grid, dst shape, gather id) -> valid-pixel fractional
        # coordinates (see _gathered_coords).
        self._gather_coord_cache: Dict[tuple, tuple] = {}

    def _find_granules(self) -> None:
        """Index granule directories by acquisition date.

        A granule is any directory containing an ``*aot.tif`` marker file
        under ``<parent>/YYYY/MM/DD/...`` (the marker convention and
        path-encoded date of the reference data layout,
        ``Sentinel2_Observations.py:116-130``); discovery here is by glob
        over that layout.  Directories whose date segments don't parse are
        skipped with a log message."""
        self.date_data: Dict[datetime.datetime, str] = {}
        pattern = os.path.join(
            glob.escape(self.parent), "*", "*", "*", "*", "*aot.tif"
        )
        for marker in glob.glob(pattern):
            granule_dir = os.path.dirname(marker)
            day_dir = os.path.dirname(granule_dir)
            segments = []
            for _ in range(3):  # day, month, year directories
                segments.append(os.path.basename(day_dir))
                day_dir = os.path.dirname(day_dir)
            try:
                day, month, year = (int(s) for s in segments)
                date = datetime.datetime(year, month, day)
            except ValueError:
                LOG.warning("skipping non-date granule path %s", granule_dir)
                continue
            self.date_data[date] = granule_dir
        self.dates = sorted(self.date_data)

    def define_output(self):
        """(projection, geotransform) of the output grid — the state grid
        (``Sentinel2_Observations.py:100-113``)."""
        return self.state_crs, list(self.state_geotransform)

    def _band_info(self, path: str):
        info = self._info_cache.get(path)
        if info is None:
            info = self._info_cache[path] = read_info(path)
        return info

    def _ensure_mapping(self, info, dst_shape):
        """The (cached) fractional-pixel mapping of the state grid into
        one source grid — the expensive CRS transform, no pixel I/O."""
        src_crs = info.geo.epsg if info.geo.epsg else self.state_crs
        key = (tuple(info.geo.geotransform), src_crs, tuple(dst_shape))
        if key not in self._mapping_cache:
            col_f, row_f = grid_mapping(
                info.geo.geotransform, dst_shape, self.state_geotransform,
                src_crs=src_crs, dst_crs=self.state_crs,
            )
            # Source bbox covering every mapped coordinate (+1 for the
            # bilinear neighbour), clipped to the source raster.
            c0 = int(max(0, np.floor(col_f.min()) - 1))
            r0 = int(max(0, np.floor(row_f.min()) - 1))
            c1 = int(min(info.width, np.ceil(col_f.max()) + 2))
            r1 = int(min(info.height, np.ceil(row_f.max()) + 2))
            c1, r1 = max(c1, c0 + 1), max(r1, r0 + 1)
            self._mapping_cache[key] = (
                col_f - c0, row_f - r0, r0, c0, r1 - r0, c1 - c0
            )
        return self._mapping_cache[key]

    def _gathered_coords(self, info, dst_shape, gather: PixelGather):
        """Fractional source coordinates of the VALID pixels only.

        Resampling the full chunk grid and then gathering wastes
        (1 - fill_fraction) of the warp work — the Barrax pivot mask is
        ~18% fill, so sampling at the gathered coordinates directly cuts
        the per-band warp cost ~5x.  Cached per (source grid incl. CRS,
        gather); the cache entry HOLDS the gather object, so its id can
        never be recycled while the entry lives, and an identity check
        guards against a different gather arriving under the same key."""
        col_l, row_l, r0, c0, nr, nc = self._ensure_mapping(
            info, dst_shape
        )
        src_crs = info.geo.epsg if info.geo.epsg else self.state_crs
        key = (
            tuple(info.geo.geotransform), src_crs, tuple(dst_shape),
            id(gather),
        )
        hit = self._gather_coord_cache.get(key)
        if hit is None or hit[0] is not gather:
            gcol = col_l[gather.rows, gather.cols]
            grow = row_l[gather.rows, gather.cols]
            # Precompute the nearest-neighbour integer lookup ONCE: all
            # 10 bands of every date share these coordinates, and the
            # per-band round/astype/bounds arithmetic was the warm read
            # path's single largest cost (~0.3 s/date at 1.2M px).
            ci = np.round(gcol).astype(np.int64)
            ri = np.round(grow).astype(np.int64)
            valid = (ci >= 0) & (ci < nc) & (ri >= 0) & (ri < nr)
            np.clip(ci, 0, nc - 1, out=ci)
            np.clip(ri, 0, nr - 1, out=ri)
            hit = (gather, ri, ci, valid)
            self._gather_coord_cache[key] = hit
        return hit[1], hit[2], hit[3], r0, c0, nr, nc

    def _band_arrays(self, path: str, dst_shape, gather: PixelGather):
        """One band's full host chain: read window -> decode -> nearest
        lookup AT the valid pixels -> reflectance/uncertainty arrays."""
        info = self._band_info(path)
        ri, ci, in_bounds, r0, c0, nr, nc = self._gathered_coords(
            info, dst_shape, gather
        )
        win, _ = read_geotiff_window(path, r0, c0, nr, nc, info=info)
        win2d = win if win.ndim == 2 else win[..., 0]
        vals = win2d[ri, ci].astype(np.float32, copy=False)
        if not in_bounds.all():
            vals = np.where(in_bounds, vals, np.float32(0.0))
        rho_pix = np.zeros(gather.n_pad, np.float32)
        rho_pix[: gather.n_valid] = vals
        mask = (rho_pix > 0) & gather.valid
        # DN/10000 reflectance, 5% relative sigma, inverse variance
        # (Sentinel2_Observations.py:167-179).
        refl = np.where(mask, rho_pix / 10000.0, 0.0).astype(np.float32)
        sigma = self.relative_uncertainty * refl
        with np.errstate(divide="ignore"):
            r_inv = np.where(mask, 1.0 / sigma**2, 0.0)
        return refl, r_inv.astype(np.float32), mask

    def get_observations(self, date, gather: PixelGather) -> DateObservation:
        folder = self.date_data[date]
        meta_file = os.path.join(folder, "metadata.xml")
        sza, saa, vza, vaa = parse_s2_xml(meta_file)
        metadata = {"sza": sza, "saa": saa, "vza": vza, "vaa": vaa}

        dst_shape = gather.mask.shape
        paths = [
            os.path.join(folder, f"B{band}_sur.tif") for band in BAND_MAP
        ]
        if self.band_workers > 1:
            # Warm the per-grid caches serially first: all bands of a
            # granule typically share one source grid, and N threads
            # discovering a cold mapping would each recompute the (one
            # expensive) CRS transform and the gathered-coordinate
            # selection.  Header reads are cheap; no pixel I/O happens
            # here.
            for path in paths:
                self._gathered_coords(
                    self._band_info(path), dst_shape, gather
                )
            if self._band_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._band_pool = ThreadPoolExecutor(
                    self.band_workers, thread_name_prefix="s2-band"
                )
            results = list(self._band_pool.map(
                lambda p: self._band_arrays(p, dst_shape, gather),
                paths,
            ))
        else:
            results = [
                self._band_arrays(p, dst_shape, gather) for p in paths
            ]
        ys = [r[0] for r in results]
        r_invs = [r[1] for r in results]
        masks = [r[2] for r in results]

        dev = self.device
        bands = BandBatch(
            y=torch.as_tensor(np.stack(ys), device=dev),
            r_inv=torch.as_tensor(np.stack(r_invs), device=dev),
            mask=torch.as_tensor(np.stack(masks), device=dev),
        )
        aux = to_device(self.aux_builder(metadata, gather), dev)
        return DateObservation(
            bands=bands, operator=self.operator, aux=aux
        )


def find_nearest_geometry(available, sza: float, vza: float, raa: float):
    """Pick the closest (sza, vza, raa) key from an emulator bank — the
    per-geometry emulator selection of the reference
    (``Sentinel2_Observations.py:133-145``), which matches each axis to
    its nearest available grid value independently.

    On a complete angular grid the per-axis match lands on an existing
    key (the reference's assumption).  On an INCOMPLETE bank the axes can
    disagree — each axis's nearest value exists, but their combination is
    no actual bank — so the fallback picks the nearest EXISTING key, with
    each axis normalised by its grid span (raw degrees would let the wide
    relative-azimuth axis, 0-180, swamp the zenith axes, 20-60)."""
    keys = list(available)
    arr = np.asarray(keys, np.float64)  # (m, 3): sza, vza, raa
    e1 = arr[:, 0] == arr[np.argmin(np.abs(arr[:, 0] - sza)), 0]
    e2 = arr[:, 1] == arr[np.argmin(np.abs(arr[:, 1] - vza)), 1]
    e3 = arr[:, 2] == arr[np.argmin(np.abs(arr[:, 2] - raa)), 2]
    hits = np.where(e1 & e2 & e3)[0]
    if hits.size:
        return keys[int(hits[0])]
    span = arr.max(axis=0) - arr.min(axis=0)
    span[span <= 0] = 1.0
    dist = (np.abs(arr - [sza, vza, raa]) / span).sum(axis=1)
    return keys[int(np.argmin(dist))]


def geometry_bank_aux_builder(banks: Dict[tuple, Any]) -> Callable:
    """``aux_builder`` selecting a per-geometry emulator bank.

    ``banks`` maps ``(sza, vza, raa)`` grid points to operator aux pytrees
    (e.g. stacked ``GPParams`` from ``obsops.gp.stack_gp_bank``).  Each
    date's scene angles pick the nearest bank — the traced-data equivalent
    of the reference unpickling an emulator file per geometry
    (``Sentinel2_Observations.py:157-159``): the jitted program is reused,
    only the aux arrays change."""

    def build(metadata, gather):
        raa = metadata["vaa"] - metadata["saa"]
        key = find_nearest_geometry(
            banks.keys(), metadata["sza"], metadata["vza"], raa
        )
        return banks[key]

    return build
