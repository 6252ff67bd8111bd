"""MODIS MCD43 broadband-albedo readers (port of ``kafka_tpu/io/modis.py``).

``BHRObservations`` gives the observation semantics of the original
KaFKA ``BHRObservations`` (``kafka/input_output/observations.py:214-310``):

- per-date granule indexing with ``period``-day thinning of the date list
  (16-day default, ``:241-242``);
- ROI windowing via ``apply_roi`` (``:262-267``);
- two bands, VIS then NIR (``:254-255``);
- BRDF kernel weights (iso, vol, geo) integrated to bihemispherical
  reflectance with ``to_BHR = [1.0, 0.189184, -1.377622]`` (``:290-298``);
- QA-dependent relative uncertainty — 5% for full inversions (QA 0), 7%
  for magnitude inversions (QA 1), floored at 2.5e-3 — stored as inverse
  variance (``:299-307``).

The on-disk contract is the JAX package's: preprocessed GeoTIFFs, one
pair per date and band,

    <dir>/MCD43_<A%Y%j>_<vis|nir>_kernels.tif   (3 bands: iso, vol, geo)
    <dir>/MCD43_<A%Y%j>_<vis|nir>_qa.tif        (QA level, 255 = no data)

``SynergyKernels`` reads per-band kernel-weight series into broadband
VIS/NIR albedo with propagated variance.  The host chains are the JAX
module's; the ``BandBatch`` is made on the reader's ``device`` with one
``torch.as_tensor`` per field.
"""

from __future__ import annotations

import datetime
import glob
import logging
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.types import BandBatch
from ..engine.protocols import DateObservation
from ..engine.state import PixelGather
from .geotiff import read_info
from .roi import RoiWindowMixin, index_dated_paths
from .sentinel2 import to_device

LOG = logging.getLogger(__name__)

#: Kernel-weight -> white-sky-albedo integration (``observations.py:290``).
TO_BHR = np.array([1.0, 0.189184, -1.377622], np.float64)
BAND_TRANSFER = {0: "vis", 1: "nir"}  # observations.py:254-255
_FNAME_RE = re.compile(r"MCD43_A(\d{7})_(vis|nir)_kernels\.tif$")

#: MODIS narrowband -> broadband albedo integration (the published spectral
#: conversion the reference hard-codes in ``SynergyKernels.get_band_data``,
#: ``observations.py:187-192``): weights over land bands 1-7 plus intercept.
TO_VIS = np.array([0.3265, 0.0, 0.4364, 0.2366, 0.0, 0.0, 0.0], np.float64)
TO_NIR = np.array([0.0, 0.5447, 0.0, 0.0, 0.1363, 0.0469, 0.2536], np.float64)
BB_INTERCEPT = (-0.0019, -0.0068)  # (VIS, NIR)


def _band_batch(ys, r_invs, masks, device) -> BandBatch:
    """The date's stacked host arrays as a ``BandBatch`` on ``device``."""
    return BandBatch(
        y=torch.as_tensor(np.stack(ys), device=device),
        r_inv=torch.as_tensor(np.stack(r_invs), device=device),
        mask=torch.as_tensor(np.stack(masks), device=device),
    )


class BHRObservations(RoiWindowMixin):
    """ObservationSource over preprocessed MCD43 kernel-weight GeoTIFFs."""

    def __init__(
        self,
        data_dir: str,
        operator: Any,
        start_time: Optional[datetime.datetime] = None,
        end_time: Optional[datetime.datetime] = None,
        period: int = 16,
        aux_builder=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.operator = operator
        self.aux_builder = aux_builder or (lambda date, gather: None)
        self._index_granules(start_time, end_time)
        # Thin to one date per `period` days (observations.py:241-242).
        self.dates = self.dates[::period] if period > 1 else self.dates
        self.bands_per_observation = {d: 2 for d in self.dates}

    def _index_granules(self, start_time, end_time) -> None:
        dates = set()
        for path in glob.glob(
            os.path.join(self.data_dir, "MCD43_A*_kernels.tif")
        ):
            m = _FNAME_RE.search(os.path.basename(path))
            if not m:
                continue
            d = datetime.datetime.strptime(m.group(1), "%Y%j")
            if start_time is not None and d < start_time:
                continue
            if end_time is not None and d > end_time:
                continue
            dates.add(d)
        self.dates: List[datetime.datetime] = sorted(dates)

    def _paths(self, date: datetime.datetime, band: int):
        stem = f"MCD43_A{date.strftime('%Y%j')}_{BAND_TRANSFER[band]}"
        return (
            os.path.join(self.data_dir, stem + "_kernels.tif"),
            os.path.join(self.data_dir, stem + "_qa.tif"),
        )

    def define_output(self):
        self._require_dates()
        kpath, _ = self._paths(self.dates[0], 0)
        info = read_info(kpath)
        gt = self._shift_geotransform(info.geo.geotransform)
        return info.geo.epsg or "sinusoidal", gt

    def get_observations(self, date, gather: PixelGather) -> DateObservation:
        ys, r_invs, masks = [], [], []
        for band in (0, 1):
            kpath, qpath = self._paths(date, band)
            kernels = np.asarray(
                self._read_windowed(kpath), np.float64
            )  # (ny, nx, 3)
            qa = np.asarray(self._read_windowed(qpath))
            k_pix = gather.gather(kernels)       # (n_pad, 3)
            qa_pix = gather.gather(qa.astype(np.int32), fill=255)
            valid = (qa_pix <= 1) & np.isfinite(k_pix).all(axis=-1) \
                & gather.valid
            # kernels . to_BHR -> white-sky albedo (observations.py:290-298)
            bhr = np.where(valid, k_pix @ TO_BHR, 0.0).astype(np.float32)
            # QA-dependent sigma, floored (observations.py:299-303).
            sigma = np.zeros_like(bhr)
            sigma[qa_pix == 0] = np.maximum(2.5e-3, bhr[qa_pix == 0] * 0.05)
            sigma[qa_pix == 1] = np.maximum(2.5e-3, bhr[qa_pix == 1] * 0.07)
            with np.errstate(divide="ignore"):
                r_inv = np.where(valid & (sigma > 0), 1.0 / sigma**2, 0.0)
            ys.append(bhr)
            r_invs.append(r_inv.astype(np.float32))
            masks.append(valid & (sigma > 0))

        bands = _band_batch(ys, r_invs, masks, self.device)
        return DateObservation(
            bands=bands,
            operator=self.operator,
            aux=to_device(self.aux_builder(date, gather), self.device),
        )


_SYNERGY_RE = re.compile(r"\.A(\d{7})")


class SynergyKernels(RoiWindowMixin):
    """Broadband-albedo observations from per-band kernel-weight series.

    The reference's ``SynergyKernels`` (``observations.py:150-211``) indexes
    ``*_b{band}_kernel_weights.tif`` time series, integrates the 3 kernel
    weights to white-sky albedo with ``to_BHR`` and spectrally integrates
    the 7 MODIS land bands to broadband VIS/NIR — but its ``get_band_data``
    never returns and never touches uncertainty.  This class completes the
    contract: 2-band (VIS, NIR) broadband BHR observations with variance
    propagated through both linear integrations, assuming independent
    per-kernel, per-band errors:

        var(BHR_b) = sum_k to_BHR[k]^2 * sigma_bk^2
        var(BB)    = sum_b w_b^2 * var(BHR_b)

    On-disk contract per date (3-band float GeoTIFFs, kernel order
    iso/vol/geo, matching the reference's file naming ``:155-170``):

        <dir>/<stem>.A<%Y%j>_b{0..6}_kernel_weights.tif
        <dir>/<stem>.A<%Y%j>_b{0..6}_kernel_unc.tif
        <dir>/<stem>.A<%Y%j>_mask.tif                (uint8, 1 = usable)
    """

    def __init__(
        self,
        data_dir: str,
        operator: Any,
        start_time: Optional[datetime.datetime] = None,
        end_time: Optional[datetime.datetime] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.operator = operator
        self._stems: Dict[datetime.datetime, str] = index_dated_paths(
            os.path.join(data_dir, "*_b0_kernel_weights.tif"), _SYNERGY_RE,
            start_time, end_time,
            transform=lambda p: p[: -len("_b0_kernel_weights.tif")],
            label="Synergy series",
        )
        self.dates: List[datetime.datetime] = sorted(self._stems)
        self.bands_per_observation = {d: 2 for d in self.dates}

    def add_observations(self, date: datetime.datetime, stem: str) -> None:
        """Append one date to the index (``observations.py:176-182``)."""
        self._stems[date] = stem
        self.dates = sorted(self._stems)
        self.bands_per_observation[date] = 2

    def define_output(self):
        self._require_dates()
        stem = self._stems[self.dates[0]]
        info = read_info(stem + "_b0_kernel_weights.tif")
        gt = self._shift_geotransform(info.geo.geotransform)
        return info.geo.epsg or info.geo.projection or "sinusoidal", gt

    def get_observations(self, date, gather: PixelGather) -> DateObservation:
        stem = self._stems[date]
        mask_r = self._read_windowed(stem + "_mask.tif")
        usable = gather.gather(
            np.asarray(mask_r).squeeze().astype(bool)
        ) & gather.valid

        bhr = np.zeros((7, gather.n_pad), np.float64)
        var = np.zeros((7, gather.n_pad), np.float64)
        for band in range(7):
            k = self._read_windowed(f"{stem}_b{band}_kernel_weights.tif")
            u = self._read_windowed(f"{stem}_b{band}_kernel_unc.tif")
            k_pix = gather.gather(
                np.asarray(k, np.float64)
            )  # (n_pad, 3)
            u_pix = gather.gather(np.asarray(u, np.float64))
            bhr[band] = k_pix @ TO_BHR
            var[band] = (u_pix**2) @ (TO_BHR**2)

        ys, r_invs, masks = [], [], []
        for bb, weights in enumerate((TO_VIS, TO_NIR)):
            y = weights @ bhr + BB_INTERCEPT[bb]
            v = (weights**2) @ var
            valid = usable & np.isfinite(y) & (v > 0)
            ys.append(np.where(valid, y, 0.0).astype(np.float32))
            with np.errstate(divide="ignore"):
                r_invs.append(
                    np.where(valid, 1.0 / v, 0.0).astype(np.float32)
                )
            masks.append(valid)

        bands = _band_batch(ys, r_invs, masks, self.device)
        return DateObservation(bands=bands, operator=self.operator, aux=None)
