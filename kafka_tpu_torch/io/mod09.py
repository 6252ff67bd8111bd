"""MOD09GA directional-reflectance reader, the kernels observation path
(port of ``kafka_tpu/io/mod09.py``).

The observation semantics of the reference's
``MOD09_ObservationsKernels``:

- 500 m surface reflectance bands scaled by 1e-4;
- the 1 km ``state_1km`` QA word decoded to clear-sky land (bit fields,
  which accept the reference's whitelist and every word with the same
  clear/land meaning);
- 1 km solar/sensor zenith/azimuth scaled by 1e-2, relative azimuth
  ``vaa - saa``, upsampled x2 (nearest) onto the 500 m grid;
- Ross-Li kernels from the per-pixel geometry as the operator's aux;
- fixed per-band absolute uncertainties.

The on-disk contract is the JAX package's: one directory per date with
the HDF4-EOS subdatasets as GeoTIFFs,

    <dir>/MOD09GA.A<%Y%j>[.*]/sur_refl_b01.tif ... sur_refl_b07.tif
                              (int16 DN = reflectance * 1e4, 500 m grid)
    <dir>/MOD09GA.A<%Y%j>[.*]/state_1km.tif     (uint16 QA, 1 km grid)
    <dir>/MOD09GA.A<%Y%j>[.*]/SolarZenith_1.tif / SolarAzimuth_1.tif /
         SensorZenith_1.tif / SensorAzimuth_1.tif
                              (int16 DN = degrees * 1e2, 1 km grid)

The host chain is the JAX module's (the kernels in float32 on the
host); the ``BandBatch`` and the ``KernelsAux`` are made on the reader's
``device``.
"""

from __future__ import annotations

import datetime
import logging
import os
import re
from typing import List, Optional

import numpy as np

from .. import resolve_device
from ..engine.protocols import DateObservation
from ..engine.state import PixelGather
from ..obsops.kernels import KernelsAux, ross_li_kernels
from .geotiff import read_geotiff, read_info
from .modis import _band_batch
from .roi import RoiWindowMixin, index_dated_paths

LOG = logging.getLogger(__name__)

#: Per-band absolute reflectance uncertainty, MODIS land bands 1-7.
BAND_UNCERTAINTY = np.array(
    [0.004, 0.015, 0.003, 0.004, 0.013, 0.010, 0.006], np.float32
)

_GRANULE_RE = re.compile(r"MOD09GA\.A(\d{7})")

# state_1km bit layout (MOD09GA product spec):
#   bits 0-1  cloud state          (00 clear)
#   bit  2    cloud shadow
#   bits 3-5  land/water           (001 land)
#   bits 6-7  aerosol quantity     (any accepted)
#   bits 8-9  cirrus               (00 none / 01 small accepted)
#   bit  10   internal cloud flag  (ignored, as the reference whitelist
#   bit  11   internal fire flag    holds both settings of each)
#   bit  12   snow/ice
#   bit  13   adjacent to cloud


def decode_state_qa(qa: np.ndarray) -> np.ndarray:
    """Clear-sky land mask from the MOD09GA ``state_1km`` QA word: clear,
    no shadow, land, any aerosol load, cirrus none or small, no snow,
    not cloud-adjacent."""
    qa = np.asarray(qa).astype(np.uint16)
    cloud_clear = (qa & 0b11) == 0
    no_shadow = (qa >> 2 & 0b1) == 0
    land = (qa >> 3 & 0b111) == 0b001
    cirrus_ok = (qa >> 8 & 0b11) <= 0b01
    no_snow = (qa >> 12 & 0b1) == 0
    no_adjacent = (qa >> 13 & 0b1) == 0
    return cloud_clear & no_shadow & land & cirrus_ok & no_snow & no_adjacent


def zoom2_nearest(arr: np.ndarray) -> np.ndarray:
    """Nearest-neighbour x2 upsample, the 1 km -> 500 m regridding."""
    return np.repeat(np.repeat(arr, 2, axis=0), 2, axis=1)


class MOD09Observations(RoiWindowMixin):
    """ObservationSource over MOD09GA-style granule directories: the 7
    directional-reflectance bands with per-pixel Ross-Li kernel values
    in the aux, for the (linear) ``KernelsOperator``."""

    def __init__(
        self,
        data_dir: str,
        operator,
        start_time: Optional[datetime.datetime] = None,
        end_time: Optional[datetime.datetime] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.operator = operator
        self._granules = index_dated_paths(
            os.path.join(data_dir, "MOD09GA.A*"), _GRANULE_RE,
            start_time, end_time,
            transform=lambda p: p if os.path.isdir(p) else None,
            label="MOD09GA granule",
        )
        self.dates: List[datetime.datetime] = sorted(self._granules)
        self.bands_per_observation = {d: 7 for d in self.dates}

    def _read(self, granule: str, name: str) -> np.ndarray:
        arr, _ = read_geotiff(os.path.join(granule, name + ".tif"))
        return np.asarray(arr).squeeze()

    def define_output(self):
        self._require_dates()
        granule = self._granules[self.dates[0]]
        info = read_info(os.path.join(granule, "sur_refl_b01.tif"))
        gt = self._shift_geotransform(info.geo.geotransform)
        return info.geo.epsg or info.geo.projection or "sinusoidal", gt

    def get_observations(self, date, gather: PixelGather) -> DateObservation:
        granule = self._granules[date]
        qa = decode_state_qa(self._read(granule, "state_1km"))
        sza = self._read(granule, "SolarZenith_1").astype(np.float32) / 100.0
        saa = self._read(granule, "SolarAzimuth_1").astype(np.float32) / 100.0
        vza = self._read(granule, "SensorZenith_1").astype(np.float32) / 100.0
        vaa = self._read(granule, "SensorAzimuth_1").astype(np.float32) / 100.0
        clear = self._window(zoom2_nearest(qa))
        sza = self._window(zoom2_nearest(sza))
        raa = self._window(zoom2_nearest(vaa - saa))
        vza = self._window(zoom2_nearest(vza))

        clear_pix = gather.gather(clear) & gather.valid
        k_vol, k_geo = ross_li_kernels(
            gather.gather(sza), gather.gather(vza), gather.gather(raa)
        )
        aux = KernelsAux(k_vol=k_vol.to(self.device),
                         k_geo=k_geo.to(self.device))

        ys, r_invs, masks = [], [], []
        for band in range(7):
            # The 500 m bands are the I/O bulk: only the ROI window is
            # read (the 1 km rasters above stay whole for the x2 zoom).
            dn = np.asarray(self._read_windowed(
                os.path.join(granule, f"sur_refl_b{band + 1:02d}.tif")
            )).squeeze()
            refl_pix = gather.gather(dn.astype(np.float32) / 10000.0)
            valid = clear_pix & np.isfinite(refl_pix) & (refl_pix > 0)
            sigma = BAND_UNCERTAINTY[band]
            ys.append(np.where(valid, refl_pix, 0.0).astype(np.float32))
            r_invs.append(
                np.where(valid, 1.0 / sigma ** 2, 0.0).astype(np.float32))
            masks.append(valid)

        return DateObservation(
            bands=_band_batch(ys, r_invs, masks, self.device),
            operator=self.operator, aux=aux)
