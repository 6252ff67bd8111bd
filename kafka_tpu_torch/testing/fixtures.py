"""Raster fixtures (port of ``kafka_tpu/testing/fixtures.py``): the
Barrax-like footprint, procedural centre-pivot field masks, and on-disk
sensor data for the real-sensor drivers — a Sentinel-2 granule tree, an
MCD43 kernel-weight series, MOD09GA granules, a Synergy series and a
Sentinel-1 NetCDF series — each physically consistent (the port's
forward model at a known truth).  File names, layouts and random draws are the JAX package's for
the same arguments; the forward models run in PyTorch on the CPU (one
pixel each), so float values agree to float32 rounding and uint16 DN to
one count."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.geotiff import GeoInfo, write_geotiff

# A Barrax-like footprint: 10 m pixels, UTM zone 30N.
DEFAULT_GEO = GeoInfo(
    geotransform=(576000.0, 10.0, 0.0, 4325000.0, 0.0, -10.0),
    projection="WGS 84 / UTM zone 30N",
    epsg=32630,
)


def make_pivot_mask(ny: int = 204, nx: int = 235, n_pivots: int = 5,
                    seed: int = 0) -> np.ndarray:
    """Boolean mask of circular 'pivot fields' scattered over the scene."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((ny, nx), bool)
    yy, xx = np.mgrid[:ny, :nx]
    for _ in range(n_pivots):
        r = rng.integers(min(ny, nx) // 12, min(ny, nx) // 6)
        cy = rng.integers(r, ny - r)
        cx = rng.integers(r, nx - r)
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
    return mask


def write_pivot_mask(path: str, ny: int = 204, nx: int = 235,
                     n_pivots: int = 5, seed: int = 0) -> np.ndarray:
    mask = make_pivot_mask(ny, nx, n_pivots, seed)
    write_geotiff(path, mask.astype(np.uint8), DEFAULT_GEO)
    return mask


_S2_METADATA_XML = """<?xml version="1.0"?>
<granule><Geometric_Info><Tile_Angles>
  <Mean_Sun_Angle>
    <ZENITH_ANGLE>{sza}</ZENITH_ANGLE><AZIMUTH_ANGLE>{saa}</AZIMUTH_ANGLE>
  </Mean_Sun_Angle>
  <Mean_Viewing_Incidence_Angle_List>
    <Mean_Viewing_Incidence_Angle bandId="0">
      <ZENITH_ANGLE>{vza}</ZENITH_ANGLE><AZIMUTH_ANGLE>{vaa}</AZIMUTH_ANGLE>
    </Mean_Viewing_Incidence_Angle>
  </Mean_Viewing_Incidence_Angle_List>
</Tile_Angles></Geometric_Info></granule>
"""


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def make_s2_granule_tree(
    root: str,
    dates,
    truth_state=None,
    ny: int = 64,
    nx: int = 64,
    geo: GeoInfo = DEFAULT_GEO,
    noise: float = 0.0,
    seed: int = 0,
    angles=(30.5, 150.0, 5.0, 100.0),
    dtype=np.float32,
):
    """Write a Sentinel-2 granule tree (``YYYY/MM/DD/granule/``) whose
    10-band reflectances are the PROSAIL forward model evaluated at
    ``truth_state`` (default: the SAIL mean with LAI 3).  Returns the
    truth state used.

    ``dtype=np.uint16`` writes DN bands as real S2 L2A products are
    encoded (half the bytes of float32) — use for at-scale runs."""
    from ..io.sentinel2 import BAND_MAP
    from ..obsops.prosail import ProsailAux, ProsailOperator

    rng = np.random.default_rng(seed)
    op = ProsailOperator()
    if truth_state is None:
        from ..engine.priors import sail_prior_arrays

        truth_state = sail_prior_arrays()[0].copy()
        truth_state[6] = np.exp(-3.0 / 2.0)  # LAI 3
    truth_state = np.asarray(truth_state, np.float32)
    sza, saa, vza, vaa = angles
    aux = ProsailAux(sza=_f32(sza), vza=_f32(vza), raa=_f32(vaa - saa))
    brf = op.forward(aux, torch.as_tensor(truth_state)[None, :]).numpy()
    brf = brf[:, 0]  # (10,)
    for date in dates:
        gran = os.path.join(
            root, f"{date.year}", f"{date.month}", f"{date.day}",
            "S2_SYNTH_GRANULE",
        )
        os.makedirs(gran, exist_ok=True)
        for bi, b in enumerate(BAND_MAP):
            field = np.full((ny, nx), brf[bi], np.float32)
            if noise > 0:
                field = field + rng.normal(
                    0, noise, field.shape
                ).astype(np.float32)
            dn = np.clip(field, 1e-4, 1.0) * 10000.0
            if np.dtype(dtype).kind == "u":
                dn = np.round(dn)
            write_geotiff(
                os.path.join(gran, f"B{b}_sur.tif"),
                dn.astype(dtype), geo,
                predictor=2 if np.dtype(dtype).kind in "ui" else 1,
            )
        write_geotiff(
            os.path.join(gran, "synth_aot.tif"),
            np.ones((ny, nx), np.float32), geo,
        )
        with open(os.path.join(gran, "metadata.xml"), "w") as f:
            f.write(_S2_METADATA_XML.format(sza=sza, saa=saa, vza=vza,
                                            vaa=vaa))
    return truth_state


def make_mod09_granules(
    dirpath: str,
    dates,
    truth_weights=None,
    ny: int = 32,
    nx: int = 32,
    geo: GeoInfo = DEFAULT_GEO,
    noise: float = 0.0,
    seed: int = 0,
    angles=None,
):
    """Write MOD09GA-style granule directories whose 7-band reflectances
    are the Ross-Li kernel model at ``truth_weights`` under each date's
    geometry (the JAX package's ``make_mod09_granules``, file for file
    for the same seed; the kernels are the port's own, on the CPU).

    ``ny, nx`` is the 1 km grid; reflectances are written at the 2x
    500 m resolution.  ``angles`` maps each date to ``(sza, saa, vza,
    vaa)`` degrees (a default sweep when None).  Returns the ``(21,)``
    truth kernel-weight state."""
    from ..obsops.kernels import ross_li_kernels

    rng = np.random.default_rng(seed)
    if truth_weights is None:
        # Plausible MODIS land-band weights: moderate iso, smaller vol/geo.
        iso = np.array([0.05, 0.3, 0.04, 0.06, 0.25, 0.2, 0.1])
        truth_weights = np.stack([iso, 0.4 * iso, 0.15 * iso],
                                 axis=1).reshape(-1)
    truth_weights = np.asarray(truth_weights, np.float32)
    w = truth_weights.reshape(7, 3)
    for di, date in enumerate(dates):
        if angles is not None:
            sza, saa, vza, vaa = angles[di]
        else:  # a geometry sweep makes the kernel weights identifiable
            sza, saa = 25.0 + 3.0 * di, 140.0
            vza, vaa = 10.0 + 5.0 * (di % 4), 140.0 + 30.0 * (di % 3)
        gran = os.path.join(dirpath, f"MOD09GA.A{date.strftime('%Y%j')}")
        os.makedirs(gran, exist_ok=True)
        k_vol, k_geo = (float(k) for k in ross_li_kernels(sza, vza,
                                                          vaa - saa))
        for band in range(7):
            refl = w[band, 0] + k_vol * w[band, 1] + k_geo * w[band, 2]
            field = np.full((2 * ny, 2 * nx), refl, np.float32)
            if noise > 0:
                field = field + rng.normal(0, noise, field.shape)
            write_geotiff(
                os.path.join(gran, f"sur_refl_b{band + 1:02d}.tif"),
                np.clip(field * 10000.0, 1.0, 16000.0).astype(np.int16),
                geo,
            )
        write_geotiff(  # QA word 8: clear sky, no shadow, land
            os.path.join(gran, "state_1km.tif"),
            np.full((ny, nx), 8, np.uint16), geo,
        )
        for name, deg in (("SolarZenith_1", sza), ("SolarAzimuth_1", saa),
                          ("SensorZenith_1", vza), ("SensorAzimuth_1", vaa)):
            write_geotiff(os.path.join(gran, name + ".tif"),
                          np.full((ny, nx), round(deg * 100), np.int16), geo)
    return truth_weights


def make_synergy_series(
    dirpath: str,
    dates,
    truth_bhr=None,
    ny: int = 32,
    nx: int = 32,
    geo: GeoInfo = DEFAULT_GEO,
    kernel_unc: float = 0.005,
    stem: str = "SYN.h17v05",
):
    """Write a Synergy kernel-weight series (per-band weights + unc + mask
    GeoTIFFs) whose per-band white-sky albedo equals ``truth_bhr`` (7,).
    Returns ``truth_bhr``."""
    if truth_bhr is None:
        truth_bhr = np.array([0.05, 0.3, 0.04, 0.06, 0.25, 0.2, 0.1])
    truth_bhr = np.asarray(truth_bhr, np.float64)
    os.makedirs(dirpath, exist_ok=True)
    for date in dates:
        base = os.path.join(dirpath, f"{stem}.A{date.strftime('%Y%j')}")
        for band in range(7):
            k = np.zeros((ny, nx, 3), np.float32)
            k[..., 0] = truth_bhr[band]  # iso-only => kernels . to_BHR = iso
            u = np.full((ny, nx, 3), kernel_unc, np.float32)
            write_geotiff(f"{base}_b{band}_kernel_weights.tif", k, geo)
            write_geotiff(f"{base}_b{band}_kernel_unc.tif", u, geo)
        write_geotiff(
            f"{base}_mask.tif", np.ones((ny, nx), np.uint8), geo
        )
    return truth_bhr


def make_mcd43_series(
    dirpath: str,
    dates,
    truth_state=None,
    ny: int = 64,
    nx: int = 64,
    geo: GeoInfo = DEFAULT_GEO,
    noise: float = 0.0,
    seed: int = 0,
):
    """Write an MCD43 kernel-weight series whose BHR equals the two-stream
    forward model at ``truth_state`` (default: the TIP prior mean with
    TeLAI 0.5; iso weight = albedo, vol/geo zero, so ``kernels . to_BHR``
    reproduces it exactly).  Returns the truth state."""
    from ..obsops.twostream import TwoStreamOperator

    rng = np.random.default_rng(seed)
    op = TwoStreamOperator()
    if truth_state is None:
        from ..core.propagators import tip_prior_arrays

        truth_state = tip_prior_arrays()[0].copy()
        truth_state[6] = 0.5
    truth_state = np.asarray(truth_state, np.float32)
    albedo = op.forward(
        None, torch.as_tensor(truth_state)[None, :]).numpy()[:, 0]
    for date in dates:
        stem = os.path.join(dirpath, f"MCD43_A{date.strftime('%Y%j')}")
        for bi, band in enumerate(("vis", "nir")):
            k = np.zeros((ny, nx, 3), np.float32)
            k[..., 0] = albedo[bi]
            if noise > 0:
                k[..., 0] += rng.normal(0, noise, (ny, nx))
            qa = np.zeros((ny, nx), np.uint8)
            write_geotiff(f"{stem}_{band}_kernels.tif", k, geo)
            write_geotiff(f"{stem}_{band}_qa.tif", qa, geo)
    return truth_state


def make_s1_series(
    dirpath: str,
    dates,
    truth_lai: float = 3.0,
    truth_sm: float = 0.3,
    ny: int = 64,
    nx: int = 64,
    geo: GeoInfo = DEFAULT_GEO,
    theta_deg: float = 35.0,
    noise: float = 0.0,
    seed: int = 0,
):
    """Write a folder of preprocessed Sentinel-1 sigma0 NetCDFs whose VV/VH
    backscatter is the Water-Cloud Model evaluated at (``truth_lai``,
    ``truth_sm``) — the file naming and contract of
    ``io.sentinel1.S1Observations``.  Needs ``h5py``, imported here.
    Returns the noise-free sigma0 per polarisation."""
    import h5py

    from ..obsops.wcm import WCM_PARAMETERS, wcm_sigma0

    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    s0 = {
        pol: float(wcm_sigma0(
            _f32(truth_lai), _f32(truth_sm), _f32(theta_deg),
            WCM_PARAMETERS[pol],
        ))
        for pol in ("VV", "VH")
    }
    for date in dates:
        name = f"S1A_IW_GRDH_1SDV_pre_{date.strftime('%Y%m%dT%H%M%S')}_x_y.nc"
        with h5py.File(os.path.join(dirpath, name), "w") as f:
            f.attrs["geotransform"] = np.asarray(geo.geotransform, np.float64)
            f.attrs["epsg"] = np.int64(geo.epsg or 32630)
            for pol in ("VV", "VH"):
                field = np.full((ny, nx), s0[pol], np.float32)
                if noise > 0:
                    field = field * (
                        1.0 + rng.normal(0, noise, field.shape)
                    ).astype(np.float32)
                f.create_dataset(f"sigma0_{pol}", data=field)
            f.create_dataset(
                "theta", data=np.full((ny, nx), theta_deg, np.float32)
            )
    return s0
