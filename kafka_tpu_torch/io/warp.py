"""Host-side raster reprojection (a copy of ``kafka_tpu/io/warp.py``, which
imports no JAX) — the GDAL-warp replacement.

The original KaFKA readers warp each acquisition to the state-mask grid
with ``gdal.Warp``/``ReprojectImage``
(``kafka/input_output/Sentinel2_Observations.py:56-79``,
``Sentinel1_Observations.py:30-53``, ``input_output/utils.py:43-64``).
Neither package depends on GDAL or pyproj, and the warp is a host-side
data-prep step (never on the device hot path), so the needed projection
math is implemented here directly in vectorised NumPy:

- **WGS84 geographic** (EPSG:4326),
- **UTM** (EPSG:326xx north / 327xx south) via the Krüger/Karney
  transverse-Mercator series to n^3 (sub-mm over a UTM zone) — covers all
  Sentinel-2 MGRS tiles and the reference's EPSG:32630 Barrax fixtures,
- **MODIS sinusoidal** (the MCD43/MOD09 grid; sphere R=6371007.181 m).

Resampling is nearest or bilinear gather — the reference uses
nearest-neighbour for masks and bilinear for reflectances
(``input_output/utils.py:58-63``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)
_N = _F / (2.0 - _F)
# Krüger series radius and coefficients (to n^3).
_ABAR = _A / (1.0 + _N) * (1.0 + _N**2 / 4.0 + _N**4 / 64.0)
_ALPHA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 5.0 * _N**3 / 16.0,
    13.0 * _N**2 / 48.0 - 3.0 * _N**3 / 5.0,
    61.0 * _N**3 / 240.0,
)
_BETA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 37.0 * _N**3 / 96.0,
    _N**2 / 48.0 + _N**3 / 15.0,
    17.0 * _N**3 / 480.0,
)
_DELTA = (
    2.0 * _N - 2.0 * _N**2 / 3.0 - 2.0 * _N**3,
    7.0 * _N**2 / 3.0 - 8.0 * _N**3 / 5.0,
    56.0 * _N**3 / 15.0,
)
_K0 = 0.9996
_E0 = 500000.0
# MODIS sinusoidal sphere radius (the SIN grid's datum).
_R_SIN = 6371007.181


def utm_zone_params(epsg: int) -> Tuple[float, float]:
    """(central meridian radians, false northing) of a UTM EPSG code."""
    if 32601 <= epsg <= 32660:
        zone, n0 = epsg - 32600, 0.0
    elif 32701 <= epsg <= 32760:
        zone, n0 = epsg - 32700, 10000000.0
    else:
        raise ValueError(f"not a UTM EPSG code: {epsg}")
    lon0 = np.deg2rad(-183.0 + 6.0 * zone)
    return lon0, n0


def lonlat_to_utm(lon, lat, epsg: int):
    """Forward transverse Mercator (degrees -> metres)."""
    lon0, n0 = utm_zone_params(epsg)
    lam = np.deg2rad(np.asarray(lon, np.float64)) - lon0
    phi = np.deg2rad(np.asarray(lat, np.float64))
    sphi = np.sin(phi)
    c = 2.0 * np.sqrt(_N) / (1.0 + _N)
    t = np.sinh(np.arctanh(sphi) - c * np.arctanh(c * sphi))
    xi = np.arctan2(t, np.cos(lam))
    eta = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))
    x, y = xi.copy(), eta.copy()
    for j, al in enumerate(_ALPHA, start=1):
        x = x + al * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        y = y + al * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    easting = _E0 + _K0 * _ABAR * y
    northing = n0 + _K0 * _ABAR * x
    return easting, northing


def utm_to_lonlat(easting, northing, epsg: int):
    """Inverse transverse Mercator (metres -> degrees)."""
    lon0, n0 = utm_zone_params(epsg)
    xi = (np.asarray(northing, np.float64) - n0) / (_K0 * _ABAR)
    eta = (np.asarray(easting, np.float64) - _E0) / (_K0 * _ABAR)
    xip, etap = xi.copy(), eta.copy()
    for j, be in enumerate(_BETA, start=1):
        xip = xip - be * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        etap = etap - be * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    chi = np.arcsin(np.sin(xip) / np.cosh(etap))
    phi = chi.copy()
    for j, de in enumerate(_DELTA, start=1):
        phi = phi + de * np.sin(2 * j * chi)
    lam = np.arctan2(np.sinh(etap), np.cos(xip))
    return np.rad2deg(lam + lon0), np.rad2deg(phi)


def lonlat_to_sinusoidal(lon, lat):
    lat_r = np.deg2rad(np.asarray(lat, np.float64))
    lon_r = np.deg2rad(np.asarray(lon, np.float64))
    return _R_SIN * lon_r * np.cos(lat_r), _R_SIN * lat_r


def sinusoidal_to_lonlat(x, y):
    lat_r = np.asarray(y, np.float64) / _R_SIN
    with np.errstate(divide="ignore", invalid="ignore"):
        lon_r = np.asarray(x, np.float64) / (_R_SIN * np.cos(lat_r))
    return np.rad2deg(lon_r), np.rad2deg(lat_r)


#: EPSG code for the MODIS sinusoidal grid as used by GDAL ("SR-ORG:6974");
#: we accept the conventional 6974 plus the magic string "sinusoidal".
SINUSOIDAL = "sinusoidal"


def to_lonlat(crs, x, y):
    """Projected coordinates -> (lon, lat) degrees for a supported CRS."""
    key = _crs_key(crs)
    if key == 4326:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    if key == SINUSOIDAL:
        return sinusoidal_to_lonlat(x, y)
    return utm_to_lonlat(x, y, key)


def from_lonlat(crs, lon, lat):
    """(lon, lat) degrees -> projected coordinates for a supported CRS."""
    key = _crs_key(crs)
    if key == 4326:
        return np.asarray(lon, np.float64), np.asarray(lat, np.float64)
    if key == SINUSOIDAL:
        return lonlat_to_sinusoidal(lon, lat)
    return lonlat_to_utm(lon, lat, key)


def _as_epsg(crs) -> int:
    if isinstance(crs, str):
        crs = crs.upper().replace("EPSG:", "")
        return int(crs)
    return int(crs)


def _crs_key(crs):
    """Canonical comparison key for a CRS value, so equivalent spellings
    (4326 vs 'EPSG:4326' vs None, 'sinusoidal' vs 6974) compare equal."""
    if crs in (None, "", 4326, "EPSG:4326"):
        return 4326
    if crs in (SINUSOIDAL, 6974):
        return SINUSOIDAL
    return _as_epsg(crs)


def apply_geotransform(gt, col, row):
    """Pixel (col, row) -> projected (x, y); GDAL convention, pixel centre
    at (col+0.5, row+0.5)."""
    return (
        gt[0] + (col + 0.5) * gt[1] + (row + 0.5) * gt[2],
        gt[3] + (col + 0.5) * gt[4] + (row + 0.5) * gt[5],
    )


def invert_geotransform(gt, x, y):
    """Projected (x, y) -> fractional pixel (col, row)."""
    det = gt[1] * gt[5] - gt[2] * gt[4]
    dx = np.asarray(x, np.float64) - gt[0]
    dy = np.asarray(y, np.float64) - gt[3]
    col = (gt[5] * dx - gt[2] * dy) / det - 0.5
    row = (-gt[4] * dx + gt[1] * dy) / det - 0.5
    return col, row


def grid_mapping(
    src_gt,
    dst_shape: Tuple[int, int],
    dst_gt,
    src_crs=None,
    dst_crs=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fractional source pixel coordinates ``(col_f, row_f)`` of every
    destination pixel centre.  This is the expensive part of a warp (the
    per-pixel CRS transform); compute it once per (grid, CRS) pair and
    reuse it across bands/variables via ``resample``."""
    ny, nx = dst_shape
    cols, rows = np.meshgrid(np.arange(nx), np.arange(ny))
    x, y = apply_geotransform(dst_gt, cols, rows)
    # Exact equality first: equal-but-unparseable spellings must still be
    # treated as the identity mapping, without going through _crs_key.
    if src_crs != dst_crs and _crs_key(src_crs) != _crs_key(dst_crs):
        lon, lat = to_lonlat(dst_crs, x, y)
        x, y = from_lonlat(src_crs, lon, lat)
    return invert_geotransform(src_gt, x, y)


def resample(
    src: np.ndarray,
    col_f: np.ndarray,
    row_f: np.ndarray,
    method: str = "nearest",
    nodata: float = np.nan,
) -> np.ndarray:
    """Gather ``src`` (ny, nx[, k]) at fractional pixel coordinates.

    ``nearest`` or ``bilinear``; out-of-bounds pixels get ``nodata``.
    Trailing band axes are supported by both methods.
    """
    src = np.asarray(src)
    h, w = src.shape[:2]
    dst_shape = col_f.shape
    out_dtype = src.dtype if np.issubdtype(src.dtype, np.floating) \
        else np.float32
    if method == "nearest":
        ci = np.round(col_f).astype(np.int64)
        ri = np.round(row_f).astype(np.int64)
        valid = (ci >= 0) & (ci < w) & (ri >= 0) & (ri < h)
        out = np.full(dst_shape + src.shape[2:], nodata, out_dtype)
        out[valid] = src[ri[valid], ci[valid]]
        return out
    if method != "bilinear":
        raise ValueError(f"unknown resampling method: {method}")
    # Valid anywhere within the outer pixel centres; cell indices clamped to
    # the last full cell so points exactly on the far edge interpolate with
    # fraction 1.0 instead of being dropped.
    valid = (col_f >= 0) & (col_f <= w - 1) & (row_f >= 0) & (row_f <= h - 1)
    c0 = np.clip(np.floor(col_f).astype(np.int64), 0, max(w - 2, 0))
    r0 = np.clip(np.floor(row_f).astype(np.int64), 0, max(h - 2, 0))
    fc = np.clip(col_f - c0, 0.0, 1.0)
    fr = np.clip(row_f - r0, 0.0, 1.0)
    c1 = np.minimum(c0 + 1, w - 1)
    r1 = np.minimum(r0 + 1, h - 1)
    if src.ndim > 2:
        fc = fc[..., None]
        fr = fr[..., None]
        valid = valid[..., None]
    v00 = src[r0, c0].astype(np.float64)
    v01 = src[r0, c1].astype(np.float64)
    v10 = src[r1, c0].astype(np.float64)
    v11 = src[r1, c1].astype(np.float64)
    interp = (
        v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
        + v10 * fr * (1 - fc) + v11 * fr * fc
    )
    out = np.where(valid, interp, nodata)
    return out.astype(out_dtype)


def reproject_raster(
    src: np.ndarray,
    src_gt,
    dst_shape: Tuple[int, int],
    dst_gt,
    src_crs=None,
    dst_crs=None,
    method: str = "nearest",
    nodata: float = np.nan,
) -> np.ndarray:
    """Warp ``src`` (ny, nx[, k]) onto the destination grid.

    The equivalent of the reference's ``reproject_image``
    (``input_output/utils.py:43-64``): target-driven inverse mapping — for
    each destination pixel centre, project into the source grid and gather.
    One-shot convenience around ``grid_mapping`` + ``resample``.
    """
    col_f, row_f = grid_mapping(src_gt, dst_shape, dst_gt, src_crs, dst_crs)
    return resample(src, col_f, row_f, method=method, nodata=nodata)
