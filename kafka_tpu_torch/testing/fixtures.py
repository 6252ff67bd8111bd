"""Raster fixtures (port of ``kafka_tpu/testing/fixtures.py:17-49``): the
Barrax-like footprint and procedural centre-pivot field masks, the same
arrays as the JAX package's for the same arguments."""

from __future__ import annotations

import numpy as np

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
