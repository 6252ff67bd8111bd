"""Spectral inputs of the plain PROSAIL reference: leaf refractive index,
specific absorptions and soil spectra on a 400-2500 nm grid, averaged
over flat-top approximations of the Sentinel-2A band responses.

A frozen copy of the tables the program's operator is built on
(``kafka_tpu_torch/obsops/prospect_data.py``, generated from published
anchor data by plain numpy at import), so the reference reads no table
of the program.
"""

from __future__ import annotations

import numpy as np

#: fine wavelength grid [nm]
WL = np.arange(400.0, 2501.0, 5.0)

# ---------------------------------------------------------------------------
# Sentinel-2A spectral response (Gaussian approximation: centre, FWHM, nm),
# reference band order B02..B8A, B09, B12
# (``Sentinel2_Observations.py:93-94``).
# ---------------------------------------------------------------------------
S2_BANDS = {
    "B02": (492.4, 66.0),
    "B03": (559.8, 36.0),
    "B04": (664.6, 31.0),
    "B05": (704.1, 16.0),
    "B06": (740.5, 15.0),
    "B07": (782.8, 20.0),
    "B08": (832.8, 106.0),
    "B8A": (864.7, 22.0),
    "B09": (945.1, 21.0),
    "B12": (2202.4, 175.0),
}
BAND_ORDER = list(S2_BANDS)


def _interp(anchors) -> np.ndarray:
    """Piecewise-linear spectrum through (wavelength, value) anchors."""
    pts = np.asarray(anchors, np.float64)
    return np.interp(WL, pts[:, 0], pts[:, 1])


def _gaussians(components) -> np.ndarray:
    """Sum of (amplitude, centre, sigma) Gaussians on the fine grid."""
    out = np.zeros_like(WL)
    for amp, centre, sigma in components:
        out += amp * np.exp(-0.5 * ((WL - centre) / sigma) ** 2)
    return out


# --- leaf refractive index -------------------------------------------------
N_SPECTRUM = _interp([
    (400, 1.540), (450, 1.535), (500, 1.525), (550, 1.515), (600, 1.505),
    (650, 1.495), (700, 1.485), (750, 1.475), (800, 1.465), (900, 1.455),
    (1000, 1.450), (1200, 1.440), (1400, 1.425), (1600, 1.415),
    (1800, 1.405), (2000, 1.395), (2200, 1.370), (2400, 1.340),
    (2500, 1.330),
])

# --- chlorophyll a+b, in vivo [cm^2/ug] ------------------------------------
K_CAB = _gaussians([
    (0.072, 435.0, 26.0),   # Soret band
    (0.034, 470.0, 22.0),   # Chl-b shoulder
    (0.013, 580.0, 80.0),   # green-gap base absorption
    (0.022, 630.0, 25.0),   # red shoulder
    (0.070, 672.0, 16.0),   # red peak
    (0.004, 710.0, 30.0),   # in-vivo red-edge wing (broadened red band)
])
# In-vivo chlorophyll absorption vanishes across the red edge; the
# taper ends before B07/B08 so the NIR plateau bands stay
# chlorophyll-transparent (their defining property).
K_CAB *= np.clip((765.0 - WL) / 30.0, 0.0, 1.0)

# --- carotenoids [cm^2/ug], blue only --------------------------------------
K_CAR = _gaussians([
    (0.022, 430.0, 30.0),
    (0.045, 452.0, 18.0),
    (0.040, 482.0, 18.0),
])
K_CAR[WL > 540.0] = 0.0

# --- brown pigment [relative] ----------------------------------------------
K_BROWN = np.where(
    WL < 900.0, 0.9 * np.exp(-(WL - 400.0) / 150.0), 0.0
)

# --- liquid water [cm^-1] --------------------------------------------------
K_WATER = _interp([
    (400, 0.0007), (600, 0.002), (700, 0.006), (800, 0.02), (900, 0.068),
    (940, 0.27), (960, 0.45), (980, 0.43), (1000, 0.36), (1100, 0.17),
    (1150, 0.80), (1200, 1.00), (1250, 0.85), (1300, 1.20), (1350, 3.0),
    (1400, 14.0), (1450, 29.0), (1500, 20.0), (1550, 10.0), (1600, 6.7),
    (1650, 5.6), (1700, 5.6), (1750, 6.0), (1800, 8.0), (1850, 15.0),
    (1900, 100.0), (1950, 125.0), (2000, 65.0), (2050, 40.0),
    (2100, 26.0), (2150, 24.0), (2200, 27.0), (2250, 31.0), (2300, 37.0),
    (2350, 44.0), (2400, 55.0), (2450, 70.0), (2500, 88.0),
])

# --- dry matter [cm^2/g] ---------------------------------------------------
# Magnitudes set so a fresh canonical leaf (Cw=0.0176 cm, Cm=0.009
# g/cm^2) keeps the published ~0.15 reflectance at 2200 nm (water
# dominates there; dry matter adds the cellulose/lignin floor that takes
# over when Cw drops).
K_DRY = _interp([
    (400, 3.0), (600, 1.5), (800, 1.0), (1000, 2.0), (1200, 4.0),
    (1400, 5.0), (1500, 6.0), (1700, 10.0), (1800, 11.0), (2000, 16.0),
    (2100, 19.0), (2200, 22.0), (2300, 28.0), (2400, 32.0), (2500, 35.0),
])

# --- soil spectra ----------------------------------------------------------
SOIL_DRY_SPECTRUM = _interp([
    (400, 0.06), (500, 0.09), (600, 0.14), (700, 0.18), (800, 0.22),
    (900, 0.25), (1000, 0.27), (1200, 0.31), (1400, 0.31), (1600, 0.35),
    (1800, 0.36), (2000, 0.33), (2200, 0.37), (2400, 0.33), (2500, 0.31),
])
SOIL_WET_SPECTRUM = _interp([
    (400, 0.035), (600, 0.075), (800, 0.12), (1000, 0.14), (1200, 0.16),
    (1400, 0.12), (1600, 0.17), (1800, 0.17), (2000, 0.12), (2200, 0.16),
    (2400, 0.12), (2500, 0.10),
])


def band_average(spectrum: np.ndarray) -> np.ndarray:
    """SRF-weighted average of a fine-grid spectrum over the 10 S2 bands.

    MSI response functions are near-rectangular (steep band edges), so
    the weight is a flat-top super-Gaussian ``exp(-0.5 x^8)`` with
    half-width FWHM/2 — a plain Gaussian's long tails would leak e.g.
    red-edge chlorophyll absorption into the (chlorophyll-transparent)
    broad B08 NIR band."""
    out = np.empty(len(BAND_ORDER))
    for i, name in enumerate(BAND_ORDER):
        centre, fwhm = S2_BANDS[name]
        x = (WL - centre) / (fwhm / 2.0)
        w = np.exp(-0.5 * x**8)
        out[i] = (w * spectrum).sum() / w.sum()
    return out


#: band centre wavelengths [nm], reference band order
BAND_WAVELENGTHS = np.array([S2_BANDS[b][0] for b in BAND_ORDER])

#: per-band leaf refractive index
N_REFRACT = band_average(N_SPECTRUM)

#: band-averaged specific absorption, rows = (cab, car, cbrown, cw, cm)
#: with the units of ``prosail.inverse_transforms`` outputs
#: (ug/cm^2, ug/cm^2, -, cm, g/cm^2)
BAND_K = np.stack([
    band_average(K_CAB),
    band_average(K_CAR),
    band_average(K_BROWN),
    band_average(K_WATER),
    band_average(K_DRY),
])

SOIL_DRY = band_average(SOIL_DRY_SPECTRUM)
SOIL_WET = band_average(SOIL_WET_SPECTRUM)
