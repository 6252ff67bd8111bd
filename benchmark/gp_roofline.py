"""The least time of the GP emulator bank's row kernel
(``csrc/gp_rows.cu``) on one H100, counted from the kernel's source and
the configuration's sizes, not from anything the program reports: bytes
over the HBM roof or float32 operations over the peak rate, the larger
(``roofline.bound_s``).

Per launch, over ``n_pad`` pixels of a bank of ``bands`` GPs with ``m``
training points and ``k`` inputs each, on a ``p``-entry state:

- bytes: each pixel reads its ``p`` state entries once and writes a
  value and ``p`` Jacobian entries a band; the bank (kilobytes) is left
  out;
- operations, an FMA two: per (pixel, band, training point) ``k``
  subtractions, ``k`` FMAs for the squared distance, the exponential,
  the weight's product, its sum and ``k`` FMAs for the gradient
  (``5 k + 3``); per (pixel, band) ``k`` input scalings, the value's FMA
  and three operations a gradient entry (``4 k + 2``).  The staging of
  the training points (``m k`` products a band a block of 256 px) is
  left out.
"""

from __future__ import annotations

from benchmark.roofline import bound_s


def ops_per_point(k: int) -> int:
    return k + 2 * k + 1 + 1 + 1 + 2 * k


def ops_per_band(k: int) -> int:
    return k + 2 + 3 * k


def gp_rows_work(n_pad: int, p: int, bands: int, m: int, k: int) -> tuple:
    """(bytes, flops) of one launch."""
    bytes_moved = 4.0 * n_pad * (p + bands * (1 + p))
    flops = float(n_pad) * bands * (m * ops_per_point(k) + ops_per_band(k))
    return bytes_moved, flops


def gp_rows_bound_s(n_pad: int, p: int, bands: int, m: int, k: int) -> float:
    return bound_s(*gp_rows_work(n_pad, p, bands, m, k))
