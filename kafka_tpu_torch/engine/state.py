"""State-mask pixel gathering: rasters <-> fixed-shape pixel batches
(a copy of ``kafka_tpu/engine/state.py``).

The reference carries boolean state masks through every layer and builds
variable-size vectors from ``mask[state_mask]`` selections (e.g.
KaFKA ``kafka/inference/utils.py:155-167``).  Variable sizes are
hostile to batched kernels; here the mask is resolved ONCE into a gather index list,
padded to a fixed pixel count (a multiple of ``pad_multiple``), and
every raster is gathered into that layout on the host before device upload.
Padding pixels carry ``r_inv = 0`` observations and an identity-information
prior, so they ride along in the batched solves at full speed and are simply
never scattered back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PixelGather:
    """Precomputed mapping between a 2-D state mask and the padded flat
    pixel batch."""

    mask: np.ndarray          # (ny, nx) bool
    rows: np.ndarray          # (n_valid,) row index of each valid pixel
    cols: np.ndarray          # (n_valid,)
    n_valid: int
    n_pad: int                # padded batch size (>= n_valid)

    @property
    def valid(self) -> np.ndarray:
        """(n_pad,) bool — True for real pixels, False for padding."""
        out = np.zeros(self.n_pad, bool)
        out[: self.n_valid] = True
        return out

    def gather(self, raster: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """(ny, nx [, ...]) raster -> (n_pad [, ...]) pixel batch."""
        vals = np.asarray(raster)[self.rows, self.cols]
        pad_shape = (self.n_pad,) + vals.shape[1:]
        out = np.full(pad_shape, fill, dtype=vals.dtype)
        out[: self.n_valid] = vals
        return out

    def scatter(self, pixel_values: np.ndarray,
                fill: float = 0.0) -> np.ndarray:
        """(n_pad [, ...]) batch -> (ny, nx [, ...]) raster, padding
        dropped, unmasked pixels set to ``fill`` (the reference writes 0
        outside the mask, ``observations.py:375-377``)."""
        pixel_values = np.asarray(pixel_values)
        out_shape = self.mask.shape + pixel_values.shape[1:]
        out = np.full(out_shape, fill, dtype=pixel_values.dtype)
        out[self.rows, self.cols] = pixel_values[: self.n_valid]
        return out


def make_pixel_gather(state_mask: np.ndarray,
                      pad_multiple: int = 256) -> PixelGather:
    """Build the gather for a boolean state mask.  ``pad_multiple`` keeps
    the pixel count a multiple of the fused kernel's pixel groups."""
    mask = np.asarray(state_mask).astype(bool)
    rows, cols = np.nonzero(mask)
    n_valid = int(rows.size)
    n_pad = max(int(np.ceil(max(n_valid, 1) / pad_multiple)) * pad_multiple,
                pad_multiple)
    return PixelGather(
        mask=mask, rows=rows, cols=cols, n_valid=n_valid, n_pad=n_pad
    )
