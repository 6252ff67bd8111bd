"""Core tensor containers (port of ``kafka_tpu/core/types.py``).

Same layouts as the JAX package: the state is ``(n_pix, p)``, the
information matrix ``(n_pix, p, p)``, band data ``(n_bands, n_pix)``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class BandBatch(NamedTuple):
    """All observations of one date, batched over bands.

    - ``y``:     ``(n_bands, n_pix)`` observed values.
    - ``r_inv``: ``(n_bands, n_pix)`` inverse variance (0 where masked).
    - ``mask``:  ``(n_bands, n_pix)`` bool, True where valid.  Masked
      ``y`` may hold NaN nodata; every consumer excludes it by select.
    """

    y: torch.Tensor
    r_inv: torch.Tensor
    mask: torch.Tensor


class GaussianState(NamedTuple):
    """Per-pixel Gaussian belief in information form: ``x`` (n_pix, p),
    ``p_inv`` (n_pix, p, p), optional covariance ``p``."""

    x: torch.Tensor
    p_inv: Optional[torch.Tensor]
    p: Optional[torch.Tensor] = None


class Linearization(NamedTuple):
    """``h0`` (n_bands, n_pix) forward model at the linearisation point,
    ``jac`` (n_bands, n_pix, p) its Jacobian."""

    h0: torch.Tensor
    jac: torch.Tensor


class SolveDiagnostics(NamedTuple):
    """Extras returned by the iterated solve; field meanings are those of
    ``kafka_tpu.core.types.SolveDiagnostics``."""

    innovations: torch.Tensor
    fwd_modelled: torch.Tensor
    n_iterations: torch.Tensor
    convergence_norm: torch.Tensor
    converged_mask: Any = None
    chi2_per_band: Any = None
    clipped_count: Any = None
    nodata_count: Any = None
    health_verdicts: Any = None
    cap_bailout_count: Any = None
    damped_recovered_count: Any = None
    quarantined_count: Any = None
    nonfinite_count: Any = None
    clip_saturated_count: Any = None
    #: the mean Gauss-Newton trips over the date's ``fused_gn``
    #: convergence groups (float32 scalar); None off that route and on a
    #: mesh.
    mean_trips: Any = None


def flat_to_pixel_major(x_flat: torch.Tensor, n_params: int) -> torch.Tensor:
    """``(n_pix*p,)`` interleaved reference layout -> ``(n_pix, p)``."""
    return x_flat.reshape(-1, n_params)


def pixel_major_to_flat(x: torch.Tensor) -> torch.Tensor:
    """``(n_pix, p)`` -> the reference's interleaved flat layout."""
    return x.reshape(-1)


def block_diag_to_batched(p_mat: Any, n_params: int) -> np.ndarray:
    """Dense or scipy block-diagonal ``(n_pix*p, n_pix*p)`` ->
    ``(n_pix, p, p)`` numpy: a host-side helper for interop with the
    reference layout."""
    if hasattr(p_mat, "toarray"):
        p_mat = p_mat.toarray()
    p_mat = np.asarray(p_mat)
    n = p_mat.shape[0] // n_params
    out = np.empty((n, n_params, n_params), dtype=p_mat.dtype)
    for i in range(n):
        sl = slice(i * n_params, (i + 1) * n_params)
        out[i] = p_mat[sl, sl]
    return out
