"""Second-order (Hessian) correction of the posterior information matrix
(port of ``kafka_tpu/core/hessian.py``).

The Gauss-Newton Hessian ``J^T R^-1 J + P_f^-1`` drops the term
``sum_b r_inv_b * innov_b * d2H_b/dx2``; the reference subtracts it per
pixel after convergence.  The second derivative comes from
``torch.func.hessian`` (forward over reverse, as ``jax.hessian``) of the
per-pixel forward model, ``torch.func.vmap``-ed over pixels.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import hessian, vmap

#: Pixels per vmap chunk: bounds the forward-over-reverse intermediates
#: on a tile (nothing couples pixels, so chunking changes no value).
HESSIAN_CHUNK = 262144


def hessian_correction(forward_per_pixel: Callable[[torch.Tensor],
                                                   torch.Tensor],
                       x_analysis: torch.Tensor, r_inv: torch.Tensor,
                       innovations: torch.Tensor,
                       obs_mask: torch.Tensor) -> torch.Tensor:
    """The ``(n_pix, p, p)`` correction to subtract from the analysis
    information matrix.

    ``forward_per_pixel`` maps one pixel's state ``(p,)`` to its
    ``(n_bands,)`` forward-modelled observations; ``x_analysis`` is
    ``(n_pix, p)``, ``r_inv``, ``innovations`` (``y - H0``) and
    ``obs_mask`` are ``(n_bands, n_pix)``.  Masked entries contribute a
    zero block."""
    ddh = vmap(hessian(forward_per_pixel),
               chunk_size=HESSIAN_CHUNK)(x_analysis)  # (n, B, p, p)
    weight = (r_inv * innovations * obs_mask).T       # (n, B)
    return torch.einsum("nb,nbpq->npq", weight.to(ddh.dtype), ddh)
