"""Carry state from the JAX package into the port.

Takes plain numpy (e.g. ``np.asarray`` of JAX arrays — this module never
imports JAX) and returns the port's tensors on a device, so both
packages can compute the same thing from the same numbers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import resolve_device
from .core.propagators import PixelPrior
from .core.types import BandBatch
from .engine.priors import (JOINT_PARAMETER_LIST, PROSAIL_PARAMETER_LIST,
                            WCM_PARAMETER_LIST, FixedGaussianPrior,
                            joint_prior_arrays, sail_prior_arrays,
                            wcm_prior_arrays)
from .obsops.gp import GPParams
from .obsops.prosail import ProsailAux
from .obsops.wcm import WCMAux


def tensor(a, device=None, dtype=torch.float32) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=resolve_device(device))


def pixel_prior(mean, cov, inv_cov, device=None) -> PixelPrior:
    """``PixelPrior`` from numpy mean (p,), cov and inv_cov (p, p)."""
    return PixelPrior(mean=tensor(mean, device), cov=tensor(cov, device),
                      inv_cov=tensor(inv_cov, device))


def fixed_gaussian_prior(mean, cov, inv_cov, parameter_list: Sequence[str],
                         device=None) -> FixedGaussianPrior:
    """``FixedGaussianPrior`` from the numpy fields of a JAX one."""
    return FixedGaussianPrior(pixel_prior(mean, cov, inv_cov, device),
                              parameter_list)


def band_batch(y, r_inv, mask, device=None) -> BandBatch:
    """``BandBatch`` from numpy ``y``/``r_inv`` (float) and ``mask``."""
    return BandBatch(y=tensor(y, device), r_inv=tensor(r_inv, device),
                     mask=tensor(mask, device, dtype=torch.bool))


def state(x, p_inv, device=None):
    """``(x, p_inv)`` state tensors; ``p_inv`` may be None."""
    return tensor(x, device), None if p_inv is None else tensor(p_inv,
                                                               device)


def solver_options(opts, device=None) -> dict:
    """A solver-option dict with array-valued ``state_bounds`` moved to
    ``device``; every other option passes through unchanged."""
    out = dict(opts or {})
    if out.get("state_bounds") is not None:
        lo, hi = out["state_bounds"]
        out["state_bounds"] = (tensor(lo, device), tensor(hi, device))
    return out


def prosail_aux(aux, device=None) -> ProsailAux:
    """A port ``ProsailAux`` from the JAX one's fields (numpy-convertible
    scalars or ``(n_pix,)`` arrays): each angle becomes a float32 tensor
    on ``device``, 0-d when it was a scalar, so broadcast and per-pixel
    leaves keep their roles."""
    return ProsailAux(*(tensor(v, device) for v in (aux.sza, aux.vza,
                                                     aux.raa)))


def sail_prior(mean=None, cov=None, inv_cov=None,
               device=None) -> FixedGaussianPrior:
    """The SAIL prior from the numpy fields of the JAX ``sail_prior()``
    (its constants when none are given)."""
    if mean is None:
        mean, cov, inv_cov = sail_prior_arrays()
    return fixed_gaussian_prior(mean, cov, inv_cov, PROSAIL_PARAMETER_LIST,
                                device)


def wcm_prior(mean=None, cov=None, inv_cov=None,
              device=None) -> FixedGaussianPrior:
    """The WCM prior from the numpy fields of the JAX ``wcm_prior()``
    (its constants when none are given)."""
    if mean is None:
        mean, cov, inv_cov = wcm_prior_arrays()
    return fixed_gaussian_prior(mean, cov, inv_cov, WCM_PARAMETER_LIST,
                                device)


def joint_prior(mean=None, cov=None, inv_cov=None,
                device=None) -> FixedGaussianPrior:
    """The joint S2 + S1 prior from the numpy fields of the JAX
    ``joint_prior()`` (its constants when none are given)."""
    if mean is None:
        mean, cov, inv_cov = joint_prior_arrays()
    return fixed_gaussian_prior(mean, cov, inv_cov, JOINT_PARAMETER_LIST,
                                device)


def wcm_aux(aux, device=None) -> WCMAux:
    """A port ``WCMAux`` from the JAX one: the incidence angle as a
    float32 tensor, 0-d when it was a scalar, ``(n_pix,)`` per pixel."""
    return WCMAux(theta_deg=tensor(aux.theta_deg, device))


def gp_params(params, device=None) -> GPParams:
    """Port ``GPParams`` from the JAX ones' numpy-convertible fields (one
    emulator or a stacked bank)."""
    return GPParams(*(tensor(getattr(params, f), device)
                      for f in GPParams._fields))


def mlp_params(params, device=None) -> list:
    """The port's MLP parameter list from the JAX one (a list of
    ``{"w", "b"}`` dicts of arrays)."""
    return [{k: tensor(layer[k], device) for k in ("w", "b")}
            for layer in params]
