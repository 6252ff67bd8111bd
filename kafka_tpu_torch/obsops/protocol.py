"""Observation-operator protocol (port of ``kafka_tpu/obsops/protocol.py``).

An operator is a differentiable PyTorch function of one pixel's state,
``forward_pixel(aux, x_pixel) -> (n_bands,)``; the batched ``forward``
and ``linearize`` derive from it with ``torch.func`` (``vmap`` over
pixels, ``jacfwd`` per pixel; ``hessian`` for second derivatives) — the
counterparts of ``jax.vmap``, ``jax.jacfwd`` and ``jax.hessian`` in the
JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.func import hessian, jacfwd, vmap

from ..core.types import Linearization


def _aux_in_dims(aux: Any, n_pix: int):
    """vmap in_dims for an aux tree of tensors (dict / list / tuple /
    NamedTuple): leaves with a leading ``n_pix`` axis are mapped, the
    rest broadcast."""
    if isinstance(aux, dict):
        return {k: _aux_in_dims(v, n_pix) for k, v in aux.items()}
    if isinstance(aux, (list, tuple)):
        items = [_aux_in_dims(v, n_pix) for v in aux]
        # A NamedTuple takes its fields as arguments, a tuple or list an
        # iterable.
        if hasattr(aux, "_fields"):
            return type(aux)(*items)
        return type(aux)(items)
    if isinstance(aux, torch.Tensor) and aux.ndim > 0 \
            and aux.shape[0] == n_pix:
        return 0
    return None


class ObservationModel:
    """Base class: subclasses implement ``forward_pixel``; ``forward`` and
    ``linearize`` derive from it."""

    n_bands: int
    n_params: int
    #: False disables the leading-axis aux detection (shared weights).
    aux_per_pixel: bool = True
    #: Optional (lower, upper) per-parameter physical domain.
    state_bounds = None
    #: Operators implementing ``kernel_linearize_rows`` set this True: the
    #: whole Gauss-Newton loop then runs in the fused kernel
    #: (``core.fused_gn.fused_gn_rows``).
    inkernel_linearize: bool = False

    def forward_pixel(self, aux: Any, x_pixel: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kernel_linearize_rows(self, x_rows):
        """Row-layout value + Jacobian: a tuple of ``p`` state rows ->
        ``(h0, jac)`` with ``h0`` a list of ``n_bands`` rows and
        ``jac[b][k]`` the ``dH0[b]/dx[k]`` row.  Only consulted when
        ``inkernel_linearize`` is True."""
        raise NotImplementedError

    def aux_in_axes(self, aux: Any, n_pix: int):
        if not self.aux_per_pixel:
            return None if aux is None else _aux_in_dims(aux, -1)
        return _aux_in_dims(aux, n_pix)

    def forward(self, aux: Any, x: torch.Tensor) -> torch.Tensor:
        """(n_pix, p) -> (n_bands, n_pix) predicted observations."""
        dims = self.aux_in_axes(aux, x.shape[0])
        return vmap(self.forward_pixel, in_dims=(dims, 0))(aux, x).T

    def linearize(self, aux: Any, x: torch.Tensor) -> Linearization:
        """(n_pix, p) -> Linearization(h0 (B, n_pix), jac (B, n_pix, p))."""
        dims = self.aux_in_axes(aux, x.shape[0])

        def value_and_jac(a, xi):
            h0 = self.forward_pixel(a, xi)
            jac = jacfwd(lambda z: self.forward_pixel(a, z))(xi)
            return h0, jac

        h0, jac = vmap(value_and_jac, in_dims=(dims, 0))(aux, x)
        return Linearization(h0=h0.T, jac=jac.permute(1, 0, 2))

    def hessian(self, aux: Any, x: torch.Tensor) -> torch.Tensor:
        """(n_pix, p) -> (n_pix, n_bands, p, p) second derivatives
        (``torch.func.hessian``, forward over reverse, per pixel)."""
        dims = self.aux_in_axes(aux, x.shape[0])
        return vmap(
            lambda a, xi: hessian(lambda z: self.forward_pixel(a, z))(xi),
            in_dims=(dims, 0))(aux, x)


class BandView(ObservationModel):
    """A single-band view of a multi-band operator, the unit of the
    reference's band-sequential assimilation (each band's posterior
    becomes the next band's prior).  The view evaluates the inner
    operator's whole forward and keeps one band, as in the JAX package."""

    def __init__(self, inner: ObservationModel, band: int):
        self.inner = inner
        self.band = int(band)
        self.n_bands = 1
        self.n_params = inner.n_params
        self.state_bounds = getattr(inner, "state_bounds", None)
        self.aux_per_pixel = getattr(inner, "aux_per_pixel", True)

    def forward_pixel(self, aux: Any, x_pixel: torch.Tensor) -> torch.Tensor:
        return self.inner.forward_pixel(aux, x_pixel)[
            self.band:self.band + 1
        ]

    def aux_in_axes(self, aux: Any, n_pix: int):
        return self.inner.aux_in_axes(aux, n_pix)


class MappedStateModel(ObservationModel):
    """Wraps a sub-state operator into the full state vector by per-band
    index mapping (the reference's ``state_mapper`` pattern): band ``b``
    reads the parameters ``state_mappers[b]`` of the state.

    ``inner.forward_band_pixel(aux, b, sub)`` returns that one band's
    value, ``(1,)``-shaped, from ``sub``, the band's parameters as a list
    of ``(1,)``-shaped slices (as ``TwoStreamOperator`` takes them: under
    ``torch.func.jacfwd`` a 0-d tensor times a Python float gets a
    float64 tangent); this wrapper evaluates it once per band."""

    def __init__(self, inner, state_mappers, n_params: int):
        self.inner = inner
        # Host constants: each band's gather is a fixed list of slices.
        self.mappers = np.asarray(state_mappers)  # (n_bands, k)
        self.n_bands = int(self.mappers.shape[0])
        self.n_params = n_params

    def forward_pixel(self, aux: Any, x_pixel: torch.Tensor) -> torch.Tensor:
        def one_band(b):
            sub = [x_pixel[int(i):int(i) + 1] for i in self.mappers[b]]
            return self.inner.forward_band_pixel(aux, b, sub).reshape(1)

        return torch.cat([one_band(b) for b in range(self.n_bands)])
