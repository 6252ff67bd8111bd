"""Clamps with JAX's derivative rule at ties, shared by the operators.

``jnp.maximum`` / ``jnp.minimum`` (and ``jnp.clip``, built from them)
split the tangent half and half where both arguments are equal;
``torch.clamp`` passes it whole to the input.  The solver projects
iterates onto the state bounds, and several bounds coincide with clip
limits inside the operators, so clipped pixels sit exactly on such ties:
``torch.maximum`` / ``torch.minimum`` against a tensor constant follow
the JAX rule, and every clamp of the physics goes through these.  The
constant comes from the per-device cache (``core.device_constants``):
made once per value, dtype and device, never copied per call.
"""

from __future__ import annotations

import torch

from ..core.device_constants import device_constant


def _max(x, c):
    return torch.maximum(x, device_constant(c, x.dtype, x.device))


def _min(x, c):
    return torch.minimum(x, device_constant(c, x.dtype, x.device))


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    return _min(_max(x, lo), hi)
