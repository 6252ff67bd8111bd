"""Clamps with JAX's derivative rule at ties, shared by the operators.

``jnp.maximum`` / ``jnp.minimum`` (and ``jnp.clip``, built from them)
split the tangent half and half where both arguments are equal;
``torch.clamp`` passes it whole to the input.  The solver projects
iterates onto the state bounds, and several bounds coincide with clip
limits inside the operators, so clipped pixels sit exactly on such ties:
``torch.maximum`` / ``torch.minimum`` against a tensor constant follow
the JAX rule, and every clamp of the physics goes through these.
"""

from __future__ import annotations

import torch


def _max(x, c):
    return torch.maximum(x, torch.as_tensor(c, dtype=x.dtype,
                                            device=x.device))


def _min(x, c):
    return torch.minimum(x, torch.as_tensor(c, dtype=x.dtype,
                                            device=x.device))


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    return _min(_max(x, lo), hi)
