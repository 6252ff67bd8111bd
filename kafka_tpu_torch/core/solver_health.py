"""Per-pixel solve-health verdicts, damping escalation, quarantine (port of
``kafka_tpu/core/solver_health.py``).

The semantics and the QA bitmask values are those of the JAX package —
the values land in ``solver_qa`` rasters, so they must stay identical:

================== === ==================================================
``QA_CONVERGED``     1 healthy, converged trajectory
``QA_CAP_BAILOUT``   2 hit ``max_iterations`` still moving (||dx||/p >= tol)
``QA_DAMPED_RECOVERED``
                     4 took the LM retreat and finished healthy
``QA_QUARANTINED``   8 still bad after escalation; output is the forecast
                       with deflated information
``QA_NODATA``       16 no valid observation in any band
================== === ==================================================

The plain solver, the fused kernels' plain versions (``core.fused_gn``,
``core.fused_update``) and the CUDA kernels (``csrc/fused_gn.cu``,
``csrc/fused_update.cu``) implement the same
detect -> retreat -> quarantine steps with these constants.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

QA_CONVERGED = 1
QA_CAP_BAILOUT = 2
QA_DAMPED_RECOVERED = 4
QA_QUARANTINED = 8
QA_NODATA = 16

#: multiplicative LM inflation of an escalated pixel's packed-A diagonal.
DAMP_DIAG = 10.0
#: absolute diagonal floor added under escalation (rescues a zero pivot).
DAMP_ABS = 1e-3
#: relaxation multiplier for escalated pixels' remaining steps.
DAMP_RELAX = 0.25
#: information deflation for quarantined pixels (sigma inflated 2x).
QUARANTINE_INFO_SCALE = 0.25

#: the chaos fault site name (the fault registry arrives in a later slice).
FAULT_SITE = "solver.pixel"


def chol_breakdown(l) -> torch.Tensor:
    """Pixels whose packed Cholesky factor has a non-positive or
    non-finite diagonal entry."""
    bad = torch.zeros_like(l[0][0], dtype=torch.bool)
    for j in range(len(l)):
        d = l[j][j]
        bad = bad | ~(d > 0) | ~torch.isfinite(d)
    return bad


def nonfinite_any(vectors) -> torch.Tensor:
    """Elementwise OR of non-finiteness over same-shape vectors."""
    bad = ~torch.isfinite(vectors[0])
    for v in vectors[1:]:
        bad = bad | ~torch.isfinite(v)
    return bad


def inflate_diag(a_ii, esc):
    """``a_ii * DAMP_DIAG + DAMP_ABS`` where ``esc`` (0/1 float) is set;
    exactly ``a_ii * 1.0 + 0.0`` for healthy pixels."""
    return a_ii * (1.0 + esc * (DAMP_DIAG - 1.0)) + esc * DAMP_ABS


def damped_relaxation(relaxation, esc):
    """Per-pixel relaxation: shrunk for escalated pixels."""
    return relaxation * (1.0 + esc * (DAMP_RELAX - 1.0))


def retreat(x_raw, x_prev, bad):
    """A bad pixel discards its raw step and holds position."""
    return torch.where(bad, x_prev, x_raw)


def quarantine_select(quarantined, fallback, value):
    """Quarantined pixels take ``fallback``; the rest keep ``value``."""
    return torch.where(quarantined, fallback, value)


def assemble_verdicts(observed, quarantined, cap_exit, moving,
                      escalated_ever) -> torch.Tensor:
    """Pack the per-pixel verdict bitmask (int32) from boolean vectors.
    ``cap_exit`` is a scalar or broadcastable bool."""
    i32 = torch.int32
    observed = observed.bool()
    quarantined = quarantined.bool() & observed
    cap = torch.as_tensor(cap_exit, device=moving.device)
    bailout = (
        torch.broadcast_to(cap, moving.shape).bool()
        & moving.bool() & observed & ~quarantined
    )
    recovered = escalated_ever.bool() & observed & ~quarantined
    converged = observed & ~quarantined & ~bailout
    return (
        converged.to(i32) * QA_CONVERGED
        + bailout.to(i32) * QA_CAP_BAILOUT
        + recovered.to(i32) * QA_DAMPED_RECOVERED
        + quarantined.to(i32) * QA_QUARANTINED
        + (~observed).to(i32) * QA_NODATA
    )


def verdict_counts(verdicts):
    """(cap_bailouts, damped_recoveries, quarantined) int32 scalars."""
    i32 = torch.int32
    return (
        ((verdicts & QA_CAP_BAILOUT) > 0).sum().to(i32),
        ((verdicts & QA_DAMPED_RECOVERED) > 0).sum().to(i32),
        ((verdicts & QA_QUARANTINED) > 0).sum().to(i32),
    )


def merge_verdicts(a, b):
    """OR-combine two verdict vectors; NODATA survives only where both
    solves saw no data."""
    return (((a | b) & ~QA_NODATA) | (a & b & QA_NODATA)).to(torch.int32)


#: the fault-injection site of per-pixel linearisation corruption.
FAULT_SITE = "solver.pixel"


def corruption_mask(n_pix: int) -> Optional[np.ndarray]:
    """The armed ``solver.pixel`` fault specs as a boolean (n_pix,) numpy
    mask of pixels whose linearisation must be corrupted (0-based index
    ranges through the calls grammar of ``resilience.faults``), or
    ``None`` when nothing is armed."""
    from ..resilience import faults

    if not faults.active():
        return None
    specs = faults.specs_for(FAULT_SITE)
    if not specs:
        return None
    mask = np.zeros((n_pix,), bool)
    for s in specs:
        first = max(0, int(s.first))
        last = n_pix - 1 if s.last is None else min(n_pix - 1, int(s.last))
        if last >= first:
            mask[first:last + 1] = True
    if not mask.any():
        return None
    faults.record_injection(
        FAULT_SITE, pixels=int(mask.sum()),
        ranges=[[int(s.first), None if s.last is None else int(s.last)]
                for s in specs],
    )
    return mask


def corrupt_h0(h0, corrupt):
    """Force the forecast observations of ``corrupt`` pixels to NaN in
    every band (pixels on the last axis)."""
    return torch.where(corrupt.bool(), float("nan"), h0)
