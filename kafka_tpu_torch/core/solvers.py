"""The variational-Kalman update (port of ``kafka_tpu/core/solvers.py``).

Per pixel the analysis solves the linearised normal equations

    A x = b,  A = sum_b r_inv_b J_b J_b^T + P_f^-1,
              b = sum_b r_inv_b y~_b J_b + P_f^-1 x_f,
    y~ = y + J x_lin - H0

inside a Gauss-Newton loop (reference constants: tol 1e-3 on
``||dx||_2 / numel``, at least 2 solves, bail after 25).

Paths, chosen by the ``use_pallas`` solver option (the JAX option keys
carry over unchanged, ``STRUCTURAL_OPTION_KEYS``).  Unset, or True, means
the fused path for every problem on the packed small-state path
(p <= ``UNROLL_MAX_P``, <= 32 bands):

- the in-kernel branch (``core.fused_gn``): the whole loop in one
  launch, for operators that advertise ``inkernel_linearize`` when the
  JAX engagement conditions hold (empty operator params, int iteration
  bounds, per-parameter state bounds, ``inkernel_linearize`` not opted
  out);
- otherwise the out-of-kernel row loop: linearise (blocked on big
  batches), then one launch of the fused update (``core.fused_update``,
  kernel 2) per Gauss-Newton iteration;

and ``{"use_pallas": False}`` opts out to the plain global-norm loop with
solve health (``_iterated_solve_health``).  Two modes keep the JAX
package's generic loop without solve health (``_iterated_solve_generic``):
``per_pixel_convergence`` (each step one ``kalman_update``, the fused
update on the packed path) and the dense large-p fallback (p > 16 or
more than 32 bands: ``build_normal_equations`` and a ``torch.linalg``
Cholesky, the counterpart of XLA's; unset ``use_pallas`` takes it,
an explicit True raises as in the JAX package).  ``hessian_forward``
subtracts the second-order correction (``core.hessian``) after any
path, under an eigenvalue floor.  ``assimilate_windows_scan`` runs a
block of fused windows (advance, then ``iterated_solve``, per window)
for the engine's temporal fusion.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import solver_health
from .fused_gn import fused_gn_rows
from .fused_update import fused_update, fused_update_rows, jac_to_rows
from .linalg import (
    UNROLL_MAX_P,
    cholesky_packed,
    eigh_blocked,
    pack_rows,
    solve_chol_vectors,
    solve_spd_batched,
    solve_spd_packed,
    tri_rows,
    unpack_rows,
    unpack_symmetric,
)
from .types import BandBatch, Linearization, SolveDiagnostics

CONVERGENCE_TOL = 1e-3
MIN_ITERATIONS = 2
MAX_ITERATIONS = 25

LinearizeFn = Callable[[Any, torch.Tensor], Linearization]

STRUCTURAL_OPTION_KEYS = (
    "linearize_block", "use_pallas", "per_pixel_convergence",
    "inkernel_linearize", "min_iterations", "max_iterations",
)

def build_normal_equations(lin: Linearization, obs: BandBatch, x_lin,
                           x_forecast, p_inv_forecast):
    """Dense assembly: ``A`` (n_pix, p, p) and ``b`` (n_pix, p), the large-p
    form of the JAX package.  The contractions run in float32 (TF32 is
    off for the whole package), the counterpart of its
    ``Precision.HIGHEST``."""
    f32 = torch.float32
    jac = lin.jac.to(f32)
    r_inv = obs.r_inv.to(f32)
    y_tilde = torch.where(
        obs.mask,
        obs.y.to(f32) + torch.einsum("bnp,np->bn", jac, x_lin.to(f32))
        - lin.h0.to(f32),
        0.0,
    )
    wj = jac * r_inv[..., None]
    a = torch.einsum("bnp,bnq->npq", wj, jac) + p_inv_forecast.to(f32)
    b = torch.einsum("bnp,bn->np", wj, y_tilde) + torch.einsum(
        "npq,nq->np", p_inv_forecast.to(f32), x_forecast.to(f32))
    return a, b


def build_normal_equations_packed(lin: Linearization, obs: BandBatch,
                                  x_lin, x_forecast, p_inv_forecast):
    """Packed-symmetric assembly: ``(a_packed, b)`` with
    ``a_packed[i][j]`` (n_pix,) for j <= i (mirrored), ``b`` (n_pix, p).
    Every operation is elementwise float32 (no TF32 contraction)."""
    f32 = torch.float32
    jac = lin.jac.to(f32)
    w = obs.r_inv.to(f32)
    n_bands, _, p = jac.shape
    jx = []
    for b in range(n_bands):
        s = jac[b, :, 0] * x_lin[:, 0]
        for k in range(1, p):
            s = s + jac[b, :, k] * x_lin[:, k]
        jx.append(s)
    # Relinearised pseudo-observation, zeroed where masked by a select
    # (masked y may hold NaN nodata).
    y_tilde = [
        torch.where(obs.mask[b], obs.y[b].to(f32) + jx[b] - lin.h0[b], 0.0)
        for b in range(n_bands)
    ]
    wj = [[w[b] * jac[b, :, i] for i in range(p)] for b in range(n_bands)]
    a_packed = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = p_inv_forecast[:, i, j].to(f32)
            for b in range(n_bands):
                s = s + wj[b][i] * jac[b, :, j]
            a_packed[i][j] = a_packed[j][i] = s
    b_cols = []
    for i in range(p):
        s = p_inv_forecast[:, i, 0].to(f32) * x_forecast[:, 0].to(f32)
        for q in range(1, p):
            s = s + (p_inv_forecast[:, i, q].to(f32)
                     * x_forecast[:, q].to(f32))
        for b in range(n_bands):
            s = s + wj[b][i] * y_tilde[b]
        b_cols.append(s)
    return a_packed, torch.stack(b_cols, dim=-1)


def _packed_update_health(lin, obs, x_lin, x_forecast, p_inv_forecast, esc):
    """One packed update with LM inflation of the factored diagonal for
    escalated pixels; returns ``(x_raw, a_packed, step_bad, x_nonfin)``."""
    a_packed, b = build_normal_equations_packed(
        lin, obs, x_lin, x_forecast, p_inv_forecast
    )
    p = x_forecast.shape[-1]
    chol_in = [row[:] for row in a_packed]
    for i in range(p):
        chol_in[i][i] = solver_health.inflate_diag(a_packed[i][i], esc)
    l = cholesky_packed(chol_in)
    x_cols = solve_chol_vectors(l, [b[..., i] for i in range(p)])
    x_nonfin = solver_health.nonfinite_any(x_cols)
    step_bad = solver_health.chol_breakdown(l) | x_nonfin
    return torch.stack(x_cols, dim=-1), a_packed, step_bad, x_nonfin


def kalman_update(lin: Linearization, obs: BandBatch, x_lin, x_forecast,
                  p_inv_forecast, use_pallas: bool = False):
    """One linearised update: ``(x_analysis, A)``.  Small states take the
    packed path (``use_pallas``: one launch of the fused update,
    ``core.fused_update``); p > ``UNROLL_MAX_P`` or more than 32 bands
    the dense assembly and library Cholesky, where ``use_pallas``
    raises as in the JAX package."""
    p = x_forecast.shape[-1]
    n_bands = lin.jac.shape[0]
    if p <= UNROLL_MAX_P and n_bands <= 32:
        if use_pallas:
            x, a_packed = fused_update(lin, obs, x_lin, x_forecast,
                                       p_inv_forecast)
            return x, unpack_symmetric(a_packed)
        a_packed, b = build_normal_equations_packed(
            lin, obs, x_lin, x_forecast, p_inv_forecast
        )
        return solve_spd_packed(a_packed, b), unpack_symmetric(a_packed)
    if use_pallas:
        raise NotImplementedError(
            "use_pallas covers the packed small-state path only "
            f"(p <= {UNROLL_MAX_P}, <= 32 bands); this problem has "
            f"p={p}, {n_bands} bands")
    a, b = build_normal_equations(lin, obs, x_lin, x_forecast,
                                  p_inv_forecast)
    return solve_spd_batched(a, b), a


def _kernel_bounds_rows(state_bounds, p: int):
    """None (no bounds), the (lo, hi) pair when both sides broadcast to
    (p,) vectors, or False for per-pixel bounds."""
    if state_bounds is None:
        return None
    for v in state_bounds:
        nd = v.ndim if hasattr(v, "ndim") else np.ndim(v)
        shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
        if nd > 1 or (nd == 1 and shape[0] != p):
            return False
    return state_bounds


def _params_empty(operator_params) -> bool:
    if operator_params is None:
        return True
    if isinstance(operator_params, dict):
        return all(_params_empty(v) for v in operator_params.values())
    if isinstance(operator_params, (list, tuple)):
        return all(_params_empty(v) for v in operator_params)
    return False


def _bounds_rows(state_bounds, n_pix: int, p: int, dev):
    """``(lo, hi)`` in row layout for the row loop: scalars broadcast,
    ``(p,)`` vectors become ``(p, 1)``, ``(n_pix, p)`` arrays ``(p, n_pix)``
    (the shapes ``torch.clamp`` of the plain loop accepts); anything else
    raises here with a shape message."""
    def to_rows(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        if v.ndim == 0:
            return v
        if v.ndim == 1:
            if v.shape[0] != p:
                raise ValueError(f"state_bounds vector has {v.shape[0]} "
                                 f"entries for p={p} parameters")
            return v[:, None]
        if v.ndim == 2:
            if tuple(v.shape) != (n_pix, p):
                raise ValueError(
                    f"state_bounds array has shape {tuple(v.shape)}; "
                    f"expected (n_pix, p) = ({n_pix}, {p})")
            return v.T
        raise ValueError("state_bounds must be scalar, (p,) or (n_pix, p); "
                         f"got ndim={v.ndim}")

    lo, hi = state_bounds
    return to_rows(lo), to_rows(hi)


def _iterated_solve_rows(linearize, obs, x_forecast, p_inv_forecast,
                         operator_params, tol, min_iterations,
                         max_iterations, relaxation, state_bounds,
                         norm_denominator, linearize_block=None,
                         inkernel_linearize=True, corrupt=None):
    """The fused path in row layout (JAX ``_iterated_solve_rows``).

    The in-kernel branch runs the whole loop in ``fused_gn_rows`` when
    the operator advertises ``inkernel_linearize``, the operator params
    are empty, the iteration bounds are ints and the bounds are
    per-parameter.  Otherwise the out-of-kernel row loop: P_f^-1 is packed
    to (tri(p), n) rows once, the iterate is carried as (p, n) rows, and
    each iteration linearises (in blocks when ``linearize_block`` is
    smaller than the batch) and launches the fused update once; the LM
    retreat, damped relaxation and bounds projection run around it, and
    the loop keeps the while loop's post-increment cap."""
    f32 = torch.float32
    n_pix, p = x_forecast.shape
    n_bands = obs.y.shape[0]
    dev = x_forecast.device
    numel = (n_pix * p) if norm_denominator is None else norm_denominator
    xf_rows = x_forecast.T.to(f32).contiguous()
    pf_rows = pack_rows(p_inv_forecast)
    y = obs.y.to(f32).contiguous()
    w = obs.r_inv.to(f32).contiguous()
    mask_f = obs.mask.to(f32).contiguous()
    owner = getattr(linearize, "__self__", None)
    kernel_bounds = _kernel_bounds_rows(state_bounds, p)
    if (
        inkernel_linearize
        and owner is not None
        and getattr(owner, "inkernel_linearize", False)
        and _params_empty(operator_params)
        and isinstance(min_iterations, int)
        and isinstance(max_iterations, int)
        and kernel_bounds is not False
    ):
        cor = None if corrupt is None else corrupt.to(f32).contiguous()
        x_rows, a_rows, fwd, inn, n_done, norm, verd, nonfin, clip_sat = \
            fused_gn_rows(
                owner.kernel_linearize_rows, y, w, mask_f, xf_rows, pf_rows,
                tol, min_iterations, max_iterations, relaxation,
                kernel_bounds, numel, corrupt=cor, device=dev,
            )
        return (x_rows.T, unpack_rows(a_rows), fwd, inn, n_done, norm,
                (verd, nonfin, clip_sat))

    use_block = linearize_block is not None \
        and 0 < int(linearize_block) < n_pix
    lo = hi = None
    if state_bounds is not None:
        lo, hi = _bounds_rows(state_bounds, n_pix, p, dev)
    tol_t = torch.tensor(float(np.float32(tol)), dtype=f32, device=dev)
    numel_t = torch.tensor(float(numel), dtype=f32, device=dev)
    relax_t = torch.tensor(float(relaxation), dtype=f32, device=dev)

    def body_step(x_rows, esc):
        x_cols = x_rows.T
        if use_block:
            lin = _blocked_linearize(linearize, operator_params, x_cols,
                                     int(linearize_block))
        else:
            lin = _call_linearize(linearize, operator_params, x_cols)
        h0 = lin.h0.to(f32)
        if corrupt is not None:
            h0 = solver_health.corrupt_h0(h0, corrupt)
        h0 = h0.contiguous()
        jac_rows = jac_to_rows(lin.jac.to(f32))
        del lin
        x_raw, a_rows, inn, hb = fused_update_rows(
            jac_rows, h0, y, w, mask_f, x_rows, xf_rows, pf_rows,
            esc[None, :].contiguous())
        step_bad = hb[0] > 0
        # LM retreat: bad pixels hold position, escalated pixels take
        # shrunk-relaxation steps; healthy arithmetic is unchanged.
        esc_now = torch.maximum(esc, step_bad.to(f32))
        x_tgt = solver_health.retreat(x_raw, x_rows, step_bad[None, :])
        relax_eff = solver_health.damped_relaxation(relax_t, esc_now)[None, :]
        x_new = x_rows + relax_eff * (x_tgt - x_rows)
        at_bound = None
        if lo is not None:
            x_new = torch.minimum(torch.maximum(x_new, lo), hi)
            at_bound = (x_new <= lo) | (x_new >= hi)
        # fwd = J (x - x_f) + H0 at the damped, projected iterate.
        fwd = []
        for b in range(n_bands):
            s = jac_rows[b * p] * (x_new[0] - xf_rows[0])
            for k in range(1, p):
                s = s + jac_rows[b * p + k] * (x_new[k] - xf_rows[k])
            fwd.append(s + h0[b])
        return (x_new.contiguous(), a_rows, torch.stack(fwd), inn, esc_now,
                step_bad, hb[1] > 0, at_bound)

    x_rows = xf_rows
    a_rows = torch.zeros((tri_rows(p), n_pix), dtype=f32, device=dev)
    fwd = torch.zeros((n_bands, n_pix), dtype=f32, device=dev)
    inn = torch.zeros((n_bands, n_pix), dtype=f32, device=dev)
    esc = torch.zeros(n_pix, dtype=f32, device=dev)
    nonfin = torch.zeros(n_pix, dtype=f32, device=dev)
    bad_now = torch.zeros(n_pix, dtype=f32, device=dev)
    ssq = torch.full((n_pix,), float("inf"), dtype=f32, device=dev)
    clip = torch.ones((p, n_pix), dtype=f32, device=dev)
    n_done = 0
    norm = torch.tensor(float("inf"), dtype=f32, device=dev)
    while True:
        # One host sync per iteration: the while loop's condition.
        converged = bool(norm < tol_t) and n_done >= min_iterations
        if converged or n_done > max_iterations:
            break
        x_new, a_rows, fwd, inn, esc, step_bad, x_nonfin, at_bound = \
            body_step(x_rows, esc)
        if at_bound is not None:
            clip = clip * at_bound.to(f32)
        step = x_new - x_rows
        norm = torch.linalg.vector_norm(step) / numel_t
        nonfin = torch.maximum(nonfin, x_nonfin.to(f32))
        bad_now = step_bad.to(f32)
        ssq = (step * step).sum(dim=0)
        x_rows = x_new
        n_done += 1
    # Quarantine: still-bad pixels fall back to the forecast with
    # deflated information; their fwd/innovation diagnostics are zeroed.
    observed = obs.mask.any(dim=0)
    quar = (
        (bad_now > 0)
        | solver_health.nonfinite_any([x_rows[k] for k in range(p)])
        | solver_health.nonfinite_any(
            [a_rows[r] for r in range(tri_rows(p))])
    ) & observed
    x_rows = solver_health.quarantine_select(quar[None, :], xf_rows, x_rows)
    a_rows = solver_health.quarantine_select(
        quar[None, :], solver_health.QUARANTINE_INFO_SCALE * pf_rows, a_rows)
    fwd = solver_health.quarantine_select(quar[None, :], 0.0, fwd)
    inn = solver_health.quarantine_select(quar[None, :], 0.0, inn)
    moving_sq = float(np.float32(np.float32(tol) * np.float32(p)) ** 2)
    verd = solver_health.assemble_verdicts(
        observed, quar, n_done > max_iterations, ssq >= moving_sq, esc > 0,
    )
    nonfin_count = ((nonfin > 0) & observed).sum().to(torch.int32)
    if lo is not None:
        clip_sat = ((clip > 0) & observed[None, :]).sum(dim=1) \
            .to(torch.int32)
    else:
        clip_sat = torch.zeros(p, dtype=torch.int32, device=dev)
    n_done_t = torch.tensor(n_done, dtype=torch.int32, device=dev)
    return (x_rows.T, unpack_rows(a_rows), fwd, inn, n_done_t, norm,
            (verd, nonfin_count, clip_sat))


def _iterated_solve_health(one_lin, obs, x_forecast, p_inv_forecast, tol,
                           min_iterations, max_iterations, relaxation,
                           state_bounds, numel):
    """Global-norm Gauss-Newton loop with per-pixel solve health (the
    plain path).  Iteration semantics of the JAX while loop: stop when
    ``||dx||_2 / numel < tol`` after at least ``min_iterations`` solves,
    or once more than ``max_iterations`` solves ran."""
    f32 = torch.float32
    n_pix, p = x_forecast.shape
    dev = x_forecast.device
    tol_t = torch.tensor(float(np.float32(tol)), dtype=f32, device=dev)
    numel_t = torch.tensor(float(numel), dtype=f32, device=dev)
    relax_t = torch.tensor(float(relaxation), dtype=f32, device=dev)
    lo = hi = None
    if state_bounds is not None:
        lo, hi = (torch.as_tensor(v, dtype=f32, device=dev)
                  for v in state_bounds)

    x = x_forecast.to(f32)
    a = h0 = jac = None
    esc = torch.zeros(n_pix, dtype=f32, device=dev)
    nonfin = torch.zeros(n_pix, dtype=f32, device=dev)
    bad_now = torch.zeros(n_pix, dtype=f32, device=dev)
    ssq = torch.full((n_pix,), float("inf"), dtype=f32, device=dev)
    clip = torch.ones((n_pix, p), dtype=f32, device=dev)
    n_done = 0
    norm = torch.tensor(float("inf"), dtype=f32, device=dev)
    while True:
        converged = bool(norm < tol_t) and n_done >= min_iterations
        if converged or n_done > max_iterations:
            break
        x_prev = x
        lin = one_lin(x_prev)
        x_raw, a_packed, step_bad, x_nonfin = _packed_update_health(
            lin, obs, x_prev, x_forecast, p_inv_forecast, esc
        )
        esc = torch.maximum(esc, step_bad.to(f32))
        x_tgt = solver_health.retreat(x_raw, x_prev, step_bad[:, None])
        relax_eff = solver_health.damped_relaxation(relax_t, esc)[:, None]
        x = x_prev + relax_eff * (x_tgt - x_prev)
        if lo is not None:
            x = torch.minimum(torch.maximum(x, lo), hi)
            clip = clip * ((x <= lo) | (x >= hi)).to(f32)
        step = x - x_prev
        norm = torch.linalg.vector_norm(step) / numel_t
        a = unpack_symmetric(a_packed)
        h0, jac = lin.h0, lin.jac
        nonfin = torch.maximum(nonfin, x_nonfin.to(f32))
        bad_now = step_bad.to(f32)
        ssq = (step * step).sum(dim=-1)
        n_done += 1
    observed = obs.mask.any(dim=0)
    quar = (
        (bad_now > 0)
        | solver_health.nonfinite_any([x[:, k] for k in range(p)])
        | solver_health.nonfinite_any(
            [a[:, i, j] for i in range(p) for j in range(i + 1)])
    ) & observed
    x = solver_health.quarantine_select(quar[:, None], x_forecast, x)
    a = solver_health.quarantine_select(
        quar[:, None, None],
        solver_health.QUARANTINE_INFO_SCALE * p_inv_forecast, a,
    )
    fwd = torch.einsum("bnp,np->bn", jac, x - x_forecast) + h0
    fwd = solver_health.quarantine_select(quar[None, :], 0.0, fwd)
    innovations = torch.where(obs.mask, obs.y - h0, 0.0)
    innovations = solver_health.quarantine_select(quar[None, :], 0.0,
                                                  innovations)
    moving_sq = float(np.float32(np.float32(tol) * np.float32(p)) ** 2)
    verd = solver_health.assemble_verdicts(
        observed, quar, n_done > max_iterations, ssq >= moving_sq, esc > 0,
    )
    nonfin_count = ((nonfin > 0) & observed).sum().to(torch.int32)
    if lo is not None:
        clip_sat = ((clip > 0) & observed[:, None]).sum(dim=0) \
            .to(torch.int32)
    else:
        clip_sat = torch.zeros(p, dtype=torch.int32, device=dev)
    n_done_t = torch.tensor(n_done, dtype=torch.int32, device=dev)
    return x, a, fwd, innovations, n_done_t, norm, \
        (verd, nonfin_count, clip_sat)


def _iterated_solve_generic(one_lin, obs, x_forecast, p_inv_forecast, tol,
                            min_iterations, max_iterations, relaxation,
                            state_bounds, numel, use_fused,
                            per_pixel_convergence):
    """The JAX package's generic while loop (no solve health): one
    ``kalman_update`` per step (``use_fused``: the fused update), a
    damped, bounds-projected step, and either the global norm or the
    per-pixel freeze.  Returns ``(x, A, fwd, innovations, n_done, norm,
    frozen)`` with ``frozen`` None in global-norm mode.

    Per-pixel mode freezes a pixel after TWO consecutive steps with
    ``||dx_i||_2 / p < tol`` (an oscillating pixel's step dips below tol
    at each turn), counts only unfrozen steps in the norm, and stops
    once every pixel froze (after ``min_iterations``) or past the cap."""
    f32 = torch.float32
    n_pix, p = x_forecast.shape
    n_bands = obs.y.shape[0]
    dev = x_forecast.device
    tol_t = torch.tensor(float(np.float32(tol)), dtype=f32, device=dev)
    numel_t = torch.tensor(float(numel), dtype=f32, device=dev)
    relax_t = torch.tensor(float(relaxation), dtype=f32, device=dev)
    lo = hi = None
    if state_bounds is not None:
        lo, hi = (torch.as_tensor(v, dtype=f32, device=dev)
                  for v in state_bounds)
    x = x_forecast.to(f32)
    a = torch.zeros((n_pix, p, p), dtype=f32, device=dev)
    h0 = torch.zeros((n_bands, n_pix), dtype=f32, device=dev)
    jac = torch.zeros((n_bands, n_pix, p), dtype=f32, device=dev)
    frozen = small = None
    if per_pixel_convergence:
        frozen = torch.zeros(n_pix, dtype=torch.bool, device=dev)
        small = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    n_done = 0
    norm = torch.tensor(float("inf"), dtype=f32, device=dev)
    while True:
        # One host sync per iteration: the while loop's condition.
        if per_pixel_convergence:
            done = bool(frozen.all()) and n_done >= min_iterations
        else:
            done = bool(norm < tol_t) and n_done >= min_iterations
        if done or n_done > max_iterations:
            break
        x_prev = x
        lin = one_lin(x_prev)
        x_new, a = kalman_update(lin, obs, x_prev, x_forecast,
                                 p_inv_forecast, use_pallas=use_fused)
        x_new = x_prev + relax_t * (x_new - x_prev)
        if lo is not None:
            x_new = torch.minimum(torch.maximum(x_new, lo), hi)
        step = x_new - x_prev
        if per_pixel_convergence:
            pix_norm = torch.sqrt((step * step).sum(dim=-1)) / p
            x = torch.where(frozen[:, None], x_prev, x_new)
            small_now = pix_norm < tol_t
            newly = small_now & small if n_done + 1 >= min_iterations \
                else torch.zeros_like(small_now)
            norm = torch.sqrt((torch.where(frozen[:, None], 0.0, step) ** 2)
                              .sum()) / numel_t
            frozen = frozen | newly
            small = small_now
        else:
            x = x_new
            norm = torch.linalg.vector_norm(step) / numel_t
        h0, jac = lin.h0.to(f32), lin.jac.to(f32)
        n_done += 1
    # Diagnostics of the reference: fwd = J (x_a - x_f) + H0, innovations
    # y - H0 at the last linearisation.
    fwd = torch.einsum("bnp,np->bn", jac, x - x_forecast) + h0
    innovations = torch.where(obs.mask, obs.y - h0, 0.0)
    n_done_t = torch.tensor(n_done, dtype=torch.int32, device=dev)
    return x, a, fwd, innovations, n_done_t, norm, frozen


def iterated_solve(linearize: LinearizeFn, obs: BandBatch, x_forecast,
                   p_inv_forecast, operator_params: Any = None,
                   tol: float = CONVERGENCE_TOL,
                   min_iterations: int = MIN_ITERATIONS,
                   max_iterations: int = MAX_ITERATIONS,
                   relaxation: float = 1.0, state_bounds: Any = None,
                   norm_denominator: Any = None, hessian_forward: Any = None,
                   linearize_block: Any = None, use_pallas=None,
                   per_pixel_convergence: bool = False,
                   inkernel_linearize: bool = True, corrupt: Any = None):
    """Gauss-Newton relinearisation loop; returns ``(x_analysis,
    p_inv_analysis, diagnostics)``.  Options mean what they mean in the
    JAX ``iterated_solve``; ``use_pallas=None`` (the port's default)
    means the fused path wherever the packed path applies, as ``True``
    does there; ``False`` is the plain loop."""
    n_pix, p = x_forecast.shape
    n_bands = obs.y.shape[0]
    numel = (n_pix * p) if norm_denominator is None else norm_denominator
    packed = p <= UNROLL_MAX_P and n_bands <= 32
    use_block = linearize_block is not None \
        and 0 < int(linearize_block) < n_pix

    def one_lin(x_prev):
        if use_block:
            lin = _blocked_linearize(linearize, operator_params, x_prev,
                                     int(linearize_block))
        else:
            lin = _call_linearize(linearize, operator_params, x_prev)
        if corrupt is not None:
            lin = lin._replace(h0=solver_health.corrupt_h0(lin.h0, corrupt))
        return lin

    frozen = health = None
    if packed and not per_pixel_convergence:
        if use_pallas is None or use_pallas:
            x, a, fwd, innovations, n_done, norm, health = \
                _iterated_solve_rows(
                    linearize, obs, x_forecast, p_inv_forecast,
                    operator_params, tol, min_iterations, max_iterations,
                    relaxation, state_bounds, norm_denominator,
                    linearize_block, inkernel_linearize=inkernel_linearize,
                    corrupt=corrupt,
                )
        else:
            x, a, fwd, innovations, n_done, norm, health = \
                _iterated_solve_health(
                    one_lin, obs, x_forecast, p_inv_forecast, tol,
                    min_iterations, max_iterations, relaxation,
                    state_bounds, numel,
                )
    else:
        use_fused = packed if use_pallas is None else bool(use_pallas)
        x, a, fwd, innovations, n_done, norm, frozen = \
            _iterated_solve_generic(
                one_lin, obs, x_forecast, p_inv_forecast, tol,
                min_iterations, max_iterations, relaxation, state_bounds,
                numel, use_fused, per_pixel_convergence,
            )
    return _finish_solve(x, a, fwd, innovations, n_done, norm, obs,
                         state_bounds, health, frozen=frozen,
                         hessian_forward=hessian_forward,
                         operator_params=operator_params)


def linear_solve(lin: Linearization, obs: BandBatch, x_forecast,
                 p_inv_forecast):
    """Single-shot update for linear observation operators:
    ``(x, A, diagnostics)`` with one iteration and a zero norm (the JAX
    ``linear_solve``)."""
    x, a = kalman_update(lin, obs, x_forecast, x_forecast, p_inv_forecast)
    fwd = torch.einsum("bnp,np->bn", lin.jac, x - x_forecast) + lin.h0
    innovations = torch.where(obs.mask, obs.y - fwd, 0.0)
    dev = x.device
    diags = SolveDiagnostics(
        innovations=innovations, fwd_modelled=fwd,
        n_iterations=torch.ones((), dtype=torch.int32, device=dev),
        convergence_norm=torch.zeros((), dtype=torch.float32, device=dev),
    )
    return x, a, diags


def _window_telemetry_scalars(x, innovations, obs, state_bounds):
    """Per-window diagnostic scalars: per-band innovation chi^2 over
    valid pixels, state entries at a bound (observed pixels only), and
    masked-out observation entries (padding included)."""
    count_b = obs.mask.sum(dim=1)
    chi2 = (innovations.float() ** 2 * obs.r_inv).sum(dim=1) \
        / count_b.clamp(min=1).float()
    nodata = (~obs.mask).sum().to(torch.int32)
    if state_bounds is None:
        clipped = torch.zeros((), dtype=torch.int32, device=x.device)
    else:
        lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                  for v in state_bounds)
        observed = obs.mask.any(dim=0)
        at_bound = (x <= lo) | (x >= hi)
        clipped = (at_bound & observed[:, None]).sum().to(torch.int32)
    return chi2, clipped, nodata


def eigenvalue_floor(a: torch.Tensor) -> torch.Tensor:
    """Clamp each pixel's eigenvalues to ``1e-6 * max(|w_max|, 1e-3)``
    (the JAX package's PSD guard after the unguarded second-order
    subtraction).  Only pixels off the cone take the rebuilt matrix;
    the others keep their exact A (the eigh round trip would smear
    ~1e-7 over every pixel).  Eigenvector signs do not matter: the
    rebuild ``V diag(w) V^T`` is invariant to them."""
    w, v = eigh_blocked(a)
    floor = 1e-6 * torch.clamp(w[..., -1:].abs(), min=1e-3)
    fixed = torch.einsum("nij,nj,nkj->nik", v, torch.maximum(w, floor), v)
    bad = w[..., 0] < floor[..., 0]
    return torch.where(bad[:, None, None], fixed, a)


def _finish_solve(x, a, fwd, innovations, n_done, norm, obs,
                  state_bounds=None, health=None, frozen=None,
                  hessian_forward=None, operator_params=None):
    """Shared post-loop tail: the optional second-order Hessian
    correction (under the eigenvalue floor) and the diagnostics."""
    if hessian_forward is not None:
        from .hessian import hessian_correction

        # A ``(params, x_pixel)`` forward is closed over the date's params.
        fwd_pixel = functools.partial(_call_linearize, hessian_forward,
                                      operator_params)
        a = eigenvalue_floor(a - hessian_correction(
            fwd_pixel, x, obs.r_inv, innovations, obs.mask))
    chi2, clipped, nodata = _window_telemetry_scalars(
        x, innovations, obs, state_bounds
    )
    verdicts = nonfin = clip_sat = cap = damped = quar = None
    if health is not None:
        verdicts, nonfin, clip_sat = health
        cap, damped, quar = solver_health.verdict_counts(verdicts)
    diags = SolveDiagnostics(
        innovations=innovations, fwd_modelled=fwd, n_iterations=n_done,
        convergence_norm=norm, converged_mask=frozen, chi2_per_band=chi2,
        clipped_count=clipped, nodata_count=nodata,
        health_verdicts=verdicts, cap_bailout_count=cap,
        damped_recovered_count=damped, quarantined_count=quar,
        nonfinite_count=nonfin, clip_saturated_count=clip_sat,
    )
    return x, a, diags


def _call_linearize(linearize, operator_params, x):
    """Support ``f(params, x)`` and plain ``f(x)`` closures (a linearise
    or a per-pixel forward)."""
    try:
        n_args = len(inspect.signature(linearize).parameters)
    except (ValueError, TypeError):
        n_args = 2
    if n_args >= 2:
        return linearize(operator_params, x)
    return linearize(x)


def _aux_leaves(tree):
    """The leaves of an aux tree (dict / list / tuple / NamedTuple; any
    other value is a leaf), in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _aux_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _aux_leaves(v)]
    return [tree]


def _aux_rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in ``_aux_leaves`` order, from
    the iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _aux_rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_aux_rebuild(v, leaves) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return next(leaves)


def _pad_edge(t: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad the leading axis by repeating its last entry ``n_pad`` times."""
    if n_pad == 0:
        return t
    return torch.cat([t, t[-1:].expand((n_pad,) + tuple(t.shape[1:]))])


def _blocked_linearize(linearize, operator_params, x, block: int):
    """Linearise in sequential pixel blocks to bound peak device memory
    (the JAX ``_blocked_linearize``: ``block`` is a maximum, the pixels
    split evenly into the fewest blocks that respect it, the last block
    edge-padded).  Per-pixel aux leaves are sliced with their pixels and
    the rest closed over; the operator's ``aux_in_axes`` decides which is
    which (0 = per pixel), and plain closures fall back to the
    leading-axis test."""
    n_pix = x.shape[0]
    n_blocks = -(-n_pix // block)
    block = -(-n_pix // n_blocks)
    n_pad = n_blocks * block - n_pix
    x_pad = _pad_edge(x, n_pad)
    leaves = _aux_leaves(operator_params)
    owner = getattr(linearize, "__self__", None)
    if owner is not None and hasattr(owner, "aux_in_axes"):
        axes = _aux_leaves(owner.aux_in_axes(operator_params, n_pix))
        per_pixel = [a == 0 for a in axes]
    else:
        per_pixel = [isinstance(leaf, torch.Tensor) and leaf.ndim > 0
                     and leaf.shape[0] == n_pix for leaf in leaves]
    padded = [_pad_edge(leaf, n_pad) if flag else leaf
              for leaf, flag in zip(leaves, per_pixel)]
    h0s, jacs = [], []
    for s in range(0, n_blocks * block, block):
        block_leaves = [leaf[s:s + block] if flag else leaf
                        for leaf, flag in zip(padded, per_pixel)]
        params = _aux_rebuild(operator_params, iter(block_leaves))
        lin = _call_linearize(linearize, params, x_pad[s:s + block])
        h0s.append(lin.h0)
        jacs.append(lin.jac)
    return Linearization(h0=torch.cat(h0s, dim=1)[:, :n_pix],
                         jac=torch.cat(jacs, dim=1)[:, :n_pix])


def _split_structural_options(opts: dict):
    """Pop the structural options out of ``opts`` (in place) and return
    ``(linearize_block, use_pallas, per_pixel, inkernel, min_it,
    max_it)``; ``use_pallas`` stays None when unset."""
    block = opts.pop("linearize_block", None)
    use_pallas = opts.pop("use_pallas", None)
    inkernel = bool(opts.pop("inkernel_linearize", True))
    per_pixel = bool(opts.pop("per_pixel_convergence", False))
    min_it = opts.pop("min_iterations", None)
    max_it = opts.pop("max_iterations", None)
    return (
        None if block is None else int(block),
        None if use_pallas is None else bool(use_pallas),
        per_pixel, inkernel,
        None if min_it is None else int(min_it),
        None if max_it is None else int(max_it),
    )


def assimilate_date(linearize: LinearizeFn, obs: BandBatch, x_forecast,
                    p_inv_forecast, operator_params: Any = None,
                    solver_options: Any = None,
                    hessian_forward: Any = None, device=None):
    """One date's full multi-band assimilation — the counterpart of the
    JAX ``assimilate_date_jit``.  Inputs (tensors or numpy arrays) are
    placed on ``device`` (default CUDA; raises without one)."""
    from .. import resolve_device

    dev = resolve_device(device)
    f32 = torch.float32
    obs = BandBatch(
        y=torch.as_tensor(obs.y, dtype=f32, device=dev),
        r_inv=torch.as_tensor(obs.r_inv, dtype=f32, device=dev),
        mask=torch.as_tensor(obs.mask, device=dev).bool(),
    )
    x_forecast = torch.as_tensor(x_forecast, dtype=f32, device=dev)
    p_inv_forecast = torch.as_tensor(p_inv_forecast, dtype=f32, device=dev)
    opts = dict(solver_options or {})
    block, use_pallas, per_pixel, inkernel, min_it, max_it = \
        _split_structural_options(opts)
    if min_it is not None:
        opts["min_iterations"] = min_it
    if max_it is not None:
        opts["max_iterations"] = max_it
    corrupt = solver_health.corruption_mask(x_forecast.shape[0])
    return iterated_solve(
        linearize, obs, x_forecast, p_inv_forecast, operator_params,
        hessian_forward=hessian_forward, linearize_block=block,
        use_pallas=use_pallas, per_pixel_convergence=per_pixel,
        inkernel_linearize=inkernel,
        corrupt=None if corrupt is None
        else torch.as_tensor(corrupt, dtype=f32, device=dev),
        **opts,
    )


class ScanWindowStats(NamedTuple):
    """Per-window telemetry stacked over a fused block (the JAX
    ``ScanWindowStats``): the same quantities as the trailing
    ``SolveDiagnostics`` fields, so the whole block's scalars are read in
    one packed device->host transfer.  The solve-health fields are None
    when the block ran a mode without health tracking; ``health_verdicts``
    is the one per-pixel member (the QA band's source)."""

    chi2_per_band: torch.Tensor   # (K, n_bands)
    clipped_count: torch.Tensor   # (K,) int32
    nodata_count: torch.Tensor    # (K,) int32
    cap_bailout_count: Any = None       # (K,) int32
    damped_recovered_count: Any = None  # (K,) int32
    quarantined_count: Any = None       # (K,) int32
    nonfinite_count: Any = None         # (K,) int32
    clip_saturated_count: Any = None    # (K, p) int32
    health_verdicts: Any = None         # (K, n_pix) int32 QA bitmask


def stack_aux(auxes):
    """Stack a list of same-structure aux trees along a new leading window
    axis (tensor leaves; None stays None)."""
    if auxes[0] is None:
        return None
    leaves = [_aux_leaves(a) for a in auxes]
    return _aux_rebuild(auxes[0], iter(
        torch.stack([torch.as_tensor(leaf) for leaf in column])
        for column in zip(*leaves)))


def _aux_at(aux_stacked, k: int):
    if aux_stacked is None:
        return None
    return _aux_rebuild(aux_stacked, iter(
        leaf[k] for leaf in _aux_leaves(aux_stacked)))


def assimilate_windows_scan(linearize: LinearizeFn, obs_stacked: BandBatch,
                            x_analysis0, p_inv_analysis0,
                            aux_stacked: Any = None, m_matrix=None,
                            q_diag=None, prior_mean=None, prior_inv=None,
                            state_propagator=None,
                            solver_options: Any = None,
                            hessian_forward: Any = None):
    """K consecutive advance -> assimilate windows (the JAX
    ``assimilate_windows_scan``; torch has no ``lax.scan``, so this is a
    loop with the same carry ``(x_a, P^-1_a)``).  Each step advances the
    previous analysis with ``propagators.advance`` and runs
    ``iterated_solve`` with the options ``assimilate_date`` would give it
    — the same operations in the same order as the unfused date path, so
    the two give the same bits.

    ``obs_stacked`` is a ``BandBatch`` of ``(K, n_bands, n_pix)``;
    ``aux_stacked`` an aux tree whose leaves carry the same leading axis
    (``stack_aux``).  The prior, if any, must be date-invariant.

    Returns ``(x_final, p_inv_final, xs (K, n, p), p_inv_diags (K, n, p),
    n_iterations (K,), convergence_norms (K,), converged_masks ((K, n)
    bool under ``per_pixel_convergence``, else None), window_stats)``."""
    from .linalg import batched_diagonal, spd_inverse_batched
    from .propagators import advance as advance_fn

    dev = x_analysis0.device
    p = x_analysis0.shape[-1]
    opts = dict(solver_options or {})
    block, use_pallas, per_pixel, inkernel, min_it, max_it = \
        _split_structural_options(opts)
    if min_it is not None:
        opts["min_iterations"] = min_it
    if max_it is not None:
        opts["max_iterations"] = max_it
    if m_matrix is None:
        m_matrix = torch.eye(p, dtype=torch.float32, device=dev)
    if q_diag is None:
        q_diag = torch.zeros(p, dtype=torch.float32, device=dev)
    # The solver.pixel fault mask: one for the whole block (the armed
    # pixel set is positional, not temporal).
    corrupt = solver_health.corruption_mask(x_analysis0.shape[0])
    if corrupt is not None:
        corrupt = torch.as_tensor(corrupt, dtype=torch.float32, device=dev)
    x_a, p_inv_a = x_analysis0, p_inv_analysis0
    steps = []
    for k in range(obs_stacked.y.shape[0]):
        bands_k = BandBatch(y=obs_stacked.y[k], r_inv=obs_stacked.r_inv[k],
                            mask=obs_stacked.mask[k])
        x_f, p_f, p_f_inv = advance_fn(
            x_a, None, p_inv_a, m_matrix, q_diag, prior_mean=prior_mean,
            prior_cov_inverse=prior_inv, state_propagator=state_propagator)
        if p_f_inv is None:
            p_f_inv = spd_inverse_batched(p_f.float())
        x_a, p_inv_a, diags = iterated_solve(
            linearize, bands_k, x_f, p_f_inv, _aux_at(aux_stacked, k),
            hessian_forward=hessian_forward, linearize_block=block,
            use_pallas=use_pallas, per_pixel_convergence=per_pixel,
            inkernel_linearize=inkernel, corrupt=corrupt, **opts)
        steps.append((x_a, batched_diagonal(p_inv_a), diags))
    xs = torch.stack([s[0] for s in steps])
    diag_s = torch.stack([s[1] for s in steps])

    def stacked(field, dtype=None):
        vals = [torch.as_tensor(getattr(s[2], field), device=dev)
                for s in steps]
        out = torch.stack(vals)
        return out if dtype is None else out.to(dtype)

    iters = stacked("n_iterations", torch.int32)
    norms = stacked("convergence_norm", torch.float32)
    health = {}
    if steps[0][2].health_verdicts is not None:
        health = {f: stacked(f) for f in (
            "cap_bailout_count", "damped_recovered_count",
            "quarantined_count", "nonfinite_count", "clip_saturated_count",
            "health_verdicts")}
    stats = ScanWindowStats(
        chi2_per_band=stacked("chi2_per_band"),
        clipped_count=stacked("clipped_count"),
        nodata_count=stacked("nodata_count"), **health)
    converged = stacked("converged_mask") if per_pixel else None
    return x_a, p_inv_a, xs, diag_s, iters, norms, converged, stats
