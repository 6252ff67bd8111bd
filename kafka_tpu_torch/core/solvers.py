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

from . import collective, solver_health
from .device_constants import device_constant
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
from ..telemetry.spans import span

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


def _bound(v, dev) -> torch.Tensor:
    """A state bound as float32 on ``dev``: a scalar or ``(p,)`` bound
    from the per-device constants; a tensor, or a per-pixel array (an
    input of the call), moved as it is."""
    if isinstance(v, torch.Tensor) or np.ndim(v) > 1:
        return torch.as_tensor(v, dtype=torch.float32, device=dev)
    return device_constant(v, torch.float32, dev)


def _bounds_rows(state_bounds, n_pix: int, p: int, dev):
    """``(lo, hi)`` in row layout for the row loop: scalars broadcast,
    ``(p,)`` vectors become ``(p, 1)``, ``(n_pix, p)`` arrays ``(p, n_pix)``
    (the shapes ``torch.clamp`` of the plain loop accepts); anything else
    raises here with a shape message."""
    def to_rows(v):
        v = _bound(v, dev)
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


def _inkernel_ok(linearize, operator_params, min_iterations,
                 max_iterations, state_bounds, p: int,
                 inkernel_linearize) -> bool:
    """The JAX engagement conditions of the in-kernel branch: the
    operator advertises ``inkernel_linearize``, its params are empty,
    the iteration bounds are ints and the bounds are per-parameter."""
    owner = getattr(linearize, "__self__", None)
    return bool(
        inkernel_linearize
        and owner is not None
        and getattr(owner, "inkernel_linearize", False)
        and _params_empty(operator_params)
        and isinstance(min_iterations, int)
        and isinstance(max_iterations, int)
        and _kernel_bounds_rows(state_bounds, p) is not False
    )


def _gn_rows_inputs(obs, x_forecast, p_inv_forecast, corrupt):
    """The fused Gauss-Newton kernel's row inputs of one problem:
    ``(y, w, mask_f, xf_rows, pf_rows, corrupt)``."""
    f32 = torch.float32
    return (obs.y.to(f32).contiguous(), obs.r_inv.to(f32).contiguous(),
            obs.mask.to(f32).contiguous(), x_forecast.T.to(f32).contiguous(),
            pack_rows(p_inv_forecast),
            None if corrupt is None else corrupt.to(f32).contiguous())


def _gn_rows_result(summary):
    """The row path's return tuple from ``fused_gn.summarise`` (its
    groups' mean trips, where it gives them, the health tuple's last)."""
    x_rows, a_rows, fwd, inn, n_done, norm, verd, nonfin, clip_sat = \
        summary[:9]
    mean_trips = summary[9] if len(summary) > 9 else None
    return (x_rows.T, unpack_rows(a_rows), fwd, inn, n_done, norm,
            (verd, nonfin, clip_sat, mean_trips))


def _iterated_solve_rows(linearize, obs, x_forecast, p_inv_forecast,
                         operator_params, tol, min_iterations,
                         max_iterations, relaxation, state_bounds,
                         norm_denominator, linearize_block=None,
                         inkernel_linearize=True, corrupt=None):
    """The fused path in row layout (JAX ``_iterated_solve_rows``).

    The in-kernel branch runs the whole loop in ``fused_gn_rows`` when
    ``_inkernel_ok`` holds.  Otherwise the out-of-kernel row loop
    (``_row_loop``, one launch of the fused update per iteration)."""
    n_pix, p = x_forecast.shape
    numel = (n_pix * p) if norm_denominator is None else norm_denominator
    inkernel = _inkernel_ok(linearize, operator_params, min_iterations,
                            max_iterations, state_bounds, p,
                            inkernel_linearize)
    if inkernel:
        y, w, mask_f, xf_rows, pf_rows, cor = _gn_rows_inputs(
            obs, x_forecast, p_inv_forecast, corrupt)
        args = (linearize.__self__.kernel_linearize_rows, y, w, mask_f,
                xf_rows, pf_rows, tol, min_iterations, max_iterations,
                relaxation, _kernel_bounds_rows(state_bounds, p), numel)
        if collective.current() is None:
            return _gn_rows_result(fused_gn_rows(
                *args, corrupt=cor, device=x_forecast.device,
                mean_trips=True))
        # A mesh shard: every pixel in the unsharded run's group, the
        # groups straddling shards launched once for all of them.
        from .fused_gn import fused_gn_shard

        return _gn_rows_result(fused_gn_shard(*args, corrupt=cor))
    return run_loops([_row_loop(
        linearize, obs, x_forecast, p_inv_forecast, operator_params, tol,
        min_iterations, max_iterations, relaxation, state_bounds,
        norm_denominator, linearize_block, corrupt)])[0]


#: argument positions of ``fused_update_rows`` that stay the same
#: tensors for a problem's whole loop (y, w, mask, x_f and P_f^-1 rows).
_LOOP_CONSTANT_ARGS = (2, 3, 4, 6, 7)


def run_loops(loops):
    """Run solver-loop generators (``_row_loop``, ``_generic_loop``) in
    lockstep and return their results.  A loop yields one of three
    requests and is sent its answer:

    - ``("sync", flag)``: its loop condition, a device bool; every
      member's flag of the round is read in ONE host transfer;
    - ``("update", args)``: the arguments of ``fused_update_rows``; ONE
      launch over every member asking, their pixel axes concatenated
      (the kernel is per pixel, so each member's pixels get the bits a
      launch of its own would give);
    - ``("dense", a, b)``: a dense p > 16 update; ONE
      ``solve_spd_batched`` (one ``cholesky_ex``, one pair of triangular
      solves) over the members' stacked matrices.  Each member's x must
      be the bits of a call of its own: the CPU tests hold that, and
      ``chip_smoke.py``'s phase batch_modes on the card, where cuSOLVER
      could pick another algorithm for another batch size.

    A finished loop drops out and keeps its bytes; everything else each
    loop computes on its own slice."""
    results = [None] * len(loops)
    pending = {}

    def advance(k, sent):
        try:
            pending[k] = loops[k].send(sent)
        except StopIteration as stop:
            results[k] = stop.value

    for k in range(len(loops)):
        advance(k, None)
    joined, joined_for = {}, None
    while pending:
        keys = sorted(pending)
        by_kind = {}
        for k in keys:
            by_kind.setdefault(pending[k][0], []).append(k)
        if "sync" in by_kind:
            ks = by_kind["sync"]
            flags = [pending.pop(k)[1] for k in ks]
            with span("loop_sync", per_date=True):
                if len(flags) == 1:
                    values = [bool(flags[0])]
                else:
                    # kafkalint: disable=host-transfer-in-jit — the
                    # lockstep driver's one read of every member's loop
                    # condition per step (the census's pinned host read).
                    values = torch.stack(flags).tolist()
            for k, v in zip(ks, values):
                advance(k, bool(v))
            continue
        if "update" in by_kind:
            ks = by_kind["update"]
            if ks != joined_for:  # a member finished: rejoin the rest
                joined, joined_for = {}, ks
            outs = _joint_update([pending.pop(k)[1] for k in ks], joined)
            for k, out in zip(ks, outs):
                advance(k, out)
        if "dense" in by_kind:
            ks = by_kind["dense"]
            reqs = [pending.pop(k) for k in ks]
            a, b = ((torch.cat([r[i] for r in reqs]) if len(reqs) > 1
                     else reqs[0][i]) for i in (1, 2))
            outs = torch.split(solve_spd_batched(a, b),
                               [r[2].shape[0] for r in reqs])
            for k, out in zip(ks, outs):
                advance(k, out)
    return results


def _joint_update(args, joined):
    """One ``fused_update_rows`` launch over the members' row arguments
    (``joined`` caches the concatenated loop-constant rows); each
    member's outputs back on its own slice."""
    if len(args) == 1:
        return [fused_update_rows(*args[0])]
    widths = [a[5].shape[1] for a in args]
    cat = []
    for i in range(len(args[0])):
        if i in _LOOP_CONSTANT_ARGS:
            if i not in joined:
                joined[i] = torch.cat([a[i] for a in args], -1)
            cat.append(joined[i])
        else:
            cat.append(torch.cat([a[i] for a in args], dim=-1))
    raw = fused_update_rows(*cat)
    parts = [torch.split(t, widths, dim=-1) for t in raw]
    return [tuple(part[m].contiguous() for part in parts)
            for m in range(len(args))]


def _row_loop(linearize, obs, x_forecast, p_inv_forecast, operator_params,
              tol, min_iterations, max_iterations, relaxation, state_bounds,
              norm_denominator, linearize_block=None, corrupt=None):
    """The out-of-kernel row loop of one problem, as a generator driven
    by ``run_loops``: P_f^-1 is packed to (tri(p), n) rows once, the
    iterate is carried as (p, n) rows, and each iteration yields its
    loop condition, linearises (in blocks when ``linearize_block`` is
    smaller than the batch), YIELDS the fused update's arguments and
    receives its outputs; the LM retreat, damped relaxation and bounds
    projection run around it, and the loop keeps the while loop's
    post-increment cap.  Returns the row path's result tuple."""
    f32 = torch.float32
    n_pix, p = x_forecast.shape
    n_bands = obs.y.shape[0]
    dev = x_forecast.device
    numel = (n_pix * p) if norm_denominator is None else norm_denominator
    y, w, mask_f, xf_rows, pf_rows, _ = _gn_rows_inputs(
        obs, x_forecast, p_inv_forecast, None)
    use_block = linearize_block is not None \
        and 0 < int(linearize_block) < n_pix
    lo = hi = None
    if state_bounds is not None:
        lo, hi = _bounds_rows(state_bounds, n_pix, p, dev)
    tol_t = torch.full((), float(np.float32(tol)), dtype=f32, device=dev)
    numel_t = torch.full((), float(numel), dtype=f32, device=dev)
    relax_t = torch.full((), float(relaxation), dtype=f32, device=dev)

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
    norm = torch.full((), float("inf"), dtype=f32, device=dev)
    while True:
        # The while loop's condition: one host read per round.
        below = yield "sync", norm < tol_t
        if (below and n_done >= min_iterations) or n_done > max_iterations:
            break
        x_cols = x_rows.T
        with span("linearize", per_date=True):
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
        x_raw, a_rows, inn, hb = yield "update", (
            jac_rows, h0, y, w, mask_f, x_rows, xf_rows, pf_rows,
            esc[None, :].contiguous())
        step_bad = hb[0] > 0
        # LM retreat: bad pixels hold position, escalated pixels take
        # shrunk-relaxation steps; healthy arithmetic is unchanged.
        esc = torch.maximum(esc, step_bad.to(f32))
        x_tgt = solver_health.retreat(x_raw, x_rows, step_bad[None, :])
        relax_eff = solver_health.damped_relaxation(relax_t, esc)[None, :]
        x_new = x_rows + relax_eff * (x_tgt - x_rows)
        if lo is not None:
            x_new = torch.minimum(torch.maximum(x_new, lo), hi)
            clip = clip * ((x_new <= lo) | (x_new >= hi)).to(f32)
        # fwd = J (x - x_f) + H0 at the damped, projected iterate.
        fwd = []
        for b in range(n_bands):
            s = jac_rows[b * p] * (x_new[0] - xf_rows[0])
            for k in range(1, p):
                s = s + jac_rows[b * p + k] * (x_new[k] - xf_rows[k])
            fwd.append(s + h0[b])
        fwd = torch.stack(fwd)
        x_new = x_new.contiguous()
        step = x_new - x_rows
        norm = collective.step_norm(step, numel_t)
        nonfin = torch.maximum(nonfin, (hb[1] > 0).to(f32))
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
    n_done_t = torch.full((), n_done, dtype=torch.int32, device=dev)
    return (x_rows.T, unpack_rows(a_rows), fwd, inn, n_done_t, norm,
            (verd, nonfin_count, clip_sat, None))


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
    tol_t = torch.full((), float(np.float32(tol)), dtype=f32, device=dev)
    numel_t = torch.full((), float(numel), dtype=f32, device=dev)
    relax_t = torch.full((), float(relaxation), dtype=f32, device=dev)
    lo = hi = None
    if state_bounds is not None:
        lo, hi = (_bound(v, dev) for v in state_bounds)

    x = x_forecast.to(f32)
    a = h0 = jac = None
    esc = torch.zeros(n_pix, dtype=f32, device=dev)
    nonfin = torch.zeros(n_pix, dtype=f32, device=dev)
    bad_now = torch.zeros(n_pix, dtype=f32, device=dev)
    ssq = torch.full((n_pix,), float("inf"), dtype=f32, device=dev)
    clip = torch.ones((n_pix, p), dtype=f32, device=dev)
    n_done = 0
    norm = torch.full((), float("inf"), dtype=f32, device=dev)
    while True:
        with span("loop_sync", per_date=True):
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
        norm = collective.step_norm(step, numel_t)
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
    n_done_t = torch.full((), n_done, dtype=torch.int32, device=dev)
    return x, a, fwd, innovations, n_done_t, norm, \
        (verd, nonfin_count, clip_sat, None)


def _iterated_solve_generic(one_lin, obs, x_forecast, p_inv_forecast, tol,
                            min_iterations, max_iterations, relaxation,
                            state_bounds, numel, use_fused,
                            per_pixel_convergence):
    """The JAX package's generic while loop (no solve health) of one
    problem: ``_generic_loop`` driven alone.  Returns ``(x, A, fwd,
    innovations, n_done, norm, frozen)`` with ``frozen`` None in
    global-norm mode."""
    return run_loops([_generic_loop(
        one_lin, obs, x_forecast, p_inv_forecast, tol, min_iterations,
        max_iterations, relaxation, state_bounds, numel, use_fused,
        per_pixel_convergence)])[0]


def _generic_loop(one_lin, obs, x_forecast, p_inv_forecast, tol,
                  min_iterations, max_iterations, relaxation, state_bounds,
                  numel, use_fused, per_pixel_convergence):
    """The generic while loop as a generator driven by ``run_loops``: one
    ``kalman_update`` per step (``use_fused``: the fused update, whose
    row arguments it YIELDS; the dense p > 16 update yields its normal
    equations), a damped, bounds-projected step, and either the global
    norm or the per-pixel freeze.  Each step first yields its loop
    condition.

    Per-pixel mode freezes a pixel after TWO consecutive steps with
    ``||dx_i||_2 / p < tol`` (an oscillating pixel's step dips below tol
    at each turn), counts only unfrozen steps in the norm, and stops
    once every pixel froze (after ``min_iterations``) or past the cap.
    Every pixel, frozen or not, rides every update: its bits are those
    of a solve of its own."""
    f32 = torch.float32
    n_pix, p = x_forecast.shape
    n_bands = obs.y.shape[0]
    dev = x_forecast.device
    packed = p <= UNROLL_MAX_P and n_bands <= 32
    # One memory layout whatever the caller hands in (a prior broadcast
    # over the batch, a slice of a stacked round): the norm's reductions
    # and the library solves follow the layout, and a coalesced member
    # must get the bits of its solo solve.
    x_forecast = x_forecast.to(f32).contiguous()
    p_inv_forecast = p_inv_forecast.to(f32).contiguous()
    tol_t = torch.full((), float(np.float32(tol)), dtype=f32, device=dev)
    numel_t = torch.full((), float(numel), dtype=f32, device=dev)
    relax_t = torch.full((), float(relaxation), dtype=f32, device=dev)
    lo = hi = None
    if state_bounds is not None:
        lo, hi = (_bound(v, dev) for v in state_bounds)
    if use_fused and packed:
        y, w, mask_f, xf_rows, pf_rows, _ = _gn_rows_inputs(
            obs, x_forecast, p_inv_forecast, None)
    x = x_forecast
    a = torch.zeros((n_pix, p, p), dtype=f32, device=dev)
    h0 = torch.zeros((n_bands, n_pix), dtype=f32, device=dev)
    jac = torch.zeros((n_bands, n_pix, p), dtype=f32, device=dev)
    frozen = small = None
    if per_pixel_convergence:
        frozen = torch.zeros(n_pix, dtype=torch.bool, device=dev)
        small = torch.zeros(n_pix, dtype=torch.bool, device=dev)
    n_done = 0
    norm = torch.full((), float("inf"), dtype=f32, device=dev)
    while True:
        # The while loop's condition: one host read per round.
        if per_pixel_convergence:
            flag = collective.all_true_flag(frozen)
        else:
            flag = norm < tol_t
        done = (yield "sync", flag) and n_done >= min_iterations
        if done or n_done > max_iterations:
            break
        x_prev = x
        lin = one_lin(x_prev)
        if use_fused and packed:
            x_rows, a_rows, _inn, _hb = yield "update", (
                jac_to_rows(lin.jac.to(f32)), lin.h0.to(f32).contiguous(),
                y, w, mask_f, x_prev.T.to(f32).contiguous(), xf_rows,
                pf_rows)
            x_new, a = x_rows.T, unpack_rows(a_rows)
        elif not packed and not use_fused:
            a, b = build_normal_equations(lin, obs, x_prev, x_forecast,
                                          p_inv_forecast)
            x_new = yield "dense", a, b
        else:
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
            norm = torch.sqrt(collective.all_reduce(
                (torch.where(frozen[:, None], 0.0, step) ** 2).sum())) \
                / numel_t
            frozen = frozen | newly
            small = small_now
        else:
            x = x_new
            norm = collective.step_norm(step, numel_t)
        h0, jac = lin.h0.to(f32), lin.jac.to(f32)
        n_done += 1
    # Diagnostics of the reference: fwd = J (x_a - x_f) + H0, innovations
    # y - H0 at the last linearisation.
    fwd = torch.einsum("bnp,np->bn", jac, x - x_forecast) + h0
    innovations = torch.where(obs.mask, obs.y - h0, 0.0)
    n_done_t = torch.full((), n_done, dtype=torch.int32, device=dev)
    return x, a, fwd, innovations, n_done_t, norm, frozen


def _linearizer(linearize, operator_params, linearize_block, corrupt,
                n_pix: int):
    """``x -> Linearization`` of one problem: blocked when
    ``linearize_block`` is smaller than the batch, the planted
    ``solver.pixel`` mask applied to H0."""
    use_block = linearize_block is not None \
        and 0 < int(linearize_block) < n_pix

    def one_lin(x_prev):
        with span("linearize", per_date=True):
            if use_block:
                lin = _blocked_linearize(linearize, operator_params, x_prev,
                                         int(linearize_block))
            else:
                lin = _call_linearize(linearize, operator_params, x_prev)
        if corrupt is not None:
            lin = lin._replace(h0=solver_health.corrupt_h0(lin.h0, corrupt))
        return lin

    return one_lin


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
    one_lin = _linearizer(linearize, operator_params, linearize_block,
                          corrupt, n_pix)
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
        lo, hi = (_bound(v, x.device) for v in state_bounds)
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
        with collective.transforms():
            correction = hessian_correction(fwd_pixel, x, obs.r_inv,
                                            innovations, obs.mask)
        a = eigenvalue_floor(a - correction)
    chi2, clipped, nodata = _window_telemetry_scalars(
        x, innovations, obs, state_bounds
    )
    verdicts = nonfin = clip_sat = cap = damped = quar = mean_trips = None
    if health is not None:
        verdicts, nonfin, clip_sat, mean_trips = health
        cap, damped, quar = solver_health.verdict_counts(verdicts)
    diags = SolveDiagnostics(
        innovations=innovations, fwd_modelled=fwd, n_iterations=n_done,
        convergence_norm=norm, converged_mask=frozen, chi2_per_band=chi2,
        clipped_count=clipped, nodata_count=nodata,
        health_verdicts=verdicts, cap_bailout_count=cap,
        damped_recovered_count=damped, quarantined_count=quar,
        nonfinite_count=nonfin, clip_saturated_count=clip_sat,
        mean_trips=mean_trips,
    )
    return x, a, diags


def _call_linearize(linearize, operator_params, x):
    """Support ``f(params, x)`` and plain ``f(x)`` closures (a linearise
    or a per-pixel forward)."""
    try:
        n_args = len(inspect.signature(linearize).parameters)
    except (ValueError, TypeError):
        n_args = 2
    with collective.transforms():
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
    corrupt = solver_health.corruption_mask(x_forecast.shape[0])
    return iterated_solve(
        linearize, obs, x_forecast, p_inv_forecast, operator_params,
        hessian_forward=hessian_forward,
        corrupt=None if corrupt is None
        else torch.as_tensor(corrupt, dtype=f32, device=dev),
        **date_solve_kwargs(solver_options),
    )


def date_solve_kwargs(solver_options) -> dict:
    """``iterated_solve``'s keywords from a solver-option dict, as
    ``assimilate_date`` passes them (the structural options normalised,
    the rest as given)."""
    opts = dict(solver_options or {})
    block, use_pallas, per_pixel, inkernel, min_it, max_it = \
        _split_structural_options(opts)
    if min_it is not None:
        opts["min_iterations"] = min_it
    if max_it is not None:
        opts["max_iterations"] = max_it
    return dict(opts, linearize_block=block, use_pallas=use_pallas,
                per_pixel_convergence=per_pixel,
                inkernel_linearize=inkernel)


def structural_options(solver_options) -> tuple:
    """The structural-option fingerprint of an option dict (normalised,
    in ``_split_structural_options`` order) — the piece of a serve shape
    bucket key that comes from solver options.  Does not mutate the
    input."""
    return _split_structural_options(dict(solver_options or {}))


def _stack_leaves(values):
    """One stacked leaf from K members' values: tensors and arrays stack,
    Python numbers become a float64 / int64 tensor (exact for every
    float32 and Python float), tuples and lists stack element-wise."""
    first = values[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_leaves(list(col)) for col in zip(*values))
    if isinstance(first, torch.Tensor):
        return torch.stack([torch.as_tensor(v, device=first.device)
                            for v in values])
    if isinstance(first, np.ndarray) and first.ndim:
        return torch.as_tensor(np.stack(values))
    if isinstance(first, (bool, int, np.integer)) \
            and not isinstance(first, (float, np.floating)):
        return torch.tensor([int(v) for v in values], dtype=torch.int64)
    # kafkalint: disable=implicit-f64 — a host tensor of the members'
    # Python floats, kept exact so each member unstacks its own number;
    # it never reaches the device.
    return torch.tensor([float(v) for v in values], dtype=torch.float64)


def _unstack_leaf(value, k: int):
    """Member ``k`` of a stacked leaf: Python numbers come back as the
    Python numbers they were, tensors as member ``k``'s slice."""
    if isinstance(value, (tuple, list)):
        return type(value)(_unstack_leaf(v, k) for v in value)
    leaf = value[k]
    # kafkalint: disable=implicit-f64 — the stacked host tensor above,
    # read back (no device memory) to its member's Python number.
    if leaf.ndim == 0 and leaf.dtype in (torch.float64, torch.int64):
        return leaf.item()  # kafkalint: disable=host-transfer-in-jit
    return leaf


def stack_solver_options(options_list):
    """Merge per-member solver-option dicts into ONE batched dict for
    ``assimilate_date_batch``: structural options must agree across
    members and pass through as plain values; every numeric leaf gains
    a leading member axis (``_stack_leaves``), so each member sees
    exactly its own value.

    Raises ``ValueError`` when members disagree structurally or carry
    different option keys — such requests belong to different shape
    buckets and must not share a launch."""
    dicts = [dict(o or {}) for o in options_list]
    statics = [_split_structural_options(d) for d in dicts]
    if any(s != statics[0] for s in statics[1:]):
        raise ValueError(
            "batch members disagree on structural solver options: "
            f"{[s for s in statics]}"
        )
    keys = sorted(dicts[0])
    if any(sorted(d) != keys for d in dicts[1:]):
        raise ValueError(
            "batch members carry different solver-option keys: "
            f"{[sorted(d) for d in dicts]}"
        )
    out = {k: _stack_leaves([d[k] for d in dicts]) for k in keys}
    for key, value in zip(STRUCTURAL_OPTION_KEYS, statics[0]):
        if value is not None:
            out[key] = value
    return out


def _member_numeric(value) -> tuple:
    """A hashable, exact fingerprint of one option value (a group of
    folded members must share every scalar the kernel takes)."""
    if value is None:
        return (None,)
    if isinstance(value, (tuple, list)):
        return tuple(_member_numeric(v) for v in value)
    if isinstance(value, torch.Tensor):
        # kafkalint: disable=host-transfer-in-jit — a fold-grouping key
        # of one option value, read once per round before any launch.
        a = value.detach().cpu().numpy()
        return (a.shape, str(a.dtype), a.tobytes())
    return (type(value).__name__, value)


def _fused_gn_fold(linearize, members, tol, min_iterations, max_iterations,
                   relaxation, state_bounds, numels):
    """One ``fused_gn`` launch over members that share every scalar the
    kernel takes: their pixel axes concatenated, each member's
    convergence groups pinned to its solo size (``_block(n, 2048)``:
    the fold's own gcd could be larger and merge groups across
    members) and each group's share of the convergence test taken from
    the member's own ``n`` and norm denominator.  Returns each
    member's row-path result, summarised on its own slice with the solo
    code."""
    from . import fused_gn as fg

    n = members[0][1].shape[0]
    p = members[0][1].shape[1]
    block = fg._block(n, 2048)
    inputs = [_gn_rows_inputs(obs, x_f, p_inv_f, cor)
              for obs, x_f, p_inv_f, cor in members]
    cors = [inp[5] for inp in inputs]
    cor = None
    if any(c is not None for c in cors):
        cor = torch.cat([
            torch.zeros(n, dtype=torch.float32, device=members[0][1].device)
            if c is None else c.reshape(n) for c in cors])
    cat = [torch.cat([inp[i] for inp in inputs], dim=-1) for i in range(5)]
    raw = fg.fused_gn_raw(
        linearize.__self__.kernel_linearize_rows, *cat, tol,
        min_iterations, max_iterations, relaxation,
        _kernel_bounds_rows(state_bounds, p), numels[0], block, cor,
        scalar_n=n,
    )
    return [
        _gn_rows_result(fg.summarise(
            tuple(t[:, m * n:(m + 1) * n].contiguous() for t in raw), n,
            block, numels[m], mean_trips=True))
        for m in range(len(members))
    ]


def assimilate_date_batch(linearize: LinearizeFn, obs: BandBatch,
                          x_forecast, p_inv_forecast,
                          operator_params: Any = None,
                          solver_options: Any = None,
                          hessian_forward: Any = None, corrupt: Any = None,
                          device=None):
    """Coalesced-serving twin of :func:`assimilate_date` (the JAX
    ``assimilate_date_batch_jit``): K compatible members stacked on a
    leading axis ride one round.

    Every argument carries a leading member axis K: ``obs`` fields
    (K, n_bands, n_pad), states (K, n_pad, p), information matrices
    (K, n_pad, p, p), ``operator_params`` leaves stacked leaf-wise (or
    None), ``solver_options`` a batched dict from
    :func:`stack_solver_options` and ``corrupt`` a (K, n_pad) mask or
    None (a row of zeros leaves its member untouched).

    Each member keeps its own convergence norm, its own iteration count
    and its own ``norm_denominator``, and its output slice is
    bit-identical to a solo ``assimilate_date`` on the same inputs:

    - the in-kernel ``fused_gn`` path: ONE launch over ``K * n_pad``
      pixels (``_fused_gn_fold``; members whose kernel scalars differ
      take one launch per distinct set);
    - the out-of-kernel row loop and per-pixel convergence: the
      members' loops in lockstep (``run_loops``), each step ONE
      ``fused_update_rows`` launch over every member still iterating,
      all its pixels (frozen ones included, as in its solo loop), and
      one host read of every member's loop condition; each member keeps
      its freeze mask, its norm over its own unfrozen steps, its step
      count and its iteration bounds, and a finished member drops out
      with its bytes;
    - the dense p > 16 path (global norm or per pixel): the same
      lockstep, each step one ``solve_spd_batched`` over the members'
      stacked normal equations;
    - the plain loop (``use_pallas: False`` on the packed path): member
      after member inside the round, the solo code on each (nothing is
      launched there that members could share).

    Linearisation stays per member (each has its own
    ``operator_params``).

    Returns ``(x (K, n, p), p_inv (K, n, p, p), diagnostics)`` with every
    diagnostics field stacked on the member axis (None stays None;
    :func:`diagnostics_at` takes one member's back)."""
    from .. import resolve_device

    dev = resolve_device(device)
    f32 = torch.float32
    y = torch.as_tensor(obs.y, dtype=f32, device=dev)
    r_inv = torch.as_tensor(obs.r_inv, dtype=f32, device=dev)
    mask = torch.as_tensor(obs.mask, device=dev).bool()
    x_forecast = torch.as_tensor(x_forecast, dtype=f32, device=dev)
    p_inv_forecast = torch.as_tensor(p_inv_forecast, dtype=f32, device=dev)
    k_members, n_pix, p = x_forecast.shape
    n_bands = y.shape[1]
    opts = dict(solver_options or {})
    block, use_pallas, per_pixel, inkernel, min_it, max_it = \
        _split_structural_options(opts)
    member_opts = []
    for m in range(k_members):
        o = {k: _unstack_leaf(v, m) for k, v in opts.items()}
        if min_it is not None:
            o["min_iterations"] = min_it
        if max_it is not None:
            o["max_iterations"] = max_it
        member_opts.append(o)
    members = []
    for m in range(k_members):
        cor = None if corrupt is None else torch.as_tensor(
            corrupt[m], dtype=f32, device=dev)
        members.append((
            BandBatch(y=y[m], r_inv=r_inv[m], mask=mask[m]),
            x_forecast[m], p_inv_forecast[m], cor))
    params = [_aux_at(operator_params, m) for m in range(k_members)]
    packed = p <= UNROLL_MAX_P and n_bands <= 32
    rows_path = packed and not per_pixel \
        and (use_pallas is None or use_pallas)

    def solve_kwargs(m):
        o = dict(member_opts[m])
        return dict(
            tol=o.pop("tol", CONVERGENCE_TOL),
            min_iterations=o.pop("min_iterations", MIN_ITERATIONS),
            max_iterations=o.pop("max_iterations", MAX_ITERATIONS),
            relaxation=o.pop("relaxation", 1.0),
            state_bounds=o.pop("state_bounds", None),
            norm_denominator=o.pop("norm_denominator", None), **o)

    kw = [solve_kwargs(m) for m in range(k_members)]
    extra = set(kw[0]) - {"tol", "min_iterations", "max_iterations",
                          "relaxation", "state_bounds", "norm_denominator"}
    results = [None] * k_members
    if rows_path and not extra:
        numels = [(n_pix * p) if k["norm_denominator"] is None
                  else k["norm_denominator"] for k in kw]
        inkernel_ok = [
            _inkernel_ok(linearize, params[m], kw[m]["min_iterations"],
                         kw[m]["max_iterations"], kw[m]["state_bounds"], p,
                         inkernel)
            for m in range(k_members)]
        if all(inkernel_ok):
            groups = {}
            for m in range(k_members):
                key = tuple(_member_numeric(kw[m][f]) for f in (
                    "tol", "min_iterations", "max_iterations", "relaxation",
                    "state_bounds")) + (_member_numeric(numels[m]),)
                groups.setdefault(key, []).append(m)
            for ms in groups.values():
                k0 = kw[ms[0]]
                outs = _fused_gn_fold(
                    linearize, [members[m] for m in ms], k0["tol"],
                    k0["min_iterations"], k0["max_iterations"],
                    k0["relaxation"], k0["state_bounds"],
                    [numels[m] for m in ms])
                for m, out in zip(ms, outs):
                    results[m] = out
        elif not any(inkernel_ok):
            loops = [
                _row_loop(linearize, members[m][0], members[m][1],
                          members[m][2], params[m], kw[m]["tol"],
                          kw[m]["min_iterations"], kw[m]["max_iterations"],
                          kw[m]["relaxation"], kw[m]["state_bounds"],
                          kw[m]["norm_denominator"], block,
                          members[m][3])
                for m in range(k_members)]
            results = run_loops(loops)
    frozen = [None] * k_members
    if (per_pixel or not packed) and not extra:
        use_fused = packed if use_pallas is None else bool(use_pallas)
        loops = [
            _generic_loop(
                _linearizer(linearize, params[m], block, members[m][3],
                            n_pix),
                members[m][0], members[m][1], members[m][2], kw[m]["tol"],
                kw[m]["min_iterations"], kw[m]["max_iterations"],
                kw[m]["relaxation"], kw[m]["state_bounds"],
                (n_pix * p) if kw[m]["norm_denominator"] is None
                else kw[m]["norm_denominator"], use_fused, per_pixel)
            for m in range(k_members)]
        for m, res in enumerate(run_loops(loops)):
            results[m] = res[:6] + (None,)
            frozen[m] = res[6]
    out = []
    for m in range(k_members):
        obs_m, x_m, p_inv_m, cor = members[m]
        if results[m] is None:
            # Not a shared-launch path: the solo solve of this member.
            out.append(iterated_solve(
                linearize, obs_m, x_m, p_inv_m, params[m],
                hessian_forward=hessian_forward, linearize_block=block,
                use_pallas=use_pallas, per_pixel_convergence=per_pixel,
                inkernel_linearize=inkernel, corrupt=cor, **member_opts[m]))
            continue
        x, a, fwd, innovations, n_done, norm, health = results[m]
        out.append(_finish_solve(
            x, a, fwd, innovations, n_done, norm, obs_m,
            kw[m]["state_bounds"], health, frozen=frozen[m],
            hessian_forward=hessian_forward, operator_params=params[m]))
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]),
            _stack_diagnostics([o[2] for o in out]))


def lower_date_program(linearize: LinearizeFn, obs: BandBatch, x_forecast,
                       p_inv_forecast, operator_params: Any = None,
                       solver_options: Any = None,
                       hessian_forward: Any = None, batch_size: Any = None,
                       device=None):
    """Warm one date program ahead of the first request (the counterpart
    of the JAX ``lower_date_program``, which lowers and compiles it).
    Nothing is compiled per shape here: on CUDA this builds the kernel
    sources (``core/_build.py``, one ``nvcc`` each, in parallel) and
    runs the program once — solo, or ``assimilate_date_batch`` when
    ``batch_size`` is given (arguments then carry the member axis) — on
    zeros of the arguments' shapes.  Returns ``{"batch_size",
    "wall_ms"}``."""
    from .. import resolve_device
    from ..telemetry.spans import stopwatch
    from . import _build

    dev = resolve_device(device)
    watch = stopwatch()
    if dev.type == "cuda":
        _build.build_all(_build.KERNEL_SOURCES)
        for name in _build.KERNEL_SOURCES:
            _build.load(name)
    f32 = torch.float32

    def zeros(t, dtype=f32):
        return torch.zeros(tuple(t.shape), dtype=dtype, device=dev)

    z_obs = BandBatch(y=zeros(obs.y), r_inv=zeros(obs.r_inv),
                      mask=zeros(obs.mask, torch.bool))
    z_params = None if operator_params is None else _aux_rebuild(
        operator_params, iter(
            zeros(leaf) if isinstance(leaf, torch.Tensor) else leaf
            for leaf in _aux_leaves(operator_params)))
    if batch_size is None:
        assimilate_date(linearize, z_obs, zeros(x_forecast),
                        zeros(p_inv_forecast), z_params, solver_options,
                        hessian_forward, device=dev)
    else:
        assimilate_date_batch(linearize, z_obs, zeros(x_forecast),
                              zeros(p_inv_forecast), z_params,
                              solver_options, hessian_forward, device=dev)
    if dev.type == "cuda":
        # kafkalint: disable=ad-hoc-timing — the warm-up's wall includes
        # its device work: one sync per bucket at start-up, off the
        # request path.
        torch.cuda.synchronize(dev)
    return {"batch_size": batch_size, "wall_ms": watch.elapsed() * 1e3}


def _stack_diagnostics(diags):
    """Member-stacked ``SolveDiagnostics`` (None fields stay None)."""
    fields = {}
    for name in SolveDiagnostics._fields:
        vals = [getattr(d, name) for d in diags]
        fields[name] = None if vals[0] is None else torch.stack(
            [torch.as_tensor(v) for v in vals])
    return SolveDiagnostics(**fields)


def diagnostics_at(diags, k: int):
    """Member ``k``'s ``SolveDiagnostics`` of a member-stacked one."""
    return SolveDiagnostics(**{
        name: None if getattr(diags, name) is None
        else getattr(diags, name)[k]
        for name in SolveDiagnostics._fields})


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
    mean_trips: Any = None              # (K,) float32, fused_gn only


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
    # The solver.pixel fault mask: one for the whole block (the armed
    # pixel set is positional, not temporal).
    corrupt = solver_health.corruption_mask(x_analysis0.shape[0])
    if corrupt is not None:
        corrupt = torch.as_tensor(corrupt, dtype=torch.float32,
                                  device=x_analysis0.device)
    return _windows_scan(linearize, obs_stacked, x_analysis0,
                         p_inv_analysis0, aux_stacked, m_matrix, q_diag,
                         prior_mean, prior_inv, state_propagator,
                         solver_options, hessian_forward, corrupt)


def _windows_scan(linearize, obs_stacked, x_analysis0, p_inv_analysis0,
                  aux_stacked, m_matrix, q_diag, prior_mean, prior_inv,
                  state_propagator, solver_options, hessian_forward,
                  corrupt):
    """``assimilate_windows_scan`` with the fault mask given (a mesh
    shard passes its slice of the batch's)."""
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
    if steps[0][2].mean_trips is not None:
        health["mean_trips"] = stacked("mean_trips")
    stats = ScanWindowStats(
        chi2_per_band=stacked("chi2_per_band"),
        clipped_count=stacked("clipped_count"),
        nodata_count=stacked("nodata_count"), **health)
    converged = stacked("converged_mask") if per_pixel else None
    return x_a, p_inv_a, xs, diag_s, iters, norms, converged, stats
