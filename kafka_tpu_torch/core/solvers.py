"""The variational-Kalman update (port of the main-path part of
``kafka_tpu/core/solvers.py``).

Per pixel the analysis solves the linearised normal equations

    A x = b,  A = sum_b r_inv_b J_b J_b^T + P_f^-1,
              b = sum_b r_inv_b y~_b J_b + P_f^-1 x_f,
    y~ = y + J x_lin - H0

inside a Gauss-Newton loop (reference constants: tol 1e-3 on
``||dx||_2 / numel``, at least 2 solves, bail after 25).

Two paths, chosen by the ``use_pallas`` solver option (the JAX option
keys carry over unchanged, ``STRUCTURAL_OPTION_KEYS``):

- the fused kernel (``core.fused_gn``): the whole loop in one launch, for
  operators that advertise ``inkernel_linearize``.  It is the default for
  such operators;
- the plain global-norm loop with solve health
  (``_iterated_solve_health``), for ``{"use_pallas": False}`` and for
  operators without an in-kernel linearisation.

Where ``use_pallas`` is set but the in-kernel branch cannot engage, the
JAX package would run its out-of-kernel row loop around
``_fused_update_kernel``; that kernel is not ported yet, so the port
raises ``NotImplementedError`` instead of running something else.
Not ported in this slice either: ``per_pixel_convergence``, the dense
large-p fallback and the Hessian correction.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable

import numpy as np
import torch

from . import solver_health
from .fused_gn import fused_gn_rows
from .linalg import (
    UNROLL_MAX_P,
    cholesky_packed,
    solve_chol_vectors,
    solve_spd_packed,
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

_KERNEL2_MISSING = (
    "the out-of-kernel fused update (kernel 2, "
    "kafka_tpu/core/pallas_solve.py:_fused_update_kernel) is not ported "
    "yet; pass solver option use_pallas=False for the plain loop"
)


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
    """One linearised update: ``(x_analysis, A)``.  The packed path only;
    its fused kernel (kernel 2) and the dense large-p form are not ported
    yet."""
    if use_pallas:
        raise NotImplementedError(_KERNEL2_MISSING)
    p = x_forecast.shape[-1]
    if p > UNROLL_MAX_P or lin.jac.shape[0] > 32:
        raise NotImplementedError(
            f"the dense large-p update (p={p}, {lin.jac.shape[0]} bands) "
            "is not ported yet"
        )
    a_packed, b = build_normal_equations_packed(
        lin, obs, x_lin, x_forecast, p_inv_forecast
    )
    return solve_spd_packed(a_packed, b), unpack_symmetric(a_packed)


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


def _pack_rows(p_inv_forecast, p: int):
    """(n, p, p) dense -> (p(p+1)/2, n) packed lower-triangle rows."""
    return torch.stack([p_inv_forecast[:, i, j].to(torch.float32)
                        for i in range(p) for j in range(i + 1)])


def _iterated_solve_rows(linearize, obs, x_forecast, p_inv_forecast,
                         operator_params, tol, min_iterations,
                         max_iterations, relaxation, state_bounds,
                         norm_denominator, inkernel_linearize=True,
                         corrupt=None):
    """The in-kernel branch: the whole loop in ``fused_gn_rows``.
    Engages when the operator advertises ``inkernel_linearize``, the
    operator params are empty, the iteration bounds are static ints and
    the bounds are per-parameter; otherwise raises (kernel 2 missing)."""
    f32 = torch.float32
    n_pix, p = x_forecast.shape
    numel = (n_pix * p) if norm_denominator is None else norm_denominator
    owner = getattr(linearize, "__self__", None)
    kernel_bounds = _kernel_bounds_rows(state_bounds, p)
    if not (
        inkernel_linearize
        and owner is not None
        and getattr(owner, "inkernel_linearize", False)
        and _params_empty(operator_params)
        and isinstance(min_iterations, int)
        and isinstance(max_iterations, int)
        and kernel_bounds is not False
    ):
        raise NotImplementedError(
            "use_pallas is set but the in-kernel Gauss-Newton path cannot "
            "engage (it needs an inkernel_linearize operator, empty "
            "operator params, int iteration bounds and per-parameter "
            "state bounds); " + _KERNEL2_MISSING
        )
    xf_rows = x_forecast.T.to(f32).contiguous()
    pf_rows = _pack_rows(p_inv_forecast, p).contiguous()
    cor = None if corrupt is None else corrupt.to(f32).contiguous()
    x_rows, a_rows, fwd, inn, n_done, norm, verd, nonfin, clip_sat = \
        fused_gn_rows(
            owner.kernel_linearize_rows, obs.y.to(f32).contiguous(),
            obs.r_inv.to(f32).contiguous(), obs.mask.to(f32).contiguous(),
            xf_rows, pf_rows, tol, min_iterations, max_iterations,
            relaxation, kernel_bounds, numel, corrupt=cor,
            device=x_forecast.device,
        )
    a_packed = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            a_packed[i][j] = a_packed[j][i] = a_rows[i * (i + 1) // 2 + j]
    return (x_rows.T, unpack_symmetric(a_packed), fwd, inn, n_done, norm,
            (verd, nonfin, clip_sat))


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


def _resolve_use_pallas(use_pallas, linearize) -> bool:
    """The port's kernel rule: unset means "the fused kernel when the
    operator advertises an in-kernel linearisation"."""
    if use_pallas is None:
        owner = getattr(linearize, "__self__", None)
        return bool(getattr(owner, "inkernel_linearize", False))
    return bool(use_pallas)


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
    """Gauss-Newton relinearisation loop in global-norm mode with solve
    health; returns ``(x_analysis, p_inv_analysis, diagnostics)``.
    Options mean what they mean in the JAX ``iterated_solve``;
    ``use_pallas=None`` picks the fused kernel when the operator
    advertises ``inkernel_linearize``."""
    n_pix, p = x_forecast.shape
    n_bands = obs.y.shape[0]
    if per_pixel_convergence:
        raise NotImplementedError(
            "per_pixel_convergence is not ported yet (ROADMAP)")
    if p > UNROLL_MAX_P or n_bands > 32:
        raise NotImplementedError(
            f"the dense large-p fallback (p={p}, {n_bands} bands) is not "
            "ported yet (ROADMAP)")
    if hessian_forward is not None:
        raise NotImplementedError(
            "the Hessian correction is not ported yet (ROADMAP)")
    numel = (n_pix * p) if norm_denominator is None else norm_denominator
    if _resolve_use_pallas(use_pallas, linearize):
        x, a, fwd, innovations, n_done, norm, health = _iterated_solve_rows(
            linearize, obs, x_forecast, p_inv_forecast, operator_params,
            tol, min_iterations, max_iterations, relaxation, state_bounds,
            norm_denominator, inkernel_linearize=inkernel_linearize,
            corrupt=corrupt,
        )
    else:
        use_block = linearize_block is not None \
            and 0 < int(linearize_block) < n_pix

        def one_lin(x_prev):
            if use_block:
                lin = _blocked_linearize(linearize, operator_params, x_prev,
                                         int(linearize_block))
            else:
                lin = _call_linearize(linearize, operator_params, x_prev)
            if corrupt is not None:
                lin = lin._replace(
                    h0=solver_health.corrupt_h0(lin.h0, corrupt))
            return lin

        x, a, fwd, innovations, n_done, norm, health = \
            _iterated_solve_health(
                one_lin, obs, x_forecast, p_inv_forecast, tol,
                min_iterations, max_iterations, relaxation, state_bounds,
                numel,
            )
    return _finish_solve(x, a, fwd, innovations, n_done, norm, obs,
                         state_bounds, health)


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


def _finish_solve(x, a, fwd, innovations, n_done, norm, obs,
                  state_bounds=None, health=None):
    """Diagnostics packaging (the Hessian correction is not ported)."""
    chi2, clipped, nodata = _window_telemetry_scalars(
        x, innovations, obs, state_bounds
    )
    verdicts = nonfin = clip_sat = cap = damped = quar = None
    if health is not None:
        verdicts, nonfin, clip_sat = health
        cap, damped, quar = solver_health.verdict_counts(verdicts)
    diags = SolveDiagnostics(
        innovations=innovations, fwd_modelled=fwd, n_iterations=n_done,
        convergence_norm=norm, converged_mask=None, chi2_per_band=chi2,
        clipped_count=clipped, nodata_count=nodata,
        health_verdicts=verdicts, cap_bailout_count=cap,
        damped_recovered_count=damped, quarantined_count=quar,
        nonfinite_count=nonfin, clip_saturated_count=clip_sat,
    )
    return x, a, diags


def _call_linearize(linearize, operator_params, x):
    """Support ``f(params, x)`` and plain ``f(x)`` closures."""
    try:
        n_args = len(inspect.signature(linearize).parameters)
    except (ValueError, TypeError):
        n_args = 2
    if n_args >= 2:
        return linearize(operator_params, x)
    return linearize(x)


def _blocked_linearize(linearize, operator_params, x, block: int):
    """Linearise in sequential pixel blocks to bound peak memory.  Per-pixel
    operator params would have to be split alongside; this slice supports
    operators without params only."""
    if not _params_empty(operator_params):
        raise NotImplementedError(
            "blocked linearisation of operators with per-date params is "
            "not ported yet")
    n_pix = x.shape[0]
    n_blocks = -(-n_pix // block)
    block = -(-n_pix // n_blocks)
    parts = [_call_linearize(linearize, operator_params, x[s:s + block])
             for s in range(0, n_pix, block)]
    return Linearization(h0=torch.cat([q.h0 for q in parts], dim=1),
                         jac=torch.cat([q.jac for q in parts], dim=1))


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
