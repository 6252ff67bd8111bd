"""The pixel-sharded assimilation step (port of
``kafka_tpu/shard/step.py``).

Where the JAX package jits one program and lets GSPMD partition it over
the pixel mesh, the port runs the same per-date code once per shard, on
the shard's device, in one thread per shard: the advance (state
propagation and prior blending, per pixel), then the Gauss-Newton solve
(``core.solvers.iterated_solve``).  Pixels never couple, so the only
collective is the loop's global convergence test (``core.collective``):
the step norm summed over every shard's pixels and divided by the
batch's ``norm_denominator`` — ``n_valid * p`` from the VALID pixel
count when given, so padding does not loosen the tolerance.  On the
fused Gauss-Newton kernel each shard's launch keeps the unsharded
run's convergence groups and their share of the test, so its groups
take the trips they take without a mesh.

Diagnostics come back as the JAX out-shardings put them: band-major
pixel arrays (innovations, forward model, converged mask, QA verdicts)
split on the pixel axis (``PixelShards``), scalars combined over the
shards on the mesh's first device — trip count and norm from the
collective, the per-band chi^2 from the shards' chi^2 weighted by their
valid counts, the other counts summed.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional

import torch

from ..core import _build, collective, solver_health
from ..core import propagators as prop
from ..core.linalg import spd_inverse_batched
from ..core.solvers import (_aux_leaves, _aux_rebuild, date_solve_kwargs,
                            iterated_solve)
from ..core.types import BandBatch, SolveDiagnostics
from ..telemetry import tracing
from .mesh import PixelMesh, PixelShards, shard_bounds, split_pixels

#: a shard that waits this long at the collective for the others raises
#: (a hung or dead shard must not wedge the run).
COLLECTIVE_TIMEOUT_S = 3600.0


class ShardAux(list):
    """A date's operator aux split over a mesh: one tree per shard (the
    engine's ``_shard_obs``).  A list, so the aux helpers of
    ``core.solvers`` stack it per leaf like any tree."""


def _device_scope(dev: torch.device):
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def run_shards(mesh: PixelMesh, fn: Callable[[int], Any], n_total: int
               ) -> List[Any]:
    """``fn(k)`` for every shard ``k``, each in its own thread with its
    device current and shard membership ``k`` of one ``ShardGroup``;
    returns the results in shard order and raises the first failure (the
    other shards then break out of the collective).  Jobs queued for the
    next kernel launch while the shards run (``/profilez``'s tracing
    switch) run on this thread once every shard was joined
    (``core._build.shard_group``)."""
    group = collective.ShardGroup(mesh.size, COLLECTIVE_TIMEOUT_S)
    results: list = [None] * mesh.size
    errors: list = [None] * mesh.size
    grad = torch.is_grad_enabled()
    ctx = tracing.current_context()
    census = _build.current_census()

    def work(k: int) -> None:
        tracing.set_context(ctx)
        try:
            with torch.set_grad_enabled(grad), \
                    _device_scope(mesh.devices[k]), \
                    _build.census_thread(census), \
                    collective.member(group, k, n_total):
                results[k] = fn(k)
        except BaseException as exc:  # re-raised on the caller's thread
            errors[k] = exc
            group.abort()

    if mesh.size == 1:
        work(0)
    else:
        threads = [threading.Thread(target=work, args=(k,),
                                    name=f"mesh-shard-{k}", daemon=True)
                   for k in range(mesh.size)]
        with _build.shard_group():
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    failures = [e for e in errors if e is not None]
    if failures:
        first = next((e for e in failures
                      if not isinstance(e, threading.BrokenBarrierError)),
                     failures[0])
        raise first
    return results


def as_shards(mesh: PixelMesh, arr, axis: int = 0) -> Optional[PixelShards]:
    """``arr`` split on ``axis`` over the mesh (kept as it is when already
    a ``PixelShards``); None stays None."""
    if arr is None or isinstance(arr, PixelShards):
        return arr
    return split_pixels(mesh, torch.as_tensor(arr), axis)


def shard_aux(mesh: PixelMesh, operator, aux, n_pix: int,
              batch_offset: int = 0) -> List[Any]:
    """One aux tree per shard: per-pixel leaves split on their pixel
    axis, the rest moved whole to each shard's device.  The operator's
    ``aux_in_axes`` decides which is which (0 = per pixel), as in the JAX
    engine (a weight matrix whose leading dim happens to equal n_pix
    stays whole); ``batch_offset=1`` for a fused block's stacked aux,
    whose per-pixel axis sits behind the window axis."""
    if aux is None:
        return [None] * mesh.size
    leaves = _aux_leaves(aux)
    template = aux
    if batch_offset:
        template = _aux_rebuild(aux, iter(
            leaf[0] if isinstance(leaf, torch.Tensor) else leaf
            for leaf in leaves))
    if hasattr(operator, "aux_in_axes"):
        axes = _aux_leaves(operator.aux_in_axes(template, n_pix))
    else:
        from ..obsops.protocol import _aux_in_dims

        axes = _aux_leaves(_aux_in_dims(template, n_pix))
    bounds = shard_bounds(n_pix, mesh.size)
    out = []
    for (a, b), dev in zip(bounds, mesh.devices):
        shard_leaves = []
        for leaf, ax in zip(leaves, axes):
            if not isinstance(leaf, torch.Tensor):
                shard_leaves.append(leaf)
            elif ax == 0:
                shard_leaves.append(
                    leaf.narrow(batch_offset, a, b - a).to(dev))
            else:
                shard_leaves.append(leaf.to(dev))
        out.append(_aux_rebuild(aux, iter(shard_leaves)))
    return out


def _pixelwise(mesh: PixelMesh, arr, ndim: int):
    """A prior array split over the mesh when it is per pixel (``ndim``
    dimensions); a broadcast one (fewer) as it is."""
    if arr is None or isinstance(arr, PixelShards) or arr.ndim < ndim:
        return arr
    return as_shards(mesh, arr, 0)


def _replica(value, dev):
    """A value the shards share (a trajectory model, bounds): on the
    shard's device."""
    if isinstance(value, torch.Tensor):
        return value.to(dev)
    if isinstance(value, (tuple, list)):
        return type(value)(_replica(v, dev) for v in value)
    return value


def _replica_options(opts: dict, dev) -> dict:
    return {k: _replica(v, dev) for k, v in opts.items()}


def combine_chi2(chi2s: List[torch.Tensor], counts: List[torch.Tensor],
                 home: torch.device) -> torch.Tensor:
    """The batch's per-band chi^2 (the mean over every valid entry of the
    band) from each shard's chi^2 and valid counts on its bands' last
    axis."""
    num = den = None
    for chi2, cnt in zip(chi2s, counts):
        cnt = cnt.to(home).float()
        part = chi2.to(home).float() * cnt
        num = part if num is None else num + part
        den = cnt if den is None else den + cnt
    return num / den.clamp(min=1.0)


def _sum_on(values, home):
    out = values[0].to(home)
    for v in values[1:]:
        out = out + v.to(home)
    return out


def combine_diagnostics(diags: List[SolveDiagnostics], bands: List,
                        home: torch.device) -> SolveDiagnostics:
    """One ``SolveDiagnostics`` of the whole batch from the shards':
    pixel arrays as ``PixelShards``, scalars on ``home`` (the trip count
    and norm are the collective's, equal on every shard)."""
    d0 = diags[0]

    def pix(name, axis):
        if getattr(d0, name) is None:
            return None
        return PixelShards([getattr(d, name) for d in diags], axis)

    def total(name):
        if getattr(d0, name) is None:
            return None
        return _sum_on([getattr(d, name) for d in diags], home)

    return SolveDiagnostics(
        innovations=pix("innovations", 1),
        fwd_modelled=pix("fwd_modelled", 1),
        n_iterations=torch.as_tensor(d0.n_iterations).to(home),
        convergence_norm=torch.as_tensor(d0.convergence_norm).to(home),
        converged_mask=pix("converged_mask", 0),
        chi2_per_band=combine_chi2(
            [d.chi2_per_band for d in diags],
            [b.mask.sum(dim=1) for b in bands], home),
        clipped_count=total("clipped_count"),
        nodata_count=total("nodata_count"),
        health_verdicts=pix("health_verdicts", 0),
        cap_bailout_count=total("cap_bailout_count"),
        damped_recovered_count=total("damped_recovered_count"),
        quarantined_count=total("quarantined_count"),
        nonfinite_count=total("nonfinite_count"),
        clip_saturated_count=total("clip_saturated_count"),
    )


def gather_diagnostics(diags: SolveDiagnostics,
                       device: torch.device) -> SolveDiagnostics:
    """``diags`` with every ``PixelShards`` field gathered on
    ``device``."""
    return diags._replace(**{
        name: value.full(device) for name, value in diags._asdict().items()
        if isinstance(value, PixelShards)})


def _solve_options(solver_options, n_total: int, p: int,
                   n_valid: Optional[int]) -> dict:
    """The per-shard ``iterated_solve`` keywords: the batch's
    ``norm_denominator`` (valid pixels when known, else every pixel, as
    the unsharded solve defaults)."""
    kw = date_solve_kwargs(solver_options)
    if kw.get("norm_denominator") is None:
        kw["norm_denominator"] = float(
            (n_valid if n_valid is not None else n_total) * p)
    return kw


def _corrupt_shards(mesh: PixelMesh, n_total: int) -> List[Any]:
    """The ``solver.pixel`` fault mask of the whole batch (positional),
    split per shard; Nones when nothing is armed."""
    mask = solver_health.corruption_mask(n_total)
    if mask is None:
        return [None] * mesh.size
    t = torch.as_tensor(mask, dtype=torch.float32)
    return list(split_pixels(mesh, t, 0).shards)


def sharded_solve(mesh: PixelMesh, linearize, bands, x_forecast,
                  p_inv_forecast, operator_params=None,
                  solver_options=None, hessian_forward=None,
                  n_valid: Optional[int] = None, operator=None):
    """One date's Gauss-Newton solve over the mesh: ``(x_analysis,
    p_inv_analysis)`` as ``PixelShards`` and the combined diagnostics.
    ``bands`` is a ``BandBatch`` of ``(n_bands, n_pix)`` arrays or of
    ``PixelShards``; ``operator_params`` is the whole date's aux (split
    here by ``operator``'s ``aux_in_axes``) or a list of per-shard
    trees."""
    bands = BandBatch(*(as_shards(mesh, f, 1) for f in bands))
    xs = as_shards(mesh, x_forecast, 0)
    ps = as_shards(mesh, p_inv_forecast, 0)
    n_total, p = xs.shape
    if isinstance(operator_params, ShardAux):
        params = operator_params
    else:
        owner = operator or getattr(linearize, "__self__", None)
        params = shard_aux(mesh, owner, operator_params, n_total)
    kw = _solve_options(solver_options, n_total, p, n_valid)
    cors = _corrupt_shards(mesh, n_total)
    band_k = [BandBatch(*(f.shards[k] for f in bands))
              for k in range(mesh.size)]

    def one(k):
        dev = mesh.devices[k]
        cor = None if cors[k] is None else cors[k].to(dev)
        return iterated_solve(
            linearize, band_k[k], xs.shards[k], ps.shards[k], params[k],
            hessian_forward=hessian_forward, corrupt=cor,
            **_replica_options(kw, dev))

    outs = run_shards(mesh, one, n_total)
    diags = combine_diagnostics([o[2] for o in outs], band_k,
                                mesh.devices[0])
    return (PixelShards([o[0] for o in outs], 0),
            PixelShards([o[1] for o in outs], 0), diags)


def sharded_advance(mesh: PixelMesh, x_analysis, p_analysis,
                    p_analysis_inverse, m_matrix, q_diag, prior_mean=None,
                    prior_cov_inverse=None, state_propagator=None):
    """``propagators.advance`` shard by shard (it is per pixel; no
    collective): every argument split or replicated onto the shards,
    the results as ``PixelShards`` (None stays None)."""
    parts = [as_shards(mesh, a, 0) for a in (
        x_analysis, p_analysis, p_analysis_inverse, prior_mean,
        prior_cov_inverse)]
    outs = []
    for k, dev in enumerate(mesh.devices):
        args = [None if a is None else a.shards[k] for a in parts]
        with _device_scope(dev):
            outs.append(prop.advance(
                args[0], args[1], args[2], _replica(m_matrix, dev),
                _replica(q_diag, dev), prior_mean=args[3],
                prior_cov_inverse=args[4],
                state_propagator=state_propagator))
    return tuple(None if outs[0][i] is None
                 else PixelShards([o[i] for o in outs], 0)
                 for i in range(3))


def make_sharded_step(
    linearize,
    mesh: PixelMesh,
    state_propagator: Optional[Callable] = None,
    use_prior: bool = True,
    solver_options: Optional[dict] = None,
    n_valid: Optional[int] = None,
):
    """The per-date step over the mesh, with the JAX signature::

        step(bands, x_analysis, p_inv_analysis, m_matrix, q_diag,
             prior_mean, prior_inv, operator_params)
            -> (x_analysis, p_inv_analysis, diagnostics)

    Arrays may be whole tensors (split here) or ``PixelShards``; the
    state comes back as ``PixelShards``.  ``prior_mean`` / ``prior_inv``
    are ignored when ``use_prior=False``.  ``n_valid`` is the count of
    real (unpadded) pixels: the convergence norm is normalised by
    ``n_valid * p``, not the padded count (``linear_kf.py:296``)."""

    def step(bands, x_analysis, p_inv_analysis, m_matrix, q_diag,
             prior_mean, prior_inv, operator_params):
        pm = prior_mean if use_prior else None
        pi = prior_inv if use_prior else None
        x_f, p_f, p_f_inv = sharded_advance(
            mesh, x_analysis, None, p_inv_analysis, m_matrix, q_diag,
            prior_mean=pm, prior_cov_inverse=pi,
            state_propagator=state_propagator)
        if x_f is None:  # no propagator, no prior: persistence forecast
            x_f = as_shards(mesh, x_analysis, 0)
            p_f_inv = as_shards(mesh, p_inv_analysis, 0)
        elif p_f_inv is None:
            p_f_inv = p_f.map(spd_inverse_batched)
        return sharded_solve(mesh, linearize, bands, x_f, p_f_inv,
                             operator_params, solver_options,
                             n_valid=n_valid)

    return step


def make_sharded_forward(forward: Callable, mesh: PixelMesh):
    """A batched forward model (``(aux, (n_pix, p)) -> (n_bands,
    n_pix)``) run shard by shard: the prediction path over the mesh; the
    result is ``PixelShards`` on axis 1."""

    def apply(aux, x):
        xs = as_shards(mesh, x, 0)
        outs = []
        for k, dev in enumerate(mesh.devices):
            with _device_scope(dev):
                outs.append(forward(_replica(aux, dev), xs.shards[k]))
        return PixelShards(outs, 1)

    return apply


def sharded_windows_scan(mesh: PixelMesh, linearize, obs_stacked,
                         x_analysis0, p_inv_analysis0, aux_stacked=None,
                         m_matrix=None, q_diag=None, prior_mean=None,
                         prior_inv=None, state_propagator=None,
                         solver_options=None, hessian_forward=None,
                         operator=None):
    """``core.solvers.assimilate_windows_scan`` over the mesh: the K
    windows' advance and solve per shard, the convergence norm global
    per window.  ``obs_stacked`` is a ``BandBatch`` of ``(K, n_bands,
    n_pix)`` arrays or ``PixelShards`` on axis 2; ``aux_stacked`` the
    stacked aux tree (split here) or a ``ShardAux``.  Returns the
    function's tuple with ``x_final``, ``p_inv_final``, ``xs``,
    ``p_inv_diags`` and the converged masks as ``PixelShards`` and the
    per-window scalars combined on the mesh's first device."""
    from ..core.solvers import ScanWindowStats, _windows_scan

    bands = BandBatch(*(as_shards(mesh, f, 2) for f in obs_stacked))
    xs0 = as_shards(mesh, x_analysis0, 0)
    ps0 = as_shards(mesh, p_inv_analysis0, 0)
    pm = _pixelwise(mesh, prior_mean, 2)
    pi = _pixelwise(mesh, prior_inv, 3)
    n_total, p = xs0.shape
    if isinstance(aux_stacked, ShardAux):
        params = aux_stacked
    else:
        owner = operator or getattr(linearize, "__self__", None)
        params = shard_aux(mesh, owner, aux_stacked, n_total,
                           batch_offset=1)
    opts = dict(solver_options or {})
    if opts.get("norm_denominator") is None:
        opts["norm_denominator"] = float(n_total * p)
    cors = _corrupt_shards(mesh, n_total)

    def part(a, k):
        return a.shards[k] if isinstance(a, PixelShards) else a

    def one(k):
        dev = mesh.devices[k]
        band_k = BandBatch(*(f.shards[k] for f in bands))
        return _windows_scan(
            linearize, band_k, xs0.shards[k], ps0.shards[k], params[k],
            _replica(m_matrix, dev), _replica(q_diag, dev),
            _replica(part(pm, k), dev), _replica(part(pi, k), dev),
            state_propagator, _replica_options(opts, dev),
            hessian_forward,
            None if cors[k] is None else cors[k].to(dev))

    outs = run_shards(mesh, one, n_total)
    home = mesh.devices[0]
    stats = [o[7] for o in outs]
    health = {}
    if stats[0].health_verdicts is not None:
        health = {f: _sum_on([getattr(st, f) for st in stats], home)
                  for f in ("cap_bailout_count", "damped_recovered_count",
                            "quarantined_count", "nonfinite_count",
                            "clip_saturated_count")}
        health["health_verdicts"] = PixelShards(
            [st.health_verdicts for st in stats], 1)
    wstats = ScanWindowStats(
        chi2_per_band=combine_chi2(
            [st.chi2_per_band for st in stats],
            [m.sum(dim=2) for m in bands.mask.shards], home),
        clipped_count=_sum_on([st.clipped_count for st in stats], home),
        nodata_count=_sum_on([st.nodata_count for st in stats], home),
        **health)
    converged = None if outs[0][6] is None \
        else PixelShards([o[6] for o in outs], 1)
    return (PixelShards([o[0] for o in outs], 0),
            PixelShards([o[1] for o in outs], 0),
            PixelShards([o[2] for o in outs], 1),
            PixelShards([o[3] for o in outs], 1),
            outs[0][4].to(home), outs[0][5].to(home), converged, wstats)
