"""The port's ``assimilate_date`` on both of its paths against the JAX
``assimilate_date_jit``, plus the solver pieces and host helpers around it.

- ``{"use_pallas": False}``: the port's plain global-norm loop against the
  JAX XLA health loop;
- ``{"use_pallas": True}`` and the default for an ``inkernel_linearize``
  operator: the port's fused path (plain version on the CPU) against the
  JAX in-kernel path (Pallas interpret mode).  The out-of-kernel row
  loop has its own file, ``test_torch_rowloop.py``.

Budgets are the JAX package's own (tests/test_solvers.py:702-716):
x atol 2e-3, A rtol 2e-2 of the matrix scale sqrt(A_ii A_jj) plus atol
2e-2, diagnostics atol 5e-3; iteration counts and verdicts identical.
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core import solvers as jsolvers
from kafka_tpu.core.types import BandBatch as JBandBatch
from kafka_tpu.core.types import Linearization as JLin
from kafka_tpu_torch import convert
from kafka_tpu_torch.core import solvers as tsolvers
from kafka_tpu_torch.core.types import Linearization as TLin

X_ATOL, A_TOL, DIAG_ATOL = 2e-3, 2e-2, 5e-3


class _JaxQuad:
    inkernel_linearize = True
    aux_per_pixel = True

    def __init__(self, coeff):
        self.coeff = np.asarray(coeff, np.float32)
        p = self.coeff.shape[1]
        self.state_bounds = (np.full(p, -10.0, np.float32),
                             np.full(p, 10.0, np.float32))

    def linearize(self, aux, x):
        c = jnp.asarray(self.coeff)
        return JLin(h0=jnp.einsum("bp,np->bn", c, x**2),
                    jac=2.0 * c[:, None, :] * x[None, :, :])

    def kernel_linearize_rows(self, x_rows):
        p = self.coeff.shape[1]
        h0 = [sum(float(c[k]) * x_rows[k] ** 2 for k in range(p))
              for c in self.coeff]
        jac = [[2.0 * float(c[k]) * x_rows[k] for k in range(p)]
               for c in self.coeff]
        return h0, jac


class _TorchQuad(_JaxQuad):
    def linearize(self, aux, x):
        c = torch.as_tensor(self.coeff)
        return TLin(h0=torch.einsum("bp,np->bn", c, x**2),
                    jac=2.0 * c[:, None, :] * x[None, :, :])


class _TorchQuadNoKernel(_TorchQuad):
    inkernel_linearize = False


def _quad(p=3, n_bands=2, n=256, seed=0):
    rng = np.random.default_rng(seed)
    coeff = rng.uniform(0.5, 1.5, size=(n_bands, p)).astype(np.float32)
    x_f = np.full((n, p), 0.8, np.float32)
    x_true = x_f + rng.normal(0, 0.05, (n, p)).astype(np.float32)
    y = np.einsum("bp,np->bn", coeff, x_true**2).astype(np.float32)
    mask = rng.uniform(size=y.shape) > 0.2
    bands = (np.where(mask, y, np.nan).astype(np.float32),
             np.where(mask, 25.0, 0.0).astype(np.float32), mask)
    p_inv = np.broadcast_to(4.0 * np.eye(p, dtype=np.float32),
                            (n, p, p)).copy()
    return coeff, bands, x_f, p_inv


def _tip(n=512):
    from kafka_tpu.testing.synthetic import make_tip_problem

    op, b, x0, p0 = make_tip_problem(n, mask_prob=0.2, host=True)
    y = np.where(b.mask, b.y, np.nan).astype(np.float32)
    return op, (y, b.r_inv, b.mask), x0, p0


def _jax(lin, bands, x0, p0, opts):
    return jsolvers.assimilate_date_jit(
        lin, JBandBatch(*(jnp.asarray(v) for v in bands)), jnp.asarray(x0),
        jnp.asarray(p0), None, opts)


def _torch(lin, bands, x0, p0, opts):
    return tsolvers.assimilate_date(lin, convert.band_batch(*bands, "cpu"),
                                    x0, p0, None, opts, device="cpu")


def _assert_parity(j, t):
    xj, aj, dj = j
    xt, at, dt = t
    xj, aj, xt, at = (np.asarray(v) for v in (xj, aj, xt, at))
    assert int(dt.n_iterations) == int(dj.n_iterations)
    np.testing.assert_array_equal(dt.health_verdicts.numpy(),
                                  np.asarray(dj.health_verdicts))
    np.testing.assert_allclose(xt, xj, atol=X_ATOL)
    diag = np.abs(np.diagonal(aj, axis1=-2, axis2=-1))
    scale = np.sqrt(diag[:, :, None] * diag[:, None, :])
    assert (np.abs(at - aj) <= A_TOL + A_TOL * scale).all()
    for field in ("innovations", "fwd_modelled"):
        got = getattr(dt, field).numpy()
        assert np.isfinite(got).all(), field
        np.testing.assert_allclose(got, np.asarray(getattr(dj, field)),
                                   atol=DIAG_ATOL, err_msg=field)
    np.testing.assert_allclose(dt.chi2_per_band.numpy(),
                               np.asarray(dj.chi2_per_band), rtol=1e-3)
    for field in ("nodata_count", "cap_bailout_count",
                  "damped_recovered_count", "quarantined_count",
                  "nonfinite_count"):
        assert int(getattr(dt, field)) == int(getattr(dj, field)), field
    np.testing.assert_array_equal(dt.clip_saturated_count.numpy(),
                                  np.asarray(dj.clip_saturated_count))
    assert abs(int(dt.clipped_count) - int(dj.clipped_count)) <= 2


@pytest.mark.parametrize("use_pallas", [False, True])
def test_tip_assimilate_date_matches_jax(use_pallas):
    from kafka_tpu_torch.obsops.twostream import TwoStreamOperator

    op, bands, x0, p0 = _tip()
    lo, hi = op.state_bounds
    j = _jax(op.linearize, bands, x0, p0,
             {"state_bounds": (jnp.asarray(lo), jnp.asarray(hi)),
              "use_pallas": use_pallas})
    t = _torch(TwoStreamOperator().linearize, bands, x0, p0,
               {"state_bounds": (lo, hi), "use_pallas": use_pallas})
    _assert_parity(j, t)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_quad_assimilate_date_matches_jax(use_pallas):
    coeff, bands, x0, p0 = _quad(seed=4)
    jop, top = _JaxQuad(coeff), _TorchQuad(coeff)
    j = _jax(jop.linearize, bands, x0, p0,
             {"state_bounds": tuple(jnp.asarray(v) for v in
                                    jop.state_bounds),
              "use_pallas": use_pallas, "relaxation": 0.8})
    t = _torch(top.linearize, bands, x0, p0,
               {"state_bounds": top.state_bounds, "use_pallas": use_pallas,
                "relaxation": 0.8})
    _assert_parity(j, t)


def _spy_fused(monkeypatch):
    calls = []
    real = tsolvers.fused_gn_rows

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsolvers, "fused_gn_rows", spy)
    return calls


@pytest.mark.parametrize("opts,expect_fused", [
    ({}, True), ({"use_pallas": True}, True),
    ({"use_pallas": False}, False),
])
def test_kernel_selection_rule(monkeypatch, opts, expect_fused):
    """Unset use_pallas means the fused kernel for an inkernel_linearize
    operator; an explicit False opts out to the plain loop."""
    calls = _spy_fused(monkeypatch)
    coeff, bands, x0, p0 = _quad(n=64, seed=1)
    _torch(_TorchQuad(coeff).linearize, bands, x0, p0, opts)
    assert bool(calls) == expect_fused


def _spy_update(monkeypatch):
    calls = []
    real = tsolvers.fused_update_rows

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsolvers, "fused_update_rows", spy)
    return calls


def test_operator_without_inkernel_defaults_to_plain_loop(monkeypatch):
    """Without an in-kernel linearisation the default is now the fused
    path's row loop around the fused update (one call per iteration),
    not the plain loop; the fused Gauss-Newton kernel stays untouched."""
    calls = _spy_fused(monkeypatch)
    updates = _spy_update(monkeypatch)
    coeff, bands, x0, p0 = _quad(n=64, seed=2)
    x, a, d = _torch(_TorchQuadNoKernel(coeff).linearize, bands, x0, p0, {})
    assert not calls and d.health_verdicts is not None
    assert len(updates) == int(d.n_iterations)


@pytest.mark.parametrize("case", [
    "pallas_no_inkernel", "inkernel_opt_out", "per_pixel_bounds",
    "operator_params", "per_pixel_convergence", "hessian",
])
def test_unported_paths_raise(case, monkeypatch):
    """Paths the port once refused.  The first four run through the row
    loop around the fused update; per-pixel convergence and the Hessian
    correction run too, each held to the JAX package on the same
    problem (the per-pixel frozen mask and iterations equal, x within
    X_ATOL; the corrected A within the A budget)."""
    updates = _spy_update(monkeypatch)
    coeff, bands, x0, p0 = _quad(n=64, seed=3)
    op = _TorchQuad(coeff)
    lin, params, opts, hess = op.linearize, None, {}, None
    if case == "pallas_no_inkernel":
        lin = _TorchQuadNoKernel(coeff).linearize
        opts = {"use_pallas": True}
    elif case == "inkernel_opt_out":
        opts = {"use_pallas": True, "inkernel_linearize": False}
    elif case == "per_pixel_bounds":
        opts = {"state_bounds": (np.full((64, 3), -10.0, np.float32),
                                 np.full((64, 3), 10.0, np.float32))}
    elif case == "operator_params":
        params = {"angle": torch.ones(64)}
    elif case == "per_pixel_convergence":
        opts = {"per_pixel_convergence": True}
    else:
        c = torch.as_tensor(coeff)

        def hess(x_pixel):
            return (c * x_pixel ** 2).sum(dim=-1)

    x, a, d = tsolvers.assimilate_date(
        lin, convert.band_batch(*bands, "cpu"), x0, p0, params, opts,
        hess, device="cpu")
    assert np.isfinite(x.numpy()).all()
    if case in ("pallas_no_inkernel", "inkernel_opt_out", "per_pixel_bounds",
                "operator_params"):
        assert len(updates) == int(d.n_iterations) > 0
        assert d.health_verdicts is not None
        return
    jop = _JaxQuad(coeff)
    jc = jnp.asarray(coeff)
    jhess = None if hess is None \
        else (lambda x_pixel: (jc * x_pixel ** 2).sum(axis=-1))
    jopts = dict(opts, use_pallas=True)
    xj, aj, dj = jsolvers.assimilate_date_jit(
        jop.linearize, JBandBatch(*(jnp.asarray(v) for v in bands)),
        jnp.asarray(x0), jnp.asarray(p0), None, jopts, jhess)
    assert int(d.n_iterations) == int(dj.n_iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=X_ATOL)
    aj = np.asarray(aj)
    diag = np.abs(np.diagonal(aj, axis1=-2, axis2=-1))
    scale = np.sqrt(diag[:, :, None] * diag[:, None, :])
    assert (np.abs(a.numpy() - aj) <= A_TOL + A_TOL * scale).all()
    if case == "per_pixel_convergence":
        np.testing.assert_array_equal(d.converged_mask.numpy(),
                                      np.asarray(dj.converged_mask))
        assert d.health_verdicts is None and not updates
    else:
        # The in-kernel loop, then the correction: A moves, x does not.
        _, a0, _ = tsolvers.assimilate_date(
            lin, convert.band_batch(*bands, "cpu"), x0, p0, None, {},
            device="cpu")
        assert np.abs(a.numpy() - a0.numpy()).max() > 1e-3


def test_structural_option_keys_carry_over():
    assert tsolvers.STRUCTURAL_OPTION_KEYS == jsolvers.STRUCTURAL_OPTION_KEYS
    opts = {"use_pallas": True, "max_iterations": 40, "relaxation": 0.7,
            "linearize_block": 16}
    statics = tsolvers._split_structural_options(opts)
    assert statics == (16, True, False, True, None, 40)
    assert opts == {"relaxation": 0.7}
    assert tsolvers._split_structural_options({})[1] is None


def test_blocked_linearize_matches_unblocked():
    coeff, bands, x0, p0 = _quad(n=100, seed=5)
    op = _TorchQuad(coeff)
    base = {"use_pallas": False}
    x1, a1, d1 = _torch(op.linearize, bands, x0, p0, base)
    x2, a2, d2 = _torch(op.linearize, bands, x0, p0,
                        {**base, "linearize_block": 32})
    # Same arithmetic per pixel; the operator's einsum vectorises blocks
    # differently, so the last bits may differ.
    assert int(d1.n_iterations) == int(d2.n_iterations)
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), atol=1e-5)
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), rtol=1e-5)


def test_normal_equations_and_kalman_update_match_jax():
    coeff, bands, x0, p0 = _quad(p=7, n_bands=2, n=128, seed=6)
    rng = np.random.default_rng(0)
    x_lin = (x0 + rng.normal(0, 0.05, x0.shape)).astype(np.float32)
    jop, top = _JaxQuad(coeff), _TorchQuad(coeff)
    jl = jop.linearize(None, jnp.asarray(x_lin))
    tl = top.linearize(None, torch.as_tensor(x_lin))
    jb = JBandBatch(*(jnp.asarray(v) for v in bands))
    tb = convert.band_batch(*bands, "cpu")
    aj, bj = jsolvers.build_normal_equations_packed(
        jl, jb, jnp.asarray(x_lin), jnp.asarray(x0), jnp.asarray(p0))
    at, bt = tsolvers.build_normal_equations_packed(
        tl, tb, torch.as_tensor(x_lin), torch.as_tensor(x0),
        torch.as_tensor(p0))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5,
                               atol=1e-4)
    for i in range(7):
        for k in range(i + 1):
            np.testing.assert_allclose(at[i][k].numpy(),
                                       np.asarray(aj[i][k]), rtol=1e-5,
                                       atol=1e-4)
    xj, _ = jsolvers.kalman_update(jl, jb, jnp.asarray(x_lin),
                                   jnp.asarray(x0), jnp.asarray(p0))
    xt, _ = tsolvers.kalman_update(tl, tb, torch.as_tensor(x_lin),
                                   torch.as_tensor(x0),
                                   torch.as_tensor(p0))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-4)
    # use_pallas=True now runs the fused update (test_torch_fused_update.py
    # holds it against the JAX kernel): the same assembly and solve.
    xf, af = tsolvers.kalman_update(tl, tb, torch.as_tensor(x_lin),
                                    torch.as_tensor(x0), torch.as_tensor(p0),
                                    use_pallas=True)
    np.testing.assert_allclose(xf.numpy(), xt.numpy(), atol=1e-5)
    np.testing.assert_array_equal(
        af.numpy(), tsolvers.unpack_symmetric(at).numpy())


def test_prior_only_advance_and_blend_match_jax():
    from kafka_tpu.core import propagators as jprop
    from kafka_tpu_torch.core import propagators as tprop

    mean, cov, inv = tprop.tip_prior_arrays()
    for a, b in zip((mean, cov, inv), jprop.tip_prior_arrays()):
        np.testing.assert_array_equal(a, b)
    n = 16
    x_a = np.random.default_rng(1).normal(0.3, 0.1, (n, 7)).astype(
        np.float32)
    tp = convert.pixel_prior(mean, cov, inv, "cpu")
    xm, pm = tprop.broadcast_prior(tp, n)
    out = tprop.advance(torch.as_tensor(x_a), None, None, torch.eye(7),
                        torch.zeros(7), prior_mean=xm, prior_cov_inverse=pm)
    assert out[1] is None
    np.testing.assert_array_equal(out[0].numpy(),
                                  np.broadcast_to(mean, (n, 7)))
    x0, _, p_inv = tprop.no_propagation(torch.as_tensor(x_a), None, None,
                                        None, None)
    np.testing.assert_array_equal(p_inv.numpy(),
                                  np.broadcast_to(inv, (n, 7, 7)))
    p_f = np.broadcast_to(2.0 * inv, (n, 7, 7)).copy()
    xj, aj = jprop.blend_prior(jnp.broadcast_to(jnp.asarray(mean), (n, 7)),
                               jnp.broadcast_to(jnp.asarray(inv), (n, 7, 7)),
                               jnp.asarray(x_a), jnp.asarray(p_f))
    xt, at = tprop.blend_prior(xm, pm, torch.as_tensor(x_a),
                               torch.as_tensor(p_f))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)


def test_time_grid_and_gather_copies_match_jax():
    from kafka_tpu.core.time_grid import iterate_time_grid as jgrid
    from kafka_tpu.engine.state import make_pixel_gather as jgather
    from kafka_tpu_torch.core.time_grid import iterate_time_grid as tgrid
    from kafka_tpu_torch.engine.state import make_pixel_gather as tgather

    day = datetime.datetime(2021, 1, 1)
    grid = [day + datetime.timedelta(days=16 * k) for k in range(4)]
    dates = [day + datetime.timedelta(days=d) for d in (3, 10, 19, 40, 60)]
    assert list(tgrid(grid, dates)) == list(jgrid(grid, dates))
    mask = np.random.default_rng(0).uniform(size=(9, 11)) > 0.4
    g1, g2 = tgather(mask, 32), jgather(mask, 32)
    assert (g1.n_valid, g1.n_pad) == (g2.n_valid, g2.n_pad)
    np.testing.assert_array_equal(g1.rows, g2.rows)
    raster = np.arange(99, dtype=np.float32).reshape(9, 11)
    np.testing.assert_array_equal(g1.scatter(g1.gather(raster)),
                                  g2.scatter(g2.gather(raster)))


def test_convert_solver_options_and_state():
    opts = convert.solver_options(
        {"state_bounds": (np.zeros(7), np.ones(7)), "relaxation": 0.5},
        "cpu")
    lo, hi = opts["state_bounds"]
    assert lo.dtype == torch.float32 and hi.shape == (7,)
    assert opts["relaxation"] == 0.5
    x, p = convert.state(np.zeros((4, 7)), None, "cpu")
    assert x.dtype == torch.float32 and p is None
    pri = convert.fixed_gaussian_prior(np.zeros(7), np.eye(7), np.eye(7),
                                       ["a"] * 7, "cpu")
    mean, inv = pri.process_prior(None, type("G", (), {"n_pad": 5})())
    assert mean.shape == (5, 7) and inv.shape == (5, 7, 7)
