"""The dense large-p solve of the port against the JAX package: the
Ross-Li kernel-weight state (p = 21, 7 bands) is above ``UNROLL_MAX_P``,
so both packages assemble the dense ``(n, p, p)`` normal equations and
factor them with a library Cholesky (XLA's there, ``torch.linalg`` here).

Budgets: the assembly of one update agrees to float32 rounding of
different contraction orders (rtol 1e-5 of the matrix scale), its solve
to atol 1e-4 (r_inv 4e4 against prior information 25 amplifies that
rounding by the condition number);
the iterated solve keeps the JAX package's float32 Gauss-Newton budget
(x atol 2e-3, tests/test_solvers.py:702-716), A to rtol 1e-4.  A planted
non-positive-definite pixel is NaN in both packages, and only there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core import linalg as jlinalg
from kafka_tpu.core import solvers as jsolvers
from kafka_tpu.core.types import BandBatch as JBandBatch
from kafka_tpu.obsops.kernels import KernelsAux as JAux
from kafka_tpu.obsops.kernels import KernelsOperator as JKernels
from kafka_tpu_torch import convert
from kafka_tpu_torch.core import linalg as tlinalg
from kafka_tpu_torch.core import solvers as tsolvers
from kafka_tpu_torch.core.types import Linearization as TLin
from kafka_tpu_torch.obsops.kernels import KernelsAux as TAux
from kafka_tpu_torch.obsops.kernels import KernelsOperator as TKernels

P, NB, N = 21, 7, 96
RTOL = 1e-5
UPDATE_ATOL = 1e-4
X_ATOL = 2e-3


def _spd(n=N, p=P, seed=0, bad=(5,)):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, p, p)).astype(np.float32)
    a = (np.einsum("nij,nkj->nik", m, m) + p * np.eye(p)).astype(np.float32)
    for i in bad:
        a[i] = -np.eye(p, dtype=np.float32)   # not positive definite
    b = rng.normal(size=(n, p)).astype(np.float32)
    return a, b


def _kernels_problem(n=N, seed=1, mask_frac=0.2):
    """A seeded MOD09-like date: per-pixel kernels, a truth near the
    prior, noisy reflectances, some bands masked with NaN nodata."""
    rng = np.random.default_rng(seed)
    k_vol = rng.uniform(-0.1, 0.4, n).astype(np.float32)
    k_geo = rng.uniform(-1.5, -0.5, n).astype(np.float32)
    truth = np.tile([0.12, 0.05, 0.02], NB).astype(np.float32) \
        + rng.normal(0, 0.02, (n, P)).astype(np.float32)
    w = truth.reshape(n, NB, 3)
    y = (w[..., 0] + k_vol[:, None] * w[..., 1]
         + k_geo[:, None] * w[..., 2]).T
    y = (y + rng.normal(0, 0.005, y.shape)).astype(np.float32)
    mask = rng.uniform(size=y.shape) > mask_frac
    r_inv = np.where(mask, 1.0 / 0.005 ** 2, 0.0).astype(np.float32)
    x_f = np.tile([0.15, 0.05, 0.02], NB).astype(np.float32)
    x_f = np.broadcast_to(x_f, (n, P)).copy()
    p_inv = np.broadcast_to(np.eye(P, dtype=np.float32) / 0.2 ** 2,
                            (n, P, P)).copy()
    return (k_vol, k_geo), (np.where(mask, y, np.nan), r_inv, mask), x_f, \
        p_inv


def _jbands(bands):
    y, r_inv, mask = bands
    return JBandBatch(y=jnp.asarray(np.where(mask, y, 0.0)),
                      r_inv=jnp.asarray(r_inv), mask=jnp.asarray(mask))


def _tbands(bands):
    y, r_inv, mask = bands
    return convert.band_batch(np.where(mask, y, 0.0), r_inv, mask, "cpu")


def _scale(a):
    d = np.sqrt(np.abs(np.einsum("nii->ni", a)))
    return d[:, :, None] * d[:, None, :]


def test_solve_spd_batched_dense_nan_on_non_pd_pixel():
    a, b = _spd()
    xj = np.asarray(jlinalg.solve_spd_batched(jnp.asarray(a),
                                              jnp.asarray(b)))
    xt = tlinalg.solve_spd_batched(torch.as_tensor(a),
                                   torch.as_tensor(b)).numpy()
    bad_j = ~np.isfinite(xj).all(axis=1)
    bad_t = ~np.isfinite(xt).all(axis=1)
    np.testing.assert_array_equal(bad_t, bad_j)
    assert np.flatnonzero(bad_t).tolist() == [5]
    assert np.isnan(xt[5]).all()
    ref = np.linalg.solve(a.astype(np.float64)[~bad_t],
                          b.astype(np.float64)[~bad_t][..., None])[..., 0]
    np.testing.assert_allclose(xt[~bad_t], xj[~bad_t], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(xt[~bad_t], ref, rtol=1e-4, atol=1e-6)


def test_spd_inverse_batched_dense_nan_on_non_pd_pixel():
    a, _ = _spd(seed=2, bad=(0, 17))
    ij = np.asarray(jlinalg.spd_inverse_batched(jnp.asarray(a)))
    it = tlinalg.spd_inverse_batched(torch.as_tensor(a)).numpy()
    for inv in (ij, it):
        assert np.isnan(inv[[0, 17]]).all()
        assert np.isfinite(np.delete(inv, [0, 17], axis=0)).all()
    ok = np.isfinite(it).all(axis=(1, 2))
    np.testing.assert_allclose(it[ok], ij[ok], rtol=1e-4, atol=1e-7)


def test_cholesky_dense_symmetrises_like_lax():
    """``jax.lax.linalg.cholesky`` factors (a + a^T) / 2; so does the
    port's dense factor (one asymmetric entry decides it)."""
    import jax

    a, _ = _spd(n=4, bad=())
    a[:, 3, 1] += 0.5
    lj = np.asarray(jax.lax.linalg.cholesky(jnp.asarray(a)))
    lt = tlinalg.cholesky_dense(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6)


def test_build_normal_equations_dense():
    (k_vol, k_geo), bands, x_f, p_inv = _kernels_problem()
    rng = np.random.default_rng(4)
    x_lin = (x_f + rng.normal(0, 0.01, x_f.shape)).astype(np.float32)
    jop, top = JKernels(), TKernels()
    jlin = jop.linearize(JAux(jnp.asarray(k_vol), jnp.asarray(k_geo)),
                         jnp.asarray(x_lin))
    tlin = top.linearize(TAux(torch.as_tensor(k_vol),
                              torch.as_tensor(k_geo)),
                         torch.as_tensor(x_lin))
    aj, bj = jsolvers.build_normal_equations(
        jlin, _jbands(bands), jnp.asarray(x_lin), jnp.asarray(x_f),
        jnp.asarray(p_inv))
    at, bt = tsolvers.build_normal_equations(
        tlin, _tbands(bands), torch.as_tensor(x_lin), torch.as_tensor(x_f),
        torch.as_tensor(p_inv))
    aj, at = np.asarray(aj), at.numpy()
    assert at.dtype == np.float32 and at.shape == (N, P, P)
    np.testing.assert_array_less(np.abs(at - aj), RTOL * _scale(aj) + 1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4,
                               atol=1e-2)


def test_dense_kalman_update():
    (k_vol, k_geo), bands, x_f, p_inv = _kernels_problem(seed=3)
    jlin = JKernels().linearize(
        JAux(jnp.asarray(k_vol), jnp.asarray(k_geo)), jnp.asarray(x_f))
    tlin = TLin(h0=torch.as_tensor(np.asarray(jlin.h0)),
                jac=torch.as_tensor(np.asarray(jlin.jac)))
    xj, aj = jsolvers.kalman_update(jlin, _jbands(bands), jnp.asarray(x_f),
                                    jnp.asarray(x_f), jnp.asarray(p_inv))
    xt, at = tsolvers.kalman_update(tlin, _tbands(bands),
                                    torch.as_tensor(x_f),
                                    torch.as_tensor(x_f),
                                    torch.as_tensor(p_inv))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=UPDATE_ATOL)
    aj = np.asarray(aj)
    np.testing.assert_array_less(np.abs(at.numpy() - aj),
                                 RTOL * _scale(aj) + 1e-6)


def test_dense_kalman_update_refuses_explicit_pallas():
    """``use_pallas=True`` covers the packed path only, in both
    packages."""
    (k_vol, k_geo), bands, x_f, p_inv = _kernels_problem(n=8)
    tlin = TKernels().linearize(TAux(torch.as_tensor(k_vol),
                                     torch.as_tensor(k_geo)),
                                torch.as_tensor(x_f))
    with pytest.raises(NotImplementedError, match="packed small-state"):
        tsolvers.kalman_update(tlin, _tbands(bands), torch.as_tensor(x_f),
                               torch.as_tensor(x_f), torch.as_tensor(p_inv),
                               use_pallas=True)


def _iterated(opts):
    (k_vol, k_geo), bands, x_f, p_inv = _kernels_problem(seed=5)
    jop, top = JKernels(), TKernels()
    jopts = dict(opts, state_bounds=tuple(jnp.asarray(v)
                                          for v in jop.state_bounds))
    xj, aj, dj = jsolvers.assimilate_date_jit(
        jop.linearize, _jbands(bands), jnp.asarray(x_f), jnp.asarray(p_inv),
        JAux(jnp.asarray(k_vol), jnp.asarray(k_geo)), jopts)
    topts = convert.solver_options(dict(opts, state_bounds=top.state_bounds),
                                   "cpu")
    xt, at, dt = tsolvers.assimilate_date(
        top.linearize, _tbands(bands), x_f, p_inv,
        TAux(torch.as_tensor(k_vol), torch.as_tensor(k_geo)), topts,
        device="cpu")
    return (xj, aj, dj), (xt, at, dt)


@pytest.mark.parametrize("opts", [{}, {"use_pallas": False},
                                  {"relaxation": 0.7, "max_iterations": 6}],
                         ids=["default", "plain", "damped"])
def test_iterated_solve_p21(opts):
    """The generic global-norm loop at p = 21: the port's unset
    ``use_pallas`` takes the dense path without raising; iterations,
    x, A and diagnostics as in the JAX package; no solve health."""
    (xj, aj, dj), (xt, at, dt) = _iterated(opts)
    assert int(dt.n_iterations) == int(dj.n_iterations) >= 2
    assert dt.health_verdicts is None and dj.health_verdicts is None
    assert dt.converged_mask is None
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=X_ATOL)
    aj = np.asarray(aj)
    np.testing.assert_array_less(np.abs(at.numpy() - aj),
                                 1e-4 * _scale(aj) + 1e-4)
    for name in ("innovations", "fwd_modelled", "chi2_per_band"):
        np.testing.assert_allclose(getattr(dt, name).numpy(),
                                   np.asarray(getattr(dj, name)),
                                   rtol=1e-3, atol=5e-3, err_msg=name)
    assert int(dt.clipped_count) == int(dj.clipped_count)
    assert int(dt.nodata_count) == int(dj.nodata_count)


def test_iterated_solve_p21_refuses_explicit_pallas():
    with pytest.raises(NotImplementedError, match="packed small-state"):
        _iterated({"use_pallas": True})
