"""The joint Sentinel-2 + Sentinel-1 path of the port against the JAX
package: the two joint operators, the joint prior and state bounds, the
composite date stream, and the 8 x 8 joint ``KalmanFilter.run`` of
``tests/test_joint.py``.

Tolerances: reflectance and backscatter atol 1e-5 and Jacobians atol
1e-4, as the PROSAIL parity tests (float32 transcendentals of two
libraries; the log transforms amplify them).  The engine run is held to
the JAX package's 2e-3 state budget: x within atol 2e-3, and P^-1 entry
(i, j) within 2e-3 of its matrix's scale sqrt(P^-1_ii P^-1_jj) (the
information of a 0.003-sigma SAR date is ~1e5, so an absolute budget
would read float32 rounding).  The soil-moisture gates are the JAX
test's: with S1 dates mean |sm - 0.4| < 0.05, without them sm stays at
the prior's 0.25 within 1e-3.
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.obsops import joint as jj
from kafka_tpu.obsops.prosail import ProsailAux as JProsailAux
from kafka_tpu.obsops.wcm import WCMAux as JWCMAux
from kafka_tpu_torch import convert
from kafka_tpu_torch.obsops import joint as tj

H0_ATOL, JAC_ATOL, STATE_ATOL = 1e-5, 1e-4, 2e-3
N = 48


def day(i, hour=0):
    return datetime.datetime(2017, 7, 1 + i, hour)


def _states(n=N, seed=0):
    """Joint-prior states with noise inside the bounds; row 0 on the
    transformed-LAI clip floor, row 1 on its ceiling, rows 2-3 with
    soil moisture on its bounds."""
    from kafka_tpu_torch.engine.priors import joint_prior_arrays

    rng = np.random.default_rng(seed)
    lo, hi = tj.joint_state_bounds()
    x = np.clip(joint_prior_arrays()[0] + rng.normal(0, 0.05, (n, 11)),
                lo, hi).astype(np.float32)
    x[0, 6] = np.float32(np.exp(-5.0))
    x[1, 6] = np.float32(1.0)
    x[2, 10], x[3, 10] = lo[10], hi[10]
    return x


def test_state_bounds_and_prior_match_jax():
    from kafka_tpu.engine.priors import JOINT_PARAMETER_LIST as JLIST
    from kafka_tpu.engine.priors import joint_prior as jax_prior
    from kafka_tpu_torch.engine.priors import JOINT_PARAMETER_LIST, joint_prior

    for a, b in zip(tj.joint_state_bounds(), jj.joint_state_bounds()):
        np.testing.assert_array_equal(a, b)
    jp = jax_prior()
    for tp in (joint_prior("cpu"), convert.joint_prior(device="cpu")):
        assert tp.parameter_list == JOINT_PARAMETER_LIST == JLIST
        for f in ("mean", "cov", "inv_cov"):
            np.testing.assert_array_equal(getattr(tp.prior, f).numpy(),
                                          np.asarray(getattr(jp.prior, f)))


def test_prosail_joint_matches_jax_with_a_zero_sm_column():
    x = _states()
    vals = (np.float32(30.5), np.float32(5.0), np.float32(-50.0))
    jaux = JProsailAux(*(jnp.asarray(v) for v in vals))
    taux = convert.prosail_aux(jaux, "cpu")
    jl = jj.ProsailJointOperator().linearize(jaux, jnp.asarray(x))
    tl = tj.ProsailJointOperator().linearize(taux, torch.as_tensor(x))
    assert tl.jac.shape == (10, N, 11)
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0),
                               atol=H0_ATOL)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               atol=JAC_ATOL)
    assert (tl.jac[:, :, 10] == 0).all()


@pytest.mark.parametrize("kind", ["scalar", "per_pixel"])
def test_wcm_joint_matches_jax_on_lai_and_sm_only(kind):
    x = _states()
    rng = np.random.default_rng(5)
    theta = np.float32(35.0) if kind == "scalar" else \
        rng.uniform(30.0, 45.0, N).astype(np.float32)
    jaux = JWCMAux(theta_deg=jnp.asarray(theta))
    taux = convert.wcm_aux(jaux, "cpu")
    jl = jj.WCMJointOperator().linearize(jaux, jnp.asarray(x))
    tl = tj.WCMJointOperator().linearize(taux, torch.as_tensor(x))
    assert tl.jac.shape == (2, N, 11)
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0),
                               rtol=1e-5)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               rtol=1e-4, atol=1e-6)
    touched = tl.jac.abs().amax(dim=(0, 1)) > 0
    assert touched[6] and touched[10]
    assert not touched[[0, 1, 2, 3, 4, 5, 7, 8, 9]].any()
    assert torch.isfinite(tl.jac).all()


def _sources(pkg_synthetic, op, **kw):
    truth = np.zeros((4, 4, 11), np.float32)
    a = pkg_synthetic.SyntheticObservations(
        dates=[day(1), day(3)], operator=op, truth_fn=lambda d: truth,
        sigma=0.05, seed=0, **kw)
    b = pkg_synthetic.SyntheticObservations(
        dates=[day(2), day(3)], operator=op, truth_fn=lambda d: truth,
        sigma=0.05, seed=1, **kw)
    return a, b


def test_composite_union_and_dispatch_match_jax():
    from kafka_tpu.io.multi import CompositeObservations as JComposite
    from kafka_tpu.testing import synthetic as jsyn
    from kafka_tpu_torch.engine.state import make_pixel_gather
    from kafka_tpu_torch.io import CompositeObservations
    from kafka_tpu_torch.testing import synthetic as tsyn

    a, b = _sources(tsyn, tj.ProsailJointOperator(), device="cpu")
    comp = CompositeObservations([a, b])
    ref = JComposite(list(_sources(jsyn, jj.ProsailJointOperator())))
    assert comp.dates == ref.dates and len(comp.dates) == 4
    dupes = [d for d in comp.dates if d.day == 4]
    assert (dupes[1] - dupes[0]).total_seconds() == pytest.approx(2.0)
    assert comp.bands_per_observation == ref.bands_per_observation
    g = make_pixel_gather(np.ones((4, 4), bool), pad_multiple=16)
    # The nudged duplicate goes to the second source at its own date.
    got = comp.get_observations(dupes[1], g)
    want = b.get_observations(day(3), g)
    assert torch.equal(got.bands.y, want.bands.y)
    assert not torch.equal(got.bands.y,
                           a.get_observations(day(3), g).bands.y)
    with pytest.raises(ValueError):
        CompositeObservations([])


def _jax_run(with_s1: bool):
    """The joint run of tests/test_joint.py, built as it builds it."""
    from kafka_tpu.engine import KalmanFilter
    from kafka_tpu.engine.priors import JOINT_PARAMETER_LIST, joint_prior
    from kafka_tpu.io.multi import CompositeObservations
    from kafka_tpu.testing import MemoryOutput, SyntheticObservations

    mask = np.ones((8, 8), bool)
    prior = joint_prior()
    truth = np.zeros((8, 8, 11), np.float32)
    truth[:] = np.asarray(prior.prior.mean)
    truth[..., 6] = np.exp(-3.0 / 2.0)
    truth[..., 10] = 0.4
    theta = jnp.asarray(np.full(64, 35.0, np.float32))
    sources = [SyntheticObservations(
        dates=[day(1), day(5)], operator=jj.ProsailJointOperator(),
        truth_fn=lambda d: truth, sigma=0.005, seed=3)]
    if with_s1:
        sources.append(SyntheticObservations(
            dates=[day(2), day(4)], operator=jj.WCMJointOperator(),
            truth_fn=lambda d: truth, sigma=0.003, seed=4,
            aux_fn=lambda d, g: JWCMAux(theta_deg=theta)))
    kf = KalmanFilter(CompositeObservations(sources), MemoryOutput(), mask,
                      JOINT_PARAMETER_LIST, state_propagation=None,
                      prior=None, pad_multiple=64,
                      solver_options={"relaxation": 0.7})
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    x_a, _, p_inv_a = kf.run([day(0), day(6)], x0, None, p_inv0)
    return np.asarray(x_a), np.asarray(p_inv_a)


def _port_run(with_s1: bool):
    from kafka_tpu_torch.engine import (JOINT_PARAMETER_LIST, KalmanFilter,
                                        joint_prior)
    from kafka_tpu_torch.testing import (MemoryOutput, joint_observations,
                                         joint_truth)

    mask = np.ones((8, 8), bool)
    truth = joint_truth(mask.shape)
    obs = joint_observations([day(1), day(5)],
                             [day(2), day(4)] if with_s1 else [],
                             lambda d: truth, theta_deg=35.0,
                             s1_sigma=0.003, device="cpu")
    prior = joint_prior("cpu")
    kf = KalmanFilter(obs, MemoryOutput(), mask, JOINT_PARAMETER_LIST,
                      state_propagation=None, prior=None, pad_multiple=64,
                      solver_options={"relaxation": 0.7}, device="cpu")
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    x_a, _, p_inv_a = kf.run([day(0), day(6)], x0, None, p_inv0)
    return x_a.numpy(), p_inv_a.numpy(), kf


@pytest.fixture(scope="module")
def runs():
    return {s1: (_jax_run(s1), _port_run(s1)) for s1 in (True, False)}


@pytest.mark.parametrize("with_s1", [True, False])
def test_joint_run_matches_jax(runs, with_s1):
    (xj, pj), (xt, pt, kf) = runs[with_s1]
    assert len(kf.diagnostics_log) == (4 if with_s1 else 2)
    np.testing.assert_allclose(xt, xj, atol=STATE_ATOL)
    d = np.sqrt(np.abs(np.einsum("nii->ni", pj)))
    scale = d[:, :, None] * d[:, None, :]
    err = (np.abs(pt - pj) / scale).max()
    print(f"joint run (S1 {with_s1}): x {np.abs(xt - xj).max():.3g}, "
          f"P^-1 of scale {err:.3g}")
    assert err < STATE_ATOL


def test_sar_dates_constrain_soil_moisture(runs):
    (_, p_opt_j), (x_opt, p_opt, _) = runs[False]
    (_, _), (x_joint, p_joint, _) = runs[True]
    np.testing.assert_allclose(x_opt[:64, 10], 0.25, atol=1e-3)
    assert np.abs(x_joint[:64, 10] - 0.4).mean() < 0.05
    assert (p_joint[:64, 10, 10] > 2 * p_opt[:64, 10, 10]).all()
    lai = -2 * np.log(np.clip(x_joint[:64, 6], 1e-6, 1))
    assert np.abs(lai - 3.0).mean() < 0.35


def test_joint_stream_never_fuses_across_sensors():
    """One acquisition per 2-day window, S2 and S1 alternating: every
    window's operator differs from its neighbour's, so the engine's
    fusion runs none of them fused, and each date goes through its own
    sensor's operator."""
    from kafka_tpu_torch.core import propagate_information_filter
    from kafka_tpu_torch.engine import (JOINT_PARAMETER_LIST, KalmanFilter,
                                        joint_prior)
    from kafka_tpu_torch.testing import (MemoryOutput, joint_observations,
                                         joint_truth)

    mask = np.ones((4, 4), bool)
    truth = joint_truth(mask.shape)
    s2 = [day(1), day(5)]
    s1 = [day(3, 17), day(7, 17)]
    obs = joint_observations(s2, s1, lambda d: truth,
                             theta_deg=np.full((4, 4), 38.0, np.float32),
                             device="cpu")
    seen = []
    real = obs.get_observations

    def spy(date, gather):
        got = real(date, gather)
        seen.append(type(got.operator).__name__)
        return got

    obs.get_observations = spy
    prior = joint_prior("cpu")
    kf = KalmanFilter(obs, MemoryOutput(), mask, JOINT_PARAMETER_LIST,
                      state_propagation=propagate_information_filter,
                      prior=None, pad_multiple=16,
                      solver_options={"relaxation": 0.7}, scan_window=8,
                      prefetch_depth=0, device="cpu")
    kf.set_trajectory_uncertainty([1e-3] * 10 + [1e-2])
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    kf.run([day(0) + datetime.timedelta(days=2 * i) for i in range(5)],
           x0, None, p_inv0)
    assert [r.get("fused") for r in kf.diagnostics_log] == [None] * 4
    assert seen == ["ProsailJointOperator", "WCMJointOperator"] * 2
