"""Band-sequential assimilation in the port against the JAX package: the
five cases of tests/test_band_sequential.py, each run through both
packages' ``KalmanFilter`` on the same seeded truths and observations.

Per band the port runs one Gauss-Newton loop on a ``BandView`` (its
default: the row loop around the fused update at (p, 1), the plain
version on the CPU); the JAX engine its default XLA loop.  Budgets: the
engine's (atol 2e-3 on rasters, QA and per-date iteration sums equal;
on the loose-prior Hessian case only on pixels not at the iteration
cap, see ``_held``); for
the linear operator the sequential chain equals the joint update
within the JAX test's 5e-5 (state) and rtol 1e-4 / atol 1e-3
(information) in the port itself.
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

X_ATOL = 2e-3


def day(i):
    return datetime.datetime(2020, 6, 1) + datetime.timedelta(days=i)


def circle_mask(ny=10, nx=12, r=4):
    yy, xx = np.mgrid[:ny, :nx]
    return (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 < r ** 2


def _prior(pkg, mean, cov, params):
    if pkg == "kafka_tpu_torch":
        from kafka_tpu_torch import convert

        return convert.fixed_gaussian_prior(mean, cov, np.linalg.inv(cov),
                                            params, "cpu")
    from kafka_tpu.core.propagators import PixelPrior
    from kafka_tpu.engine import FixedGaussianPrior

    return FixedGaussianPrior(
        PixelPrior(mean=jnp.asarray(mean), cov=jnp.asarray(cov),
                   inv_cov=jnp.asarray(np.linalg.inv(cov))), params)


def _op(pkg, name, *args):
    import importlib

    return getattr(importlib.import_module(pkg + ".obsops"), name)(*args)


def _run(pkg, op, truth, prior, params, band_sequential, mask,
         solver_options=None, hessian_correction=False):
    """tests/test_band_sequential.py:_run in ``pkg``."""
    import importlib

    port = pkg == "kafka_tpu_torch"
    kw = {"device": "cpu"} if port else {}
    eng = importlib.import_module(pkg + ".engine")
    syn = importlib.import_module(pkg + ".testing.synthetic")
    obs = syn.SyntheticObservations(
        dates=[day(1), day(2)], operator=op,
        truth_fn=lambda date: truth, sigma=0.01, mask_prob=0.1, **kw)
    out = syn.MemoryOutput()
    kf = eng.KalmanFilter(
        obs, out, mask, params, state_propagation=None, prior=prior,
        pad_multiple=128, band_sequential=band_sequential, scan_window=8,
        solver_options=solver_options,
        hessian_correction=hessian_correction, **kw)
    kf.set_trajectory_uncertainty(np.zeros(len(params)))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    x_a, _, p_inv_a = kf.run([day(0), day(3)], x0, None, p_inv0)
    return kf, out, np.asarray(x_a), np.asarray(p_inv_a)


def _both(make_op, truth, mean, cov, params, band_sequential, mask, **kw):
    runs = {}
    for pkg in ("kafka_tpu", "kafka_tpu_torch"):
        runs[pkg] = _run(pkg, make_op(pkg), truth,
                         _prior(pkg, mean, cov, params), params,
                         band_sequential, mask, **kw)
    return runs["kafka_tpu"], runs["kafka_tpu_torch"]


def _held(jrun, trun, settled_only=False):
    """Rasters within X_ATOL, QA equal, records equal.  ``settled_only``
    compares the rasters only on pixels whose QA lacks QA_CAP_BAILOUT:
    those still oscillate at the iteration cap, where rounding decides
    the last iterate (the JAX package's own XLA and Pallas generations
    disagree there too on the loose-prior Hessian case)."""
    from kafka_tpu_torch.core.solver_health import QA_CAP_BAILOUT

    jkf, jout, jx, jp = jrun
    kf, out, x, p = trun
    assert sorted(out.output) == sorted(jout.output)
    for ts in jout.output:
        assert sorted(out.output[ts]) == sorted(jout.output[ts])
        keep = np.ones(kf.gather.mask.shape, bool)
        if settled_only:
            keep = (out.output[ts]["solver_qa"] & QA_CAP_BAILOUT) == 0
            print(f"{ts}: {int((~keep & kf.gather.mask).sum())} of "
                  f"{int(kf.gather.mask.sum())} pixels at the cap")
        for key, ref in jout.output[ts].items():
            if key == "solver_qa":
                np.testing.assert_array_equal(out.output[ts][key], ref)
            else:
                assert np.isfinite(out.output[ts][key]).all(), key
                np.testing.assert_allclose(out.output[ts][key][keep],
                                           ref[keep], atol=X_ATOL,
                                           err_msg=f"{ts} {key}")
    if not settled_only:
        np.testing.assert_allclose(x, jx, atol=X_ATOL)
    assert len(kf.diagnostics_log) == len(jkf.diagnostics_log)
    for rt, rj in zip(kf.diagnostics_log, jkf.diagnostics_log):
        assert rt["n_iterations"] == rj["n_iterations"]
        assert rt.get("fused") == rj.get("fused")
        assert len(rt["chi2_per_band"]) == len(rj["chi2_per_band"])
        if not settled_only:  # chi^2 sums the oscillating pixels too
            np.testing.assert_allclose(rt["chi2_per_band"],
                                       rj["chi2_per_band"], rtol=1e-2,
                                       atol=1e-3)
        assert rt["nodata"] == rj["nodata"]


def test_linear_operator_sequential_equals_joint():
    mask = circle_mask()
    p = 3
    params = ("a", "b", "c")
    truth = np.random.default_rng(9).uniform(0.3, 0.7, mask.shape + (p,)) \
        .astype(np.float32)
    mean = np.full(p, 0.5, np.float32)
    cov = np.diag(np.full(p, 0.25)).astype(np.float32)

    def make(pkg):
        return _op(pkg, "IdentityOperator", p, (0, 1, 2))

    seq_j, seq_t = _both(make, truth, mean, cov, params, True, mask)
    _held(seq_j, seq_t)
    _, out_s, x_s, pinv_s = seq_t
    _, out_j, x_j, pinv_j = _run("kafka_tpu_torch", make("kafka_tpu_torch"),
                                 truth, _prior("kafka_tpu_torch", mean, cov,
                                               params), params, False, mask)
    np.testing.assert_allclose(x_s, x_j, atol=5e-5)
    np.testing.assert_allclose(pinv_s, pinv_j, rtol=1e-4, atol=1e-3)
    for ts in out_j.output:
        for key in out_j.output[ts]:
            np.testing.assert_allclose(out_s.output[ts][key],
                                       out_j.output[ts][key], atol=1e-4,
                                       err_msg=f"{ts} {key}")


def test_fusion_disabled_under_band_sequential():
    mask = circle_mask()
    params = ("a", "b")
    truth = np.full(mask.shape + (2,), 0.5, np.float32)
    cov = np.diag([0.1, 0.1]).astype(np.float32)

    def make(pkg):
        return _op(pkg, "IdentityOperator", 2, (0, 1))

    jrun, trun = _both(make, truth, np.full(2, 0.5, np.float32), cov,
                       params, True, mask)
    _held(jrun, trun)
    assert not any(r.get("fused") for r in trun[0].diagnostics_log)
    assert not trun[0]._fusion_possible()


def _tip(mask, tlai):
    from kafka_tpu_torch.core.propagators import tip_prior_arrays

    mean = tip_prior_arrays()[0]
    truth = np.broadcast_to(mean, mask.shape + (7,)).copy()
    if tlai is not None:
        truth[..., 6] = tlai
    return mean, truth


def test_nonlinear_two_stream_converges_finite():
    from kafka_tpu_torch.engine.priors import TIP_PARAMETER_LIST

    mask = circle_mask()
    mean, truth = _tip(mask, 0.45)
    sigma = np.full(7, 0.01, np.float32)
    sigma[6] = 0.5
    cov = np.diag(sigma ** 2).astype(np.float32)
    jrun, trun = _both(lambda pkg: _op(pkg, "TwoStreamOperator"), truth,
                       mean, cov, TIP_PARAMETER_LIST, True, mask,
                       solver_options={"relaxation": 0.7,
                                       "max_iterations": 40})
    _held(jrun, trun)
    kf, out, x_a, pinv_a = trun
    assert np.isfinite(x_a).all() and np.isfinite(pinv_a).all()
    tlai = out.output[day(3)]["TeLAI"][mask]
    assert 0.39 < float(tlai.mean()) < 0.55
    assert ((tlai > 0.0) & (tlai < 1.0)).all()
    assert all(r["n_iterations"] >= 4 for r in kf.diagnostics_log)
    # The merged verdicts cover both bands' loops: the QA band is written.
    assert "solver_qa" in out.output[day(3)]


@pytest.mark.parametrize("band_seq", [True, False],
                         ids=["sequential", "joint"])
def test_hessian_correction_runs_per_band(band_seq):
    from kafka_tpu_torch.core.propagators import tip_prior_arrays
    from kafka_tpu_torch.engine.priors import TIP_PARAMETER_LIST

    mask = circle_mask(8, 8, 3)
    mean, truth = _tip(mask, None)
    cov = tip_prior_arrays()[1]
    jrun, trun = _both(lambda pkg: _op(pkg, "TwoStreamOperator"), truth,
                       mean, cov, TIP_PARAMETER_LIST, band_seq, mask,
                       solver_options={"relaxation": 0.7},
                       hessian_correction=True)
    _, _, x_a, pinv_a = trun
    assert np.isfinite(x_a).all() and np.isfinite(pinv_a).all()
    _held(jrun, trun, settled_only=True)


def test_linearize_only_operator_rejected_clearly():
    from kafka_tpu_torch.engine import KalmanFilter
    from kafka_tpu_torch.obsops import IdentityOperator
    from kafka_tpu_torch.obsops.protocol import ObservationModel
    from kafka_tpu_torch.testing import MemoryOutput, SyntheticObservations
    from kafka_tpu_torch.core.types import Linearization

    class LinearizeOnly(ObservationModel):
        n_bands, n_params = 2, 2

        def linearize(self, aux, x):
            n = x.shape[0]
            return Linearization(h0=torch.zeros((2, n)),
                                 jac=torch.zeros((2, n, 2)))

    mask = circle_mask(6, 6, 2)
    obs = SyntheticObservations(
        dates=[day(1)], operator=IdentityOperator(2, (0, 1)),
        truth_fn=lambda d: np.full(mask.shape + (2,), 0.5, np.float32),
        sigma=0.02, device="cpu")
    kf = KalmanFilter(obs, MemoryOutput(), mask, ("a", "b"),
                      band_sequential=True, device="cpu")
    with pytest.raises(TypeError, match="forward_pixel"):
        kf._band_view(LinearizeOnly(), 0)
    view = kf._band_view(IdentityOperator(2, (0, 1)), 1)
    assert view.n_bands == 1 and not getattr(view, "kernel_physics", None)
