"""The port's ``KalmanFilter.run`` against the JAX engine, date by date.

The tiny TIP problem of ``run_tip_engine`` (12 x 14 raster, 4 dates, 4
grid windows, prior-only advance, relaxation 0.7, max 40 iterations) runs
through both packages on the same numpy-drawn observations.  Mean, sigma
(``_unc``) and ``solver_qa`` rasters are compared per timestep at atol
2e-3, the JAX package's float32 Gauss-Newton budget for two solve paths
(tests/test_solvers.py:702-716): the observations' clean forward model is
computed by each package, and float32 sums in another order feed back
through the loop.  QA rasters and per-date iteration counts must match.
"""

import datetime

import numpy as np
import pytest

from kafka_tpu_torch.testing.synthetic import run_tip_engine as torch_run

ATOL = 2e-3


def _jax_run(solver_options):
    """The JAX ``run_tip_engine`` construction with chosen solver options
    (the JAX helper fixes them)."""
    import jax.numpy as jnp

    from kafka_tpu.core.propagators import PixelPrior
    from kafka_tpu.engine import FixedGaussianPrior, KalmanFilter
    from kafka_tpu.engine.priors import TIP_PARAMETER_LIST, jrc_prior
    from kafka_tpu.obsops import TwoStreamOperator
    from kafka_tpu.testing.synthetic import (MemoryOutput,
                                             SyntheticObservations)

    def day(i):
        return datetime.datetime(2021, 3, 1) + datetime.timedelta(days=i)

    ny, nx = 12, 14
    yy, xx = np.mgrid[:ny, :nx]
    mask = (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 < (min(ny, nx) / 2.4) ** 2
    truth = np.broadcast_to(np.asarray(jrc_prior().prior.mean),
                            mask.shape + (7,)).copy()
    truth[..., 6] = 0.45
    obs = SyntheticObservations([day(i) for i in (1, 3, 5, 7)],
                                TwoStreamOperator(), lambda date: truth,
                                sigma=0.001, mask_prob=0.05)
    out = MemoryOutput()
    sigma = np.full(7, 0.01, np.float32)
    sigma[6] = 0.5
    cov = np.diag(sigma**2).astype(np.float32)
    prior = FixedGaussianPrior(
        PixelPrior(mean=jnp.asarray(np.asarray(jrc_prior().prior.mean)),
                   cov=jnp.asarray(cov),
                   inv_cov=jnp.asarray(np.linalg.inv(cov))),
        TIP_PARAMETER_LIST)
    kf = KalmanFilter(obs, out, mask, TIP_PARAMETER_LIST,
                      state_propagation=None, prior=prior, pad_multiple=128,
                      solver_options=solver_options, scan_window=1,
                      prefetch_depth=0)
    kf.set_trajectory_uncertainty(np.zeros(7))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    kf.run([day(i) for i in (0, 2, 4, 6, 8)], x0, None, p_inv0)
    return kf, out


def _compare(jax_kf, jax_out, kf, out):
    assert sorted(out.output) == sorted(jax_out.output)
    for ts in jax_out.output:
        ref = jax_out.output[ts]
        got = out.output[ts]
        assert sorted(got) == sorted(ref), ts
        for key in ref:
            if key == "solver_qa":
                np.testing.assert_array_equal(got[key], ref[key])
            else:
                assert np.isfinite(got[key]).all(), key
                np.testing.assert_allclose(got[key], ref[key], atol=ATOL,
                                           err_msg=f"{ts} {key}")
    assert len(kf.diagnostics_log) == len(jax_kf.diagnostics_log) == 4
    for rt, rj in zip(kf.diagnostics_log, jax_kf.diagnostics_log):
        assert rt["date"] == rj["date"]
        for field in ("n_iterations", "nodata", "cap_bailouts",
                      "damped_recovered", "quarantined", "nonfinite",
                      "clip_saturated"):
            assert rt[field] == rj[field], field
        np.testing.assert_allclose(rt["chi2_per_band"], rj["chi2_per_band"],
                                   rtol=1e-2)


def test_default_port_run_matches_jax_run_tip_engine():
    """The port's default (fused kernel path, plain version on the CPU)
    against the JAX ``run_tip_engine()`` as shipped (XLA loop)."""
    from kafka_tpu.testing.synthetic import run_tip_engine as jax_run

    jkf, jout, _, _ = jax_run()
    kf, out, x_a, p_inv_a = torch_run(device="cpu")
    _compare(jkf, jout, kf, out)
    assert x_a.shape == (128, 7) and p_inv_a.shape == (128, 7, 7)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_port_paths_match_jax_paths(use_pallas):
    """Same path on both sides: the plain loop against the JAX XLA loop,
    the in-kernel path against the JAX in-kernel path."""
    opts = {"relaxation": 0.7, "max_iterations": 40,
            "use_pallas": use_pallas}
    jkf, jout = _jax_run(opts)
    kf, out, _, _ = torch_run(solver_options=opts, device="cpu")
    _compare(jkf, jout, kf, out)


def test_engine_records_and_qa_band():
    kf, out, _, _ = torch_run(device="cpu")
    rec = kf.diagnostics_log[0]
    for key in ("n_iterations", "convergence_norm", "bounds_clipped",
                "nodata", "chi2_per_band", "wall_s", "cap_bailouts",
                "damped_recovered", "quarantined", "nonfinite",
                "clip_saturated"):
        assert key in rec, key
    assert len(rec["chi2_per_band"]) == 2 and len(rec["clip_saturated"]) == 7
    qa = next(iter(out.output.values()))["solver_qa"]
    assert qa.dtype == np.uint8
    assert set(np.unique(qa[kf.gather.mask])) <= {1, 2, 3, 5, 6, 7, 16}
    assert (qa[~kf.gather.mask] == 0).all()


def test_window_without_observations_passes_forecast_through():
    kf, out, _, _ = torch_run(obs_days=(1,), grid_days=(0, 2, 4),
                              device="cpu")
    ts = sorted(out.output)
    assert len(kf.diagnostics_log) == 1
    empty = out.output[ts[1]]
    assert "solver_qa" not in empty
    mean = kf.prior.prior.mean.numpy()
    np.testing.assert_allclose(empty["w_vis"][kf.gather.mask], mean[0],
                               rtol=1e-6)


def _jax_s2_run(solver_options):
    """The port's ``run_s2_engine`` built the same way in the JAX package:
    16 x 16 px field, 3 dates on a 2-day grid, sail_prior, no
    propagation with Q = 0, scene-constant S2 geometry."""
    import jax.numpy as jnp

    from kafka_tpu.engine import KalmanFilter
    from kafka_tpu.engine.priors import PROSAIL_PARAMETER_LIST, sail_prior
    from kafka_tpu.obsops.prosail import ProsailAux, ProsailOperator
    from kafka_tpu.testing.synthetic import (MemoryOutput,
                                             SyntheticObservations)

    def day(i):
        return datetime.datetime(2017, 7, 3) + datetime.timedelta(days=i)

    ny = nx = 16
    yy, xx = np.mgrid[:ny, :nx]
    mask = (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 < (min(ny, nx) / 2.2) ** 2
    prior = sail_prior()
    truth = np.asarray(prior.prior.mean).copy()
    truth[6] = np.exp(-1.5)
    truth = np.broadcast_to(truth, mask.shape + (10,))
    aux = ProsailAux(*(jnp.asarray(np.float32(v)) for v in (30.5, 5.0, -50.0)))
    obs = SyntheticObservations([day(i) for i in (1, 3, 5)],
                                ProsailOperator(), lambda date: truth,
                                sigma=0.005, aux_fn=lambda d, g: aux,
                                mask_prob=0.1)
    out = MemoryOutput()
    kf = KalmanFilter(obs, out, mask, PROSAIL_PARAMETER_LIST,
                      state_propagation=None, prior=prior, pad_multiple=128,
                      solver_options=solver_options, scan_window=1,
                      prefetch_depth=0)
    kf.set_trajectory_uncertainty(np.zeros(10))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    kf.run([day(i) for i in (0, 2, 4, 6)], x0, None, p_inv0)
    return kf, out


def test_s2_prosail_run_matches_jax():
    """The port's default S2 path (the row loop around the fused update,
    plain version on the CPU) against the JAX KalmanFilter as shipped
    (XLA loop), date by date: means and ``_unc`` within 2e-3, QA equal."""
    from kafka_tpu_torch.testing.synthetic import run_s2_engine

    jkf, jout = _jax_s2_run({"relaxation": 0.7})
    kf, out, x_a, p_inv_a = run_s2_engine(device="cpu")
    assert sorted(out.output) == sorted(jout.output)
    worst = max(float(np.abs(out.output[ts][k] - jout.output[ts][k]).max())
                for ts in jout.output for k in jout.output[ts]
                if k != "solver_qa")
    print(f"parity s2 engine: mean/unc {worst:.3g}")
    for ts in jout.output:
        ref, got = jout.output[ts], out.output[ts]
        assert sorted(got) == sorted(ref), ts
        for key in ref:
            if key == "solver_qa":
                np.testing.assert_array_equal(got[key], ref[key])
            else:
                assert np.isfinite(got[key]).all(), key
                np.testing.assert_allclose(got[key], ref[key], atol=ATOL,
                                           err_msg=f"{ts} {key}")
    assert len(kf.diagnostics_log) == len(jkf.diagnostics_log) == 3
    for rt, rj in zip(kf.diagnostics_log, jkf.diagnostics_log):
        for field in ("n_iterations", "nodata", "cap_bailouts",
                      "quarantined", "nonfinite", "clip_saturated"):
            assert rt[field] == rj[field], field
    assert x_a.shape == (256, 10) and p_inv_a.shape == (256, 10, 10)
