"""The engine on a pixel mesh: ``KalmanFilter(mesh=...)`` (mirroring
tests/test_engine_mesh.py).  A mesh of ``["cpu"] * 8`` against the
unsharded port at the JAX package's mesh budgets (atol 2e-4; fused
sharded against unfused unsharded 3e-4; a one-device mesh 1e-6) and
against the JAX ``run_tip_engine`` on eight CPU devices at the
port-vs-JAX engine budget of tests/test_torch_engine.py (atol 2e-3);
the state and the per-pixel aux are actually split."""

import datetime

import numpy as np
import torch

from kafka_tpu_torch.core.propagators import PixelPrior
from kafka_tpu_torch.engine import FixedGaussianPrior, KalmanFilter
from kafka_tpu_torch.obsops import WCMAux, WCMOperator
from kafka_tpu_torch.shard import PixelShards, make_pixel_mesh
from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                               SyntheticObservations,
                                               run_tip_engine)

JAX_ATOL = 2e-3


def day(i):
    return datetime.datetime(2021, 3, 1) + datetime.timedelta(days=i)


def circle_mask(ny=12, nx=14, r=5):
    yy, xx = np.mgrid[:ny, :nx]
    return (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 < r**2


def mesh8():
    return make_pixel_mesh(["cpu"] * 8)


def same_outputs(out_a, out_b, atol):
    assert sorted(out_a.output) == sorted(out_b.output)
    for ts in out_b.output:
        assert sorted(out_a.output[ts]) == sorted(out_b.output[ts])
        for key in out_b.output[ts]:
            np.testing.assert_allclose(
                np.asarray(out_a.output[ts][key]),
                np.asarray(out_b.output[ts][key]), atol=atol,
                err_msg=f"{ts} {key}")


def test_sharded_run_matches_single_device_and_jax(eight_cpu_devices):
    from kafka_tpu.shard import make_pixel_mesh as jmesh
    from kafka_tpu.testing.synthetic import run_tip_engine as jax_run

    obs_days, grid_days = (1, 2, 4, 5), (0, 3, 6)
    kf_s, out_s, x_s, _ = run_tip_engine(obs_days, grid_days, device="cpu",
                                         mesh=mesh8())
    kf_r, out_r, x_r, _ = run_tip_engine(obs_days, grid_days, device="cpu")
    assert kf_s.gather.n_pad == kf_r.gather.n_pad
    same_outputs(out_s, out_r, 2e-4)
    np.testing.assert_allclose(np.asarray(x_s), x_r.numpy(), atol=2e-4)
    assert [r["n_iterations"] for r in kf_s.diagnostics_log] == \
        [r["n_iterations"] for r in kf_r.diagnostics_log]
    _, out_j, x_j, _ = jax_run(jmesh(eight_cpu_devices), 1, obs_days,
                               grid_days)
    same_outputs(out_s, out_j, JAX_ATOL)
    np.testing.assert_allclose(np.asarray(x_s), np.asarray(x_j),
                               atol=JAX_ATOL)


def test_fused_sharded_matches_unfused_single_device():
    obs_days, grid_days = (1, 3, 5, 7), (0, 2, 4, 6, 8)
    kf_s, out_s, x_s, _ = run_tip_engine(obs_days, grid_days, device="cpu",
                                         mesh=mesh8(), scan_window=4)
    kf_r, out_r, x_r, _ = run_tip_engine(obs_days, grid_days, device="cpu")
    assert any(rec.get("fused") for rec in kf_s.diagnostics_log), \
        "the sharded run should have taken the fused path"
    same_outputs(out_s, out_r, 3e-4)
    np.testing.assert_allclose(np.asarray(x_s), x_r.numpy(), atol=3e-4)


def test_state_actually_partitioned():
    kf, out, x_a, p_inv_a = run_tip_engine((1, 2), (0, 3), device="cpu",
                                           mesh=mesh8())
    n_pad = kf.gather.n_pad
    assert n_pad % 8 == 0
    for t in (x_a, p_inv_a):
        assert isinstance(t, PixelShards) and len(t.shards) == 8
        assert {s.shape[0] for s in t.shards} == {n_pad // 8}


def test_per_pixel_aux_is_sharded(eight_cpu_devices, monkeypatch):
    """Per-pixel aux leaves (SAR incidence angles) split on the pixel
    axis, not replicated; the sharded WCM run equals the unsharded one
    and the JAX package's sharded run."""
    import jax.numpy as jnp

    from kafka_tpu.core.propagators import PixelPrior as JPrior
    from kafka_tpu.engine import FixedGaussianPrior as JFixed
    from kafka_tpu.engine import KalmanFilter as JKalman
    from kafka_tpu.obsops import WCMOperator as JWCM
    from kafka_tpu.obsops.wcm import WCMAux as JAux
    from kafka_tpu.shard import make_pixel_mesh as jmesh
    from kafka_tpu.testing import MemoryOutput as JMemory
    from kafka_tpu.testing import SyntheticObservations as JObs

    from kafka_tpu_torch.shard import step as step_mod

    mask = circle_mask()
    truth = np.zeros(mask.shape + (2,), np.float32)
    truth[..., 0] = 2.0   # LAI
    truth[..., 1] = 0.25  # SM
    mean = np.asarray([1.0, 0.2], np.float32)
    cov = np.diag([1.0, 0.01]).astype(np.float32)
    inv = np.diag([1.0, 100.0]).astype(np.float32)

    def theta(n_pad):
        return 20.0 + 15.0 * np.linspace(0.0, 1.0, n_pad).astype(np.float32)

    seen = []
    real = step_mod.sharded_solve

    def spy(mesh, linearize, bands, x, p_inv, params, *a, **k):
        seen.append(params)
        return real(mesh, linearize, bands, x, p_inv, params, *a, **k)

    monkeypatch.setattr(step_mod, "sharded_solve", spy)

    def build(mesh):
        obs = SyntheticObservations(
            dates=[day(1), day(2)], operator=WCMOperator(),
            truth_fn=lambda date: truth, sigma=0.1,
            aux_fn=lambda date, g: WCMAux(theta_deg=torch.as_tensor(
                theta(g.n_pad))), mask_prob=0.0, device="cpu")
        prior = FixedGaussianPrior(
            PixelPrior(mean=torch.as_tensor(mean), cov=torch.as_tensor(cov),
                       inv_cov=torch.as_tensor(inv)), ("LAI", "SM"))
        kf = KalmanFilter(obs, MemoryOutput(), mask, ("LAI", "SM"),
                          state_propagation=None, prior=prior,
                          pad_multiple=64, scan_window=1, mesh=mesh,
                          mesh_lane=8, device=None if mesh else "cpu")
        kf.set_trajectory_uncertainty(np.zeros(2))
        x0, p_inv0 = prior.process_prior(None, kf.gather)
        x_a, _, _ = kf.run([day(0), day(3)], x0, None, p_inv0)
        return kf, x_a

    kf_s, x_s = build(mesh8())
    kf_r, x_r = build(None)
    assert len(x_s.shards) == 8
    n_pad = kf_s.gather.n_pad
    assert len(seen) == 2
    for params in seen:
        assert isinstance(params, step_mod.ShardAux) and len(params) == 8
        assert {a.theta_deg.shape for a in params} == {(n_pad // 8,)}
        np.testing.assert_array_equal(
            np.concatenate([a.theta_deg.numpy() for a in params]),
            theta(n_pad))
    np.testing.assert_allclose(np.asarray(x_s), x_r.numpy(), atol=2e-4)

    jobs = JObs(dates=[day(1), day(2)], operator=JWCM(),
                truth_fn=lambda date: truth, sigma=0.1,
                aux_fn=lambda date, g: JAux(theta_deg=jnp.asarray(
                    theta(g.n_pad))), mask_prob=0.0)
    jprior = JFixed(JPrior(mean=jnp.asarray(mean), cov=jnp.asarray(cov),
                           inv_cov=jnp.asarray(inv)), ("LAI", "SM"))
    jkf = JKalman(jobs, JMemory(), mask, ("LAI", "SM"),
                  state_propagation=None, prior=jprior, pad_multiple=64,
                  scan_window=1, mesh=jmesh(eight_cpu_devices),
                  mesh_lane=8)
    jkf.set_trajectory_uncertainty(np.zeros(2))
    jx0, jp0 = jprior.process_prior(None, jkf.gather)
    x_j, _, _ = jkf.run([day(0), day(3)], jx0, None, jp0)
    np.testing.assert_allclose(np.asarray(x_s), np.asarray(x_j),
                               atol=JAX_ATOL)


def test_single_device_mesh_works():
    """A one-device mesh (``device_mesh='local'`` on a one-card host)
    runs and matches the no-mesh path within 1e-6."""
    kf_s, out_s, x_s, _ = run_tip_engine((1, 2), (0, 3), device="cpu",
                                         mesh=make_pixel_mesh(["cpu"]))
    kf_r, out_r, x_r, _ = run_tip_engine((1, 2), (0, 3), device="cpu")
    assert kf_s.gather.n_pad == kf_r.gather.n_pad
    np.testing.assert_allclose(np.asarray(x_s), x_r.numpy(), atol=1e-6)
