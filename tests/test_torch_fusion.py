"""Temporal fusion in the port: fused blocks against the JAX engine's on
tests/test_fusion.py's pipeline (two-stream, the exact information
propagator, sigma 0.03, relaxation 0.7, Q 1e-3), the port's fused run
against its own unfused run bit for bit, the block plan, and a degraded
date breaking a block.

Port against JAX is held to the budgets of the JAX package's own
fused-vs-unfused test (test_fused_matches_unfused): the state within
2e-3, every raster within rtol 1e-2 / atol 2e-3, the same output keys
and equal QA bands.  Port fused against port unfused must give the same
bits: both run the same torch operations in the same order."""

import datetime

import numpy as np
import pytest
import torch

from kafka_tpu_torch.core.propagators import (propagate_information_filter,
                                              tip_prior, tip_prior_arrays)
from kafka_tpu_torch.engine import (TIP_PARAMETER_LIST, FixedGaussianPrior,
                                    KalmanFilter)
from kafka_tpu_torch.obsops import TwoStreamOperator
from kafka_tpu_torch.resilience import RetryPolicy, faults
from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                               SyntheticObservations,
                                               run_s2_engine)


def day(i):
    return datetime.datetime(2018, 5, 1) + datetime.timedelta(days=i)


def pivot_mask(ny=14, nx=18, r=6):
    yy, xx = np.mgrid[:ny, :nx]
    return (yy - ny // 2) ** 2 + (xx - nx // 2) ** 2 < r * r


def tip_truth(mask, seed=3):
    rng = np.random.default_rng(seed)
    truth = np.broadcast_to(tip_prior_arrays()[0],
                            mask.shape + (7,)).copy()
    truth[..., 6] = np.clip(
        0.45 + 0.1 * rng.standard_normal(mask.shape), 0.1, 0.9
    ).astype(np.float32)
    return truth.astype(np.float32)


def torch_pipeline(scan_window, n_days=9, grid_step=1, checkpointer=None,
                   read_retry_policy=None, checkpoint_every_n=1):
    """tests/test_fusion.py's run_pipeline through the port, on the CPU."""
    mask = pivot_mask()
    op = TwoStreamOperator()
    truth = tip_truth(mask)
    obs = SyntheticObservations(
        dates=[day(i) for i in range(1, n_days)], operator=op,
        truth_fn=lambda date: truth, sigma=0.03, mask_prob=0.1,
        device="cpu")
    out = MemoryOutput()
    kf = KalmanFilter(
        obs, out, mask, TIP_PARAMETER_LIST,
        state_propagation=propagate_information_filter, prior=None,
        pad_multiple=128, scan_window=scan_window,
        solver_options={"relaxation": 0.7},
        checkpoint_every_n=checkpoint_every_n,
        read_retry_policy=read_retry_policy, device="cpu")
    kf.set_trajectory_model()
    kf.set_trajectory_uncertainty(np.full(7, 1e-3, np.float32))
    p0 = FixedGaussianPrior(tip_prior("cpu"), TIP_PARAMETER_LIST)
    x0, p_inv0 = p0.process_prior(None, kf.gather)
    grid = [day(i) for i in range(0, n_days + 1, grid_step)]
    x_a, _, p_inv_a = kf.run(grid, x0, None, p_inv0,
                             checkpointer=checkpointer)
    return kf, out, x_a, p_inv_a


def jax_pipeline(scan_window, n_days=9, grid_step=1, checkpointer=None,
                 read_retry_policy=None, checkpoint_every_n=1):
    """The same pipeline through the JAX package (tests/test_fusion.py)."""
    from kafka_tpu.core.propagators import propagate_information_filter \
        as jax_prop
    from kafka_tpu.core.propagators import tip_prior as jax_tip_prior
    from kafka_tpu.engine import KalmanFilter as JaxFilter
    from kafka_tpu.engine.priors import FixedGaussianPrior as JaxPrior
    from kafka_tpu.obsops.twostream import TwoStreamOperator as JaxOp
    from kafka_tpu.testing import MemoryOutput as JaxMemory
    from kafka_tpu.testing import SyntheticObservations as JaxObs

    mask = pivot_mask()
    truth = tip_truth(mask)
    obs = JaxObs(dates=[day(i) for i in range(1, n_days)], operator=JaxOp(),
                 truth_fn=lambda date: truth, sigma=0.03, mask_prob=0.1)
    out = JaxMemory()
    kf = JaxFilter(obs, out, mask, TIP_PARAMETER_LIST,
                   state_propagation=jax_prop, prior=None, pad_multiple=128,
                   scan_window=scan_window,
                   solver_options={"relaxation": 0.7},
                   checkpoint_every_n=checkpoint_every_n,
                   read_retry_policy=read_retry_policy)
    kf.set_trajectory_model()
    kf.set_trajectory_uncertainty(np.full(7, 1e-3, np.float32))
    x0, p_inv0 = JaxPrior(jax_tip_prior(), TIP_PARAMETER_LIST) \
        .process_prior(None, kf.gather)
    grid = [day(i) for i in range(0, n_days + 1, grid_step)]
    x_a, _, p_inv_a = kf.run(grid, x0, None, p_inv0,
                             checkpointer=checkpointer)
    return kf, out, np.asarray(x_a), np.asarray(p_inv_a)


def plan(kf):
    """The block plan of a run: (date, fused) per diagnostic record."""
    return [(r["date"], r.get("fused")) for r in kf.diagnostics_log]


@pytest.fixture(scope="module")
def runs():
    return {"jax4": jax_pipeline(4), "torch4": torch_pipeline(4),
            "torch1": torch_pipeline(1)}


def test_fused_matches_jax_fused(runs):
    kf_j, out_j, x_j, _ = runs["jax4"]
    kf_t, out_t, x_t, _ = runs["torch4"]
    np.testing.assert_allclose(x_t.numpy(), x_j, atol=2e-3)
    assert sorted(out_t.output) == sorted(out_j.output)
    for ts in out_j.output:
        assert sorted(out_t.output[ts]) == sorted(out_j.output[ts])
        for key, raster in out_j.output[ts].items():
            got = out_t.output[ts][key]
            if key == "solver_qa":
                np.testing.assert_array_equal(got, np.asarray(raster))
            else:
                np.testing.assert_allclose(got, raster, rtol=1e-2,
                                           atol=2e-3, err_msg=f"{ts} {key}")


def test_block_plan_and_diagnostics_match_jax(runs):
    kf_j, kf_t = runs["jax4"][0], runs["torch4"][0]
    assert plan(kf_t) == plan(kf_j)
    assert any(f == 4 for _, f in plan(kf_t))
    assert [r["n_iterations"] for r in kf_t.diagnostics_log] == \
        [r["n_iterations"] for r in kf_j.diagnostics_log]
    for rt, rj in zip(kf_t.diagnostics_log, kf_j.diagnostics_log):
        assert set(rt) <= set(rj) | {"wall_s"}
        for key in ("bounds_clipped", "nodata", "quarantined",
                    "cap_bailouts", "damped_recovered", "nonfinite"):
            assert rt[key] == rj[key], key


def test_fused_equals_unfused_bit_for_bit(runs):
    kf4, out4, x4, pi4 = runs["torch4"]
    kf1, out1, x1, pi1 = runs["torch1"]
    assert any("fused" in r for r in kf4.diagnostics_log)
    assert not any("fused" in r for r in kf1.diagnostics_log)
    assert torch.equal(x4, x1) and torch.equal(pi4, pi1)
    assert sorted(out4.output) == sorted(out1.output)
    for ts in out1.output:
        for key, raster in out1.output[ts].items():
            np.testing.assert_array_equal(out4.output[ts][key], raster,
                                          err_msg=f"{ts} {key}")


def test_fused_block_bounds_follow_the_jax_guards():
    """_block_fits counts elements (the JAX constants): at the MODIS tile
    (4,608,000 px, 7 parameters, 2 bands) three windows fit, four do not;
    the bucketing then runs blocks of two."""
    from types import SimpleNamespace

    from kafka_tpu.engine.filter import KalmanFilter as JaxFilter

    for name in ("_SCAN_MAX_STATE_ELEMS", "_SCAN_MAX_BAND_ELEMS",
                 "_SCAN_MAX_AUX_BYTES"):
        assert getattr(KalmanFilter, name) == getattr(JaxFilter, name)
    kf = KalmanFilter.__new__(KalmanFilter)
    kf.gather = SimpleNamespace(n_pad=4_608_000)
    kf.n_params = 7
    obs = SimpleNamespace(
        bands=SimpleNamespace(y=np.empty((2, 4_608_000), np.float32)),
        aux=None)
    assert kf._block_fits(obs, 3) and not kf._block_fits(obs, 4)


def test_prosail_fused_equals_unfused():
    """PROSAIL under fusion: the ProsailAux leaves stack along the window
    axis and the row loop runs per step with the same linearize_block;
    the fused run gives the unfused run's bits."""
    outs = {sw: run_s2_engine(12, 12, scan_window=sw, device="cpu")
            for sw in (1, 8)}
    assert any(r.get("fused") == 2 for r in outs[8][0].diagnostics_log)
    assert not any("fused" in r for r in outs[1][0].diagnostics_log)
    assert torch.equal(outs[8][2], outs[1][2])
    assert torch.equal(outs[8][3], outs[1][3])
    for ts, rasters in outs[1][1].output.items():
        for key, raster in rasters.items():
            np.testing.assert_array_equal(outs[8][1].output[ts][key], raster)


@pytest.mark.parametrize("fail_call", [3])
def test_degraded_date_breaks_a_block_like_jax(fail_call):
    """A transient read failure that exhausts its retries degrades the
    date: it cannot join a fused block, is parked, and the unfused path
    sees None again (predict-only).  The port's plan and outputs follow
    the JAX engine's under the same fault script."""
    from kafka_tpu.resilience import RetryPolicy as JaxPolicy
    from kafka_tpu.resilience import faults as jax_faults

    no_retry = dict(max_attempts=1, base_delay=0.0, jitter=0.0)
    try:
        faults.script("prefetch.read_date", str(fail_call))
        kf_t, out_t, x_t, _ = torch_pipeline(
            4, read_retry_policy=RetryPolicy(**no_retry))
    finally:
        faults.reset()
    try:
        jax_faults.script("prefetch.read_date", str(fail_call))
        kf_j, out_j, x_j, _ = jax_pipeline(
            4, read_retry_policy=JaxPolicy(**no_retry))
    finally:
        jax_faults.reset()
    assert kf_t._degraded_count == 1
    # 8 acquisitions, one of them degraded to predict-only.
    assert len(kf_t.diagnostics_log) == 7
    assert plan(kf_t) == plan(kf_j)
    # The degraded third date cuts the first block to two windows and
    # runs predict-only; the next four fuse.
    assert [f for _, f in plan(kf_t)] == [2, 2, 4, 4, 4, 4, None]
    np.testing.assert_allclose(x_t.numpy(), x_j, atol=2e-3)
    for ts in out_j.output:
        # The predict-only window has no QA band, in either package.
        assert sorted(out_t.output[ts]) == sorted(out_j.output[ts])
        if "solver_qa" in out_j.output[ts]:
            np.testing.assert_array_equal(
                out_t.output[ts]["solver_qa"],
                np.asarray(out_j.output[ts]["solver_qa"]))
