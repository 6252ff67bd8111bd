"""The port's assimilation-quality ledger (``telemetry.quality``) and its
engine sites against the JAX package's, on the CPU and the same inputs:

- the ledger records of ``run_tip_engine`` and of the identity engine
  in both packages: verdicts equal, chi^2 within the engine's parity
  budget (rtol 1e-2, tests/test_torch_engine.py), drift flags equal;
- one ``KAFKA_TPU_FAULTS`` ``obs.bias`` spec flagging the same dates in
  both packages, the clean dates' records and outputs untouched;
- ``record_missing`` on a degraded read and ``record_smoothed``, record
  for record with the JAX ledger;
- the copied pieces (verdicts, sentinels, ``load_ledger``) on the JAX
  test's cases.
"""

import datetime
import os

import numpy as np
import pytest
import torch

from kafka_tpu import telemetry as jax_telemetry
from kafka_tpu.resilience import faults as jax_faults
from kafka_tpu.telemetry import MetricsRegistry as JaxRegistry
from kafka_tpu.telemetry import quality as jax_quality
from kafka_tpu_torch import telemetry
from kafka_tpu_torch.resilience import faults
from kafka_tpu_torch.telemetry import MetricsRegistry, quality

CHI2_RTOL = 1e-2


def day(i):
    return datetime.datetime(2017, 7, 1) + datetime.timedelta(days=i)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _ledger(directory):
    records, skipped = quality.load_ledger(
        os.path.join(directory, quality.LEDGER_FILENAME))
    assert skipped == 0
    return records


def _compare_ledgers(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert a["date"] == b["date"]
        assert a["verdict"] == b["verdict"], a["date"]
        assert a["drift"]["active"] == b["drift"]["active"], a["date"]
        assert a["drift"]["bands"] == b["drift"]["bands"], a["date"]
        assert a["n_valid"] == b["n_valid"]
        assert a["degraded"] == b["degraded"]
        assert a["solver_health"] == b["solver_health"]
        np.testing.assert_allclose(a["chi2_per_band"], b["chi2_per_band"],
                                   rtol=CHI2_RTOL)
        assert set(a) == set(b)


def test_run_tip_engine_ledger_matches_jax(tmp_path):
    from kafka_tpu.testing.synthetic import run_tip_engine as jax_run
    from kafka_tpu_torch.testing.synthetic import run_tip_engine

    with telemetry.use(MetricsRegistry(str(tmp_path / "port"))):
        kf, _, _, _ = run_tip_engine(device="cpu")
    with jax_telemetry.use(JaxRegistry(str(tmp_path / "jax"))):
        jax_run()
    port = _ledger(str(tmp_path / "port"))
    _compare_ledgers(port, _ledger(str(tmp_path / "jax")))
    for rec, led in zip(kf.diagnostics_log, port):
        assert rec["quality_verdict"] == led["verdict"]
        assert rec["quality_drift"] == led["drift"]["active"]


def run_identity_engine(package, telemetry_dir, scan_window=1, dates=None,
                        grid=None, ny=20, read_retry=None, prefetch=2):
    """The JAX test's identity engine (tests/test_quality.py:38) in
    either package: 8 observation dates over 5 grid windows, the
    diagonal information propagator, relaxation 0.5."""
    dates = dates or [day(i) for i in range(1, 16, 2)]
    grid = grid or [day(i) for i in range(0, 20, 4)]
    p = 2
    cov = np.diag(np.full(p, 0.4 ** 2)).astype(np.float32)
    truth = np.broadcast_to(np.array([0.3, 0.7], np.float32),
                            (ny, ny, 2)).astype(np.float32)
    extra = {}
    if read_retry is not None:
        extra["read_retry_policy"] = read_retry
    if package == "jax":
        import jax.numpy as jnp

        from kafka_tpu.core.propagators import (
            PixelPrior, propagate_information_filter_approx)
        from kafka_tpu.engine import FixedGaussianPrior, KalmanFilter
        from kafka_tpu.obsops.identity import IdentityOperator
        from kafka_tpu.testing.fixtures import make_pivot_mask
        from kafka_tpu.testing.synthetic import (MemoryOutput,
                                                 SyntheticObservations)

        use, registry = jax_telemetry.use, JaxRegistry
        prior_t = PixelPrior(mean=jnp.full((p,), 0.5, jnp.float32),
                             cov=jnp.asarray(cov),
                             inv_cov=jnp.asarray(np.linalg.inv(cov)))
        dev = {}
    else:
        from kafka_tpu_torch.core.propagators import (
            PixelPrior, propagate_information_filter_approx)
        from kafka_tpu_torch.engine import FixedGaussianPrior, KalmanFilter
        from kafka_tpu_torch.obsops.identity import IdentityOperator
        from kafka_tpu_torch.testing.fixtures import make_pivot_mask
        from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                       SyntheticObservations)

        use, registry = telemetry.use, MetricsRegistry
        prior_t = PixelPrior(mean=torch.full((p,), 0.5),
                             cov=torch.as_tensor(cov),
                             inv_cov=torch.as_tensor(np.linalg.inv(cov)))
        dev = {"device": "cpu"}
    mask = make_pivot_mask(ny, ny, seed=0)
    op = IdentityOperator(n_params=p, obs_indices=(0, 1))
    prior = FixedGaussianPrior(prior_t, ("a", "b"))
    with use(registry(telemetry_dir)) as reg:
        obs = SyntheticObservations(
            dates=dates, operator=op, truth_fn=lambda d: truth, sigma=0.02,
            mask_prob=0.1, seed=0, **dev)
        out = MemoryOutput()
        kf = KalmanFilter(
            obs, out, mask, ("a", "b"),
            state_propagation=propagate_information_filter_approx,
            prior=None, solver_options={"relaxation": 0.5},
            scan_window=scan_window, prefetch_depth=prefetch, **extra,
            **dev)
        kf.set_trajectory_model()
        kf.set_trajectory_uncertainty(np.full(p, 1e-3, np.float32))
        x0, p_inv0 = prior.process_prior(None, kf.gather)
        kf.run(grid, x0, None, p_inv0)
    return kf, out, reg


@pytest.mark.parametrize("scan_window", [1, 4])
def test_identity_engine_ledger_matches_jax(tmp_path, scan_window):
    run_identity_engine("torch", str(tmp_path / "port"), scan_window)
    run_identity_engine("jax", str(tmp_path / "jax"), scan_window)
    port = _ledger(str(tmp_path / "port"))
    _compare_ledgers(port, _ledger(str(tmp_path / "jax")))
    assert all(r["verdict"] == quality.CONSISTENT for r in port)
    assert [r["fused"] for r in port] == \
        [r["fused"] for r in _ledger(str(tmp_path / "jax"))]


def test_obs_bias_spec_flags_the_same_dates(tmp_path, monkeypatch):
    """One ``KAFKA_TPU_FAULTS`` spec, installed by each package from the
    environment, biases fetch-order dates 7-8 in both: the same records
    flip to OVERCONFIDENT with drift, the clean ones stay as in a clean
    run, and the clean windows' outputs are untouched."""
    _, out_c, _ = run_identity_engine("torch", str(tmp_path / "clean"))
    monkeypatch.setenv(faults.ENV_VAR, "obs.bias@7-8")
    assert faults.install_from_env() == 1
    assert jax_faults.install_from_env() == 1
    _, out_b, reg = run_identity_engine("torch", str(tmp_path / "port"))
    run_identity_engine("jax", str(tmp_path / "jax"))
    port = _ledger(str(tmp_path / "port"))
    ref = _ledger(str(tmp_path / "jax"))
    _compare_ledgers(port, ref)
    armed = {str(day(13)), str(day(15))}
    assert {r["date"] for r in port if r["drift"]["active"]} == armed
    assert {r["date"] for r in port
            if r["verdict"] == quality.OVERCONFIDENT} == armed
    clean = _ledger(str(tmp_path / "clean"))
    for a, c in zip(port, clean):
        if a["date"] not in armed:
            assert a["chi2_per_band"] == c["chi2_per_band"]
    assert reg.value("kafka_resilience_faults_injected_total",
                     site="obs.bias") == 2
    timesteps = sorted(out_c.output)
    for ts in timesteps[:-1]:
        for key, arr in out_c.output[ts].items():
            assert np.array_equal(arr, out_b.output[ts][key],
                                  equal_nan=True), (ts, key)
    assert not np.array_equal(out_c.output[timesteps[-1]]["a"],
                              out_b.output[timesteps[-1]]["a"])


def test_degraded_read_lands_as_a_missing_record(tmp_path):
    """A read that exhausts its retries (``prefetch.read_date`` armed on
    the second fetch) lands as one degraded NO_OBS record in both
    packages."""
    from kafka_tpu.resilience import RetryPolicy as JaxRetry
    from kafka_tpu_torch.resilience import RetryPolicy

    kw = dict(dates=[day(i) for i in (1, 3, 5)],
              grid=[day(0), day(2), day(4), day(6)], ny=12, prefetch=0)
    faults.script("prefetch.read_date", "2", faults.TRANSIENT)
    _, _, reg = run_identity_engine(
        "torch", str(tmp_path / "port"),
        read_retry=RetryPolicy(max_attempts=1, base_delay=0.0), **kw)
    jax_faults.script("prefetch.read_date", "2", jax_faults.TRANSIENT)
    run_identity_engine("jax", str(tmp_path / "jax"),
                        read_retry=JaxRetry(max_attempts=1, base_delay=0.0),
                        **kw)
    port = _ledger(str(tmp_path / "port"))
    ref = _ledger(str(tmp_path / "jax"))
    _compare_ledgers(port, ref)
    degraded = [r for r in port if r["degraded"]]
    assert len(degraded) == 1 and degraded[0]["date"] == str(day(3))
    assert degraded[0]["verdict"] == quality.NO_OBS
    assert degraded[0]["reason"] == "degraded_read"
    assert reg.value("kafka_quality_windows_total",
                     verdict=quality.NO_OBS) == 1


def test_record_smoothed_matches_jax(tmp_path):
    shrink = [0.91, 0.999, float("nan")]
    recs = []
    for pkg, use, reg_cls, q in (
            ("port", telemetry.use, MetricsRegistry, quality),
            ("jax", jax_telemetry.use, JaxRegistry, jax_quality)):
        with use(reg_cls(str(tmp_path / pkg))) as reg:
            ledger = q.get_ledger(reg)
            ledger.record_smoothed("2017-07-05", shrink, n_valid=12,
                                   prefix="tile:t0")
            ledger.record_smoothed("2017-07-09", [1.01, 0.9], n_valid=12)
            recs.append((_ledger(str(tmp_path / pkg)), ledger.summary(),
                         reg.value("kafka_quality_windows_total",
                                   verdict=q.OVERCONFIDENT)))
    (port, port_sum, port_over), (ref, ref_sum, ref_over) = recs
    assert [r["verdict"] for r in port] == [r["verdict"] for r in ref] \
        == [quality.CONSISTENT, quality.OVERCONFIDENT]
    for a, b in zip(port, ref):
        a, b = dict(a), dict(b)
        a.pop("ts"), b.pop("ts")
        assert a == b or str(a) == str(b)
    port_sum.pop("ledger_path"), ref_sum.pop("ledger_path")
    assert port_sum == ref_sum
    assert port_over == ref_over == 1


@pytest.mark.parametrize("ratios", [[0.9, 1.1], [3.0, 0.5], [0.005, 0.8],
                                    [0.0, float("nan")], [], [0.01, 2.5]])
def test_verdicts_match_jax(ratios):
    assert quality.verdict_for(ratios) == jax_quality.verdict_for(ratios)
    assert quality.smoothed_verdict_for(ratios) == \
        jax_quality.smoothed_verdict_for(ratios)


def test_drift_sentinel_matches_jax():
    rng = np.random.default_rng(5)
    series = list(np.exp(rng.normal(0.0, 0.2, 30)))
    series[12:16] = [v * 40.0 for v in series[12:16]]
    series[22:25] = [v / 60.0 for v in series[22:25]]
    a, b = quality.DriftSentinel(), jax_quality.DriftSentinel()
    for v in series:
        assert a.update(v) == b.update(v)


def test_load_ledger_skips_torn_lines(tmp_path):
    path = tmp_path / quality.LEDGER_FILENAME
    path.write_text('{"verdict": "CONSISTENT", "date": "d"}\n'
                    '{"torn": \n[1, 2]\n\n')
    assert quality.load_ledger(str(path)) == \
        jax_quality.load_ledger(str(path))
    assert quality.load_ledger(str(path))[1] == 2
