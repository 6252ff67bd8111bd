"""The port's RTS smoother (``kafka_tpu_torch.smoother``) and offline
driver (``cli/kafka_smooth.py``) against the JAX package's, on the CPU
and the same numpy inputs.

- ``smooth_chain`` in both packages, and both against the dense float64
  oracle ``rts_smoother_np``, within the JAX test's budgets (x rtol
  1e-3 / atol 1e-4, the information diagonal rtol 2e-3);
- the newest date the filter's analysis bit for bit, the smoothed
  sigma never larger than the filter's, the QA bits equal to JAX's;
- ``load_chain`` skipping a corrupt newest and an incomplete middle set,
  the propagator fallback of sidecar-less sets, and chains written by
  one package's ``Checkpointer`` smoothed by the other;
- ``kafka_smooth.main`` in both packages over one ``run_synthetic``
  chain, and the port's ``x_sha256`` equal to its served smoothed
  answer.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch

from kafka_tpu.engine import Checkpointer as JaxCheckpointer
from kafka_tpu.smoother import ChainNode as JaxChainNode
from kafka_tpu.smoother import smooth_chain as jax_smooth_chain
from kafka_tpu.smoother import smooth_checkpoints as jax_smooth_checkpoints
from kafka_tpu.testing.oracle import rts_smoother_np
from kafka_tpu_torch import telemetry
from kafka_tpu_torch.core import (propagate_information_filter,
                                  propagate_information_filter_approx)
from kafka_tpu_torch.engine import Checkpointer
from kafka_tpu_torch.smoother import (QA_CLAMPED, QA_REDERIVED, QA_SMOOTHED,
                                      QA_TERMINAL, ChainNode, SmootherError,
                                      load_chain, smooth_chain,
                                      smooth_checkpoints, state_sha256)
from kafka_tpu_torch.smoother import rts_pass
from kafka_tpu_torch.telemetry import MetricsRegistry

X_RTOL, X_ATOL, DIAG_RTOL = 1e-3, 1e-4, 2e-3
#: every QA bit but the clamp's (which float32 roundoff decides).
UNCLAMPED = np.uint8(0xFF ^ QA_CLAMPED)


def day(i):
    return datetime.datetime(2017, 7, 1) + datetime.timedelta(days=i)


def _spd(rng, n_pix, p):
    a = rng.normal(size=(n_pix, p, p))
    return (np.einsum("nij,nkj->nik", a, a)
            + 3.0 * np.eye(p)).astype(np.float64)


def _simulate_linear_filter(t_total=5, n_pix=6, p=3, seed=7):
    """The JAX test's consistent identity-operator linear filter in
    float64 (tests/test_smoother.py:240)."""
    rng = np.random.default_rng(seed)
    q = np.array([1e-2, 5e-3, 2e-2])[:p]
    r_inv = 4.0
    x_a = rng.normal(size=(n_pix, p))
    p_a_inv = _spd(rng, n_pix, p)
    xs_a, ps_a_inv = [x_a], [p_a_inv]
    xs_f = [np.zeros((n_pix, p))]
    ps_f_inv = [np.stack([np.eye(p)] * n_pix)]
    for _ in range(t_total - 1):
        p_f_inv = np.linalg.inv(np.linalg.inv(p_a_inv) + np.diag(q))
        x_f = x_a.copy()
        y = x_f + rng.normal(size=(n_pix, p)) * 0.3
        p_a_inv = p_f_inv + r_inv * np.eye(p)
        rhs = np.einsum("nij,nj->ni", p_f_inv, x_f) + r_inv * y
        x_a = np.linalg.solve(p_a_inv, rhs[..., None])[..., 0]
        xs_a.append(x_a)
        ps_a_inv.append(p_a_inv)
        xs_f.append(x_f)
        ps_f_inv.append(p_f_inv)
    return tuple(np.stack(v).astype(np.float32)
                 for v in (xs_a, ps_a_inv, xs_f, ps_f_inv))


def _nodes(cls, chain):
    x_a, pa, x_f, pf = chain
    return [cls(day(1 + 4 * t), x_a[t], pa[t],
                sidecar=(x_f[t], pf[t]) if t else None)
            for t in range(len(x_a))]


@pytest.fixture(scope="module")
def chain_results():
    chain = _simulate_linear_filter(t_total=6, n_pix=64, p=3)
    port = smooth_chain(_nodes(ChainNode, chain), device="cpu")
    jax_res = jax_smooth_chain(_nodes(JaxChainNode, chain))
    return chain, port, jax_res


def test_sweep_matches_jax_and_the_float64_oracle(chain_results):
    chain, port, jax_res = chain_results
    x_a, pa, x_f, pf = (v.astype(np.float64) for v in chain)
    x_oracle, p_oracle = rts_smoother_np(x_a, pa, x_f, pf,
                                         np.eye(x_a.shape[-1]))
    diag_oracle = np.diagonal(np.linalg.inv(p_oracle), axis1=-2, axis2=-1)
    for res in (port, jax_res):
        np.testing.assert_allclose(res.x_smoothed, x_oracle, rtol=X_RTOL,
                                   atol=X_ATOL)
        np.testing.assert_allclose(res.p_inv_diag, diag_oracle,
                                   rtol=DIAG_RTOL)
    np.testing.assert_allclose(port.x_smoothed, jax_res.x_smoothed,
                               rtol=X_RTOL, atol=X_ATOL)
    np.testing.assert_allclose(port.p_inv_diag, jax_res.p_inv_diag,
                               rtol=DIAG_RTOL)
    err = np.abs(port.x_smoothed - jax_res.x_smoothed).max()
    print(f"port vs JAX smoothed x: max abs {err:.3g}")


def test_newest_date_is_the_analysis_and_sigma_never_larger(chain_results):
    chain, port, jax_res = chain_results
    assert port.x_smoothed[-1].tobytes() == chain[0][-1].tobytes()
    assert np.array_equal(port.p_inv_diag[-1],
                          np.diagonal(chain[1][-1], axis1=-2, axis2=-1))
    assert bool(np.all(port.p_inv_diag >= port.p_inv_diag_filter))
    for t in range(len(port.timesteps)):
        assert all(v <= 1.0 for v in port.sigma_shrink(t))
    assert port.timesteps == jax_res.timesteps
    assert np.array_equal(port.qa, jax_res.qa)
    assert bool(np.all(port.qa & QA_SMOOTHED))
    assert bool(np.all(port.qa[-1] & QA_TERMINAL))
    assert not np.any(port.qa[-1] & QA_CLAMPED)


def test_qa_bits_match_jax():
    """The QA bitmask of both packages on one chain: equal but for the
    clamp bit, which float32 roundoff decides on a pixel whose smoothed
    information sits at the filter's (the counts are printed)."""
    chain = list(_simulate_linear_filter(t_total=4, n_pix=256, p=3,
                                         seed=11))
    port = smooth_chain(_nodes(ChainNode, chain), device="cpu")
    jax_res = jax_smooth_chain(_nodes(JaxChainNode, chain))
    assert bool(np.all(port.p_inv_diag >= port.p_inv_diag_filter))
    same = (port.qa & UNCLAMPED) == (jax_res.qa & UNCLAMPED)
    assert bool(same.all())
    clamped = [int(np.count_nonzero(r.qa & QA_CLAMPED))
               for r in (port, jax_res)]
    print(f"clamped pixels port / JAX: {clamped}")


def _save_states(ck, timesteps, n_pix=6, p=2, seed=0, sidecar=False):
    rng = np.random.default_rng(seed)
    saved = {}
    for ts in timesteps:
        x = rng.normal(size=(n_pix, p)).astype(np.float32)
        p_inv = _spd(rng, n_pix, p).astype(np.float32)
        extra = {}
        if sidecar:
            extra = dict(
                x_forecast=rng.normal(size=(n_pix, p)).astype(np.float32),
                p_forecast_inverse=_spd(rng, n_pix, p).astype(np.float32),
            )
        ck.save(ts, x, p_inv, **extra)
        saved[ts] = (x, p_inv, extra or None)
        time.sleep(0.01)
    return saved


def test_load_chain_skips_a_corrupt_newest_set(tmp_path):
    ck = Checkpointer(str(tmp_path), n_shards=2)
    _save_states(ck, [day(1), day(5), day(9)], n_pix=8)
    with open(ck.list_checkpoints()[-1][1][0], "r+b") as f:
        f.truncate(40)
    with telemetry.use(MetricsRegistry()) as reg:
        nodes, skipped = load_chain(ck)
        assert reg.value("kafka_checkpoint_unreadable_total") == 1
    assert [n.timestep for n in nodes] == [day(1), day(5)]
    assert skipped == [day(9)]
    latest = ck.load_latest()
    assert latest is not None and latest[0] == day(5)
    np.testing.assert_array_equal(latest[1], nodes[-1].x_analysis)


def test_load_chain_skips_an_incomplete_middle_set(tmp_path):
    ck = Checkpointer(str(tmp_path), n_shards=2)
    saved = _save_states(ck, [day(1), day(5), day(9)], n_pix=8)
    os.remove(ck.list_checkpoints()[1][1][1])
    with telemetry.use(MetricsRegistry()) as reg:
        nodes, skipped = load_chain(ck)
        assert reg.value("kafka_checkpoint_unreadable_total") == 1
    assert [n.timestep for n in nodes] == [day(1), day(9)]
    assert skipped == [day(5)]
    np.testing.assert_array_equal(nodes[1].x_analysis, saved[day(9)][0])


@pytest.mark.parametrize("propagator", ["information", "approx"])
def test_rederived_forecast_path_matches_jax(tmp_path, propagator):
    """Sidecar-less sets: every pair re-derived through the propagator
    (counted, QA_REDERIVED), in both packages, within budget; no
    fallback configuration raises."""
    from kafka_tpu.core import propagators as jax_prop

    port_fn, jax_fn = {
        "information": (propagate_information_filter,
                        jax_prop.propagate_information_filter),
        "approx": (propagate_information_filter_approx,
                   jax_prop.propagate_information_filter_approx),
    }[propagator]
    ck = Checkpointer(str(tmp_path))
    _save_states(ck, [day(1), day(5), day(9)], n_pix=16, p=3)
    nodes, _ = load_chain(ck)
    with pytest.raises(SmootherError, match="no forecast sidecar"):
        smooth_chain(nodes, device="cpu")
    with telemetry.use(MetricsRegistry()) as reg:
        port = smooth_checkpoints(ck, q_diag=np.float32(1e-2),
                                  state_propagator=port_fn, device="cpu")
        assert reg.value("kafka_smoother_rederived_total") == 2
    jax_res = jax_smooth_checkpoints(JaxCheckpointer(str(tmp_path)),
                                     q_diag=np.float32(1e-2),
                                     state_propagator=jax_fn)
    assert port.rederived == jax_res.rederived == [day(5), day(9)]
    assert bool(np.all(port.qa[1] & QA_REDERIVED))
    assert np.array_equal(port.qa & UNCLAMPED, jax_res.qa & UNCLAMPED)
    np.testing.assert_allclose(port.x_smoothed, jax_res.x_smoothed,
                               rtol=X_RTOL, atol=X_ATOL)
    np.testing.assert_allclose(port.p_inv_diag, jax_res.p_inv_diag,
                               rtol=DIAG_RTOL)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_chain_written_by_one_package_smooths_in_the_other(tmp_path, writer):
    """Sidecar chains written by either package's Checkpointer, smoothed
    by both: the same nodes, the same result within budget."""
    cls = JaxCheckpointer if writer == "jax" else Checkpointer
    _save_states(cls(str(tmp_path), n_shards=2), [day(1), day(5), day(9)],
                 n_pix=10, p=3, sidecar=True)
    port = smooth_checkpoints(Checkpointer(str(tmp_path), n_shards=2),
                              device="cpu")
    jax_res = jax_smooth_checkpoints(JaxCheckpointer(str(tmp_path),
                                                     n_shards=2))
    assert port.rederived == jax_res.rederived == []
    assert port.timesteps == jax_res.timesteps
    assert port.x_smoothed[-1].tobytes() == jax_res.x_smoothed[-1].tobytes()
    np.testing.assert_allclose(port.x_smoothed, jax_res.x_smoothed,
                               rtol=X_RTOL, atol=X_ATOL)
    np.testing.assert_allclose(port.p_inv_diag, jax_res.p_inv_diag,
                               rtol=DIAG_RTOL)


def test_sweep_blocks_give_the_same_bits(monkeypatch):
    """The pixel-blocked sweep is the whole-batch sweep: the recursion is
    independent per pixel."""
    chain = _simulate_linear_filter(t_total=4, n_pix=40, p=3, seed=3)
    whole = smooth_chain(_nodes(ChainNode, chain), device="cpu")
    monkeypatch.setattr(rts_pass, "SWEEP_BLOCK", 7)
    blocked = smooth_chain(_nodes(ChainNode, chain), device="cpu")
    np.testing.assert_allclose(blocked.x_smoothed, whole.x_smoothed,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(blocked.p_inv_diag, whole.p_inv_diag,
                               rtol=1e-6)
    assert np.array_equal(blocked.qa & UNCLAMPED, whole.qa & UNCLAMPED)


def test_smooth_chain_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    chain = _simulate_linear_filter(t_total=3, n_pix=4, p=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smooth_chain(_nodes(ChainNode, chain))


# ---------------------------------------------------------------------------
# The offline driver
# ---------------------------------------------------------------------------

SMOOTH_RUN = ["--operator", "identity", "--ny", "24", "--nx", "28",
              "--checkpoint"]


@pytest.fixture(scope="module")
def synthetic_chain(tmp_path_factory):
    from kafka_tpu.cli.run_synthetic import main as jax_run

    out = tmp_path_factory.mktemp("chain")
    jax_run(SMOOTH_RUN + ["--outdir", str(out)])
    return out


def test_kafka_smooth_matches_jax(synthetic_chain, tmp_path):
    from kafka_tpu.cli.kafka_smooth import main as jax_smooth
    from kafka_tpu_torch.cli.kafka_smooth import main as port_smooth
    from kafka_tpu_torch.io import read_geotiff

    args = ["--ckpt-dir", str(synthetic_chain / "ckpt"), "--operator",
            "identity", "--ny", "24", "--nx", "28"]
    port = port_smooth(args + ["--outdir", str(tmp_path / "port"),
                               "--device", "cpu"])
    ref = jax_smooth(args + ["--outdir", str(tmp_path / "jax")])
    for key in ("windows", "n_pixels", "rederived", "skipped",
                "outputs_written"):
        assert port[key] == ref[key], key
    # x and sigma per parameter, and the QA band, per date.
    assert port["outputs_written"] == (2 * 2 + 1) * port["windows"]
    assert sorted(port["dates"]) == sorted(ref["dates"])
    newest = max(port["dates"])
    assert port["dates"][newest]["x_sha256"] == \
        ref["dates"][newest]["x_sha256"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        a = read_geotiff(str(tmp_path / "port" / name))[0]
        b = read_geotiff(str(tmp_path / "jax" / name))[0]
        if name.startswith("solver_qa"):
            assert np.array_equal(a & UNCLAMPED, b & UNCLAMPED), name
        elif name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=DIAG_RTOL, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=X_RTOL, atol=X_ATOL,
                                       err_msg=name)


def test_kafka_smooth_equals_the_served_smoothed_answer(tmp_path):
    """The port's offline reanalysis and its ``smoothed=true`` serve over
    one chain hash the same bytes (the JAX pin,
    tests/test_smoother.py:425)."""
    from kafka_tpu_torch.cli.kafka_smooth import main as port_smooth
    from kafka_tpu_torch.serve import (TileSession, make_synthetic_tile,
                                       synthetic_dates)
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE

    dates = synthetic_dates(DEFAULT_BASE_DATE, 16, 2)
    session = TileSession(make_synthetic_tile(
        "t0", str(tmp_path / "ck"), device="cpu"))
    assert session.serve(dates[4])["served_from"] == "cold"
    served = session.serve(dates[1], smoothed=True)
    assert served["served_from"] == "smoothed_chain"
    offline = port_smooth(["--ckpt-dir", str(tmp_path / "ck"), "--device",
                           "cpu"])
    assert offline["dates"][served["timestep"]]["x_sha256"] == \
        served["x_sha256"]
    assert served["quality"]["verdict"] == "CONSISTENT"


def test_state_sha256_hashes_every_row():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert state_sha256(x) != state_sha256(x[:5])
    assert state_sha256(x) == state_sha256(x.astype(np.float64))
