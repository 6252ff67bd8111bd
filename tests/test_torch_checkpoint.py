"""The port's Checkpointer and resume against the JAX package's: the same
files (members, names, dtypes) in both directions, load_latest, the
cadence and the forecast sidecar, resume equal to the uninterrupted run
(bit for bit in the port), and the re-padding of a state checkpointed
under another padding (where the port used to raise)."""

import zipfile

import numpy as np
import pytest
import torch

from kafka_tpu_torch.core.propagators import (PixelPrior,
                                              propagate_information_filter)
from kafka_tpu_torch.engine import FixedGaussianPrior, KalmanFilter
from kafka_tpu_torch.engine.checkpoint import (Checkpointer, pack_tril,
                                               unpack_tril)
from kafka_tpu_torch.obsops import IdentityOperator
from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                               SyntheticObservations)

from test_torch_fusion import day, jax_pipeline, torch_pipeline


def _state(n=40, p=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    w = rng.normal(size=(n, p, p)).astype(np.float32)
    p_inv = (np.einsum("npq,nrq->npr", w, w)
             + np.eye(p, dtype=np.float32)).astype(np.float32)
    # Symmetric to the bit, as the engine's information matrices are.
    p_inv = np.tril(p_inv) + np.swapaxes(np.tril(p_inv, -1), 1, 2)
    return x, p_inv


def _members(path):
    with zipfile.ZipFile(path) as zf:
        names = sorted(zf.namelist())
    data = np.load(path)
    return names, {k: (data[k].dtype, data[k].shape) for k in data.files}


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("sidecar", [False, True])
def test_files_match_jax_in_both_directions(tmp_path, n_shards, sidecar):
    from kafka_tpu.engine.checkpoint import Checkpointer as JaxCk

    x, p_inv = _state()
    xf, pf_inv = _state(seed=1)
    extra = dict(x_forecast=xf, p_forecast_inverse=pf_inv) if sidecar \
        else {}
    ts = day(3)
    t_paths = Checkpointer(str(tmp_path / "t"), n_shards=n_shards).save(
        ts, torch.as_tensor(x), torch.as_tensor(p_inv),
        **{k: torch.as_tensor(v) for k, v in extra.items()})
    j_paths = JaxCk(str(tmp_path / "j"), n_shards=n_shards).save(
        ts, x, p_inv, **extra)
    assert [p.split("/")[-1] for p in t_paths] == \
        [p.split("/")[-1] for p in j_paths]
    for tp_, jp_ in zip(t_paths, j_paths):
        assert _members(tp_) == _members(jp_)
        dt, dj = np.load(tp_), np.load(jp_)
        for key in dj.files:
            np.testing.assert_array_equal(dt[key], dj[key])
    # Each package reads the other's files.
    for reader, folder in ((Checkpointer, "j"), (JaxCk, "t")):
        ck = reader(str(tmp_path / folder))
        got_ts, got_x, got_p = ck.load_latest()
        assert got_ts == ts
        np.testing.assert_array_equal(got_x, x)
        np.testing.assert_array_equal(got_p, p_inv)
        if sidecar:
            paths = ck.list_checkpoints()[-1][1]
            _, _, side = ck._load_set(paths, with_sidecar=True)
            np.testing.assert_array_equal(side[0], xf)
            np.testing.assert_array_equal(side[1], pf_inv)


def test_pack_tril_matches_jax_and_device_packing():
    from kafka_tpu.engine.checkpoint import pack_tril as jax_pack

    _, p_inv = _state(n=5)
    np.testing.assert_array_equal(pack_tril(p_inv), jax_pack(p_inv))
    np.testing.assert_array_equal(unpack_tril(pack_tril(p_inv), 7), p_inv)
    from kafka_tpu_torch.engine.checkpoint import _host_tril

    np.testing.assert_array_equal(_host_tril(torch.as_tensor(p_inv)),
                                  pack_tril(p_inv))


def test_cadence_and_sidecar_match_jax(tmp_path):
    """Cadence 3 on the unfused pipeline: the same saved timesteps as the
    JAX engine's, the last window always saved, and the forecast sidecar
    only on adjacent saves, with the same arrays within the fusion
    budget."""
    from kafka_tpu.engine import Checkpointer as JaxCk

    saved = {}
    for name, ck_cls, every in (("t1", Checkpointer, 1),
                                ("t3", Checkpointer, 3)):
        ck = ck_cls(str(tmp_path / name))
        torch_pipeline(1, checkpointer=ck, checkpoint_every_n=every)
        saved[name] = ck
    jck = JaxCk(str(tmp_path / "j3"))
    jax_pipeline(1, checkpointer=jck, checkpoint_every_n=3)
    ts1 = [ts for ts, _ in saved["t1"].list_checkpoints()]
    ts3 = [ts for ts, _ in saved["t3"].list_checkpoints()]
    assert ts3 == [ts for ts, _ in jck.list_checkpoints()]
    assert len(ts1) > len(ts3) >= 1 and max(ts3) == max(ts1)
    for (ts, tp_), (_, jp_) in zip(saved["t3"].list_checkpoints(),
                                   jck.list_checkpoints()):
        t_set = saved["t3"]._load_set(tp_, with_sidecar=True)
        j_set = jck._load_set(jp_, with_sidecar=True)
        assert (t_set[2] is None) == (j_set[2] is None), ts
        np.testing.assert_allclose(t_set[0], j_set[0], atol=2e-3)
    # Every-window saves all carry the sidecar (each is adjacent).
    sides = [saved["t1"]._load_set(p, with_sidecar=True)[2]
             for _, p in saved["t1"].list_checkpoints()]
    assert all(s is not None for s in sides[1:])


@pytest.mark.parametrize("scan_window", [1, 4])
def test_resume_equals_uninterrupted_run_bit_for_bit(tmp_path, scan_window):
    """Checkpoint the first windows, resume on a fresh filter with
    resume_time_grid + advance_first: the final state is the
    uninterrupted run's, to the bit (float32 x and packed P^-1 are stored
    exactly)."""
    kf_full, _, x_full, p_full = torch_pipeline(scan_window)
    head = Checkpointer(str(tmp_path / "ck"))
    torch_pipeline(scan_window, n_days=4, checkpointer=head)
    ck = Checkpointer(str(tmp_path / "ck"))
    grid = [day(i) for i in range(0, 10)]
    rest, seed = ck.resume_time_grid(grid)
    assert seed is not None and rest[0] == day(4) and len(rest) == 6
    kf = _resume_filter(scan_window)
    x_r, _, p_r = kf.run(rest, seed[0], None, seed[1], advance_first=True)
    assert torch.equal(x_r, x_full)
    assert torch.equal(p_r, p_full)


def _resume_filter(scan_window):
    """A fresh filter of torch_pipeline's configuration over its dates."""
    from kafka_tpu_torch.engine import TIP_PARAMETER_LIST
    from kafka_tpu_torch.obsops import TwoStreamOperator

    from test_torch_fusion import pivot_mask, tip_truth

    mask = pivot_mask()
    truth = tip_truth(mask)
    obs = SyntheticObservations(
        dates=[day(i) for i in range(1, 9)], operator=TwoStreamOperator(),
        truth_fn=lambda date: truth, sigma=0.03, mask_prob=0.1,
        device="cpu")
    kf = KalmanFilter(obs, MemoryOutput(), mask, TIP_PARAMETER_LIST,
                      state_propagation=propagate_information_filter,
                      pad_multiple=128, scan_window=scan_window,
                      solver_options={"relaxation": 0.7}, device="cpu")
    kf.set_trajectory_uncertainty(np.full(7, 1e-3, np.float32))
    return kf


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_across_packages(tmp_path, writer):
    """A checkpoint written by one package seeds a resumed run in the
    other.  On the linear identity problem (no float32 chaos) the resumed
    run reproduces the writer's uninterrupted run to 1e-6, the JAX resume
    test's tolerance."""
    from kafka_tpu.engine import Checkpointer as JaxCk

    reader = "torch" if writer == "jax" else "jax"
    ck_cls = {"jax": JaxCk, "torch": Checkpointer}
    grid = [day(i) for i in range(0, 9, 2)]
    kf_full, _, prior = _identity_filter(writer, n_dates=8)
    x0, p_inv0 = prior.process_prior(None, kf_full.gather)
    x_full, _, p_full = kf_full.run(grid, x0, None, p_inv0)
    kf_head, _, _ = _identity_filter(writer, n_dates=3)
    kf_head.run(grid[:3], x0, None, p_inv0,
                checkpointer=ck_cls[writer](str(tmp_path)))
    rest, seed = ck_cls[reader](str(tmp_path)).resume_time_grid(grid)
    assert rest == grid[2:]
    kf_r, _, _ = _identity_filter(reader, n_dates=8)
    x_r, _, p_r = kf_r.run(rest, seed[0], None, seed[1], advance_first=True)
    np.testing.assert_allclose(np.asarray(x_r), np.asarray(x_full),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(p_r), np.asarray(p_full),
                               rtol=1e-5, atol=1e-6)


# --- re-padding a state of another padding (filter._repad) -------------

def _circle(ny=10, nx=10, r=4):
    yy, xx = np.mgrid[:ny, :nx]
    return (yy - ny // 2) ** 2 + (xx - nx // 2) ** 2 < r * r


def _identity_filter(pkg, n_dates=2):
    """TestRepadOnResume's identity filter (tests/test_engine.py) over
    ``n_dates`` daily acquisitions, in the port (``pkg="torch"``) or the
    JAX package."""
    mask = _circle()
    truth = np.full(mask.shape + (2,), 0.6, np.float32)
    dates = [day(i) for i in range(1, n_dates + 1)]
    if pkg == "torch":
        op = IdentityOperator(n_params=2, obs_indices=(0, 1))
        obs = SyntheticObservations(dates, op,
                                    lambda date: truth, sigma=0.02,
                                    mask_prob=0.0, device="cpu")
        out = MemoryOutput()
        kf = KalmanFilter(obs, out, mask, ("a", "b"),
                          state_propagation=propagate_information_filter,
                          pad_multiple=128, device="cpu")
        cov = np.diag(np.full(2, 0.09)).astype(np.float32)
        prior = FixedGaussianPrior(PixelPrior(
            mean=torch.full((2,), 0.5), cov=torch.as_tensor(cov),
            inv_cov=torch.as_tensor(np.linalg.inv(cov))), ("a", "b"))
    else:
        import jax.numpy as jnp

        from kafka_tpu.core.propagators import PixelPrior as JaxPixelPrior
        from kafka_tpu.core.propagators import \
            propagate_information_filter as jax_prop
        from kafka_tpu.engine import FixedGaussianPrior as JaxPrior
        from kafka_tpu.engine import KalmanFilter as JaxFilter
        from kafka_tpu.obsops import IdentityOperator as JaxIdentity
        from kafka_tpu.testing import MemoryOutput as JaxMemory
        from kafka_tpu.testing import SyntheticObservations as JaxObs

        op = JaxIdentity(n_params=2, obs_indices=(0, 1))
        obs = JaxObs(dates=dates, operator=op,
                     truth_fn=lambda date: truth, sigma=0.02, mask_prob=0.0)
        out = JaxMemory()
        kf = JaxFilter(obs, out, mask, ("a", "b"),
                       state_propagation=jax_prop, pad_multiple=128)
        cov = np.diag(np.full(2, 0.09)).astype(np.float32)
        prior = JaxPrior(JaxPixelPrior(
            mean=jnp.full((2,), 0.5), cov=jnp.asarray(cov),
            inv_cov=jnp.asarray(np.linalg.inv(cov))), ("a", "b"))
    kf.set_trajectory_uncertainty(np.zeros(2))
    return kf, out, prior


def test_run_repads_foreign_padding_like_jax():
    """A state under a foreign 64-row padding: the JAX engine re-pads it
    (``_repad``), where the port used to raise ValueError; the port now
    re-pads too, and both give the state of the run at this padding."""
    grid = [day(0), day(3)]
    results = {}
    for pkg in ("jax", "torch"):
        kf_ref, out_ref, prior = _identity_filter(pkg)
        x0, p_inv0 = prior.process_prior(None, kf_ref.gather)
        assert kf_ref.gather.n_pad == 128
        kf_ref.run(grid, x0, None, p_inv0)
        kf_f, out_f, _ = _identity_filter(pkg)
        assert kf_f.gather.n_valid <= 64
        kf_f.run(grid, np.asarray(x0)[:64], None, np.asarray(p_inv0)[:64])
        for key in out_ref.output[day(3)]:
            np.testing.assert_allclose(np.asarray(out_f.output[day(3)][key]),
                                       np.asarray(out_ref.output[day(3)][key]),
                                       atol=1e-6)
        results[pkg] = out_f.output[day(3)]
    for key, raster in results["jax"].items():
        np.testing.assert_allclose(results["torch"][key], np.asarray(raster),
                                   atol=1e-6)


@pytest.mark.parametrize("rows,match", [(10, "valid pixels"),
                                        (100, "one row per raster cell")])
def test_repad_guards_raise_like_jax(rows, match):
    """Both ValueError guards of _repad: a state with fewer rows than the
    mask's valid pixels, and one row per raster cell (not PixelGather
    layout)."""
    for pkg in ("jax", "torch"):
        kf, _, _ = _identity_filter(pkg)
        x = np.zeros((rows, 2), np.float32)
        with pytest.raises(ValueError, match=match):
            kf.run([day(0), day(3)], x, None, None)
