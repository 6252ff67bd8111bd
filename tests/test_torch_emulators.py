"""The port's emulators — the GP bank, the reference's GP pickles and the
MLP surrogate — against the JAX package's, and the port's own fits held
to the JAX package's accuracy thresholds.

- GP bank and MLP: the JAX fit's weights go through ``convert`` into the
  port, and both packages' ``forward`` and ``linearize`` run on the same
  states; held to atol 1e-5 (values) and 1e-4 (Jacobians): float32
  exp/tanh and matvec sums of two libraries.
- ``gp_import``: synthetic ``gp_emulator`` pickles (the classes stubbed,
  as ``tests/test_gp_import.py`` builds them) through the port's loader,
  against the emulator's own predictive-mean formula, to that test's
  tolerances (rtol/atol 2e-4; 1e-3 where alpha is recomputed; 2e-3 for
  a stacked bank).
- ``fit_gp`` / ``fit_mlp`` of the port (Adam in PyTorch, not optax, so
  not the JAX fit's bits) meet the thresholds of
  ``tests/test_obsops.py``: a smooth function within 0.05, the GP's
  gradient within 1e-2 of finite differences, a two-stream GP bank
  within 0.02 and a WCM MLP within 0.01.  ``fit_gp`` without Adam
  matches the JAX package's; its written-out Adam gives
  ``torch.optim.Adam``'s bits; a batch of GPs fitted at once gives each
  entry's own fit (hyperparameters to float32 rounding, predictive
  means within 1e-4: alpha carries the Gram matrix's conditioning).
- ``protocol``'s ``BandView`` and ``MappedStateModel`` against JAX's, to
  the same value / Jacobian tolerances.
"""

import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kafka_tpu.obsops import gp as jgp
from kafka_tpu.obsops import mlp as jmlp
from kafka_tpu_torch import convert
from kafka_tpu_torch.obsops import gp as tgp
from kafka_tpu_torch.obsops import gp_import as tgi
from kafka_tpu_torch.obsops import mlp as tmlp

VAL_ATOL, JAC_ATOL = 1e-5, 1e-4
CPU = "cpu"


def _states(n=32, p=7, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.15, 0.85, (n, p)).astype(np.float32)


@pytest.mark.parametrize("mapped", [False, True])
def test_gp_bank_matches_jax(mapped):
    rng = np.random.default_rng(1)
    k = 4 if mapped else 7
    xs = rng.uniform(0.1, 0.9, (120, k)).astype(np.float32)
    banks = [jgp.fit_gp(xs, np.sin(xs @ rng.normal(size=k)))
             for _ in range(2)]
    jbank = jgp.stack_gp_bank(banks)
    mappers = np.array([[0, 1, 6, 2], [3, 4, 6, 5]]) if mapped else None
    jop = jgp.GPBankOperator(n_params=7, n_bands=2, state_mappers=mappers)
    top = tgp.GPBankOperator(n_params=7, n_bands=2, state_mappers=mappers)
    tbank = convert.gp_params(jbank, CPU)
    x = _states()
    jl = jop.linearize(jbank, jnp.asarray(x))
    tl = top.linearize(tbank, torch.as_tensor(x))
    assert tl.jac.dtype == torch.float32 and tl.jac.shape == (2, 32, 7)
    np.testing.assert_allclose(top.forward(tbank, torch.as_tensor(x)),
                               np.asarray(jop.forward(jbank, jnp.asarray(x))),
                               atol=VAL_ATOL)
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0),
                               atol=VAL_ATOL)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               atol=JAC_ATOL)


def test_gp_bank_band_mismatch_raises():
    z = torch.zeros
    bank = tgp.GPParams(x_train=z((3, 6, 4)), alpha=z((3, 6)),
                        log_lengthscales=z((3, 4)), log_amplitude=z((3,)),
                        y_mean=z((3,)))
    with pytest.raises(ValueError, match="3 band"):
        tgp.GPBankOperator(n_params=4, n_bands=10).forward_pixel(
            bank, torch.zeros(4))


def test_gp_save_load_reads_either_package(tmp_path):
    rng = np.random.default_rng(2)
    xs = rng.uniform(size=(40, 3)).astype(np.float32)
    jparams = jgp.fit_gp(xs, xs.sum(1))
    jgp.save_gp(str(tmp_path / "j.npz"), jparams)
    tparams = tgp.load_gp(str(tmp_path / "j.npz"), CPU)
    tgp.save_gp(str(tmp_path / "t.npz"), tparams)
    back = jgp.load_gp(str(tmp_path / "t.npz"))
    for f in tgp.GPParams._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      np.asarray(getattr(jparams, f)))


@pytest.mark.parametrize("mapper", [None, [6, 1]])
def test_mlp_matches_jax(mapper):
    rng = np.random.default_rng(3)
    xs = rng.uniform(0.1, 0.9, (200, 2 if mapper else 7)).astype(np.float32)
    jparams, _ = jmlp.fit_mlp(lambda a: np.stack([a.sum(1), a[:, 0] ** 2],
                                                 1), xs, hidden=(16, 16),
                              steps=20)
    jop = jmlp.MLPOperator(n_params=7, n_bands=2, state_mapper=mapper)
    top = tmlp.MLPOperator(n_params=7, n_bands=2, state_mapper=mapper)
    tparams = convert.mlp_params(jparams, CPU)
    x = _states(seed=4)
    jl = jop.linearize(jparams, jnp.asarray(x))
    tl = top.linearize(tparams, torch.as_tensor(x))
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0),
                               atol=VAL_ATOL)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               atol=JAC_ATOL)
    np.testing.assert_allclose(
        tmlp.mlp_apply(tparams, torch.as_tensor(x[:, :2] if mapper else x)),
        np.asarray(jmlp.mlp_apply(jparams,
                                  jnp.asarray(x[:, :2] if mapper else x))),
        atol=VAL_ATOL)


# --- the port's own fits, held to the JAX package's thresholds -------------

def test_fit_gp_predicts_a_smooth_function():
    rng = np.random.default_rng(17)
    x = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    y = np.sin(2 * x[:, 0]) + x[:, 1] ** 2 + 0.5 * x[:, 2]
    params = tgp.fit_gp(x, y, device=CPU)
    xt = rng.uniform(-0.8, 0.8, size=(50, 3)).astype(np.float32)
    yt = np.sin(2 * xt[:, 0]) + xt[:, 1] ** 2 + 0.5 * xt[:, 2]
    pred = torch.cat([tgp.gp_predict_pixel(params, torch.as_tensor(z))
                      for z in xt])
    np.testing.assert_allclose(pred.numpy(), yt, atol=0.05)


def test_fit_gp_gradient_matches_finite_differences():
    rng = np.random.default_rng(18)
    x = rng.uniform(-1, 1, size=(300, 2)).astype(np.float32)
    params = tgp.fit_gp(x, np.tanh(x[:, 0]) * x[:, 1], device=CPU)
    x0 = torch.tensor([0.2, -0.4])
    g = torch.func.jacfwd(lambda z: tgp.gp_predict_pixel(params, z))(x0)[0]
    eps = 1e-3
    for i in range(2):
        step = torch.zeros(2)
        step[i] = eps
        fd = (tgp.gp_predict_pixel(params, x0 + step)
              - tgp.gp_predict_pixel(params, x0 - step)) / (2 * eps)
        np.testing.assert_allclose(float(g[i]), float(fd), atol=1e-2)


def test_fit_gp_optimize_runs_adam():
    rng = np.random.default_rng(19)
    x = rng.uniform(-1, 1, size=(80, 2)).astype(np.float32)
    params = tgp.fit_gp(x, np.sin(3 * x[:, 0]), optimize=True, steps=30,
                        device=CPU)
    assert all(torch.isfinite(getattr(params, f)).all()
               for f in tgp.GPParams._fields)
    fixed = tgp.fit_gp(x, np.sin(3 * x[:, 0]), device=CPU)
    assert not torch.equal(params.log_lengthscales,
                           fixed.log_lengthscales)


@pytest.fixture
def one_thread():
    """One intra-op thread: beside other test processes on the same
    cores, the fits' small threaded ops wait on each other's threads
    (the batched fit took 17 s in a whole run, 0.2 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fit_samples(seed=23, batch=3, m=40, k=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, m, k)).astype(np.float32)
    y = np.sin(x @ rng.normal(size=k)) \
        + 0.3 * (x ** 2).sum(-1) * np.arange(1, batch + 1)[:, None]
    return x, y.astype(np.float32), rng.uniform(0, 1, (50, k)) \
        .astype(np.float32)


def _gp_means(params, xs):
    return torch.cat([tgp.gp_predict_pixel(params, torch.as_tensor(z))
                      for z in xs])


@pytest.mark.usefixtures("one_thread")
def test_fit_gp_batched_equals_each_entry_fitted_alone():
    x, y, xs = _fit_samples()
    amp = y.var(-1)
    batched = tgp.fit_gp(x, y, amplitude=amp, optimize=True, steps=30,
                         device=CPU)
    assert batched.alpha.shape == (3, 40)
    assert batched.log_lengthscales.shape == (3, 3)
    assert batched.log_amplitude.shape == batched.y_mean.shape == (3,)
    for i in range(3):
        alone = tgp.fit_gp(x[i], y[i], amplitude=amp[i], optimize=True,
                           steps=30, device=CPU)
        entry = tgp.GPParams(*(leaf[i] for leaf in batched))
        for f in ("x_train", "log_lengthscales", "log_amplitude",
                  "y_mean"):
            np.testing.assert_allclose(getattr(entry, f).numpy(),
                                       getattr(alone, f).numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(_gp_means(entry, xs).numpy(),
                                   _gp_means(alone, xs).numpy(), atol=1e-4)


@pytest.mark.usefixtures("one_thread")
def test_fit_gp_adam_is_torch_optim_adam():
    """The fit's written-out Adam against ``torch.optim.Adam`` driving
    the same negative log marginal likelihood: the same bits."""
    x, y, _ = _fit_samples(seed=24)
    x, y = x[0], y[0]
    amp, noise, steps = float(y.var()), 1e-4, 30
    fit = tgp.fit_gp(x, y, amplitude=amp, noise=noise, optimize=True,
                     steps=steps, device=CPU)
    xt = torch.as_tensor(x)
    yt = torch.as_tensor(y - y.mean())
    params = [torch.log(torch.as_tensor(x.std(0) + 1e-3)),
              torch.log(torch.tensor(amp, dtype=torch.float32)),
              torch.log(torch.tensor(noise, dtype=torch.float32))]
    for q in params:
        q.requires_grad_()
    opt = torch.optim.Adam(params, lr=1e-2)
    eye = torch.eye(x.shape[0])
    for _ in range(steps):
        opt.zero_grad()
        k = tgp._gram(xt, params[0], params[1]) \
            + (noise + torch.exp(params[2])) * eye
        chol = torch.linalg.cholesky(k)
        w = torch.cholesky_solve(yt[:, None], chol)[:, 0]
        nll = 0.5 * yt @ w + torch.sum(torch.log(torch.diagonal(chol)))
        nll.backward()
        opt.step()
    assert torch.equal(fit.log_lengthscales, params[0].detach())
    assert torch.equal(fit.log_amplitude, params[1].detach())


@pytest.mark.usefixtures("one_thread")
def test_fit_gp_without_adam_matches_jax():
    x, y, xs = _fit_samples(seed=25)
    x, y = x[0], y[0]
    amp = float(y.var())
    jfit = jgp.fit_gp(x, y, amplitude=amp)
    fit = tgp.fit_gp(x, y, amplitude=amp, device=CPU)
    for f in ("x_train", "log_lengthscales", "log_amplitude", "y_mean"):
        np.testing.assert_allclose(getattr(fit, f).numpy(),
                                   np.asarray(getattr(jfit, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    jmean = np.array([np.asarray(jgp.gp_predict_pixel(
        jfit, jnp.asarray(z))).reshape(-1)[0] for z in xs])
    np.testing.assert_allclose(_gp_means(fit, xs).numpy(), jmean,
                               atol=VAL_ATOL)


def test_gp_bank_emulates_twostream():
    from kafka_tpu_torch.core.propagators import broadcast_prior, tip_prior
    from kafka_tpu_torch.obsops import (NIR_MAPPER, VIS_MAPPER,
                                        TwoStreamOperator, tlai_to_lai,
                                        twostream_albedo)

    rng = np.random.default_rng(20)
    n = 500
    sub = np.stack([rng.uniform(0.1, 0.9, n), rng.uniform(0.5, 2.0, n),
                    rng.uniform(0.15, 0.9, n), rng.uniform(0.05, 0.5, n)],
                   axis=1).astype(np.float32)
    s = torch.as_tensor(sub)
    alb = twostream_albedo(s[:, 0], s[:, 1], s[:, 3],
                           tlai_to_lai(s[:, 2])).numpy()
    band = tgp.fit_gp(sub, alb, noise=1e-6, device=CPU)
    bank = tgp.stack_gp_bank([band, band])
    op = tgp.GPBankOperator(n_params=7, n_bands=2,
                            state_mappers=np.stack([VIS_MAPPER, NIR_MAPPER]))
    x, _ = broadcast_prior(tip_prior(CPU), 5)
    np.testing.assert_allclose(
        op.forward(bank, x).numpy(),
        TwoStreamOperator().forward(None, x).numpy(), atol=0.02)


def test_fit_mlp_emulates_wcm():
    from kafka_tpu_torch.obsops.wcm import (WCM_PARAMETERS, WCMAux,
                                            WCMOperator, wcm_sigma0)

    def forward(x):
        t = torch.as_tensor(x)
        return np.stack([wcm_sigma0(t[:, 0], t[:, 1], torch.tensor(23.0),
                                    WCM_PARAMETERS[p]).numpy()
                         for p in ("VV", "VH")], axis=1)

    rng = np.random.default_rng(21)
    x = np.stack([rng.uniform(0.2, 4.0, 2000), rng.uniform(0.05, 0.5, 2000)],
                 axis=1).astype(np.float32)
    params, loss = tmlp.fit_mlp(forward, x, steps=1500, device=CPU)
    assert np.isfinite(loss)
    xt = torch.tensor([[1.5, 0.2], [3.0, 0.4]])
    pred = tmlp.MLPOperator(n_params=2, n_bands=2).forward(params, xt)
    truth = WCMOperator().forward(WCMAux(theta_deg=torch.full((2,), 23.0)),
                                  xt)
    np.testing.assert_allclose(pred.numpy(), truth.numpy(), atol=0.01)


# --- gp_import on synthetic pickles ----------------------------------------

def _fake_module():
    """One fake ``gp_emulator`` module for the file: pickling by reference
    needs every instance's class registered under it at dump time."""
    if not hasattr(_fake_module, "mod"):
        mod = types.ModuleType("gp_emulator")

        class GaussianProcess:
            pass

        GaussianProcess.__module__ = "gp_emulator"
        GaussianProcess.__qualname__ = "GaussianProcess"
        mod.GaussianProcess = GaussianProcess
        _fake_module.mod = mod
    return _fake_module.mod


def _fake_gp(m=40, d=4, seed=0, with_invqt=True):
    rng = np.random.default_rng(seed)
    inputs = rng.uniform(0.0, 1.0, (m, d))
    targets = np.sin(inputs.sum(axis=1)) + 0.05 * rng.standard_normal(m)
    theta = np.concatenate([np.log(rng.uniform(2.0, 20.0, d)),
                            [np.log(1.3)], [np.log(1e-4)]])
    z = inputs * np.sqrt(np.exp(theta[:d]))
    d2 = (z * z).sum(1)[:, None] + (z * z).sum(1)[None, :] - 2 * z @ z.T
    k = np.exp(theta[d]) * np.exp(-0.5 * np.maximum(d2, 0.0))
    k[np.diag_indices_from(k)] += np.exp(theta[d + 1])
    inv_qt = np.linalg.solve(k, targets)
    gp = _fake_module().GaussianProcess()
    gp.inputs, gp.targets, gp.theta = inputs, targets, theta
    if with_invqt:
        gp.invQt = inv_qt
    return gp, (inputs, inv_qt, theta)


def _reference_predict(inputs, inv_qt, theta, x_star):
    """The gp_emulator predictive mean: a @ invQt with a_j = e^{theta[D]}
    exp(-0.5 sum_d e^{theta[d]} (x*_d - X_jd)^2)."""
    d = inputs.shape[1]
    diff = inputs - x_star
    a = np.exp(theta[d]) * np.exp(
        -0.5 * (np.exp(theta[:d]) * diff**2).sum(axis=1))
    return float(a @ inv_qt)


def _dump(obj, path):
    sys.modules["gp_emulator"] = _fake_module()
    try:
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    finally:
        del sys.modules["gp_emulator"]


def _predict(params, x_star):
    return float(tgp.gp_predict_pixel(params, torch.as_tensor(x_star))[0])


@pytest.mark.parametrize("with_invqt,tol", [(True, 2e-4), (False, 1e-3)])
def test_pickle_predicts_the_emulators_mean(tmp_path, with_invqt, tol):
    gp, ref = _fake_gp(with_invqt=with_invqt)
    _dump(gp, tmp_path / "emu.pkl")
    params = tgi.gp_params_from_emulator(
        tgi.load_emulator_pickle(str(tmp_path / "emu.pkl")), CPU)
    assert "gp_emulator" not in sys.modules
    rng = np.random.default_rng(5)
    for _ in range(5):
        x_star = rng.uniform(0.0, 1.0, 4).astype(np.float32)
        np.testing.assert_allclose(_predict(params, x_star),
                                   _reference_predict(*ref, x_star),
                                   rtol=tol, atol=tol)


def test_band_dict_to_bank_operator(tmp_path):
    bands = tgi.EMULATOR_BAND_MAP
    raw, refs = {}, {}
    for i, num in enumerate(bands):
        gp, refs[num] = _fake_gp(m=30 + 3 * i, seed=num)
        raw[b"S2A_MSI_%02d" % num] = gp
    _dump(raw, tmp_path / "prosail_5_30_90.pkl")
    bank = tgi.load_emulator_bank_file(str(tmp_path / "prosail_5_30_90.pkl"),
                                       device=CPU)
    assert tuple(bank.x_train.shape[:2]) == (len(bands), 30 + 3 * 9)
    op = tgp.GPBankOperator(n_params=4, n_bands=len(bands))
    x_star = np.random.default_rng(6).uniform(0.2, 0.8, 4).astype(np.float32)
    got = op.forward_pixel(bank, torch.as_tensor(x_star)).numpy()
    want = [_reference_predict(*refs[num], x_star) for num in bands]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    _dump({b"S2A_MSI_02": raw[b"S2A_MSI_02"]}, tmp_path / "emu_5_30_90.pkl")
    with pytest.raises(KeyError, match="band"):
        tgi.load_emulator_bank_file(str(tmp_path / "emu_5_30_90.pkl"),
                                    device=CPU)


def test_port_bank_equals_jax_bank(tmp_path):
    from kafka_tpu.obsops import gp_import as jgi

    raw = {b"S2A_MSI_%02d" % n: _fake_gp(m=20 + n, seed=n)[0]
           for n in (2, 3)}
    _dump(raw, tmp_path / "b_0_20_50.pkl")
    path = str(tmp_path / "b_0_20_50.pkl")
    tb = tgi.load_emulator_bank_file(path, band_numbers=(2, 3), device=CPU)
    jb = jgi.load_emulator_bank_file(path, band_numbers=(2, 3))
    for f in tgp.GPParams._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))


def test_geometry_and_directory_banks(tmp_path):
    assert tgi.geometry_from_filename("/x/prosail_S2A_10_30_120.pkl") == \
        (30.0, 10.0, 120.0)
    with pytest.raises(ValueError):
        tgi.geometry_from_filename("/x/no_geometry_here.pkl")
    for vza, sza, raa in ((0, 20, 50), (10, 40, 120)):
        _dump({b"S2A_MSI_%02d" % n: _fake_gp(m=20, seed=n)[0]
               for n in (2, 3)}, tmp_path / f"prosail_{vza}_{sza}_{raa}.pkl")
    banks = tgi.load_emulator_directory(str(tmp_path), band_numbers=(2, 3),
                                        device=CPU)
    assert set(banks) == {(20.0, 0.0, 50.0), (40.0, 10.0, 120.0)}
    assert all(b.x_train.shape[0] == 2 for b in banks.values())
    with pytest.raises(IOError):
        tgi.load_emulator_directory(str(tmp_path / "empty"), device=CPU)


def test_npz_bank_wins_over_pickle(tmp_path):
    _dump({b"S2A_MSI_02": _fake_gp(m=12)[0]}, tmp_path / "bank_5_30_90.pkl")
    marker = tgp.GPParams(
        x_train=torch.zeros((1, 7, 4)), alpha=torch.ones((1, 7)),
        log_lengthscales=torch.zeros((1, 4)),
        log_amplitude=torch.zeros((1,)), y_mean=torch.full((1,), 42.0))
    tgi.save_bank_npz(str(tmp_path / "bank_5_30_90.npz"), marker)
    banks = tgi.load_emulator_directory(str(tmp_path), band_numbers=(2,),
                                        device=CPU)
    assert float(banks[(30.0, 5.0, 90.0)].y_mean[0]) == 42.0
    back = tgi.load_bank_npz(str(tmp_path / "bank_5_30_90.npz"), CPU)
    assert torch.equal(back.alpha, marker.alpha)


def test_loaders_default_to_cuda(tmp_path, monkeypatch):
    _dump(_fake_gp(m=8)[0], tmp_path / "one.pkl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgi.load_emulator_bank_file(str(tmp_path / "one.pkl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.fit_mlp(lambda a: a, np.zeros((4, 2), np.float32), steps=1)


def test_jax_grad_agrees_on_a_converted_gp():
    """The GP's gradient through convert equals JAX's autodiff one."""
    rng = np.random.default_rng(7)
    xs = rng.uniform(size=(50, 3)).astype(np.float32)
    jp = jgp.fit_gp(xs, np.cos(xs.sum(1)))
    x0 = np.array([0.3, 0.6, 0.2], np.float32)
    jg = np.asarray(jax.grad(lambda z: jgp.gp_predict_pixel(jp, z))(
        jnp.asarray(x0)))
    tp = convert.gp_params(jp, CPU)
    tg = torch.func.jacfwd(lambda z: tgp.gp_predict_pixel(tp, z))(
        torch.as_tensor(x0))[0]
    np.testing.assert_allclose(tg.numpy(), jg, atol=JAC_ATOL)


# --- protocol wrappers ------------------------------------------------------

@pytest.mark.parametrize("band", [0, 7])
def test_band_view_matches_jax(band):
    """A one-band view of PROSAIL: the same value and Jacobian row as
    JAX's ``BandView``, and the inner operator's bounds and aux axes."""
    from kafka_tpu.obsops.prosail import ProsailAux as JAux
    from kafka_tpu.obsops.prosail import ProsailOperator as JProsail
    from kafka_tpu.obsops.protocol import BandView as JBandView
    from kafka_tpu_torch.engine.priors import sail_prior_arrays
    from kafka_tpu_torch.obsops import BandView, ProsailOperator

    rng = np.random.default_rng(8)
    x = np.clip(sail_prior_arrays()[0] + rng.normal(0, 0.03, (16, 10)),
                0.02, 0.98).astype(np.float32)
    theta = rng.uniform(20, 40, 16).astype(np.float32)
    jaux = JAux(sza=jnp.asarray(theta), vza=jnp.asarray(5.0),
                raa=jnp.asarray(40.0))
    taux = convert.prosail_aux(jaux, CPU)
    jv, tv = JBandView(JProsail(), band), BandView(ProsailOperator(), band)
    assert tv.n_bands == 1 and tv.state_bounds is ProsailOperator.state_bounds
    jl = jv.linearize(jaux, jnp.asarray(x))
    tl = tv.linearize(taux, torch.as_tensor(x))
    assert tl.jac.shape == (1, 16, 10)
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0),
                               atol=VAL_ATOL)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               atol=JAC_ATOL)


def test_mapped_state_model_matches_jax_and_twostream():
    """The two-stream bands through ``MappedStateModel`` with the TIP
    mappers: JAX's wrapper's value and Jacobian, and the port's own
    ``TwoStreamOperator`` exactly (the same closed form per band)."""
    from kafka_tpu.obsops import TwoStreamOperator as JTwoStream
    from kafka_tpu.obsops.protocol import MappedStateModel as JMapped
    from kafka_tpu_torch.obsops import (NIR_MAPPER, VIS_MAPPER,
                                        MappedStateModel, TwoStreamOperator)

    mappers = np.stack([VIS_MAPPER, NIR_MAPPER])
    x = _states(n=24, seed=9)
    jm = JMapped(JTwoStream(), mappers, 7)
    tm = MappedStateModel(TwoStreamOperator(), mappers, 7)
    assert (tm.n_bands, tm.n_params) == (2, 7)
    jl = jm.linearize(None, jnp.asarray(x))
    tl = tm.linearize(None, torch.as_tensor(x))
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0),
                               atol=VAL_ATOL)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               atol=JAC_ATOL)
    direct = TwoStreamOperator().linearize(None, torch.as_tensor(x))
    assert torch.equal(tl.h0, direct.h0) and torch.equal(tl.jac, direct.jac)
