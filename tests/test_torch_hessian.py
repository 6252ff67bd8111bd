"""The second-order (Hessian) correction of the port against the JAX
package: ``hessian_correction`` (``torch.func`` forward over reverse
against ``jax.hessian``) on the JAX solver test's quadratic
(tests/test_solvers.py:228-310) and on the two-stream forward, at
interior states and at states on the TIP bounds (the ``max(d, 0.1)``
tie and omega's upper bound); the eigenvalue floor on a planted
off-cone pixel; and the engine with ``hessian_correction=True`` (the
tests/test_engine.py:225-260 analogue) against the JAX engine.

Budgets: the quadratic's constant Hessian to float32 rounding (rtol
2e-4 / atol 2e-4, the JAX test's oracle budget); the two-stream second
derivatives to rtol 1e-3 of the largest entry per pixel (two libraries'
float32 chains through ``sqrt``/``exp``), but on omega's bound, where
both packages lose digits alike and the port is held to a float64
evaluation by the smoke's 1.25x rule;
the engine's rasters within atol 2e-3 (the engine budget); healthy
pixels' A bit for bit equal to ``A - C``.
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core import hessian as jhessian
from kafka_tpu.core import solvers as jsolvers
from kafka_tpu.core.types import BandBatch as JBandBatch
from kafka_tpu.core.types import Linearization as JLin
from kafka_tpu_torch import convert
from kafka_tpu_torch.core import hessian as thessian
from kafka_tpu_torch.core import solvers as tsolvers
from kafka_tpu_torch.core.types import Linearization as TLin

N_BANDS, N_PIX, P = 3, 11, 4


def _quad_problem():
    """tests/test_solvers.py:TestHessianCorrection._problem, draw for
    draw."""
    rng = np.random.default_rng(7)
    w = rng.normal(size=(N_BANDS, P, P))
    q = (w + np.swapaxes(w, -1, -2)).astype(np.float32)
    c = rng.normal(size=(N_BANDS,)).astype(np.float32)
    y = rng.normal(0.0, 1.0, (N_BANDS, N_PIX)).astype(np.float32)
    r_inv = rng.uniform(0.5, 2.0, y.shape).astype(np.float32)
    mask = rng.uniform(size=y.shape) > 0.25
    x_f = rng.normal(0.0, 0.3, (N_PIX, P)).astype(np.float32)
    p_inv = np.tile(5.0 * np.eye(P, dtype=np.float32), (N_PIX, 1, 1))
    y = np.where(mask, y, 0.0).astype(np.float32)
    r_inv = np.where(mask, r_inv, 0.0).astype(np.float32)
    return (q, c), (y, r_inv, mask), x_f, p_inv


def _jax_quad():
    def forward(params, x_pixel):
        q, c = params
        return c + 0.5 * jnp.einsum("bpq,p,q->b", q, x_pixel, x_pixel)

    def linearize(params, x):
        q, c = params
        return JLin(h0=c[:, None] + 0.5 * jnp.einsum("bpq,np,nq->bn", q, x,
                                                      x),
                    jac=jnp.einsum("bpq,nq->bnp", q, x))

    return forward, linearize


def _torch_quad():
    def forward(params, x_pixel):
        q, c = params
        return c + 0.5 * torch.einsum("bpq,p,q->b", q, x_pixel, x_pixel)

    def linearize(params, x):
        q, c = params
        return TLin(h0=c[:, None] + 0.5 * torch.einsum("bpq,np,nq->bn", q, x,
                                                        x),
                    jac=torch.einsum("bpq,nq->bnp", q, x))

    return forward, linearize


@pytest.mark.parametrize("use_pallas", [False, None],
                         ids=["plain", "default"])
def test_quadratic_correction_matches_jax_and_oracle(use_pallas):
    (q, c), (y, r_inv, mask), x_f, p_inv = _quad_problem()
    jfwd, jlin = _jax_quad()
    tfwd, tlin = _torch_quad()
    jparams = (jnp.asarray(q), jnp.asarray(c))
    tparams = (torch.as_tensor(q), torch.as_tensor(c))
    jb = JBandBatch(y=jnp.asarray(y), r_inv=jnp.asarray(r_inv),
                    mask=jnp.asarray(mask))
    tb = convert.band_batch(y, r_inv, mask, "cpu")
    xj, aj, dj = jsolvers.iterated_solve(jlin, jb, jnp.asarray(x_f),
                                         jnp.asarray(p_inv), jparams,
                                         hessian_forward=jfwd)
    opts = {} if use_pallas is None else {"use_pallas": use_pallas}
    tx, ta, td = tsolvers.iterated_solve(tlin, tb, torch.as_tensor(x_f),
                                         torch.as_tensor(p_inv), tparams,
                                         hessian_forward=tfwd, **opts)
    tx0, ta0, _ = tsolvers.iterated_solve(tlin, tb, torch.as_tensor(x_f),
                                          torch.as_tensor(p_inv), tparams,
                                          **opts)
    # The correction changes the information, not the state.
    np.testing.assert_array_equal(tx.numpy(), tx0.numpy())
    np.testing.assert_allclose(tx.numpy(), np.asarray(xj), atol=2e-3)
    # The oracle: per pixel and band, Q_b r_inv innovation, masked.
    innov = td.innovations.numpy()
    corr = np.einsum("bn,bpq->npq", r_inv * innov * mask, q)
    np.testing.assert_allclose(ta.numpy(), ta0.numpy() - corr, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(aj), rtol=2e-3,
                               atol=2e-3)


def test_masked_pixels_uncorrected():
    (q, c), (y, r_inv, mask), x_f, p_inv = _quad_problem()
    tfwd, tlin = _torch_quad()
    tparams = (torch.as_tensor(q), torch.as_tensor(c))
    tb = convert.band_batch(y, r_inv, np.zeros_like(mask), "cpu")
    _, a0, _ = tsolvers.iterated_solve(tlin, tb, torch.as_tensor(x_f),
                                       torch.as_tensor(p_inv), tparams)
    _, a1, _ = tsolvers.iterated_solve(tlin, tb, torch.as_tensor(x_f),
                                       torch.as_tensor(p_inv), tparams,
                                       hessian_forward=tfwd)
    np.testing.assert_array_equal(a1.numpy(), a0.numpy())


def _tip_states(n=256, seed=3):
    """Interior TIP states, plus states on the bounds: d on 0.1 (the
    ``max(d, 0.1)`` tie) and omega on its upper bound."""
    from kafka_tpu_torch.core.propagators import tip_prior_arrays
    from kafka_tpu_torch.obsops import TwoStreamOperator

    rng = np.random.default_rng(seed)
    mean = tip_prior_arrays()[0]
    x = np.clip(mean + rng.normal(0, 0.08, (n, 7)), 0.02, 0.98) \
        .astype(np.float32)
    lo, hi = TwoStreamOperator.state_bounds
    x[:16, 1] = lo[1]
    x[16:32, 4] = lo[4]
    x[32:48, 0] = hi[0]
    return x


def test_twostream_second_derivatives_match_jax_hessian():
    """Interior states and the ``d`` tie to rtol 1e-3 of JAX.  With
    omega on its 0.999 bound the float32 second derivative loses digits
    in ``sqrt(alpha^2 - beta^2)`` in both packages alike (~17 % from a
    float64 evaluation): there the port is held to float64, at most
    1.25x as far off as the JAX package."""
    from kafka_tpu.obsops import TwoStreamOperator as JTwoStream
    from kafka_tpu_torch.obsops import TwoStreamOperator

    x = _tip_states()
    op = TwoStreamOperator()
    hj = np.asarray(JTwoStream().hessian(None, jnp.asarray(x)))
    ht = op.hessian(None, torch.as_tensor(x)).numpy()
    h64 = op.hessian(None, torch.as_tensor(x, dtype=torch.float64)).numpy()
    assert ht.shape == (256, 2, 7, 7)
    scale = np.abs(h64).max(axis=(2, 3), keepdims=True) + 1e-6
    err = np.abs(ht - hj) / scale
    omega_bound = np.zeros(256, bool)
    omega_bound[32:48] = True
    print(f"two-stream Hessian: max relative difference {err.max():.3g} "
          f"({err[~omega_bound].max():.3g} off the omega bound)")
    assert err[~omega_bound].max() < 1e-3
    far_t = (np.abs(ht - h64) / scale)[omega_bound].max()
    far_j = (np.abs(hj - h64) / scale)[omega_bound].max()
    print(f"on the omega bound, from float64: port {far_t:.3g}, "
          f"JAX {far_j:.3g}")
    assert far_t <= 1.25 * far_j + 1e-5, (far_t, far_j)


def test_hessian_correction_twostream_matches_jax():
    from kafka_tpu.obsops import TwoStreamOperator as JTwoStream
    from kafka_tpu_torch.obsops import TwoStreamOperator

    x = np.delete(_tip_states(seed=5), np.s_[32:48], axis=0)
    n = x.shape[0]
    rng = np.random.default_rng(6)
    r_inv = rng.uniform(1e4, 4e4, (2, n)).astype(np.float32)
    innov = rng.normal(0, 0.01, (2, n)).astype(np.float32)
    mask = rng.uniform(size=(2, n)) > 0.2
    jop, top = JTwoStream(), TwoStreamOperator()
    cj = np.asarray(jhessian.hessian_correction(
        lambda xp: jop.forward_pixel(None, xp), jnp.asarray(x),
        jnp.asarray(r_inv), jnp.asarray(innov), jnp.asarray(mask)))
    ct = thessian.hessian_correction(
        lambda xp: top.forward_pixel(None, xp), torch.as_tensor(x),
        torch.as_tensor(r_inv), torch.as_tensor(innov),
        torch.as_tensor(mask)).numpy()
    scale = np.abs(cj).max(axis=(1, 2), keepdims=True) + 1e-3
    assert (np.abs(ct - cj) / scale).max() < 1e-3
    assert not ct[~mask.any(axis=0)].any()


def test_eigenvalue_floor_rebuilds_only_off_cone_pixels():
    rng = np.random.default_rng(8)
    m = rng.normal(size=(64, 7, 7)).astype(np.float32)
    a = (np.einsum("nij,nkj->nik", m, m) + 7 * np.eye(7)).astype(np.float32)
    w, v = np.linalg.eigh(a[10].astype(np.float64))
    w[:2] = [-3.0, -1e-3]                      # planted off the cone
    a[10] = (v * w) @ v.T
    a[10] = (a[10] + a[10].T) / 2
    out = tsolvers.eigenvalue_floor(torch.as_tensor(a)).numpy()
    ref = np.asarray(jsolvers._finish_solve(
        jnp.zeros((64, 7)), jnp.asarray(a), jnp.zeros((1, 64)),
        jnp.zeros((1, 64)), 1, 0.0, None,
        JBandBatch(y=jnp.zeros((1, 64)), r_inv=jnp.zeros((1, 64)),
                   mask=jnp.zeros((1, 64), bool)),
        lambda xp: jnp.zeros(1), None)[1])
    healthy = np.arange(64) != 10
    np.testing.assert_array_equal(out[healthy], a[healthy])
    np.testing.assert_array_equal(ref[healthy], a[healthy])
    wo = np.linalg.eigvalsh(out[10].astype(np.float64))
    w_max = abs(np.linalg.eigvalsh(a[10].astype(np.float64))[-1])
    # At the floor, less the float32 rounding of the V diag(w) V^T
    # rebuild (4 ulps of the largest eigenvalue).
    assert wo.min() >= 1e-6 * w_max - 4 * np.finfo(np.float32).eps * w_max
    np.testing.assert_allclose(out[10], ref[10], rtol=1e-4, atol=1e-4)


def _engine(pkg, hessian_correction, scan_window=1):
    """tests/test_engine.py:TestHessianCorrectionWiring's run in ``pkg``:
    8 x 8 circle, the TIP prior, one date, truth TLAI 0.5."""
    import importlib

    port = pkg == "kafka_tpu_torch"
    kw = {"device": "cpu"} if port else {}
    eng = importlib.import_module(pkg + ".engine")
    syn = importlib.import_module(pkg + ".testing.synthetic")
    obsops = importlib.import_module(pkg + ".obsops")
    prop = importlib.import_module(pkg + ".core.propagators")

    def day(i):
        return datetime.datetime(2020, 6, 1) + datetime.timedelta(days=i)

    yy, xx = np.mgrid[:8, :8]
    mask = (yy - 4) ** 2 + (xx - 4) ** 2 < 9
    op = obsops.TwoStreamOperator()
    mean = prop.tip_prior_arrays()[0] if port \
        else np.asarray(prop.tip_prior().mean)
    truth = np.broadcast_to(mean, mask.shape + (7,)).copy()
    truth[..., 6] = 0.5
    if port:
        prior = eng.FixedGaussianPrior(prop.tip_prior(device="cpu"),
                                       eng.TIP_PARAMETER_LIST)
    else:
        prior = eng.FixedGaussianPrior(prop.tip_prior(),
                                       eng.TIP_PARAMETER_LIST)
    obs = syn.SyntheticObservations(dates=[day(1), day(3)], operator=op,
                                    truth_fn=lambda date: truth, sigma=0.01,
                                    mask_prob=0.0, seed=5, **kw)
    out = syn.MemoryOutput()
    kf = eng.KalmanFilter(obs, out, mask, eng.TIP_PARAMETER_LIST,
                          state_propagation=None, prior=prior,
                          pad_multiple=64,
                          hessian_correction=hessian_correction,
                          scan_window=scan_window, **kw)
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    x_a, _, p_inv_a = kf.run([day(0), day(2), day(4)], x0, None, p_inv0)
    return kf, out, np.asarray(x_a), np.asarray(p_inv_a)


@pytest.mark.parametrize("scan_window", [1, 8], ids=["unfused", "fused"])
def test_engine_hessian_correction_matches_jax(scan_window):
    """The same state with and without the correction, a real change of
    the information, and the JAX engine's rasters (its default XLA loop
    against the port's default fused path)."""
    _, _, x0, p0 = _engine("kafka_tpu_torch", False, scan_window)
    kf, out, x1, p1 = _engine("kafka_tpu_torch", True, scan_window)
    jkf, jout, jx1, jp1 = _engine("kafka_tpu", True, scan_window)
    np.testing.assert_allclose(x1, x0, atol=1e-6)
    assert np.isfinite(p1).all()
    assert np.abs(p1 - p0).max() > 1e-6
    assert [r.get("fused") for r in kf.diagnostics_log] \
        == [r.get("fused") for r in jkf.diagnostics_log]
    np.testing.assert_allclose(x1, jx1, atol=2e-3)
    for ts in jout.output:
        for key, ref in jout.output[ts].items():
            if key == "solver_qa":
                np.testing.assert_array_equal(out.output[ts][key], ref)
            else:
                np.testing.assert_allclose(out.output[ts][key], ref,
                                           atol=2e-3, err_msg=f"{ts} {key}")


def test_eigenvalue_floor_in_blocks_equals_one_batch(monkeypatch):
    """The batched eigh runs in EIGH_BLOCK slices (cuSOLVER refuses a
    tile's batch); the floored matrices do not depend on the slicing."""
    from kafka_tpu_torch.core import linalg as tlinalg

    rng = np.random.default_rng(9)
    m = rng.normal(size=(50, 7, 7)).astype(np.float32)
    a = np.einsum("nij,nkj->nik", m, m) - 2.0 * np.eye(7, dtype=np.float32)
    a = torch.as_tensor(a)
    whole = tsolvers.eigenvalue_floor(a)
    monkeypatch.setattr(tlinalg, "EIGH_BLOCK", 16)
    w, v = tlinalg.eigh_blocked(a)
    assert w.shape == (50, 7) and v.shape == (50, 7, 7)
    np.testing.assert_array_equal(tsolvers.eigenvalue_floor(a).numpy(),
                                  whole.numpy())
