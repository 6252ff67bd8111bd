"""``per_pixel_convergence`` in the port against the JAX package: a pixel
freezes after two consecutive steps with ``||dx_i||_2 / p < tol``, the
norm counts only unfrozen steps, and the frozen mask comes back as
``converged_mask`` (stacked per window in a fused block).

Each Gauss-Newton step is one ``kalman_update``: the port's default
(and ``use_pallas: True``) runs the fused update (its plain version on
the CPU) and is held to the JAX fused update (Pallas interpret mode);
``use_pallas: False`` runs the packed plain update on both sides.

Budgets: iteration counts and frozen masks equal; x atol 2e-3 and A
within 2e-2 of the matrix scale plus 2e-2 (the JAX package's float32
Gauss-Newton budget, tests/test_solvers.py:702-716).  On the TIP
fixture a pixel whose step lies within float noise of tol could freeze
in one package and not the other; the test prints how many differ and
holds that count to 0 on this seeded problem.
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core import solvers as jsolvers
from kafka_tpu.core.types import BandBatch as JBandBatch
from kafka_tpu.core.types import Linearization as JLin
from kafka_tpu_torch import convert
from kafka_tpu_torch.core import fused_update as tfu
from kafka_tpu_torch.core import solvers as tsolvers
from kafka_tpu_torch.core.types import Linearization as TLin
from kafka_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry
from kafka_tpu_torch.telemetry.registry import use as tuse
from kafka_tpu_torch.testing.synthetic import run_tip_engine as torch_run

X_ATOL, A_TOL = 2e-3, 2e-2


class _JaxQuad:
    aux_per_pixel = True

    def __init__(self, coeff):
        self.coeff = np.asarray(coeff, np.float32)

    def linearize(self, aux, x):
        c = jnp.asarray(self.coeff)
        return JLin(h0=jnp.einsum("bp,np->bn", c, x ** 2),
                    jac=2.0 * c[:, None, :] * x[None, :, :])


class _TorchQuad(_JaxQuad):
    def linearize(self, aux, x):
        c = torch.as_tensor(self.coeff)
        return TLin(h0=torch.einsum("bp,np->bn", c, x ** 2),
                    jac=2.0 * c[:, None, :] * x[None, :, :])


def _quad(p=3, n_bands=2, n=256, seed=0):
    """Pixels whose truths sit at different distances from the forecast,
    so they freeze on different iterations."""
    rng = np.random.default_rng(seed)
    coeff = rng.uniform(0.5, 1.5, size=(n_bands, p)).astype(np.float32)
    x_f = np.full((n, p), 0.8, np.float32)
    spread = rng.uniform(0.0, 0.3, (n, 1)).astype(np.float32)
    x_true = x_f + spread * rng.normal(0, 1, (n, p)).astype(np.float32)
    y = np.einsum("bp,np->bn", coeff, x_true ** 2).astype(np.float32)
    mask = rng.uniform(size=y.shape) > 0.2
    bands = (np.where(mask, y, 0.0).astype(np.float32),
             np.where(mask, 25.0, 0.0).astype(np.float32), mask)
    p_inv = np.broadcast_to(np.eye(p, dtype=np.float32),
                            (n, p, p)).copy()
    return coeff, bands, x_f, p_inv


def _pair(jlin, tlin, bands, x_f, p_inv, jopts, topts):
    y, r_inv, mask = bands
    jb = JBandBatch(y=jnp.asarray(y), r_inv=jnp.asarray(r_inv),
                    mask=jnp.asarray(mask))
    j = jsolvers.assimilate_date_jit(jlin, jb, jnp.asarray(x_f),
                                     jnp.asarray(p_inv), None, jopts)
    t = tsolvers.assimilate_date(tlin, convert.band_batch(y, r_inv, mask,
                                                          "cpu"),
                                 x_f, p_inv, None,
                                 convert.solver_options(topts, "cpu"),
                                 device="cpu")
    return j, t


def _held(j, t):
    (xj, aj, dj), (xt, at, dt) = j, t
    assert dj.converged_mask is not None and dt.converged_mask is not None
    assert dt.health_verdicts is None
    assert int(dt.n_iterations) == int(dj.n_iterations)
    differ = int((dt.converged_mask.numpy()
                  != np.asarray(dj.converged_mask)).sum())
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=X_ATOL)
    aj = np.asarray(aj)
    d = np.sqrt(np.abs(np.einsum("nii->ni", aj)))
    scale = d[:, :, None] * d[:, None, :]
    np.testing.assert_array_less(np.abs(at.numpy() - aj),
                                 A_TOL * scale + A_TOL)
    np.testing.assert_allclose(float(dt.convergence_norm),
                               float(dj.convergence_norm), rtol=1e-2,
                               atol=1e-7)
    return differ


@pytest.mark.parametrize("path", ["fused", "plain"])
def test_quadratic_frozen_masks_match_jax(path, monkeypatch):
    calls = []
    real = tfu.fused_update_rows

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tfu, "fused_update_rows", spy)
    coeff, bands, x_f, p_inv = _quad()
    fused = path == "fused"
    jopts = {"per_pixel_convergence": True, "use_pallas": fused,
             "max_iterations": 30}
    topts = {"per_pixel_convergence": True, "max_iterations": 30}
    if not fused:
        topts["use_pallas"] = False
    j, t = _pair(_JaxQuad(coeff).linearize, _TorchQuad(coeff).linearize,
                 bands, x_f, p_inv, jopts, topts)
    assert _held(j, t) == 0
    frozen = t[2].converged_mask.numpy()
    assert frozen.all() and int(t[2].n_iterations) < 30
    # One fused update per Gauss-Newton step on the fused path, none on
    # the plain one.
    assert len(calls) == (int(t[2].n_iterations) if fused else 0)


def test_quadratic_cap_leaves_pixels_unfrozen():
    """Under a 2-iteration cap only the pixels with two sub-tol steps
    freeze; both packages agree on which."""
    coeff, bands, x_f, p_inv = _quad(seed=4)
    opts = {"per_pixel_convergence": True, "max_iterations": 2}
    j, t = _pair(_JaxQuad(coeff).linearize, _TorchQuad(coeff).linearize,
                 bands, x_f, p_inv, dict(opts, use_pallas=True), opts)
    assert _held(j, t) == 0
    frozen = t[2].converged_mask.numpy()
    assert 0 < frozen.sum() < frozen.size


def test_tip_frozen_masks_match_jax():
    from kafka_tpu.obsops import TwoStreamOperator as JTwoStream
    from kafka_tpu.testing.synthetic import make_tip_problem
    from kafka_tpu_torch.obsops import TwoStreamOperator

    jop, b, x0, p0 = make_tip_problem(512, seed=2, host=True)
    bands = (np.asarray(b.y), np.asarray(b.r_inv), np.asarray(b.mask))
    lo, hi = (np.asarray(v) for v in JTwoStream.state_bounds)
    opts = {"per_pixel_convergence": True, "relaxation": 0.7,
            "max_iterations": 40, "state_bounds": (lo, hi)}
    j, t = _pair(jop.linearize, TwoStreamOperator().linearize, bands,
                 np.asarray(x0), np.asarray(p0),
                 dict(opts, state_bounds=(jnp.asarray(lo), jnp.asarray(hi)),
                      use_pallas=True), opts)
    differ = _held(j, t)
    print(f"per-pixel TIP: {differ} of 512 frozen flags differ; "
          f"{int(t[2].converged_mask.sum())} frozen after "
          f"{int(t[2].n_iterations)} iterations")
    assert differ == 0


def _jax_engine(solver_options, scan_window):
    """The JAX twin of the port's ``run_tip_engine`` with a chosen
    ``scan_window`` (the JAX helper fixes it to 1)."""
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
    mean = np.asarray(jrc_prior().prior.mean)
    truth = np.broadcast_to(mean, mask.shape + (7,)).copy()
    truth[..., 6] = 0.45
    obs = SyntheticObservations([day(i) for i in (1, 3, 5, 7)],
                                TwoStreamOperator(), lambda date: truth,
                                sigma=0.001, mask_prob=0.05)
    out = MemoryOutput()
    sigma = np.full(7, 0.01, np.float32)
    sigma[6] = 0.5
    cov = np.diag(sigma ** 2).astype(np.float32)
    prior = FixedGaussianPrior(
        PixelPrior(mean=jnp.asarray(mean), cov=jnp.asarray(cov),
                   inv_cov=jnp.asarray(np.linalg.inv(cov))),
        TIP_PARAMETER_LIST)
    kf = KalmanFilter(obs, out, mask, TIP_PARAMETER_LIST,
                      state_propagation=None, prior=prior, pad_multiple=128,
                      solver_options=solver_options,
                      scan_window=scan_window, prefetch_depth=0)
    kf.set_trajectory_uncertainty(np.zeros(7))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    kf.run([day(i) for i in (0, 2, 4, 6, 8)], x0, None, p_inv0)
    return kf, out


@pytest.mark.parametrize("scan_window", [1, 8], ids=["unfused", "fused"])
def test_engine_per_pixel_matches_jax(scan_window):
    """The engine in per-pixel mode, unfused and in fused blocks: the
    converged fraction rides the date's packed read, the gauge holds the
    JAX name and value, the rasters agree."""
    from kafka_tpu import telemetry as jtel
    from kafka_tpu.telemetry.registry import MetricsRegistry as JRegistry

    opts = {"relaxation": 0.7, "max_iterations": 40,
            "per_pixel_convergence": True}
    with jtel.use(JRegistry()) as jreg:
        jkf, jout = _jax_engine(dict(opts, use_pallas=True), scan_window)
    with tuse(TRegistry()) as treg:
        kf, out, _, _ = torch_run(solver_options=opts,
                                  scan_window=scan_window, device="cpu")
    assert sorted(out.output) == sorted(jout.output)
    for ts in jout.output:
        assert sorted(out.output[ts]) == sorted(jout.output[ts])
        assert "solver_qa" not in out.output[ts]
        for key, ref in jout.output[ts].items():
            np.testing.assert_allclose(out.output[ts][key], ref, atol=X_ATOL,
                                       err_msg=f"{ts} {key}")
    assert len(kf.diagnostics_log) == len(jkf.diagnostics_log) == 4
    fused = [r.get("fused") for r in kf.diagnostics_log]
    assert fused == [r.get("fused") for r in jkf.diagnostics_log]
    assert any(fused) == (scan_window > 1)
    for rt, rj in zip(kf.diagnostics_log, jkf.diagnostics_log):
        assert rt["n_iterations"] == rj["n_iterations"]
        assert rt["converged_frac"] == rj["converged_frac"]
        assert "quarantined" not in rt
    name = "kafka_engine_converged_frac"
    tg, jg = treg.gauge(name), jreg.gauge(name)
    assert tg.help == jg.help
    assert tg.value() == jg.value() == kf.diagnostics_log[-1][
        "converged_frac"]
