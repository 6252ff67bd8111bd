"""The port's Water-Cloud Model, its prior and its driver against the JAX
package's, on the same numpy inputs.

Tolerances: backscatter rtol 1e-5 and Jacobians rtol 1e-4 / atol 1e-7
(float32 exp, cos and pow of two libraries, a few ulps of values of
order 1e-2..1; the Jacobian chains two of them).  States on the
``_EPS`` clamp pin the JAX tie rule (half the tangent at an exact tie),
states below it a zero derivative, and VH's E = 0 a zero (not NaN)
derivative of ``V ** 0``.  The priors are the same float32 constants,
compared exactly.  The two ``run_synthetic --operator wcm`` drivers run
on a small CPU grid and are held to the driver parity budgets of
``tests/test_torch_cli.py``: state rasters atol 2e-3, sigma rasters
rtol 1e-2 / atol 2e-3, QA bands and summary fields equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kafka_tpu.obsops import wcm as jw
from kafka_tpu_torch import convert
from kafka_tpu_torch.obsops import wcm as tw

EPS = 1e-6
N = 64


def _inputs(n=N, seed=0):
    """(v, sm, theta): random LAI, SM and angles; rows 0-3 put v or sm
    exactly on the clamp, rows 4-5 below it."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.05, 8.0, n).astype(np.float32)
    sm = rng.uniform(0.02, 0.55, n).astype(np.float32)
    theta = rng.uniform(20.0, 45.0, n).astype(np.float32)
    v[0] = sm[1] = np.float32(EPS)
    v[2] = sm[2] = np.float32(EPS)
    v[3] = np.float32(EPS)
    sm[3] = np.float32(EPS)
    v[4], sm[5] = np.float32(1e-8), np.float32(-0.1)
    return v, sm, theta


@pytest.mark.parametrize("pol", ["VV", "VH"])
def test_sigma0_matches_jax(pol):
    v, sm, theta = _inputs()
    j = np.asarray(jw.wcm_sigma0(jnp.asarray(v), jnp.asarray(sm),
                                 jnp.asarray(theta), jw.WCM_PARAMETERS[pol]))
    t = tw.wcm_sigma0(torch.as_tensor(v), torch.as_tensor(sm),
                      torch.as_tensor(theta), tw.WCM_PARAMETERS[pol]).numpy()
    assert t.dtype == np.float32 and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-5)


def _state(kind):
    v, sm, theta = _inputs()
    x = np.stack([v, sm], axis=1)
    if kind == "scalar":
        return x, np.float32(23.0)
    return x, theta


@pytest.mark.parametrize("kind", ["scalar", "per_pixel"])
def test_forward_and_linearize_match_jax(kind):
    x, theta = _state(kind)
    jop, top = jw.WCMOperator(), tw.WCMOperator()
    jaux = jw.WCMAux(theta_deg=jnp.asarray(theta))
    taux = convert.wcm_aux(jaux, "cpu")
    np.testing.assert_allclose(
        top.forward(taux, torch.as_tensor(x)).numpy(),
        np.asarray(jop.forward(jaux, jnp.asarray(x))), rtol=1e-5)
    jl = jop.linearize(jaux, jnp.asarray(x))
    tl = top.linearize(taux, torch.as_tensor(x))
    assert tl.jac.shape == (2, N, 2) and tl.jac.dtype == torch.float32
    assert torch.isfinite(tl.jac).all(), "NaN derivative at the clamp"
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0), rtol=1e-5)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               rtol=1e-4, atol=1e-7)


def test_clamp_ties_and_zero_exponent():
    """At v = _EPS the tangent halves (JAX's tie rule); below it it is
    zero; VH's d/dv of v ** 0 is 0 everywhere, so VH's v-derivative is
    the canopy attenuation's alone."""
    x, theta = _state("per_pixel")
    tl = tw.WCMOperator().linearize(
        tw.WCMAux(theta_deg=torch.as_tensor(theta)), torch.as_tensor(x))
    jac = tl.jac.numpy()
    assert (jac[:, 4, 0] == 0).all() and (jac[:, 5, 1] == 0).all()
    v = torch.tensor([EPS, 2.0 * EPS], dtype=torch.float32,
                     requires_grad=True)
    s0 = tw.wcm_sigma0(v, torch.full((2,), 0.3), torch.tensor(30.0),
                       tw.WCM_PARAMETERS["VV"])
    g, = torch.autograd.grad(s0.sum(), v)
    jg = np.asarray(jax.grad(
        lambda z: jw.wcm_sigma0(z, jnp.full((2,), 0.3), 30.0,
                                jw.WCM_PARAMETERS["VV"]).sum())(
        jnp.asarray(v.detach().numpy())))
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4)
    assert 0.4 < g[0] / g[1] < 0.6   # half the tangent on the tie


def test_wcm_operator_shape_checks():
    op = tw.WCMOperator()
    assert (op.n_params, op.n_bands) == (2, 2)
    lo, hi = op.state_bounds
    np.testing.assert_array_equal(lo, jw.WCMOperator().state_bounds[0])
    np.testing.assert_array_equal(hi, jw.WCMOperator().state_bounds[1])
    assert tw.WCMOperator(n_params=4).state_bounds is None
    with pytest.raises(ValueError, match="polarisation"):
        tw.WCMOperator(polarisations=("HH",))
    with pytest.raises(ValueError, match="Negative SM"):
        tw.validate_state(np.array([[1.0, -0.1]]))


def test_wcm_prior_matches_jax():
    from kafka_tpu.engine.priors import WCM_PARAMETER_LIST as JLIST
    from kafka_tpu.engine.priors import wcm_prior as jax_prior
    from kafka_tpu_torch.engine.priors import WCM_PARAMETER_LIST, wcm_prior

    jp = jax_prior()
    for tp in (wcm_prior("cpu"), convert.wcm_prior(
            *(np.asarray(getattr(jp.prior, f))
              for f in ("mean", "cov", "inv_cov")), device="cpu")):
        assert tp.parameter_list == WCM_PARAMETER_LIST == JLIST
        for f in ("mean", "cov", "inv_cov"):
            np.testing.assert_array_equal(getattr(tp.prior, f).numpy(),
                                          np.asarray(getattr(jp.prior, f)))


# --- the driver -------------------------------------------------------------

ARGS = ["--operator", "wcm", "--ny", "24", "--nx", "28"]


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    from kafka_tpu.cli.run_synthetic import main as jax_main
    from kafka_tpu_torch.cli.run_synthetic import main as port_main

    root = tmp_path_factory.mktemp("wcm")
    return {
        "jax": (root / "jax", jax_main(ARGS + ["--outdir",
                                               str(root / "jax")])),
        "torch": (root / "torch", port_main(
            ARGS + ["--outdir", str(root / "torch"), "--device", "cpu"])),
    }


def _tifs(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".tif"))


def test_driver_summary_matches_jax(drivers):
    j, t = drivers["jax"][1], drivers["torch"][1]
    for key in ("outputs_written", "n_pixels", "mean_iterations",
                "operator", "n_dates", "n_timesteps"):
        assert t[key] == j[key], key
    assert t["operator"] == "wcm" and t["outputs_written"] == \
        t["n_timesteps"] * (2 * 2 + 1)


def test_driver_rasters_match_jax(drivers):
    from kafka_tpu_torch.io import read_geotiff

    jdir, tdir = drivers["jax"][0], drivers["torch"][0]
    names = _tifs(jdir)
    assert names == _tifs(tdir) and names
    for name in names:
        a, _ = read_geotiff(str(tdir / name))
        b, _ = read_geotiff(str(jdir / name))
        assert np.isfinite(a).all(), name
        if name.startswith("solver_qa"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=2e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=2e-3, err_msg=name)
