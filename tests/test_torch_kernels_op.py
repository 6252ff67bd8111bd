"""The port's Ross-Li kernels, MOD09 QA decoding, x2 regridding,
``KernelsOperator`` and ``kernels_prior`` against the JAX package on the
same seeded inputs.

Budgets: the kernels are float32 transcendental chains evaluated by two
libraries (XLA's and PyTorch's CPU math), held to rtol 1e-5 / atol 2e-6;
the operator's forward and Jacobian to float32 rounding (rtol 1e-6,
atol 1e-7); QA decoding, regridding and the prior exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.engine import priors as jpriors
from kafka_tpu.io import mod09 as jmod09
from kafka_tpu.obsops import kernels as jk
from kafka_tpu_torch.engine import priors as tpriors
from kafka_tpu_torch.io import mod09 as tmod09
from kafka_tpu_torch.obsops import kernels as tk

K_RTOL, K_ATOL = 1e-5, 2e-6


def _geometry(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    sza = rng.uniform(0.0, 70.0, n).astype(np.float32)
    vza = rng.uniform(0.0, 65.0, n).astype(np.float32)
    raa = rng.uniform(-360.0, 360.0, n).astype(np.float32)
    return sza, vza, raa


@pytest.mark.parametrize("fn", ["ross_thick", "li_sparse_reciprocal"])
def test_kernel_matches_jax_on_seeded_geometry(fn):
    sza, vza, raa = _geometry()
    ref = np.asarray(getattr(jk, fn)(jnp.asarray(sza), jnp.asarray(vza),
                                     jnp.asarray(raa)))
    got = getattr(tk, fn)(sza, vza, raa)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=K_RTOL, atol=K_ATOL)


def test_ross_li_kernels_scalars_and_nadir():
    """Scalar degrees (the fixture's per-date geometry) in float32, and
    both kernels zero at nadir, in both packages."""
    for sza, vza, raa in ((30.0, 10.0, 60.0), (42.0, 25.0, -55.0),
                          (0.0, 0.0, 0.0)):
        kj = [float(v) for v in jk.ross_li_kernels(sza, vza, raa)]
        kt = [float(v) for v in tk.ross_li_kernels(sza, vza, raa)]
        np.testing.assert_allclose(kt, kj, rtol=K_RTOL, atol=K_ATOL)
    assert np.allclose([float(v) for v in tk.ross_li_kernels(0.0, 0.0, 0.0)],
                       0.0, atol=1e-6)


def test_decode_state_qa_whitelist_and_rejections():
    whitelist = np.array([8, 72, 136, 200, 1032, 1288, 2056, 2120, 2184,
                          2248])
    bad = np.array([0b01, 0b10, 8 | 0b100, 0, 8 | (0b10 << 8),
                    8 | (1 << 12), 8 | (1 << 13)])
    assert tmod09.decode_state_qa(whitelist).all()
    assert not tmod09.decode_state_qa(bad).any()
    every = np.arange(2 ** 16, dtype=np.uint16)
    np.testing.assert_array_equal(tmod09.decode_state_qa(every),
                                  jmod09.decode_state_qa(every))


def test_zoom2_nearest_matches_jax():
    a = np.random.default_rng(3).integers(0, 9, (5, 7)).astype(np.int16)
    z = tmod09.zoom2_nearest(a)
    assert z.shape == (10, 14)
    np.testing.assert_array_equal(z, jmod09.zoom2_nearest(a))


def _operator_inputs(n_pix=64, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 0.5, (n_pix, 21)).astype(np.float32)
    k_vol = rng.uniform(-0.1, 0.6, n_pix).astype(np.float32)
    k_geo = rng.uniform(-1.2, 0.1, n_pix).astype(np.float32)
    return x, k_vol, k_geo


def test_kernels_operator_forward_and_jacobian():
    x, k_vol, k_geo = _operator_inputs()
    jop, top = jk.KernelsOperator(7), tk.KernelsOperator(7)
    jlin = jop.linearize(jk.KernelsAux(jnp.asarray(k_vol),
                                       jnp.asarray(k_geo)), jnp.asarray(x))
    taux = tk.KernelsAux(torch.as_tensor(k_vol), torch.as_tensor(k_geo))
    tlin = top.linearize(taux, torch.as_tensor(x))
    assert tuple(tlin.jac.shape) == (7, 64, 21)
    np.testing.assert_allclose(tlin.h0.numpy(), np.asarray(jlin.h0),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tlin.jac.numpy(), np.asarray(jlin.jac))
    np.testing.assert_allclose(top.forward(taux, torch.as_tensor(x)).numpy(),
                               np.asarray(jlin.h0), rtol=1e-6, atol=1e-7)
    # The operator is linear: a zero second derivative in both packages.
    head = tk.KernelsAux(taux.k_vol[:4], taux.k_geo[:4])
    assert not top.hessian(head, torch.as_tensor(x[:4])).any()
    assert top.n_params == 21 and top.n_bands == 7
    for t, j in zip(top.state_bounds, jop.state_bounds):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.mark.parametrize("n_bands", [7, 2])
def test_kernels_prior_matches_jax(n_bands):
    jp = jpriors.kernels_prior(n_modis_bands=n_bands)
    tp = tpriors.kernels_prior(n_modis_bands=n_bands, device="cpu")
    assert tp.parameter_list == jp.parameter_list \
        == jpriors.kernel_parameter_list(n_bands)
    assert tpriors.KERNEL_PARAMETER_LIST == jpriors.KERNEL_PARAMETER_LIST
    for f in ("mean", "cov", "inv_cov"):
        np.testing.assert_array_equal(getattr(tp.prior, f).numpy(),
                                      np.asarray(getattr(jp.prior, f)),
                                      err_msg=f)
    assert tp.date_invariant


def test_kernels_prior_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpriors.kernels_prior()
