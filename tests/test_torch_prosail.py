"""The port's PROSAIL operator against the JAX ``ProsailOperator``.

Same numpy-built states and angles through both packages.  Tolerances:
h0 atol 1e-5 (float32 transcendentals of two libraries, a few ulps of a
reflectance below 1) and Jacobian atol 1e-4 (the chain amplifies those
ulps where the log transforms are steep, e.g. cm on its lower bound).
States on each bound that coincides with a clip limit inside
``inverse_transforms`` (n = 1, cbrown in {0, 1}, bsoil = 0, psoil in
{0, 1}) pin the tie rule: JAX passes half the tangent there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.obsops import prosail as jps
from kafka_tpu_torch.core import solvers as tsolvers
from kafka_tpu_torch.obsops import prosail as tps
from kafka_tpu_torch.obsops.protocol import _aux_in_dims

H0_ATOL, JAC_ATOL = 1e-5, 1e-4
N = 64


def _states(n=N, seed=0):
    """SAIL-mean states with noise; row k sits on parameter k's lower
    bound, row 10 + k on its upper bound."""
    from kafka_tpu_torch.engine.priors import sail_prior_arrays

    rng = np.random.default_rng(seed)
    mean = sail_prior_arrays()[0]
    x = np.clip(mean + rng.normal(0, 0.05, (n, 10)), 0.02, 0.98).astype(
        np.float32)
    lo, hi = tps.ProsailOperator.state_bounds
    for k in range(10):
        x[k, k] = lo[k]
        x[10 + k, k] = hi[k]
    return x


def _aux(kind, n=N, seed=1):
    """(JAX aux, port aux) of one kind: None, scalar, per-pixel, mixed."""
    if kind == "none":
        return None, None
    rng = np.random.default_rng(seed)
    if kind == "scalar":
        vals = [np.float32(30.5), np.float32(5.0), np.float32(-50.0)]
    else:
        vals = [rng.uniform(20, 50, n).astype(np.float32),
                rng.uniform(0, 10, n).astype(np.float32),
                rng.uniform(-180, 180, n).astype(np.float32)]
        if kind == "mixed":
            vals[0] = np.float32(35.0)
    return (jps.ProsailAux(*(jnp.asarray(v) for v in vals)),
            tps.ProsailAux(*(torch.as_tensor(v) for v in vals)))


@pytest.mark.parametrize("kind", ["none", "scalar", "per_pixel", "mixed"])
def test_forward_and_linearize_match_jax(kind):
    x = _states()
    jaux, taux = _aux(kind)
    jop, top = jps.ProsailOperator(), tps.ProsailOperator()
    jl = jop.linearize(jaux, jnp.asarray(x))
    tl = top.linearize(taux, torch.as_tensor(x))
    assert tl.h0.dtype == tl.jac.dtype == torch.float32
    assert tl.h0.shape == (10, N) and tl.jac.shape == (10, N, 10)
    assert np.isfinite(tl.jac.numpy()).all()
    print(f"parity prosail[{kind}]: h0 "
          f"{np.abs(tl.h0.numpy() - np.asarray(jl.h0)).max():.3g} jac "
          f"{np.abs(tl.jac.numpy() - np.asarray(jl.jac)).max():.3g}")
    np.testing.assert_allclose(tl.h0.numpy(), np.asarray(jl.h0),
                               atol=H0_ATOL)
    np.testing.assert_allclose(tl.jac.numpy(), np.asarray(jl.jac),
                               atol=JAC_ATOL)
    np.testing.assert_allclose(
        top.forward(taux, torch.as_tensor(x)).numpy(),
        np.asarray(jop.forward(jaux, jnp.asarray(x))), atol=H0_ATOL)


def test_tie_rule_on_bounds_matches_jax():
    """At n = 1 the JAX chain halves the tangent twice (clip, then
    max(n, 1)): a naive torch.clamp port would differ by 4x in that
    column.  Every bound row agrees with JAX column by column."""
    x = _states()
    jaux, taux = _aux("scalar")
    jj = np.asarray(jps.ProsailOperator().linearize(jaux, jnp.asarray(x)).jac)
    tj = tps.ProsailOperator().linearize(taux, torch.as_tensor(x)).jac.numpy()
    for row, col in ((0, 0), (3, 3), (13, 3), (8, 8), (9, 9), (19, 9)):
        np.testing.assert_allclose(tj[:, row, col], jj[:, row, col],
                                   atol=JAC_ATOL, err_msg=f"{row},{col}")
    assert np.abs(jj[:, 0, 0]).max() > 1e-3


def test_host_constants_are_the_jax_packages():
    for name in ("_TAV40", "_TAV90", "_BF_POLY"):
        np.testing.assert_array_equal(getattr(tps, name), getattr(jps, name))
    from kafka_tpu.obsops import prospect_data as jpd
    from kafka_tpu_torch.obsops import prospect_data as tpd

    for name in ("BAND_K", "N_REFRACT", "SOIL_DRY", "SOIL_WET",
                 "BAND_WAVELENGTHS"):
        np.testing.assert_array_equal(getattr(tpd, name), getattr(jpd, name))


def test_namedtuple_aux_in_dims():
    """Repair: a NamedTuple aux is rebuilt field by field (it takes its
    fields as arguments, not one iterable)."""
    _, taux = _aux("mixed")
    dims = _aux_in_dims(taux, N)
    assert isinstance(dims, tps.ProsailAux)
    assert tuple(dims) == (None, 0, 0)
    assert _aux_in_dims([torch.ones(N), 1.0], N) == [0, None]
    assert tps.ProsailOperator().aux_in_axes(taux, N) == dims


@pytest.mark.parametrize("kind", ["per_pixel", "mixed", "none"])
def test_blocked_linearize_matches_unblocked(kind):
    """Repair: blocked linearisation splits per-pixel aux leaves with the
    pixels (uneven last block, edge-padded) and closes over the rest;
    the same per-pixel arithmetic gives the same values."""
    x = torch.as_tensor(_states(n=50))
    _, taux = _aux(kind, n=50)
    op = tps.ProsailOperator()
    full = op.linearize(taux, x)
    blocked = tsolvers._blocked_linearize(op.linearize, taux, x, 16)
    assert blocked.h0.shape == (10, 50) and blocked.jac.shape == (10, 50, 10)
    np.testing.assert_allclose(blocked.h0.numpy(), full.h0.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(blocked.jac.numpy(), full.jac.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_blocked_linearize_respects_aux_in_axes():
    """A leaf whose leading axis happens to equal n_pix is not split when
    the operator says it is shared (``aux_per_pixel = False``); plain
    closures split by the leading axis."""
    seen = []

    class Shared(tps.ProsailOperator):
        aux_per_pixel = False

        def linearize(self, aux, x):
            seen.append(aux["w"].shape[0])
            return super().linearize(None, x)

    x = torch.as_tensor(_states(n=40))
    params = {"w": torch.ones(40)}
    tsolvers._blocked_linearize(Shared().linearize, params, x, 16)
    assert seen == [40, 40, 40]

    def closure(aux, xb):
        seen.append(aux["w"].shape[0])
        return tps.ProsailOperator().linearize(None, xb)

    seen.clear()
    tsolvers._blocked_linearize(closure, params, x, 16)
    assert seen == [14, 14, 14]


def test_convert_carries_prosail_aux_and_sail_prior():
    """``convert`` turns a JAX ``ProsailAux`` (scalar and per-pixel
    leaves) and the JAX SAIL prior into the port's, leaf roles kept."""
    from kafka_tpu.engine.priors import sail_prior as jsail
    from kafka_tpu_torch import convert

    jaux, taux = _aux("mixed")
    got = convert.prosail_aux(jaux, "cpu")
    assert isinstance(got, tps.ProsailAux)
    assert got.sza.ndim == 0 and got.vza.shape == (N,)
    for a, b in zip(got, taux):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jp = jsail().prior
    tp = convert.sail_prior(np.asarray(jp.mean), np.asarray(jp.cov),
                            np.asarray(jp.inv_cov), device="cpu")
    default = convert.sail_prior(device="cpu")
    for field in ("mean", "cov", "inv_cov"):
        np.testing.assert_array_equal(getattr(tp.prior, field).numpy(),
                                      np.asarray(getattr(jp, field)))
        np.testing.assert_array_equal(getattr(default.prior, field).numpy(),
                                      np.asarray(getattr(jp, field)))
    assert tp.parameter_list == ("n", "cab", "car", "cbrown", "cw", "cm",
                                 "lai", "ala", "bsoil", "psoil")
