"""The port's out-of-kernel Gauss-Newton row loop (one fused update per
iteration) against the JAX ``assimilate_date_jit`` row loop, and the
port's kernel rule.

- TIP (n=512) with ``{"use_pallas": True, "inkernel_linearize": False}``
  on both sides: the (7, 2) fused update;
- PROSAIL (``make_prosail_problem(256)``, the JAX package's p=10 problem)
  with ``{"use_pallas": True}``: the (10, 10) fused update.

Budgets are the JAX package's for two float32 Gauss-Newton paths
(tests/test_solvers.py:422-432, 518-529): x atol 2e-3, A rtol/atol 2e-2
(of the matrix scale sqrt(A_ii A_jj)), fwd and innovations atol 5e-3;
iteration counts equal and verdicts bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core import solvers as jsolvers
from kafka_tpu.core.types import BandBatch as JBandBatch
from kafka_tpu_torch import convert
from kafka_tpu_torch.core import solvers as tsolvers
from kafka_tpu_torch.testing.synthetic import make_prosail_problem

X_ATOL, A_TOL, DIAG_ATOL = 2e-3, 2e-2, 5e-3
ROWLOOP = {"use_pallas": True, "inkernel_linearize": False}


def _assert_parity(j, t):
    xj, aj, dj = (np.asarray(v) if i < 2 else v for i, v in enumerate(j))
    xt, at, dt = t
    xt, at = xt.numpy(), at.numpy()
    assert int(dt.n_iterations) == int(dj.n_iterations)
    np.testing.assert_array_equal(dt.health_verdicts.numpy(),
                                  np.asarray(dj.health_verdicts))
    assert np.isfinite(xt).all() and np.isfinite(at).all()
    print(f"parity rowloop: x {np.abs(xt - xj).max():.3g} A "
          f"{np.abs(at - aj).max():.3g} fwd "
          f"{np.abs(dt.fwd_modelled.numpy() - np.asarray(dj.fwd_modelled)).max():.3g}"
          f" inn {np.abs(dt.innovations.numpy() - np.asarray(dj.innovations)).max():.3g}"
          f" iterations {int(dt.n_iterations)}")
    np.testing.assert_allclose(xt, xj, atol=X_ATOL)
    diag = np.abs(np.diagonal(aj, axis1=-2, axis2=-1))
    scale = np.sqrt(diag[:, :, None] * diag[:, None, :])
    assert (np.abs(at - aj) <= A_TOL + A_TOL * scale).all()
    for field in ("innovations", "fwd_modelled"):
        got = getattr(dt, field).numpy()
        assert np.isfinite(got).all(), field
        np.testing.assert_allclose(got, np.asarray(getattr(dj, field)),
                                   atol=DIAG_ATOL, err_msg=field)
    for field in ("quarantined_count", "nonfinite_count",
                  "cap_bailout_count", "damped_recovered_count"):
        assert int(getattr(dt, field)) == int(getattr(dj, field)), field
    np.testing.assert_array_equal(dt.clip_saturated_count.numpy(),
                                  np.asarray(dj.clip_saturated_count))


def _spy(monkeypatch):
    calls = {"update": 0, "gn": 0}
    real_u, real_g = tsolvers.fused_update_rows, tsolvers.fused_gn_rows

    def update(*a, **k):
        calls["update"] += 1
        return real_u(*a, **k)

    def gn(*a, **k):
        calls["gn"] += 1
        return real_g(*a, **k)

    monkeypatch.setattr(tsolvers, "fused_update_rows", update)
    monkeypatch.setattr(tsolvers, "fused_gn_rows", gn)
    return calls


def _tip(n=512):
    from kafka_tpu.testing.synthetic import make_tip_problem

    op, b, x0, p0 = make_tip_problem(n, mask_prob=0.2, host=True)
    y = np.where(b.mask, b.y, np.nan).astype(np.float32)
    return op, (y, b.r_inv, b.mask), x0, p0


def test_tip_rowloop_matches_jax(monkeypatch):
    from kafka_tpu_torch.obsops import TwoStreamOperator

    calls = _spy(monkeypatch)
    op, bands, x0, p0 = _tip()
    lo, hi = op.state_bounds
    j = jsolvers.assimilate_date_jit(
        op.linearize, JBandBatch(*(jnp.asarray(v) for v in bands)),
        jnp.asarray(x0), jnp.asarray(p0), None,
        {**ROWLOOP, "state_bounds": (jnp.asarray(lo), jnp.asarray(hi))})
    t = tsolvers.assimilate_date(
        TwoStreamOperator().linearize, convert.band_batch(*bands, "cpu"),
        x0, p0, None, {**ROWLOOP, "state_bounds": (lo, hi)}, device="cpu")
    _assert_parity(j, t)
    assert calls == {"update": int(t[2].n_iterations), "gn": 0}


def test_prosail_rowloop_matches_jax(monkeypatch):
    from kafka_tpu.obsops.prosail import ProsailAux, ProsailOperator

    calls = _spy(monkeypatch)
    op, bands, x0, p0, aux = make_prosail_problem(256, device="cpu")
    lo, hi = op.state_bounds
    j = jsolvers.assimilate_date_jit(
        ProsailOperator().linearize,
        JBandBatch(*(jnp.asarray(v.numpy()) for v in bands)),
        jnp.asarray(x0.numpy()), jnp.asarray(p0.numpy()),
        ProsailAux(*(jnp.asarray(v.numpy()) for v in aux)),
        {"use_pallas": True,
         "state_bounds": (jnp.asarray(lo), jnp.asarray(hi))})
    t = tsolvers.assimilate_date(
        op.linearize, bands, x0, p0, aux,
        {"use_pallas": True, "state_bounds": (lo, hi)}, device="cpu")
    _assert_parity(j, t)
    assert calls == {"update": int(t[2].n_iterations), "gn": 0}


def _prosail_small(n=128):
    op, bands, x0, p0, aux = make_prosail_problem(n, seed=3, device="cpu")
    # A forecast away from the truth, so the loop takes several steps.
    x0 = torch.clamp(x0 + 0.05, 0.02, 0.98)
    return op, bands, x0, p0, aux


def test_per_pixel_bounds_clip_as_per_parameter_bounds():
    """(n_pix, p) bounds go through the row loop transposed to (p, n_pix)
    rows and clip exactly as the same (p,) bounds do."""
    op, bands, x0, p0, aux = _prosail_small()
    lo, hi = op.state_bounds
    n = x0.shape[0]
    x1, a1, d1 = tsolvers.assimilate_date(
        op.linearize, bands, x0, p0, aux,
        {"state_bounds": (lo, hi), "relaxation": 0.7}, device="cpu")
    x2, a2, d2 = tsolvers.assimilate_date(
        op.linearize, bands, x0, p0, aux,
        {"state_bounds": (np.tile(lo, (n, 1)), np.tile(hi, (n, 1))),
         "relaxation": 0.7},
        device="cpu")
    assert int(d1.n_iterations) == int(d2.n_iterations) >= 2
    assert int(d1.clip_saturated_count[0]) == n  # n forecast under 1
    np.testing.assert_array_equal(x1.numpy(), x2.numpy())
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    np.testing.assert_array_equal(d1.clip_saturated_count.numpy(),
                                  d2.clip_saturated_count.numpy())


@pytest.mark.parametrize("shape", ["rank3", "wrong_p", "wrong_n"])
def test_bad_bound_shapes_raise(shape):
    op, bands, x0, p0, aux = _prosail_small(n=32)
    lo, hi = op.state_bounds
    bad = {"rank3": np.zeros((32, 10, 1), np.float32),
           "wrong_p": np.zeros(11, np.float32),
           "wrong_n": np.zeros((31, 10), np.float32)}[shape]
    with pytest.raises(ValueError, match="state_bounds"):
        tsolvers.assimilate_date(op.linearize, bands, x0, p0, aux,
                                 {"state_bounds": (bad, hi)}, device="cpu")


@pytest.mark.parametrize("case,expect", [
    ("prosail_default", {"update": True, "gn": False}),
    ("tip_default", {"update": False, "gn": True}),
    ("tip_inkernel_opt_out", {"update": True, "gn": False}),
    ("prosail_plain", {"update": False, "gn": False}),
    ("tip_plain", {"update": False, "gn": False}),
])
def test_kernel_rule(monkeypatch, case, expect):
    """Unset use_pallas means the fused path: the in-kernel fused
    Gauss-Newton for TIP, the row loop around the fused update for
    PROSAIL (and for TIP with inkernel_linearize=False); use_pallas=False
    is the plain loop."""
    calls = _spy(monkeypatch)
    if case.startswith("prosail"):
        op, bands, x0, p0, aux = _prosail_small(n=32)
    else:
        from kafka_tpu_torch.testing.synthetic import make_tip_problem

        op, bands, x0, p0 = make_tip_problem(32, device="cpu")
        aux = None
    opts = {"state_bounds": op.state_bounds}
    if case.endswith("plain"):
        opts["use_pallas"] = False
    if case.endswith("opt_out"):
        opts["inkernel_linearize"] = False
    x, a, d = tsolvers.assimilate_date(op.linearize, bands, x0, p0, aux,
                                       opts, device="cpu")
    assert {k: v > 0 for k, v in calls.items()} == expect
    assert np.isfinite(x.numpy()).all() and d.health_verdicts is not None


def test_rowloop_quarantines_a_corrupted_pixel():
    """The corruption row (NaN forward model) quarantines its pixels on
    the row loop as on the other paths: forecast state, a quarter of the
    forecast information, zero diagnostics."""
    op, bands, x0, p0, aux = _prosail_small(n=32)
    corrupt = torch.zeros(32)
    corrupt[[4, 9]] = 1.0
    x, a, d = tsolvers.iterated_solve(
        op.linearize, bands, x0, p0, aux, state_bounds=op.state_bounds,
        relaxation=0.7, corrupt=corrupt)
    assert int(d.quarantined_count) == 2
    np.testing.assert_array_equal(x[[4, 9]].numpy(), x0[[4, 9]].numpy())
    np.testing.assert_array_equal(a[[4, 9]].numpy(),
                                  0.25 * p0[[4, 9]].numpy())
    assert (d.fwd_modelled[:, [4, 9]] == 0).all()
    assert np.isfinite(x.numpy()).all()
