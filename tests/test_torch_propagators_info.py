"""The port's propagators and ``solve_batched`` against the JAX package's
and against ``oracle.propagate_information_filter_np``, on the same
numpy inputs, at the JAX tests' tolerances (tests/test_propagators.py)."""

import numpy as np
import pytest
import torch

import kafka_tpu_torch.core.propagators as tp
from kafka_tpu_torch.core.linalg import solve_batched

RNG_SEED = 7


def random_spd(n_pix, p, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_pix, p, p)).astype(np.float32)
    return np.einsum("npq,nrq->npr", w, w) + 2.0 * np.eye(p, dtype=np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _inputs(n_pix, p, seed=RNG_SEED):
    rng = np.random.default_rng(seed + 1)
    x_a = rng.normal(0.5, 0.1, size=(n_pix, p)).astype(np.float32)
    p_inv = random_spd(n_pix, p, seed)
    q = rng.uniform(0.01, 0.5, size=(p,)).astype(np.float32)
    return x_a, p_inv, q


def _jax(name):
    import kafka_tpu.core.propagators as jp

    return getattr(jp, name)


def _both(name, x_a, p_a, p_inv, q, m=None):
    import jax.numpy as jnp

    p = x_a.shape[1]
    m = np.eye(p, dtype=np.float32) if m is None else m
    jout = _jax(name)(jnp.asarray(x_a), None if p_a is None
                      else jnp.asarray(p_a), jnp.asarray(p_inv),
                      jnp.asarray(m), jnp.asarray(q))
    tout = getattr(tp, name)(_t(x_a), None if p_a is None else _t(p_a),
                             _t(p_inv), _t(m), _t(q))
    return ([None if a is None else np.asarray(a) for a in jout],
            [None if a is None else a.numpy() for a in tout])


def test_information_filter_matches_jax_and_oracle():
    from kafka_tpu.testing import oracle

    x_a, p_inv, q = _inputs(13, 7)
    jout, tout = _both("propagate_information_filter", x_a, None, p_inv, q)
    ref = oracle.propagate_information_filter_np(p_inv, q)
    assert tout[1] is None and jout[1] is None
    np.testing.assert_allclose(tout[2], ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tout[0], x_a)


def test_information_filter_blocks_match_one_solve(monkeypatch):
    """Past INFO_SOLVE_BLOCK pixels the propagator solves in slices; the
    result is the one-call result (each pixel's system is its own)."""
    from kafka_tpu.testing import oracle

    x_a, p_inv, q = _inputs(37, 7, seed=3)
    full = tp.propagate_information_filter(_t(x_a), None, _t(p_inv),
                                           torch.eye(7), _t(q))[2]
    monkeypatch.setattr(tp, "INFO_SOLVE_BLOCK", 8)
    blk = tp.propagate_information_filter(_t(x_a), None, _t(p_inv),
                                          torch.eye(7), _t(q))[2]
    np.testing.assert_allclose(blk.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(
        blk.numpy(), oracle.propagate_information_filter_np(p_inv, q),
        rtol=1e-4, atol=1e-4)


def test_trajectory_model_applies():
    x_a, p_inv, q = _inputs(9, 7, seed=5)
    m = (np.eye(7) + 0.1 * np.random.default_rng(5).normal(size=(7, 7))) \
        .astype(np.float32)
    jout, tout = _both("propagate_information_filter", x_a, None, p_inv, q,
                       m)
    np.testing.assert_allclose(tout[0], x_a @ m.T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-5, atol=1e-6)


def test_standard_kalman_matches_jax():
    x_a, p_inv, q = _inputs(11, 7, seed=9)
    p_a = np.linalg.inv(p_inv).astype(np.float32)
    jout, tout = _both("propagate_standard_kalman", x_a, p_a, p_inv, q)
    assert tout[2] is None and jout[2] is None
    np.testing.assert_allclose(tout[1], p_a + np.diag(q), rtol=1e-6)
    np.testing.assert_allclose(tout[1], jout[1], rtol=1e-6)
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-6)


def test_information_filter_approx_matches_jax():
    x_a, p_inv, _ = _inputs(9, 5, seed=11)
    q = np.full((5,), 0.2, np.float32)
    jout, tout = _both("propagate_information_filter_approx", x_a, None,
                       p_inv, q)
    d = np.einsum("npp->np", p_inv)
    np.testing.assert_allclose(np.einsum("npp->np", tout[2]),
                               d * (1.0 / (1.0 + d * 0.2)), rtol=1e-5)
    off = tout[2] - np.einsum("np,pq->npq", np.einsum("npp->np", tout[2]),
                              np.eye(5))
    np.testing.assert_allclose(off, 0.0, atol=1e-7)
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-5, atol=1e-7)


def test_lai_propagator_matches_jax():
    x_a, p_inv, _ = _inputs(6, 7, seed=13)
    q = np.zeros((7,), np.float32)
    q[6] = 0.04
    jout, tout = _both("propagate_information_filter_lai", x_a, None, p_inv,
                       q)
    prior = tp.tip_prior("cpu")
    np.testing.assert_allclose(tout[0][:, 6], x_a[:, 6], rtol=1e-6)
    for k in range(6):
        np.testing.assert_allclose(tout[0][:, k], float(prior.mean[k]),
                                   rtol=1e-6)
    lai_info = np.einsum("npp->np", p_inv)[:, 6]
    np.testing.assert_allclose(tout[2][:, 6, 6],
                               1.0 / ((1.0 / lai_info) + 0.04), rtol=1e-5)
    np.testing.assert_allclose(tout[2][:, 0, 0],
                               float(prior.inv_cov[0, 0]), rtol=1e-5)
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-6)
    np.testing.assert_allclose(tout[2], jout[2], rtol=1e-5)


def test_prior_reset_propagator_keeps_one_slot():
    x_a, p_inv, _ = _inputs(5, 7, seed=17)
    q = np.full((7,), 0.1, np.float32)
    prior = tp.tip_prior("cpu")
    x_f, p_f, p_f_inv = tp.make_prior_reset_propagator(prior, 2)(
        _t(x_a), None, _t(p_inv), torch.eye(7), _t(q))
    assert p_f is None
    np.testing.assert_allclose(x_f[:, 2].numpy(), x_a[:, 2], rtol=1e-6)
    np.testing.assert_allclose(x_f[:, 0].numpy(), float(prior.mean[0]))
    np.testing.assert_allclose(
        p_f_inv[:, 2, 2].numpy(),
        1.0 / (1.0 / np.einsum("npp->np", p_inv)[:, 2] + 0.1), rtol=1e-5)
    # The prior's own views are untouched.
    assert float(prior.inv_cov[2, 2]) != float(p_f_inv[0, 2, 2])


@pytest.mark.parametrize("n,block", [(37, 8), (37, None), (16, 16)])
def test_solve_batched_matches_jax_and_numpy(n, block):
    import jax.numpy as jnp

    from kafka_tpu.core.linalg import solve_batched as jax_solve

    rng = np.random.default_rng(11)
    a = rng.normal(size=(n, 5, 5)).astype(np.float32) + \
        5 * np.eye(5, dtype=np.float32)
    b = rng.normal(size=(n, 5, 5)).astype(np.float32)
    got = solve_batched(_t(a), _t(b), block=block).numpy()
    ref = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    jax_out = np.asarray(jax_solve(jnp.asarray(a), jnp.asarray(b),
                                   block=block))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, jax_out, rtol=2e-4, atol=2e-5)


def test_advance_with_information_propagator_and_prior():
    """The four-way dispatcher with the exact propagator and a blend,
    against the JAX dispatcher."""
    import jax.numpy as jnp

    from kafka_tpu.core.propagators import advance as jax_advance

    x_a, p_inv, q = _inputs(10, 7, seed=23)
    mu = np.random.default_rng(1).normal(0.4, 0.1, (10, 7)).astype(
        np.float32)
    c_inv = random_spd(10, 7, seed=29)
    got = tp.advance(_t(x_a), None, _t(p_inv), torch.eye(7), _t(q),
                     prior_mean=_t(mu), prior_cov_inverse=_t(c_inv),
                     state_propagator=tp.propagate_information_filter)
    ref = jax_advance(jnp.asarray(x_a), None, jnp.asarray(p_inv),
                      jnp.eye(7), jnp.asarray(q), prior_mean=jnp.asarray(mu),
                      prior_cov_inverse=jnp.asarray(c_inv),
                      state_propagator=_jax("propagate_information_filter"))
    assert got[1] is None and ref[1] is None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-4, atol=1e-4)
