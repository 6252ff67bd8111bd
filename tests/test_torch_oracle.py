"""The port's NumPy/SciPy oracle (``kafka_tpu_torch/testing/oracle.py``)
against the JAX package's (``kafka_tpu/testing/oracle.py``): the same
arrays, exactly, on the same seeded inputs, for every function; and the
port's own solves held to the port's oracle, as the JAX package's tests
hold theirs (the update to the float32 budget of tests/test_solvers.py,
atol 1e-4; the exact propagation to rtol 1e-4)."""

import inspect

import numpy as np
import pytest
import torch

from kafka_tpu.testing import oracle as joracle
from kafka_tpu_torch.testing import oracle as toracle

N, P, NB = 24, 3, 2


def _equal(a, b):
    if hasattr(a, "toarray"):
        a, b = a.toarray(), b.toarray()
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _spd(rng, n=N, p=P, scale=1.0):
    m = rng.normal(size=(n, p, p))
    return (scale * (m @ m.transpose(0, 2, 1) + p * np.eye(p))) \
        .astype(np.float32)


def _bands(rng, n=N, p=P, nb=NB):
    jac = [rng.normal(size=(n, p)).astype(np.float32) for _ in range(nb)]
    h0 = [rng.normal(size=n).astype(np.float32) for _ in range(nb)]
    y = [rng.normal(size=n).astype(np.float32) for _ in range(nb)]
    r_inv = [rng.uniform(1, 10, n).astype(np.float32) for _ in range(nb)]
    mask = [rng.uniform(size=n) > 0.2 for _ in range(nb)]
    return h0, jac, y, r_inv, mask


def test_same_public_functions():
    def names(mod):
        return sorted(n for n, v in vars(mod).items()
                      if inspect.isfunction(v) and not n.startswith("_")
                      and v.__module__ == mod.__name__)

    assert names(toracle) == names(joracle)


def test_sparse_layout_helpers_equal():
    rng = np.random.default_rng(0)
    jac = rng.normal(size=(N, P)).astype(np.float32)
    _equal(toracle.build_sparse_h(jac), joracle.build_sparse_h(jac))
    blocks = _spd(rng)
    _equal(toracle.block_diag_dense(blocks), joracle.block_diag_dense(blocks))


@pytest.mark.parametrize("seed", [1, 2])
def test_sparse_multiband_solve_equal(seed):
    rng = np.random.default_rng(seed)
    h0, jac, y, r_inv, mask = _bands(rng)
    x_lin = rng.normal(size=(N, P)).astype(np.float32)
    x_f = rng.normal(size=(N, P)).astype(np.float32)
    p_inv = _spd(rng)
    args = (h0, jac, y, r_inv, mask, x_lin, x_f, p_inv)
    xt, at = toracle.sparse_multiband_solve(*args)
    xj, aj = joracle.sparse_multiband_solve(*args)
    _equal(xt, xj)
    _equal(at, aj)


def test_iterated_sparse_solve_equal():
    rng = np.random.default_rng(3)
    coeff = rng.uniform(0.5, 1.5, (NB, P)).astype(np.float32)
    _, _, y, r_inv, mask = _bands(rng)
    x_f = rng.uniform(0.2, 0.8, (N, P)).astype(np.float32)
    p_inv = _spd(rng)

    def linearize(x):
        h0 = [(coeff[b] * x ** 2).sum(axis=1) for b in range(NB)]
        jac = [2 * coeff[b] * x for b in range(NB)]
        return h0, jac

    outs = [mod.iterated_sparse_solve(linearize, y, r_inv, mask, x_f,
                                      p_inv)
            for mod in (toracle, joracle)]
    _equal(outs[0][0], outs[1][0])
    _equal(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] >= 2


def test_propagation_and_prior_blend_equal():
    rng = np.random.default_rng(4)
    p_inv = _spd(rng)
    q = rng.uniform(0.01, 0.1, P).astype(np.float32)
    _equal(toracle.propagate_information_filter_np(p_inv, q),
           joracle.propagate_information_filter_np(p_inv, q))
    prior_mean = rng.normal(size=(N, P)).astype(np.float32)
    prior_inv = _spd(rng)
    x_f = rng.normal(size=(N, P)).astype(np.float32)
    xt, at = toracle.blend_prior_np(prior_mean, prior_inv, x_f, p_inv)
    xj, aj = joracle.blend_prior_np(prior_mean, prior_inv, x_f, p_inv)
    _equal(xt, xj)
    _equal(at, aj)


def test_rts_smoother_equal():
    rng = np.random.default_rng(5)
    t_total, n = 4, 6
    x_a = rng.normal(size=(t_total, n, P)).astype(np.float32)
    x_f = rng.normal(size=(t_total, n, P)).astype(np.float32)
    p_a = np.stack([_spd(rng, n) for _ in range(t_total)])
    p_f = np.stack([_spd(rng, n, scale=0.5) for _ in range(t_total)])
    m = np.eye(P, dtype=np.float32)
    xt, pt = toracle.rts_smoother_np(x_a, p_a, x_f, p_f, m)
    xj, pj = joracle.rts_smoother_np(x_a, p_a, x_f, p_f, m)
    _equal(xt, xj)
    _equal(pt, pj)


def test_port_update_held_to_the_port_oracle():
    """One linear update of the port (``linear_solve``) against the
    port's oracle, in the float32 budget of the JAX package's test."""
    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.types import BandBatch, Linearization

    rng = np.random.default_rng(6)
    h0, jac, y, r_inv, mask = _bands(rng)
    x_f = rng.normal(size=(N, P)).astype(np.float32)
    p_inv = _spd(rng)
    x_ref, _ = toracle.sparse_multiband_solve(h0, jac, y, r_inv, mask, x_f,
                                              x_f, p_inv)
    lin = Linearization(h0=torch.as_tensor(np.stack(h0)),
                        jac=torch.as_tensor(np.stack(jac)))
    bands = BandBatch(y=torch.as_tensor(np.where(mask, y, 0.0)
                                        .astype(np.float32)),
                      r_inv=torch.as_tensor(np.where(mask, r_inv, 0.0)
                                            .astype(np.float32)),
                      mask=torch.as_tensor(np.stack(mask)))
    x, _, _ = solvers.linear_solve(lin, bands, torch.as_tensor(x_f),
                                   torch.as_tensor(p_inv))
    np.testing.assert_allclose(x.numpy().ravel(), x_ref, atol=1e-4)


def test_port_propagation_held_to_the_port_oracle():
    from kafka_tpu_torch.core import propagators

    rng = np.random.default_rng(7)
    p_inv = _spd(rng)
    q = rng.uniform(0.01, 0.1, P).astype(np.float32)
    x = torch.zeros((N, P))
    _, _, got = propagators.propagate_information_filter(
        x, None, torch.as_tensor(p_inv), torch.eye(P), torch.as_tensor(q))
    np.testing.assert_allclose(
        got.numpy(), toracle.propagate_information_filter_np(p_inv, q),
        rtol=1e-4, atol=1e-5)
