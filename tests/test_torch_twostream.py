"""Parity of the port's two-stream operator with the JAX package.

``forward``, the batched ``linearize`` (torch.func vmap + jacfwd) and the
row-layout ``kernel_linearize_rows`` (torch.func.jvp) against the JAX
``linearize`` at atol 1e-5: the same float32 closed form, differentiated
by the same JVP rules, so only rounding order differs (observed ~2e-6 on
Jacobian entries of order 1).  States on the bounds are included: there
``max(d, 0.1)`` sits exactly on its tie, where JAX splits the derivative
half and half — the port must do the same.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.obsops.twostream import TwoStreamOperator as JaxOp
from kafka_tpu.obsops.twostream import twostream_albedo as jax_albedo
from kafka_tpu_torch.obsops.twostream import TwoStreamOperator as TorchOp
from kafka_tpu_torch.obsops.twostream import twostream_albedo

ATOL = 1e-5


def _states(kind, n=64, seed=3):
    lo, hi = JaxOp.state_bounds
    rng = np.random.default_rng(seed)
    x = (lo + (hi - lo) * rng.uniform(0.1, 0.9, (n, 7))).astype(np.float32)
    if kind == "lower":
        x[:] = lo
    elif kind == "upper":
        x[:] = hi
    elif kind == "mixed":
        x[::3] = lo
        x[1::3] = hi
    return x


@pytest.mark.parametrize("kind", ["interior", "lower", "upper", "mixed"])
def test_forward_matches_jax(kind):
    x = _states(kind)
    hj = np.asarray(JaxOp().forward(None, jnp.asarray(x)))
    ht = TorchOp().forward(None, torch.as_tensor(x))
    assert ht.shape == (2, x.shape[0]) and ht.dtype == torch.float32
    np.testing.assert_allclose(ht.numpy(), hj, atol=ATOL)


@pytest.mark.parametrize("kind", ["interior", "lower", "upper", "mixed"])
def test_linearize_matches_jax(kind):
    x = _states(kind)
    lj = JaxOp().linearize(None, jnp.asarray(x))
    lt = TorchOp().linearize(None, torch.as_tensor(x))
    assert lt.jac.shape == (2, x.shape[0], 7)
    assert lt.jac.dtype == torch.float32
    np.testing.assert_allclose(lt.h0.numpy(), np.asarray(lj.h0), atol=ATOL)
    np.testing.assert_allclose(lt.jac.numpy(), np.asarray(lj.jac),
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["interior", "lower", "upper", "mixed"])
def test_kernel_rows_match_jax_linearize(kind):
    x = _states(kind)
    lj = JaxOp().linearize(None, jnp.asarray(x))
    h0, jac = TorchOp().kernel_linearize_rows(
        tuple(torch.as_tensor(x[:, k]) for k in range(7)))
    for b in range(2):
        assert h0[b].shape == (x.shape[0],)
        np.testing.assert_allclose(h0[b].numpy(), np.asarray(lj.h0[b]),
                                   atol=ATOL)
        for k in range(7):
            np.testing.assert_allclose(
                jac[b][k].numpy(), np.asarray(lj.jac[b, :, k]), atol=ATOL,
                err_msg=f"band {b} dparam {k}")


def test_tie_derivative_is_halved_like_jax():
    """At d == 0.1 exactly, d/dd max(d, 0.1) is 0.5 in both packages (the
    clip of g then zeroes the albedo's derivative); torch.clamp would
    give 1."""
    from torch.func import jvp

    from kafka_tpu_torch.obsops.twostream import _max

    d = torch.tensor([0.1, 0.2, 0.05])
    _, dot = jvp(lambda v: _max(v, 0.1), (d,), (torch.ones(3),))
    assert dot.tolist() == [0.5, 1.0, 0.0]
    args = [np.float32(v) for v in (0.3, 0.1, 0.2, 1.5)]
    import jax

    gj = jax.grad(lambda d_: jax_albedo(args[0], d_, args[2], args[3]))(
        args[1])
    _, gt = jvp(lambda d_: twostream_albedo(
        torch.tensor(args[0]), d_, torch.tensor(args[2]),
        torch.tensor(args[3])), (torch.tensor(args[1]),),
        (torch.tensor(1.0),))
    assert float(gt) == pytest.approx(float(gj), abs=ATOL)


def test_operator_surface():
    op = TorchOp()
    assert op.inkernel_linearize and op.kernel_physics == "twostream"
    for a, b in zip(op.state_bounds, JaxOp.state_bounds):
        np.testing.assert_array_equal(a, b)
