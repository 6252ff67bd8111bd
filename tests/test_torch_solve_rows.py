"""The port's packed solve (kernel 3's plain version) against the JAX
``solve_spd_packed_pallas`` in Pallas interpret mode and against a
float64 numpy solve, with the JAX package's own budgets
(tests/test_solvers.py:387-447): rtol/atol 2e-5 against the JAX kernel
(the same float32 operations in the same order), 2e-3 against float64
(float32 rounding of a well-conditioned p x p solve).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core.linalg import pack_symmetric as jpack
from kafka_tpu.core.pallas_solve import solve_spd_packed_pallas as jsolve
from kafka_tpu_torch.core import solve_rows as tsr
from kafka_tpu_torch.core.linalg import pack_symmetric as tpack


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, p, p)).astype(np.float32)
    a = (m @ m.transpose(0, 2, 1) + 5 * np.eye(p, dtype=np.float32)).astype(
        np.float32)
    b = rng.normal(size=(n, p)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("n", [256, 384, 1280])
@pytest.mark.parametrize("p", [2, 7, 10])
def test_plain_solve_matches_jax_kernel_and_float64(p, n):
    a, b = _problem(n, p, seed=p * 7 + n)
    xj = np.asarray(jsolve(jpack(jnp.asarray(a)), jnp.asarray(b),
                           interpret=True))
    xt = tsr.solve_spd_packed_kernel(tpack(torch.as_tensor(a)),
                                     torch.as_tensor(b)).numpy()
    assert xt.shape == (n, p) and xt.dtype == np.float32
    x64 = np.linalg.solve(a.astype(np.float64),
                          b.astype(np.float64)[..., None])[..., 0]
    print(f"parity solve_rows[{p},{n}]: vs jax {np.abs(xt - xj).max():.3g}"
          f" vs f64 {np.abs(xt - x64).max():.3g}")
    np.testing.assert_allclose(xt, xj, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(xt, x64, rtol=2e-3, atol=2e-3)


def test_solve_rows_layout_and_float64():
    """Row layout in and out; the plain version also runs in float64
    (the reference the card's kernel is held to)."""
    a, b = _problem(64, 7, seed=3)
    a_rows = torch.stack([torch.as_tensor(a[:, i, j]) for i in range(7)
                          for j in range(i + 1)])
    x = tsr.solve_rows(a_rows, torch.as_tensor(b).T.contiguous())
    assert x.shape == (7, 64)
    x64 = tsr.solve_rows_plain(a_rows.double(),
                               torch.as_tensor(b).T.double())
    assert x64.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), x64.numpy(), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="coefficient rows"):
        tsr.solve_rows(a_rows[:-1], torch.as_tensor(b).T.contiguous())


@pytest.mark.parametrize("p", [1, 3, 16])
def test_unsupported_instance_raises(p):
    with pytest.raises(NotImplementedError, match=r"\(2, 7, 10\)"):
        tsr.check_instance(p)
