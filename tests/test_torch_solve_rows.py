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


@pytest.mark.parametrize("n", [256, 384, 1280, 257, 258, 259])
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


@pytest.mark.parametrize("p", [2, 7, 10])
@pytest.mark.parametrize("n", [1, 3, 127, 128, 4096, 4099, 2 ** 19,
                               2 ** 19 + 3, 1_205_760, 4_608_000])
def test_launch_plan_route_tiles_and_shared_memory(p, n):
    """TMA exactly when n % 4 == 0 and both bases are 16-byte aligned; the
    tiles cover n with a ragged tail of the right size; one CTA per SM at
    most; the ring fits a CTA's shared memory."""
    for ptrs in [(0, 256), (4096, 16), (4, 256), (256, 8), (256, 260)]:
        plan = tsr.launch_plan(p, n, ptrs, sms=132)
        aligned = all(x % 16 == 0 for x in ptrs)
        assert plan["route"] == ("tma" if n % 4 == 0 and aligned
                                 else "cp_async")
    groups, stages = tsr.GEOMETRY[p]
    assert plan["tile"] == groups * tsr.CHUNK
    assert plan["stages"] == stages
    assert plan["consumer_warps"] == 4 * groups
    assert plan["threads"] == 32 * plan["consumer_warps"] + tsr.CHUNK
    assert (plan["tiles"] - 1) * plan["tile"] < n <= plan["tiles"] * plan[
        "tile"]
    assert plan["tail"] == n - (plan["tiles"] - 1) * plan["tile"]
    assert 1 <= plan["tail"] <= plan["tile"]
    assert plan["tail"] == (n % plan["tile"] or plan["tile"])
    assert plan["grid"] == min(132, plan["tiles"])
    rows = p * (p + 1) // 2 + p
    assert plan["smem_bytes"] == tsr.BARRIER_BYTES + stages * plan[
        "tile"] * rows * 4
    assert plan["smem_bytes"] <= 232_448  # a CTA's shared memory on Hopper
    assert plan["threads"] <= 1024


def test_launch_plan_rejects_empty_and_unknown_instances():
    with pytest.raises(ValueError, match="nothing to solve"):
        tsr.launch_plan(10, 0, (), 132)
    with pytest.raises(NotImplementedError):
        tsr.launch_plan(5, 256, (), 132)


def test_route_reads_every_base_pointer():
    assert tsr.route(4096) == "tma"
    assert tsr.route(4096, 256, 512, 1024) == "tma"
    assert tsr.route(4096, 256, 512, 1028) == "cp_async"
    assert tsr.route(4097, 256) == "cp_async"
