"""Parity of the port's packed linear algebra and solve-health helpers
(kafka_tpu_torch.core.linalg / solver_health) with the JAX package.

Inputs are built with numpy from a fixed seed and fed to both packages.
Tolerance for the factorisation: 1e-6 relative — both run the same
unrolled float32 loops, so only the order of a few roundings differs.
Verdict packing is integer logic and must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core import linalg as jlinalg
from kafka_tpu.core import solver_health as jsh
from kafka_tpu_torch.core import linalg as tlinalg
from kafka_tpu_torch.core import solver_health as tsh


def _spd(n, p, seed):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, p, p)).astype(np.float32)
    return (np.einsum("nij,nkj->nik", m, m)
            + p * np.eye(p, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("p", [2, 7, 10])
def test_cholesky_packed_matches_jax(p):
    a = _spd(64, p, seed=p)
    lj = jlinalg.cholesky_packed(jlinalg.pack_symmetric(jnp.asarray(a)))
    lt = tlinalg.cholesky_packed(tlinalg.pack_symmetric(torch.as_tensor(a)))
    for i in range(p):
        for j in range(i + 1):
            np.testing.assert_allclose(lt[i][j].numpy(),
                                       np.asarray(lj[i][j]), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("p", [3, 7])
def test_solve_spd_packed_matches_jax(p):
    a = _spd(64, p, seed=10 + p)
    b = np.random.default_rng(p).normal(size=(64, p)).astype(np.float32)
    xj = jlinalg.solve_spd_packed(jlinalg.pack_symmetric(jnp.asarray(a)),
                                  jnp.asarray(b))
    xt = tlinalg.solve_spd_packed(
        tlinalg.pack_symmetric(torch.as_tensor(a)), torch.as_tensor(b))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-6)


def test_spd_inverse_and_batched_solve_match_jax():
    a = _spd(32, 7, seed=3)
    b = np.random.default_rng(4).normal(size=(32, 7)).astype(np.float32)
    inv_j = np.asarray(jlinalg.spd_inverse_batched(jnp.asarray(a)))
    inv_t = tlinalg.spd_inverse_batched(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tlinalg.solve_spd_batched(torch.as_tensor(a),
                                  torch.as_tensor(b)).numpy(),
        np.asarray(jlinalg.solve_spd_batched(jnp.asarray(a),
                                             jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)


def test_pack_unpack_and_diagonals_roundtrip():
    a = torch.as_tensor(_spd(8, 5, seed=1))
    np.testing.assert_array_equal(
        tlinalg.unpack_symmetric(tlinalg.pack_symmetric(a)).numpy(),
        a.numpy())
    d = tlinalg.batched_diagonal(a)
    np.testing.assert_array_equal(
        tlinalg.batched_diagonal(tlinalg.batched_diag(d)).numpy(),
        d.numpy())


def test_qa_constants_identical():
    for name in ("QA_CONVERGED", "QA_CAP_BAILOUT", "QA_DAMPED_RECOVERED",
                 "QA_QUARANTINED", "QA_NODATA", "DAMP_DIAG", "DAMP_ABS",
                 "DAMP_RELAX", "QUARANTINE_INFO_SCALE", "FAULT_SITE"):
        assert getattr(tsh, name) == getattr(jsh, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap_exit", [False, True])
def test_assemble_verdicts_bit_identical(seed, cap_exit):
    rng = np.random.default_rng(seed)
    obs, quar, moving, esc = (rng.uniform(size=(4, 256)) > 0.5)
    vj = np.asarray(jsh.assemble_verdicts(
        jnp.asarray(obs), jnp.asarray(quar), cap_exit, jnp.asarray(moving),
        jnp.asarray(esc)))
    vt = tsh.assemble_verdicts(
        torch.as_tensor(obs), torch.as_tensor(quar), cap_exit,
        torch.as_tensor(moving), torch.as_tensor(esc)).numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vt.dtype == np.int32
    counts_j = [int(c) for c in jsh.verdict_counts(jnp.asarray(vj))]
    counts_t = [int(c) for c in tsh.verdict_counts(torch.as_tensor(vt))]
    assert counts_t == counts_j


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_verdicts_bit_identical(seed):
    rng = np.random.default_rng(seed)
    vals = np.array([1, 2, 3, 4, 5, 6, 8, 16, 17, 20], np.int32)
    a = rng.choice(vals, 512).astype(np.int32)
    b = rng.choice(vals, 512).astype(np.int32)
    np.testing.assert_array_equal(
        tsh.merge_verdicts(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jsh.merge_verdicts(jnp.asarray(a), jnp.asarray(b))))


def test_health_arithmetic_matches_jax():
    rng = np.random.default_rng(5)
    a_ii = rng.uniform(-1, 10, 64).astype(np.float32)
    esc = (rng.uniform(size=64) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tsh.inflate_diag(torch.as_tensor(a_ii), torch.as_tensor(esc)).numpy(),
        np.asarray(jsh.inflate_diag(jnp.asarray(a_ii), jnp.asarray(esc))))
    healthy = esc == 0
    np.testing.assert_array_equal(
        tsh.inflate_diag(torch.as_tensor(a_ii),
                         torch.as_tensor(esc)).numpy()[healthy],
        a_ii[healthy])
    np.testing.assert_array_equal(
        tsh.damped_relaxation(0.7, torch.as_tensor(esc)).numpy(),
        np.asarray(jsh.damped_relaxation(0.7, jnp.asarray(esc))))


def test_breakdown_nonfinite_and_corruption():
    a = _spd(4, 3, seed=2)
    a[1, 1, 1] = -5.0  # indefinite pixel
    a[2, 0, 0] = np.nan
    l = tlinalg.cholesky_packed(tlinalg.pack_symmetric(torch.as_tensor(a)))
    lj = jlinalg.cholesky_packed(jlinalg.pack_symmetric(jnp.asarray(a)))
    np.testing.assert_array_equal(tsh.chol_breakdown(l).numpy(),
                                  np.asarray(jsh.chol_breakdown(lj)))
    assert tsh.chol_breakdown(l).numpy().tolist() == [False, True, True,
                                                      False]
    v = [torch.tensor([1.0, np.inf, 0.0]), torch.tensor([0.0, 1.0, np.nan])]
    assert tsh.nonfinite_any(v).tolist() == [False, True, True]
    h0 = torch.ones(2, 5)
    cor = torch.tensor([0.0, 1.0, 0.0, 0.0, 1.0])
    out = tsh.corrupt_h0(h0, cor)
    assert torch.isnan(out[:, [1, 4]]).all()
    assert (out[:, [0, 2, 3]] == 1).all()
    assert tsh.corruption_mask(10) is None
