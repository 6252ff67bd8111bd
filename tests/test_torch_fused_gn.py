"""The port's fused Gauss-Newton solve (plain version, CPU) against the
JAX ``fused_gn_rows`` (Pallas kernel in interpret mode, as the JAX
package's own tests run it off-TPU).

Budgets are the JAX package's own fused-kernel parity budgets
(tests/test_solvers.py:702-716): x atol 2e-3, A rtol/atol 2e-2, fwd and
innovations atol 5e-3 — float32 sums in another order, fed back through
the Gauss-Newton loop.  The A rtol is taken of the matrix's own scale,
sqrt(A_ii A_jj) for entry (i, j): off-diagonals that cancel to near zero
carry the rounding of their ~1e3 terms (observed: 2 of 14336 TIP entries
at 2.4e-2 of their own value, 1e-4 of the scale).  Iteration counts
and QA verdicts must be identical: they decide convergence groups and
output QA bands.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core.pallas_solve import fused_gn_rows as jax_fused
from kafka_tpu_torch.core import fused_gn as tfg

X_ATOL, A_TOL, DIAG_ATOL = 2e-3, 2e-2, 5e-3


class _JaxQuad:
    """y_b = sum_k c[b,k] x_k^2 with the analytic row Jacobian."""

    def __init__(self, coeff):
        self.coeff = np.asarray(coeff, np.float32)

    def kernel_linearize_rows(self, x_rows):
        p = self.coeff.shape[1]
        h0 = [sum(float(c[k]) * x_rows[k] ** 2 for k in range(p))
              for c in self.coeff]
        jac = [[2.0 * float(c[k]) * x_rows[k] for k in range(p)]
               for c in self.coeff]
        return h0, jac


class _TorchQuad(_JaxQuad):
    pass


def _quad_rows(p, n_bands, n, seed, hi=10.0):
    rng = np.random.default_rng(seed)
    coeff = rng.uniform(0.5, 1.5, size=(n_bands, p)).astype(np.float32)
    x_f = np.full((n, p), 0.8, np.float32)
    x_true = x_f + rng.normal(0, 0.05, (n, p)).astype(np.float32)
    y = np.einsum("bp,np->bn", coeff, x_true**2).astype(np.float32)
    mask = rng.uniform(size=y.shape) > 0.2
    y = np.where(mask, y, np.nan).astype(np.float32)  # NaN nodata
    r_inv = np.where(mask, 25.0, 0.0).astype(np.float32)
    pf = np.stack([(4.0 if i == j else 0.0) * np.ones(n, np.float32)
                   for i in range(p) for j in range(i + 1)])
    bounds = (np.full(p, -10.0, np.float32), np.full(p, hi, np.float32))
    return coeff, dict(y=y, r_inv=r_inv, mask_f=mask.astype(np.float32),
                       xf_rows=x_f.T.copy(), pf_rows=pf.astype(np.float32),
                       bounds=bounds)


def _tip_rows(n, seed=0):
    from kafka_tpu.testing.synthetic import make_tip_problem

    op, b, x0, p0 = make_tip_problem(n, seed=seed, mask_prob=0.2, host=True)
    y = np.where(b.mask, b.y, np.nan).astype(np.float32)
    pf = np.stack([p0[:, i, j] for i in range(7) for j in range(i + 1)])
    return op, dict(y=y, r_inv=b.r_inv, mask_f=b.mask.astype(np.float32),
                    xf_rows=np.ascontiguousarray(x0.T),
                    pf_rows=pf.astype(np.float32), bounds=op.state_bounds)


def _run_both(jax_lin, torch_lin, rows, corrupt=None, relaxation=1.0,
              max_iterations=25, tol=1e-3):
    n = rows["xf_rows"].shape[1]
    p = rows["xf_rows"].shape[0]
    common = dict(tol=tol, min_iterations=2, max_iterations=max_iterations,
                  relaxation=relaxation, norm_denominator=float(n * p))
    names = ("y", "r_inv", "mask_f", "xf_rows", "pf_rows")
    j = jax_fused(jax_lin, *(jnp.asarray(rows[k]) for k in names),
                  state_bounds_rows=rows["bounds"],
                  corrupt=None if corrupt is None else jnp.asarray(corrupt),
                  **common)
    t = tfg.fused_gn_rows(
        torch_lin, *(torch.as_tensor(rows[k]) for k in names),
        state_bounds_rows=rows["bounds"],
        corrupt=None if corrupt is None else torch.as_tensor(corrupt),
        device="cpu", **common)
    return [np.asarray(v) for v in j], [v.numpy() for v in t]


def _assert_parity(j, t):
    (xj, aj, fj, ij, nj, normj, vj, nfj, csj) = j
    (xt, at, ft, it, nt, normt, vt, nft, cst) = t
    assert int(nt) == int(nj), "iteration counts differ"
    np.testing.assert_array_equal(vt, vj)
    assert int(nft) == int(nfj)
    np.testing.assert_array_equal(cst, csj)
    for got in (xt, at, ft, it):
        assert np.isfinite(got).all(), "NaN leaked into an output"
    np.testing.assert_allclose(xt, xj, atol=X_ATOL)
    p = xt.shape[0]
    diag = np.abs(aj[[i * (i + 1) // 2 + i for i in range(p)]])
    scale = np.stack([np.sqrt(diag[i] * diag[j])
                      for i in range(p) for j in range(i + 1)])
    assert (np.abs(at - aj) <= A_TOL + A_TOL * scale).all(), \
        f"A differs by {np.abs(at - aj).max()}"
    np.testing.assert_allclose(ft, fj, atol=DIAG_ATOL)
    np.testing.assert_allclose(it, ij, atol=DIAG_ATOL)
    np.testing.assert_allclose(float(normt), float(normj), rtol=1e-3)


@pytest.mark.parametrize("p,n_bands", [(3, 2), (7, 1)])
def test_quad_operator_parity(p, n_bands):
    coeff, rows = _quad_rows(p, n_bands, 256, seed=p * 10 + n_bands)
    j, t = _run_both(_JaxQuad(coeff).kernel_linearize_rows,
                     _TorchQuad(coeff).kernel_linearize_rows, rows)
    _assert_parity(j, t)


def test_quad_corrupt_pixel_quarantined_and_saturation_census():
    """One corrupt pixel must come out quarantined (forecast state,
    deflated information, zeroed diagnostics) in both packages; a tight
    upper bound on parameter 0 pins pixels on every trip, and the
    saturation census must agree."""
    from kafka_tpu_torch.core import solver_health as sh

    coeff, rows = _quad_rows(3, 2, 256, seed=7, hi=0.82)
    rows["bounds"] = (np.full(3, -10.0, np.float32),
                      np.array([0.82, 10.0, 10.0], np.float32))
    cor = np.zeros(256, np.float32)
    observed = rows["mask_f"].max(axis=0) > 0
    px = int(np.nonzero(observed)[0][3])
    cor[px] = 1.0
    j, t = _run_both(_JaxQuad(coeff).kernel_linearize_rows,
                     _TorchQuad(coeff).kernel_linearize_rows, rows,
                     corrupt=cor)
    _assert_parity(j, t)
    x, a, fwd, inn, _, _, verd, _, clip_sat = t
    assert verd[px] & sh.QA_QUARANTINED
    assert ((verd & sh.QA_QUARANTINED) > 0).sum() == 1
    np.testing.assert_array_equal(x[:, px], rows["xf_rows"][:, px])
    np.testing.assert_allclose(a[:, px], 0.25 * rows["pf_rows"][:, px])
    assert (fwd[:, px] == 0).all() and (inn[:, px] == 0).all()
    assert clip_sat[0] > 0 and clip_sat[1] == 0


def test_twostream_tip_parity():
    """The production TIP configuration, p=7, 2 bands, n=512 (one
    group), NaN nodata under the mask."""
    op, rows = _tip_rows(512)
    from kafka_tpu_torch.obsops.twostream import TwoStreamOperator

    j, t = _run_both(op.kernel_linearize_rows,
                     TwoStreamOperator().kernel_linearize_rows, rows)
    _assert_parity(j, t)


def test_twostream_two_groups_block_local_convergence():
    """n=4096: two 2048-px convergence groups, each deciding its own
    trips.  The second group is unobserved (NaN nodata, zero weight), so
    its steps are ~0 and it stops after min_iterations, while damped
    steps (relaxation 0.3, tol 1e-5) keep the first group iterating."""
    from kafka_tpu_torch.obsops.twostream import TwoStreamOperator

    op, rows = _tip_rows(4096, seed=3)
    rows["y"][:, 2048:] = np.nan
    rows["r_inv"][:, 2048:] = 0.0
    rows["mask_f"][:, 2048:] = 0.0
    j, t = _run_both(op.kernel_linearize_rows,
                     TwoStreamOperator().kernel_linearize_rows, rows,
                     relaxation=0.3, tol=1e-5)
    _assert_parity(j, t)
    names = ("y", "r_inv", "mask_f", "xf_rows", "pf_rows")
    raw = tfg.fused_gn_raw_plain(
        TwoStreamOperator().kernel_linearize_rows,
        *(torch.as_tensor(rows[k]) for k in names), tol=1e-5,
        min_iterations=2, max_iterations=25, relaxation=0.3,
        state_bounds_rows=rows["bounds"], norm_denominator=4096.0 * 7)
    groups = raw[4][0, ::2048].numpy()
    assert groups[1] == 2 and groups[0] > 2
    assert int(t[4]) == int(groups[0])
    # The unobserved group is NODATA and keeps its forecast (up to the
    # rounding of solving P_f^-1 x = P_f^-1 x_f).
    assert (t[6][2048:] == 16).all()
    np.testing.assert_allclose(t[0][:, 2048:], rows["xf_rows"][:, 2048:],
                               atol=1e-6)


def test_twostream_planted_faults_parity():
    """TIP rows with planted corrupt, Cholesky-breakdown, recoverable and
    NaN-nodata pixels under a one-iteration cap, so that every verdict
    branch fires (the same planting chip_smoke.py holds the CUDA kernel
    to).  Verdicts must be bit-identical to the JAX kernel's and the
    quarantined pixels must carry exactly the forecast state, a quarter
    of the forecast information and zero diagnostics."""
    from kafka_tpu_torch.core import solver_health as sh
    from kafka_tpu_torch.obsops.twostream import TwoStreamOperator
    from kafka_tpu_torch.testing.synthetic import plant_solver_faults

    op, rows = _tip_rows(2048, seed=5)
    names = ("y", "r_inv", "mask_f", "xf_rows", "pf_rows")
    planted_rows, cor, planted = plant_solver_faults(
        *(torch.as_tensor(rows[k]) for k in names), n_each=8)
    rows.update({k: v.numpy() for k, v in planted_rows.items()})
    j, t = _run_both(op.kernel_linearize_rows,
                     TwoStreamOperator().kernel_linearize_rows, rows,
                     corrupt=cor.numpy(), max_iterations=1)
    _assert_parity(j, t)
    x, a, fwd, inn, _, _, verd, _, _ = t
    for name in ("corrupt", "breakdown"):
        assert (verd[planted[name].numpy()] & sh.QA_QUARANTINED).all()
    rec = planted["recovered"].numpy()
    assert (verd[rec] & sh.QA_DAMPED_RECOVERED).all()
    assert not (verd[rec] & sh.QA_QUARANTINED).any()
    assert (verd[planted["nodata"].numpy()] == sh.QA_NODATA).all()
    assert not (verd[planted["half_nan"].numpy()] & sh.QA_NODATA).any()
    assert ((verd & sh.QA_CAP_BAILOUT) > 0).any()
    quar = (verd & sh.QA_QUARANTINED) > 0
    assert quar.sum() == 16
    np.testing.assert_array_equal(x[:, quar], rows["xf_rows"][:, quar])
    np.testing.assert_array_equal(a[:, quar], 0.25 * rows["pf_rows"][:, quar])
    assert (fwd[:, quar] == 0).all() and (inn[:, quar] == 0).all()


def test_wrapper_checks_device():
    coeff, rows = _quad_rows(3, 1, 64, seed=1)
    args = [torch.as_tensor(rows[k]) for k in
            ("y", "r_inv", "mask_f", "xf_rows", "pf_rows")]
    with pytest.raises(ValueError, match="not on"):
        tfg.fused_gn_rows(_TorchQuad(coeff).kernel_linearize_rows, *args,
                          1e-3, 2, 25, 1.0, None, 192.0, device="meta")
    with pytest.raises(ValueError, match="no fused"):
        tfg.fused_gn_raw(_TorchQuad(coeff).kernel_linearize_rows,
                         *[a.to("meta") for a in args], 1e-3, 2, 25, 1.0,
                         None, 192.0)
    before = tfg.fused_gn_rows.launches
    tfg.fused_gn_rows(_TorchQuad(coeff).kernel_linearize_rows, *args,
                      1e-3, 2, 25, 1.0, None, 192.0, device="cpu")
    assert tfg.fused_gn_rows.launches == before, \
        "the plain version must not count as a kernel launch"


@pytest.mark.parametrize("n,group,tol", [
    (200, 200, 1e-4), (768, 768, 1e-4),     # one group: 1, 3 CTAs
    (1536, 1536, 1e-4),                     # one group: 6 CTAs
    (2056, 8, 1e-3),                        # groups under a warp
    (2304, 256, 1e-4), (2560, 512, 1e-4),   # 1 and 2 CTAs
    (4096, 2048, 1e-4),                     # 8 CTAs, as on a tile
])
def test_twostream_parity_per_group_size(n, group, tol):
    """TIP rows at n whose convergence group gcd(n, min(2048, n)) takes
    each cluster shape of the CUDA kernel: the plain version that the
    kernel is held to on the card, against the JAX kernel.  Every other
    group is unobserved and stops at min_iterations, while damped steps
    keep the observed groups going, so each group decides its own trips.
    8-px groups take tol 1e-3: under 1e-4 a single ill-conditioned pixel
    decides its group's path, and float32 rounding then moves it."""
    from kafka_tpu_torch.obsops.twostream import TwoStreamOperator

    assert tfg.launch_geometry(n)["group"] == group
    op, rows = _tip_rows(n, seed=group)
    unobserved = (np.arange(n) // group) % 2 == 1
    rows["y"][:, unobserved] = np.nan
    rows["r_inv"][:, unobserved] = 0.0
    rows["mask_f"][:, unobserved] = 0.0
    j, t = _run_both(op.kernel_linearize_rows,
                     TwoStreamOperator().kernel_linearize_rows, rows,
                     relaxation=0.5, tol=tol)
    _assert_parity(j, t)
    names = ("y", "r_inv", "mask_f", "xf_rows", "pf_rows")
    raw = tfg.fused_gn_raw_plain(
        TwoStreamOperator().kernel_linearize_rows,
        *(torch.as_tensor(rows[k]) for k in names), tol=tol,
        min_iterations=2, max_iterations=25, relaxation=0.5,
        state_bounds_rows=rows["bounds"], norm_denominator=float(n * 7))
    trips = raw[4][0, ::group].numpy()
    assert (trips[1::2] == 2).all() and (trips[::2] > 2).all()
    assert int(t[4]) == int(trips.max())
    assert (t[6][unobserved] == 16).all()


@pytest.mark.parametrize("n,group,ctas,threads", [
    (4_608_000, 2048, 8, 256),   # the MODIS tile date
    (1_205_760, 512, 2, 256),    # the S2 sub-tile
    (2 ** 19, 2048, 8, 256),     # the JAX bench's device size
    (168, 168, 1, 192),          # the small engine runs (12 x 14 px)
])
def test_launch_geometry_tiles_every_group(n, group, ctas, threads):
    """One cluster of CTAs covers each convergence group, one pixel per
    thread, in whole warps, within the portable cluster size and a CTA's
    227 KB of shared memory; no CTA of a cluster is left without a
    pixel."""
    g = tfg.launch_geometry(n)
    assert (g["group"], g["ctas"], g["threads"]) == (group, ctas, threads)
    assert g["group"] * g["clusters"] == n
    assert (g["ctas"] - 1) * g["threads"] < g["group"] \
        <= g["ctas"] * g["threads"]
    assert g["threads"] % 32 == 0 and g["threads"] <= 256
    assert g["ctas"] <= 8
    assert g["smem_bytes"] == threads * tfg.COLUMN_FLOATS * 4
    assert g["smem_bytes"] <= 232_448


def test_launch_geometry_rejects_groups_beyond_one_cluster():
    assert tfg.launch_geometry(2056)["threads"] == 32  # 8-px groups
    with pytest.raises(ValueError, match="cluster holds at most 8"):
        tfg.launch_geometry(8192, block=4096)
