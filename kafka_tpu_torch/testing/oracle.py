"""NumPy/SciPy oracle of the reference solver path (copy of
``kafka_tpu/testing/oracle.py``, which imports no JAX; nothing here
imports torch either).

A faithful re-implementation (NOT a copy) of the original KaFKA
reference's sparse block-diagonal math: the executable spec the port's
batched solves, propagators and smoother are held to on the CPU.

Formulas mirrored (file:line of the original KaFKA package):
 - normal equations + splu solve: ``kafka/inference/solvers.py:100-145``
 - relinearisation shift: ``solvers.py:95``
 - convergence loop: ``linear_kf.py:245-307`` (tol 1e-3, min 2, bail >25)
 - information propagation: ``kf_tools.py:208-245`` and ``:247-289``
 - prior blending: ``kf_tools.py:75-96``
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spl


def build_sparse_h(jac: np.ndarray) -> sp.csr_matrix:
    """Pack a batched Jacobian (n_pix, p) for one band into the reference's
    sparse layout: row i touches columns [i*p, (i+1)*p)
    (``inference/utils.py:193-215``)."""
    n_pix, p = jac.shape
    rows = np.repeat(np.arange(n_pix), p)
    cols = np.arange(n_pix * p)
    return sp.csr_matrix(
        (jac.ravel(), (rows, cols)), shape=(n_pix, n_pix * p)
    )


def block_diag_dense(blocks: np.ndarray) -> sp.csr_matrix:
    """(n_pix, p, p) -> sparse block-diagonal, reference state layout."""
    return sp.block_diag(list(blocks), format="csc")


def sparse_multiband_solve(
    h0_b: Sequence[np.ndarray],
    jac_b: Sequence[np.ndarray],
    y_b: Sequence[np.ndarray],
    r_inv_b: Sequence[np.ndarray],
    mask_b: Sequence[np.ndarray],
    x_lin: np.ndarray,
    x_forecast: np.ndarray,
    p_inv_blocks: np.ndarray,
) -> Tuple[np.ndarray, sp.spmatrix]:
    """One linearised multiband update via sparse splu, mirroring
    ``variational_kalman_multiband`` (``solvers.py:100-145``).

    All band inputs are per-pixel dense arrays; the masked-obs convention is
    the reference's: ``y`` is zeroed where masked and the uncertainty row is
    zeroed before inversion, so masked rows have R^-1 = 0 contribution.
    Returns the flat interleaved analysis state and the sparse Hessian A.
    """
    x_forecast = np.asarray(x_forecast).ravel()
    h_rows, y_rows, r_rows = [], [], []
    x_lin_flat = np.asarray(x_lin).ravel()
    for h0, jac, y, r_inv, mask in zip(h0_b, jac_b, y_b, r_inv_b, mask_b):
        h_sp = build_sparse_h(jac)
        y_shift = np.where(mask, y, 0.0) + h_sp.dot(x_lin_flat) - h0
        h_rows.append(h_sp)
        y_rows.append(y_shift)
        r_rows.append(np.where(mask, r_inv, 0.0))
    big_h = sp.vstack(h_rows).tocsr()
    big_r = sp.diags(np.hstack(r_rows))
    big_y = np.hstack(y_rows)
    p_inv = block_diag_dense(p_inv_blocks)
    a = (big_h.T.dot(big_r).dot(big_h) + p_inv).astype(np.float32)
    b = (
        big_h.T.dot(big_r).dot(big_y) + p_inv.dot(x_forecast)
    ).astype(np.float32)
    lu = spl.splu(a.tocsc())
    x = lu.solve(b)
    return x, a


def iterated_sparse_solve(
    linearize: Callable[[np.ndarray], Tuple[List[np.ndarray], List[np.ndarray]]],
    y_b: Sequence[np.ndarray],
    r_inv_b: Sequence[np.ndarray],
    mask_b: Sequence[np.ndarray],
    x_forecast: np.ndarray,
    p_inv_blocks: np.ndarray,
    tol: float = 1e-3,
    min_iterations: int = 2,
    max_iterations: int = 25,
) -> Tuple[np.ndarray, sp.spmatrix, int]:
    """The reference's Gauss-Newton loop (``linear_kf.py:245-307``) around
    the sparse solve.  ``linearize(x)`` returns per-band ``(h0_b, jac_b)``
    evaluated on the (n_pix, p) state."""
    n_params = p_inv_blocks.shape[-1]
    x_prev = x_forecast.ravel().copy()
    n_iter = 1
    while True:
        h0_b, jac_b = linearize(x_prev.reshape(-1, n_params))
        x_new, a = sparse_multiband_solve(
            h0_b, jac_b, y_b, r_inv_b, mask_b,
            x_prev.reshape(-1, n_params), x_forecast, p_inv_blocks,
        )
        norm = np.linalg.norm(x_new - x_prev) / float(len(x_new))
        if (norm < tol and n_iter >= min_iterations) or n_iter > max_iterations:
            return x_new, a, n_iter
        x_prev = x_new.copy()
        n_iter += 1


def propagate_information_filter_np(p_inv_blocks: np.ndarray,
                                    q_diag: np.ndarray) -> np.ndarray:
    """Exact information propagation oracle (``kf_tools.py:208-245``):
    solve ``(I + P_inv Q) X = P_inv`` blockwise with dense LAPACK."""
    out = np.empty_like(p_inv_blocks)
    p = p_inv_blocks.shape[-1]
    q = np.diag(np.broadcast_to(q_diag, (p,)))
    for i, blk in enumerate(p_inv_blocks):
        out[i] = np.linalg.solve(np.eye(p) + blk @ q, blk)
    return out


def blend_prior_np(prior_mean, prior_inv_blocks, x_forecast, p_inv_blocks):
    """Prior blending oracle preserving the reference's operand pairing
    (``kf_tools.py:89-94``)."""
    a = block_diag_dense(p_inv_blocks + prior_inv_blocks)
    b = (
        block_diag_dense(p_inv_blocks).dot(prior_mean.ravel())
        + block_diag_dense(prior_inv_blocks).dot(x_forecast.ravel())
    ).astype(np.float32)
    lu = spl.splu(a.tocsc())
    return lu.solve(b), a


def rts_smoother_np(
    x_analysis: np.ndarray,
    p_analysis_inverse: np.ndarray,
    x_forecast: np.ndarray,
    p_forecast_inverse: np.ndarray,
    m_matrix: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense float64 fixed-interval RTS smoother oracle, per pixel.

    Textbook covariance-form backward recursion over T filter steps:
    ``G(t) = P_a(t) M^T P_f(t+1)^-1``,
    ``x_s(t) = x_a(t) + G(t)(x_s(t+1) - x_f(t+1))``,
    ``P_s(t) = P_a(t) + G(t)(P_s(t+1) - P_f(t+1))G(t)^T``,
    anchored at ``x_s(T-1) = x_a(T-1)``.  Inputs are stacked
    ``(T, n, p)`` / ``(T, n, p, p)`` in INFORMATION form (what the
    checkpoint chain stores); ``x_forecast``/``p_forecast_inverse`` hold
    the forecast AT each step (index 0 is unused by the recursion).
    Returns ``(x_smoothed, p_smoothed)`` stacked the same way — the
    executable spec the ``smoother.rts_pass`` sweep is pinned
    against in the linear regime.
    """
    t_total, n_pix, p = x_analysis.shape
    x_s = np.empty((t_total, n_pix, p), np.float64)
    p_s = np.empty((t_total, n_pix, p, p), np.float64)
    m = np.asarray(m_matrix, np.float64)
    p_a = np.linalg.inv(np.asarray(p_analysis_inverse, np.float64))
    p_f = np.linalg.inv(np.asarray(p_forecast_inverse, np.float64))
    x_s[-1] = x_analysis[-1]
    p_s[-1] = p_a[-1]
    for t in range(t_total - 2, -1, -1):
        for i in range(n_pix):
            gain = p_a[t, i] @ m.T @ np.linalg.inv(p_f[t + 1, i])
            x_s[t, i] = x_analysis[t, i] + gain @ (
                x_s[t + 1, i] - x_forecast[t + 1, i]
            )
            p_s[t, i] = p_a[t, i] + gain @ (
                p_s[t + 1, i] - p_f[t + 1, i]
            ) @ gain.T
    return x_s, p_s
