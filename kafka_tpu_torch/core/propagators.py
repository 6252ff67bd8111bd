"""State propagation in time (port of ``kafka_tpu/core/propagators.py``).

Propagator contract, as in the JAX package: a callable

    (x_analysis, p_analysis, p_analysis_inverse, m_matrix, q_diag) ->
        (x_forecast, p_forecast | None, p_forecast_inverse | None)

``m_matrix`` is the (p, p) linear trajectory model and ``q_diag`` the
per-parameter model-uncertainty diagonal.  All five propagators of the
JAX package are here, with the prior blend and the advance dispatcher.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .linalg import (batched_diag, batched_diagonal, solve_batched,
                     solve_spd_batched, spd_inverse_batched)

# Pixels per ``torch.linalg.solve`` call in the exact information
# propagator (the JAX package's slice of its LU call).
INFO_SOLVE_BLOCK = 131072


class PixelPrior(NamedTuple):
    """A per-pixel i.i.d. Gaussian prior: mean (p,), cov + inverse (p, p)."""

    mean: torch.Tensor
    cov: torch.Tensor
    inv_cov: torch.Tensor


def tip_prior_arrays() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side (mean, cov, inv_cov) of the JRC-TIP prior
    (``kf_tools.py:99-116`` constants, as in the JAX package)."""
    sigma = np.array([0.12, 0.7, 0.0959, 0.15, 1.5, 0.2, 0.5])
    x0 = np.array([0.17, 1.0, 0.1, 0.7, 2.0, 0.18, np.exp(-0.5 * 1.5)])
    little_p = np.diag(sigma**2).astype(np.float32)
    little_p[5, 2] = 0.8862 * 0.0959 * 0.2
    little_p[2, 5] = 0.8862 * 0.0959 * 0.2
    inv_p = np.linalg.inv(little_p)
    return x0.astype(np.float32), little_p, inv_p.astype(np.float32)


def tip_prior(device=None) -> PixelPrior:
    """The JRC-TIP prior as tensors on ``device``."""
    from .. import resolve_device

    dev = resolve_device(device)
    x0, little_p, inv_p = tip_prior_arrays()
    return PixelPrior(
        mean=torch.as_tensor(x0, dtype=torch.float32, device=dev),
        cov=torch.as_tensor(little_p, dtype=torch.float32, device=dev),
        inv_cov=torch.as_tensor(inv_p, dtype=torch.float32, device=dev),
    )


def broadcast_prior(prior: PixelPrior,
                    n_pix: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile a per-pixel prior over the pixel batch.  The results are
    expanded views (stride 0 on the pixel axis): the dense (n, p, p)
    information batch costs no memory until a consumer writes it."""
    p = prior.mean.shape[0]
    return (prior.mean.expand(n_pix, p),
            prior.inv_cov.expand(n_pix, p, p))


def _trajectory(m_matrix, x_analysis):
    """``x_f = M x_a`` per pixel."""
    return torch.einsum("pq,nq->np", m_matrix, x_analysis)


def propagate_standard_kalman(x_analysis, p_analysis, p_analysis_inverse,
                              m_matrix, q_diag):
    """Covariance-form propagation (``kf_tools.py:174-205``):
    ``x_f = M x_a``, ``P_f = P_a + Q``; no inverse, as the reference."""
    p_forecast = p_analysis + batched_diag(q_diag.expand(x_analysis.shape))
    return _trajectory(m_matrix, x_analysis), p_forecast, None


def propagate_information_filter(x_analysis, p_analysis, p_analysis_inverse,
                                 m_matrix, q_diag):
    """Exact information-filter propagation: solves
    ``(I + P^-1 Q) P_f^-1 = P^-1`` per pixel (``kf_tools.py:208-245``),
    in ``INFO_SOLVE_BLOCK`` pixel slices."""
    n_pix, p = x_analysis.shape
    q = q_diag.expand(n_pix, p)
    # S = P^-1 Q with diagonal Q: scale the columns.
    a = torch.eye(p, dtype=x_analysis.dtype, device=x_analysis.device) \
        + p_analysis_inverse * q[:, None, :]
    p_forecast_inverse = solve_batched(a, p_analysis_inverse,
                                       block=INFO_SOLVE_BLOCK)
    return _trajectory(m_matrix, x_analysis), None, p_forecast_inverse


def propagate_information_filter_approx(x_analysis, p_analysis,
                                        p_analysis_inverse, m_matrix, q_diag):
    """Diagonal approximation (``kf_tools.py:247-289``): keep the main
    diagonal of ``P^-1``, deflated by ``1 / (1 + diag(P^-1) diag(Q))``."""
    m_diag = batched_diagonal(p_analysis_inverse)
    d = 1.0 / (1.0 + m_diag * q_diag)
    return (_trajectory(m_matrix, x_analysis), None,
            batched_diag(m_diag * d))


def make_prior_reset_propagator(prior: PixelPrior, keep_param: int):
    """Generalisation of ``propagate_information_filter_LAI``
    (``kf_tools.py:292-314``): every parameter is reset to the prior
    except ``keep_param``, whose mean is carried over and whose
    information is deflated as ``1 / (1/p_kk + q_k)``."""

    def propagate(x_analysis, p_analysis, p_analysis_inverse, m_matrix,
                  q_diag):
        x_forecast = _trajectory(m_matrix, x_analysis)
        n_pix, p = x_analysis.shape
        x0, p_inv0 = broadcast_prior(prior, n_pix)
        x0 = x0.clone()
        x0[:, keep_param] = x_forecast[:, keep_param]
        post_info = batched_diagonal(p_analysis_inverse)[:, keep_param]
        q_k = q_diag.expand(n_pix, p)[:, keep_param]
        p_forecast_inverse = p_inv0.clone()
        p_forecast_inverse[:, keep_param, keep_param] = \
            1.0 / ((1.0 / post_info) + q_k)
        return x0, None, p_forecast_inverse

    return propagate


def propagate_information_filter_lai(x_analysis, p_analysis,
                                     p_analysis_inverse, m_matrix, q_diag):
    """The reference's TIP/LAI propagator (``kf_tools.py:292-314``): the
    TIP prior with TLAI (slot 6) carried, on the analysis' device."""
    return make_prior_reset_propagator(tip_prior(x_analysis.device),
                                       keep_param=6)(
        x_analysis, p_analysis, p_analysis_inverse, m_matrix, q_diag)


def make_no_propagation(prior: PixelPrior):
    """``no_propagation`` (``kf_tools.py:316-353``): discard the analysis
    and return the tiled prior."""

    def propagate(x_analysis, p_analysis, p_analysis_inverse, m_matrix,
                  q_diag):
        x0, p_inv0 = broadcast_prior(prior, x_analysis.shape[0])
        return x0, None, p_inv0

    return propagate


def no_propagation(x_analysis, p_analysis, p_analysis_inverse, m_matrix,
                   q_diag):
    """Reset to the TIP prior, on the analysis' device."""
    return make_no_propagation(tip_prior(x_analysis.device))(
        x_analysis, p_analysis, p_analysis_inverse, m_matrix, q_diag
    )


def blend_prior(prior_mean, prior_cov_inverse, x_forecast,
                p_forecast_inverse):
    """Product-of-Gaussians combination with the reference's crossed
    operand pairing (``kf_tools.py:89-94``): ``A = P_f_inv + C_inv``,
    ``b = P_f_inv @ prior_mean + C_inv @ x_forecast``."""
    combined = p_forecast_inverse + prior_cov_inverse
    b = (torch.einsum("npq,nq->np", p_forecast_inverse, prior_mean)
         + torch.einsum("npq,nq->np", prior_cov_inverse, x_forecast))
    return solve_spd_batched(combined, b.float()), combined


def blend_gaussians(mean_a, inv_cov_a, mean_b, inv_cov_b):
    """Textbook product of Gaussians: each mean weighted by its own
    information matrix (the conventional form of ``blend_prior``)."""
    combined = inv_cov_a + inv_cov_b
    b = (torch.einsum("npq,nq->np", inv_cov_a, mean_a)
         + torch.einsum("npq,nq->np", inv_cov_b, mean_b))
    return solve_spd_batched(combined, b.float()), combined


def advance(x_analysis, p_analysis, p_analysis_inverse, m_matrix, q_diag,
            prior_mean=None, prior_cov_inverse=None, state_propagator=None):
    """The four-way advance dispatcher (``kf_tools.py:136-171``):
    propagate, blend with a prior, either, or neither."""
    have_prior = prior_mean is not None
    if state_propagator is not None:
        x_f, p_f, p_f_inv = state_propagator(
            x_analysis, p_analysis, p_analysis_inverse, m_matrix, q_diag
        )
        if have_prior:
            if p_f_inv is None:
                p_f_inv = spd_inverse_batched(p_f)
            x_c, p_c_inv = blend_prior(
                prior_mean, prior_cov_inverse, x_f, p_f_inv
            )
            return x_c, None, p_c_inv
        return x_f, p_f, p_f_inv
    if have_prior:
        return prior_mean, None, prior_cov_inverse
    return None, None, None
