"""Gaussian-process emulator of radiative-transfer models (port of
``kafka_tpu/obsops/gp.py``).

An ARD-RBF GP whose predictive mean

    m(x*) = k(x*, X) @ alpha,   alpha = (K + sigma_n^2 I)^-1 y

is a plain PyTorch function of one pixel's input, with its Jacobian from
``torch.func``; on the row loop ``GPBankOperator.linearize_rows`` gives
a bank's value and Jacobian rows in closed form (``core/gp_rows.py``,
one kernel launch on a card).  ``fit_gp`` conditions it, or a whole
bank at once, on (X, y) samples of any forward model (hyperparameters
optionally tuned by Adam on the negative log marginal likelihood, where
the JAX package uses optax); ``save_gp`` / ``load_gp`` keep the result
as ``.npz``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from .protocol import ObservationModel


class GPParams(NamedTuple):
    """Everything the predictive mean needs; flows through ``aux`` as
    tensors, so one operator serves any band or geometry emulator of the
    same shapes."""

    x_train: torch.Tensor           # (m, k) inducing inputs
    alpha: torch.Tensor             # (m,) (K + sig^2 I)^-1 y
    log_lengthscales: torch.Tensor  # (k,)
    log_amplitude: torch.Tensor     # ()
    y_mean: torch.Tensor            # () training-target mean


def _kernel_row(params: GPParams, x_star: torch.Tensor) -> torch.Tensor:
    ell = torch.exp(params.log_lengthscales)
    d = (params.x_train - x_star) / ell
    return torch.exp(params.log_amplitude) * torch.exp(
        -0.5 * torch.sum(d * d, -1))


def gp_predict_pixel(params: GPParams, x_star: torch.Tensor) -> torch.Tensor:
    """Predictive mean for one pixel's ``(k,)`` input, ``(1,)``-shaped."""
    return (_kernel_row(params, x_star) @ params.alpha).reshape(1) \
        + params.y_mean


def _gram(xt, log_ell, log_amp):
    z = xt / torch.exp(log_ell)[..., None, :]
    sq = torch.sum(z * z, -1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * z @ z.mT
    return torch.exp(log_amp)[..., None, None] * torch.exp(
        -0.5 * torch.clamp(d2, min=0.0))


def _adam_step(param, grad, m1, m2, step: int, lr: float = 1e-2,
               betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam update of ``param`` in place (``torch.optim.Adam``'s
    single-tensor rule, written out: ``torch.optim``'s optimizers import
    ``torch._dynamo`` when built, seconds of a cold process's set-up)."""
    b1, b2 = betas
    m1.lerp_(grad, 1.0 - b1)
    m2.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
    denom = (m2.sqrt() / np.sqrt(1.0 - b2 ** step)).add_(eps)
    param.addcdiv_(m1, denom, value=-lr / (1.0 - b1 ** step))


def fit_gp(x_train: np.ndarray, y_train: np.ndarray,
           lengthscales: Optional[np.ndarray] = None,
           amplitude=1.0, noise: float = 1e-4,
           optimize: bool = False, steps: int = 200,
           device=None) -> GPParams:
    """Condition a GP on training samples, on ``device``.

    ``x_train`` (..., m, k) and ``y_train`` (..., m) may carry leading
    batch axes: each batch entry is its own GP (its own target mean,
    hyperparameters and noise), and the returned leaves carry the same
    axes, so ``(bands, m, k)`` samples give a stacked bank at once.
    ``amplitude`` (and ``lengthscales``, (..., k)) may be given per
    entry.  With ``optimize=True`` the (log) hyperparameters are tuned
    by Adam (learning rate 1e-2, ``steps`` steps, ``_adam_step``) on the
    negative log marginal likelihood, summed over the batch (Adam's
    update is elementwise, so each entry follows its own likelihood);
    otherwise the lengthscales default to the per-dimension input
    std."""
    dev = resolve_device(device)
    f32 = torch.float32
    x_train = np.asarray(x_train, np.float32)
    y_train = np.asarray(y_train, np.float32)
    batch = x_train.shape[:-2]
    y_mean = y_train.mean(axis=-1, keepdims=True)
    if lengthscales is None:
        lengthscales = x_train.std(-2) + 1e-3
    xt = torch.as_tensor(x_train, device=dev)
    yt = torch.as_tensor(y_train - y_mean, device=dev)
    log_ell = torch.log(torch.as_tensor(
        np.broadcast_to(np.asarray(lengthscales, np.float32),
                        batch + x_train.shape[-1:]).copy(), device=dev))
    log_amp = torch.log(torch.as_tensor(
        np.broadcast_to(np.asarray(amplitude, np.float32), batch).copy(),
        device=dev))
    eye = torch.eye(x_train.shape[-2], dtype=f32, device=dev)
    noise = torch.full(batch, float(noise), dtype=f32, device=dev)

    if optimize:
        params = [log_ell.clone().requires_grad_(),
                  log_amp.clone().requires_grad_(),
                  torch.log(noise).requires_grad_()]
        moments = [(torch.zeros_like(q), torch.zeros_like(q))
                   for q in params]
        for step in range(1, steps + 1):
            k = _gram(xt, params[0], params[1]) \
                + (noise + torch.exp(params[2]))[..., None, None] * eye
            chol = torch.linalg.cholesky(k)
            w = torch.cholesky_solve(yt[..., None], chol)[..., 0]
            nll = 0.5 * torch.sum(yt * w, -1) + torch.sum(
                torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
            grads = torch.autograd.grad(nll.sum(), params)
            with torch.no_grad():
                for q, g, (m1, m2) in zip(params, grads, moments):
                    _adam_step(q, g, m1, m2, step)
        log_ell, log_amp = params[0].detach(), params[1].detach()
        noise = noise + torch.exp(params[2].detach())

    k = _gram(xt, log_ell, log_amp) + noise[..., None, None] * eye
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(yt[..., None], chol)[..., 0]
    return GPParams(x_train=xt, alpha=alpha, log_lengthscales=log_ell,
                    log_amplitude=log_amp,
                    y_mean=torch.as_tensor(y_mean[..., 0], device=dev))


def save_gp(path: str, params: GPParams) -> None:
    # kafkalint: disable=host-transfer-in-jit — writing the bank to disk
    # reads it to the host, once, off the assimilation path.
    np.savez(path, **{f: getattr(params, f).detach().cpu().numpy()
                      for f in params._fields})


def load_gp(path: str, device=None) -> GPParams:
    """A ``save_gp`` file (of either package) as tensors on ``device``."""
    dev = resolve_device(device)
    data = np.load(path)
    return GPParams(**{f: torch.as_tensor(data[f], device=dev)
                       for f in GPParams._fields})


class GPBankOperator(ObservationModel):
    """Multi-band observation operator backed by one GP per band.

    ``aux`` is a ``GPParams`` whose leaves are stacked over a leading
    band axis (``stack_gp_bank``), so per-date emulator selection is a
    swap of tensors.  Optional ``state_mappers`` ``(n_bands, k)`` gather
    a sub-state per band (the reference's ``state_mapper``)."""

    aux_per_pixel = False

    def __init__(self, n_params: int, n_bands: int, state_mappers=None):
        self.n_params = n_params
        self.n_bands = n_bands
        self.mappers = (
            None if state_mappers is None else np.asarray(state_mappers)
        )

    def linearize_rows(self, aux: GPParams, x_rows, linearize_block=None):
        """The row loop's linearisation: ``(h0 (n_bands, n), jac_rows
        (n_bands * n_params, n))`` at the row-layout state ``x_rows``
        (n_params, n), row ``b*n_params + j`` of ``jac_rows`` holding
        dh0[b]/dx[j] — one launch of the GP row kernel on a card, the
        closed form in plain PyTorch on the CPU (``core.gp_rows``)."""
        from ..core.gp_rows import gp_linearize_rows

        return gp_linearize_rows(self, aux, x_rows, linearize_block)

    def forward_pixel(self, aux: GPParams, x_pixel):
        # A bank whose band axis disagrees with the operator fails loudly
        # here: the JAX package clamps out-of-bounds indices, which would
        # silently repeat the last band, so it checks; so does the port.
        n_in_bank = int(aux.x_train.shape[0])
        if n_in_bank != self.n_bands:
            raise ValueError(
                f"emulator bank carries {n_in_bank} band(s) but the "
                f"operator expects {self.n_bands}"
            )

        def one_band(b):
            params = GPParams(*(leaf[b] for leaf in aux))
            sub = x_pixel if self.mappers is None else torch.cat(
                [x_pixel[int(i):int(i) + 1] for i in self.mappers[b]])
            return gp_predict_pixel(params, sub)

        return torch.cat([one_band(b) for b in range(self.n_bands)])


def stack_gp_bank(per_band: list) -> GPParams:
    """Stack per-band ``GPParams`` into the banked layout of
    ``GPBankOperator`` (a leading band axis on every leaf)."""
    return GPParams(*[
        torch.stack([torch.as_tensor(getattr(p, f)) for p in per_band])
        for f in GPParams._fields
    ])
