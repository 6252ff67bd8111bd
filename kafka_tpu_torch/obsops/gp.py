"""Gaussian-process emulator of radiative-transfer models (port of
``kafka_tpu/obsops/gp.py``).

An ARD-RBF GP whose predictive mean

    m(x*) = k(x*, X) @ alpha,   alpha = (K + sigma_n^2 I)^-1 y

is a plain PyTorch function of one pixel's input, with its Jacobian from
``torch.func``.  ``fit_gp`` conditions it on (X, y) samples of any
forward model (hyperparameters optionally tuned by ``torch.optim.Adam``
on the negative log marginal likelihood, where the JAX package uses
optax); ``save_gp`` / ``load_gp`` keep the result as ``.npz``.
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
    z = xt / torch.exp(log_ell)
    sq = torch.sum(z * z, -1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * z @ z.T
    return torch.exp(log_amp) * torch.exp(-0.5 * torch.clamp(d2, min=0.0))


def fit_gp(x_train: np.ndarray, y_train: np.ndarray,
           lengthscales: Optional[np.ndarray] = None,
           amplitude: float = 1.0, noise: float = 1e-4,
           optimize: bool = False, steps: int = 200,
           device=None) -> GPParams:
    """Condition a GP on training samples, on ``device``.

    With ``optimize=True`` the (log) hyperparameters are tuned by Adam
    (learning rate 1e-2, ``steps`` steps) on the negative log marginal
    likelihood; otherwise the lengthscales default to the per-dimension
    input std."""
    dev = resolve_device(device)
    f32 = torch.float32
    x_train = np.asarray(x_train, np.float32)
    y_train = np.asarray(y_train, np.float32)
    y_mean = float(y_train.mean())
    if lengthscales is None:
        lengthscales = x_train.std(0) + 1e-3
    xt = torch.as_tensor(x_train, device=dev)
    yt = torch.as_tensor(y_train - y_mean, device=dev)
    log_ell = torch.log(torch.as_tensor(np.asarray(lengthscales), dtype=f32,
                                        device=dev))
    log_amp = torch.log(torch.tensor(float(amplitude), dtype=f32,
                                     device=dev))
    eye = torch.eye(x_train.shape[0], dtype=f32, device=dev)

    if optimize:
        params = [log_ell.clone().requires_grad_(),
                  log_amp.clone().requires_grad_(),
                  torch.log(torch.tensor(float(noise), dtype=f32,
                                         device=dev)).requires_grad_()]
        opt = torch.optim.Adam(params, lr=1e-2)
        for _ in range(steps):
            opt.zero_grad()
            k = _gram(xt, params[0], params[1]) \
                + (noise + torch.exp(params[2])) * eye
            chol = torch.linalg.cholesky(k)
            w = torch.cholesky_solve(yt[:, None], chol)[:, 0]
            nll = 0.5 * yt @ w + torch.sum(torch.log(torch.diagonal(chol)))
            nll.backward()
            opt.step()
        log_ell, log_amp = params[0].detach(), params[1].detach()
        noise = noise + float(torch.exp(params[2].detach()))

    k = _gram(xt, log_ell, log_amp) + noise * eye
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(yt[:, None], chol)[:, 0]
    return GPParams(x_train=xt, alpha=alpha, log_lengthscales=log_ell,
                    log_amplitude=log_amp,
                    y_mean=torch.tensor(y_mean, dtype=f32, device=dev))


def save_gp(path: str, params: GPParams) -> None:
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
