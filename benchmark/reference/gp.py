"""A bank of Gaussian-process emulators (one GP per band) in plain
PyTorch, in any dtype: the predictive mean and its closed-form Jacobian,
as gp_emulator's ``GaussianProcess.predict(x, do_deriv=True)`` computes
them for each band's emulator.

A bank is any object with the fields ``x_train`` (B, m, k), ``alpha``
(B, m), ``log_lengthscales`` (B, k), ``log_amplitude`` (B,) and
``y_mean`` (B,), each band's GP

    m_b(x*) = amp_b sum_i alpha_bi exp(-1/2 sum_d ((x*_d - X_bid) / ell_bd)^2)
              + y_mean_b

with ``amp = exp(log_amplitude)``, ``ell = exp(log_lengthscales)``;
``mappers`` (B, k) picks band b's inputs from the state (all of it, in
order, where there is none).  Departures from gp_emulator: its
hyperparameters are ``theta = [log(1/ell^2)..., log amp, log noise]``,
the same kernel written otherwise; it predicts raw targets, where the
fits here centre them (``y_mean``, zero for an imported emulator); it
computes the squared distance with ``scipy.spatial.distance.cdist``,
here directly as a sum over the inputs; it returns the predictive
variance too, which the filter does not use.

Nothing here imports the program.
"""

from __future__ import annotations

import torch


def _leaves(bank, b: int, dtype, device):
    return tuple(torch.as_tensor(getattr(bank, f)[b]).to(device=device,
                                                          dtype=dtype)
                 for f in ("x_train", "alpha", "log_lengthscales",
                           "log_amplitude", "y_mean"))


def _inputs(x, mappers, b: int):
    return x if mappers is None else x[:, list(mappers[b])]


def band_terms(bank, b: int, x, with_grad: bool = True):
    """``(mean (n,), grad (n, k))`` of band ``b`` at its inputs ``x``
    (n, k), in ``x``'s dtype: the closed form, one input at a time (no
    (n, m, k) tensor); ``grad`` None unless ``with_grad``."""
    x_train, alpha, log_ell, log_amp, y_mean = _leaves(bank, b, x.dtype,
                                                       x.device)
    inv_ell = torch.exp(-log_ell)
    amp = torch.exp(log_amp)
    s = torch.zeros((x.shape[0], x_train.shape[0]), dtype=x.dtype,
                    device=x.device)
    for d in range(x.shape[1]):
        diff = (x[:, d, None] - x_train[None, :, d]) * inv_ell[d]
        s = s + diff * diff
    w = torch.exp(-0.5 * s) * alpha                          # (n, m)
    mean = amp * w.sum(dim=1) + y_mean
    if not with_grad:
        return mean, None
    grad = torch.stack([
        -amp * (w * (x[:, d, None] - x_train[None, :, d])).sum(dim=1)
        * inv_ell[d] ** 2 for d in range(x.shape[1])], dim=1)
    return mean, grad


def predict(bank, x, mappers=None):
    """``(n, B)`` means of every band at the states ``x`` (n, p)."""
    return torch.stack([band_terms(bank, b, _inputs(x, mappers, b),
                                   False)[0]
                        for b in range(bank.x_train.shape[0])], dim=1)


def jacobian(bank, x, mappers=None):
    """``(h0 (n, B), J (n, B, p))``: the means and their closed-form
    derivatives with respect to the state ``x`` (n, p)."""
    n, p = x.shape
    n_bands = bank.x_train.shape[0]
    h0 = torch.empty((n, n_bands), dtype=x.dtype, device=x.device)
    jac = torch.zeros((n, n_bands, p), dtype=x.dtype, device=x.device)
    for b in range(n_bands):
        mean, grad = band_terms(bank, b, _inputs(x, mappers, b))
        h0[:, b] = mean
        cols = range(p) if mappers is None else mappers[b]
        for d, j in enumerate(cols):
            jac[:, b, int(j)] += grad[:, d]
    return h0, jac


def forward(bank, mappers=None):
    """The bank as an observation operator ``x (n, p) -> (n, B)`` in
    ``x``'s dtype (``filter.gn_date``'s ``forward``)."""
    return lambda x: predict(bank, x, mappers)
