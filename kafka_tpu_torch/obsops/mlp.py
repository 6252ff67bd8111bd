"""MLP surrogate emulator, the neural alternative to the GP bank (port of
``kafka_tpu/obsops/mlp.py``).

A small tanh MLP trained on samples of any forward function, used as an
``ObservationModel`` with ``torch.func`` Jacobians.  Parameters are a list
of ``{"w": (k_in, k_out), "b": (k_out,)}`` dicts, the JAX package's
layout; the initial weights come from an explicit ``torch.Generator``
and ``fit_mlp`` trains with ``torch.optim.Adam`` (optax in the JAX
package), so the two fits agree in accuracy, not in bits.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import resolve_device
from .protocol import ObservationModel


def _init_params(generator: torch.Generator, sizes: Sequence[int], device):
    params = []
    for k_in, k_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((k_in, k_out), generator=generator) \
            * float(np.sqrt(2.0 / k_in))
        params.append({"w": w.to(device), "b": torch.zeros(k_out,
                                                            device=device)})
    return params


def mlp_apply(params, x):
    """Forward pass; ``x`` (..., k_in) -> (..., k_out).  Tanh hidden units
    keep the surrogate smooth, so its Jacobians are well behaved in the
    Gauss-Newton loop."""
    h = x
    for layer in params[:-1]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    return h @ params[-1]["w"] + params[-1]["b"]


def fit_mlp(forward: Callable[[np.ndarray], np.ndarray],
            x_samples: np.ndarray, hidden: Sequence[int] = (64, 64),
            steps: int = 2000, lr: float = 1e-3, seed: int = 0,
            device=None):
    """Train a surrogate of ``forward`` on the sampled inputs, on
    ``device``.

    ``forward`` maps (n, k_in) numpy -> (n,) or (n, k_out).  Inputs and
    outputs are standardised for training, and the standardisation is
    folded into the first and last layers, so the result is a plain
    parameter list for ``mlp_apply``.  Returns ``(params, final_loss)``."""
    dev = resolve_device(device)
    x = np.asarray(x_samples, np.float32)
    y = np.asarray(forward(x), np.float32)
    if y.ndim == 1:
        y = y[:, None]
    x_mu, x_sd = x.mean(0), x.std(0) + 1e-6
    y_mu, y_sd = y.mean(0), y.std(0) + 1e-6
    xn = torch.as_tensor((x - x_mu) / x_sd, device=dev)
    yn = torch.as_tensor((y - y_mu) / y_sd, device=dev)

    gen = torch.Generator().manual_seed(seed)
    params = _init_params(gen, [x.shape[1], *hidden, y.shape[1]], dev)
    leaves = [t.requires_grad_() for layer in params for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=lr)
    loss = torch.tensor(float("nan"))
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.mean((mlp_apply(params, xn) - yn) ** 2)
        loss.backward()
        opt.step()
    params = [{k: v.detach() for k, v in layer.items()} for layer in params]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # Fold the input standardisation into layer 0 and the output
    # de-standardisation into the last layer.
    p0 = params[0]
    params[0] = {"w": p0["w"] / t(x_sd)[:, None],
                 "b": p0["b"] - t(x_mu / x_sd) @ p0["w"]}
    pl = params[-1]
    params[-1] = {"w": pl["w"] * t(y_sd)[None, :],
                  "b": pl["b"] * t(y_sd) + t(y_mu)}
    return params, float(loss.detach())


class MLPOperator(ObservationModel):
    """Observation operator whose bands are the outputs of one MLP
    surrogate (its parameters flow through ``aux``)."""

    aux_per_pixel = False

    def __init__(self, n_params: int, n_bands: int, state_mapper=None):
        self.n_params = n_params
        self.n_bands = n_bands
        self.mapper = None if state_mapper is None \
            else [int(i) for i in np.asarray(state_mapper)]

    def forward_pixel(self, aux, x_pixel):
        sub = x_pixel if self.mapper is None else torch.cat(
            [x_pixel[i:i + 1] for i in self.mapper])
        return mlp_apply(aux, sub)[: self.n_bands]
