"""Identity / selection observation operators for linear testing (port of
``kafka_tpu/obsops/identity.py``): each band observes one chosen state
parameter directly (the plain identity is ``obs_indices = (0,)`` on a
1-parameter state)."""

from __future__ import annotations

import torch

from .protocol import ObservationModel


class IdentityOperator(ObservationModel):
    def __init__(self, n_params: int, obs_indices=(0,)):
        self.n_params = n_params
        self.obs_indices = tuple(int(i) for i in obs_indices)
        self.n_bands = len(self.obs_indices)

    def forward_pixel(self, aux, x_pixel):
        return torch.stack([x_pixel[i] for i in self.obs_indices])
