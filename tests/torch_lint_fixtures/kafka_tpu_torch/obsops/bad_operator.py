"""An operator overriding ``forward_pixel``: its body and the methods it
calls on ``self`` run inside the protocol's transform."""

import torch

from .bad_protocol import Model


class Operator(Model):
    def forward_pixel(self, aux, x):
        return self._band(x) + torch.tensor(1.0, device=x.device)  # expect: host-transfer-in-jit

    def _band(self, x):
        return x * x.max().item()  # expect: host-transfer-in-jit
