"""Seeded host-transfer-in-jit violations inside ``torch.func``
regions, and an explicit read in a device-code module outside any
region.  ``clip_low`` lives in another module: a helper a region calls
runs inside the transform, so its copy is flagged there."""

import torch
from torch import func as tfunc
from torch.func import jacfwd, vmap

from ..obsops.bad_helpers import clip_low


def per_pixel(x):
    n = float(x[0])  # expect: host-transfer-in-jit
    k = int(x.shape[0])  # a shape is host metadata: fine
    v = x.sum().item()  # expect: host-transfer-in-jit
    return clip_low(x, 0.0) * n + v + k


def linearize(x):
    return vmap(jacfwd(per_pixel))(x)


def scaled(x):
    def body(z):
        return z * torch.as_tensor(0.5, device=z.device)  # expect: host-transfer-in-jit

    return tfunc.vmap(body)(x)


def host_side(x):
    n = float(x.shape[0])
    return x.tolist(), n  # expect: host-transfer-in-jit
