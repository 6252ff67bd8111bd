"""Seeded host-transfer-in-jit violations at hand-kernel launch sites: a
def that counts its launch, and a ``kernel_region`` block.  A launch
site's host options (``int(n_iter)``) are not device values."""

import torch

from . import _build


def leaky_launch(x, n_iter):
    steps = int(n_iter)
    total = x.sum().item()  # expect: host-transfer-in-jit
    _build.count_launch(leaky_launch)
    return total + steps


def region_launch(x):
    with _build.kernel_region("fused_gn"):
        host = x.cpu()  # expect: host-transfer-in-jit
        scale = torch.tensor(2.0, device=x.device)  # expect: host-transfer-in-jit
    return host * scale


def compliant_launch(x, block: int):
    grid = int(x.shape[0]) // block
    _build.count_launch(compliant_launch)
    return grid
