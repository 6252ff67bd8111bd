"""Helpers of the seeded regions: ``clip_low`` is called from a
``torch.func`` region in ``core/bad_region.py`` (the ROADMAP 10h shape:
a host constant copied to the device on every call)."""

import torch


def clip_low(x, c):
    return torch.maximum(x, torch.as_tensor(c, dtype=x.dtype, device=x.device))  # expect: host-transfer-in-jit


def unused_helper(x, c):
    # Called from no region: no finding.
    return torch.as_tensor(c, device=x.device)
