"""Seeded nonfinite-launder violations (outside the solver_health
sanctuary): silently replacing NaN/inf with plausible numbers instead
of raising a solve-health verdict."""

import numpy as np
import torch


def launder(x, fallback):
    a = torch.nan_to_num(x)  # expect: nonfinite-launder
    b = torch.where(torch.isnan(x), fallback, x)  # expect: nonfinite-launder
    c = torch.where(~torch.isfinite(x), 0.0, x)  # expect: nonfinite-launder
    d = x.nan_to_num(0.0)  # expect: nonfinite-launder
    e = torch.where(x.isinf(), 0.0, x)  # expect: nonfinite-launder
    ok_select = torch.where(x > 0, fallback, x)
    ok_probe = torch.isfinite(x)  # detection alone raises no verdict lie
    ok_host = np.nan_to_num(np.zeros(2))  # numpy on the host: out of scope
    return a, b, c, d, e, ok_select, ok_probe, ok_host
