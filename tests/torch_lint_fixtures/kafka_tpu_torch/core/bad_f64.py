"""Seeded implicit-f64 violations (device-code module by path)."""

import numpy as np
import torch


def promote(x):
    a = np.asarray(x, np.float64)  # expect: implicit-f64
    b = torch.zeros(4, dtype=torch.float64)  # expect: implicit-f64
    c = x.double()  # expect: implicit-f64
    d = torch.zeros(4, dtype=torch.double)  # expect: implicit-f64
    e = torch.ones(3, dtype=float)  # expect: implicit-f64
    f = torch.as_tensor(np.linspace(0.0, 1.0, 5))  # expect: implicit-f64
    g = torch.from_numpy(np.zeros(3))  # expect: implicit-f64
    h = np.zeros(2, dtype="float64")  # expect: implicit-f64
    ok_dtype = torch.as_tensor(np.linspace(0.0, 1.0, 5),
                               dtype=torch.float32)
    ok_numpy_dtype = torch.from_numpy(np.zeros(3, np.float32))
    ok_literal = torch.tensor(0.5)  # default dtype float32: no promotion
    ok_float = x.float()
    return a, b, c, d, e, f, g, h, ok_dtype, ok_numpy_dtype, ok_literal, \
        ok_float
