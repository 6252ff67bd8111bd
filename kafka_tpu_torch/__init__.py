"""kafka_tpu_torch — the PyTorch/CUDA port of kafka_tpu for NVIDIA Hopper.

A per-pixel linearised Kalman/information filter for satellite raster
time series, module for module beside the JAX package (``kafka_tpu``),
which stays the reference.  Plain tensor code is PyTorch; the kernels
the JAX package wrote in Pallas are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built at first use (``core/_build.py``).

Device rule: every entry point takes ``device=None``, which means CUDA.
Without a CUDA device the entry point raises — it never continues on
the CPU unless the caller asks for ``device="cpu"`` explicitly (the
tests do).  On CPU tensors a kernel wrapper runs the kernel's plain
PyTorch version; on CUDA tensors it launches the kernel or raises.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``kafka_tpu``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Full float32 in every contraction.  The normal equations add
# R^-1 ~ 1e5 .. 1e6 weighted Jacobian products to prior information of
# order 1: TF32 keeps 10 mantissa bits, and its rounding error there
# exceeds the prior's small eigenvalues, making A numerically indefinite
# and the Cholesky NaN — the failure the JAX package rules out with
# Precision.HIGHEST (kafka_tpu/core/solvers.py:72-76).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA.  Raises when the resolved device is CUDA and no
    CUDA device is available: the port never falls back to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kafka_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


# The flat re-exports of ``kafka_tpu/__init__.py``.  Imported after
# ``resolve_device``, which the core modules call.
from .core import (  # noqa: E402
    BandBatch,
    GaussianState,
    Linearization,
    PixelPrior,
    iterate_time_grid,
    tip_prior,
)
