"""Host constants as device tensors, made once per device.

The JAX programs hold their constants (clip limits, PROSAIL's spectra,
the state bounds) on the device: tracing folds them into the program.
An eager torch program that writes ``torch.as_tensor(c, device=dev)``
copies ``c`` from the host on every call instead, and on the card each
such copy waits for the stream to drain.  :func:`device_constant` makes
the tensor once per ``(value, dtype, device)`` and hands back the same
tensor afterwards, so a device path makes no host-to-device copy of a
constant after its first call.

A cached tensor is a plain constant: it is made with ``torch.func``'s
transforms switched off, so it carries no tangent under
``torch.func.jacfwd`` and no batch dimension under ``torch.func.vmap``,
whichever transform was running when it was first asked for.  It is
made on the device's current stream, which is the stream every launch
of the port uses (``core._build.on_device``).  Callers never write to
it.

The key is the value's bytes, not its identity: a clip limit computed
per call (``1.0 - eps``) finds its entry, ``0.0`` and ``-0.0`` keep
theirs, and an array rebuilt per call does not grow the cache.  Only
scalars and arrays of at most ``MAX_ELEMENTS`` elements are constants;
a larger array is an input, and the caller moves it.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

#: the largest host array taken as a constant (PROSAIL's absorption
#: table is 5 x 10; a per-pixel bounds array is an input).
MAX_ELEMENTS = 4096

_CACHE: Dict[Tuple, torch.Tensor] = {}
_LOCK = threading.Lock()


def _key(value, dtype, device) -> Tuple:
    arr = np.asarray(value)
    if arr.size > MAX_ELEMENTS:
        raise ValueError(f"a host array of {arr.size} elements is an input, "
                         f"not a constant (at most {MAX_ELEMENTS})")
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"not a numeric constant: {type(value).__name__}")
    return (arr.dtype.str, arr.shape, arr.tobytes(), dtype,
            torch.device(device))


def _make(value, dtype, device) -> torch.Tensor:
    # Made outside torch.func's transforms (a factory called inside
    # jacfwd returns a wrapper of the transform's level, dead once the
    # transform returns) and outside inference mode (later callers
    # differentiate through it): a plain tensor, whoever asks first.
    with torch._C._DisableFuncTorch(), torch.inference_mode(False):
        if np.ndim(value) == 0:
            return torch.full((), np.asarray(value)[()], dtype=dtype,
                              device=device)
        # kafkalint: disable=host-transfer-in-jit — the one copy of this
        # constant to this device; later calls take the cached tensor.
        return torch.as_tensor(np.asarray(value), dtype=dtype,
                               device=device)


def device_constant(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` (a Python number, a numpy scalar or a numpy array of at
    most MAX_ELEMENTS elements) as a ``dtype`` tensor on ``device``: the
    same tensor on every call with the same value, dtype and device.  A
    tensor is returned as ``torch.as_tensor(value, dtype, device)``
    returns it (no copy when it is already there)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    key = _key(value, dtype, device)
    t = _CACHE.get(key)
    if t is None:
        with _LOCK:
            t = _CACHE.get(key)
            if t is None:
                t = _CACHE[key] = _make(value, dtype, device)
    return t
