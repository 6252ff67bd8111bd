"""PROSAIL's value and Jacobian in row layout, one kernel launch per
Gauss-Newton trip of the row loop (``csrc/prosail_rows.cu``).

No TPU kernel stands behind it: the JAX package leaves the PROSAIL
linearisation to ``jax.jacfwd`` under XLA.  Eagerly, ``torch.func``
runs it as thousands of small kernels per block of pixels, dispatched
by the host, then ``jac_to_rows`` relays the ``(B, n, p)`` Jacobian;
the kernel evaluates the closed form and its derivatives per pixel in
registers and writes the rows the fused update takes.

- :func:`linearize_rows_plain` — the row loop's path for every other
  operator, on any device: ``ProsailOperator.linearize`` (in sequential
  blocks when ``linearize_block`` asks for it), then ``jac_to_rows``.
- :func:`prosail_linearize_rows` — the wrapper: CPU tensors run the
  plain version, CUDA tensors launch the kernel or raise.
  ``prosail_linearize_rows.launches`` counts kernel launches.
- :func:`constants` — the kernel's per-band constants, cast to float32
  where the operator casts them.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build

#: the operator's bands and state entries: the kernel's only shape.
N_BANDS = 10
N_PARAMS = 10

#: devices whose __constant__ block holds ``constants()``.
_CONSTANTS_SET: set = set()
_CONSTANTS_LOCK = threading.Lock()


def constants() -> np.ndarray:
    """The kernel's ``ProsailConstants`` as float32, in its field order:
    BAND_K (5 x 10), tav(40), tav(90), N_REFRACT, the dry and the wet
    soil spectra, the bf cubic (highest power first)."""
    from ..obsops.prosail import _BF_POLY, _TAV40, _TAV90
    from ..obsops.prospect_data import (BAND_K, N_REFRACT, SOIL_DRY,
                                        SOIL_WET)

    return np.concatenate([
        np.asarray(a, np.float32).ravel()
        for a in (BAND_K, _TAV40, _TAV90, N_REFRACT, SOIL_DRY, SOIL_WET,
                  _BF_POLY)])


def check_inputs(op, x_rows) -> None:
    """Raise unless ``op`` has the kernel's 10 bands and 10 state entries
    and ``x_rows`` is a contiguous float32 ``(10, n)`` tensor."""
    if (op.n_bands, op.n_params) != (N_BANDS, N_PARAMS):
        raise ValueError(
            f"the PROSAIL row kernel takes {N_BANDS} bands and "
            f"{N_PARAMS} state entries, the operator has {op.n_bands} and "
            f"{op.n_params}")
    if not isinstance(x_rows, torch.Tensor) or x_rows.ndim != 2:
        raise ValueError("x_rows must be a (p, n) tensor")
    _build.check_rows("x_rows", x_rows, N_PARAMS, x_rows.shape[1],
                      x_rows.device)


def angle_steps(aux, n: int, dev) -> list:
    """``[(tensor, step), ...]`` of sza, vza, raa: a 0-d angle is read
    with step 0, a per-pixel ``(n,)`` one with step 1; anything else
    raises."""
    out = []
    for name, a in zip(("sza", "vza", "raa"), aux):
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got "
                            f"{type(a).__name__}")
        if a.device != dev:
            raise ValueError(f"{name} lies on {a.device}, expected {dev}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.ndim == 0:
            out.append((a, 0))
        elif tuple(a.shape) == (n,) and a.is_contiguous():
            out.append((a, 1))
        else:
            raise ValueError(f"{name} must be 0-d or a contiguous ({n},) "
                             f"tensor, got shape {tuple(a.shape)}")
    return out


def linearize_rows_plain(op, aux, x_rows, linearize_block=None):
    """``(h0 (10, n), jac_rows (100, n))`` by ``op.linearize``, blocked
    as the row loop blocks every other operator's
    (``solvers.linearize_rows``)."""
    from .solvers import linearize_rows

    return linearize_rows(op.linearize, aux, x_rows, linearize_block)


def _set_constants(lib, dev) -> None:
    """Fill ``dev``'s __constant__ block once (``dev`` current)."""
    with _CONSTANTS_LOCK:
        if dev.index in _CONSTANTS_SET:
            return
        values = np.ascontiguousarray(constants())
        fn = lib.kafka_prosail_rows_constants
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        rc = fn(values.ctypes.data, values.size)
        if rc == -1:
            raise RuntimeError("prosail_rows: the constant block's size "
                               "differs from the kernel's")
        _build.raise_on_error(lib, rc, "prosail_rows constants")
        _CONSTANTS_SET.add(dev.index)


def _launch_cuda(op, aux, x_rows):
    """Launch ``csrc/prosail_rows.cu`` on the current stream of
    ``x_rows``' device (no sync)."""
    from .device_constants import device_constant

    n = x_rows.shape[1]
    dev = x_rows.device
    if aux is None:
        aux = tuple(device_constant(v, torch.float32, dev)
                    for v in (30.0, 0.0, 0.0))
    angles = angle_steps(aux, n, dev)
    h0 = torch.empty((N_BANDS, n), dtype=torch.float32, device=dev)
    jac = torch.empty((N_BANDS * N_PARAMS, n), dtype=torch.float32,
                      device=dev)
    lib = _build.load("prosail_rows")
    fn = lib.kafka_prosail_rows
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_void_p, ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_void_p])
    with _build.on_device(dev) as stream:
        _set_constants(lib, dev)
        rc = fn(x_rows.data_ptr(),
                *(v for a, step in angles for v in (a.data_ptr(), step)),
                op.hotspot, h0.data_ptr(), jac.data_ptr(), n, stream)
    _build.raise_on_error(lib, rc, "prosail_rows")
    _build.count_launch(prosail_linearize_rows)
    return h0, jac


def kernel_attributes() -> dict:
    """Registers, spill bytes, static shared bytes and threads per block
    of the compiled kernel (builds it if needed)."""
    return _build.attributes("prosail_rows", "kafka_prosail_rows_attributes")


def prosail_linearize_rows(op, aux, x_rows, linearize_block=None):
    """``(h0 (10, n), jac_rows (100, n))`` of ``ProsailOperator`` ``op``
    at the row-layout state ``x_rows`` (10, n), row ``b*10 + k`` of
    ``jac_rows`` holding dh0[b]/dx[k]: the plain version on the CPU
    (blocked by ``linearize_block``), the kernel on a card (one launch
    over every pixel, whatever the block)."""
    check_inputs(op, x_rows)
    dev = x_rows.device
    with _build.kernel_region("prosail_rows"):
        if dev.type == "cpu":
            return linearize_rows_plain(op, aux, x_rows, linearize_block)
        if dev.type == "cuda":
            return _launch_cuda(op, aux, x_rows)
    raise ValueError(f"no PROSAIL row linearisation for {dev}")


#: CUDA kernel launches of this process (plain-version calls excluded).
prosail_linearize_rows.launches = 0
