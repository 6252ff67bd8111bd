"""A GP emulator bank's value and Jacobian in row layout, one kernel
launch per Gauss-Newton trip of the row loop (``csrc/gp_rows.cu``).

No TPU kernel stands behind it: the JAX package leaves the bank's
linearisation to ``jax.jacfwd`` under XLA.  Eagerly, ``torch.func`` runs
it over ``(block, p, m, k)`` tangents per band, then ``jac_to_rows``
relays the ``(B, n, p)`` Jacobian; the kernel evaluates the closed form
(gp_emulator's ``predict(..., do_deriv)``) per pixel and writes the rows
the fused update takes.

- :func:`linearize_rows_plain` — the closed form in plain PyTorch, on any
  device, in sequential blocks of pixels when ``linearize_block`` asks.
- :func:`gp_linearize_rows` — the wrapper: CPU tensors run the plain
  version, CUDA tensors launch the kernel or raise.
  ``gp_linearize_rows.launches`` counts kernel launches.
- :func:`mapper_table` — the bank's per-band input indices, the identity
  where the operator has no ``state_mappers``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

#: the kernel's runtime limits: GP inputs per band and bands.
MAX_INPUTS = 16
MAX_BANDS = 32


def mapper_table(op, k: int) -> np.ndarray:
    """``(bands, k)`` int32: band b's GP input d is state entry
    ``table[b, d]``."""
    if op.mappers is None:
        if k != op.n_params:
            raise ValueError(f"an unmapped GP bank takes the whole state: "
                             f"{k} inputs for {op.n_params} parameters")
        return np.tile(np.arange(k, dtype=np.int32), (op.n_bands, 1))
    table = np.asarray(op.mappers, np.int32)
    if table.shape != (op.n_bands, k):
        raise ValueError(f"state_mappers has shape {table.shape}, the bank "
                         f"takes {(op.n_bands, k)}")
    if table.min() < 0 or table.max() >= op.n_params:
        raise ValueError("state_mappers index outside the state")
    return table


def check_inputs(op, aux, x_rows, dtype=torch.float32) -> tuple:
    """``(bank, bands, m, k)``: the bank ``aux`` with every leaf a
    contiguous ``dtype`` tensor on ``x_rows``' device (the leaves as they
    are where they already are so), its sizes checked against the
    operator's and the kernel's; raises unless ``x_rows`` is a contiguous
    ``dtype`` ``(p, n)`` tensor."""
    if aux is None:
        raise ValueError("a GP bank operator needs its bank as aux")
    if not isinstance(x_rows, torch.Tensor) or x_rows.ndim != 2:
        raise ValueError("x_rows must be a (p, n) tensor")
    dev = x_rows.device
    if dtype == torch.float32:
        _build.check_rows("x_rows", x_rows, op.n_params, x_rows.shape[1],
                          dev)
    elif x_rows.dtype != dtype or x_rows.shape[0] != op.n_params:
        raise ValueError(f"x_rows must be ({op.n_params}, n) {dtype}")
    bank = type(aux)(*(torch.as_tensor(leaf).to(
        device=dev, dtype=dtype).contiguous() for leaf in aux))
    if bank.x_train.ndim != 3:
        raise ValueError("the bank's x_train must be (bands, m, k)")
    bands, m, k = (int(v) for v in bank.x_train.shape)
    if bands != op.n_bands:
        raise ValueError(f"emulator bank carries {bands} band(s) but the "
                         f"operator expects {op.n_bands}")
    if not (1 <= k <= MAX_INPUTS and 1 <= bands <= MAX_BANDS and m >= 1):
        raise ValueError(f"the GP row kernel takes 1-{MAX_INPUTS} inputs "
                         f"and 1-{MAX_BANDS} bands, the bank has {k} and "
                         f"{bands}")
    shapes = {"alpha": (bands, m), "log_lengthscales": (bands, k),
              "log_amplitude": (bands,), "y_mean": (bands,)}
    for name, shape in shapes.items():
        got = tuple(getattr(bank, name).shape)
        if got != shape:
            raise ValueError(f"the bank's {name} has shape {got}, "
                             f"expected {shape}")
    return bank, bands, m, k


def linearize_rows_plain(op, aux, x_rows, linearize_block=None,
                         dtype=torch.float32):
    """``(h0 (bands, n), jac_rows (bands*p, n))`` by the closed form:
    ``h0 = amp sum_i alpha_i e_i + y_mean``, ``dh0/dx_d = -amp sum_i
    alpha_i e_i (x_d - X_id) / ell_d^2`` with ``e_i = exp(-1/2 sum_d
    ((x_d - X_id) / ell_d)^2)``, in blocks of ``linearize_block``
    pixels, in ``dtype`` (``x_rows``' own)."""
    aux, bands, _, k = check_inputs(op, aux, x_rows, dtype)
    p, n = x_rows.shape
    table = torch.as_tensor(mapper_table(op, k), dtype=torch.long,
                            device=x_rows.device)
    block = n if not linearize_block or int(linearize_block) >= n \
        else int(linearize_block)
    h0 = torch.empty((bands, n), dtype=dtype, device=x_rows.device)
    jac = torch.zeros((bands * p, n), dtype=dtype, device=x_rows.device)
    for b in range(bands):
        ell = torch.exp(aux.log_lengthscales[b])
        amp = torch.exp(aux.log_amplitude[b])
        for lo in range(0, n, block):
            x = x_rows[table[b], lo:lo + block].T            # (B, k)
            d = (x[:, None, :] - aux.x_train[b][None]) / ell  # (B, m, k)
            w = torch.exp(-0.5 * torch.sum(d * d, -1)) * aux.alpha[b]
            h0[b, lo:lo + block] = amp * torch.sum(w, -1) + aux.y_mean[b]
            grad = -amp * torch.sum(w[..., None] * d, 1) / ell  # (B, k)
            jac[b * p:(b + 1) * p, lo:lo + block].index_add_(
                0, table[b], grad.T)
    return h0, jac


def _launch_cuda(op, aux, x_rows):
    """Launch ``csrc/gp_rows.cu`` on the current stream of ``x_rows``'
    device (no sync), inside a device-timed ``gp_rows`` span."""
    from ..telemetry import get_registry, span
    from .device_constants import device_constant

    aux, bands, m, k = check_inputs(op, aux, x_rows)
    p, n = x_rows.shape
    dev = x_rows.device
    table = device_constant(mapper_table(op, k), torch.int32, dev)
    h0 = torch.empty((bands, n), dtype=torch.float32, device=dev)
    jac = torch.empty((bands * p, n), dtype=torch.float32, device=dev)
    lib = _build.load("gp_rows")
    fn = lib.kafka_gp_rows
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p])
    with span("gp_rows", per_date=True, device=dev), \
            _build.on_device(dev) as stream:
        rc = fn(x_rows.data_ptr(), p, aux.x_train.data_ptr(),
                aux.alpha.data_ptr(), aux.log_lengthscales.data_ptr(),
                aux.log_amplitude.data_ptr(), aux.y_mean.data_ptr(),
                table.data_ptr(), bands, m, k, h0.data_ptr(),
                jac.data_ptr(), n, stream)
    if rc == -1:
        raise ValueError(f"gp_rows: sizes outside the kernel's: p {p}, "
                         f"bands {bands}, m {m}, k {k}")
    _build.raise_on_error(lib, rc, "gp_rows")
    _build.count_launch(gp_linearize_rows)
    get_registry().counter(
        "kafka_gp_rows_launches_total",
        "launches of the GP emulator bank's row kernel (csrc/gp_rows.cu), "
        "one a row-loop Gauss-Newton trip").inc()
    return h0, jac


def kernel_attributes(k: int) -> dict:
    """Registers, spill bytes, static shared bytes and threads per block
    of the compiled instance for ``k`` inputs (builds it if needed)."""
    return _build.attributes("gp_rows", "kafka_gp_rows_attributes", k)


def gp_linearize_rows(op, aux, x_rows, linearize_block=None):
    """``(h0 (bands, n), jac_rows (bands*p, n))`` of ``GPBankOperator``
    ``op`` with bank ``aux`` at the row-layout state ``x_rows`` (p, n),
    row ``b*p + j`` of ``jac_rows`` holding dh0[b]/dx[j]: the plain
    version on the CPU (blocked by ``linearize_block``), the kernel on a
    card (one launch over every pixel, whatever the block)."""
    dev = x_rows.device
    with _build.kernel_region("gp_rows"):
        if dev.type == "cpu":
            return linearize_rows_plain(op, aux, x_rows, linearize_block)
        if dev.type == "cuda":
            return _launch_cuda(op, aux, x_rows)
    raise ValueError(f"no GP bank row linearisation for {dev}")


#: CUDA kernel launches of this process (plain-version calls excluded).
gp_linearize_rows.launches = 0
