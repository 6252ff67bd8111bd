"""Packed Cholesky factor and substitution per pixel as one kernel launch
(port of ``kafka_tpu/core/pallas_solve.py:solve_rows`` and its Pallas
kernel ``_solve_kernel``, with ``solve_spd_packed_pallas``).

- :func:`solve_rows_plain` — the plain PyTorch version (``linalg``'s
  packed Cholesky and substitution on the rows), any device and dtype;
- :func:`solve_rows` — the JAX signature: CPU tensors run the plain
  version, CUDA tensors launch ``csrc/solve_rows.cu`` (p in
  ``INSTANCES``) or raise.  ``solve_rows.launches`` counts launches;
- :func:`solve_spd_packed_kernel` — the drop-in for
  ``linalg.solve_spd_packed`` (``solve_spd_packed_pallas`` in the JAX
  package).
"""

from __future__ import annotations

import ctypes

import torch

from .linalg import cholesky_packed, solve_chol_vectors, tri_rows

#: state sizes of the CUDA kernel's instances.
INSTANCES = (2, 7, 10)


def check_instance(p: int) -> None:
    """Raise unless the CUDA kernel has an instance for ``p``."""
    if p not in INSTANCES:
        raise NotImplementedError(
            f"the CUDA packed solve has no instance for p={p}; instances: "
            f"{INSTANCES}")


def solve_rows_plain(a_rows, b_rows):
    """Plain version: ``a_rows`` (tri(p), n) packed lower triangle,
    ``b_rows`` (p, n) -> x (p, n)."""
    p = b_rows.shape[0]
    a_pk = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            a_pk[i][j] = a_pk[j][i] = a_rows[i * (i + 1) // 2 + j]
    l = cholesky_packed(a_pk)
    return torch.stack(solve_chol_vectors(l, [b_rows[i] for i in range(p)]))


def _launch_cuda(a_rows, b_rows):
    """Launch ``csrc/solve_rows.cu`` on the current stream (no sync)."""
    from . import _build

    p, n = b_rows.shape
    check_instance(p)
    dev = b_rows.device
    _build.check_rows("a_rows", a_rows, tri_rows(p), n, dev)
    _build.check_rows("b_rows", b_rows, p, n, dev)
    x = torch.empty((p, n), dtype=torch.float32, device=dev)
    lib = _build.load("solve_rows")
    fn = lib.kafka_solve_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    rc = fn(p, a_rows.data_ptr(), b_rows.data_ptr(), x.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, rc, "solve_rows")
    solve_rows.launches += 1
    return x


def kernel_attributes(p: int) -> dict:
    """Registers, spill bytes, static shared bytes and threads per block
    of the compiled p instance (builds it if needed)."""
    from . import _build

    check_instance(p)
    return _build.attributes("solve_rows", "kafka_solve_rows_attributes", p)


def solve_rows(a_rows, b_rows, block: int = 1024):
    """Solve the packed batch in row layout: ``a_rows`` (tri(p), n),
    ``b_rows`` (p, n) -> x (p, n).  ``block`` is accepted for the JAX
    signature only."""
    if tri_rows(b_rows.shape[0]) != a_rows.shape[0]:
        raise ValueError(f"{a_rows.shape[0]} coefficient rows for "
                         f"p={b_rows.shape[0]}")
    dev = b_rows.device
    if dev.type == "cpu":
        return solve_rows_plain(a_rows, b_rows)
    if dev.type == "cuda":
        return _launch_cuda(a_rows, b_rows)
    raise ValueError(f"no packed solve for {dev}")


#: CUDA kernel launches of this process (plain-version calls excluded).
solve_rows.launches = 0


def solve_spd_packed_kernel(a_packed, b: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``linalg.solve_spd_packed``: packed list-of-lists ``A``
    of ``(n,)`` vectors and ``b`` (n, p) -> x (n, p)."""
    p = len(a_packed)
    a_rows = torch.stack([a_packed[i][j] for i in range(p)
                          for j in range(i + 1)]).to(torch.float32)
    return solve_rows(a_rows, b.T.to(torch.float32).contiguous()).T
