"""Batched small-matrix linear algebra (port of ``kafka_tpu/core/linalg.py``).

The packed Cholesky and the substitution work on lists of same-shape
batch vectors, so one implementation serves the ``(n,)`` batch layout of
the plain solver and the ``(n,)`` lane rows of the fused kernel's plain
version; ``csrc/fused_gn.cu`` and ``csrc/packed_chol.cuh`` (shared by
the fused update and the packed solve) mirror the same loops as device
code.
"""

from __future__ import annotations

import functools
import math

import torch

from ..telemetry.spans import span

# The unrolled elementwise factorisation covers the small states (p=7
# TIP, p=10 PROSAIL, p=11 joint); larger blocks (the p=21 Ross-Li
# kernel-weight state) go to torch.linalg, as the JAX package's go to
# XLA's Cholesky.
UNROLL_MAX_P = 16


def solve_chol_vectors(l, b_vectors):
    """Forward + back substitution against a packed lower factor ``l``
    (list of lists); ``b_vectors`` is a list of p batch vectors."""
    p = len(l)
    y = [None] * p
    for i in range(p):
        s = b_vectors[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return x


def _solve_chol_unrolled(l, b: torch.Tensor) -> torch.Tensor:
    p = len(l)
    return torch.stack(solve_chol_vectors(l, [b[..., i] for i in range(p)]),
                       dim=-1)


def cholesky_packed(a_packed):
    """Cholesky of a packed symmetric list-of-lists ``a_packed[i][j]`` of
    batch vectors (j <= i read).  Returns the lower factor, same form."""
    p = len(a_packed)
    l = [[None] * p for _ in range(p)]
    for j in range(p):
        d = a_packed[j][j]
        for k in range(j):
            d = d - l[j][k] * l[j][k]
        ljj = torch.sqrt(d)
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, p):
            s = a_packed[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    return l


def solve_spd_packed(a_packed, b: torch.Tensor) -> torch.Tensor:
    """Solve against a packed symmetric batch; ``b`` (..., p)."""
    return _solve_chol_unrolled(cholesky_packed(a_packed), b)


def pack_symmetric(a: torch.Tensor):
    """(..., p, p) dense -> packed list-of-lists view (lower + mirrored)."""
    p = a.shape[-1]
    out = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            out[i][j] = out[j][i] = a[..., i, j]
    return out


def tri_rows(p: int) -> int:
    return p * (p + 1) // 2


@functools.lru_cache(maxsize=None)
def _gather_index(p: int, kind: str, device: torch.device) -> torch.Tensor:
    """The gather index of ``pack_rows`` (``kind="pack"``: the flat
    ``i * p + j`` of each packed row ``i (i + 1) / 2 + j``, j <= i) or of
    ``unpack_rows`` (``"unpack"``: the packed row of each dense entry
    ``(i, j)``, mirrored), made once per p and device."""
    if kind == "pack":
        idx = [i * p + j for i in range(p) for j in range(i + 1)]
    else:
        idx = [max(i, j) * (max(i, j) + 1) // 2 + min(i, j)
               for i in range(p) for j in range(p)]
    return torch.tensor(idx, dtype=torch.long, device=device)


def pack_rows(a: torch.Tensor) -> torch.Tensor:
    """Dense ``(n, p, p)`` -> ``(p(p+1)/2, n)`` float32 lower-triangle rows,
    one indexed gather over the flattened ``(n, p*p)`` batch (a broadcast
    prior stays a view until the gather); a ``row_layout`` span, timed
    on the device inside a date."""
    n, p = a.shape[0], a.shape[-1]
    with span("row_layout", per_date=True, device=a.device):
        flat_t = a.reshape(n, p * p).T
        return flat_t.index_select(0, _gather_index(p, "pack", a.device)) \
            .to(torch.float32)


def unpack_rows(rows: torch.Tensor) -> torch.Tensor:
    """``(p(p+1)/2, n)`` packed rows -> dense ``(n, p, p)``, one indexed
    gather (bit-identical copies of the packed entries); a
    ``row_layout`` span like :func:`pack_rows`."""
    n_coeff, n = rows.shape
    p = (math.isqrt(8 * n_coeff + 1) - 1) // 2
    if tri_rows(p) != n_coeff:
        raise ValueError(f"{n_coeff} rows is not a packed triangle")
    with span("row_layout", per_date=True, device=rows.device):
        return rows.T.index_select(
            1, _gather_index(p, "unpack", rows.device)).view(n, p, p)


def unpack_symmetric(a_packed) -> torch.Tensor:
    """Packed list-of-lists of ``(n,)`` vectors -> dense ``(n, p, p)``."""
    p = len(a_packed)
    return unpack_rows(torch.stack([a_packed[i][j] for i in range(p)
                                    for j in range(i + 1)]))


def cholesky_dense(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a batch of dense SPD matrices with the
    semantics of ``jax.lax.linalg.cholesky``: the input is symmetrised
    as ``(a + a^T) / 2`` first, and a matrix that is not positive
    definite yields a factor of NaN instead of an error.
    ``cholesky_ex`` does not check ``info``, so nothing syncs the
    device; its partial factor on such a matrix is masked here."""
    chol, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return torch.where((info != 0)[..., None, None],
                       torch.full((), float("nan"), dtype=chol.dtype,
                                  device=chol.device), chol)


def _solve_chol_dense(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``L L^T X = B`` by two triangular solves; ``b`` (..., p, k)."""
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def solve_spd_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a[i] x[i] = b[i]`` for a batch of SPD matrices: the
    unrolled packed Cholesky up to ``UNROLL_MAX_P``, the dense library
    factor above it (NaN for a non-PD pixel, as in the JAX package)."""
    if a.shape[-1] <= UNROLL_MAX_P:
        return _solve_chol_unrolled(cholesky_packed(pack_symmetric(a)), b)
    return _solve_chol_dense(cholesky_dense(a), b[..., None])[..., 0]


def solve_batched(a: torch.Tensor, b: torch.Tensor,
                  block: int = None) -> torch.Tensor:
    """General batched solve (LU) for non-symmetric per-pixel systems —
    the exact information-filter propagator's ``(I + P^-1 Q) X = P^-1``.
    ``block`` bounds the pixels handed to one ``torch.linalg.solve`` call
    (its LU workspace grows with the batch), as the JAX ``solve_batched``
    bounds its ``lax.map`` slices."""
    n = a.shape[0]
    if block is None or n <= block:
        return torch.linalg.solve(a, b)
    return torch.cat([torch.linalg.solve(a[s:s + block], b[s:s + block])
                      for s in range(0, n, block)])


def spd_inverse_batched(a: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse via Cholesky."""
    p = a.shape[-1]
    if p <= UNROLL_MAX_P:
        l = cholesky_packed(pack_symmetric(a))
        eye = torch.eye(p, dtype=a.dtype, device=a.device)
        cols = [
            _solve_chol_unrolled(l, eye[j].expand(a.shape[:-2] + (p,)))
            for j in range(p)
        ]
        return torch.stack(cols, dim=-1)
    eye = torch.eye(p, dtype=a.dtype, device=a.device).expand(a.shape)
    return _solve_chol_dense(cholesky_dense(a), eye)


#: Matrices per batched ``torch.linalg.eigh`` call: cuSOLVER's batched
#: eigensolver (``cusolverDnXsyevBatched``, CUDA 12.8) refuses a tile's
#: batch with CUSOLVER_STATUS_INVALID_VALUE (chip_smoke.py's phase
#: hessian records a batch of this size and of twice it).
EIGH_BLOCK = 16384


def eigh_blocked(a: torch.Tensor):
    """``torch.linalg.eigh`` of a ``(n, p, p)`` batch in ``EIGH_BLOCK``
    slices: ``(w (n, p) ascending, v (n, p, p))``."""
    if a.shape[0] <= EIGH_BLOCK:
        return torch.linalg.eigh(a)
    parts = [torch.linalg.eigh(a[s:s + EIGH_BLOCK])
             for s in range(0, a.shape[0], EIGH_BLOCK)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([v for _, v in parts]))


def batched_diag(d: torch.Tensor) -> torch.Tensor:
    """``(..., p)`` diagonals -> ``(..., p, p)`` diagonal matrices."""
    return torch.diag_embed(d)


def batched_diagonal(a: torch.Tensor) -> torch.Tensor:
    """``(..., p, p)`` -> ``(..., p)`` main diagonals."""
    return torch.diagonal(a, dim1=-2, dim2=-1)
