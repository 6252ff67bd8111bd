"""Batched small-matrix linear algebra (port of ``kafka_tpu/core/linalg.py``).

The packed Cholesky and the substitution work on lists of same-shape
batch vectors, so one implementation serves the ``(n,)`` batch layout of
the plain solver and the ``(n,)`` lane rows of the fused kernel's plain
version; ``csrc/fused_gn.cu`` mirrors the same loops as device code.
"""

from __future__ import annotations

import torch

# The unrolled elementwise factorisation covers every real state (p=7
# TIP, p=10 PROSAIL); larger blocks go to torch.linalg.
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


def unpack_symmetric(a_packed) -> torch.Tensor:
    """Packed list-of-lists -> dense (..., p, p)."""
    p = len(a_packed)
    rows = [torch.stack([a_packed[i][j] for j in range(p)], dim=-1)
            for i in range(p)]
    return torch.stack(rows, dim=-2)


def solve_spd_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a[i] x[i] = b[i]`` for a batch of SPD matrices."""
    if a.shape[-1] <= UNROLL_MAX_P:
        return _solve_chol_unrolled(cholesky_packed(pack_symmetric(a)), b)
    chol = torch.linalg.cholesky(a)
    return torch.cholesky_solve(b[..., None], chol)[..., 0]


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
    return torch.cholesky_inverse(torch.linalg.cholesky(a))


def batched_diag(d: torch.Tensor) -> torch.Tensor:
    """``(..., p)`` diagonals -> ``(..., p, p)`` diagonal matrices."""
    return torch.diag_embed(d)


def batched_diagonal(a: torch.Tensor) -> torch.Tensor:
    """``(..., p, p)`` -> ``(..., p)`` main diagonals."""
    return torch.diagonal(a, dim1=-2, dim2=-1)
