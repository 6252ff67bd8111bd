"""The plain reference filter: a linearised Gauss-Newton analysis per date
and the verdict bits of each window, over a pixel batch in any dtype.

Per pixel and trip, at the iterate ``x`` with value ``h0`` and Jacobian
``J`` (one reverse pass per band):

    A   = P_f^-1 + sum_b w_b J_b J_b^T
    rhs = P_f^-1 x_f + sum_b w_b J_b (y_b + J_b x - h0_b)   (observed b)
    x  <- clip(x + relaxation (A^-1 rhs - x), lower, upper)

The posterior information is the last trip's ``A``.  Trips stop once a
convergence group's summed squared step, times the group's ``scale``,
falls under its threshold after ``min_iterations`` trips, or after
``max_iterations + 1`` trips.  A group is a set of pixels whose test is
one sum: a cluster of the fused Gauss-Newton kernel, or the whole batch
(estimated from a sample by ``scale``) on the row loop.

Nothing here imports the program.
"""

from __future__ import annotations

import torch

QA_CONVERGED = 1
QA_CAP_BAILOUT = 2
QA_NODATA = 16


def linearize(forward, x):
    """``(h0 (n, B), J (n, B, p))`` of ``forward`` at ``x`` (n, p): one
    reverse pass per band (pixels are independent, so the gradient of a
    band's sum over pixels is each pixel's row of the Jacobian)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        h0 = forward(xg)
        rows = [torch.autograd.grad(h0[:, b].sum(), xg,
                                    retain_graph=b + 1 < h0.shape[1])[0]
                for b in range(h0.shape[1])]
    return h0.detach(), torch.stack(rows, dim=1)


def cholesky_solve(a, b):
    """Solve ``a x = b`` for SPD (n, p, p) ``a`` by an unrolled Cholesky
    factor, elementwise over pixels (works in any dtype)."""
    p = a.shape[-1]
    low = [[None] * p for _ in range(p)]
    for j in range(p):
        s = a[:, j, j]
        for k in range(j):
            s = s - low[j][k] * low[j][k]
        d = torch.sqrt(s)
        low[j][j] = d
        for i in range(j + 1, p):
            s = a[:, i, j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            low[i][j] = s / d
    z = [None] * p
    for i in range(p):
        s = b[:, i]
        for k in range(i):
            s = s - low[i][k] * z[k]
        z[i] = s / low[i][i]
    x = [None] * p
    for i in reversed(range(p)):
        s = z[i]
        for k in range(i + 1, p):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return torch.stack(x, dim=1)


def gn_date(forward, x_f, p_f, y, w, mask, lower, upper, relaxation,
            group, thresh_sq, scale, min_iterations, max_iterations,
            moving_sq, lin_dtype=None):
    """One date's analysis of every pixel.

    ``x_f`` (n, p) and ``p_f`` (n, p, p) are the forecast and its
    information; ``y``, ``w`` (n, B) the observations and their inverse
    variances, ``mask`` (n, B) bool which of them were observed;
    ``lower`` / ``upper`` (p,) the state bounds; ``group`` (n,) long the
    convergence group of each pixel, ``thresh_sq`` (G,) and ``scale``
    (G,) each group's test.  ``lin_dtype`` (default ``x_f``'s dtype)
    is the precision of the operator's value and Jacobian.  Returns
    ``(x, A, verdict)`` with the verdict bits of the date."""
    dt = x_f.dtype
    n_groups = thresh_sq.shape[0]
    yw = torch.where(mask, y, torch.zeros_like(y))
    ww = torch.where(mask, w, torch.zeros_like(w))
    prior_rhs = (p_f @ x_f[:, :, None])[:, :, 0]
    x = x_f.clone()
    a_last = p_f.clone()
    n_done = torch.zeros(n_groups, dtype=torch.long, device=x.device)
    normsq = torch.full((n_groups,), float("inf"), dtype=dt,
                        device=x.device)
    ssq = torch.full((x.shape[0],), float("inf"), dtype=dt,
                     device=x.device)
    for _ in range(int(max_iterations) + 1):
        active_g = ~((normsq < thresh_sq) & (n_done >= min_iterations))
        if not bool(active_g.any()):
            break
        active = active_g[group]
        if lin_dtype is None:
            h0, jac = linearize(forward, x)
        else:
            h0, jac = (t.to(dt) for t in linearize(forward,
                                                   x.to(lin_dtype)))
        y_t = yw + (jac @ x[:, :, None])[:, :, 0] - h0
        y_t = torch.where(mask, y_t, torch.zeros_like(y_t))
        wj = jac * ww[:, :, None]
        a = p_f + wj.transpose(1, 2) @ jac
        rhs = prior_rhs + (wj.transpose(1, 2) @ y_t[:, :, None])[:, :, 0]
        x_raw = cholesky_solve(a, rhs)
        x_new = x + relaxation * (x_raw - x)
        x_new = torch.minimum(torch.maximum(x_new, lower), upper)
        dx2 = (x_new - x) ** 2
        step_sq = torch.zeros(n_groups, dtype=dt, device=x.device) \
            .index_add_(0, group, dx2.sum(dim=1)) * scale
        x = torch.where(active[:, None], x_new, x)
        a_last = torch.where(active[:, None, None], a, a_last)
        ssq = torch.where(active, dx2.sum(dim=1), ssq)
        normsq = torch.where(active_g, step_sq, normsq)
        n_done = n_done + active_g.long()
    observed = mask.any(dim=1)
    bailout = (n_done[group] > max_iterations) & (ssq >= moving_sq) \
        & observed
    verdict = torch.where(
        observed,
        torch.where(bailout, QA_CAP_BAILOUT, QA_CONVERGED),
        QA_NODATA).to(torch.int32)
    return x, a_last, verdict


def merge_verdicts(a, b):
    """A window's verdicts over its dates: bits ORed, NODATA only where
    no date observed."""
    return ((a | b) & ~QA_NODATA) | (a & b & QA_NODATA)
