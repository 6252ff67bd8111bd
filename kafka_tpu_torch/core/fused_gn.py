"""The whole per-date Gauss-Newton solve as one kernel launch (port of
``kafka_tpu/core/pallas_solve.py:fused_gn_rows`` and its Pallas kernel
``_fused_gn_kernel``).

Three layers:

- :func:`fused_gn_raw_plain` — the plain PyTorch version: the same
  row-layout arithmetic, the same convergence groups of ``gcd(n, block)``
  pixels and the same per-group reduction order (per-row sums, then the
  row total) as the TPU kernel.  It runs on any device and in float32
  or float64; the CPU tests hold it against the JAX kernel,
  ``chip_smoke.py`` holds the CUDA kernel against it on the card.
- :func:`fused_gn_raw` — dispatch on where the tensors lie: CPU tensors
  run the plain version; CUDA tensors launch the hand-written kernel
  ``csrc/fused_gn.cu`` (two-stream operator, p=7, 2 bands; one
  thread-block cluster per convergence group, see
  :func:`launch_geometry`) or raise.  There is no fallback from CUDA to
  the plain version.
- :func:`fused_gn_rows` — the entry point with the JAX signature and
  return tuple.  ``fused_gn_rows.launches`` counts kernel launches.

Raw outputs, all float32 rows ``(rows, n)``: ``x`` (p), packed ``A``
(p(p+1)/2), ``fwd`` and ``inn`` (n_bands), ``st`` (2: the group's
executed trip count and final squared step norm, broadcast over the
group) and ``hl`` (2 + p: verdict bitmask, ever-non-finite flag,
per-parameter clipped-on-every-trip flags).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import solver_health
from .linalg import cholesky_packed, solve_chol_vectors, tri_rows


def _idx(i: int, j: int) -> int:
    return i * (i + 1) // 2 + j


def _block(n: int, block: int) -> int:
    return math.gcd(n, min(block, n))


#: threads per CTA and CTAs per cluster at most (csrc/fused_gn.cu:
#: kMaxThreads, kMaxCluster — 8 is the portable cluster size).
MAX_THREADS = 256
MAX_CLUSTER = 8
#: floats of one thread's shared-memory column (csrc/fused_gn.cu:
#: Column<TwoStream>::kRows): y, r_inv, mask, x_f, packed P_f^-1, the
#: prior term P_f^-1 x_f, the last trip's A, fwd and inn, the corruption
#: flag — 81, an odd count.
COLUMN_FLOATS = 81


def launch_geometry(n: int, block: int = 2048) -> dict:
    """How the CUDA kernel covers ``n`` pixels: one thread-block cluster
    per convergence group of ``gcd(n, min(block, n))`` pixels, of
    ``ctas`` = ceil(group / 256) CTAs with ``threads`` threads each
    (ceil(group / ctas) in whole warps, one pixel per thread; threads
    past the group's end only join the sums) and ``smem_bytes`` of
    dynamic shared memory per CTA.  ``geometry`` in ``csrc/fused_gn.cu``
    computes the same; raises ValueError for a group that does not fit
    one portable cluster."""
    group = _block(n, block)
    ctas = -(-group // MAX_THREADS)
    if ctas > MAX_CLUSTER:
        raise ValueError(
            f"a convergence group of {group} px needs {ctas} CTAs of "
            f"{MAX_THREADS} threads; a cluster holds at most {MAX_CLUSTER}")
    per_cta = -(-group // ctas)
    threads = -(-per_cta // 32) * 32
    return {"group": group, "clusters": n // group, "ctas": ctas,
            "threads": threads, "smem_bytes": threads * COLUMN_FLOATS * 4}


def _scalars(tol, numel, relaxation, block: int, n: int, p: int):
    """(relaxation, thresh_sq, moving_sq) as float32, computed in the JAX
    driver's order: the group's share of the global convergence test and
    the per-pixel "still moving" threshold (||dx_i|| / p >= tol)."""
    f32 = np.float32
    thresh = f32(tol) * f32(float(numel)) * f32(block / n)
    moving = f32(tol) * f32(p)
    return f32(relaxation), f32(thresh * thresh), f32(moving * moving)


def _bounds(state_bounds_rows, p: int):
    """None, or a (2, p) float32 numpy array of per-parameter bounds."""
    if state_bounds_rows is None:
        return None
    lo, hi = state_bounds_rows

    def row(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.broadcast_to(np.asarray(v, np.float32), (p,))

    return np.stack([row(lo), row(hi)])


def fused_gn_raw_plain(lin_rows, y, r_inv, mask_f, xf_rows, pf_rows, tol,
                       min_iterations: int, max_iterations: int, relaxation,
                       state_bounds_rows, norm_denominator,
                       block: int = 2048, corrupt=None, scalar_n=None):
    """Plain PyTorch version of the kernel; returns
    ``(x, a, fwd, inn, st, hl)`` rows.  All pixels step together; a
    converged group keeps its carry by select, which is what the TPU
    kernel's skipped trips leave.  ``scalar_n`` (default ``n``) is the
    pixel count whose share of the convergence test each group takes:
    a launch of K members folded into one pixel axis passes one
    member's ``n`` with the member's group size as ``block``."""
    f32 = torch.float32
    n_coeff, n = pf_rows.shape
    p = xf_rows.shape[0]
    n_bands = y.shape[0]
    dev = xf_rows.device
    if tri_rows(p) != n_coeff:
        raise ValueError(f"{n_coeff} coefficient rows for p={p}")
    block = _block(n, block)
    n_blk = n // block
    relax, thresh_sq, moving_sq = _scalars(
        tol, norm_denominator, relaxation, block,
        n if scalar_n is None else scalar_n, p
    )
    bnd = _bounds(state_bounds_rows, p)
    lo = hi = None
    if bnd is not None:
        lo = [torch.tensor(float(v), dtype=f32, device=dev) for v in bnd[0]]
        hi = [torch.tensor(float(v), dtype=f32, device=dev) for v in bnd[1]]
    relax_t = torch.tensor(float(relax), dtype=f32, device=dev)
    thresh_t = torch.tensor(float(thresh_sq), dtype=f32, device=dev)

    xf = [xf_rows[k] for k in range(p)]
    yv = [y[b] for b in range(n_bands)]
    w = [r_inv[b] for b in range(n_bands)]
    msk = [mask_f[b] > 0 for b in range(n_bands)]
    pf = [pf_rows[r] for r in range(n_coeff)]
    cor = (torch.zeros(n, dtype=torch.bool, device=dev) if corrupt is None
           else corrupt.reshape(n) > 0)

    def gn_step(x, esc, clip):
        h0, jac = lin_rows(tuple(x))
        h0 = [solver_health.corrupt_h0(h0[b], cor) for b in range(n_bands)]
        y_t = []
        for b in range(n_bands):
            jx = jac[b][0] * x[0]
            for k in range(1, p):
                jx = jx + jac[b][k] * x[k]
            y_t.append(torch.where(msk[b], yv[b] + jx - h0[b], 0.0))
        wj = [[w[b] * jac[b][i] for i in range(p)] for b in range(n_bands)]
        a_pk = [[None] * p for _ in range(p)]
        for i in range(p):
            for j in range(i + 1):
                s = pf[_idx(i, j)]
                for b in range(n_bands):
                    s = s + wj[b][i] * jac[b][j]
                a_pk[i][j] = a_pk[j][i] = s
        rhs = []
        for i in range(p):
            s = pf[_idx(i, 0)] * xf[0]
            for q in range(1, p):
                s = s + pf[_idx(max(i, q), min(i, q))] * xf[q]
            for b in range(n_bands):
                s = s + wj[b][i] * y_t[b]
            rhs.append(s)
        chol_in = [row[:] for row in a_pk]
        for i in range(p):
            chol_in[i][i] = solver_health.inflate_diag(a_pk[i][i], esc)
        l = cholesky_packed(chol_in)
        x_raw = solve_chol_vectors(l, rhs)
        x_nonfin = solver_health.nonfinite_any(x_raw)
        step_bad = solver_health.chol_breakdown(l) | x_nonfin
        esc_now = torch.maximum(esc, step_bad.to(f32))
        relax_eff = solver_health.damped_relaxation(relax_t, esc_now)
        x_new = [
            x[k] + relax_eff * (solver_health.retreat(x_raw[k], x[k],
                                                      step_bad) - x[k])
            for k in range(p)
        ]
        if bnd is not None:
            x_new = [torch.minimum(torch.maximum(x_new[k], lo[k]), hi[k])
                     for k in range(p)]
            clip = [clip[k] * ((x_new[k] <= lo[k]) | (x_new[k] >= hi[k]))
                    .to(f32) for k in range(p)]
        fwd = []
        for b in range(n_bands):
            s = jac[b][0] * (x_new[0] - xf[0])
            for k in range(1, p):
                s = s + jac[b][k] * (x_new[k] - xf[k])
            fwd.append(s + h0[b])
        inn = [torch.where(msk[b], yv[b] - h0[b], 0.0)
               for b in range(n_bands)]
        dx2 = [(x_new[k] - x[k]) ** 2 for k in range(p)]
        ssq = dx2[0]
        for k in range(1, p):
            ssq = ssq + dx2[k]
        # Per-group reduction in the TPU kernel's order: per-row sums,
        # then the row total.
        normsq = dx2[0].view(n_blk, block).sum(dim=1)
        for k in range(1, p):
            normsq = normsq + dx2[k].view(n_blk, block).sum(dim=1)
        a_rows = [a_pk[i][j] for i in range(p) for j in range(i + 1)]
        return (x_new, a_rows, fwd, inn, normsq, esc_now, x_nonfin,
                step_bad, ssq, clip)

    zero = torch.zeros(n, dtype=f32, device=dev)
    x = list(xf)
    a_rows = [zero] * n_coeff
    fwd = [zero] * n_bands
    inn = [zero] * n_bands
    n_done = torch.zeros(n_blk, dtype=torch.int32, device=dev)
    normsq = torch.full((n_blk,), float("inf"), dtype=f32, device=dev)
    esc = zero
    nonfin = zero
    bad_now = zero
    ssq = zero + float("inf")
    clip = [zero + 1.0 for _ in range(p)]
    # max_iterations + 1 trips: the while loop's post-increment cap.
    for _ in range(int(max_iterations) + 1):
        active = ~((normsq < thresh_t) & (n_done >= int(min_iterations)))
        if not bool(active.any()):
            break
        act = active.repeat_interleave(block)

        def sel(new, old):
            return torch.where(act, new, old)

        (x_new, a_new, fwd_new, inn_new, normsq_new, esc_now, x_nonfin,
         step_bad, ssq_new, clip_new) = gn_step(x, esc, clip)
        x = [sel(u, v) for u, v in zip(x_new, x)]
        a_rows = [sel(u, v) for u, v in zip(a_new, a_rows)]
        fwd = [sel(u, v) for u, v in zip(fwd_new, fwd)]
        inn = [sel(u, v) for u, v in zip(inn_new, inn)]
        clip = [sel(u, v) for u, v in zip(clip_new, clip)]
        nonfin = sel(torch.maximum(nonfin, x_nonfin.to(f32)), nonfin)
        bad_now = sel(step_bad.to(f32), bad_now)
        esc = sel(esc_now, esc)
        ssq = sel(ssq_new, ssq)
        normsq = torch.where(active, normsq_new, normsq)
        n_done = torch.where(active, n_done + 1, n_done)

    observed = msk[0]
    for b in range(1, n_bands):
        observed = observed | msk[b]
    quar = ((bad_now > 0) | solver_health.nonfinite_any(x)
            | solver_health.nonfinite_any(a_rows)) & observed
    x = [solver_health.quarantine_select(quar, xf[k], x[k])
         for k in range(p)]
    a_rows = [solver_health.quarantine_select(
        quar, solver_health.QUARANTINE_INFO_SCALE * pf[r], a_rows[r])
        for r in range(n_coeff)]
    fwd = [solver_health.quarantine_select(quar, zero, v) for v in fwd]
    inn = [solver_health.quarantine_select(quar, zero, v) for v in inn]
    cap_exit = (n_done > int(max_iterations)).repeat_interleave(block)
    verd = solver_health.assemble_verdicts(
        observed, quar, cap_exit, ssq >= float(moving_sq), esc > 0
    )
    obs_f = observed.to(f32)
    st = torch.stack([n_done.to(f32).repeat_interleave(block),
                      normsq.repeat_interleave(block)])
    hl = torch.stack(
        [verd.to(f32), nonfin * obs_f]
        + [(clip[k] * obs_f) if bnd is not None else zero
           for k in range(p)]
    )
    return (torch.stack(x), torch.stack(a_rows), torch.stack(fwd),
            torch.stack(inn), st, hl)


def _launch_cuda(lin_rows, y, r_inv, mask_f, xf_rows, pf_rows, tol,
                 min_iterations, max_iterations, relaxation,
                 state_bounds_rows, norm_denominator, block, corrupt,
                 scalar_n=None):
    """Launch ``csrc/fused_gn.cu`` on the current stream (no sync)."""
    from . import _build

    owner = getattr(lin_rows, "__self__", None)
    if getattr(owner, "kernel_physics", None) != "twostream":
        raise NotImplementedError(
            "the CUDA fused Gauss-Newton kernel implements the two-stream "
            f"operator only; got {lin_rows!r}"
        )
    n_coeff, n = pf_rows.shape
    p, n_bands = xf_rows.shape[0], y.shape[0]
    if (p, n_bands) != (7, 2):
        raise ValueError(f"the two-stream kernel takes p=7, 2 bands; got "
                         f"p={p}, {n_bands} bands")
    dev = xf_rows.device
    for name, t, rows in (("y", y, 2), ("r_inv", r_inv, 2),
                          ("mask_f", mask_f, 2), ("xf_rows", xf_rows, 7),
                          ("pf_rows", pf_rows, 28)):
        _build.check_rows(name, t, rows, n, dev)
    cor_ptr = None  # no corruption row: the kernel reads none
    if corrupt is not None:
        cor = corrupt.reshape(1, n)
        _build.check_rows("corrupt", cor, 1, n, dev)
        cor_ptr = cor.data_ptr()
    block = launch_geometry(n, block)["group"]
    relax, thresh_sq, moving_sq = _scalars(
        tol, norm_denominator, relaxation, block,
        n if scalar_n is None else scalar_n, p
    )
    bnd = _bounds(state_bounds_rows, p)
    has_bounds = bnd is not None
    bnd_host = (np.zeros((2, p), np.float32) if bnd is None
                else np.ascontiguousarray(bnd, np.float32))

    def out(rows):
        return torch.empty((rows, n), dtype=torch.float32, device=dev)

    x, a, fwd, inn, st, hl = out(p), out(n_coeff), out(n_bands), \
        out(n_bands), out(2), out(2 + p)
    lib = _build.load("fused_gn")
    fn = lib.kafka_fused_gn_twostream
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(y.data_ptr(), r_inv.data_ptr(), mask_f.data_ptr(),
            xf_rows.data_ptr(), pf_rows.data_ptr(), cor_ptr,
            x.data_ptr(), a.data_ptr(), fwd.data_ptr(), inn.data_ptr(),
            st.data_ptr(), hl.data_ptr(), n, block, int(min_iterations),
            int(max_iterations), int(has_bounds), float(relax),
            float(thresh_sq), float(moving_sq),
            bnd_host.ctypes.data, stream)
    _build.raise_on_error(lib, rc, "fused_gn")
    fused_gn_rows.launches += 1
    return x, a, fwd, inn, st, hl


def kernel_attributes() -> dict:
    """Registers, spill bytes, static shared bytes and threads per block
    of the compiled CUDA kernel (builds it if needed)."""
    from . import _build

    return _build.attributes("fused_gn",
                             "kafka_fused_gn_twostream_attributes")


def kernel_geometry(n: int, block: int = 2048) -> dict:
    """The compiled kernel's own launch geometry for ``n`` pixels (CTAs
    per cluster, threads, dynamic shared bytes) and the clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``); builds the kernel
    if needed."""
    from . import _build

    group = launch_geometry(n, block)["group"]
    lib = _build.load("fused_gn")
    fn = lib.kafka_fused_gn_twostream_geometry
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    rc = fn(n, group, ctypes.addressof(out))
    _build.raise_on_error(lib, rc, "fused_gn geometry")
    return {"group": group, "clusters": n // group, "ctas": out[0],
            "threads": out[1], "smem_bytes": out[2],
            "active_clusters": out[3]}


def fused_gn_raw(lin_rows, y, r_inv, mask_f, xf_rows, pf_rows, tol,
                 min_iterations: int, max_iterations: int, relaxation,
                 state_bounds_rows, norm_denominator, block: int = 2048,
                 corrupt=None, scalar_n=None):
    """Raw outputs ``(x, a, fwd, inn, st, hl)``: the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors (``scalar_n``: see
    :func:`fused_gn_raw_plain`)."""
    args = (lin_rows, y, r_inv, mask_f, xf_rows, pf_rows, tol,
            min_iterations, max_iterations, relaxation, state_bounds_rows,
            norm_denominator, block, corrupt, scalar_n)
    if xf_rows.device.type == "cpu":
        return fused_gn_raw_plain(*args)
    if xf_rows.device.type == "cuda":
        return _launch_cuda(*args)
    raise ValueError(f"no fused Gauss-Newton path for {xf_rows.device}")


def summarise(raw, n: int, block: int, norm_denominator):
    """``(x, a, fwd, inn, n_done, norm, verdicts, nonfinite_count,
    clip_saturated)`` from raw outputs, as the JAX driver assembles them:
    ``n_done`` the max over groups, ``norm`` the global final step norm."""
    x, a, fwd, inn, st, hl = raw
    block = _block(n, block)
    # A fresh contiguous copy: the sums below then see the same layout
    # whether ``raw`` is one launch's output or one member's slice of a
    # folded launch (serve.batch), and give the same bits.
    per_block = st[:, ::block].contiguous()
    n_done = per_block[0].max().to(torch.int32)
    numel = torch.tensor(float(norm_denominator), dtype=torch.float32,
                         device=st.device)
    norm = torch.sqrt(per_block[1].sum()) / numel
    verdicts = hl[0].to(torch.int32)
    nonfinite_count = (hl[1] > 0).sum().to(torch.int32)
    clip_saturated = (hl[2:] > 0).sum(dim=1).to(torch.int32)
    return (x, a, fwd, inn, n_done, norm, verdicts, nonfinite_count,
            clip_saturated)


def fused_gn_rows(lin_rows, y, r_inv, mask_f, xf_rows, pf_rows, tol,
                  min_iterations: int, max_iterations: int, relaxation,
                  state_bounds_rows, norm_denominator, block: int = 2048,
                  corrupt=None, device=None):
    """Whole Gauss-Newton solve, the signature and return tuple of the
    JAX ``fused_gn_rows``: ``(x_rows, a_rows, fwd, inn, n_done, norm,
    verdicts, nonfinite_count, clip_saturated)``.

    ``device`` (default CUDA; raises without one) must be where the
    tensors lie.  ``lin_rows`` is the operator's bound
    ``kernel_linearize_rows``; on CUDA only the two-stream operator's
    device implementation exists."""
    from .. import resolve_device

    dev = resolve_device(device)
    if xf_rows.device.type != dev.type:
        raise ValueError(f"tensors lie on {xf_rows.device}, not on {dev}")
    raw = fused_gn_raw(lin_rows, y, r_inv, mask_f, xf_rows, pf_rows, tol,
                       min_iterations, max_iterations, relaxation,
                       state_bounds_rows, norm_denominator, block, corrupt)
    return summarise(raw, pf_rows.shape[1], block, norm_denominator)


#: CUDA kernel launches of this process (plain-version calls excluded).
fused_gn_rows.launches = 0
