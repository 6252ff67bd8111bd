"""One linearised update per pixel as one kernel launch (port of
``kafka_tpu/core/pallas_solve.py:_fused_update_rows`` and its Pallas
kernel ``_fused_update_kernel``, with ``jac_to_rows`` and
``fused_update_pallas``).

Per pixel, from Jacobian lane rows and the linearisation point:

    y~  = where(mask, y + J x_lin - H0, 0)
    A   = P_f^-1 + sum_b w_b J_b J_b^T             (packed lower triangle)
    rhs = P_f^-1 x_f + sum_b w_b y~_b J_b
    x   = chol(A with an LM-inflated diagonal) \\ rhs

storing the uninflated A, the innovations ``where(mask, y - H0, 0)`` and
``hb`` (row 0: Cholesky breakdown or non-finite x; row 1: non-finite x).

- :func:`fused_update_raw_plain` — the plain PyTorch version in the TPU
  kernel's order of operations (float32 or float64, any device); the
  CPU tests hold it against the JAX kernel, ``chip_smoke.py`` holds the
  CUDA kernel against it on the card.
- :func:`fused_update_rows` — the JAX signature and return tuple: CPU
  tensors run the plain version, CUDA tensors launch
  ``csrc/fused_update.cu`` (instances ``INSTANCES``) or raise.
  ``fused_update_rows.launches`` counts kernel launches,
  ``fused_update_rows.launches_by_instance`` them by (p, n_bands).
- :func:`fused_update` — the drop-in for the packed path of
  ``solvers.kalman_update`` (``fused_update_pallas`` in the JAX package).
"""

from __future__ import annotations

import ctypes

import torch

from . import solver_health
from .linalg import cholesky_packed, pack_rows, solve_chol_vectors, tri_rows

#: (p, n_bands) instances of the CUDA kernel: PROSAIL on Sentinel-2 (and
#: the GP and MLP emulators of its bands), TIP through the row loop
#: (``{"inkernel_linearize": False}`` or per-pixel convergence), the
#: SAR-only WCM state, the joint S2 + S1 state on its S2 and its S1
#: dates, and one band of the WCM, TIP, S2 and joint states
#: (band-sequential assimilation).
INSTANCES = ((10, 10), (7, 2), (2, 2), (11, 10), (11, 2),
             (2, 1), (7, 1), (10, 1), (11, 1))


def _idx(i: int, j: int) -> int:
    return i * (i + 1) // 2 + j


def jac_to_rows(jac: torch.Tensor) -> torch.Tensor:
    """``(B, n, p)`` Jacobian -> ``(B*p, n)`` lane rows (row ``b*p + k``
    is ``J[b, :, k]``): the one relayout the out-of-kernel path pays.
    Contiguous, as the kernel takes its rows (for one band the reshape
    alone would return a strided view)."""
    n_bands, n, p = jac.shape
    return jac.permute(0, 2, 1).reshape(n_bands * p, n).contiguous()


def check_instance(p: int, n_bands: int) -> None:
    """Raise unless the CUDA kernel has an instance for (p, n_bands)."""
    if (p, n_bands) not in INSTANCES:
        raise NotImplementedError(
            f"the CUDA fused update has no instance for p={p}, "
            f"{n_bands} bands; instances (p, bands): {INSTANCES}")


def assemble_rows(jac_rows, h0, y, w, m, xl_rows, xf_rows, pf_rows):
    """The normal equations in row layout, in the TPU kernel's order:
    ``(a, rhs, inn)`` as lists of ``(n,)`` rows (``a`` packed)."""
    p = xf_rows.shape[0]
    n_bands = h0.shape[0]
    jac = [[jac_rows[b * p + k] for k in range(p)] for b in range(n_bands)]
    msk = [m[b] > 0 for b in range(n_bands)]
    y_t = []
    for b in range(n_bands):
        jx = jac[b][0] * xl_rows[0]
        for k in range(1, p):
            jx = jx + jac[b][k] * xl_rows[k]
        # A select, not a mask multiplication: masked y may hold NaN.
        y_t.append(torch.where(msk[b], y[b] + jx - h0[b], 0.0))
    wj = [[w[b] * jac[b][i] for i in range(p)] for b in range(n_bands)]
    a = []
    for i in range(p):
        for j in range(i + 1):
            s = pf_rows[_idx(i, j)]
            for b in range(n_bands):
                s = s + wj[b][i] * jac[b][j]
            a.append(s)
    rhs = []
    for i in range(p):
        s = pf_rows[_idx(i, 0)] * xf_rows[0]
        for q in range(1, p):
            s = s + pf_rows[_idx(max(i, q), min(i, q))] * xf_rows[q]
        for b in range(n_bands):
            s = s + wj[b][i] * y_t[b]
        rhs.append(s)
    inn = [torch.where(msk[b], y[b] - h0[b], 0.0) for b in range(n_bands)]
    return a, rhs, inn


def fused_update_raw_plain(jac_rows, h0, y, w, m, xl_rows, xf_rows, pf_rows,
                           esc_row=None):
    """Plain PyTorch version of the kernel: ``(x, a, inn, hb)`` rows."""
    p = xf_rows.shape[0]
    a, rhs, inn = assemble_rows(jac_rows, h0, y, w, m, xl_rows, xf_rows,
                                pf_rows)
    esc = (torch.zeros_like(xf_rows[0]) if esc_row is None
           else esc_row.reshape(-1))
    # Factor the LM-inflated copy; the stored A stays the true Hessian.
    chol_in = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            v = a[_idx(i, j)]
            if i == j:
                v = solver_health.inflate_diag(v, esc)
            chol_in[i][j] = chol_in[j][i] = v
    l = cholesky_packed(chol_in)
    x = solve_chol_vectors(l, rhs)
    x_nonfin = solver_health.nonfinite_any(x)
    bad = solver_health.chol_breakdown(l) | x_nonfin
    hb = torch.stack([bad, x_nonfin]).to(xf_rows.dtype)
    return torch.stack(x), torch.stack(a), torch.stack(inn), hb


def _launch_cuda(jac_rows, h0, y, w, m, xl_rows, xf_rows, pf_rows, esc_row):
    """Launch ``csrc/fused_update.cu`` on the current stream of the
    inputs' device (no sync)."""
    from . import _build

    p, n = xf_rows.shape
    n_bands = h0.shape[0]
    check_instance(p, n_bands)
    dev = xf_rows.device
    if esc_row is None:
        esc_row = torch.zeros((1, n), dtype=torch.float32, device=dev)
    for name, t, rows in (("jac_rows", jac_rows, n_bands * p),
                          ("h0", h0, n_bands), ("y", y, n_bands),
                          ("w", w, n_bands), ("m", m, n_bands),
                          ("xl_rows", xl_rows, p), ("xf_rows", xf_rows, p),
                          ("pf_rows", pf_rows, tri_rows(p)),
                          ("esc_row", esc_row, 1)):
        _build.check_rows(name, t, rows, n, dev)

    def out(rows):
        return torch.empty((rows, n), dtype=torch.float32, device=dev)

    x, a, inn, hb = out(p), out(tri_rows(p)), out(n_bands), out(2)
    lib = _build.load("fused_update")
    fn = lib.kafka_fused_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
                   + [ctypes.c_longlong, ctypes.c_void_p])
    with _build.on_device(dev) as stream:
        rc = fn(p, n_bands, jac_rows.data_ptr(), h0.data_ptr(),
                y.data_ptr(), w.data_ptr(), m.data_ptr(), xl_rows.data_ptr(),
                xf_rows.data_ptr(), pf_rows.data_ptr(), esc_row.data_ptr(),
                x.data_ptr(), a.data_ptr(), inn.data_ptr(), hb.data_ptr(), n,
                stream)
    _build.raise_on_error(lib, rc, "fused_update")
    _build.count_launch(fused_update_rows, (p, n_bands))
    return x, a, inn, hb


def kernel_attributes(p: int, n_bands: int) -> dict:
    """Registers, spill bytes, static shared bytes and threads per block
    of the compiled (p, n_bands) instance (builds it if needed)."""
    from . import _build

    check_instance(p, n_bands)
    return _build.attributes("fused_update", "kafka_fused_update_attributes",
                             p, n_bands)


def fused_update_rows(jac_rows, h0, y, w, m, xl_rows, xf_rows, pf_rows,
                      esc_row=None, block: int = 2048):
    """One fused update in row layout, the signature and return tuple of
    the JAX ``_fused_update_rows``: ``(x_rows, a_rows, inn_rows, hb_rows)``.
    ``block`` is accepted for that signature only: nothing couples
    pixels, so the CUDA kernel tiles as it likes."""
    dev = xf_rows.device
    if dev.type == "cpu":
        return fused_update_raw_plain(jac_rows, h0, y, w, m, xl_rows,
                                      xf_rows, pf_rows, esc_row)
    if dev.type == "cuda":
        return _launch_cuda(jac_rows, h0, y, w, m, xl_rows, xf_rows,
                            pf_rows, esc_row)
    raise ValueError(f"no fused update for {dev}")


#: CUDA kernel launches of this process (plain-version calls excluded),
#: in all and by (p, n_bands) instance.
fused_update_rows.launches = 0
fused_update_rows.launches_by_instance = {}


def fused_update(lin, obs, x_lin, x_forecast, p_inv_forecast):
    """Whole-update drop-in for the packed path of ``kalman_update``:
    ``(x (n, p), a_packed)`` with ``a_packed`` the list-of-lists packed
    information matrix.  ``p_inv_forecast`` is the dense ``(n, p, p)``
    batch or pre-packed ``(tri(p), n)`` rows."""
    f32 = torch.float32
    n_bands, n, p = lin.jac.shape
    if p_inv_forecast.ndim == 2:
        pf_rows = p_inv_forecast.to(f32).contiguous()
    else:
        pf_rows = pack_rows(p_inv_forecast)
    x_rows, a_rows, _inn, _hb = fused_update_rows(
        jac_to_rows(lin.jac.to(f32)), lin.h0.to(f32).contiguous(),
        obs.y.to(f32).contiguous(), obs.r_inv.to(f32).contiguous(),
        obs.mask.to(f32).contiguous(), x_lin.T.to(f32).contiguous(),
        x_forecast.T.to(f32).contiguous(), pf_rows,
    )
    a_packed = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            a_packed[i][j] = a_packed[j][i] = a_rows[_idx(i, j)]
    return x_rows.T, a_packed
