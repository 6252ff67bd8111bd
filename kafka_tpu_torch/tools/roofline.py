"""Roofline accounting for the port's hot solver components (port of
``tools/roofline.py``).

How close is each component of the date solve to what the card can do?
For each component it reports:

- measured ms/call at the operating size (the queued-slope method of
  ``bench.bench_device_sizes``: ``k`` calls flushed by one
  ``torch.cuda.synchronize``, for two values of ``k``);
- the *analytic minimum* HBM traffic of the JAX tool (read every live
  input once, write every output once; ``telemetry.perf.min_traffic_*``)
  and the utilisation LOWER BOUND it implies against the card's HBM
  roof (``telemetry.perf.HBM_GBPS``);
- ``bound_ms``, the least time of the component on the card: for a
  component that launches a hand kernel, the least time of those
  launches — each launch's bytes over the HBM roof or its float32
  operations over ``telemetry.perf.PEAK_TFLOPS_F32``, whichever is
  larger, counted from ``csrc/`` as ``chip_smoke.py`` counts them (the
  bound column of PERF.md's kernel table); for any other component the
  fusion-perfect traffic over the HBM roof.  ``share_of_bound`` is
  ``bound_ms / ms``.

Torch has no counterpart of XLA's post-fusion cost model, so the JAX
rows' cost-model fields (``xla_bytes``, ``xla_flops``,
``achieved_gflops``, ``traffic_amplification_xla``) stay in each row as
null: the JSON keeps the JAX tool's shape.

Components, at n = 2^19 pixels (the benchmark operating size), with the
JAX names:

- ``tip/linearize``, ``prosail/linearize``: the operator's batched
  value+Jacobian (``torch.func``; two-stream p=7 and PROSAIL p=10);
- ``tip/update``, ``prosail/update``: one packed update given a
  linearisation (``core.solvers.kalman_update``, the plain path);
- ``tip/gn_full``: the whole date solve on the plain unfused loop
  (``assimilate_date`` with ``use_pallas`` False);
- ``tip/gn_full_pallas`` (card only): the same solve on the row loop,
  one launch of the hand ``fused_update`` (7, 2) kernel per iteration;
- ``tip/gn_inkernel`` (card only): the whole loop in one launch of the
  hand ``fused_gn`` kernel;
- ``prosail/update_pallas`` (card only): the update as one launch of the
  hand ``fused_update`` (10, 10) kernel.

Usage:
    python -m kafka_tpu_torch.tools.roofline [--n 524288] [--json OUT]
        [--skip-prosail] [--device cuda]

Run it alone on the card: concurrent work skews queued-slope timings.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np

# The roofs and the analytic minimum-traffic bounds live in the telemetry
# layer (``telemetry.perf``), which publishes the same utilisation lower
# bound as a live gauge; re-exported here as in the JAX tool.
from ..telemetry.perf import (  # noqa: F401 — re-export
    HBM_GBPS,
    PEAK_TFLOPS_F32,
    min_traffic_gn_full,
    min_traffic_gn_inkernel,
    min_traffic_linearize,
    min_traffic_update,
)


def slope_time(fn, flush, k1=5, k2=25, reps=5, target_s=1.5):
    """Sustained per-call seconds via the queued-slope method:
    ``(median, spread)`` of ``reps`` slopes, ``k2`` grown until the
    difference exceeds ``target_s``."""

    def run_k(k):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        flush()
        return time.perf_counter() - t0

    while (run_k(k2) - run_k(k1)) < target_s and k2 < 8000:
        k2 = min(k2 * 4, 8000)
    slopes = [(run_k(k2) - run_k(k1)) / (k2 - k1)
              for _ in range(max(1, reps))]
    return float(np.median(slopes)), float(max(slopes) - min(slopes))


# ---------------------------------------------------------------------------
# The hand kernels' least work, counted from csrc/ as chip_smoke.py counts
# it for the bound column of PERF.md's kernel table.
# ---------------------------------------------------------------------------


def tri(p: int) -> int:
    return p * (p + 1) // 2


#: fused_gn (two-stream, p = 7, 2 bands), floats per pixel it must move
#: once: reads y, r_inv, mask (2 bands each), x_f (7), packed P_f^-1
#: (28); writes x (7), packed A (28), fwd (2), inn (2) and the verdict
#: (1).  Per convergence group its trip count and step norm.
GN_FLOATS_PER_PIXEL = 6 + 7 + 28 + 7 + 28 + 2 + 2 + 1
GN_FLOATS_PER_GROUP = 2
#: float32 operations per pixel per Gauss-Newton trip (two-stream value
#: + 4-tangent Jacobian, y~, A, rhs, LM inflation, Cholesky,
#: substitution, step/clip, fwd/inn, step norm) and once per pixel (the
#: prior term P_f^-1 x_f).
GN_FLOPS_PER_PIXEL_TRIP = 670 + 30 + 168 + 42 + 28 + 147 + 98 + 35 + 46 + 21
GN_FLOPS_PER_PIXEL_ONCE = 91


def fused_gn_work(n_pix: int, group: int, trips: float) -> tuple:
    """(bytes, flops) of one ``fused_gn`` launch over ``n_pix`` px in
    groups of ``group`` px whose trip counts sum to ``trips``."""
    bytes_moved = 4 * (GN_FLOATS_PER_PIXEL * n_pix
                       + GN_FLOATS_PER_GROUP * (n_pix // group))
    flops = GN_FLOPS_PER_PIXEL_TRIP * trips * group \
        + GN_FLOPS_PER_PIXEL_ONCE * n_pix
    return bytes_moved, flops


def chol_solve_flops(p: int) -> int:
    """float32 operations of one packed Cholesky and substitution
    (csrc/packed_chol.cuh)."""
    chol = sum(2 * j + 2 + (p - 1 - j) * (2 * j + 1) for j in range(p))
    return chol + 2 * p * p


def fused_update_work(n_pix: int, p: int, nb: int) -> tuple:
    """(bytes, flops) of one ``fused_update`` launch at (p, nb): reads J,
    H0, y, w, mask, x_lin, x_f, packed P_f^-1 and the escalation row;
    writes x, packed A, the innovations and the two flags."""
    floats = (nb * p + 4 * nb + 2 * p + tri(p) + 1) + (p + tri(p) + nb + 2)
    per_band = (2 * p - 1) + 3 + p + 2 * tri(p) + 2 * p
    flops = p * (2 * p - 1) + nb * per_band + 5 * p + chol_solve_flops(p)
    return 4.0 * floats * n_pix, flops * n_pix


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time of some work on the card: its bytes over the HBM
    roof or its float32 operations over the peak rate, the larger."""
    bytes_ms = bytes_moved / (HBM_GBPS * 1e9) * 1e3
    ops_ms = flops / (PEAK_TFLOPS_F32 * 1e12) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# ---------------------------------------------------------------------------
# Measurement.
# ---------------------------------------------------------------------------


def measure(name, fn, flush, rows, min_traffic=None, note="",
            kernel=None, slope=None):
    """Time ``fn`` and append its row.  ``kernel`` is ``(name, launches,
    bytes, flops)`` of the hand-kernel launches one call makes, which
    then set ``bound_ms``; otherwise the fusion-perfect traffic does."""
    fn()  # warm
    flush()
    dt, spread = slope_time(fn, flush, **(slope or {}))
    row = {
        "component": name,
        "ms": dt * 1e3,
        "ms_spread": spread * 1e3,
        # XLA's cost model has no torch counterpart: kept null so the
        # JSON keeps the JAX tool's shape.
        "xla_bytes": None,
        "xla_flops": None,
        "achieved_gflops": None,
        "min_traffic_bytes": min_traffic,
        "note": note,
        "kernel": None,
    }
    pct = ""
    if min_traffic:
        row["min_traffic_gbps"] = min_traffic / dt / 1e9
        row["pct_hbm_roof_lower_bound"] = (
            100.0 * row["min_traffic_gbps"] / HBM_GBPS
        )
        row["traffic_amplification_xla"] = None
        # Time the component would take if it only moved the live inputs
        # and outputs once at the full bandwidth roof.
        row["fusion_perfect_ms"] = min_traffic / (HBM_GBPS * 1e9) * 1e3
        row.update(bound(min_traffic, 0.0))
        pct = (
            f"-> >= {row['min_traffic_gbps']:7.1f} GB/s "
            f">= {row['pct_hbm_roof_lower_bound']:.1f}% of HBM roof"
        )
    if kernel is not None:
        kname, launches, k_bytes, k_flops = kernel
        row.update(kernel=kname, launches=launches, kernel_bytes=k_bytes,
                   kernel_flops=k_flops, **bound(k_bytes, k_flops))
    if "bound_ms" in row:
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        pct += (f", bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{100 * row['share_of_bound']:.1f}% of it")
    print(f"{name:24s} {dt*1e3:9.4f} ms  (spread {spread*1e3:.4f})  {pct}",
          file=sys.stderr)
    rows.append(row)
    return row


def _launches(fn) -> tuple:
    """The hand kernels' launch counters moved by one call of ``fn``,
    and the call's result."""
    from ..core.fused_gn import fused_gn_rows
    from ..core.fused_update import fused_update_rows

    before = (fused_gn_rows.launches,
              dict(fused_update_rows.launches_by_instance))
    result = fn()
    after_upd = fused_update_rows.launches_by_instance
    out = {"fused_gn": fused_gn_rows.launches - before[0]}
    out.update({f"fused_update[{p},{nb}]": n - before[1].get((p, nb), 0)
                for (p, nb), n in after_upd.items()
                if n != before[1].get((p, nb), 0)})
    return out, result


def _gn_trips(op, bands, x0, p_inv0, n_pix: int) -> tuple:
    """(group size, summed trips over groups) of ``fused_gn`` on the
    problem, read from one untimed kernel launch's per-group trip row."""
    import torch

    from ..core.fused_gn import fused_gn_raw, launch_geometry
    from ..core.linalg import pack_rows

    f32 = torch.float32
    group = launch_geometry(n_pix)["group"]
    raw = fused_gn_raw(
        op.kernel_linearize_rows, bands.y.to(f32).contiguous(),
        bands.r_inv.to(f32).contiguous(), bands.mask.to(f32).contiguous(),
        x0.T.contiguous(), pack_rows(p_inv0), 1e-3, 2, 25, 1.0,
        op.state_bounds, float(n_pix * op.n_params))
    return group, float(raw[4][0, ::group].sum())


def tip_components(n_pix, rows, device, slope=None):
    from ..bench import date_solve_options, sync_device
    from ..core.solvers import assimilate_date, kalman_update
    from ..testing.synthetic import make_tip_problem

    dev = device
    flush = functools.partial(sync_device, dev)
    op, bands, x0, p_inv0 = make_tip_problem(n_pix, device=dev)
    p = op.n_params
    n_bands = op.n_bands

    # -- linearize: reads x (n,p), writes h0 (B,n) + jac (B,n,p).
    measure(
        "tip/linearize", lambda: op.linearize(None, x0), flush, rows,
        min_traffic_linearize(n_pix, p, n_bands),
        note=f"value+jacfwd (torch.func), p={p}, {n_bands} bands",
        slope=slope,
    )

    # -- update: reads lin + obs + x_lin + x_f + p_inv_f, writes x + A.
    lin = op.linearize(None, x0)
    measure(
        "tip/update",
        lambda: kalman_update(lin, bands, x0, x0, p_inv0), flush, rows,
        min_traffic_update(n_pix, p, n_bands),
        note="packed assembly + packed Cholesky + substitution (plain)",
        slope=slope,
    )

    # -- the whole date solve on the plain unfused loop.
    def solver(opts):
        return lambda: assimilate_date(op.linearize, bands, x0, p_inv0,
                                       None, opts, device=dev)

    full = solver(date_solve_options(op, dev, use_pallas=False))
    n_iters = int(full()[2].n_iterations)
    min_full = min_traffic_gn_full(n_pix, p, n_bands)
    row = measure(
        "tip/gn_full", full, flush, rows, min_full,
        note=f"{n_iters} GN iterations (plain unfused loop)", slope=slope,
    )
    row["n_iterations"] = n_iters

    # -- the same solve through the hand kernels: card only (on the CPU
    # the wrappers run the plain versions, whose time is not a kernel's).
    if dev.type != "cuda":
        for name in ("tip/gn_full_pallas", "tip/gn_inkernel"):
            print(f"{name:24s} skipped - no card (a CPU run times the "
                  "plain versions, not the kernels)", file=sys.stderr)
        return rows
    rowloop = solver(date_solve_options(op, dev, use_pallas=True,
                                        inkernel_linearize=False))
    launched, result = _launches(rowloop)
    n_upd = launched.get(f"fused_update[{p},{n_bands}]", 0)
    u_bytes, u_flops = fused_update_work(n_pix, p, n_bands)
    n_iters = int(result[2].n_iterations)
    row_pl = measure(
        "tip/gn_full_pallas", rowloop, flush, rows, min_full,
        note=f"{n_iters} GN iterations, the row loop: {n_upd} launches "
             f"of fused_update ({p}, {n_bands})",
        kernel=(f"fused_update[{p},{n_bands}]", n_upd, n_upd * u_bytes,
                n_upd * u_flops),
        slope=slope,
    )
    row_pl["n_iterations"] = n_iters

    inkernel = solver(date_solve_options(op, dev, use_pallas=True,
                                         inkernel_linearize=True))
    launched, result = _launches(inkernel)
    n_iters = int(result[2].n_iterations)
    group, trips = _gn_trips(op, bands, x0, p_inv0, n_pix)
    g_bytes, g_flops = fused_gn_work(n_pix, group, trips)
    n_gn = launched.get("fused_gn", 0)
    row_ik = measure(
        "tip/gn_inkernel", inkernel, flush, rows,
        min_traffic_gn_inkernel(n_pix, p, n_bands),
        note=(f"whole GN loop ({n_iters} iters) + analytic "
              f"linearisation in {n_gn} fused_gn launch(es)"),
        kernel=("fused_gn", n_gn, n_gn * g_bytes, n_gn * g_flops),
        slope=slope,
    )
    row_ik.update(n_iterations=n_iters, group=group, trips=trips)
    return rows


def prosail_components(n_pix, rows, device, slope=None):
    import torch

    from ..bench import sync_device
    from ..cli.drivers import prosail_aux_builder
    from ..core.solvers import kalman_update
    from ..core.types import BandBatch
    from ..engine.priors import sail_prior_arrays
    from ..obsops.prosail import ProsailAux, ProsailOperator

    dev = device
    flush = functools.partial(sync_device, dev)
    op = ProsailOperator()
    p = op.n_params
    n_bands = op.n_bands
    rng = np.random.default_rng(0)
    mean, _, inv = sail_prior_arrays()
    x0 = torch.as_tensor(
        np.clip(mean + rng.normal(0, 0.02, (n_pix, p)), 0.02, 0.98)
        .astype(np.float32), device=dev)
    p_inv0 = torch.as_tensor(inv, dtype=torch.float32,
                             device=dev).expand(n_pix, p, p)
    aux = ProsailAux(*(a.to(dev) for a in prosail_aux_builder(
        {"sza": 30.0, "saa": 120.0, "vza": 5.0, "vaa": 200.0}, None)))

    measure(
        "prosail/linearize", lambda: op.linearize(aux, x0), flush, rows,
        min_traffic_linearize(n_pix, p, n_bands),
        note=f"exact-SAIL value+jacfwd (torch.func), p={p}, "
             f"{n_bands} bands",
        slope=slope,
    )

    lin = op.linearize(aux, x0)
    y = lin.h0.cpu().numpy() + rng.normal(
        0, 0.005, (n_bands, n_pix)).astype(np.float32)
    bands = BandBatch(
        y=torch.as_tensor(y.astype(np.float32), device=dev),
        r_inv=torch.full((n_bands, n_pix), 1 / 0.005**2,
                         dtype=torch.float32, device=dev),
        mask=torch.ones((n_bands, n_pix), dtype=torch.bool, device=dev),
    )
    measure(
        "prosail/update",
        lambda: kalman_update(lin, bands, x0, x0, p_inv0), flush, rows,
        min_traffic_update(n_pix, p, n_bands),
        note="packed assembly + packed Cholesky + substitution (plain)",
        slope=slope,
    )
    if dev.type != "cuda":
        print("prosail/update_pallas    skipped - no card (a CPU run "
              "times the plain version, not the kernel)", file=sys.stderr)
        return rows

    def fused():
        return kalman_update(lin, bands, x0, x0, p_inv0, use_pallas=True)

    n_upd = _launches(fused)[0].get(f"fused_update[{p},{n_bands}]", 0)
    u_bytes, u_flops = fused_update_work(n_pix, p, n_bands)
    measure(
        "prosail/update_pallas", fused, flush, rows,
        min_traffic_update(n_pix, p, n_bands),
        note=f"{n_upd} launch of fused_update ({p}, {n_bands}) with the "
             "dense P_f^-1 packed in and A unpacked out",
        kernel=(f"fused_update[{p},{n_bands}]", n_upd, n_upd * u_bytes,
                n_upd * u_flops),
        slope=slope,
    )
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 19)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--skip-prosail", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; 'cpu' times the "
                         "plain versions and skips the kernel rows)")
    ap.add_argument("--reps", type=int, default=5,
                    help="slope estimates per component (default 5)")
    ap.add_argument("--target-s", type=float, default=1.5,
                    help="grow k2 until T(k2) - T(k1) exceeds this "
                         "(default 1.5 s)")
    ap.add_argument("--ks", default="5,25",
                    help="the starting k1,k2 of the slope (default 5,25)")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..utils.compilation_cache import enable_compilation_cache

    dev = resolve_device(args.device)
    enable_compilation_cache()
    k1, k2 = (int(k) for k in args.ks.split(","))
    slope = {"k1": k1, "k2": k2, "reps": args.reps,
             "target_s": args.target_s}

    rows: list = []
    tip_components(args.n, rows, dev, slope)
    if not args.skip_prosail:
        prosail_components(args.n, rows, dev, slope)

    out = {
        "n_pix": args.n,
        "hbm_gbps_roof": HBM_GBPS,
        "peak_tflops_f32": PEAK_TFLOPS_F32,
        "platform": dev.type,
        "device_name": _device_name(dev),
        "rows": rows,
    }
    print(json.dumps(out, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


if __name__ == "__main__":
    sys.exit(main())
