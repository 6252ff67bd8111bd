"""Benchmark of the port: assimilation throughput (pixels/sec) against
the CPU reference path (port of the JAX package's ``bench.py``).

    python -m kafka_tpu_torch.bench [--device cuda]

The reference publishes no numbers, so the baseline is *measured*: the
NumPy/SciPy-sparse oracle of its solver path
(``kafka_tpu_torch.testing.oracle`` — sparse block-diagonal normal
equations + SuperLU, the reference's Gauss-Newton loop) on this host's
CPU, at the reference's own chunk size (16384 pixels = one 128x128
chunk).  Ours is the identical problem solved on the card.

Prints ONE JSON line with the JAX bench's key set (``assemble_result``),
so both packages' ``bench_compare`` and ``bench_history`` read it:
    {"metric": "assimilation_throughput", "value": <device px/s>,
     "unit": "pixels/sec", "vs_baseline": <speedup over SciPy CPU>, ...}

What the rows time on the card (one TIP/two-stream date solve,
``core.solvers.assimilate_date`` on ``make_tip_problem``):

- ``device_*`` (the JAX XLA rows): ``{"use_pallas": False}``, the plain
  unfused Gauss-Newton loop.  It is NOT queued end to end: every trip
  reads its convergence test back to the host (the census's
  ``host_syncs``), so a solve is a chain of launches and host reads.
  The slope between two solve counts still cancels the fixed cost of
  the final flush; what remains is the per-solve wall, host reads and
  launch gaps included;
- ``device_pallas_ms``: ``use_pallas=True, inkernel_linearize=False``,
  the row loop — the eager linearisation and one launch of the hand
  ``fused_update`` (7, 2) kernel per iteration;
- ``device_pallas_fused_lin_ms``: the options unset, the port's default
  for two-stream — the whole loop in one launch of the hand ``fused_gn``
  kernel.

The two kernel rows are null on the CPU only (a CPU run times the plain
versions, not a kernel); on a CUDA device they are measured or the bench
raises.  The health layer (``probe_device_ms``, ``probe_host_ms``,
``unhealthy`` — see ``telemetry.health.probe_health``) brackets the run,
so an artifact measured in off-band weather is flagged instead of
trusted.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# Bench health layer (``kafka_tpu_torch.telemetry.health``): every probe
# records its reading into the metrics registry and ``probe_health``
# sources its verdict FROM the registry, so the bench and production runs
# read the same gauges.  The re-exports keep the bench API
# (``bench.probe_health`` etc.) and the card's bands importable from here.
# ---------------------------------------------------------------------------

from . import resolve_device
from .telemetry import get_registry
from .telemetry.health import (  # noqa: F401 — bench API re-export
    DEVICE_BAND,
    HEALTHY_DEVICE_MS,
    HEALTHY_HOST_MS,
    probe_device,
    probe_health,
    probe_host,
)


def sync_device(dev) -> None:
    """Wait for the device's queued work (CPU tensors are synchronous):
    the flush that ends every timed burst of the bench and roofline."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def date_solve_options(op, dev, use_pallas: bool = False,
                       inkernel_linearize=None) -> dict:
    """The solver options of one bench row: the operator's state bounds
    and the route — ``use_pallas`` False is the plain loop; True with
    ``inkernel_linearize`` False the row loop on ``fused_update``;
    otherwise the options stay unset (two-stream then runs
    ``fused_gn``)."""
    import torch

    lo, hi = op.state_bounds
    opts = {"state_bounds": (
        torch.as_tensor(lo, dtype=torch.float32, device=dev),
        torch.as_tensor(hi, dtype=torch.float32, device=dev))}
    if not use_pallas:
        opts["use_pallas"] = False
    elif inkernel_linearize is not None and not inkernel_linearize:
        opts["use_pallas"] = True
        opts["inkernel_linearize"] = False
    return opts


def bench_device_sizes(sizes, ks=(5, 25), use_pallas=False,
                       inkernel_linearize=None, device=None,
                       target_s: float = 1.5, reps: int = 5):
    """One TIP date solve (``assimilate_date``) per call on ``device``
    (default CUDA; raises without one), timed by the queued slope.

    ``k`` back-to-back solves are flushed by one synchronisation, for two
    values of ``k``: the slope ``(T(k2)-T(k1))/(k2-k1)`` is the per-solve
    time with the flush's fixed cost cancelled.  ``k2`` grows until the
    difference exceeds ``target_s`` (a few solves' worth of work is
    buried in the noise of one flush), then the median of ``reps`` slope
    estimates.  Returns ``{n_pix: (pixels_per_sec, median_ms_per_solve,
    slope_spread_ms)}`` with the median pooled over every burst of that
    size in ``sizes`` (repeated sizes measure in separate bursts spread
    across the run, bounding drift).

    ``use_pallas`` / ``inkernel_linearize`` pick the route as
    :func:`date_solve_options` does: the module docstring says what each
    row runs.
    """
    import torch

    from .core.solvers import assimilate_date
    from .testing.synthetic import make_tip_problem

    dev = resolve_device(device)
    slopes_by_size: dict = {}
    k2_by_size: dict = {}
    for n_pix in sizes:
        op, bands, x0, p_inv0 = make_tip_problem(n_pix, device=dev)
        opts = date_solve_options(op, dev, use_pallas, inkernel_linearize)

        def solve():
            return assimilate_date(op.linearize, bands, x0, p_inv0, None,
                                   opts, device=dev)

        _, _, diags = solve()  # warm-up: kernel build and load
        sync_device(dev)

        def run_k(k):
            t0 = time.perf_counter()
            for _ in range(k):
                solve()
            sync_device(dev)
            return time.perf_counter() - t0

        # Grow k2 until the measured k2-k1 delta clearly exceeds the
        # flush noise; a later burst of the same size reuses the k2 its
        # first burst discovered (still valid under drift — k2 only ever
        # needs to be LARGE enough).
        k1, k2 = ks
        k2 = max(k2, k2_by_size.get(n_pix, k2))
        if n_pix not in k2_by_size:
            while (run_k(k2) - run_k(k1)) < target_s and k2 < 8000:
                k2 = min(k2 * 4, 8000)
            k2_by_size[n_pix] = k2
        burst = [
            (run_k(k2) - run_k(k1)) / (k2 - k1) for _ in range(max(1, reps))
        ]
        slopes_by_size.setdefault(n_pix, []).extend(burst)
        dt = float(np.median(burst))
        tag = "plain"
        if use_pallas:
            tag = "fused_update" if inkernel_linearize is False \
                else "fused_gn"
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else dev.type
        print(
            f"device[{tag}]: {n_pix} px, "
            f"{int(diags.n_iterations)} GN iters, "
            f"{dt*1e3:.3f} ms/solve sustained on {where}",
            file=sys.stderr,
        )
    out = {}
    for n_pix, slopes in slopes_by_size.items():
        dt = float(np.median(slopes))
        out[n_pix] = (
            n_pix / dt, dt * 1e3,
            (max(slopes) - min(slopes)) * 1e3,
        )
    return out


def oracle_inputs(n_pix: int):
    """The oracle's arguments on ``make_tip_problem(n_pix)``:
    ``(linearize, y_b, r_b, m_b, x0, p_inv0)`` as
    ``testing.oracle.iterated_sparse_solve`` takes them, the operator's
    linearisation run on the CPU (the baseline is the CPU's)."""
    import torch

    from .testing.synthetic import make_tip_problem

    cpu = torch.device("cpu")
    op, bands, x0, p_inv0 = make_tip_problem(n_pix, device=cpu)
    y_b = list(bands.y.numpy())
    r_b = list(bands.r_inv.numpy())
    m_b = list(bands.mask.numpy())

    def linearize(x):
        lin = op.linearize(None, torch.as_tensor(
            np.asarray(x, np.float32), device=cpu))
        return list(lin.h0.numpy()), list(lin.jac.numpy())

    return (linearize, y_b, r_b, m_b, x0.numpy().copy(),
            p_inv0.numpy().copy())


def bench_oracle(n_pix: int, reps: int = 5):
    """The reference algorithm (sparse block-diag + SuperLU) on the host
    CPU, its linearisation the port's on the CPU.

    A WARM-UP solve runs before the timed reps: the first call pays
    SuperLU's symbolic factorisation and lazy-import costs, which are
    setup, not solve.  Median of ``reps`` timed runs with the spread AND
    the min reported (host-load contamination only ever adds time, so
    the minimum is the cleanest single observation).  Returns
    ``(pixels_per_sec_median, median_ms, spread_ms, min_ms)``.
    """
    from .testing.oracle import iterated_sparse_solve

    args = oracle_inputs(n_pix)
    iterated_sparse_solve(*args)  # untimed warm-up (see docstring)
    times = []
    n_iters = 0
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        _, _, n_iters = iterated_sparse_solve(*args)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    spread = float(max(times) - min(times))
    best = float(min(times))
    print(
        f"oracle: {n_pix} px, {n_iters} GN iters, {dt*1e3:.1f} ms/solve "
        f"median of {len(times)} warm (spread {spread*1e3:.1f} ms, "
        f"min {best*1e3:.1f} ms, SciPy SuperLU)",
        file=sys.stderr,
    )
    return n_pix / dt, dt * 1e3, spread * 1e3, best * 1e3


def bench_end_to_end(ny: int = 204, nx: int = 235, n_dates: int = 3,
                     outdir=None, full_mask: bool = False,
                     noise: float = 0.002, passes: int = 5, device=None):
    """Full-pipeline throughput INCLUDING host I/O: on-disk S2 granule
    tree -> read/decode -> gather -> PROSAIL assimilation (the row loop,
    the hand ``fused_update`` (10, 10) kernel on the card) -> GeoTIFF
    outputs, at the reference's Barrax problem scale.  Returns
    (pixel_steps/sec median of ``passes``, device fraction of the median
    pass's wall, n_pixels, pixel_steps/sec spread).

    The row is the MEDIAN of ``passes`` measured rates with the max-min
    spread reported alongside (``e2e_pixel_steps_per_s_spread``), so a
    cross-round consumer (``tools.bench_history``) can see when the
    number is too dispersed to trend.  ``outdir`` keeps the tree and the
    outputs (``outdir/s2``, ``outdir/out``); by default both live in a
    temporary directory removed at the end."""
    import datetime
    import shutil
    import tempfile

    from .cli.drivers import prosail_aux_builder
    from .engine import KalmanFilter
    from .engine.priors import sail_prior
    from .io import GeoTIFFOutput
    from .io.sentinel2 import Sentinel2Observations
    from .obsops.prosail import ProsailOperator
    from .testing.fixtures import (
        DEFAULT_GEO, make_pivot_mask, make_s2_granule_tree,
    )

    dev = resolve_device(device)
    tmp = outdir or tempfile.mkdtemp(prefix="kafka_bench_")
    try:
        dates = [
            datetime.datetime(2017, 7, 1) + datetime.timedelta(days=2 * i)
            for i in range(n_dates)
        ]
        make_s2_granule_tree(
            f"{tmp}/s2", dates, ny=ny, nx=nx, noise=noise
        )
        mask = (np.ones((ny, nx), bool) if full_mask
                else make_pivot_mask(ny, nx, n_pivots=5, seed=0))
        prior = sail_prior(device=dev)
        obs = Sentinel2Observations(
            f"{tmp}/s2", ProsailOperator(),
            (DEFAULT_GEO.geotransform, DEFAULT_GEO.epsg),
            aux_builder=prosail_aux_builder, device=dev,
        )
        output = GeoTIFFOutput(
            prior.parameter_list, list(DEFAULT_GEO.geotransform),
            DEFAULT_GEO.projection, folder=f"{tmp}/out",
            epsg=DEFAULT_GEO.epsg, async_writes=True,
            # Fast-wire opt-in (the benchmarked performance mode; the
            # DEFAULT wire is bit-exact float32 — io.output).
            wire_dtype="float16",
        )
        kf = KalmanFilter(
            obs, output, mask, prior.parameter_list,
            state_propagation=None, prior=prior, device=dev,
        )
        kf.set_trajectory_model()
        kf.set_trajectory_uncertainty(np.zeros(10, np.float32))
        x0, p_inv0 = prior.process_prior(None, kf.gather)
        grid = [
            dates[0] - datetime.timedelta(days=1),
            *[d + datetime.timedelta(days=1) for d in dates],
        ]
        # Warm-up on the full grid (kernel load, allocator, reader
        # pools), then the MEDIAN of ``passes`` measured rates.
        kf.run(grid, x0, None, p_inv0)
        # Drain the warm-up's async writes BEFORE timing, or the first
        # pass's flush pays the warm-up backlog and inflates the spread.
        output.flush()
        walls, devices = [], []
        for _ in range(max(1, passes)):
            kf.diagnostics_log.clear()
            t0 = time.perf_counter()
            kf.run(grid, x0, None, p_inv0)
            output.flush()
            walls.append(time.perf_counter() - t0)
            devices.append(sum(r["wall_s"] for r in kf.diagnostics_log))
        output.close()
        order = int(np.argsort(walls)[len(walls) // 2])
        wall, device_s = walls[order], devices[order]
        n_pix = kf.gather.n_valid
        steps = len(kf.diagnostics_log)
        rates = [n_pix * steps / w for w in walls]
        px_steps_s = n_pix * steps / wall
        spread = float(max(rates) - min(rates))
        print(
            f"e2e: {n_pix} px x {steps} dates incl. host I/O: "
            f"{wall:.2f}s wall median of {len(walls)} (rate spread "
            f"{spread:.0f} px-steps/s), {device_s:.2f}s in solves "
            f"({100 * device_s / wall:.0f}%)",
            file=sys.stderr,
        )
        return px_steps_s, device_s / wall, n_pix, spread
    finally:
        if outdir is None:
            shutil.rmtree(tmp, ignore_errors=True)


def assemble_result(
    health: dict,
    *,
    oracle,                # (px_s, ms_median, ms_spread, ms_min) @ n_matched
    device_matched,        # (px_s, ms_median, ms_spread) @ n_matched
    device,                # (px_s, ms_median, ms_spread) @ n_device
    pallas,                # same triple or None (CPU run)
    e2e,                   # (px_steps_s, device_fraction, n_pixels[, spread])
    host_after_ms: float,
    fused_lin=None,        # (px_s, ms_median, ms_spread) or None (CPU run)
    serve=None,            # tools.loadgen bench_serve rows dict or None
    fleet=None,            # tools.loadgen bench_fleet rows dict or None
    sweep=None,            # tools.loadgen bench_concurrency_sweep or None
    smoother=None,         # bench_smoother_rows dict or None
    n_matched: int = 16384,
    n_device: int = 1 << 19,
    registry=None,
    program_contracts=None,  # a contracts_snapshot() already taken
    run_device=None,       # where the contracts census runs (CUDA)
) -> dict:
    """Assemble the one-line BENCH JSON from measured rows: the JAX
    bench's key set, null conventions and health fields, so both
    packages' ``bench_compare`` read it.  ``telemetry`` embeds the
    registry's compact counter/gauge snapshot (including the health
    gauges the probes recorded).  ``program_contracts`` takes a snapshot
    the caller already holds (the census traces 16 programs); otherwise
    it is taken on ``run_device``.
    """
    base_px_s, oracle_ms, oracle_spread_ms, oracle_min_ms = oracle
    dev_matched_px_s, matched_ms, matched_spread_ms = device_matched
    dev_px_s, plain_ms, plain_spread_ms = device
    pallas_px_s, pallas_ms, pallas_spread_ms = \
        pallas if pallas is not None else (None, None, None)
    fl_px_s, fl_ms, fl_spread_ms = \
        fused_lin if fused_lin is not None else (None, None, None)
    # A 3-tuple (no spread) is accepted, as the JAX bench accepts it.
    e2e_px_steps_s, device_frac, e2e_pix = e2e[:3]
    e2e_spread = e2e[3] if len(e2e) > 3 else None
    reg = registry if registry is not None else get_registry()
    # Close the health bracket: a window that degraded DURING the run is
    # as contaminating as one that started bad.
    unhealthy = bool(health["unhealthy"]) or \
        host_after_ms > HEALTHY_HOST_MS
    if program_contracts is None:
        program_contracts = program_contracts_snapshot(run_device)
    return {
        "metric": "assimilation_throughput",
        "value": round(dev_px_s, 1),
        "unit": "pixels/sec",
        "vs_baseline": round(dev_matched_px_s / base_px_s, 2),
        # The matched-size ratio above is honest but doubly noisy (the
        # small device row is launch-bound, the CPU oracle host-bound);
        # device throughput at its operating size over the oracle's
        # per-pixel rate (size-linear for a block-diagonal solve) is the
        # comparable cross-round number.
        "vs_baseline_at_scale": round(dev_px_s / base_px_s, 2),
        "oracle_ms_median": round(oracle_ms, 1),
        "oracle_ms_spread": round(oracle_spread_ms, 1),
        # Min-of-k over the WARM reps (first-call SuperLU symbolic
        # factorisation excluded by a warm-up solve): host-load noise
        # only ever ADDS time, so the min is the robust comparator.
        "oracle_ms_min": round(oracle_min_ms, 1),
        "n_pix_device": n_device,
        "n_pix_matched": n_matched,
        "device_px_s_matched": round(dev_matched_px_s, 1),
        "device_ms_matched_median": round(matched_ms, 3),
        "device_ms_matched_spread": round(matched_spread_ms, 3),
        # The JAX names: "xla" is the port's plain unfused loop, the
        # "pallas" rows its hand kernels — fused_update's row loop and
        # the whole loop in fused_gn (null on a CPU run).
        "device_xla_ms": round(plain_ms, 3),
        "device_xla_ms_spread": round(plain_spread_ms, 3),
        "device_pallas_ms": None if pallas_ms is None
        else round(pallas_ms, 3),
        "device_pallas_ms_spread": None if pallas_spread_ms is None
        else round(pallas_spread_ms, 3),
        "device_pallas_px_s": None if pallas_px_s is None
        else round(pallas_px_s, 1),
        "device_pallas_fused_lin_ms": None if fl_ms is None
        else round(fl_ms, 3),
        "device_pallas_fused_lin_ms_spread": None if fl_spread_ms is None
        else round(fl_spread_ms, 3),
        "device_pallas_fused_lin_px_s": None if fl_px_s is None
        else round(fl_px_s, 1),
        # Reanalysis solve rows (bench_smoother_rows: the RTS backward
        # sweep over a synthetic in-memory chain).  The _ms row gates in
        # bench_compare via the device_*_ms pattern; the px_s twin gates
        # larger-is-better — both null when the smoother bench failed.
        "device_smoother_ms": None if smoother is None
        else smoother.get("device_smoother_ms"),
        "device_smoother_px_s": None if smoother is None
        else smoother.get("device_smoother_px_s"),
        "e2e_pixel_steps_per_s": round(e2e_px_steps_s, 1),
        # Max-min over the measured passes: the dispersion travels WITH
        # the number, so bench_history flags a row unjudgeable instead
        # of trending its noise.
        "e2e_pixel_steps_per_s_spread": None if e2e_spread is None
        else round(e2e_spread, 1),
        "e2e_device_fraction": round(device_frac, 3),
        "e2e_n_pixels": e2e_pix,
        # Serving rows (tools.loadgen against the in-process service —
        # warm-path request latency).  Gated by bench_compare like the
        # device_*_ms rows: disappearance or >10% regression fails.
        "serve_p50_ms": None if serve is None
        else serve.get("serve_p50_ms"),
        "serve_p99_ms": None if serve is None
        else serve.get("serve_p99_ms"),
        "serve_cold_ms": None if serve is None
        else serve.get("serve_cold_ms"),
        "serve_rejected_total": None if serve is None
        else serve.get("serve_rejected_total"),
        "serve_requests_total": None if serve is None
        else serve.get("serve_requests_total"),
        # Reanalysis serving rows (loadgen's smoothed mix: every Kth
        # request reads the RTS-smoothed state off the checkpoint chain).
        "serve_smoothed_p50_ms": None if serve is None
        else serve.get("serve_smoothed_p50_ms"),
        "serve_smoothed_p99_ms": None if serve is None
        else serve.get("serve_smoothed_p99_ms"),
        # Request-tracing rows: the fraction of served requests whose
        # per-request trace attributes >=95% of their wall time, and the
        # single slowest request (diffed informationally).
        "serve_trace_coverage": None if serve is None
        else serve.get("serve_trace_coverage"),
        "serve_slowest_ms": None if serve is None
        else serve.get("serve_slowest_ms"),
        # Mid-run /metrics scrape of the serving bench: how queue depth
        # and admission counters MOVED under load.
        "live_telemetry": None if serve is None
        else serve.get("live_telemetry"),
        # SLO rows (loadgen's fast-windowed evaluator over the serving
        # bench): alert episodes fired during the bench and the worst
        # per-objective error-budget remainder.
        "serve_slo_alerts_total": None if serve is None
        else serve.get("serve_slo_alerts_total"),
        "serve_slo_budget_remaining": None if serve is None
        else serve.get("serve_slo_budget_remaining"),
        # Coalesced-serving rows (loadgen.bench_concurrency_sweep): the
        # concurrency ladder, the launch throughput at the top level
        # (serve_batched_px_s GATES in bench_compare) and the unbatched
        # same-run baseline.
        "serve_sweep": None if sweep is None
        else sweep.get("serve_sweep"),
        "serve_batched_px_s": None if sweep is None
        else sweep.get("serve_batched_px_s"),
        "serve_batch_mean_size": None if sweep is None
        else sweep.get("serve_batch_mean_size"),
        "serve_queue_wait_p99_ms": None if sweep is None
        else sweep.get("serve_queue_wait_p99_ms"),
        "serve_unbatched_p99_ms": None if sweep is None
        else sweep.get("serve_unbatched_p99_ms"),
        "serve_unbatched_queue_wait_p99_ms": None if sweep is None
        else sweep.get("serve_unbatched_queue_wait_p99_ms"),
        # Elastic-fleet serving rows (loadgen.bench_fleet: N in-process
        # replicas behind the consistent-hash router).
        "serve_fleet_p50_ms": None if fleet is None
        else fleet.get("serve_fleet_p50_ms"),
        "serve_fleet_p99_ms": None if fleet is None
        else fleet.get("serve_fleet_p99_ms"),
        "serve_fleet_replicas": None if fleet is None
        else fleet.get("serve_fleet_replicas"),
        "serve_fleet_requests_total": None if fleet is None
        else fleet.get("serve_fleet_requests_total"),
        "serve_fleet_rerouted_total": None if fleet is None
        else fleet.get("serve_fleet_rerouted_total"),
        "serve_backoff_total": None if fleet is None
        else fleet.get("serve_backoff_total"),
        # Bench health layer (telemetry.health.probe_health): off-band
        # probes flag the whole artifact.
        **health,
        "probe_host_after_ms": round(host_after_ms, 3),
        "unhealthy": unhealthy,
        # Compact registry snapshot: counters/gauges (+histogram
        # count/sum) from the run.
        "telemetry": reg.flat(),
        # The kafka_solver_* counters, so bench_compare can diff result
        # QUALITY alongside timing (zeros on a healthy run).
        "solver_health": solver_health_snapshot(reg),
        # Filter-consistency verdict counts and drift-sentinel state.
        "quality": quality_snapshot(reg),
        # The live kafka_perf_* gauges at assembly time.
        "perf": perf_snapshot(reg),
        # Alert counts, firing objectives and budget remainders.
        "slo": slo_snapshot(reg),
        # Top kernels / collective fraction of the newest parsed capture
        # plus the device-memory peak watermark.
        "device_profile": devprof_snapshot(reg),
        # Per-program census fingerprints and the contract finding count
        # (bench_compare warns LOUDLY when a fingerprint drifts).
        "program_contracts": program_contracts,
    }


def program_contracts_snapshot(device=None) -> dict:
    """Census-level contract snapshot (``kafka_tpu_torch.analysis``) on
    ``device`` (default CUDA): cached per device after the first
    artifact of the run, and never raises (an analysis failure becomes an
    ``error`` field, not a dead benchmark)."""
    from .analysis import contracts_snapshot

    return contracts_snapshot(device)


def devprof_snapshot(registry=None) -> dict:
    """The run's device-plane state (``telemetry.devprof``): capture
    count, the top-kernel table (bounded), collective fraction and the
    per-device memory peak from the watermark gauges — always present
    (zeros/None before any capture or watermark)."""
    from .telemetry import devprof as _devprof

    reg = registry if registry is not None else get_registry()
    ks = _devprof.kernel_summary(reg, n=8)
    hbm_peak = {}
    for key, val in reg.flat().items():
        if key.startswith("kafka_device_memory_peak_bytes"):
            hbm_peak[key] = val
    return {
        "captures_parsed": ks["captures_parsed"],
        "device_ms": ks["device_ms"],
        "collective_fraction": ks["collective_fraction"],
        "kernels": [
            {"name": k["name"], "bucket": k["bucket"], "ms": k["ms"],
             "fraction": k["fraction"]}
            for k in ks["kernels"]
        ],
        "hbm_peak_bytes": hbm_peak,
        "live_buffer_bytes": _devprof.summary(reg)["live_buffer_bytes"],
    }


def perf_snapshot(registry=None) -> dict:
    """The run's performance-attribution state (``telemetry.perf``):
    rolling throughput/device-fraction gauges, phase busy fractions and
    roofline-utilization components — always present, gauges None when
    the run assimilated no windows."""
    from .telemetry import perf as _perf

    return _perf.summary(
        registry if registry is not None else get_registry()
    )


def slo_snapshot(registry=None) -> dict:
    """The run's SLO state as a compact dict: alert counts, firing
    objectives and the per-objective budget remainder — the stable
    disabled shape when no evaluator ran on this registry."""
    from .telemetry import slo as _slo

    reg = registry if registry is not None else get_registry()
    summary = _slo.summary(reg)
    objectives = {
        name: {
            "status": o.get("status"),
            "budget_remaining": (o.get("budget") or {}).get(
                "remaining"
            ),
        }
        for name, o in (summary.get("objectives") or {}).items()
    }
    return {
        "enabled": bool(summary.get("enabled")),
        "alerts_fired": int(summary.get("alerts_fired") or 0),
        "alerts_resolved": int(summary.get("alerts_resolved") or 0),
        "firing": sorted(
            f"{a.get('objective')}:{a.get('severity')}"
            for a in summary.get("firing") or ()
        ),
        "objectives": objectives,
    }


def quality_snapshot(registry=None) -> dict:
    """The run's assimilation-quality state as a compact dict: window
    counts per consistency verdict (``kafka_quality_windows_total``),
    drift-sentinel totals, and the run's overall (worst) verdict — None
    when the run recorded no quality windows."""
    from .telemetry import quality as _quality

    reg = registry if registry is not None else get_registry()
    windows = {}
    for v in _quality.VERDICTS:
        n = reg.value("kafka_quality_windows_total", verdict=v)
        windows[v] = 0 if n is None else int(n)
    events_total = 0.0
    for key, val in reg.flat().items():
        if key.startswith("kafka_quality_drift_events_total"):
            events_total += float(val)
    return {
        "verdict": _quality.worst_verdict(
            v for v, n in windows.items() if n
        ),
        "windows": windows,
        "drift_events": int(events_total),
        "drift_active": int(reg.value("kafka_quality_drift_active")
                            or 0),
    }


def solver_health_snapshot(registry=None) -> dict:
    """The run's ``kafka_solver_*`` counter totals as a compact dict
    (labelled series summed — e.g. clip_saturated over parameters)."""
    reg = registry if registry is not None else get_registry()
    out = {
        "quarantined_pixels": 0.0,
        "cap_bailouts": 0.0,
        "damped_recoveries": 0.0,
        "nonfinite": 0.0,
        "clip_saturated": 0.0,
    }
    for key, val in reg.flat().items():
        if not key.startswith("kafka_solver_"):
            continue
        short = key[len("kafka_solver_"):].split("{", 1)[0]
        if short.endswith("_total"):
            short = short[: -len("_total")]
        out[short] = out.get(short, 0.0) + float(val)
    return out


def bench_kernel_rows(n_device: int = 1 << 19, device=None,
                      ks=(5, 25), target_s: float = 1.5, reps: int = 5):
    """``(pallas, fused_lin)``: the two hand-kernel rows at ``n_device``
    px — the row loop on ``fused_update`` and the whole loop in
    ``fused_gn`` — measured on a CUDA device, ``(None, None)`` on the
    CPU, whose timing would be of the plain versions.  On a card a
    failure raises; the rows are never dropped for it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        print("device[fused_update, fused_gn]: skipped — CPU run (the "
              "plain versions, not the kernels)", file=sys.stderr)
        return None, None
    pallas = bench_device_sizes(
        [n_device], ks, use_pallas=True, inkernel_linearize=False,
        device=dev, target_s=target_s, reps=reps)[n_device]
    fused_lin = bench_device_sizes(
        [n_device], ks, use_pallas=True, inkernel_linearize=True,
        device=dev, target_s=target_s, reps=reps)[n_device]
    return pallas, fused_lin


def main(argv=None) -> int:
    from .telemetry import (
        flight_recorder, install_compile_listeners, tracing,
    )
    from .utils.compilation_cache import enable_compilation_cache

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the device rows (default CUDA; "
                         "'cpu' times the plain versions and leaves the "
                         "kernel rows null)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    enable_compilation_cache()
    install_compile_listeners()
    # Crash forensics next to the BENCH artifact: a bench killed mid-run
    # (or flagged unhealthy by the probes) leaves crash_<ts>.json in the
    # working directory instead of nothing.
    recorder = flight_recorder.install(".")
    with tracing.push(run_id=tracing.new_run_id()), recorder:
        _bench_rows(dev)
    return 0


def _bench_rows(dev):
    # Health first: an off-band host or card contaminates every row
    # below; probe (with one retry) BEFORE spending minutes measuring.
    health = probe_health()
    # Baseline on the reference's chunk size (16384 px = one 128x128
    # chunk).  vs_baseline compares both at that SAME size; the headline
    # value is the device's throughput at 2^19 px, its operating point.
    n_matched = 16384
    n_device = 1 << 19
    oracle = bench_oracle(n_matched)
    # The matched size measures in two bursts bracketing the large-size
    # run; the pooled median (+ reported spread) bounds drift.
    dev_rows = bench_device_sizes([n_matched, n_device, n_matched],
                                  device=dev)
    pallas, fused_lin = bench_kernel_rows(n_device, device=dev)
    e2e = bench_end_to_end(device=dev)
    smoother = bench_smoother_rows(device=dev)
    serve = bench_serve_rows(device=dev)
    fleet = bench_fleet_rows(device=dev)
    sweep = bench_sweep_rows(device=dev)
    host_after_ms = probe_host()
    print(json.dumps(assemble_result(
        health,
        oracle=oracle,
        device_matched=dev_rows[n_matched],
        device=dev_rows[n_device],
        pallas=pallas,
        fused_lin=fused_lin,
        e2e=e2e,
        serve=serve,
        fleet=fleet,
        sweep=sweep,
        smoother=smoother,
        host_after_ms=host_after_ms,
        n_matched=n_matched,
        n_device=n_device,
        run_device=dev,
    )))


def bench_smoother_rows(n_pix: int = 16384, windows: int = 8,
                        n_params: int = 2, reps: int = 5, device=None):
    """Time the RTS backward sweep (``kafka_tpu_torch.smoother``) on
    ``device`` over a synthetic in-memory chain — ``windows`` checkpoint
    nodes of ``n_pix`` pixels, every node carrying a forecast sidecar so
    the measurement is the pure sweep (no propagator re-derivation, no
    IO; host arrays in and out, as the chain's loader hands them).
    ``device_smoother_px_s`` counts pixel-windows per second.  Failure
    degrades to null rows with a loud stderr note rather than killing
    the solve rows."""
    import datetime

    try:
        from .smoother import ChainNode, smooth_chain

        rng = np.random.default_rng(0)
        idx = np.arange(n_params)
        base = datetime.datetime(2017, 7, 1)
        nodes = []
        for t in range(windows):
            x = rng.standard_normal(
                (n_pix, n_params)).astype(np.float32)
            p_inv = np.zeros((n_pix, n_params, n_params), np.float32)
            p_inv[:, idx, idx] = \
                (1.0 + rng.random((n_pix, n_params))).astype(np.float32)
            sidecar = None
            if t > 0:
                xf = rng.standard_normal(
                    (n_pix, n_params)).astype(np.float32)
                pf_inv = np.zeros(
                    (n_pix, n_params, n_params), np.float32)
                pf_inv[:, idx, idx] = (
                    0.5 + rng.random((n_pix, n_params))
                ).astype(np.float32)
                sidecar = (xf, pf_inv)
            nodes.append(ChainNode(
                base + datetime.timedelta(days=4 * t), x, p_inv,
                sidecar,
            ))
        smooth_chain(nodes, device=device)  # warm-up outside the reps
        times = []
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            smooth_chain(nodes, device=device)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        rows = {
            "device_smoother_ms": round(med * 1e3, 3),
            "device_smoother_px_s": round(n_pix * windows / med, 1),
        }
        print(
            f"smoother: {rows['device_smoother_ms']} ms / "
            f"{windows}x{n_pix} px chain "
            f"({rows['device_smoother_px_s']} px-windows/s)",
            file=sys.stderr,
        )
        return rows
    except Exception as exc:  # degrade to null rows: the smoother bench must never cost the solve rows
        print(f"smoother bench failed ({exc!r}) — smoother rows null",
              file=sys.stderr)
        return None


def bench_serve_rows(requests: int = 24, concurrency: int = 4,
                     device=None):
    """The serving latency rows via ``tools.loadgen``'s self-contained
    in-process harness on ``device``.  Failure degrades to null rows
    with a loud stderr note rather than killing the solve rows."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kafka_bench_serve_")
    try:
        from .tools.loadgen import bench_serve

        rows = bench_serve(tmp, requests=requests,
                           concurrency=concurrency, device=device)
        print(
            f"serve: p50 {rows['serve_p50_ms']} ms, "
            f"p99 {rows['serve_p99_ms']} ms over "
            f"{rows['serve_ok_total']} ok / "
            f"{rows['serve_requests_total']} requests "
            f"(cold {rows['serve_cold_ms']} ms)",
            file=sys.stderr,
        )
        return rows
    except Exception as exc:  # degrade to null rows: the serving bench must never cost the solve rows
        print(f"serve bench failed ({exc!r}) — serving rows null",
              file=sys.stderr)
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_sweep_rows(concurrencies=(1, 8, 32), device=None):
    """The coalesced-serving concurrency-sweep rows via
    ``tools.loadgen``'s self-contained in-process harness on
    ``device``.  Failure degrades to null rows with a loud stderr note
    rather than killing the solve rows."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kafka_bench_sweep_")
    try:
        from .tools.loadgen import bench_concurrency_sweep

        rows = bench_concurrency_sweep(tmp, concurrencies=concurrencies,
                                       device=device)
        print(
            f"serve sweep: batched px/s {rows['serve_batched_px_s']}, "
            f"mean batch {rows['serve_batch_mean_size']} @ "
            f"c={rows['serve_sweep_concurrencies'][-1]}, queue_wait "
            f"p99 {rows['serve_queue_wait_p99_ms']} ms batched vs "
            f"{rows['serve_unbatched_queue_wait_p99_ms']} ms unbatched",
            file=sys.stderr,
        )
        return rows
    except Exception as exc:  # degrade to null rows like the other serving benches
        print(f"serve sweep failed ({exc!r}) — sweep rows null",
              file=sys.stderr)
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_fleet_rows(replicas: int = 3, requests: int = 24,
                     concurrency: int = 4, device=None):
    """The elastic-fleet serving rows via ``tools.loadgen``'s in-process
    N-replica + consistent-hash-router harness on ``device`` — the
    serve_fleet_* rows bench_compare gates.  Failure degrades to null
    rows with a loud stderr note rather than killing the solve rows."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kafka_bench_fleet_")
    try:
        from .tools.loadgen import bench_fleet

        rows = bench_fleet(tmp, replicas=replicas, requests=requests,
                           concurrency=concurrency, device=device)
        print(
            f"fleet: p50 {rows['serve_fleet_p50_ms']} ms, "
            f"p99 {rows['serve_fleet_p99_ms']} ms over "
            f"{rows['serve_fleet_ok_total']} ok / "
            f"{rows['serve_fleet_requests_total']} requests across "
            f"{rows['serve_fleet_replicas']} replicas "
            f"(rerouted {rows['serve_fleet_rerouted_total']})",
            file=sys.stderr,
        )
        return rows
    except Exception as exc:  # degrade to null rows: the fleet bench must never cost the solve rows
        print(f"fleet bench failed ({exc!r}) — fleet rows null",
              file=sys.stderr)
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
