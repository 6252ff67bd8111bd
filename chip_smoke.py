"""GPU smoke run of the PyTorch/CUDA port (kafka_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero without one, and without the
kafka_tpu_torch package beside it.  Imports neither JAX nor kafka_tpu.
Phases, each printing one JSON line:

1. device — card, torch/CUDA versions, kernel build time and registers;
2. reference — a small TIP engine run through the kernel path against
   the port's plain loop (use_pallas=False), date by date;
3. main — KalmanFilter.run over one 2400 x 2400 MODIS tile under a
   seeded land mask: TwoStreamOperator, jrc_prior, prior-only advance,
   3 windows of 16 days with 2 acquisitions each.  Kernel launch counts
   are reset just before and read just after; the kernel's inputs on the
   second date (an advanced state) are kept;
4. kernel — the fused Gauss-Newton CUDA kernel against its plain PyTorch
   version on those kept inputs (the main path's shapes and data), then
   on make_tip_problem(2**19) (the JAX bench's device size): held to
   the plain version run in float64 as set out below, and timed;
5. faults — the kept inputs with planted corrupt, Cholesky-breakdown,
   recoverable and NaN-nodata pixels under a one-iteration cap, so every
   verdict branch fires: verdicts of the planted pixels, the quarantined
   set and the quarantined outputs must be identical;
6. profile — one tile-size date under torch.profiler (device busy time
   and time by kernel).

Then the card's name and power limit as nvidia-smi gives them, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np

# How the kernel is held to its plain version.  The float32 Gauss-Newton
# solve is ill-conditioned on about 1 % of a tile date's pixels: moving
# x_f by one ulp moves the plain version's x by over 2e-3 there, by over
# 1e-2 on 1 pixel in 10^4, and by ~1 where a pixel's path crosses a kink
# of the two-stream model (the clip of g = 1 - 1/d).  The kernel rounds
# differently (FMA contraction, dual-number derivatives, another
# reduction order), so it differs from the float32 plain version by the
# same amount, and no per-pixel tolerance separates that from a bug.
# So the reference is the plain version run in float64 on the same
# inputs: at each of QUANTILES of the per-pixel error against it — in x,
# in A, and in fwd/inn — the kernel may be at most ERR_MARGIN times as
# far off as the float32 plain version, or ERR_FLOOR (about 100 float32
# ulps of a quantity of order one: rounding, whatever the order of the
# operations).  QA verdicts and the groups' trip counts must equal the
# float32 plain version's.  The solve-health branches are held exactly by
# the faults phase.
QUANTILES = (0.5, 0.99, 0.999, 0.9999)
ERR_MARGIN = 1.25
ERR_FLOOR = 1e-5
#: the JAX package's fused-kernel parity budgets (tests/test_solvers.py:
#: 702-716): pixels beyond them are counted, and the faults phase holds
#: its planted pixels to them.  A entry (i, j) is measured against its
#: matrix's scale sqrt(A_ii A_jj): off-diagonals that cancel to near zero
#: carry the rounding of their large terms.  A single pixel's A moves by
#: over 1e-3 of that scale when x_f moves by one ulp, so the tight test
#: of A is the quantile rule above, not a per-pixel budget.
X_ATOL = 2e-3
A_RTOL = 2e-2
DIAG_ATOL = 5e-3

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
#: floats per pixel the fused solve must move once: reads y, r_inv, mask
#: (2 bands each), x_f (7), packed P_f^-1 (28); writes x (7), packed A
#: (28), fwd (2), inn (2) and the verdict (1).  Plus per convergence
#: group its trip count and step norm.
MIN_FLOATS_PER_PIXEL = 6 + 7 + 28 + 7 + 28 + 2 + 2 + 1
MIN_FLOATS_PER_GROUP = 2
#: what the kernel's row layout moves: the same inputs, and the outputs
#: x, A, fwd, inn, st (2) and hl (2 + 7) per pixel.
LAYOUT_FLOATS_PER_PIXEL = 6 + 7 + 28 + 7 + 28 + 2 + 2 + 2 + 9
#: float32 operations per pixel per Gauss-Newton trip, counted from
#: csrc/fused_gn.cu: two-stream value + 4-tangent Jacobian 670 (2 bands),
#: y~ 30, A 168, rhs 133, LM inflation 28, Cholesky 147, substitution 98,
#: step/clip 35, fwd/inn 46, step norm 21.
FLOPS_PER_PIXEL_TRIP = 670 + 30 + 168 + 133 + 28 + 147 + 98 + 35 + 46 + 21

TILE = 2400
KERNEL_REPLACES = "kafka_tpu/core/pallas_solve.py:255"
#: kernel inputs kept from this main-path date (0-based).
KEEP_DATE = 1
#: positional arguments of the solver's fused_gn_rows call.
ROW_ARGS = ("lin_rows", "y", "r_inv", "mask_f", "xf_rows", "pf_rows", "tol",
            "min_iterations", "max_iterations", "relaxation",
            "state_bounds_rows", "norm_denominator")
ROW_INPUTS = ("y", "r_inv", "mask_f", "xf_rows", "pf_rows")
OUTPUTS = ("x", "A", "fwd", "inn", "st", "hl")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int):
    """Milliseconds per ``fn()`` after one warm-up run: on the card, CUDA
    events around ``reps`` back-to-back calls (their launches queue, so
    host overhead overlaps device work), divided by ``reps``."""
    import torch

    fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def problem_rows(n_pix: int, device, seed: int = 0):
    """The port's make_tip_problem in the kernel's row layout."""
    import torch

    from kafka_tpu_torch.core.solvers import _pack_rows
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    op, bands, x0, p_inv0 = make_tip_problem(n_pix, seed=seed,
                                             device=device)
    f32 = torch.float32
    return dict(
        lin_rows=op.kernel_linearize_rows,
        y=bands.y.to(f32).contiguous(),
        r_inv=bands.r_inv.to(f32).contiguous(),
        mask_f=bands.mask.to(f32).contiguous(),
        xf_rows=x0.T.contiguous(),
        pf_rows=_pack_rows(p_inv0, op.n_params).contiguous(),
        tol=1e-3, min_iterations=2, max_iterations=25, relaxation=1.0,
        state_bounds_rows=op.state_bounds,
        norm_denominator=float(n_pix * op.n_params),
    )


def plain_f64(rows: dict):
    """The plain version in float64 on ``rows`` (outputs cast back to
    float32): the reference the kernel is held to."""
    from kafka_tpu_torch.core import fused_gn

    r = {**rows, **{k: rows[k].double() for k in ROW_INPUTS}}
    return [t.float() for t in fused_gn.fused_gn_raw_plain(**r)]


def pixel_errors(out, ref, block: int) -> dict:
    """Per-pixel errors of raw outputs ``out`` against ``ref``: x (max abs
    over parameters), A (max over entries, of the matrix's scale), diag
    (max abs over fwd and inn); and the pixels whose verdict differs and
    each group's trip-count difference."""
    import torch

    o = dict(zip(OUTPUTS, out))
    r = dict(zip(OUTPUTS, ref))
    p = o["x"].shape[0]
    diag = r["A"][[i * (i + 1) // 2 + i for i in range(p)]].abs()
    scale = torch.stack([torch.sqrt(diag[i] * diag[j])
                         for i in range(p) for j in range(i + 1)])
    return {
        "x": (o["x"] - r["x"]).abs().max(dim=0).values,
        "A": ((o["A"] - r["A"]).abs() / scale.clamp_min(1e-30))
        .max(dim=0).values,
        "diag": torch.cat([(o["fwd"] - r["fwd"]).abs(),
                           (o["inn"] - r["inn"]).abs()]).max(dim=0).values,
        "verdict": o["hl"][0] != r["hl"][0],
        "trips": (o["st"][0, ::block] - r["st"][0, ::block]).abs(),
    }


def summary(err: dict) -> dict:
    """QUANTILES, max and the count beyond the JAX package's budget of
    each per-pixel error; verdict and trip-count differences."""
    import torch

    budget = {"x": X_ATOL, "A": A_RTOL, "diag": DIAG_ATOL}
    out = {}
    for nm, lim in budget.items():
        s = torch.sort(err[nm].double()).values
        n = s.numel()
        out[nm] = {**{str(q): float(s[min(n - 1, int(q * n))])
                      for q in QUANTILES},
                   "max": float(s[-1]), "beyond_budget": int((s > lim).sum())}
    out["verdict_mismatch_pixels"] = int(err["verdict"].sum())
    out["max_group_trip_diff"] = float(err["trips"].max())
    return out


def held(kernel_vs_ref: dict, plain_vs_ref: dict) -> list:
    """Failures: each quantile where the kernel is further than ERR_FLOOR
    and more than ERR_MARGIN times as far from the float64 reference as
    the float32 plain version."""
    failures = []
    for nm in ("x", "A", "diag"):
        for q in map(str, QUANTILES):
            kq, pq = kernel_vs_ref[nm][q], plain_vs_ref[nm][q]
            if kq > max(ERR_MARGIN * pq, ERR_FLOOR):
                failures.append(f"{nm} error at quantile {q}: kernel {kq:.3g}"
                                f" > {ERR_MARGIN} x plain {pq:.3g}")
    return failures


def phase_kernel(device, label: str, rows: dict, kernel_reps: int = 20,
                 plain_reps: int = 2) -> dict:
    """The CUDA kernel against its plain version on ``rows`` (float32,
    float64, and float32 on x_f moved by one ulp), both timed, and the
    function's bound."""
    import torch

    from kafka_tpu_torch.core import fused_gn

    n_pix = rows["pf_rows"].shape[1]
    block = fused_gn._block(n_pix, 2048)
    kern = fused_gn.fused_gn_raw(**rows)
    plain = fused_gn.fused_gn_raw_plain(**rows)
    ref = plain_f64(rows)
    nudged = {**rows, "xf_rows": torch.nextafter(
        rows["xf_rows"], torch.full_like(rows["xf_rows"], float("inf")))}
    plain_ulp = fused_gn.fused_gn_raw_plain(**nudged)
    _sync(device)
    finite = all(bool(torch.isfinite(t).all()) for t in kern)
    vs_plain = summary(pixel_errors(kern, plain, block))
    vs_ref = summary(pixel_errors(kern, ref, block))
    plain_vs_ref = summary(pixel_errors(plain, ref, block))
    ulp_vs_plain = summary(pixel_errors(plain_ulp, plain, block))
    ms = time_ms(lambda: fused_gn.fused_gn_raw(**rows), device, kernel_reps)
    plain_ms = time_ms(lambda: fused_gn.fused_gn_raw_plain(**rows), device,
                       plain_reps)
    # Bound: the function's minimum bytes once, and its operations for
    # the trips this run's data needed (per group, from the st row).
    trips = float(kern[4][0, ::block].sum())
    bytes_moved = 4 * (MIN_FLOATS_PER_PIXEL * n_pix
                       + MIN_FLOATS_PER_GROUP * (n_pix // block))
    flops = FLOPS_PER_PIXEL_TRIP * trips * block
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    rec = {
        "phase": "kernel", "case": label, "n_pix": n_pix, "block": block,
        "finite": finite,
        "max_abs_err": {nm: float((a - b).abs().max()) for nm, a, b
                        in zip(OUTPUTS[:4], kern, plain)},
        "n_done_kernel": int(kern[4][0].max()),
        "n_done_plain": int(plain[4][0].max()),
        "kernel_vs_plain": vs_plain, "kernel_vs_f64": vs_ref,
        "plain_vs_f64": plain_vs_ref, "plain_ulp_vs_plain": ulp_vs_plain,
        "ms": ms, "plain_ms": plain_ms,
        "bytes": bytes_moved,
        "layout_bytes": 4 * LAYOUT_FLOATS_PER_PIXEL * n_pix, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit(rec)
    failures = held(vs_ref, plain_vs_ref)
    if not finite:
        failures.append("non-finite kernel output")
    if vs_plain["max_group_trip_diff"] > 0:
        failures.append("group trip counts differ")
    if vs_plain["verdict_mismatch_pixels"] > 0:
        failures.append(f"{vs_plain['verdict_mismatch_pixels']} verdicts "
                        "differ")
    if failures:
        raise AssertionError(f"kernel ({label}): " + "; ".join(failures))
    return rec


def phase_faults(device, rows: dict, n_each: int = 64) -> dict:
    """Planted faults in ``rows`` under a one-iteration cap: every verdict
    branch fires, and kernel and plain version must agree exactly on the
    planted pixels' verdicts and non-finite flags, on the quarantined set,
    and on the quarantined outputs (forecast state, a quarter of the
    forecast information, zero diagnostics).  The other pixels stop
    mid-path, and their verdicts and errors are held to the float64
    reference as in ``phase_kernel``."""
    import torch

    from kafka_tpu_torch.core import fused_gn
    from kafka_tpu_torch.core import solver_health as sh
    from kafka_tpu_torch.testing.synthetic import plant_solver_faults

    planted_rows, cor, planted = plant_solver_faults(
        rows["y"], rows["r_inv"], rows["mask_f"], rows["xf_rows"],
        rows["pf_rows"], n_each=n_each)
    args = {**rows, **planted_rows, "max_iterations": 1, "corrupt": cor}
    n_pix = cor.shape[0]
    block = fused_gn._block(n_pix, 2048)
    kern = fused_gn.fused_gn_raw(**args)
    plain = fused_gn.fused_gn_raw_plain(**args)
    ref = plain_f64(args)
    _sync(device)
    finite = all(bool(torch.isfinite(t).all()) for t in kern)
    k = dict(zip(OUTPUTS, kern))
    q = dict(zip(OUTPUTS, plain))
    vk, vq = k["hl"][0].to(torch.int32), q["hl"][0].to(torch.int32)
    failures = []
    expect = {
        "corrupt": lambda v: (v & sh.QA_QUARANTINED) > 0,
        "breakdown": lambda v: (v & sh.QA_QUARANTINED) > 0,
        "recovered": lambda v: ((v & sh.QA_DAMPED_RECOVERED) > 0)
        & ((v & sh.QA_QUARANTINED) == 0),
        "nodata": lambda v: v == sh.QA_NODATA,
        "half_nan": lambda v: (v & (sh.QA_NODATA | sh.QA_QUARANTINED)) == 0,
    }
    # The planted pixels that are not quarantined (the LM-damped path and
    # the one-band solve) must also hold the JAX package's budgets
    # against the float32 plain version.
    err_kq = pixel_errors(kern, plain, block)
    budget = {"x": X_ATOL, "A": A_RTOL, "diag": DIAG_ATOL}
    branches = {}
    for nm, px in planted.items():
        equal = bool((vk[px] == vq[px]).all()) and bool(
            (k["hl"][1, px] == q["hl"][1, px]).all())
        hit = bool(expect[nm](vk[px]).all())
        worst = {e: float(err_kq[e][px].max()) for e in budget}
        within = nm in ("corrupt", "breakdown") or all(
            worst[e] <= lim for e, lim in budget.items())
        branches[nm] = {"equal": equal, "expected_verdict": hit,
                        "max_err_vs_plain": worst}
        if not (equal and hit and within):
            failures.append(f"{nm}: equal={equal} expected={hit} "
                            f"errors={worst}")
    quar_k = (vk & sh.QA_QUARANTINED) > 0
    quar_q = (vq & sh.QA_QUARANTINED) > 0
    same_set = bool((quar_k == quar_q).all())
    xf, pf = args["xf_rows"], args["pf_rows"]
    exact = same_set and all(
        bool((o["x"][:, quar_k] == xf[:, quar_k]).all())
        and bool((o["A"][:, quar_k] == 0.25 * pf[:, quar_k]).all())
        and bool((o["fwd"][:, quar_k] == 0).all())
        and bool((o["inn"][:, quar_k] == 0).all())
        for o in (k, q))
    if not exact:
        failures.append("quarantined set or outputs differ")
    bits = {"converged": sh.QA_CONVERGED, "cap_bailout": sh.QA_CAP_BAILOUT,
            "damped_recovered": sh.QA_DAMPED_RECOVERED,
            "quarantined": sh.QA_QUARANTINED, "nodata": sh.QA_NODATA}
    counts = {who: {nm: int(((v & bit) > 0).sum())
                    for nm, bit in bits.items()}
              for who, v in (("kernel", vk), ("plain", vq))}
    if min(counts[who]["cap_bailout"] for who in counts) == 0:
        failures.append("no cap bailout under the one-iteration cap")
    planted_any = torch.zeros(n_pix, dtype=torch.bool, device=cor.device)
    for px in planted.values():
        planted_any[px] = True
    err_k = pixel_errors(kern, ref, block)
    err_q = pixel_errors(plain, ref, block)
    other = {who: int((err["verdict"] & ~planted_any).sum())
             for who, err in (("kernel", err_k), ("plain", err_q))}
    vs_ref, plain_vs_ref = summary(err_k), summary(err_q)
    failures += held(vs_ref, plain_vs_ref)
    if other["kernel"] > ERR_MARGIN * other["plain"]:
        failures.append(f"{other['kernel']} other verdicts differ from the "
                        f"float64 reference, float32 plain {other['plain']}")
    if not finite:
        failures.append("non-finite kernel output")
    rec = {"phase": "faults", "n_pix": n_pix, "planted_per_branch": n_each,
           "branches": branches, "quarantined_exact": exact,
           "verdict_counts": counts,
           "kernel_vs_plain_verdict_mismatch_pixels": int(
               (vk != vq).sum()),
           "other_verdict_mismatch_vs_f64": other,
           "kernel_vs_f64": vs_ref, "plain_vs_f64": plain_vs_ref,
           "finite": finite}
    emit(rec)
    if failures:
        raise AssertionError("faults: " + "; ".join(failures))
    return rec


def phase_reference(device) -> dict:
    """The tiny TIP engine run: kernel path against the plain loop."""
    from kafka_tpu_torch.testing.synthetic import run_tip_engine

    _, out_k, _, _ = run_tip_engine(device=device)
    _, out_p, _, _ = run_tip_engine(
        device=device,
        solver_options={"relaxation": 0.7, "max_iterations": 40,
                        "use_pallas": False},
    )
    worst = 0.0
    qa_equal = True
    for ts in out_p.output:
        for key, ref in out_p.output[ts].items():
            got = out_k.output[ts][key]
            if key == "solver_qa":
                qa_equal = qa_equal and bool((got == ref).all())
            else:
                worst = max(worst, float(np.abs(got - ref).max()))
    rec = {"phase": "reference", "dates": len(out_p.output),
           "max_abs_err": worst, "solver_qa_equal": qa_equal}
    emit(rec)
    if worst > X_ATOL or not qa_equal:
        raise AssertionError(f"engine kernel path vs plain loop: {rec}")
    return rec


def land_mask(ny: int, nx: int, seed: int, land_frac: float = 0.8):
    """A seeded land mask: coarse noise upsampled and smoothed, the
    ``land_frac`` highest cells land."""
    rng = np.random.default_rng(seed)
    cell = 32
    coarse = rng.normal(size=(ny // cell + 2, nx // cell + 2))
    fine = np.kron(coarse, np.ones((cell, cell)))[:ny, :nx]
    for axis in (0, 1):
        fine = (fine + np.roll(fine, cell // 2, axis=axis)) / 2.0
    return fine > np.quantile(fine, 1.0 - land_frac)


def phase_main(device, ny: int = TILE, nx: int = TILE, seed: int = 0):
    """KalmanFilter.run over a full MODIS tile through the kernel.
    Returns the phase record and the kernel's inputs on date KEEP_DATE."""
    import torch

    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.core.propagators import tip_prior_arrays
    from kafka_tpu_torch.engine import (TIP_PARAMETER_LIST, KalmanFilter,
                                        jrc_prior)
    from kafka_tpu_torch.obsops import TwoStreamOperator
    from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                   SyntheticObservations)

    def day(i):
        return datetime.datetime(2021, 6, 1) + datetime.timedelta(days=i)

    t_setup = time.perf_counter()
    mask = land_mask(ny, nx, seed)
    rng = np.random.default_rng(seed)
    mean_h = tip_prior_arrays()[0]
    truth = np.clip(mean_h + rng.normal(0, 0.05, (ny, nx, 7)),
                    0.05, 0.95).astype(np.float32)
    grid_days = (0, 16, 32, 48)
    obs_days = (3, 10, 19, 26, 35, 42)
    op = TwoStreamOperator()
    obs = SyntheticObservations(
        [day(i) for i in obs_days], op, lambda date: truth, sigma=0.005,
        mask_prob=0.1, seed=seed, device=device,
    )
    out = MemoryOutput()
    prior = jrc_prior(device)
    kf = KalmanFilter(obs, out, mask, TIP_PARAMETER_LIST,
                      state_propagation=None, prior=prior, device=device)
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    setup_s = time.perf_counter() - t_setup

    # Keep the kernel's inputs on one date: the solver's call goes
    # through unchanged, the tensors are only referenced (nothing
    # writes into them afterwards).
    calls = []
    kept = {}

    def keep(*args, **kwargs):
        if len(calls) == KEEP_DATE:
            kept.update(zip(ROW_ARGS, args), corrupt=kwargs.get("corrupt"))
        calls.append(None)
        return fused_gn_rows(*args, **kwargs)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    solvers.fused_gn_rows = keep
    try:
        fused_gn_rows.launches = 0
        t0 = time.perf_counter()
        kf.run([day(i) for i in grid_days], x0, None, p_inv0)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches = fused_gn_rows.launches
    finally:
        solvers.fused_gn_rows = fused_gn_rows
    dates = kf.diagnostics_log
    finite = True
    for ts, rasters in out.output.items():
        for key, arr in rasters.items():
            finite = finite and bool(np.isfinite(arr).all())
            if arr.shape != mask.shape:
                raise AssertionError(f"{key} raster has shape {arr.shape}")
    per_date = [{
        "date": str(r["date"].date()), "n_iterations": r["n_iterations"],
        "convergence_norm": r["convergence_norm"],
        "chi2_per_band": r["chi2_per_band"],
        "cap_bailouts": r["cap_bailouts"],
        "damped_recovered": r["damped_recovered"],
        "quarantined": r["quarantined"], "nonfinite": r["nonfinite"],
        "wall_s": r["wall_s"],
    } for r in dates]
    rec = {
        "phase": "main", "tile": [ny, nx], "n_valid": kf.gather.n_valid,
        "n_pad": kf.gather.n_pad, "windows": len(grid_days) - 1,
        "dates_assimilated": len(dates), "kernel_launches": launches,
        "outputs_finite": finite, "setup_s": setup_s, "run_s": run_s,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "kept_date": KEEP_DATE,
        "per_date": per_date,
    }
    emit(rec)
    if launches != len(dates) or len(dates) != len(obs_days):
        raise AssertionError(
            f"{launches} kernel launches for {len(dates)} dates")
    if not finite:
        raise AssertionError("non-finite output raster")
    if not kept:
        raise AssertionError(f"no kernel call on date {KEEP_DATE}")
    return rec, kept


def phase_profile(device, n_pix: int, top: int = 6) -> dict:
    """One ``assimilate_date`` at the main path's pixel count under
    ``torch.profiler``: host wall, device busy time and the device time
    by kernel — where a date's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kafka_tpu_torch.core.solvers import assimilate_date
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    op, bands, x0, p_inv0 = make_tip_problem(n_pix, seed=2, device=device)
    opts = {"state_bounds": op.state_bounds,
            "norm_denominator": float(n_pix * 7)}
    assimilate_date(op.linearize, bands, x0, p_inv0, None, opts,
                    device=device)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = assimilate_date(op.linearize, bands, x0, p_inv0, None, opts,
                              device=device)
        int(out[2].n_iterations)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0)
        if dev_us and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    rec = {"phase": "profile", "n_pix": n_pix, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                                 if wall_ms else None),
           "top_kernels": [{"name": k[:80], "ms": ms, "count": c}
                           for k, ms, c in rows[:top]]}
    emit(rec)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kafka_tpu_torch.core import _build, fused_gn

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.load("fused_gn")
    build_s = time.perf_counter() - t0
    log = _build.BUILDS["fused_gn"]["log"]
    emit({
        "phase": "device", "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "nvcc_flags": list(_build.NVCC_FLAGS),
        "ptxas": [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln],
        "attributes": fused_gn.kernel_attributes(),
    })
    phase_reference(device)
    main_rec, kept = phase_main(device)
    tile = phase_kernel(device, "main_path_date", kept)
    small = phase_kernel(device, "2^19", problem_rows(2 ** 19, device),
                         plain_reps=3)
    phase_faults(device, kept)
    del kept
    phase_profile(device, main_rec["n_pad"])
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_gn", "route": "cuda",
        "source": "kafka_tpu_torch/csrc/fused_gn.cu",
        "replaces": KERNEL_REPLACES,
        "launches": main_rec["kernel_launches"],
        "max_abs_err": tile["max_abs_err"]["x"],
        "max_abs_err_vs_f64": tile["kernel_vs_f64"]["x"]["max"],
        "ms": tile["ms"], "plain_ms": tile["plain_ms"],
        "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
        "library_ms": None,
        "n_pix": tile["n_pix"],
        "at_2^19": {k: small[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")},
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
