"""GPU smoke run of the PyTorch/CUDA port (kafka_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero without one, and without the
kafka_tpu_torch package beside it.  Imports neither JAX nor kafka_tpu.
The three kernels (csrc/fused_gn.cu, fused_update.cu with its nine
(p, bands) instances, solve_rows.cu) are built at the start, one nvcc
each, in parallel.  Phases, each printing
one JSON line:

1. device — card, torch/CUDA versions, build time, registers and spills;
2. reference — a small TIP engine run through the fused Gauss-Newton
   kernel against the port's plain loop (use_pallas=False), date by date,
   its one-acquisition windows run as fused blocks (scan_window 8):
   fused_gn launches must equal the dates;
3. reference_s2 — a small Sentinel-2 PROSAIL engine run through the row
   loop (fused update at (10, 10)) against the plain loop, and the small
   TIP run with inkernel_linearize=False (fused update at (7, 2)) against
   it too, both fused: fused-update launches must equal the iterations;
4. main — KalmanFilter.run over one 2400 x 2400 MODIS tile under a
   seeded land mask: TwoStreamOperator, jrc_prior, prior-only advance,
   3 windows of 16 days with 2 acquisitions each.  Kernel launch counts
   are reset just before and read just after; the fused Gauss-Newton
   kernel's inputs on the second date (an advanced state) are kept;
5. kernel — the fused Gauss-Newton kernel against its plain PyTorch
   version on those kept inputs (the main path's shapes and data), then
   on make_tip_problem(2**19) (the JAX bench's device size) and on the
   GROUP_CASES (convergence groups of 8, 256 and 512 px, every other one
   unobserved, so every cluster shape runs and its sum decides the
   trips): held to the plain version run in float64 as set out below,
   and timed; with the trips per group, the cluster geometry,
   the modelled HBM bytes of the per-trip and the staged design and the
   share of the bound;
6. faults — the kept inputs with planted corrupt, Cholesky-breakdown,
   recoverable and NaN-nodata pixels under a one-iteration cap, so every
   verdict branch fires: verdicts of the planted pixels, the quarantined
   set and the quarantined outputs must be identical;
7. main_s2 — KalmanFilter.run over one 1098 x 1098 Sentinel-2 sub-tile
   (1,205,604 px): ProsailOperator, sail_prior, no propagation with
   Q = 0, relaxation 0.7, the Barrax grid (2017-07-03 to 07-11, 2-day
   steps), one acquisition per step, so the engine fuses blocks of two
   where its guards let it (``fused`` printed per date).  Launch counts
   reset before, read after: fused-update launches must equal the dates'
   iterations.  The fused update's inputs of the second date's first
   iteration are kept;
8. kernel_update — the fused update against its plain version on those
   kept inputs and on make_prosail_problem(2**19), by the same float64
   rule; flags equal; timed;
9. faults_update — the kept inputs with planted indefinite P_f^-1, LM
   escalation, NaN y under a false mask and a non-finite Jacobian entry:
   x, A and the flags identical to the plain version's on those pixels,
   and no NaN leaks;
10. kernel_solve — the packed solve on the normal equations of the kept
   S2 date (p=10), on them with 64 planted non-SPD and 64 zero-pivot
   pixels, on the kept TIP date's (p=7), and on the SOLVE_CASES (seeded
   SPD systems at 2^19 px, p=10, and at 2^19 + 3 px for p = 2, 7, 10:
   the cp.async route, ending on a ragged tile): each first once through
   solve_spd_packed_kernel with the counts reset (its own path: one
   launch), then bit for bit against its plain version (0 pixels may
   differ; NaN equals NaN) and against a float64 solve, timed beside
   torch.linalg.solve on the dense batch, with its route and launch
   geometry (held to the compiled kernel's); both routes must run;
11. profile, profile_s2 — one TIP tile date and one S2 sub-tile date
   under torch.profiler (device busy time, idle share, time by kernel);
   the TIP phase also times the dense<->packed information copies;
12. cli — the torch ``run_synthetic --operator twostream`` as a user
   runs it (``kafka_tpu_torch.cli.run_synthetic.main``, in-process) over
   the 2400 x 2400 tile under the land mask of phase main, written as a
   GeoTIFF outside the output folder: 8 windows of one acquisition,
   prefetch, temporal fusion, the exact information propagator,
   checkpoints and GeoTIFF outputs.  Gates: the summary line printed;
   fused_gn launches equal the dates; the block plan equal to the one
   the engine's guards give for this n_pad (``block_plan``, the
   constants copied here), with a block of at least 2; windows x 15
   GeoTIFFs, finite on the mask, each read back bit-identical to a
   MemoryOutput copy of the same dumps; the same inputs with
   scan_window=1 bit-identical; a run stopped after 4 windows and resumed
   from its checkpoint ending bit-identical to the uninterrupted run's
   last checkpoint; then the kernel (phase kernel, case
   ``cli_fused_date``) on its inputs of a date inside a fused block,
   whose prior information is a dense propagated P^-1.  It prints
   wall_s and pixel_steps_per_s, the per-block wall time, one
   propagate_information_filter over the tile, the writer's flush and
   close time and peak queue depth, the codec path (the native codec
   must build) and the peak device bytes.  Its files go to
   ``build/chip_smoke_cli`` in the checkout and are removed after;
13. main_joint — KalmanFilter.run over the S2 sub-tile in the joint
   S2 + S1 configuration (11-parameter state, joint_state_bounds, the
   exact information propagator, 6 S2 and 6 S1 dates interleaved on a
   2-day grid, a seeded per-pixel incidence angle in 30-45 degrees): the
   fused update at (11, 10) on S2 dates and (11, 2) on S1 dates, launches
   per instance equal to the iterations of its sensor's dates, no block
   fusing two sensors, mean |sm - 0.4| over the S1-observed pixels below
   0.05; the per-date wall split S2 / S1 and the peak device bytes.  Then
   kernel_update and faults_update on the kept inputs of its first S1 date
   and its second S2 date;
14. cli_wcm — the torch ``run_synthetic --operator wcm`` over phase cli's
   tile (8 windows, no checkpoint): the summary line, the block plan,
   fused-update launches at (2, 2) equal to the iterations, every GeoTIFF
   read back bit-identical to a MemoryOutput copy; then kernel_update and
   faults_update at (2, 2) on a kept date.  The (7, 2) instance is timed
   on the TIP tile date's inputs (phase kernel_update, after
   kernel_solve);
15. cli_s2 — the torch ``run_s2`` driver as users run it
   (``kafka_tpu_torch.cli.run_s2.main``, in-process, ``--config``
   saved from ``default_config()`` with 1098 x 1098 chunks) over a
   Sentinel-2 granule tree written on disk (2196 x 2196 px, uint16 DN,
   four July 2017 dates, one per window) under phase main's land mask:
   four chunks, each through the S2 reader, the SAIL prior, the engine
   and the GeoTIFF writer, with restart markers.  Gates: 4 chunks run,
   16 chunk-dates assimilated, fused-update launches at (10, 10) equal
   to the chunks' iterations, every expected GeoTIFF present and finite,
   the median LAI nearer the truth than the prior's, a second run that
   skips every chunk and writes nothing, the port's mosaic equal to the
   chunk rasters bit for bit; then kernel_update on a kept chunk date,
   where 0 pixels may differ from the plain version.  Reduced: 4 of a
   10980 x 10980 tile's 100 chunks, 4 dates;
16. cli_modis — the torch ``run_modis`` driver over an MCD43 series
   written on disk (the 2400 x 2400 tile, 4 dates 16 days apart, one per
   window of the driver's own grid, ``period`` 1) under phase main's
   land mask, the whole tile one chunk: one fused_gn launch per date,
   every GeoTIFF present and finite, the median TeLAI nearer the truth
   than the JRC prior's; then phase kernel on a kept date.  Reduced: 4
   of the annual run's 23 windows.  Both driver phases print wall_s,
   the per-chunk and per-date walls, reader seconds per date, pixel
   steps/s, peak device bytes and their seconds; their files live in
   ``build/chip_smoke_cli`` and are removed after;
17. cli_mod09 — the torch ``run_mod09`` driver over a MOD09GA tree
   written on disk (the 2400 x 2400 500 m tile, its 1 km QA and angle
   rasters, 8 daily dates from 2017-06-01) under phase main's land mask
   in four 1200 x 1200 chunks: the 21-parameter Ross-Li kernel-weight
   state on the dense large-p solve (torch.linalg Cholesky) under the
   exact information filter.  Gates: 4 chunks and 32 chunk-dates run, 0
   hand-kernel launches, every GeoTIFF present and finite on the mask,
   the median b1_iso of the last window within 0.02 of the truth, a
   restart that skips all 4 chunks and writes nothing, the first chunk
   run alone unfused equal to the fused run bit for bit; the dense
   update split into assembly, Cholesky and triangular solves on a kept
   chunk date, and the propagation.  Reduced: 8 of the config's 30
   days, 1200 x 1200 chunks instead of 256 x 256;
18. per_pixel — phase main's tile run with per_pixel_convergence: (7, 2)
   fused-update launches equal the iterations, the converged fraction
   and its gauge equal the frozen mask's mean, held to the plain loop
   (use_pallas False) as phase reference holds its runs; the first date
   again in the engine's default linearisation blocks, its wall
   recorded; then kernel_update on a kept iteration's inputs (0 pixels
   may differ);
19. band_seq — one window of the tile with band_sequential: (7, 1)
   launches equal the per-band iterations, no block fused, held to the
   plain loop; kernel_update and faults_update at (7, 1) on kept
   inputs;
20. band_seq_fleet — one window each of the WCM, S2 and joint states
   with band_sequential on a 512 x 512 tile: launches at (2, 1),
   (10, 1) and (11, 1) equal each run's per-band iterations, no block
   fused, outputs finite; kernel_update at each instance on a kept
   iteration's inputs (0 pixels may differ) and on seeded 2^19-px rows
   by the float64 rule;
21. hessian — one tile date with hessian_correction (one fused_gn
   launch, then the correction and the eigenvalue floor): A finite,
   every pixel at or above the floor, the correction on 4096 sampled
   pixels within 1e-4 of a float64 torch.func evaluation, untouched
   pixels' A equal to A - C bit for bit; the ms of the Hessian and of
   the batched eigh;
22. smooth (run inside phase cli's working directory, right after it) —
   ``kafka_smooth.main`` over the checkpoint chain phase cli's driver
   left: one smoothed product per chain date, finite on the mask; the
   newest date's x the chain's analysis bit for bit; diag(P_s^-1) >=
   diag(P_a^-1) everywhere (clamp counts printed); the QA bits; on
   SMOOTH_SAMPLE seeded pixels within the JAX test's budget of a
   float64 run of the port's own sweep; no hand-kernel launch; the chain
   load, sweep, batched-inverse and write times, peak device bytes and
   the x_sha256 of the newest and the oldest date;
23. serve — ``kafka_serve.main`` in-process over two 2400 x 2400
   two-stream tiles, the inbox filled first with each tile's cold,
   cache, warm_noop, warm, cold_replay and smoothed requests: every
   outcome and every response ok, warm equal to a cold serve on a fresh
   checkpoint directory, smoothed equal to kafka_smooth over the chain,
   fused_gn launched and its plain version never; per-request wall_ms
   by served_from with the trace phases, checkpoint saves, the bucket
   warm-up;
24. serve_batch — coalesced rounds at full width: two tiles over one
   mask, the JAX test's micro-window, its ladder (cold, warm_noop and
   warm groups, a mixed cache-hit / miss group), once two-stream (one
   fused_gn launch per round over both members) and once identity (one
   (2, 2) fused-update launch per iteration): every member equal to its
   one-at-a-time baseline bit for bit, at least 3 coalesced rounds, the
   launches per round, and the kept coalesced launches held to their
   plain versions.

Then the card's name and power limit as nvidia-smi gives them, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
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
# float32 plain version's.  The one exception is a group that rounding
# decides: one whose trip count the float32 plain version itself changes
# when x_f moves by one ulp, up or down (its step norm lies on its
# threshold).  There the kernel's trip count, and its pixels' verdicts,
# may instead equal those of the nudged float32 plain version or of the
# float64 reference; such groups are counted.  Where the float32 plain
# version is steady under the nudge, nothing is waived.  The
# solve-health branches are held exactly by the faults phase.
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
#: what a per-trip design of the kernel moves (floats per pixel), one
#: that keeps nothing on chip: on every executed trip it re-reads y,
#: r_inv, mask, x_f and P_f^-1 and re-writes A, fwd and inn; once, it
#: reads x_f at the start and the mask and x_f in the epilogue, and
#: writes x, st and hl.
PER_TRIP_FLOATS = 6 + 7 + 28 + 28 + 2 + 2
PER_TRIP_ONCE_FLOATS = 7 + 2 + 7 + 7 + 2 + 9
#: float32 operations per pixel per Gauss-Newton trip, counted from
#: csrc/fused_gn.cu: two-stream value + 4-tangent Jacobian 670 (2 bands),
#: y~ 30, A 168, rhs 42, LM inflation 28, Cholesky 147, substitution 98,
#: step/clip 35, fwd/inn 46, step norm 21; and once per pixel the prior
#: term P_f^-1 x_f, 91.
FLOPS_PER_PIXEL_TRIP = 670 + 30 + 168 + 42 + 28 + 147 + 98 + 35 + 46 + 21
FLOPS_PER_PIXEL_ONCE = 91
#: the extra kernel cases (label, n, tol): make_tip_problem sizes whose
#: convergence group gcd(n, 2048) is 8 px (one warp, 24 of its threads
#: idle), 256 (one CTA) and 512 (a cluster of 2 CTAs); the main path and
#: 2^19 give groups of 2048 (8 CTAs).  Built as
#: tests/test_torch_fused_gn.py's per-group-size test builds its inputs
#: (group_case_rows): every other group unobserved, so it stops at the
#: 2-trip minimum, and damped steps (relaxation 0.5) under a tight tol,
#: so every observed group runs more than 2 trips and its stop hangs on
#: the whole cluster's sum.  8-px groups take a looser tol (2e-3): under
#: 1e-3 single pixels hold some 8-px groups to the iteration cap.
GROUP_CASES = (("group_8", 8 * 1001, 2e-3),
               ("group_256", 256 * 1001, 1e-4),
               ("group_512", 512 * 501, 1e-4))
GROUP_RELAXATION = 0.5

TILE = 2400
KERNEL_REPLACES = "kafka_tpu/core/pallas_solve.py:255"
UPDATE_REPLACES = "kafka_tpu/core/pallas_solve.py:124"
SOLVE_REPLACES = "kafka_tpu/core/pallas_solve.py:72"
#: one Sentinel-2 sub-tile: the JAX harness's S2 chunk (BASELINE.md:32-33).
S2_TILE = 1098
#: kernel inputs kept from this main-path date (0-based).
KEEP_DATE = 1
#: the MODIS tile run's time grid and acquisition days (days from
#: 2021-06-01): 4 windows, 6 dates.
TIP_GRID_DAYS = (0, 16, 32, 48)
TIP_OBS_DAYS = (3, 10, 19, 26, 35, 42)
#: positional arguments of the solver's fused_gn_rows call.
ROW_ARGS = ("lin_rows", "y", "r_inv", "mask_f", "xf_rows", "pf_rows", "tol",
            "min_iterations", "max_iterations", "relaxation",
            "state_bounds_rows", "norm_denominator")
ROW_INPUTS = ("y", "r_inv", "mask_f", "xf_rows", "pf_rows")
OUTPUTS = ("x", "A", "fwd", "inn", "st", "hl")

#: the cli phase: the driver's arguments (one acquisition every 4 days
#: over 32 days on a 4-day grid: 8 one-acquisition windows) and the
#: fused_gn call kept for the kernel phase (0-based date; date 0 is the
#: unfused head window, dates 1 and 2 the first fused block).
CLI_ARGS = ("--operator", "twostream", "--days", "32", "--step", "4",
            "--obs-every", "4", "--checkpoint")
CLI_KEEP_DATE = 2
CLI_RESUME_WINDOWS = 4
#: the engine's fusion guards (kafka_tpu/engine/filter.py:920-922 and the
#: port's copy), copied here: a block of k windows must hold k*n*p state
#: elements and 3*k*B*n band elements; the tile has no aux.
SCAN_MAX_STATE_ELEMS = 100_000_000
SCAN_MAX_BAND_ELEMS = 100_000_000
SCAN_MAX_AUX_BYTES = 64 * 1024 * 1024
SCAN_WINDOW = 8

#: the joint S2 + S1 configuration (kafka_tpu/cli/run_joint.py:47-57,
#: tools/measure_baseline.py:142-172): 6 S2 dates from 2017-07-01 and 6
#: S1 dates from 2017-07-03 17:00, 4 days apart and interleaved, on a
#: 2-day grid from a day before the first date to a day after the last;
#: information propagated with Q = 1e-3 (1e-2 for soil moisture).
JOINT_N_DATES = 6
JOINT_Q = (1e-3,) * 10 + (1e-2,)
#: S1 observation sigma (the S2 sources' is 0.005).
JOINT_S1_SIGMA = 0.01
#: the S1 IW swath's incidence angles (degrees), drawn per pixel.
JOINT_THETA = (30.0, 45.0)
#: the joint run's soil-moisture gate (tests/test_joint.py:159-160).
JOINT_SM_GATE = 0.05
#: the joint run's kept dates (0-based): its first S1 date and its second
#: S2 date, the first S2 date on an advanced state.
JOINT_KEEP = {(11, 2): 1, (11, 10): 2}
#: the cli_wcm phase: the WCM driver over the cli tile, no checkpoint.
CLI_WCM_ARGS = ("--operator", "wcm", "--days", "32", "--step", "4",
                "--obs-every", "4")
#: the cli_s2 phase: run_s2 over a 2 x 2-chunk S2 tile of 1098 x 1098
#: chunks (the JAX harness's S2 chunk, tools/measure_baseline.py:204-207)
#: on four July 2017 acquisitions, one per window of the Barrax grid; the
#: fused update's inputs kept on this 0-based date of the run.
CLI_S2_TILE = 2 * S2_TILE
CLI_S2_DAYS = (4, 6, 8, 10)
CLI_S2_KEEP_DATE = 1
#: the cli_modis phase: run_modis over the MODIS tile, 4 MCD43 dates 16
#: days apart from 2017-01-01 on the driver's grid, which ends at
#: CLI_MODIS_END (4 windows of the annual 23); fused_gn inputs kept on
#: this 0-based date.
CLI_MODIS_DATES = 4
CLI_MODIS_END = datetime.datetime(2017, 3, 6)
CLI_MODIS_KEEP_DATE = 1
#: the fused-update instances and the path each runs on.
UPDATE_PATHS = {(10, 10): "main_s2", (7, 2): "reference_s2 (tip_rowloop)",
                (2, 2): "cli_wcm", (11, 10): "main_joint",
                (11, 2): "main_joint", (7, 1): "band_seq",
                (2, 1): "band_seq_fleet (WCM)", (10, 1): "band_seq_fleet (S2)",
                (11, 1): "band_seq_fleet (joint)"}
#: the cli_mod09 phase: run_mod09 over the 2400 x 2400 MOD09GA tile (the
#: 1 km QA and angle grid is 1200 x 1200), CLI_MOD09_DATES daily dates
#: from 2017-06-01 on the driver's daily grid cut to CLI_MOD09_END (its
#: windows are [t, t + 1 day), so one date per window), in
#: CLI_MOD09_CHUNK x CLI_MOD09_CHUNK chunks; the dense update's inputs
#: are kept on this 0-based date of the run.
CLI_MOD09_DATES = 8
CLI_MOD09_END = datetime.datetime(2017, 6, 9)
CLI_MOD09_CHUNK = 1200
CLI_MOD09_KEEP_DATE = 1
#: the median b1_iso of the last window within this of the truth (the
#: JAX driver test's budget, tests/test_drivers.py:228-231).
MOD09_ISO_GATE = 0.02
#: phase per_pixel keeps the (7, 2) fused update's inputs on this date.
PER_PIXEL_KEEP_DATE = 1
#: phases per_pixel and band_seq linearise the tile in one block (the
#: ``linearize_block`` solver option; the same values as the engine's
#: default ENGINE_BLOCK-px blocks): per block, the eager torch.func
#: linearisation pays its launches again (phase per_pixel times one
#: linearisation of the tile both ways).
ONE_BLOCK = 1 << 30
ENGINE_BLOCK = 262144
#: phase band_seq_fleet's all-valid tile side: one window each of the
#: WCM, S2 and joint states in band-sequential mode (its time is the
#: eager per-band linearisation's dispatch, which hardly grows with the
#: tile up to one ENGINE_BLOCK).
BAND_SEQ_FLEET_TILE = 512
#: the hessian phase's sampled pixels and the relative budget of the
#: correction against a float64 evaluation.
HESSIAN_SAMPLE = 4096
HESSIAN_RTOL = 1e-4
#: phase smooth: the seeded pixel sample held to a float64 sweep, and the
#: JAX test's budget (tests/test_smoother.py:291,297: x rtol 1e-3 and
#: atol 1e-4, the information diagonal rtol 2e-3).
SMOOTH_SAMPLE = 65536
SMOOTH_SAMPLE_SEED = 9
SMOOTH_X_RTOL = 1e-3
SMOOTH_X_ATOL = 1e-4
SMOOTH_DIAG_RTOL = 2e-3
#: phase serve: the synthetic tiles' calendar (observations every 2 days
#: from 2017-07-02 over SERVE_DAYS days on a 4-day grid from 2017-07-01),
#: and the index of each grid window's first date in it.
SERVE_DAYS = 16
SERVE_WINDOW_DATES = {1: 0, 2: 2, 3: 4, 4: 6}
#: phase serve_batch: the JAX test's micro-window
#: (tests/test_serve_batch.py:353).
SERVE_BATCH_WINDOW_MS = 1500.0


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

    from kafka_tpu_torch.core.linalg import pack_rows
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
        pf_rows=pack_rows(p_inv0),
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
    out = {nm: quantile_summary(err[nm], lim) for nm, lim in budget.items()}
    out["verdict_mismatch_pixels"] = int(err["verdict"].sum())
    out["max_group_trip_diff"] = float(err["trips"].max())
    return out


def phase_kernel(device, label: str, rows: dict, kernel_reps: int = 20,
                 plain_reps: int = 2, observed=None,
                 hold_f64_quantiles: bool = True) -> dict:
    """The CUDA kernel against its plain version on ``rows`` (float32,
    float64, and float32 on x_f moved by one ulp up and down), both
    timed, and the function's bound.  ``hold_f64_quantiles=False``
    records the float64 quantile rule's outcome (``f64_quantile_rule``)
    instead of failing on it; every other gate holds."""
    import torch

    from kafka_tpu_torch.core import fused_gn

    n_pix = rows["pf_rows"].shape[1]
    # A folded launch of several members (phase serve_batch) pins its
    # groups to one member's size: ``rows["block"]``.
    block = fused_gn._block(n_pix, rows.get("block", 2048))
    kern = fused_gn.fused_gn_raw(**rows)
    plain = fused_gn.fused_gn_raw_plain(**rows)
    ref = plain_f64(rows)
    xf = rows["xf_rows"]
    nudged = [fused_gn.fused_gn_raw_plain(**{
        **rows, "xf_rows": torch.nextafter(xf, torch.full_like(xf, to))})
        for to in (float("inf"), float("-inf"))]
    plain_ulp = nudged[0]
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
    group_trips = kern[4][0, ::block]
    trips = float(group_trips.sum())
    bytes_moved = 4 * (MIN_FLOATS_PER_PIXEL * n_pix
                       + MIN_FLOATS_PER_GROUP * (n_pix // block))
    flops = (FLOPS_PER_PIXEL_TRIP * trips * block
             + FLOPS_PER_PIXEL_ONCE * n_pix)
    rec = {
        "phase": "kernel", "case": label, "n_pix": n_pix, "block": block,
        "tol": rows["tol"], "relaxation": rows["relaxation"],
        "finite": finite,
        "max_abs_err": {nm: float((a - b).abs().max()) for nm, a, b
                        in zip(OUTPUTS[:4], kern, plain)},
        "n_done_kernel": int(kern[4][0].max()),
        "n_done_plain": int(plain[4][0].max()),
        "trips_per_group": {"mean": float(group_trips.mean()),
                            "max": float(group_trips.max()),
                            "histogram": dict(zip(*(t.tolist() for t in (
                                torch.unique(group_trips.int(),
                                             return_counts=True)))))},
        "kernel_vs_plain": vs_plain, "kernel_vs_f64": vs_ref,
        "plain_vs_f64": plain_vs_ref, "plain_ulp_vs_plain": ulp_vs_plain,
        **held_trips(kern, plain, ref, nudged, block),
        "ms": ms, "plain_ms": plain_ms,
        "layout_bytes": 4 * LAYOUT_FLOATS_PER_PIXEL * n_pix,
        # HBM bytes each design moves on this run's trips (a model, not
        # a counter): per-trip re-reads, and the staged design's one pass
        # over the layout.
        "modelled_hbm_bytes": {
            "per_trip_design": 4 * (PER_TRIP_FLOATS * trips * block
                                    + PER_TRIP_ONCE_FLOATS * n_pix),
            "staged_design": 4 * LAYOUT_FLOATS_PER_PIXEL * n_pix},
        "geometry": {**fused_gn.kernel_geometry(n_pix, block),
                     "registers": fused_gn.kernel_attributes()["registers"]},
        **bound(bytes_moved, flops),
    }
    rec["share_of_bound"] = rec["bound_ms"] / ms
    rec["f64_quantile_rule"] = held_quantiles(vs_ref, plain_vs_ref,
                                              ("x", "A", "diag"))
    emit(rec)
    failures = list(rec["f64_quantile_rule"]) if hold_f64_quantiles else []
    mirror = fused_gn.launch_geometry(n_pix, block)
    if any(rec["geometry"][k] != v for k, v in mirror.items()):
        failures.append(f"launch_geometry {mirror} is not the kernel's "
                        f"{rec['geometry']}")
    if not finite:
        failures.append("non-finite kernel output")
    if rec["groups_differing"]:
        failures.append(f"{rec['groups_differing']} group trip counts "
                        "differ")
    if rec["verdicts_differing"]:
        failures.append(f"{rec['verdicts_differing']} verdicts differ")
    if observed is not None and not bool(
            (plain[4][0, ::block][observed] > rows["min_iterations"]).all()):
        failures.append("an observed group stopped at the trip minimum")
    if failures:
        raise AssertionError(f"kernel ({label}): " + "; ".join(failures))
    return rec


def held_trips(kern, plain, ref, nudged, block: int) -> dict:
    """The trip-count and verdict gate (see the head of this file): the
    groups that rounding decides (the float32 plain version's trip count
    moves under a 1-ulp nudge of x_f, one of ``nudged``), the groups and
    pixels where the kernel differs from the float32 plain version
    outside that waiver, and those where it took the waiver."""
    import torch

    def trips(t):
        return t[4][0, ::block]

    def verdicts(t):
        return t[5][0]

    decided = torch.zeros_like(trips(plain), dtype=torch.bool)
    for t in nudged:
        decided |= trips(t) != trips(plain)

    def differing(get, waived):
        k = get(kern)
        other = k != get(plain)
        alternative = torch.zeros_like(other)
        for t in (ref, *nudged):
            alternative |= k == get(t)
        taken = other & waived & alternative
        return int((other & ~taken).sum()), int(taken.sum())

    groups, groups_waived = differing(trips, decided)
    pixels, pixels_waived = differing(
        verdicts, decided.repeat_interleave(block))
    return {"rounding_decided_groups": int(decided.sum()),
            "groups_differing": groups, "groups_waived": groups_waived,
            "verdicts_differing": pixels, "verdicts_waived": pixels_waived}


def group_case_rows(n_pix: int, tol: float, device):
    """make_tip_problem(n_pix) in the row layout with every other
    convergence group unobserved (NaN y, zero weight and mask), damped
    by GROUP_RELAXATION under ``tol``; returns the rows and the mask of
    the observed groups."""
    import torch

    from kafka_tpu_torch.core.fused_gn import launch_geometry

    rows = problem_rows(n_pix, device)
    block = launch_geometry(n_pix)["group"]
    group = torch.arange(n_pix, device=device) // block
    unobserved = group % 2 == 1
    for key, fill in (("y", float("nan")), ("r_inv", 0.0), ("mask_f", 0.0)):
        rows[key] = rows[key].masked_fill(unobserved, fill)
    rows.update(tol=tol, relaxation=GROUP_RELAXATION)
    return rows, torch.arange(n_pix // block, device=device) % 2 == 0


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
    failures += held_quantiles(vs_ref, plain_vs_ref, ("x", "A", "diag"))
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
    """The tiny TIP engine run, its one-acquisition windows fused: kernel
    path against the plain loop."""
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.testing.synthetic import run_tip_engine

    fused_gn_rows.launches = 0
    kf, out_k, _, _ = run_tip_engine(scan_window=SCAN_WINDOW, device=device)
    launches = fused_gn_rows.launches
    _, out_p, _, _ = run_tip_engine(
        device=device, scan_window=SCAN_WINDOW,
        solver_options={"relaxation": 0.7, "max_iterations": 40,
                        "use_pallas": False},
    )
    rec = {"phase": "reference", "dates": len(out_p.output),
           "fused_per_date": [r.get("fused") for r in kf.diagnostics_log],
           "launches": launches, **compare_runs(out_k, out_p)}
    emit(rec)
    if rec["max_abs_err"] > X_ATOL or not rec["solver_qa_equal"]:
        raise AssertionError(f"engine kernel path vs plain loop: {rec}")
    if launches != len(kf.diagnostics_log):
        raise AssertionError(f"{launches} fused_gn launches for "
                             f"{len(kf.diagnostics_log)} dates")
    return rec


def outputs_finite(out, shape) -> bool:
    """All of a MemoryOutput's rasters finite; raises on a wrong shape."""
    finite = True
    for ts, rasters in out.output.items():
        for key, arr in rasters.items():
            finite = finite and bool(np.isfinite(arr).all())
            if arr.shape != shape:
                raise AssertionError(f"{key} raster has shape {arr.shape}")
    return finite


def date_records(dates, peaks=None) -> list:
    """The per-date diagnostics a main-path phase prints."""
    recs = [{
        "date": str(r["date"].date()), "n_iterations": r["n_iterations"],
        "convergence_norm": r["convergence_norm"],
        "chi2_per_band": r["chi2_per_band"],
        # None in the modes without solve health (per-pixel, dense).
        "cap_bailouts": r.get("cap_bailouts"),
        "damped_recovered": r.get("damped_recovered"),
        "quarantined": r.get("quarantined"), "nonfinite": r.get("nonfinite"),
        "converged_frac": r.get("converged_frac"),
        "wall_s": r["wall_s"], "fused": r.get("fused"),
    } for r in dates]
    for rec, peak in zip(recs, peaks or ()):
        rec["peak_device_bytes"] = peak
    return recs


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
    """KalmanFilter.run over a full MODIS tile through the kernel
    (``tip_tile_run``: 4 windows, 6 dates).  Returns the phase record and
    the kernel's inputs on date KEEP_DATE."""
    import torch

    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows

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
        kf, out, run_s = tip_tile_run(device, ny, nx, seed)
        setup_s = time.perf_counter() - t0 - run_s
        launches = fused_gn_rows.launches
    finally:
        solvers.fused_gn_rows = fused_gn_rows
    dates = kf.diagnostics_log
    finite = outputs_finite(out, kf.gather.mask.shape)
    per_date = date_records(dates)
    rec = {
        "phase": "main", "tile": [ny, nx], "n_valid": kf.gather.n_valid,
        "n_pad": kf.gather.n_pad, "windows": len(TIP_GRID_DAYS) - 1,
        "dates_assimilated": len(dates), "kernel_launches": launches,
        "outputs_finite": finite, "setup_s": setup_s, "run_s": run_s,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "kept_date": KEEP_DATE,
        "per_date": per_date,
    }
    emit(rec)
    if launches != len(dates) or len(dates) != len(TIP_OBS_DAYS):
        raise AssertionError(
            f"{launches} kernel launches for {len(dates)} dates")
    if not finite:
        raise AssertionError("non-finite output raster")
    if not kept:
        raise AssertionError(f"no kernel call on date {KEEP_DATE}")
    return rec, kept


def phase_profile(device, n_pix: int) -> dict:
    """One ``assimilate_date`` at the main path's pixel count under
    ``torch.profiler``: host wall, device busy time and the device time
    by kernel — where a date's time goes.  Then the dense <-> packed
    copies of the information matrix on that date's shapes: the one
    indexed gather each way (``linalg.pack_rows`` / ``unpack_rows``)
    beside the slice-stacking they replace, both timed here and held
    bit-identical."""
    import torch

    from kafka_tpu_torch.core.linalg import pack_rows, unpack_rows
    from kafka_tpu_torch.core.solvers import assimilate_date
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    op, bands, x0, p_inv0 = make_tip_problem(n_pix, seed=2, device=device)
    opts = {"state_bounds": op.state_bounds,
            "norm_denominator": float(n_pix * 7)}
    assimilate_date(op.linearize, bands, x0, p_inv0, None, opts,
                    device=device)
    _sync(device)
    out = {}

    def run():
        out["r"] = assimilate_date(op.linearize, bands, x0, p_inv0, None,
                                   opts, device=device)
        int(out["r"][2].n_iterations)

    prof = profile_device(run, device, top=6,
                          match=("fused_gn_kernel", "scatter_gather"))
    a_dense = out["r"][1].contiguous()
    p = 7

    def stack_pack(a):
        return torch.stack([a[:, i, j].to(torch.float32) for i in range(p)
                            for j in range(i + 1)])

    def stack_unpack(rows):
        def at(i, j):
            return rows[tri(max(i, j)) + min(i, j)]
        return torch.stack([torch.stack([at(i, j) for j in range(p)],
                                        dim=-1) for i in range(p)], dim=-2)

    rows = pack_rows(a_dense)
    copies = {
        "bit_identical": bool(torch.equal(rows, stack_pack(a_dense)))
        and bool(torch.equal(unpack_rows(rows), stack_unpack(rows))),
        "pack_gather_ms": time_ms(lambda: pack_rows(a_dense), device, 10),
        "pack_stack_ms": time_ms(lambda: stack_pack(a_dense), device, 10),
        "unpack_gather_ms": time_ms(lambda: unpack_rows(rows), device, 10),
        "unpack_stack_ms": time_ms(lambda: stack_unpack(rows), device, 10),
    }
    # The most trips any group ran (2, the minimum, means all ran 2):
    # the trips set the kernel's share of the date.
    rec = {"phase": "profile", "n_pix": n_pix,
           "n_iterations": int(out["r"][2].n_iterations),
           **prof, "information_copies": copies}
    emit(rec)
    if not copies["bit_identical"]:
        raise AssertionError("gather pack/unpack differs from stacking")
    return rec


def tri(p: int) -> int:
    from kafka_tpu_torch.core.linalg import tri_rows

    return tri_rows(p)


def chol_solve_flops(p: int) -> int:
    """float32 operations of one packed Cholesky and substitution,
    counted from csrc/packed_chol.cuh."""
    chol = sum(2 * j + 2 + (p - 1 - j) * (2 * j + 1) for j in range(p))
    return chol + 2 * p * p


def update_flops(p: int, nb: int) -> int:
    """float32 operations per pixel of one fused update, counted from
    csrc/fused_update.cu: the P_f^-1 x_f product, per band J.x_lin, y~,
    the innovation, w J and the rank-1 updates of A and rhs, the LM
    inflation, then the factor and the substitution."""
    per_band = (2 * p - 1) + 3 + p + 2 * tri(p) + 2 * p
    return p * (2 * p - 1) + nb * per_band + 5 * p + chol_solve_flops(p)


def update_floats(p: int, nb: int) -> tuple:
    """(read, written) floats per pixel of the fused update: J, H0, y, w,
    mask, x_lin, x_f, packed P_f^-1 and esc in; x, packed A, the
    innovations and the two flags out."""
    return nb * p + 4 * nb + 2 * p + tri(p) + 1, p + tri(p) + nb + 2


def bound(bytes_moved: float, flops: float) -> dict:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": bytes_moved, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def same_or_both_nan(a, b):
    return (a == b) | (a.isnan() & b.isnan())


def quantile_summary(err, limit=None) -> dict:
    """QUANTILES and max of a per-pixel error (and the count over
    ``limit``)."""
    import torch

    s = torch.sort(err.double()).values
    n = s.numel()
    out = {str(q): float(s[min(n - 1, int(q * n))]) for q in QUANTILES}
    out["max"] = float(s[-1])
    if limit is not None:
        out["beyond_budget"] = int((s > limit).sum())
    return out


def held_quantiles(kernel_vs_ref: dict, plain_vs_ref: dict, names) -> list:
    failures = []
    for nm in names:
        for q in map(str, QUANTILES):
            kq, pq = kernel_vs_ref[nm][q], plain_vs_ref[nm][q]
            if kq > max(ERR_MARGIN * pq, ERR_FLOOR):
                failures.append(f"{nm} error at quantile {q}: kernel {kq:.3g}"
                                f" > {ERR_MARGIN} x plain {pq:.3g}")
    return failures


def compare_runs(engine_a, engine_b) -> dict:
    """Largest output difference (QA excluded) and QA equality of two
    MemoryOutput runs over the same timesteps."""
    worst = 0.0
    qa_equal = sorted(engine_a.output) == sorted(engine_b.output)
    for ts in engine_b.output:
        for key, ref in engine_b.output[ts].items():
            got = engine_a.output[ts][key]
            if key == "solver_qa":
                qa_equal = qa_equal and bool((got == ref).all())
            else:
                worst = max(worst, float(np.abs(got - ref).max()))
    return {"max_abs_err": worst, "solver_qa_equal": qa_equal}


def phase_reference_s2(device) -> dict:
    """Small engine runs through the fused update: S2 PROSAIL (row loop,
    the default) and TIP with inkernel_linearize=False, each against the
    port's plain loop, date by date."""
    from kafka_tpu_torch.core.fused_update import fused_update_rows
    from kafka_tpu_torch.testing.synthetic import run_s2_engine, \
        run_tip_engine

    fused_update_rows.launches = 0
    s2_kf, out_k, _, _ = run_s2_engine(32, 32, device=device)
    s2_launches = fused_update_rows.launches
    _, out_p, _, _ = run_s2_engine(
        32, 32, device=device,
        solver_options={"relaxation": 0.7, "use_pallas": False})
    s2 = compare_runs(out_k, out_p)
    tip_opts = {"relaxation": 0.7, "max_iterations": 40}
    fused_update_rows.launches = 0
    tip_kf, tip_k, _, _ = run_tip_engine(
        device=device, scan_window=SCAN_WINDOW,
        solver_options={**tip_opts, "inkernel_linearize": False})
    tip_launches = fused_update_rows.launches
    _, tip_p, _, _ = run_tip_engine(
        device=device, scan_window=SCAN_WINDOW,
        solver_options={**tip_opts, "use_pallas": False})
    tip = compare_runs(tip_k, tip_p)

    def per_date(kf):
        return [(r["n_iterations"], r.get("fused"))
                for r in kf.diagnostics_log]

    rec = {"phase": "reference_s2",
           "s2_32x32": {**s2, "launches": s2_launches,
                        "iterations_fused": per_date(s2_kf)},
           "tip_rowloop": {**tip, "launches": tip_launches,
                           "iterations_fused": per_date(tip_kf)}}
    emit(rec)
    for name, r in (("s2", s2), ("tip row loop", tip)):
        if r["max_abs_err"] > X_ATOL or not r["solver_qa_equal"]:
            raise AssertionError(f"{name} fused update vs plain loop: {r}")
    for name, kf, n in (("s2", s2_kf, s2_launches),
                        ("tip row loop", tip_kf, tip_launches)):
        iterations = sum(r["n_iterations"] for r in kf.diagnostics_log)
        if n == 0 or n != iterations:
            raise AssertionError(f"{name}: {n} fused update launches for "
                                 f"{iterations} iterations")
    return rec


def s2_truth(ny: int, nx: int, seed: int):
    """The S2 sub-tile's truth: the SAIL mean with LAI 3 plus a seeded
    per-pixel N(0, 0.02), clipped into the operator's bounds."""
    from kafka_tpu_torch.engine.priors import sail_prior_arrays
    from kafka_tpu_torch.obsops.prosail import ProsailOperator

    mean = sail_prior_arrays()[0].copy()
    mean[6] = np.exp(-1.5)
    rng = np.random.default_rng(seed)
    lo, hi = ProsailOperator.state_bounds
    return np.clip(mean + rng.normal(0, 0.02, (ny, nx, 10)), lo, hi) \
        .astype(np.float32)


def phase_main_s2(device, ny: int = S2_TILE, nx: int = S2_TILE,
                  seed: int = 0):
    """KalmanFilter.run over one S2 sub-tile through the row loop (its
    one-acquisition windows run as fused blocks where the engine's
    guards let them).  Returns the record, the fused update's inputs of
    the first iteration of date KEEP_DATE, and that date's
    ``iterated_solve`` arguments."""
    import torch

    from kafka_tpu_torch.core import fused_update as fu_mod
    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.core.fused_update import fused_update_rows
    from kafka_tpu_torch.core.solve_rows import solve_rows
    from kafka_tpu_torch.engine import (PROSAIL_PARAMETER_LIST,
                                        KalmanFilter, sail_prior)
    from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                   s2_observations)

    def day(i):
        return datetime.datetime(2017, 7, 3) + datetime.timedelta(days=i)

    t_setup = time.perf_counter()
    mask = np.ones((ny, nx), bool)
    truth = s2_truth(ny, nx, seed)
    grid_days = (0, 2, 4, 6, 8)
    obs_days = (1, 3, 5, 7)
    obs = s2_observations([day(i) for i in obs_days], lambda date: truth,
                          angles=(30.5, 5.0, -50.0), sigma=0.005,
                          mask_prob=0.1, seed=seed, device=device)
    out = MemoryOutput()
    prior = sail_prior(device)
    kf = KalmanFilter(obs, out, mask, PROSAIL_PARAMETER_LIST,
                      state_propagation=None, prior=prior,
                      solver_options={"relaxation": 0.7}, device=device)
    kf.set_trajectory_uncertainty(np.zeros(10))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    setup_s = time.perf_counter() - t_setup

    # Keep the fused update's inputs on the first iteration of date
    # KEEP_DATE (clones: the solver's call goes through unchanged), the
    # date's iterated_solve arguments, and each date's peak memory.  Both
    # the unfused date path and a fused block's steps call
    # solvers.iterated_solve once per date.
    date_idx = [-1]
    kept, kept_date_args, peaks = {}, {}, []
    names = ("jac_rows", "h0", "y", "w", "m", "xl_rows", "xf_rows",
             "pf_rows", "esc_row")
    real_solve = solvers.iterated_solve

    def date_wrap(*args, **kwargs):
        date_idx[0] += 1
        if date_idx[0] == KEEP_DATE:
            kept_date_args.update(args=args, kwargs=kwargs)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        res = real_solve(*args, **kwargs)
        _sync(device)
        peaks.append(torch.cuda.max_memory_allocated(device) if cuda
                     else None)
        return res

    def keep(*args, **kwargs):
        if date_idx[0] == KEEP_DATE and not kept:
            kept.update((k, v.clone()) for k, v in zip(names, args))
        return fused_update_rows(*args, **kwargs)

    solvers.iterated_solve = date_wrap
    solvers.fused_update_rows = keep
    try:
        fused_gn_rows.launches = fused_update_rows.launches = \
            solve_rows.launches = 0
        t0 = time.perf_counter()
        kf.run([day(i) for i in grid_days], x0, None, p_inv0)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches = {"fused_gn": fused_gn_rows.launches,
                    "fused_update": fused_update_rows.launches,
                    "solve_rows": solve_rows.launches}
    finally:
        solvers.iterated_solve = real_solve
        solvers.fused_update_rows = fu_mod.fused_update_rows
    dates = kf.diagnostics_log
    finite = outputs_finite(out, mask.shape)
    per_date = date_records(dates, peaks)
    iterations = sum(r["n_iterations"] for r in dates)
    rec = {
        "phase": "main_s2", "tile": [ny, nx], "n_valid": kf.gather.n_valid,
        "n_pad": kf.gather.n_pad, "windows": len(grid_days) - 1,
        "dates_assimilated": len(dates), "kernel_launches": launches,
        "iterations": iterations, "outputs_finite": finite,
        "setup_s": setup_s, "run_s": run_s, "kept_date": KEEP_DATE,
        "per_date": per_date,
    }
    emit(rec)
    if len(dates) != len(obs_days):
        raise AssertionError(f"{len(dates)} dates assimilated")
    if launches["fused_update"] != iterations or iterations == 0:
        raise AssertionError(f"{launches} launches for {iterations} "
                             "iterations")
    if not finite:
        raise AssertionError("non-finite output raster")
    if not kept or not kept_date_args:
        raise AssertionError(f"no fused update on date {KEEP_DATE}")
    return rec, kept, kept_date_args


def prosail_update_rows(n_pix: int, device, seed: int = 11) -> dict:
    """make_prosail_problem(n_pix) linearised at its forecast, as the
    fused update's row inputs (no escalation)."""
    import torch

    from kafka_tpu_torch.core.fused_update import jac_to_rows
    from kafka_tpu_torch.core.linalg import pack_rows
    from kafka_tpu_torch.testing.synthetic import make_prosail_problem

    op, bands, x0, p0, aux = make_prosail_problem(n_pix, seed=seed,
                                                  device=device)
    lin = op.linearize(aux, x0)
    f32 = torch.float32
    return dict(
        jac_rows=jac_to_rows(lin.jac), h0=lin.h0.contiguous(),
        y=bands.y.contiguous(), w=bands.r_inv.contiguous(),
        m=bands.mask.to(f32).contiguous(), xl_rows=x0.T.contiguous(),
        xf_rows=x0.T.contiguous(), pf_rows=pack_rows(p0),
        esc_row=torch.zeros((1, n_pix), dtype=f32, device=device),
    )


def update_errors(out, ref) -> dict:
    """Per-pixel errors of fused-update outputs against ``ref``: x (max
    abs), A (max over entries, of the matrix's scale sqrt(A_ii A_jj)),
    inn (max abs)."""
    import torch

    x, a, inn = out[0], out[1], out[2]
    rx, ra, rinn = ref[0], ref[1], ref[2]
    p = x.shape[0]
    diag = ra[[i * (i + 1) // 2 + i for i in range(p)]].abs()
    scale = torch.stack([torch.sqrt(diag[i] * diag[j])
                         for i in range(p) for j in range(i + 1)])
    return {"x": (x - rx).abs().max(dim=0).values,
            "A": ((a - ra).abs() / scale.clamp_min(1e-30)).max(dim=0).values,
            "inn": (inn - rinn).abs().max(dim=0).values}


def phase_kernel_update(device, label: str, rows: dict,
                        kernel_reps: int = 20, plain_reps: int = 2) -> dict:
    """The fused-update kernel against its plain version on ``rows``
    (float32 and float64), timed, with the function's bound."""
    import torch

    from kafka_tpu_torch.core import fused_update as fu

    p, n = rows["xf_rows"].shape
    nb = rows["h0"].shape[0]
    kern = fu.fused_update_rows(**rows)
    plain = fu.fused_update_raw_plain(**rows)
    ref = [t.float() for t in fu.fused_update_raw_plain(
        **{k: v.double() for k, v in rows.items()})]
    _sync(device)
    exact = {nm: int((~same_or_both_nan(a, b)).sum())
             for nm, a, b in zip(("x", "A", "inn", "hb"), kern, plain)}
    finite = all(bool(torch.isfinite(t).all()) for t in kern[:3])
    vs_plain = {k: quantile_summary(v) for k, v in
                update_errors(kern, plain).items()}
    vs_ref = {k: quantile_summary(v) for k, v in
              update_errors(kern, ref).items()}
    plain_vs_ref = {k: quantile_summary(v) for k, v in
                    update_errors(plain, ref).items()}
    ms = time_ms(lambda: fu.fused_update_rows(**rows), device, kernel_reps)
    plain_ms = time_ms(lambda: fu.fused_update_raw_plain(**rows), device,
                       plain_reps)
    read, written = update_floats(p, nb)
    rec = {
        "phase": "kernel_update", "case": label, "n_pix": n, "p": p,
        "bands": nb, "finite": finite,
        "max_abs_err": {nm: float((a - b).nan_to_num().abs().max())
                        for nm, a, b in zip(("x", "A", "inn"), kern, plain)},
        "pixels_differing_from_plain": exact,
        "kernel_vs_plain": vs_plain, "kernel_vs_f64": vs_ref,
        "plain_vs_f64": plain_vs_ref, "ms": ms, "plain_ms": plain_ms,
        "floats_per_px": {"read": read, "written": written},
        **bound(4.0 * (read + written) * n, update_flops(p, nb) * n),
    }
    emit(rec)
    failures = held_quantiles(vs_ref, plain_vs_ref, ("x", "A", "inn"))
    if not finite:
        failures.append("non-finite kernel output")
    if exact["hb"]:
        failures.append(f"{exact['hb']} flag entries differ")
    if failures:
        raise AssertionError(f"kernel_update ({label}): "
                             + "; ".join(failures))
    return rec


def phase_faults_update(device, rows: dict, n_each: int = 64) -> dict:
    """Planted pixels on the kept fused-update inputs: indefinite P_f^-1
    (breakdown), LM escalation, NaN y under a false mask in half the
    bands, and a non-finite Jacobian entry.  x, A, inn and the flags must
    be identical (NaN where NaN) to the plain version's on every planted
    pixel, and the NaN y must not leak."""
    import torch

    from kafka_tpu_torch.core import fused_update as fu

    r = {k: v.clone() for k, v in rows.items()}
    p, n = r["xf_rows"].shape
    nb = r["h0"].shape[0]
    rng = np.random.default_rng(7)
    pick = rng.permutation(n)[:4 * n_each]
    names = ("breakdown", "escalated", "nan_y", "nonfinite_jac")
    planted = {nm: torch.as_tensor(np.sort(pick[i * n_each:(i + 1)
                                                * n_each]), device=device)
               for i, nm in enumerate(names)}
    r["pf_rows"][0, planted["breakdown"]] = -1e9
    r["esc_row"][0, planted["escalated"]] = 1.0
    half = slice(0, nb // 2)
    px = planted["nan_y"]
    r["y"][half, px] = float("nan")
    r["m"][half, px] = 0.0
    r["w"][half, px] = 0.0
    r["jac_rows"][3, planted["nonfinite_jac"]] = float("inf")
    kern = fu.fused_update_rows(**r)
    plain = fu.fused_update_raw_plain(**r)
    unplanted = fu.fused_update_rows(**{**r, "esc_row": rows["esc_row"]})
    _sync(device)
    k = dict(zip(("x", "A", "inn", "hb"), kern))
    q = dict(zip(("x", "A", "inn", "hb"), plain))
    failures, branches = [], {}
    for nm, idx in planted.items():
        equal = all(bool(same_or_both_nan(k[o][:, idx], q[o][:, idx]).all())
                    for o in k)
        hb0, hb1 = k["hb"][0, idx], k["hb"][1, idx]
        if nm in ("breakdown", "nonfinite_jac"):
            expected = bool((hb0 == 1).all())
        elif nm == "escalated":
            moved = ~same_or_both_nan(k["x"][:, idx],
                                      unplanted[0][:, idx]).any(dim=0)
            expected = bool((hb0 == 0).all()) and bool(moved.all()) and bool(
                (k["A"][:, idx] == unplanted[1][:, idx]).all())
        else:
            expected = bool((hb0 == 0).all()) and all(
                bool(torch.isfinite(k[o][:, idx]).all())
                for o in ("x", "A", "inn")) and bool(
                (k["inn"][half, idx] == 0).all())
        branches[nm] = {"equal": equal, "expected": expected,
                        "flagged": int((hb0 > 0).sum()),
                        "nonfinite_x": int((hb1 > 0).sum())}
        if not (equal and expected):
            failures.append(f"{nm}: {branches[nm]}")
    others = torch.ones(n, dtype=torch.bool, device=device)
    others[torch.as_tensor(pick, device=device)] = False
    rest = {o: int((~same_or_both_nan(k[o], q[o]))[:, others].sum())
            for o in k}
    rec = {"phase": "faults_update", "n_pix": n, "planted_per_branch":
           n_each, "branches": branches,
           "other_entries_differing_from_plain": rest}
    emit(rec)
    if failures:
        raise AssertionError("faults_update: " + "; ".join(failures))
    return rec


def normal_equation_rows(rows: dict):
    """(a_rows, rhs_rows) of the packed normal equations of fused-update
    row inputs (the plain assembly)."""
    import torch

    from kafka_tpu_torch.core.fused_update import assemble_rows

    a, rhs, _ = assemble_rows(*(rows[k] for k in (
        "jac_rows", "h0", "y", "w", "m", "xl_rows", "xf_rows", "pf_rows")))
    return torch.stack(a), torch.stack(rhs)


def tip_update_rows(kept: dict) -> dict:
    """The kept TIP date's inputs as fused-update rows, linearised at the
    forecast by the two-stream operator."""
    import torch

    x_rows = kept["xf_rows"]
    h0, jac = kept["lin_rows"](tuple(x_rows[k] for k in range(7)))
    return dict(
        jac_rows=torch.stack([jac[b][k] for b in range(2)
                              for k in range(7)]).contiguous(),
        h0=torch.stack(h0).contiguous(), y=kept["y"], w=kept["r_inv"],
        m=kept["mask_f"], xl_rows=x_rows, xf_rows=x_rows,
        pf_rows=kept["pf_rows"])


def pixels_differing(a, b) -> int:
    """Pixels (columns) of float32 (rows, n) outputs with any entry whose
    bits differ, NaN equal to NaN at the same place whatever its payload:
    the packed solve's gate against its plain version, which must be 0."""
    import torch

    differ = (a.view(torch.int32) != b.view(torch.int32)) & ~(
        a.isnan() & b.isnan())
    return int(differ.any(dim=0).sum())


def spd_rows(p: int, n: int, device, seed: int):
    """``n`` seeded SPD systems M M^T + p I (M standard normal) and
    right sides in the packed row layout: (a_rows, b_rows)."""
    import torch

    from kafka_tpu_torch.core.linalg import pack_rows

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    m = torch.randn(n, p, p, device=device, generator=gen)
    a = m @ m.transpose(1, 2) + p * torch.eye(p, device=device)
    b = torch.randn(p, n, device=device, generator=gen)
    return pack_rows(a), b.contiguous()


def plant_solve_faults(a_rows, p: int, n_each: int = 64, seed: int = 5):
    """A copy of ``a_rows`` with ``n_each`` non-SPD pixels (the last
    diagonal entry negated: the last square root of the factor is NaN)
    and ``n_each`` zero-pivot pixels (A_00 = 0: the first pivot's
    reciprocal is inf); returns it and the planted pixels by kind."""
    import torch

    n = a_rows.shape[1]
    pick = torch.as_tensor(np.random.default_rng(seed).permutation(n)[
        :2 * n_each], device=a_rows.device)
    planted = {"non_spd": pick[:n_each], "zero_pivot": pick[n_each:]}
    a = a_rows.clone()
    last = tri(p - 1) + p - 1
    a[last, planted["non_spd"]] = -a[last, planted["non_spd"]].abs()
    a[0, planted["zero_pivot"]] = 0.0
    return a, planted


def phase_kernel_solve(device, label: str, a_rows, b_rows,
                       kernel_reps: int = 20, plain_reps: int = 2,
                       planted=None) -> dict:
    """The packed solve on one batch of systems: once through
    solve_spd_packed_kernel with the launch counts reset (the kernel's
    path: one launch, by the route launch_plan picks), then bit for bit
    against its plain version (0 pixels may differ, NaN equal to NaN)
    and against a float64 solve by the quantile rule on the pixels the
    float64 solve keeps finite, timed beside torch.linalg.solve on the
    same systems as a dense batch; the launch plan is held to the
    compiled kernel's own geometry.  ``planted`` pixels by kind must be
    non-finite, every other pixel finite."""
    import torch

    from kafka_tpu_torch.core import solve_rows as sr
    from kafka_tpu_torch.core.linalg import unpack_rows

    p, n = b_rows.shape
    a_packed = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            a_packed[i][j] = a_packed[j][i] = a_rows[tri(i) + j]
    sr.solve_rows.launches = 0
    sr.solve_rows.route_launches = dict.fromkeys(sr.ROUTES, 0)
    x_path = sr.solve_spd_packed_kernel(a_packed, b_rows.T)
    _sync(device)
    launches = sr.solve_rows.launches
    routes = dict(sr.solve_rows.route_launches)
    kern = sr.solve_rows(a_rows, b_rows)
    plain = sr.solve_rows_plain(a_rows, b_rows)
    ref = sr.solve_rows_plain(a_rows.double(), b_rows.double()).float()
    dense = unpack_rows(a_rows)
    rhs = b_rows.T.contiguous()[..., None]
    lib = torch.linalg.solve(dense, rhs)[..., 0].T
    _sync(device)
    kept = torch.isfinite(ref).all(dim=0)
    errs = {who: quantile_summary((out - ref)[:, kept].abs().max(dim=0)
                                  .values)
            for who, out in (("kernel", kern), ("plain", plain),
                             ("library", lib))}
    nonfinite = ~torch.isfinite(kern).all(dim=0)
    is_planted = torch.zeros_like(nonfinite)
    for px in (planted or {}).values():
        is_planted[px] = True
    ms = time_ms(lambda: sr.solve_rows(a_rows, b_rows), device, kernel_reps)
    plain_ms = time_ms(lambda: sr.solve_rows_plain(a_rows, b_rows), device,
                       plain_reps)
    library_ms = time_ms(lambda: torch.linalg.solve(dense, rhs), device,
                         plain_reps)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = sr.launch_plan(p, n, (a_rows.data_ptr(), b_rows.data_ptr()), sms)
    attrs = sr.kernel_attributes(p, n)
    rec = {
        "phase": "kernel_solve", "case": label, "n_pix": n, "p": p,
        "launches_on_path": launches, "route": plan["route"],
        "route_launches_on_path": routes,
        "geometry": {**plan, **{k: attrs[k] for k in (
            "registers", "local_bytes", "static_shared_bytes", "sms",
            "ctas_per_sm")}},
        "path_equals_kernel": pixels_differing(x_path.T.contiguous(),
                                               kern) == 0,
        "max_abs_err": float((kern - plain).nan_to_num().abs().max()),
        "pixels_differing_from_plain": pixels_differing(kern, plain),
        "nonfinite_pixels": int(nonfinite.sum()),
        "planted": {k: int(v.numel()) for k, v in (planted or {}).items()},
        "x_err_vs_f64": errs, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        **bound(4.0 * (tri(p) + 2 * p) * n, chol_solve_flops(p) * n),
    }
    rec["share_of_bound"] = rec["bound_ms"] / ms
    emit(rec)
    failures = held_quantiles({"x": errs["kernel"]}, {"x": errs["plain"]},
                              ("x",))
    if rec["pixels_differing_from_plain"]:
        failures.append(f"{rec['pixels_differing_from_plain']} pixels differ"
                        " from the plain version")
    if bool((nonfinite != is_planted).any()):
        failures.append(f"{int(nonfinite.sum())} non-finite pixels for "
                        f"{int(is_planted.sum())} planted")
    if launches != 1 or routes[plan["route"]] != 1 or not rec[
            "path_equals_kernel"]:
        failures.append(f"path: {launches} launches, routes {routes}")
    for k in ("tile", "stages", "consumer_warps", "threads", "smem_bytes",
              "grid"):
        if attrs[k] != plan[k]:
            failures.append(f"launch_plan {k}={plan[k]}, kernel {attrs[k]}")
    if attrs["ctas_per_sm"] < 1 or attrs["local_bytes"]:
        failures.append(f"occupancy or spills: {attrs}")
    if failures:
        raise AssertionError(f"kernel_solve ({label}): "
                             + "; ".join(failures))
    return rec


#: the packed solve's cases beside the main-path dates: (label, p, n)
#: seeded SPD systems at the JAX bench's device size, and at 2^19 + 3 px
#: for every instance (the cp.async route, ending on a 3-px tile).
SOLVE_CASES = (("2^19", 10, 2 ** 19), ("2^19+3 p=2", 2, 2 ** 19 + 3),
               ("2^19+3 p=7", 7, 2 ** 19 + 3), ("2^19+3", 10, 2 ** 19 + 3))


def profile_device(fn, device, top: int = 8, match=()) -> dict:
    """``fn()`` under torch.profiler: host wall, device busy time, idle
    share, device time by kernel (the ``top`` ones), and the summed time
    of the kernels whose names contain each string of ``match``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                                  if wall_ms else None),
            "device_kernel_launches": sum(r[2] for r in rows),
            "top_kernels": [{"name": k[:80], "ms": ms, "count": c}
                            for k, ms, c in rows[:top]],
            "matched": {m: {"ms": sum(r[1] for r in rows if m in r[0]),
                            "count": sum(r[2] for r in rows if m in r[0])}
                        for m in match}}


def phase_profile_s2(device, date_args: dict) -> dict:
    """The kept S2 date's iterated_solve once more under torch.profiler,
    with the fused update's share of the device time, and the wall time
    of one blocked linearisation of the date alone."""
    from kafka_tpu_torch.core import solvers

    args, kwargs = date_args["args"], date_args["kwargs"]
    out = {}

    def run():
        out["r"] = solvers.iterated_solve(*args, **kwargs)
        int(out["r"][2].n_iterations)

    prof = profile_device(run, device, match=("fused_update_kernel",))
    # One blocked linearisation of the date's forecast on its own: the
    # layer the prediction says dominates an S2 date.
    linearize, x_f, aux = args[0], args[2], args[4]
    block = int(kwargs.get("linearize_block") or x_f.shape[0])
    linearize_ms = time_ms(lambda: solvers._blocked_linearize(
        linearize, aux, x_f, block), device, 2)
    rec = {"phase": "profile_s2", "n_pix": int(x_f.shape[0]),
           "n_iterations": int(out["r"][2].n_iterations),
           "linearize_block": block,
           "linearize_wall_ms": linearize_ms, **prof}
    emit(rec)
    return rec


def block_plan(n_windows: int, n_pad: int, n_params: int, n_bands: int,
               scan_window: int = SCAN_WINDOW, aux_bytes: int = 0) -> list:
    """The block sizes the engine runs for ``n_windows`` windows of one
    acquisition each: the head window unfused (it does not advance), then
    blocks of as many windows as ``scan_window`` and the guards allow
    (``aux_bytes`` the bytes of one window's aux), bucketed down to a
    power of two; a block of one runs unfused."""
    def fits(k):
        return (k * n_pad * n_params <= SCAN_MAX_STATE_ELEMS
                and 3 * k * n_bands * n_pad <= SCAN_MAX_BAND_ELEMS
                and k * aux_bytes <= SCAN_MAX_AUX_BYTES)

    plan, idx = [1], 1
    while idx < n_windows:
        k = 0
        while idx + k < n_windows and k < scan_window and fits(k + 1):
            k += 1
        bucket = 1
        while bucket * 2 <= k:
            bucket *= 2
        plan.append(bucket)
        idx += bucket
    return plan


def plan_fused_fields(plan: list) -> list:
    """Each window's ``fused`` diagnostic field under ``plan``."""
    return [None if k == 1 else k for k in plan for _ in range(k)]


def expected_outputs(n_windows: int, n_params: int) -> int:
    """GeoTIFFs a run writes: per window a state and a sigma raster per
    parameter and one QA band."""
    return n_windows * (2 * n_params + 1)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Arrays equal bit for bit, NaN equal to NaN at the same places."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind != "f":
        return bool(np.array_equal(a, b))
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    return bool((nan_a == nan_b).all()) and a[~nan_a].tobytes() == \
        b[~nan_b].tobytes()


class TeeOutput:
    """The driver's GeoTIFF writer with every dump also sent to a
    MemoryOutput; times the writer's flushes and close."""

    def __init__(self, writer, memory):
        self.writer, self.memory = writer, memory
        self.flush_s = self.close_s = 0.0

    def dump_data(self, ts, x, diag, gather, params):
        self.writer.dump_data(ts, x, diag, gather, params)
        self.memory.dump_data(ts, x, diag, gather, params)

    def dump_block(self, timesteps, xs, diags, gather, params):
        self.writer.dump_block(timesteps, xs, diags, gather, params)
        for k, ts in enumerate(timesteps):
            self.memory.dump_data(ts, xs[k], diags[k], gather, params)

    def dump_qa(self, ts, verdicts, gather):
        self.writer.dump_qa(ts, verdicts, gather)
        self.memory.dump_qa(ts, verdicts, gather)

    def dump_qa_block(self, timesteps, verdicts, gather):
        self.writer.dump_qa_block(timesteps, verdicts, gather)
        for k, ts in enumerate(timesteps):
            self.memory.dump_qa(ts, verdicts[k], gather)

    def flush(self):
        t0 = time.perf_counter()
        self.writer.flush()
        self.flush_s += time.perf_counter() - t0

    def close(self):
        t0 = time.perf_counter()
        self.writer.close()
        self.close_s += time.perf_counter() - t0


class MemoryOnly:
    """A MemoryOutput standing in for the driver's GeoTIFF writer."""

    def __init__(self, memory):
        self.memory = memory

    def dump_data(self, *args):
        self.memory.dump_data(*args)

    def dump_qa(self, *args):
        self.memory.dump_qa(*args)

    def flush(self):
        pass

    def close(self):
        pass


class NullOutput:
    """Discards every dump (the resume phase reads only the state)."""

    def dump_data(self, *args):
        pass


def memory_rasters(memory, names_of) -> dict:
    """A MemoryOutput's rasters by GeoTIFF file name."""
    out = {}
    for ts, rasters in memory.output.items():
        for key, arr in rasters.items():
            out[names_of(key, ts)] = arr
    return out


def writer_snapshot_check(device, folder: str) -> dict:
    """The asynchronous GeoTIFFOutput on tensors of ``device``: a tensor
    overwritten right after its dump keeps its dumped values in the
    file, and the writer holds no device memory once the dumped tensor
    is freed and the writer closed."""
    import torch

    from kafka_tpu_torch.engine.state import make_pixel_gather
    from kafka_tpu_torch.io import GeoTIFFOutput, read_geotiff

    g = make_pixel_gather(np.ones((512, 512), bool))
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    x = torch.rand((g.n_pad, 2), generator=gen, device=device)
    expect = g.scatter(x[:, 0].cpu().numpy())
    _sync(device)
    cuda = device.type == "cuda"
    before = torch.cuda.memory_allocated(device) if cuda else 0
    out = GeoTIFFOutput(("a", "b"), (0.0, 1.0, 0.0, 0.0, 0.0, -1.0),
                        folder=folder, async_writes=True)
    ts = datetime.datetime(2017, 7, 2)
    out.dump_data(ts, x, None, g, ("a", "b"))
    x.fill_(-1.0)
    del x
    out.close()
    after = torch.cuda.memory_allocated(device) if cuda else 0
    got, _ = read_geotiff(os.path.join(folder, "a_A2017183.tif"))
    return {"snapshot_holds": same_bits(got, expect),
            "device_bytes_freed_after_close": before - after}


def phase_cli(device, workdir: str, ny: int = TILE, nx: int = TILE,
              seed: int = 0):
    """The torch run_synthetic --operator twostream over the MODIS tile
    through the engine's default configuration (prefetch, fusion,
    checkpoints, the exact information propagator, GeoTIFF outputs),
    called in-process as a user would; then the same inputs unfused, and
    a run interrupted after CLI_RESUME_WINDOWS windows and resumed from
    its checkpoint.  Returns the record and the kernel's inputs on
    CLI_KEEP_DATE."""
    import argparse
    import contextlib
    import io

    import torch

    from kafka_tpu_torch.cli import run_synthetic as rs
    from kafka_tpu_torch.core import propagators, solvers
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.engine.checkpoint import Checkpointer
    from kafka_tpu_torch.io import native_codec, read_geotiff, write_geotiff
    from kafka_tpu_torch.native import load_library
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use
    from kafka_tpu_torch.testing.fixtures import DEFAULT_GEO
    from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                   SyntheticObservations)

    # No fallback here: the native codec must build and load.
    load_library(strict=True)
    mask = land_mask(ny, nx, seed)
    mask_path = os.path.join(workdir, "mask.tif")
    write_geotiff(mask_path, mask.astype(np.uint8), DEFAULT_GEO)
    outdir = os.path.join(workdir, "out")
    argv = [*CLI_ARGS, "--mask", mask_path, "--outdir", outdir,
            "--device", str(device)]
    n_windows = 32 // 4

    real_output, real_make = rs.GeoTIFFOutput, rs._make_filter
    real_scan = solvers.assimilate_windows_scan
    captured, kept, calls, blocks = {}, {}, [], []
    in_block = [False]

    def tee_factory(*args, **kwargs):
        captured["tee"] = TeeOutput(real_output(*args, **kwargs),
                                    MemoryOutput())
        return captured["tee"]

    def make_filter(*args, **kwargs):
        captured["kf"] = real_make(*args, **kwargs)
        return captured["kf"]

    def keep(*args, **kwargs):
        if len(calls) == CLI_KEEP_DATE:
            kept.update(zip(ROW_ARGS, args), corrupt=kwargs.get("corrupt"))
        calls.append(in_block[0])
        return fused_gn_rows(*args, **kwargs)

    real_save, saves = Checkpointer.save, []

    def timed_save(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real_save(self, *args, **kwargs)
        finally:
            saves.append(time.perf_counter() - t0)

    def scan(*args, **kwargs):
        in_block[0] = True
        t0 = time.perf_counter()
        try:
            res = real_scan(*args, **kwargs)
            _sync(device)
        finally:
            in_block[0] = False
        blocks.append(time.perf_counter() - t0)
        return res

    rs.GeoTIFFOutput, rs._make_filter = tee_factory, make_filter
    solvers.fused_gn_rows, solvers.assimilate_windows_scan = keep, scan
    Checkpointer.save = timed_save
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    printed = io.StringIO()
    try:
        fused_gn_rows.launches = 0
        with contextlib.redirect_stdout(printed), \
                use(MetricsRegistry()) as registry:
            summary = rs.main(argv)
        launches = fused_gn_rows.launches
    finally:
        rs.GeoTIFFOutput, rs._make_filter = real_output, real_make
        solvers.fused_gn_rows = fused_gn_rows
        solvers.assimilate_windows_scan = real_scan
        Checkpointer.save = real_save
    print(printed.getvalue(), end="", flush=True)
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else None
    kf, tee = captured["kf"], captured["tee"]
    failures = []
    if json.loads(printed.getvalue().strip().splitlines()[-1]) != summary:
        failures.append("the summary line is not the summary")

    # The block plan the JAX guards give for this n_pad.
    n_pad, p = kf.gather.n_pad, kf.n_params
    plan = block_plan(n_windows, n_pad, p, 2)
    fused = [r.get("fused") for r in kf.diagnostics_log]
    if fused != plan_fused_fields(plan) or max(plan) < 2:
        failures.append(f"block plan {fused}, expected "
                        f"{plan_fused_fields(plan)}")
    if launches != summary["n_dates"] or launches != n_windows:
        failures.append(f"{launches} fused_gn launches for "
                        f"{summary['n_dates']} dates")
    if not kept or len(calls) <= CLI_KEEP_DATE or not calls[CLI_KEEP_DATE]:
        failures.append(f"date {CLI_KEEP_DATE} was not in a fused block")

    # Every GeoTIFF read back equals the teed MemoryOutput, bit for bit,
    # and is finite on the mask.
    writer = tee.writer
    mem = memory_rasters(
        tee.memory, lambda key, ts: os.path.basename(
            writer._qa_fname(ts) if key == "solver_qa" else
            writer._fname(key.removesuffix("_unc"), ts,
                          key.endswith("_unc"))))
    files = sorted(f for f in os.listdir(outdir) if f.endswith(".tif"))
    t0 = time.perf_counter()
    readback_differ, nonfinite = [], []
    for name in files:
        arr, _ = read_geotiff(os.path.join(outdir, name))
        if name not in mem or not same_bits(arr, mem[name]):
            readback_differ.append(name)
        if not np.isfinite(arr[mask]).all():
            nonfinite.append(name)
    readback_s = time.perf_counter() - t0
    if summary["outputs_written"] != expected_outputs(n_windows, p) or \
            len(files) != len(mem):
        failures.append(f"{summary['outputs_written']} outputs written, "
                        f"{len(mem)} dumped, expected "
                        f"{expected_outputs(n_windows, p)}")
    if readback_differ or nonfinite:
        failures.append(f"read-back differs: {readback_differ[:4]}; "
                        f"non-finite: {nonfinite[:4]}")
    final_ck = Checkpointer(os.path.join(outdir, "ckpt")).load_latest()

    snapshot = writer_snapshot_check(device, os.path.join(workdir, "snap"))
    if not snapshot["snapshot_holds"] or (
            cuda and snapshot["device_bytes_freed_after_close"] <= 0):
        failures.append(f"writer snapshot: {snapshot}")

    # The same inputs unfused (scan_window=1) into a MemoryOutput.
    unfused = MemoryOutput()
    rs.GeoTIFFOutput = lambda *a, **k: MemoryOnly(unfused)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rs.main([*CLI_ARGS[:-1], "--mask", mask_path, "--scan-window",
                     "1", "--outdir", os.path.join(workdir, "unfused"),
                     "--device", str(device)])
    finally:
        rs.GeoTIFFOutput = real_output
    unfused_differ = [
        f"{ts.date()} {key}" for ts, rasters in tee.memory.output.items()
        for key, arr in rasters.items()
        if not same_bits(arr, unfused.output[ts][key])]
    if sorted(unfused.output) != sorted(tee.memory.output) or \
            unfused_differ:
        failures.append(f"fused vs unfused differ: {unfused_differ[:4]}")
    del unfused, mem

    # Interrupted after CLI_RESUME_WINDOWS windows, then resumed on a
    # fresh filter from its checkpoint (cli/drivers.py's resume).
    op, params, prior, truth_val, aux_fn, sigma = rs.build_operator(
        "twostream", device)
    truth = np.broadcast_to(truth_val, mask.shape + (p,)).astype(np.float32)
    base = datetime.datetime(2017, 7, 1)
    dates = [base + datetime.timedelta(days=d) for d in range(1, 32, 4)]
    grid = [base + datetime.timedelta(days=d) for d in range(0, 36, 4)]
    ns = argparse.Namespace(max_degraded_dates=8, scan_window=SCAN_WINDOW)
    ck_dir = os.path.join(workdir, "resume_ckpt")

    def filter_over(n_dates):
        obs = SyntheticObservations(dates[:n_dates], op, lambda d: truth,
                                    sigma=sigma, aux_fn=aux_fn,
                                    mask_prob=0.1, device=device)
        return rs._make_filter(ns, mask, NullOutput(), op, params, obs,
                               None, device)

    t0 = time.perf_counter()
    kf_head = filter_over(CLI_RESUME_WINDOWS)
    x0, p_inv0 = prior.process_prior(None, kf_head.gather)
    kf_head.run(grid[:CLI_RESUME_WINDOWS + 1], x0, None, p_inv0,
                checkpointer=Checkpointer(ck_dir))
    ck = Checkpointer(ck_dir)
    rest, seed_state = ck.resume_time_grid(grid)
    kf_rest = filter_over(len(dates))
    x_r, _, p_r = kf_rest.run(rest, seed_state[0], None, seed_state[1],
                              checkpointer=ck, advance_first=True)
    _sync(device)
    resume_s = time.perf_counter() - t0
    x_host = x_r.cpu().numpy()
    tril = np.tril_indices(p)
    resume_equal = (final_ck is not None and final_ck[0] == grid[-1]
                    and same_bits(x_host, final_ck[1])
                    and same_bits(p_r.cpu().numpy()[:, tril[0], tril[1]],
                                  final_ck[2][:, tril[0], tril[1]]))
    if not resume_equal:
        failures.append("resumed final state differs from the "
                        "uninterrupted run's")

    # One exact information propagation over the tile, timed.
    q = kf_rest.trajectory_uncertainty
    eye = kf_rest.trajectory_model
    propagate_ms = time_ms(lambda: propagators.propagate_information_filter(
        x_r, None, p_r, eye, q), device, 3)

    recs = kf.diagnostics_log
    rec = {
        "phase": "cli", "tile": [ny, nx], "n_valid": kf.gather.n_valid,
        "n_pad": n_pad, "argv": list(CLI_ARGS), "summary": summary,
        "wall_s": summary["wall_s"],
        "pixel_steps_per_s": summary["pixel_steps_per_s"],
        "block_plan": plan, "fused_per_date": fused,
        "fused_gn_launches": launches,
        "block_wall_s": blocks,
        # Where the run's wall time went, from the run's own telemetry
        # (host seconds summed over the run; reads and writes run on
        # their own threads, overlapped with the loop) and the
        # checkpoint saves timed here.
        "time_breakdown": {
            **{k: v for k, v in registry.flat().items()
               if k.endswith("_sum") and (
                   k.startswith("kafka_prefetch_") or
                   k.startswith("kafka_engine_phase_seconds") or
                   k.startswith("kafka_io_write_seconds"))},
            "checkpoint_save_s": saves},
        "per_date": date_records(recs),
        "propagate_information_filter_ms": propagate_ms,
        "writer": {"flush_s": tee.flush_s, "close_s": tee.close_s,
                   "peak_queue_depth": writer.peak_backlog, **snapshot},
        "codec_path": native_codec.codec_path(),
        "peak_device_bytes": peak_bytes,
        "outputs_written": summary["outputs_written"],
        "readback": {"files": len(files), "differing": len(readback_differ),
                     "nonfinite": len(nonfinite), "seconds": readback_s},
        "fused_vs_unfused_differing": len(unfused_differ),
        "resume": {"windows_before": CLI_RESUME_WINDOWS,
                   "resumed_grid": [str(t.date()) for t in rest],
                   "bit_identical": resume_equal, "seconds": resume_s},
        "kept_date": CLI_KEEP_DATE,
    }
    emit(rec)
    if rec["codec_path"] != "native":
        failures.append("the GeoTIFFs did not go through the native codec")
    if failures:
        raise AssertionError("cli: " + "; ".join(failures))
    return rec, kept


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.core.fused_update import fused_update_rows
    from kafka_tpu_torch.core.solve_rows import solve_rows

    fused_gn_rows.launches = fused_update_rows.launches = \
        solve_rows.launches = 0
    fused_update_rows.launches_by_instance = {}


def launch_counts() -> dict:
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.core.fused_update import fused_update_rows
    from kafka_tpu_torch.core.solve_rows import solve_rows

    return {"fused_gn": fused_gn_rows.launches,
            "fused_update": fused_update_rows.launches,
            "fused_update_by_instance": {
                f"{p}x{nb}": n for (p, nb), n in
                sorted(fused_update_rows.launches_by_instance.items())},
            "solve_rows": solve_rows.launches}


UPDATE_ROW_NAMES = ("jac_rows", "h0", "y", "w", "m", "xl_rows", "xf_rows",
                    "pf_rows", "esc_row")


class UpdateKeeper:
    """Wraps ``solvers.iterated_solve``, ``solvers.kalman_update`` and the
    fused update's two routes (``_launch_cuda`` and
    ``fused_update_raw_plain``, which ``fused_update_rows`` reaches by
    device) for one run: counts the dates, records each date's peak
    device bytes (and the peak between dates, ``run_peak``) and its
    per-pixel frozen mask (``frozen``, on the host; None without
    per-pixel convergence), and keeps (clones) the fused update's inputs
    of the first iteration on date ``keep[(p, n_bands)]`` of each
    instance, and ``kalman_update``'s inputs (the dense update's, at
    p > 16) of the first iteration on date ``keep["dense"]``.  The
    solver's calls go through unchanged."""

    def __init__(self, device, keep: dict):
        self.device, self.keep = device, dict(keep)
        self.date = -1
        self.kept, self.peaks, self._between = {}, [], []
        self.frozen = []

    def __enter__(self):
        import torch

        from kafka_tpu_torch.core import fused_update as fu_mod
        from kafka_tpu_torch.core import solvers

        self._solvers, self._fu = solvers, fu_mod
        self._real = (solvers.iterated_solve, solvers.kalman_update,
                      fu_mod._launch_cuda, fu_mod.fused_update_raw_plain)
        real_solve, real_kalman = self._real[:2]
        cuda = self.device.type == "cuda"

        def date_wrap(*args, **kwargs):
            self.date += 1
            if cuda:
                # The peak since the last date's read (propagation,
                # observation reads), before the counter restarts.
                self._between.append(
                    torch.cuda.max_memory_allocated(self.device))
                torch.cuda.reset_peak_memory_stats(self.device)
            res = real_solve(*args, **kwargs)
            _sync(self.device)
            self.peaks.append(torch.cuda.max_memory_allocated(self.device)
                              if cuda else None)
            mask = res[2].converged_mask
            self.frozen.append(None if mask is None else mask.cpu())
            return res

        def keep_kalman(lin, obs, x_lin, x_f, p_inv, *args, **kwargs):
            if self.keep.get("dense") == self.date and \
                    "dense" not in self.kept:
                self.kept["dense"] = dict(
                    lin=lin, obs=obs, x_lin=x_lin.clone(), x_f=x_f.clone(),
                    p_inv=p_inv.clone())
            return real_kalman(lin, obs, x_lin, x_f, p_inv, *args,
                               **kwargs)

        def keeping(route):
            def keep(*args):
                inst = (args[6].shape[0], args[1].shape[0])
                if self.keep.get(inst) == self.date and \
                        inst not in self.kept:
                    rows = {k: None if v is None else v.clone()
                            for k, v in zip(UPDATE_ROW_NAMES, args)}
                    # kalman_update's fused step passes no escalation row.
                    if rows.get("esc_row") is None:
                        rows["esc_row"] = torch.zeros_like(rows["h0"][:1])
                    self.kept[inst] = rows
                return route(*args)
            return keep

        solvers.iterated_solve, solvers.kalman_update = date_wrap, \
            keep_kalman
        fu_mod._launch_cuda = keeping(self._real[2])
        fu_mod.fused_update_raw_plain = keeping(self._real[3])
        return self

    def __exit__(self, *exc):
        (self._solvers.iterated_solve, self._solvers.kalman_update,
         self._fu._launch_cuda, self._fu.fused_update_raw_plain) = \
            self._real

    def run_peak(self):
        """Peak device bytes over the whole run (None off the card); read
        after the run."""
        import torch

        if self.device.type != "cuda":
            return None
        return max(self.peaks + self._between
                   + [torch.cuda.max_memory_allocated(self.device)])


class CheckingOutput:
    """An output sink that keeps nothing: it checks each dumped state and
    information diagonal finite on the valid pixels and counts dumps."""

    def __init__(self):
        self.dumps = self.qa = 0
        self.finite = True

    def dump_data(self, ts, x, diag, gather, params):
        import torch

        n = gather.n_valid
        self.dumps += 1
        self.finite = self.finite and bool(torch.isfinite(x[:n]).all()) \
            and (diag is None or bool(torch.isfinite(diag[:n]).all()))

    def dump_qa(self, ts, verdicts, gather):
        self.qa += 1


def joint_dates():
    """(S2 dates, S1 dates, grid) of the joint configuration."""
    s2 = [datetime.datetime(2017, 7, 1) + datetime.timedelta(days=4 * i)
          for i in range(JOINT_N_DATES)]
    s1 = [datetime.datetime(2017, 7, 3, 17) + datetime.timedelta(days=4 * i)
          for i in range(JOINT_N_DATES)]
    start = min(s2 + s1) - datetime.timedelta(days=1)
    end = max(s2 + s1) + datetime.timedelta(days=1)
    grid, t = [], start
    while t <= end:
        grid.append(t)
        t += datetime.timedelta(days=2)
    return s2, s1, grid


def phase_main_joint(device, ny: int = S2_TILE, nx: int = S2_TILE,
                     seed: int = 0):
    """KalmanFilter.run over one S2 sub-tile of the joint S2 + S1
    configuration: the 11-parameter joint state seeded from joint_prior,
    joint_state_bounds, relaxation 0.7, the exact information propagator
    with JOINT_Q, 6 S2 dates on ProsailJointOperator (sigma 0.005) and 6
    S1 dates on WCMJointOperator (sigma 0.01, a seeded per-pixel incidence
    angle in JOINT_THETA) interleaved on a 2-day grid, 10 % masked.  The
    truth is the joint prior mean with LAI 3 and soil moisture 0.4.
    Returns the record and the fused update's first-iteration inputs of
    the JOINT_KEEP dates, by instance."""
    import torch

    from kafka_tpu_torch.core.propagators import propagate_information_filter
    from kafka_tpu_torch.engine import (JOINT_PARAMETER_LIST, KalmanFilter,
                                        joint_prior)
    from kafka_tpu_torch.testing import joint_observations, joint_truth

    t_setup = time.perf_counter()
    mask = np.ones((ny, nx), bool)
    truth = joint_truth(mask.shape)
    rng = np.random.default_rng(seed)
    theta = rng.uniform(*JOINT_THETA, size=(ny, nx)).astype(np.float32)
    s2_dates, s1_dates, grid = joint_dates()
    obs = joint_observations(s2_dates, s1_dates, lambda d: truth, theta,
                             s2_angles=(30.5, 5.0, -50.0),
                             s1_sigma=JOINT_S1_SIGMA, device=device)
    # Pixels observed by an S1 date (any band): the soil-moisture gate's
    # population.
    seen_s1 = {}
    real_get = obs.get_observations

    def get_observations(date, gather):
        got = real_get(date, gather)
        if got.operator.n_bands == 2:
            m = got.bands.mask.any(dim=0)
            seen_s1["mask"] = m if "mask" not in seen_s1 \
                else seen_s1["mask"] | m
        return got

    obs.get_observations = get_observations
    out = CheckingOutput()
    prior = joint_prior(device)
    kf = KalmanFilter(obs, out, mask, JOINT_PARAMETER_LIST,
                      state_propagation=propagate_information_filter,
                      prior=None, solver_options={"relaxation": 0.7},
                      device=device)
    kf.set_trajectory_uncertainty(np.array(JOINT_Q, np.float32))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    setup_s = time.perf_counter() - t_setup

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with UpdateKeeper(device, JOINT_KEEP) as keeper:
        reset_launches()
        t0 = time.perf_counter()
        x_a, _, _ = kf.run(grid, x0, None, p_inv0)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches = launch_counts()
    peak = keeper.run_peak()
    dates = kf.diagnostics_log
    s2_set = set(s2_dates)
    sensor = ["S2" if r["date"] in s2_set else "S1" for r in dates]
    iters = {s: sum(r["n_iterations"] for r, k in zip(dates, sensor)
                    if k == s) for s in ("S2", "S1")}
    walls = {s: [r["wall_s"] for r, k in zip(dates, sensor) if k == s]
             for s in ("S2", "S1")}
    n = kf.gather.n_valid
    observed = seen_s1["mask"][:n] if "mask" in seen_s1 else \
        torch.zeros(n, dtype=torch.bool, device=device)
    sm = x_a[:n, 10][observed]
    sm_err = float((sm - 0.4).abs().mean()) if sm.numel() else float("nan")
    lai = -2.0 * torch.log(x_a[:n, 6].clamp(1e-6, 1.0))
    by_inst = launches["fused_update_by_instance"]
    rec = {
        "phase": "main_joint", "tile": [ny, nx], "n_valid": n,
        "n_pad": kf.gather.n_pad, "windows": len(grid) - 1,
        "dates_assimilated": len(dates), "sensors": sensor,
        "kernel_launches": launches, "iterations": iters,
        "date_wall_s": walls,
        "date_wall_mean_s": {k: (sum(v) / len(v) if v else None)
                             for k, v in walls.items()},
        "outputs_finite": out.finite, "dumps": out.dumps,
        "setup_s": setup_s, "run_s": run_s, "peak_device_bytes": peak,
        "sm_observed_pixels": int(observed.sum()),
        "mean_abs_sm_err": sm_err, "sm_gate": JOINT_SM_GATE,
        "mean_abs_lai_err": float((lai - 3.0).abs().mean()),
        "kept_dates": {f"{p}x{nb}": d for (p, nb), d in JOINT_KEEP.items()},
        "per_date": [{**d, "sensor": k} for d, k in
                     zip(date_records(dates, keeper.peaks), sensor)],
    }
    emit(rec)
    failures = []
    if len(dates) != 2 * JOINT_N_DATES or \
            sensor != ["S2", "S1"] * JOINT_N_DATES:
        failures.append(f"dates assimilated {sensor}")
    if any(r.get("fused") for r in dates):
        failures.append("a block fused dates of two sensors")
    if by_inst.get("11x10") != iters["S2"] or \
            by_inst.get("11x2") != iters["S1"] or not all(iters.values()):
        failures.append(f"fused update launches {by_inst} for iterations "
                        f"{iters}")
    if launches["fused_gn"] or set(by_inst) != {"11x10", "11x2"}:
        failures.append(f"other kernels launched: {launches}")
    if not out.finite or out.dumps != len(grid) - 1:
        failures.append(f"outputs: {out.dumps} dumps, finite {out.finite}")
    if not sm_err < JOINT_SM_GATE:
        failures.append(f"mean |sm - 0.4| = {sm_err}")
    if set(keeper.kept) != set(JOINT_KEEP):
        failures.append(f"kept instances {sorted(keeper.kept)}")
    if failures:
        raise AssertionError("main_joint: " + "; ".join(failures))
    return rec, keeper.kept


def phase_cli_wcm(device, workdir: str, ny: int = TILE, nx: int = TILE,
                  seed: int = 0):
    """The torch run_synthetic --operator wcm over the cli tile's land
    mask (read from a GeoTIFF), called in-process: 8 one-acquisition
    windows through the engine's defaults (prefetch, fusion, the exact
    information propagator, GeoTIFF outputs), no checkpoint.  Gates: the
    summary line printed; fused-update launches at (2, 2) equal the
    dates' iterations; the block plan the guards give (the per-pixel
    incidence angle counts as aux); windows x 5 GeoTIFFs, finite on the
    mask, each read back bit-identical to a MemoryOutput copy.  Returns
    the record and the fused update's first-iteration inputs of
    CLI_KEEP_DATE."""
    import contextlib
    import io

    import torch

    from kafka_tpu_torch.cli import run_synthetic as rs
    from kafka_tpu_torch.io import read_geotiff, write_geotiff
    from kafka_tpu_torch.testing.fixtures import DEFAULT_GEO
    from kafka_tpu_torch.testing.synthetic import MemoryOutput

    mask = land_mask(ny, nx, seed)
    mask_path = os.path.join(workdir, "mask.tif")
    write_geotiff(mask_path, mask.astype(np.uint8), DEFAULT_GEO)
    outdir = os.path.join(workdir, "out")
    argv = [*CLI_WCM_ARGS, "--mask", mask_path, "--outdir", outdir,
            "--device", str(device)]
    n_windows = 32 // 4
    real_output, real_make = rs.GeoTIFFOutput, rs._make_filter
    captured = {}

    def tee_factory(*args, **kwargs):
        captured["tee"] = TeeOutput(real_output(*args, **kwargs),
                                    MemoryOutput())
        return captured["tee"]

    def make_filter(*args, **kwargs):
        captured["kf"] = real_make(*args, **kwargs)
        return captured["kf"]

    rs.GeoTIFFOutput, rs._make_filter = tee_factory, make_filter
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    printed = io.StringIO()
    try:
        with UpdateKeeper(device, {(2, 2): CLI_KEEP_DATE}) as keeper, \
                contextlib.redirect_stdout(printed):
            reset_launches()
            summary = rs.main(argv)
            launches = launch_counts()
    finally:
        rs.GeoTIFFOutput, rs._make_filter = real_output, real_make
    print(printed.getvalue(), end="", flush=True)
    peak = keeper.run_peak()
    kf, tee = captured["kf"], captured["tee"]
    failures = []
    if json.loads(printed.getvalue().strip().splitlines()[-1]) != summary:
        failures.append("the summary line is not the summary")
    n_pad, p = kf.gather.n_pad, kf.n_params
    plan = block_plan(n_windows, n_pad, p, 2, aux_bytes=4 * n_pad)
    fused = [r.get("fused") for r in kf.diagnostics_log]
    if fused != plan_fused_fields(plan):
        failures.append(f"block plan {fused}, expected "
                        f"{plan_fused_fields(plan)}")
    iterations = sum(r["n_iterations"] for r in kf.diagnostics_log)
    by_inst = launches["fused_update_by_instance"]
    if by_inst != {"2x2": iterations} or iterations == 0 or \
            launches["fused_gn"] or summary["n_dates"] != n_windows:
        failures.append(f"launches {launches} for {iterations} iterations "
                        f"of {summary['n_dates']} dates")
    writer = tee.writer
    mem = memory_rasters(
        tee.memory, lambda key, ts: os.path.basename(
            writer._qa_fname(ts) if key == "solver_qa" else
            writer._fname(key.removesuffix("_unc"), ts,
                          key.endswith("_unc"))))
    files = sorted(f for f in os.listdir(outdir) if f.endswith(".tif"))
    readback_differ, nonfinite = [], []
    for name in files:
        arr, _ = read_geotiff(os.path.join(outdir, name))
        if name not in mem or not same_bits(arr, mem[name]):
            readback_differ.append(name)
        if not np.isfinite(arr[mask]).all():
            nonfinite.append(name)
    if summary["outputs_written"] != expected_outputs(n_windows, p) or \
            len(files) != len(mem):
        failures.append(f"{summary['outputs_written']} outputs written, "
                        f"{len(mem)} dumped, expected "
                        f"{expected_outputs(n_windows, p)}")
    if readback_differ or nonfinite:
        failures.append(f"read-back differs: {readback_differ[:4]}; "
                        f"non-finite: {nonfinite[:4]}")
    if (2, 2) not in keeper.kept:
        failures.append(f"no fused update kept on date {CLI_KEEP_DATE}")
    rec = {
        "phase": "cli_wcm", "tile": [ny, nx], "n_valid": kf.gather.n_valid,
        "n_pad": n_pad, "argv": list(CLI_WCM_ARGS), "summary": summary,
        "wall_s": summary["wall_s"],
        "pixel_steps_per_s": summary["pixel_steps_per_s"],
        "block_plan": plan, "fused_per_date": fused,
        "kernel_launches": launches, "iterations": iterations,
        "per_date": date_records(kf.diagnostics_log, keeper.peaks),
        "writer": {"flush_s": tee.flush_s, "close_s": tee.close_s,
                   "peak_queue_depth": writer.peak_backlog},
        "peak_device_bytes": peak,
        "readback": {"files": len(files), "differing": len(readback_differ),
                     "nonfinite": len(nonfinite)},
        "kept_date": CLI_KEEP_DATE,
    }
    emit(rec)
    if failures:
        raise AssertionError("cli_wcm: " + "; ".join(failures))
    return rec, keeper.kept[(2, 2)]


def chunk_rasters(chunks, grid, dates, params) -> set:
    """The GeoTIFF names a chunked driver run writes: per chunk and per
    window of ``grid`` a state and a sigma raster per parameter, and a QA
    band for each window that holds one of ``dates``."""
    from kafka_tpu_torch.core.time_grid import iterate_time_grid

    observed = {ts for ts, located, _ in
                iterate_time_grid(grid, dates, verbose=False) if located}
    names = set()
    for c in chunks:
        prefix = f"{c.chunk_no:04x}"
        for ts in grid[1:]:
            tag = ts.strftime("A%Y%j")
            names.update(f"{p}_{tag}_{prefix}{unc}.tif" for p in params
                         for unc in ("", "_unc"))
            if ts in observed:
                names.add(f"solver_qa_{tag}_{prefix}.tif")
    return names


def chunk_prefix(name: str) -> str:
    """The chunk prefix of an output name ``{param}_{A%Y%j}_{prefix}[_unc]
    .tif``."""
    return name[:-len(".tif")].removesuffix("_unc").rsplit("_", 1)[1]


def folder_state(folder: str) -> dict:
    """Every file of ``folder`` with its size and modification time."""
    out = {}
    for name in sorted(os.listdir(folder)):
        st = os.stat(os.path.join(folder, name))
        out[name] = (st.st_size, st.st_mtime_ns)
    return out


class DriverProbe:
    """Instruments one in-process run of a chunked driver: keeps each
    chunk's KalmanFilter, each chunk's summary, the wall seconds of each
    call to the reader class's ``get_observations``, and (with
    ``keep_gn``) the fused Gauss-Newton kernel's inputs on that 0-based
    date of the run.  Everything is put back on exit."""

    def __init__(self, reader_cls, keep_gn=None):
        self.reader_cls, self.keep_gn = reader_cls, keep_gn
        self.filters, self.summaries, self.reads = [], [], []
        self.kept_gn, self._gn_calls = {}, 0

    def __enter__(self):
        from kafka_tpu_torch.cli import drivers
        from kafka_tpu_torch.core import solvers
        from kafka_tpu_torch.core.fused_gn import fused_gn_rows

        self._drivers, self._solvers = drivers, solvers
        real_kf, real_chunk = drivers.KalmanFilter, drivers.run_one_chunk
        real_get = self._real_get = self.reader_cls.get_observations
        self._real = (real_kf, real_chunk)

        def make_kf(*args, **kwargs):
            kf = real_kf(*args, **kwargs)
            self.filters.append(kf)
            return kf

        def one_chunk(*args, **kwargs):
            s = real_chunk(*args, **kwargs)
            if s is not None:
                self.summaries.append(s)
            return s

        def timed_get(reader, date, gather):
            t0 = time.perf_counter()
            try:
                return real_get(reader, date, gather)
            finally:
                self.reads.append(time.perf_counter() - t0)

        def keep_gn(*args, **kwargs):
            if self._gn_calls == self.keep_gn:
                self.kept_gn.update(zip(ROW_ARGS, args),
                                    corrupt=kwargs.get("corrupt"))
            self._gn_calls += 1
            return fused_gn_rows(*args, **kwargs)

        drivers.KalmanFilter, drivers.run_one_chunk = make_kf, one_chunk
        self.reader_cls.get_observations = timed_get
        if self.keep_gn is not None:
            solvers.fused_gn_rows = keep_gn
        return self

    def __exit__(self, *exc):
        from kafka_tpu_torch.core.fused_gn import fused_gn_rows

        self._drivers.KalmanFilter, self._drivers.run_one_chunk = self._real
        self.reader_cls.get_observations = self._real_get
        self._solvers.fused_gn_rows = fused_gn_rows

    def dates(self) -> list:
        return [r for kf in self.filters for r in kf.diagnostics_log]


def run_driver(main_fn, argv) -> tuple:
    """A driver's ``main`` in-process with its stdout captured and then
    printed: (stats, the printed summary line parsed, seconds)."""
    import contextlib
    import io

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        stats = main_fn(list(argv))
    seconds = time.perf_counter() - t0
    print(printed.getvalue(), end="", flush=True)
    return stats, json.loads(printed.getvalue().strip().splitlines()[-1]), \
        seconds


def raster_median(outdir: str, names, masks) -> float:
    """Median of the rasters ``names`` over their ``masks`` pixels."""
    from kafka_tpu_torch.io import read_geotiff

    vals = [read_geotiff(os.path.join(outdir, n))[0][m]
            for n, m in zip(names, masks)]
    return float(np.median(np.concatenate(vals)))


def phase_cli_s2(device, workdir: str, ny: int = CLI_S2_TILE,
                 nx: int = CLI_S2_TILE, chunk: int = S2_TILE,
                 seed: int = 0):
    """The torch ``run_s2`` driver as users run it, in-process, over a
    granule tree written on disk: ``make_s2_granule_tree`` (uint16 DN,
    noise 0.002) over ny x nx px on the Barrax grid for CLI_S2_DAYS, the
    seeded land mask as the state-mask GeoTIFF, ``default_config()`` with
    chunk x chunk chunks saved as the run's ``--config``.  Each chunk runs
    the Sentinel-2 reader, the SAIL prior, the engine (prefetch, fusion)
    and the GeoTIFF writer; each Gauss-Newton iteration launches the fused
    update at (10, 10).  Gates: every chunk run and every date
    assimilated; launches equal to the chunks' summed iterations; every
    expected GeoTIFF present and finite on the mask; the median LAI of the
    last window nearer the truth than the SAIL prior's; a second ``main``
    on the same arguments runs nothing and writes nothing; the port's
    mosaic of the LAI rasters equal to the chunk rasters at their
    offsets, bit for bit.  Returns the record and the fused update's
    first-iteration inputs on the run's date CLI_S2_KEEP_DATE."""
    import contextlib
    import io

    import torch

    from kafka_tpu_torch.cli import mosaic, run_s2
    from kafka_tpu_torch.engine.priors import (PROSAIL_PARAMETER_LIST,
                                               sail_prior_arrays)
    from kafka_tpu_torch.io import get_chunks, read_geotiff, write_geotiff
    from kafka_tpu_torch.io.sentinel2 import Sentinel2Observations
    from kafka_tpu_torch.testing.fixtures import (DEFAULT_GEO,
                                                  make_s2_granule_tree)

    t_phase = time.perf_counter()
    mask = land_mask(ny, nx, seed)
    mask_path = os.path.join(workdir, "mask.tif")
    write_geotiff(mask_path, mask.astype(np.uint8), DEFAULT_GEO)
    data = os.path.join(workdir, "s2")
    dates = [datetime.datetime(2017, 7, d) for d in CLI_S2_DAYS]
    truth = make_s2_granule_tree(data, dates, ny=ny, nx=nx, geo=DEFAULT_GEO,
                                 noise=0.002, seed=seed, dtype=np.uint16)
    cfg = run_s2.default_config()
    cfg.chunk_size = (chunk, chunk)
    cfg_path = os.path.join(workdir, "run_s2.json")
    cfg.save(cfg_path)
    outdir = os.path.join(workdir, "out")
    argv = ["--config", cfg_path, "--data-folder", data, "--state-mask",
            mask_path, "--outdir", outdir, "--device", str(device)]
    data_s = time.perf_counter() - t_phase
    chunks = list(get_chunks(nx, ny, cfg.chunk_size))
    grid = cfg.time_grid()

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with UpdateKeeper(device, {(10, 10): CLI_S2_KEEP_DATE}) as keeper, \
            DriverProbe(Sentinel2Observations) as probe:
        reset_launches()
        stats, printed, _ = run_driver(run_s2.main, argv)
        launches = launch_counts()
    peak = keeper.run_peak()
    failures = []
    if printed != stats:
        failures.append("the printed line is not the stats")
    n = len(chunks)
    if (stats["run"], stats["skipped"], stats["failed"],
            stats["chunks_with_pixels"], stats["dates_assimilated"]) != \
            (n, 0, 0, n, n * len(dates)):
        failures.append(f"stats {stats}")
    runs = probe.dates()
    iterations = sum(r["n_iterations"] for r in runs)
    by_inst = launches["fused_update_by_instance"]
    if by_inst != {"10x10": iterations} or iterations == 0 or \
            launches["fused_gn"] or launches["solve_rows"]:
        failures.append(f"launches {launches} for {iterations} iterations")
    if failures:  # the run itself failed: nothing further to check
        emit({"phase": "cli_s2", "stats": stats, "kernel_launches": launches,
              "failures": failures})
        raise AssertionError("cli_s2: " + "; ".join(failures))

    t0 = time.perf_counter()
    expected = chunk_rasters(chunks, grid, dates, PROSAIL_PARAMETER_LIST)
    written = {f for f in os.listdir(outdir) if f.endswith(".tif")}
    if written != expected:
        failures.append(f"{len(written)} GeoTIFFs written, "
                        f"{len(expected)} expected: "
                        f"{sorted(written ^ expected)[:4]}")
    sub = {f"{c.chunk_no:04x}": mask[c.y0:c.y0 + c.ny_valid,
                                     c.x0:c.x0 + c.nx_valid]
           for c in chunks}
    nonfinite = [name for name in sorted(written & expected)
                 if not np.isfinite(read_geotiff(os.path.join(
                     outdir, name))[0][sub[chunk_prefix(name)]]).all()]
    if nonfinite:
        failures.append(f"non-finite: {nonfinite[:4]}")
    last = grid[-1].strftime("A%Y%j")
    lai = raster_median(outdir, [f"lai_{last}_{p}.tif" for p in sub],
                        list(sub.values()))
    prior_lai = float(sail_prior_arrays()[0][6])
    if not abs(lai - truth[6]) < abs(prior_lai - truth[6]):
        failures.append(f"median LAI {lai} not nearer the truth "
                        f"{truth[6]} than the prior's {prior_lai}")
    check_s = time.perf_counter() - t0

    # The restart: every chunk has its .done marker.
    before = folder_state(outdir)
    reset_launches()
    again, _, again_s = run_driver(run_s2.main, argv)
    again_launches = launch_counts()
    if (again["run"], again["skipped"]) != (0, n) or \
            folder_state(outdir) != before or \
            again_launches["fused_update"]:
        failures.append(f"restart ran {again} with {again_launches}")

    # The port's mosaic of the LAI rasters against the chunks.
    t0 = time.perf_counter()
    mos_dir = os.path.join(workdir, "mosaic")
    with contextlib.redirect_stdout(io.StringIO()):
        mosaics = mosaic.main([outdir, "--param", "lai", "--like",
                               mask_path, "--outdir", mos_dir])
    mosaic_differ = []
    for ts in grid[1:]:
        tag = ts.strftime("A%Y%j")
        mos, _ = read_geotiff(os.path.join(mos_dir, f"lai_{tag}.tif"))
        for c in chunks:
            part, _ = read_geotiff(os.path.join(
                outdir, f"lai_{tag}_{c.chunk_no:04x}.tif"))
            if mos[c.y0:c.y0 + c.ny_valid, c.x0:c.x0 + c.nx_valid] \
                    .tobytes() != part.tobytes():
                mosaic_differ.append(f"{tag}_{c.chunk_no:04x}")
    if len(mosaics) != len(grid) - 1 or mosaic_differ:
        failures.append(f"{len(mosaics)} mosaics; differing {mosaic_differ}")
    mosaic_s = time.perf_counter() - t0
    if (10, 10) not in keeper.kept:
        failures.append(f"no fused update kept on date {CLI_S2_KEEP_DATE}")

    n_valid = stats["pixels"]
    rec = {
        "phase": "cli_s2", "tile": [ny, nx], "chunk": list(cfg.chunk_size),
        "chunks": n, "n_valid": n_valid, "dates": [str(d.date())
                                                   for d in dates],
        "reduced": {"chunks": f"{n} of a 10980 x 10980 tile's 100 "
                              f"{chunk} x {chunk} chunks",
                    "dates": f"{len(dates)} acquisitions of the Barrax "
                             "grid's window"},
        "stats": stats, "wall_s": stats["wall_s"],
        "pixel_steps_per_s": n_valid * len(dates) / stats["wall_s"],
        "chunk_wall_s": [s["wall_s"] for s in probe.summaries],
        "date_wall_s": [r["wall_s"] for r in runs],
        "reader_s_per_date": probe.reads,
        "fused_per_date": [r.get("fused") for r in runs],
        "kernel_launches": launches, "iterations": iterations,
        "per_date": date_records(runs, keeper.peaks),
        "peak_device_bytes": peak, "geotiffs": len(written),
        "median_lai": {"last_window": lai, "truth": float(truth[6]),
                       "prior": prior_lai},
        "restart": {"stats": again, "seconds": again_s},
        "mosaic": {"files": len(mosaics), "differing": len(mosaic_differ),
                   "seconds": mosaic_s},
        "seconds": {"data": data_s, "check": check_s,
                    "phase": time.perf_counter() - t_phase},
        "kept_date": CLI_S2_KEEP_DATE,
    }
    emit(rec)
    if failures:
        raise AssertionError("cli_s2: " + "; ".join(failures))
    return rec, keeper.kept[(10, 10)]


def phase_cli_modis(device, workdir: str, ny: int = TILE, nx: int = TILE,
                    seed: int = 0):
    """The torch ``run_modis`` driver as users run it, in-process, over an
    MCD43 series written on disk: ``make_mcd43_series`` (noise 0.001) over
    the ny x nx tile for CLI_MODIS_DATES, 16 days apart on the driver's
    own grid, the seeded land mask as the state mask,
    ``default_config()`` with ``end`` CLI_MODIS_END and ``period`` 1 (the
    files already sit on the grid: one per window), the whole tile one
    chunk.  The two-stream state, the JRC initial prior and the
    information_filter_lai propagator; each date is one launch of the
    fused Gauss-Newton kernel.  Gates: one chunk, every date assimilated,
    fused_gn launches equal to the dates, every expected GeoTIFF present
    and finite on the mask, the median TeLAI of the last window nearer
    the truth than the JRC prior's.  Returns the record and the kernel's
    inputs on date CLI_MODIS_KEEP_DATE."""
    import torch

    from kafka_tpu_torch.cli import run_modis
    from kafka_tpu_torch.engine.priors import TIP_PARAMETER_LIST, jrc_prior
    from kafka_tpu_torch.io import get_chunks, read_geotiff, write_geotiff
    from kafka_tpu_torch.io.modis import BHRObservations
    from kafka_tpu_torch.testing.fixtures import (DEFAULT_GEO,
                                                  make_mcd43_series)

    t_phase = time.perf_counter()
    mask = land_mask(ny, nx, seed)
    mask_path = os.path.join(workdir, "mask.tif")
    write_geotiff(mask_path, mask.astype(np.uint8), DEFAULT_GEO)
    data = os.path.join(workdir, "mcd43")
    os.makedirs(data)
    dates = [datetime.datetime(2017, 1, 1) + datetime.timedelta(days=16 * i)
             for i in range(CLI_MODIS_DATES)]
    truth = make_mcd43_series(data, dates, ny=ny, nx=nx, geo=DEFAULT_GEO,
                              noise=0.001, seed=seed)
    cfg = run_modis.default_config()
    cfg.end = CLI_MODIS_END
    cfg.extra["period"] = 1
    cfg.chunk_size = (nx, ny)
    cfg_path = os.path.join(workdir, "run_modis.json")
    cfg.save(cfg_path)
    outdir = os.path.join(workdir, "out")
    argv = ["--config", cfg_path, "--data-folder", data, "--state-mask",
            mask_path, "--outdir", outdir, "--device", str(device)]
    data_s = time.perf_counter() - t_phase
    chunks = list(get_chunks(nx, ny, cfg.chunk_size))
    grid = cfg.time_grid()

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with DriverProbe(BHRObservations, keep_gn=CLI_MODIS_KEEP_DATE) as probe:
        reset_launches()
        stats, printed, _ = run_driver(run_modis.main, argv)
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    failures = []
    if printed != stats:
        failures.append("the printed line is not the stats")
    if (stats["run"], stats["chunks_with_pixels"],
            stats["dates_assimilated"]) != (1, 1, len(dates)):
        failures.append(f"stats {stats}")
    runs = probe.dates()
    if launches["fused_gn"] != len(dates) or launches["fused_update"] or \
            launches["solve_rows"]:
        failures.append(f"launches {launches} for {len(dates)} dates")
    if failures:  # the run itself failed: nothing further to check
        emit({"phase": "cli_modis", "stats": stats,
              "kernel_launches": launches, "failures": failures})
        raise AssertionError("cli_modis: " + "; ".join(failures))
    t0 = time.perf_counter()
    expected = chunk_rasters(chunks, grid, dates, TIP_PARAMETER_LIST)
    written = {f for f in os.listdir(outdir) if f.endswith(".tif")}
    if written != expected:
        failures.append(f"{len(written)} GeoTIFFs written, "
                        f"{len(expected)} expected")
    nonfinite = [name for name in sorted(written) if not np.isfinite(
        read_geotiff(os.path.join(outdir, name))[0][mask]).all()]
    if nonfinite:
        failures.append(f"non-finite: {nonfinite[:4]}")
    last = grid[-1].strftime("A%Y%j")
    telai = raster_median(outdir, [f"TeLAI_{last}_0001.tif"], [mask])
    prior_telai = float(jrc_prior("cpu").prior.mean[6])
    if not abs(telai - truth[6]) < abs(prior_telai - truth[6]):
        failures.append(f"median TeLAI {telai} not nearer the truth "
                        f"{truth[6]} than the prior's {prior_telai}")
    check_s = time.perf_counter() - t0
    if not probe.kept_gn:
        failures.append(f"no fused_gn call kept on date "
                        f"{CLI_MODIS_KEEP_DATE}")
    n_valid = stats["pixels"]
    rec = {
        "phase": "cli_modis", "tile": [ny, nx], "n_valid": n_valid,
        "n_pad": probe.filters[0].gather.n_pad,
        "dates": [str(d.date()) for d in dates],
        "reduced": {"windows": f"{len(grid) - 1} of an annual run's 23 "
                               "16-day windows"},
        "stats": stats, "wall_s": stats["wall_s"],
        "pixel_steps_per_s": n_valid * len(dates) / stats["wall_s"],
        "chunk_wall_s": [s["wall_s"] for s in probe.summaries],
        "date_wall_s": [r["wall_s"] for r in runs],
        "reader_s_per_date": probe.reads,
        "fused_per_date": [r.get("fused") for r in runs],
        "kernel_launches": launches, "per_date": date_records(runs),
        "peak_device_bytes": peak, "geotiffs": len(written),
        "median_telai": {"last_window": telai, "truth": float(truth[6]),
                         "prior": prior_telai},
        "seconds": {"data": data_s, "check": check_s,
                    "phase": time.perf_counter() - t_phase},
        "kept_date": CLI_MODIS_KEEP_DATE,
    }
    emit(rec)
    if failures:
        raise AssertionError("cli_modis: " + "; ".join(failures))
    return rec, probe.kept_gn


def read_rasters(paths) -> list:
    """The first band of each GeoTIFF, read on a thread per core (the
    codec releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from kafka_tpu_torch.io import read_geotiff

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return list(pool.map(lambda p: read_geotiff(p)[0], paths))


def tip_tile_run(device, ny: int, nx: int, seed: int, solver_options=None,
                 grid_days=TIP_GRID_DAYS, obs_days=TIP_OBS_DAYS,
                 **filter_kwargs):
    """The MODIS tile configuration of phase main and the phases after
    it (the seeded land mask, the truth around the TIP prior, jrc_prior,
    prior-only advance, sigma 0.005 with 10 % masked) run by KalmanFilter
    with ``solver_options`` and ``filter_kwargs``.  Returns the filter,
    its MemoryOutput and the run's seconds (set-up excluded)."""
    from kafka_tpu_torch.core.propagators import tip_prior_arrays
    from kafka_tpu_torch.engine import (TIP_PARAMETER_LIST, KalmanFilter,
                                        jrc_prior)
    from kafka_tpu_torch.obsops import TwoStreamOperator
    from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                   SyntheticObservations)

    def day(i):
        return datetime.datetime(2021, 6, 1) + datetime.timedelta(days=i)

    mask = land_mask(ny, nx, seed)
    rng = np.random.default_rng(seed)
    truth = np.clip(tip_prior_arrays()[0] + rng.normal(0, 0.05, (ny, nx, 7)),
                    0.05, 0.95).astype(np.float32)
    obs = SyntheticObservations(
        [day(i) for i in obs_days], TwoStreamOperator(), lambda date: truth,
        sigma=0.005, mask_prob=0.1, seed=seed, device=device)
    out = MemoryOutput()
    prior = jrc_prior(device)
    kf = KalmanFilter(obs, out, mask, TIP_PARAMETER_LIST,
                      state_propagation=None, prior=prior,
                      solver_options=solver_options, device=device,
                      **filter_kwargs)
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    t0 = time.perf_counter()
    kf.run([day(i) for i in grid_days], x0, None, p_inv0)
    _sync(device)
    return kf, out, time.perf_counter() - t0


def phase_per_pixel(device, ny: int = TILE, nx: int = TILE, seed: int = 0):
    """phase main's tile run (6 dates) with per_pixel_convergence (and
    ONE_BLOCK linearisation): every Gauss-Newton step is one
    kalman_update, the fused update at (7, 2).
    Gates: (7, 2) launches equal the summed iterations, nothing else
    launched; outputs finite; each date's converged_frac and the
    kafka_engine_converged_frac gauge equal the frozen mask's mean over
    the valid pixels; the run held to the same run with use_pallas False
    by phase reference's rule (max |difference| <= X_ATOL, QA equal).
    Then the first window's first date alone in the engine's default
    linearisation blocks (as users run it): its wall beside the
    ONE_BLOCK run's, its launches equal to its iterations.
    Returns the record and the fused update's first-iteration inputs on
    date PER_PIXEL_KEEP_DATE."""
    import torch

    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use

    opts = {"per_pixel_convergence": True, "linearize_block": ONE_BLOCK}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with use(MetricsRegistry()) as reg, \
            UpdateKeeper(device, {(7, 2): PER_PIXEL_KEEP_DATE}) as keeper:
        reset_launches()
        kf, out, run_s = tip_tile_run(device, ny, nx, seed, opts)
        launches = launch_counts()
        peak = keeper.run_peak()
    gauge = reg.gauge("kafka_engine_converged_frac").value()
    dates = kf.diagnostics_log
    n_valid = kf.gather.n_valid
    iterations = sum(r["n_iterations"] for r in dates)
    if launches["fused_update_by_instance"] != {"7x2": iterations} or \
            launches["fused_gn"] or launches["solve_rows"]:
        raise AssertionError(f"per_pixel: launches {launches} for "
                             f"{iterations} iterations")
    failures = []
    finite = outputs_finite(out, kf.gather.mask.shape)
    if not finite:
        failures.append("non-finite output raster")
    fracs = [float(m[:n_valid].float().mean()) for m in keeper.frozen
             if m is not None]
    if len(fracs) != len(dates) or \
            [r.get("converged_frac") for r in dates] != fracs or \
            gauge != fracs[-1]:
        recorded = [r.get("converged_frac") for r in dates]
        failures.append(f"converged_frac {recorded}, frozen means {fracs}, "
                        f"gauge {gauge}")
    kf_p, out_p, plain_s = tip_tile_run(
        device, ny, nx, seed, {**opts, "use_pallas": False})
    vs_plain = compare_runs(out, out_p)
    if vs_plain["max_abs_err"] > X_ATOL or not vs_plain["solver_qa_equal"]:
        failures.append(f"against the plain loop: {vs_plain}")
    # The window's first date as users run it: the engine's default
    # ENGINE_BLOCK-px linearisation blocks.
    reset_launches()
    kf_d, out_d, default_s = tip_tile_run(
        device, ny, nx, seed, {"per_pixel_convergence": True},
        grid_days=TIP_GRID_DAYS[:2], obs_days=TIP_OBS_DAYS[:1])
    launches_d = launch_counts()
    iters_d = sum(r["n_iterations"] for r in kf_d.diagnostics_log)
    finite_d = outputs_finite(out_d, kf_d.gather.mask.shape)
    if launches_d["fused_update_by_instance"] != {"7x2": iters_d} or \
            not finite_d:
        failures.append(f"default blocks: launches {launches_d} for "
                        f"{iters_d} iterations, finite {finite_d}")
    default_blocks = {
        "run_s": default_s, "iterations": iters_d,
        "date_wall_s": [r["wall_s"] for r in kf_d.diagnostics_log],
        "one_block_date_wall_s": dates[0]["wall_s"],
        "one_block_iterations": dates[0]["n_iterations"]}
    del kf_d, out_d
    # One linearisation of the kept state, in the engine's blocks and in
    # one block (the two give the same values).
    linearize = kf.observations.operator.linearize
    x_kept = keeper.kept[(7, 2)]["xl_rows"].T.contiguous() \
        if (7, 2) in keeper.kept else None
    lin_ms = None if x_kept is None else {
        "engine_blocks": time_ms(lambda: solvers._blocked_linearize(
            linearize, None, x_kept, ENGINE_BLOCK), device, 2),
        "one_block": time_ms(lambda: linearize(None, x_kept), device, 2)}
    rec = {
        "phase": "per_pixel", "tile": [ny, nx], "n_valid": n_valid,
        "n_pad": kf.gather.n_pad, "dates_assimilated": len(dates),
        "kernel_launches": launches, "iterations": iterations,
        "iterations_plain": [r["n_iterations"] for r in
                             kf_p.diagnostics_log],
        "converged_frac": fracs, "gauge": gauge, "outputs_finite": finite,
        "vs_plain": vs_plain, "run_s": run_s, "plain_run_s": plain_s,
        "linearize_ms": lin_ms, "default_blocks": default_blocks,
        "per_date": date_records(dates, keeper.peaks),
        "peak_device_bytes": peak, "kept_date": PER_PIXEL_KEEP_DATE,
    }
    emit(rec)
    if (7, 2) not in keeper.kept:
        failures.append(f"no (7, 2) update kept on date "
                        f"{PER_PIXEL_KEEP_DATE}")
    if failures:
        raise AssertionError("per_pixel: " + "; ".join(failures))
    return rec, keeper.kept[(7, 2)]


def phase_band_seq(device, ny: int = TILE, nx: int = TILE, seed: int = 0):
    """One window of phase main's tile (two acquisitions) with
    band_sequential (and ONE_BLOCK linearisation): each date's two bands
    assimilated one after the
    other through BandViews, each band's loop the row loop around the
    fused update at (7, 1).  Gates: (7, 1) launches equal the per-band
    iterations summed, nothing else launched; no block fused; outputs
    finite; held to the same run with use_pallas False by phase
    reference's rule.  Returns the record and the (7, 1) update's
    first-iteration inputs on the first date."""
    import torch

    window = {"grid_days": (0, 16), "obs_days": (3, 10)}
    opts = {"linearize_block": ONE_BLOCK}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with UpdateKeeper(device, {(7, 1): 0}) as keeper:
        reset_launches()
        kf, out, run_s = tip_tile_run(device, ny, nx, seed, opts,
                                      band_sequential=True, **window)
        launches = launch_counts()
        peak = keeper.run_peak()
    dates = kf.diagnostics_log
    iterations = sum(r["n_iterations"] for r in dates)
    if launches["fused_update_by_instance"] != {"7x1": iterations} or \
            launches["fused_gn"] or launches["solve_rows"]:
        raise AssertionError(f"band_seq: launches {launches} for "
                             f"{iterations} iterations")
    failures = []
    if any(r.get("fused") for r in dates) or len(dates) != 2:
        failures.append(f"records {[r.get('fused') for r in dates]}")
    finite = outputs_finite(out, kf.gather.mask.shape)
    if not finite:
        failures.append("non-finite output raster")
    kf_p, out_p, plain_s = tip_tile_run(
        device, ny, nx, seed, {**opts, "use_pallas": False},
        band_sequential=True, **window)
    vs_plain = compare_runs(out, out_p)
    if vs_plain["max_abs_err"] > X_ATOL or not vs_plain["solver_qa_equal"]:
        failures.append(f"against the plain loop: {vs_plain}")
    rec = {
        "phase": "band_seq", "tile": [ny, nx], "n_valid": kf.gather.n_valid,
        "n_pad": kf.gather.n_pad, "dates_assimilated": len(dates),
        "kernel_launches": launches, "iterations": iterations,
        "iterations_plain": [r["n_iterations"] for r in
                             kf_p.diagnostics_log],
        "outputs_finite": finite, "vs_plain": vs_plain, "run_s": run_s,
        "plain_run_s": plain_s,
        "per_date": date_records(dates, keeper.peaks),
        "peak_device_bytes": peak,
    }
    emit(rec)
    if (7, 1) not in keeper.kept:
        failures.append("no (7, 1) update kept on the first date")
    if failures:
        raise AssertionError("band_seq: " + "; ".join(failures))
    return rec, keeper.kept[(7, 1)]


def band_seq_fleet_runs(device, ny: int, nx: int, seed: int):
    """The WCM, S2 and joint configurations, one window each in
    band_sequential mode, on an all-valid ny x nx tile: yields ``(name,
    (p, 1) instance, filter, grid, x0, p_inv0)``.  WCM: the torch
    run_synthetic --operator wcm configuration (23 degree incidence,
    sigma 0.002, the exact information propagator, Q 1e-3, relaxation
    0.5), one date.  S2: phase main_s2's (the SAIL prior, s2_truth,
    sigma 0.005, relaxation 0.7), one date.  Joint: phase main_joint's
    (joint_prior, JOINT_Q, per-pixel incidence in JOINT_THETA), its
    first S2 date and first S1 date, one window each."""
    from kafka_tpu_torch.cli.run_synthetic import build_operator
    from kafka_tpu_torch.core.propagators import propagate_information_filter
    from kafka_tpu_torch.engine import (JOINT_PARAMETER_LIST,
                                        PROSAIL_PARAMETER_LIST, KalmanFilter,
                                        joint_prior, sail_prior)
    from kafka_tpu_torch.testing import joint_observations, joint_truth
    from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                   SyntheticObservations,
                                                   s2_observations)

    def day(i):
        return datetime.datetime(2017, 7, 1) + datetime.timedelta(days=i)

    mask = np.ones((ny, nx), bool)

    def filt(obs, params, propagator, prior, q, relaxation):
        kf = KalmanFilter(obs, MemoryOutput(), mask, params,
                          state_propagation=propagator, prior=prior,
                          solver_options={"relaxation": relaxation},
                          band_sequential=True, device=device)
        kf.set_trajectory_model()
        kf.set_trajectory_uncertainty(np.asarray(q, np.float32))
        return kf

    op, params, prior, truth_val, aux_fn, sigma = build_operator("wcm",
                                                                 device)
    truth = np.broadcast_to(truth_val, (ny, nx, 2)).astype(np.float32)
    obs = SyntheticObservations([day(1)], op, lambda d: truth, sigma=sigma,
                                aux_fn=aux_fn, mask_prob=0.1, seed=seed,
                                device=device)
    kf = filt(obs, params, propagate_information_filter, None,
              np.full(2, 1e-3), 0.5)
    yield ("wcm", (2, 1), kf, [day(0), day(4)],
           *prior.process_prior(None, kf.gather))

    truth = s2_truth(ny, nx, seed)
    obs = s2_observations([day(3)], lambda d: truth,
                          angles=(30.5, 5.0, -50.0), sigma=0.005,
                          mask_prob=0.1, seed=seed, device=device)
    prior = sail_prior(device)
    kf = filt(obs, PROSAIL_PARAMETER_LIST, None, prior, np.zeros(10), 0.7)
    yield ("s2", (10, 1), kf, [day(2), day(4)],
           *prior.process_prior(None, kf.gather))

    truth = joint_truth(mask.shape)
    theta = np.random.default_rng(seed).uniform(
        *JOINT_THETA, size=(ny, nx)).astype(np.float32)
    s2_dates, s1_dates, grid = joint_dates()
    obs = joint_observations(s2_dates[:1], s1_dates[:1], lambda d: truth,
                             theta, s2_angles=(30.5, 5.0, -50.0),
                             s1_sigma=JOINT_S1_SIGMA, device=device)
    kf = filt(obs, JOINT_PARAMETER_LIST, propagate_information_filter, None,
              JOINT_Q, 0.7)
    yield ("joint", (11, 1), kf, grid[:3],
           *joint_prior(device).process_prior(None, kf.gather))


def phase_band_seq_fleet(device, ny: int = BAND_SEQ_FLEET_TILE,
                         nx: int = BAND_SEQ_FLEET_TILE, seed: int = 0):
    """The band-sequential mode on the WCM, S2 and joint states
    (``band_seq_fleet_runs``), each band's loop the row loop around the
    fused update at (2, 1), (10, 1) and (11, 1).  Gates per
    configuration: that instance's launches equal the per-band
    iterations summed, nothing else launched; no block fused; every
    date assimilated; outputs finite.  Returns the record and each
    instance's first-iteration inputs on the first date."""
    import torch

    recs, kept = {}, {}
    failures = []
    for name, inst, kf, grid, x0, p_inv0 in band_seq_fleet_runs(
            device, ny, nx, seed):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with UpdateKeeper(device, {inst: 0}) as keeper:
            reset_launches()
            t0 = time.perf_counter()
            kf.run(grid, x0, None, p_inv0)
            _sync(device)
            run_s = time.perf_counter() - t0
            launches = launch_counts()
            peak = keeper.run_peak()
        dates = kf.diagnostics_log
        iterations = sum(r["n_iterations"] for r in dates)
        key = f"{inst[0]}x{inst[1]}"
        if launches["fused_update_by_instance"] != {key: iterations} or \
                launches["fused_gn"] or launches["solve_rows"]:
            raise AssertionError(f"band_seq_fleet ({name}): launches "
                                 f"{launches} for {iterations} iterations")
        finite = outputs_finite(kf.output, kf.gather.mask.shape)
        if any(r.get("fused") for r in dates) or \
                len(dates) != len(grid) - 1 or not finite:
            failures.append(f"{name}: fused {[r.get('fused') for r in dates]}"
                            f", finite {finite}")
        if inst in keeper.kept:
            kept[inst] = keeper.kept[inst]
        else:
            failures.append(f"{name}: no {inst} update kept")
        recs[name] = {
            "instance": key, "n_valid": kf.gather.n_valid,
            "n_pad": kf.gather.n_pad, "dates_assimilated": len(dates),
            "kernel_launches": launches, "iterations": iterations,
            "outputs_finite": finite, "run_s": run_s,
            "per_date": date_records(dates, keeper.peaks),
            "peak_device_bytes": peak}
        del kf
    rec = {"phase": "band_seq_fleet", "tile": [ny, nx], "runs": recs}
    emit(rec)
    if failures:
        raise AssertionError("band_seq_fleet: " + "; ".join(failures))
    return rec, kept


def seeded_update_rows(p: int, nb: int, n: int, device, seed: int) -> dict:
    """``n`` seeded fused-update problems at (p, nb) in row layout:
    standard normal Jacobians, h0 and y, weights in [0.5, 2], 70 % of the
    entries observed (NaN y under the mask), x_lin near x_f, prior
    information M M^T + 3 I, no escalation."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g)

    mask = torch.rand(nb, n, generator=g) > 0.3
    x_f = normal(p, n)
    m = normal(n, p, p)
    p_inv = m @ m.mT + 3.0 * torch.eye(p)
    rows = dict(
        jac_rows=normal(nb * p, n), h0=normal(nb, n),
        y=torch.where(mask, normal(nb, n), float("nan")),
        w=torch.where(mask, 0.5 + 1.5 * torch.rand(nb, n, generator=g), 0.0),
        m=mask.float(), xl_rows=x_f + 0.1 * normal(p, n), xf_rows=x_f,
        pf_rows=torch.stack([p_inv[:, i, j] for i in range(p)
                             for j in range(i + 1)]),
        esc_row=torch.zeros(1, n))
    return {k: v.to(device).contiguous() for k, v in rows.items()}


def phase_hessian(device, ny: int = TILE, nx: int = TILE, seed: int = 0):
    """One date of phase main's tile with hessian_correction: one
    fused_gn launch, then the second-order correction C (torch.func
    forward over reverse of the two-stream forward) and the eigenvalue
    floor.  Gates: one fused_gn launch; A finite; every valid pixel's
    smallest eigenvalue (float64) at least the floor, less the float32
    rounding of the rebuild (4 ulps of the largest); C on HESSIAN_SAMPLE
    sampled pixels within HESSIAN_RTOL of a float64 torch.func
    evaluation (relative to the pixel's largest entry); the pixels the
    floor leaves alone keep A - C bit for bit.  Prints the ms of the
    correction and of the batched eigh on the tile."""
    import torch

    from kafka_tpu_torch.core import hessian as hess_mod
    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.linalg import EIGH_BLOCK, eigh_blocked

    seen = {}
    real_corr, real_floor = hess_mod.hessian_correction, \
        solvers.eigenvalue_floor

    def keep_corr(fwd, x, r_inv, inn, mask):
        c = real_corr(fwd, x, r_inv, inn, mask)
        seen.update(fwd=fwd, x=x, r_inv=r_inv, inn=inn, mask=mask, c=c)
        return c

    def keep_floor(a):
        out = real_floor(a)
        seen.update(a_in=a, a_out=out)
        return out

    hess_mod.hessian_correction = keep_corr
    solvers.eigenvalue_floor = keep_floor
    try:
        reset_launches()
        kf, out, run_s = tip_tile_run(device, ny, nx, seed, None,
                                      hessian_correction=True,
                                      grid_days=(0, 16), obs_days=(3,))
        launches = launch_counts()
    finally:
        hess_mod.hessian_correction = real_corr
        solvers.eigenvalue_floor = real_floor
    if launches["fused_gn"] != 1 or launches["fused_update"] or \
            launches["solve_rows"] or "a_out" not in seen:
        raise AssertionError(f"hessian: launches {launches} for one date, "
                             f"correction run: {'a_out' in seen}")
    failures = []
    n_valid = kf.gather.n_valid
    a_in, a_out, c = seen["a_in"], seen["a_out"], seen["c"]
    finite = bool(torch.isfinite(a_out).all())
    # The floor's own decision, recomputed: eigh is deterministic.
    w = eigh_blocked(a_in)[0]
    floor = 1e-6 * torch.clamp(w[:, -1:].abs(), min=1e-3)
    bad = w[:, 0] < floor[:, 0]
    healthy_same = bool((a_out[~bad].view(torch.int32)
                         == a_in[~bad].view(torch.int32)).all())
    w64 = eigh_blocked(a_out[:n_valid].double())[0]
    w_max = w64[:, -1].abs()
    floor64 = 1e-6 * torch.clamp(w_max, min=1e-3)
    slack = 4 * float(np.finfo(np.float32).eps) * w_max
    below = int((w64[:, 0] < floor64 - slack).sum())
    idx = torch.as_tensor(np.random.default_rng(seed).choice(
        n_valid, min(HESSIAN_SAMPLE, n_valid), replace=False),
        device=device)
    c64 = hess_mod.hessian_correction(
        seen["fwd"], seen["x"][idx].double(), seen["r_inv"][:, idx].double(),
        seen["inn"][:, idx].double(), seen["mask"][:, idx])
    scale = c64.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    rel = ((c[idx].double() - c64).abs().amax(dim=(1, 2)) / scale)
    # Timing on the date's inputs: the correction, and eigh on the tile.
    hess_ms = time_ms(lambda: hess_mod.hessian_correction(
        seen["fwd"], seen["x"], seen["r_inv"], seen["inn"], seen["mask"]),
        device, 2)
    eigh_ms = time_ms(lambda: eigh_blocked(a_in), device, 2)
    floor_ms = time_ms(lambda: solvers.eigenvalue_floor(a_in), device, 2)
    # Why eigh_blocked slices: one batched eigh call at EIGH_BLOCK and at
    # twice that many seeded SPD matrices (recorded, not gated).
    eigh_batches = {}
    for n_mat in (EIGH_BLOCK, 2 * EIGH_BLOCK):
        g = torch.Generator(device="cpu").manual_seed(n_mat)
        m = torch.randn(n_mat, 7, 7, generator=g).to(device)
        try:
            torch.linalg.eigh(m @ m.mT + torch.eye(7, device=device))
            _sync(device)
            eigh_batches[n_mat] = "ok"
        except RuntimeError as exc:
            eigh_batches[n_mat] = str(exc)[:80]
    rec = {
        "phase": "hessian", "tile": [ny, nx], "n_valid": n_valid,
        "n_pad": kf.gather.n_pad, "kernel_launches": launches,
        "a_finite": finite, "pixels_floored": int(bad.sum()),
        "healthy_a_equal_a_minus_c": healthy_same,
        "pixels_below_floor": below,
        "correction_vs_f64": {"sampled": int(idx.numel()),
                              **quantile_summary(rel.float())},
        "correction_max_abs": float(c.abs().max()),
        "hessian_ms": hess_ms, "eigh_ms": eigh_ms,
        "eigenvalue_floor_ms": floor_ms, "eigh_batches": eigh_batches,
        "run_s": run_s,
        "per_date": date_records(kf.diagnostics_log),
    }
    emit(rec)
    if not finite:
        failures.append("non-finite A")
    if below:
        failures.append(f"{below} pixels below the eigenvalue floor")
    if not healthy_same:
        failures.append("a pixel the floor leaves alone changed")
    if float(rel.max()) > HESSIAN_RTOL:
        failures.append(f"correction off float64 by {float(rel.max())}")
    if failures:
        raise AssertionError("hessian: " + "; ".join(failures))
    return rec


def dense_update_split(device, kept: dict, reps: int = 3) -> dict:
    """Milliseconds of the dense update's parts on kept inputs: the
    assembly (build_normal_equations), the factor (cholesky_dense, and
    the bare cholesky_ex inside it), the two triangular solves, and one
    exact information-filter propagation of the kept P^-1 (Q = 0)."""
    import torch

    from kafka_tpu_torch.core import linalg, propagators, solvers

    lin, obs = kept["lin"], kept["obs"]
    x_lin, x_f, p_inv = kept["x_lin"], kept["x_f"], kept["p_inv"]
    p = x_f.shape[-1]
    a, b = solvers.build_normal_equations(lin, obs, x_lin, x_f, p_inv)
    chol = linalg.cholesky_dense(a)
    eye = torch.eye(p, dtype=torch.float32, device=device)
    q0 = torch.zeros(p, dtype=torch.float32, device=device)
    out = {
        "assembly_ms": time_ms(lambda: solvers.build_normal_equations(
            lin, obs, x_lin, x_f, p_inv), device, reps),
        "cholesky_dense_ms": time_ms(lambda: linalg.cholesky_dense(a),
                                     device, reps),
        "cholesky_ex_ms": time_ms(lambda: torch.linalg.cholesky_ex(a),
                                  device, reps),
        "triangular_solves_ms": time_ms(
            lambda: linalg._solve_chol_dense(chol, b[..., None]), device,
            reps),
        "propagation_ms": time_ms(
            lambda: propagators.propagate_information_filter(
                x_f, None, p_inv, eye, q0), device, reps),
        "nonfinite_pixels": int((~torch.isfinite(chol).all(dim=(1, 2)))
                                .sum()),
    }
    del a, b, chol
    return out


def phase_cli_mod09(device, workdir: str, ny: int = TILE, nx: int = TILE,
                    chunk: int = CLI_MOD09_CHUNK, seed: int = 0):
    """The torch ``run_mod09`` driver as users run it, in-process, over a
    MOD09GA granule tree written on disk: ``make_mod09_granules`` (noise
    0.002) over the ny x nx 500 m tile (the 1 km QA and angle rasters at
    half that) for CLI_MOD09_DATES daily dates, phase main's land mask as
    the state mask, ``default_config()`` with ``end`` CLI_MOD09_END and
    chunk x chunk chunks.  The 21-parameter Ross-Li kernel-weight state
    takes the dense large-p solve (torch.linalg) under the exact
    information filter: no hand kernel.  Gates: every chunk run and
    every date assimilated; 0 kernel launches; every expected GeoTIFF
    present and finite on the mask; the median b1_iso of the last window
    within MOD09_ISO_GATE of the truth; a second ``main`` that skips
    every chunk and writes nothing; the first chunk run alone unfused
    (scan_window 1) equal to the fused run bit for bit.  Prints the
    dense update split into its parts on a kept chunk date."""
    import torch

    from kafka_tpu_torch.cli import run_mod09
    from kafka_tpu_torch.engine.priors import (KERNEL_PARAMETER_LIST,
                                               kernels_prior_arrays)
    from kafka_tpu_torch.io import get_chunks, write_geotiff
    from kafka_tpu_torch.io.mod09 import MOD09Observations
    from kafka_tpu_torch.testing.fixtures import (DEFAULT_GEO,
                                                  make_mod09_granules)

    t_phase = time.perf_counter()
    mask = land_mask(ny, nx, seed)
    mask_path = os.path.join(workdir, "mask.tif")
    write_geotiff(mask_path, mask.astype(np.uint8), DEFAULT_GEO)
    data = os.path.join(workdir, "mod09")
    dates = [datetime.datetime(2017, 6, 1) + datetime.timedelta(days=i)
             for i in range(CLI_MOD09_DATES)]
    truth = make_mod09_granules(data, dates, ny=ny // 2, nx=nx // 2,
                                geo=DEFAULT_GEO, noise=0.002, seed=seed)
    cfg = run_mod09.default_config()
    cfg.end = CLI_MOD09_END
    cfg.chunk_size = (chunk, chunk)
    cfg_path = os.path.join(workdir, "run_mod09.json")
    cfg.save(cfg_path)
    outdir = os.path.join(workdir, "out")
    argv = ["--config", cfg_path, "--data-folder", data, "--state-mask",
            mask_path, "--outdir", outdir, "--device", str(device)]
    data_s = time.perf_counter() - t_phase
    chunks = list(get_chunks(nx, ny, cfg.chunk_size))
    grid = cfg.time_grid()

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with DriverProbe(MOD09Observations) as probe, \
            UpdateKeeper(device, {"dense": CLI_MOD09_KEEP_DATE}) as keeper:
        reset_launches()
        stats, printed, _ = run_driver(run_mod09.main, argv)
        launches = launch_counts()
    peak = keeper.run_peak()
    failures = []
    if printed != stats:
        failures.append("the printed line is not the stats")
    n = len(chunks)
    if (stats["run"], stats["skipped"], stats["failed"],
            stats["chunks_with_pixels"], stats["dates_assimilated"]) != \
            (n, 0, 0, n, n * len(dates)):
        failures.append(f"stats {stats}")
    if launches["fused_gn"] or launches["fused_update"] or \
            launches["solve_rows"]:
        failures.append(f"hand-kernel launches {launches} on the dense "
                        "path")
    if failures:  # the run itself failed: nothing further to check
        emit({"phase": "cli_mod09", "stats": stats,
              "kernel_launches": launches, "failures": failures})
        raise AssertionError("cli_mod09: " + "; ".join(failures))
    runs = probe.dates()

    t0 = time.perf_counter()
    # No solve health on the dense path: no QA band.
    expected = {f for f in chunk_rasters(chunks, grid, dates,
                                         KERNEL_PARAMETER_LIST)
                if not f.startswith("solver_qa_")}
    written = {f for f in os.listdir(outdir) if f.endswith(".tif")}
    if written != expected:
        failures.append(f"{len(written)} GeoTIFFs written, "
                        f"{len(expected)} expected: "
                        f"{sorted(written ^ expected)[:4]}")
    sub = {f"{c.chunk_no:04x}": mask[c.y0:c.y0 + c.ny_valid,
                                     c.x0:c.x0 + c.nx_valid]
           for c in chunks}
    names = sorted(written & expected)
    nonfinite = [name for name, arr in zip(names, read_rasters(
        [os.path.join(outdir, name) for name in names]))
        if not np.isfinite(arr[sub[chunk_prefix(name)]]).all()]
    if nonfinite:
        failures.append(f"non-finite: {nonfinite[:4]}")
    last = grid[-1].strftime("A%Y%j")
    iso = raster_median(outdir, [f"b1_iso_{last}_{p}.tif" for p in sub],
                        list(sub.values()))
    if not abs(iso - truth[0]) < MOD09_ISO_GATE:
        failures.append(f"median b1_iso {iso}, truth {truth[0]}")
    check_s = time.perf_counter() - t0

    # The restart: every chunk has its .done marker.
    before = folder_state(outdir)
    reset_launches()
    again, _, again_s = run_driver(run_mod09.main, argv)
    if (again["run"], again["skipped"]) != (0, n) or \
            folder_state(outdir) != before:
        failures.append(f"restart ran {again}")

    # The first chunk alone, unfused: its rasters equal the fused run's.
    t0 = time.perf_counter()
    first = chunks[0]
    mask1 = np.zeros_like(mask)
    sl = (slice(first.y0, first.y0 + first.ny_valid),
          slice(first.x0, first.x0 + first.nx_valid))
    mask1[sl] = mask[sl]
    mask1_path = os.path.join(workdir, "mask_first_chunk.tif")
    write_geotiff(mask1_path, mask1.astype(np.uint8), DEFAULT_GEO)
    cfg.scan_window = 1
    cfg1_path = os.path.join(workdir, "run_mod09_unfused.json")
    cfg.save(cfg1_path)
    out1 = os.path.join(workdir, "out_unfused")
    one, _, _ = run_driver(run_mod09.main, [
        "--config", cfg1_path, "--data-folder", data, "--state-mask",
        mask1_path, "--outdir", out1, "--device", str(device)])
    prefix = f"{first.chunk_no:04x}"
    mine = sorted(f for f in os.listdir(out1) if f.endswith(".tif"))
    differ = [f for f, a, b in zip(
        mine, read_rasters([os.path.join(out1, f) for f in mine]),
        read_rasters([os.path.join(outdir, f) for f in mine]))
        if a.tobytes() != b.tobytes()]
    if one["chunks_with_pixels"] != 1 or not mine or differ or \
            any(chunk_prefix(f) != prefix for f in mine):
        failures.append(f"unfused first chunk: {one}, {len(mine)} files, "
                        f"differing {differ[:4]}")
    unfused_s = time.perf_counter() - t0
    dense = keeper.kept.pop("dense", None)
    split = {} if dense is None else dense_update_split(device, dense)
    if dense is None:
        failures.append(f"no dense update kept on date "
                        f"{CLI_MOD09_KEEP_DATE}")
    del dense

    n_valid = stats["pixels"]
    iters = [r["n_iterations"] for r in runs]
    rec = {
        "phase": "cli_mod09", "tile": [ny, nx], "chunk": list(cfg.chunk_size),
        "chunks": n, "n_valid": n_valid, "p": len(KERNEL_PARAMETER_LIST),
        "dates": [str(d.date()) for d in dates],
        "reduced": {"dates": f"{len(dates)} of the config's 30 daily "
                             "dates",
                    "chunk": f"{chunk} x {chunk} instead of the default "
                             "256 x 256"},
        "stats": stats, "wall_s": stats["wall_s"],
        "pixel_steps_per_s": n_valid * len(dates) / stats["wall_s"],
        "chunk_wall_s": [s["wall_s"] for s in probe.summaries],
        "date_wall_s": [r["wall_s"] for r in runs],
        "reader_s_per_date": probe.reads,
        "fused_per_date": [r.get("fused") for r in runs],
        "iterations_per_date": iters,
        "kernel_launches": launches, "peak_device_bytes": peak,
        "geotiffs": len(written),
        "median_b1_iso": {"last_window": iso, "truth": float(truth[0]),
                          "prior": float(kernels_prior_arrays()[0][0])},
        "dense_update_split": {**split, "updates_per_date":
                               iters[CLI_MOD09_KEEP_DATE]
                               if len(iters) > CLI_MOD09_KEEP_DATE else None},
        "restart": {"stats": again, "seconds": again_s},
        "unfused_first_chunk": {"files": len(mine), "differing": len(differ),
                                "seconds": unfused_s},
        "seconds": {"data": data_s, "check": check_s,
                    "phase": time.perf_counter() - t_phase},
        "kept_date": CLI_MOD09_KEEP_DATE,
    }
    emit(rec)
    if failures:
        raise AssertionError("cli_mod09: " + "; ".join(failures))
    return rec


# ---------------------------------------------------------------------------
# Reanalysis and serving (phases smooth, serve, serve_batch)
# ---------------------------------------------------------------------------

def _timed(sink: list, fn, device):
    """``fn`` wrapped to append its wall seconds (device synchronised
    before and after) to ``sink``."""
    def wrapped(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _sync(device)
            sink.append(time.perf_counter() - t0)
    return wrapped


def patched(*patches):
    """``mock.patch.object`` of each ``(module, name, value)`` for the
    span of one ``with`` block."""
    from contextlib import ExitStack
    from unittest import mock

    stack = ExitStack()
    for mod, name, value in patches:
        stack.enter_context(mock.patch.object(mod, name, value))
    return stack


def phase_smooth(device, workdir: str, ny: int = TILE, nx: int = TILE,
                 sample: int = SMOOTH_SAMPLE):
    """``kafka_smooth.main`` over the checkpoint chain phase cli leaves in
    ``workdir`` (its driver's ``out/ckpt``, the tile under phase main's
    land mask, written as ``mask.tif``): one smoothed product per chain
    date, finite on the mask; the newest date's x the chain's analysis
    bit for bit; diag(P_s^-1) >= diag(P_a^-1) everywhere (the clamp
    count printed); the QA bits; on ``sample`` seeded pixels the smoothed
    x and information diagonal within the JAX test's budget of a float64
    run of the port's own sweep on the same pixels; no hand-kernel
    launch.  Times the chain load, the sweep and the batched inverses
    inside it, and the product writes."""
    import contextlib
    import io

    import torch

    from kafka_tpu_torch.cli import kafka_smooth as ks
    from kafka_tpu_torch.io import read_geotiff
    from kafka_tpu_torch.smoother import (QA_CLAMPED, QA_REDERIVED,
                                          QA_SMOOTHED, QA_TERMINAL,
                                          rts_pass)

    mask = read_geotiff(os.path.join(workdir, "mask.tif"))[0].astype(bool)
    n_valid = int(mask.sum())
    rng = np.random.default_rng(SMOOTH_SAMPLE_SEED)
    idx = np.sort(rng.choice(n_valid, size=min(sample, n_valid),
                             replace=False))
    load_s, sweep_s, inv_s, write_s = [], [], [], []
    captured, results, chains = [], [], []
    real_sweep = rts_pass.rts_sweep
    real_load = rts_pass.load_chain
    real_smooth = ks.smooth_checkpoints
    block = rts_pass.SWEEP_BLOCK

    def sweep(*args):
        out = real_sweep(*args)
        lo = len(captured) * block
        hi = lo + args[5].shape[0]
        local = torch.as_tensor(idx[(idx >= lo) & (idx < hi)] - lo,
                                device=args[5].device)
        pick = [a[:, local].cpu() if a.ndim >= 3 else a[local].cpu()
                for a in (args[0], args[1], args[2], args[3])]
        captured.append((pick, args[4].cpu(), args[5][local].cpu(),
                         args[6][local].cpu(),
                         [t[:, local].cpu() for t in out]))
        return out

    def load(*args, **kwargs):
        nodes, skipped = real_load(*args, **kwargs)
        chains.append((nodes[-1].x_analysis if nodes else None,
                       [n.timestep for n in nodes], skipped))
        return nodes, skipped

    def smooth(*args, **kwargs):
        results.append(real_smooth(*args, **kwargs))
        return results[-1]

    outdir = os.path.join(workdir, "smooth")
    argv = ["--ckpt-dir", os.path.join(workdir, "out", "ckpt"),
            "--outdir", outdir, "--operator", "twostream",
            "--mask", os.path.join(workdir, "mask.tif"),
            "--device", str(device)]
    reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with patched(
            (rts_pass, "rts_sweep", _timed(sweep_s, sweep, device)),
            (rts_pass, "load_chain", _timed(load_s, load, device)),
            (rts_pass, "batched_inverse",
             _timed(inv_s, rts_pass.batched_inverse, device)),
            (ks, "smooth_checkpoints", smooth),
            (ks, "_write_outputs", _timed(write_s, ks._write_outputs,
                                          device))):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = ks.main(argv)
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    failures = []
    if not results or "failed" in summary:
        raise AssertionError(f"smooth: kafka_smooth failed: {summary}")
    res = results[0]
    newest_x, chain_dates, skipped = chains[0]
    n_dates = len(res.timesteps)
    params = ks._OPERATOR_PARAMS["twostream"]
    stamps = [ts.strftime("A%Y%j") for ts in res.timesteps]
    names = [f"{pr}_{s}_smoothed{kind}.tif" for s in stamps
             for pr in params for kind in ("", "_unc")]
    qa_names = [f"solver_qa_{s}_smoothed.tif" for s in stamps]
    missing = [nm for nm in names + qa_names
               if not os.path.exists(os.path.join(outdir, nm))]
    if missing:
        failures.append(f"missing products {missing[:4]}")
    nonfinite = [nm for nm, arr in zip(names, read_rasters(
        [os.path.join(outdir, nm) for nm in names if nm not in missing]))
        if not np.isfinite(arr[mask]).all()]
    if nonfinite:
        failures.append(f"non-finite products {nonfinite[:4]}")
    if not same_bits(res.x_smoothed[-1], np.asarray(newest_x, np.float32)):
        failures.append("the newest date's x differs from the chain's "
                        "analysis")
    below = int((res.p_inv_diag[:, :n_valid]
                 < res.p_inv_diag_filter[:, :n_valid]).sum())
    if below:
        failures.append(f"{below} smoothed information entries below the "
                        "filter's")
    qa = res.qa[:, :n_valid]
    clamped = [int(np.count_nonzero(qa[t] & QA_CLAMPED))
               for t in range(n_dates)]
    rederived = [res.timesteps.index(ts) for ts in res.rederived]
    qa_ok = (bool(((qa & QA_SMOOTHED) > 0).all())
             and bool(((qa[-1] & QA_TERMINAL) > 0).all())
             and not bool((qa[:-1] & QA_TERMINAL).any())
             and clamped[-1] == 0
             and all(bool(((qa[t] & QA_REDERIVED) > 0).all()) ==
                     (t in rederived)
                     and (t in rederived or not (qa[t] & QA_REDERIVED).any())
                     for t in range(n_dates)))
    if not qa_ok:
        failures.append("QA bits differ from the JAX convention")
    # The float64 run of the port's own sweep on the sampled pixels.
    f64 = {"x": [], "diag": []}
    for pick, m, x_anc, p_anc, out in captured:
        xs64, d64, _ = real_sweep(*[t.double() for t in pick], m.double(),
                                  x_anc.double(), p_anc.double())
        f64["x"].append((out[0].double(), xs64))
        f64["diag"].append((out[1].double(), d64))
    x32 = torch.cat([a for a, _ in f64["x"]], dim=1)
    x64 = torch.cat([b for _, b in f64["x"]], dim=1)
    d32 = torch.cat([a for a, _ in f64["diag"]], dim=1)
    d64 = torch.cat([b for _, b in f64["diag"]], dim=1)
    x_excess = (x32 - x64).abs() - (SMOOTH_X_ATOL + SMOOTH_X_RTOL * x64.abs())
    d_excess = (d32 - d64).abs() - SMOOTH_DIAG_RTOL * d64.abs()
    sampled = int(x32.shape[1])
    over = {"x": int((x_excess > 0).sum()), "diag": int((d_excess > 0)
                                                         .sum())}
    if sampled != len(idx):
        failures.append(f"{sampled} of {len(idx)} sampled pixels captured")
    if any(over.values()):
        failures.append(f"entries beyond the JAX budget of the float64 "
                        f"sweep: {over}")
    if launches["fused_gn"] or launches["fused_update"] or \
            launches["solve_rows"]:
        failures.append(f"hand-kernel launches in the smoother: {launches}")
    dates = summary["dates"]
    rec = {
        "phase": "smooth", "tile": [ny, nx], "n_valid": n_valid,
        "chain_dates": [str(t) for t in chain_dates],
        "skipped": [str(t) for t in skipped],
        "rederived": [str(t) for t in res.rederived],
        "wall_s": summary["wall_s"], "main_s": wall,
        "chain_load_s": sum(load_s), "sweep_ms": 1e3 * sum(sweep_s),
        "batched_inverse_ms": 1e3 * sum(inv_s),
        "batched_inverses": len(inv_s),
        "sweep_block": block, "sweep_blocks": len(sweep_s),
        "product_write_s": sum(write_s),
        "outputs_written": summary["outputs_written"],
        "peak_device_bytes": peak, "kernel_launches": launches,
        "clamped_px_per_date": clamped,
        "sample": {"pixels": sampled, "seed": SMOOTH_SAMPLE_SEED,
                   "beyond_budget": over,
                   "x_max_abs_vs_f64": float((x32 - x64).abs().max()),
                   "diag_max_rel_vs_f64": float(
                       ((d32 - d64).abs() / d64.abs()).max())},
        "x_sha256": {"newest": dates[res.timesteps[-1].isoformat()]
                     ["x_sha256"],
                     "oldest": dates[res.timesteps[0].isoformat()]
                     ["x_sha256"]},
        "sigma_shrink_oldest": dates[res.timesteps[0].isoformat()]
        ["sigma_shrink"],
    }
    emit(rec)
    if failures:
        raise AssertionError("smooth: " + "; ".join(failures))
    return rec


def serve_ladder(dates):
    """Phase serve's requests per tile, in order: (label, date, smoothed,
    the served_from expected)."""
    return (("cold", dates[SERVE_WINDOW_DATES[2]], False, "cold"),
            ("cache", dates[SERVE_WINDOW_DATES[2]], False, "cache"),
            ("warm_noop", dates[SERVE_WINDOW_DATES[2] + 1], False,
             "warm_noop"),
            ("warm", dates[SERVE_WINDOW_DATES[4]], False, "warm"),
            ("cold_replay", dates[SERVE_WINDOW_DATES[1]], False,
             "cold_replay"),
            ("smoothed", dates[SERVE_WINDOW_DATES[2]], True,
             "smoothed_chain"))


def phase_serve(device, workdir: str, ny: int = TILE, nx: int = TILE,
                days: int = SERVE_DAYS, tiles: int = 2):
    """``kafka_serve.main`` in-process at full width (``SERVE_ARGS``: two
    synthetic two-stream tiles, 2400 x 2400 pivot masks of seeds 0 and 1)
    over an inbox filled before the daemon starts with, per tile, the
    ``serve_ladder`` requests; it exits when idle.  Gates: every
    served_from outcome and every response ok; the warm response's
    x_sha256 equal to a cold serve of its date on a fresh checkpoint
    directory; the smoothed response's equal to ``kafka_smooth``'s over
    that tile's chain; fused_gn launched, its plain version never; the
    daemon's summary clean."""
    import contextlib
    import io

    from kafka_tpu_torch.cli import kafka_serve, kafka_smooth
    from kafka_tpu_torch.core import fused_gn
    from kafka_tpu_torch.engine.checkpoint import Checkpointer
    from kafka_tpu_torch.serve import (TileSession, make_synthetic_tile,
                                       read_response, submit_request,
                                       synthetic_dates)
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE

    root = os.path.join(workdir, "serve")
    dates = synthetic_dates(DEFAULT_BASE_DATE, days, 2)
    ladder = serve_ladder(dates)
    rids = {}
    for k, (label, date, smoothed, _) in enumerate(ladder):
        for t in range(tiles):
            rid = f"r{k:02d}_tile{t}_{label}"
            rids[rid] = (f"tile{t}", label, date, smoothed)
            submit_request(root, {"request_id": rid, "tile": f"tile{t}",
                                  "date": date.isoformat(),
                                  "smoothed": smoothed})
    plain_calls, saves = [], []
    real_plain = fused_gn.fused_gn_raw_plain

    def plain(*args, **kwargs):
        plain_calls.append(None)
        return real_plain(*args, **kwargs)

    argv = ["--root", root, "--tiles", str(tiles), "--operator",
            "twostream", "--ny", str(ny), "--nx", str(nx), "--days",
            str(days), "--step", "4", "--obs-every", "2",
            "--exit-when-idle", "--aot-buckets", "1",
            "--device", str(device)]
    reset_launches()
    with patched((fused_gn, "fused_gn_raw_plain", plain),
                 (Checkpointer, "save",
                  _timed(saves, Checkpointer.save, device))):
        t0 = time.perf_counter()
        summary = kafka_serve.main(argv)
        wall = time.perf_counter() - t0
    launches = launch_counts()
    failures = []
    responses = {rid: read_response(root, rid) for rid in rids}
    by_outcome = {}
    for rid, (tile, label, date, smoothed) in rids.items():
        r = responses[rid] or {}
        if r.get("status") != "ok":
            failures.append(f"{rid}: {r.get('status')} "
                            f"{r.get('error') or r.get('reason')}")
            continue
        by_outcome.setdefault(r["served_from"], []).append({
            "request": rid, "wall_ms": r.get("wall_ms"),
            "trace_phases": (r.get("trace") or {}).get("phases")})
    expected = {want for _, _, _, want in ladder}
    if set(by_outcome) != expected:
        failures.append(f"served_from outcomes {sorted(by_outcome)}, "
                        f"expected {sorted(expected)}")
    for rid, (tile, label, _, _) in rids.items():
        want = [w for lb, _, _, w in ladder if lb == label][0]
        got = (responses[rid] or {}).get("served_from")
        if got != want:
            failures.append(f"{rid}: served_from {got}, expected {want}")
    # The warm-path invariant: tile0's warm answer equals a cold serve of
    # its date on a fresh checkpoint directory.
    warm_rid = next(r for r, v in rids.items()
                    if v[0] == "tile0" and v[1] == "warm")
    t1 = time.perf_counter()
    cold = TileSession(make_synthetic_tile(
        "tile0", os.path.join(workdir, "serve_fresh_ckpt"),
        operator="twostream", ny=ny, nx=nx, days=days, step_days=4,
        obs_every=2, seed=0, device=device)).serve(rids[warm_rid][2])
    cold_s = time.perf_counter() - t1
    warm_equal = cold["served_from"] == "cold" and \
        cold["x_sha256"] == (responses[warm_rid] or {}).get("x_sha256")
    if not warm_equal:
        failures.append("the warm response differs from a cold serve of "
                        "its date")
    # The served reanalysis against the offline driver over that chain.
    smooth_rid = next(r for r, v in rids.items()
                      if v[0] == "tile0" and v[1] == "smoothed")
    sm = responses[smooth_rid] or {}
    with contextlib.redirect_stdout(io.StringIO()):
        offline = kafka_smooth.main([
            "--ckpt-dir", os.path.join(root, "ckpt_tile0"),
            "--operator", "twostream", "--ny", str(ny), "--nx", str(nx),
            "--device", str(device)])
    offline_sha = (offline.get("dates") or {}).get(
        sm.get("timestep"), {}).get("x_sha256")
    smoothed_equal = offline_sha is not None and \
        offline_sha == sm.get("x_sha256")
    if not smoothed_equal:
        failures.append("the smoothed response differs from kafka_smooth "
                        "over the tile's chain")
    if launches["fused_gn"] <= 0:
        failures.append("no fused_gn launch during the serve")
    if device.type == "cuda" and plain_calls:
        failures.append(f"{len(plain_calls)} calls of the plain version "
                        "on the card")
    if summary.get("errors") or summary.get("rejected") or \
            summary.get("failed"):
        failures.append(f"daemon summary {summary}")
    if os.listdir(os.path.join(root, "inbox")):
        failures.append("requests left in the inbox")
    aot = summary.get("serve_aot_buckets") or {}
    rec = {
        "phase": "serve", "tile": [ny, nx], "tiles": tiles, "days": days,
        "argv": argv, "daemon_s": wall, "summary": summary,
        "wall_ms_by_served_from": by_outcome,
        "checkpoint_save_s": saves,
        "aot_warmup_s": [b["compile_ms"] / 1e3
                         for b in aot.get("buckets", [])],
        "kernel_launches": launches, "plain_calls": len(plain_calls),
        "warm_equals_fresh_cold": warm_equal, "fresh_cold_s": cold_s,
        "smoothed_equals_kafka_smooth": smoothed_equal,
        "n_pixels": {f"tile{t}": (responses.get(f"r00_tile{t}_cold") or {})
                     .get("n_pixels") for t in range(tiles)},
    }
    if days != SERVE_DAYS:
        rec["reduced"] = {"days": f"{days} of {SERVE_DAYS}"}
    emit(rec)
    if failures:
        raise AssertionError("serve: " + "; ".join(failures))
    return rec


def _sig(body):
    return (body.get("x_sha256"), body.get("solver_health"),
            body.get("quality"))


def serve_batch_run(device, workdir: str, operator: str, ny: int, nx: int,
                    keep_n: int):
    """One operator's ladder of phase serve_batch: two tiles over ONE
    pivot mask (seed 0) with observation seeds 0 and 1, their
    one-at-a-time baselines, then an AssimilationService with the JAX
    test's micro-window (1500 ms, max_batch 2) over cold, warm_noop and
    warm coalesced groups and a mixed cache-hit / miss group.  Every
    rendezvous round is recorded with its kernel launches; the inputs of
    the first coalesced kernel launch over ``keep_n`` pixels are kept."""
    import torch

    from kafka_tpu_torch.core import fused_gn, solvers
    from kafka_tpu_torch.engine import filter as filter_mod
    from kafka_tpu_torch.serve import (AdmissionPolicy, AssimilationService,
                                       TileSession, make_synthetic_tile,
                                       synthetic_dates)
    from kafka_tpu_torch.serve import batch as batching
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use

    dates = synthetic_dates(DEFAULT_BASE_DATE, 16, 2)
    d1, d2, d3, d4 = dates[0], dates[1], dates[2], dates[4]
    seeds = {"t0": 0, "t1": 1}

    def tile(tag, name):
        return TileSession(make_synthetic_tile(
            name, os.path.join(workdir, f"sb_{operator}_{tag}_{name}"),
            operator=operator, ny=ny, nx=nx, seed=seeds[name], mask_seed=0,
            device=device))

    base, solo_ms, solo_rounds = {}, {}, {}
    real_date = filter_mod.assimilate_date

    def solo_round(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = real_date(*args, **kwargs)
        _sync(device)
        solo_rounds[name].append((time.perf_counter() - t0) * 1e3)
        return out

    # A registry (and quality ledger) of their own, as the service gets:
    # a response's quality carries its tile's drift-sentinel state.
    with use(MetricsRegistry()), \
            patched((filter_mod, "assimilate_date", solo_round)):
        for name in seeds:
            solo_rounds[name] = []
            sess = tile("solo", name)
            for d in (d1, d2, d3) + ((d4,) if name == "t1" else ()):
                _sync(device)
                t0 = time.perf_counter()
                r = sess.serve(d)
                solo_ms[(name, d)] = (time.perf_counter() - t0) * 1e3
                base[(name, d)] = (_sig(r), r["served_from"])
    rounds, kept = [], {}
    real_batch = solvers.assimilate_date_batch
    real_solo = solvers.assimilate_date
    real_gn = fused_gn.fused_gn_raw
    real_rows = solvers.fused_update_rows

    def counted(fn, kind):
        def wrapped(*args, **kwargs):
            before = launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(device)
            after = launch_counts()
            iters = out[2].n_iterations
            rounds.append({
                "kind": kind, "ms": (time.perf_counter() - t0) * 1e3,
                "members": int(args[2].shape[0]) if kind == "coalesced"
                else 1,
                "iterations": [int(v) for v in torch.as_tensor(iters)
                               .reshape(-1).tolist()],
                "launches": {k: after[k] - before[k]
                             for k in ("fused_gn", "fused_update")}})
            return out
        return wrapped

    def keep_gn(*args, **kwargs):
        if "gn" not in kept and args[5].shape[1] == keep_n:
            kept["gn"] = dict(zip(ROW_ARGS, args))
            kept["gn"].update(block=args[12], corrupt=args[13],
                              scalar_n=kwargs.get("scalar_n"))
        return real_gn(*args, **kwargs)

    def keep_rows(*args):
        if "rows" not in kept and args[5].shape[1] == keep_n:
            kept["rows"] = dict(zip(UPDATE_ROW_NAMES, args))
        return real_rows(*args)

    got = {}
    with use(MetricsRegistry()) as reg, patched(
            (solvers, "assimilate_date_batch",
             counted(real_batch, "coalesced")),
            (solvers, "assimilate_date", counted(real_solo, "solo")),
            (fused_gn, "fused_gn_raw", keep_gn),
            (solvers, "fused_update_rows", keep_rows)):
        sessions = {name: tile("batch", name) for name in seeds}
        batching.aot_compile_buckets(sessions, batch_sizes=(1, 2))
        # The warm-up runs the programs on zeros: keep the ladder's.
        rounds.clear()
        kept.clear()
        svc = AssimilationService(
            sessions, os.path.join(workdir, f"sb_{operator}_root"),
            policy=AdmissionPolicy(max_queue_depth=64),
            batch_window_ms=SERVE_BATCH_WINDOW_MS, max_batch=2)
        svc.start()
        try:
            for group in (
                    [("t0", d1, "c0"), ("t1", d1, "c1")],
                    [("t0", d2, "n0"), ("t1", d2, "n1")],
                    [("t0", d3, "w0"), ("t1", d3, "w1")],
                    [("t0", d1, "m0"), ("t1", d4, "m1")]):
                for name, d, rid in group:
                    svc.submit({"tile": name, "date": d.isoformat(),
                                "request_id": rid})
                for name, d, rid in group:
                    got[rid] = (name, d, svc.result(rid, timeout_s=600))
        finally:
            svc.close()
        coalesced = reg.value("kafka_serve_batch_coalesced_total") or 0
        batch_launches = reg.value("kafka_serve_batch_launches_total") or 0
    return {"base": base, "solo_ms": solo_ms, "solo_rounds": solo_rounds,
            "got": got, "rounds": rounds,
            "kept": kept, "coalesced": int(coalesced),
            "batch_launches": int(batch_launches)}


def phase_serve_batch(device, workdir: str, ny: int = TILE, nx: int = TILE):
    """Coalesced rounds on the kernel paths at full width, for the
    two-stream operator (one fused_gn launch over both members' pixels
    per round) and the identity operator (one (2, 2) fused-update launch
    per iteration of the round): every coalesced member's x_sha256 (and
    solver health and quality) equal to its one-at-a-time baseline, at
    least 3 coalesced rounds each, and the launch counts per round.
    Returns the record and the inputs of the first coalesced fused_gn
    and fused-update launches (``serve_batch_kernels`` holds them to the
    plain versions)."""
    from kafka_tpu_torch.engine.state import make_pixel_gather
    from kafka_tpu_torch.testing.fixtures import make_pivot_mask

    gather = make_pixel_gather(make_pivot_mask(ny, nx, seed=0))
    n_pad, n_valid = gather.n_pad, gather.n_valid
    failures, runs, checks = [], {}, {}
    for operator in ("twostream", "identity"):
        t0 = time.perf_counter()
        run = serve_batch_run(device, workdir, operator, ny, nx, 2 * n_pad)
        seconds = time.perf_counter() - t0
        differ, stamps = [], {}
        for rid, (name, d, body) in run["got"].items():
            body = body or {}
            trace = body.get("trace") or {}
            stamps[rid] = {"served_from": body.get("served_from"),
                           "batch_size": trace.get("batch_size"),
                           "serve_batch_ms": (trace.get("phases") or {})
                           .get("serve_batch_ms")}
            if body.get("status") != "ok" or \
                    _sig(body) != run["base"][(name, d)][0]:
                differ.append(rid)
        want = {"c0": "cold", "c1": "cold", "n0": "warm_noop",
                "n1": "warm_noop", "w0": "warm", "w1": "warm",
                "m0": "cache", "m1": "warm"}
        wrong = {rid: s["served_from"] for rid, s in stamps.items()
                 if s["served_from"] != want[rid]}
        coal = [r for r in run["rounds"] if r["kind"] == "coalesced"]
        kernel = "fused_gn" if operator == "twostream" else "fused_update"
        per_round = [r["launches"][kernel] for r in coal]
        expect = [1 if operator == "twostream" else max(r["iterations"])
                  for r in coal]
        solo_rounds = [r for r in run["rounds"] if r["kind"] == "solo"]
        if differ:
            failures.append(f"{operator}: members differ from their "
                            f"one-at-a-time baselines: {differ}")
        if wrong:
            failures.append(f"{operator}: served_from {wrong}")
        if run["coalesced"] < 3:
            failures.append(f"{operator}: {run['coalesced']} coalesced "
                            "rounds")
        if per_round != expect:
            failures.append(f"{operator}: {kernel} launches per coalesced "
                            f"round {per_round}, expected {expect}")
        round_ms = [r["ms"] for r in coal]
        # The cold and warm groups' rounds against the same dates' solo
        # rounds of the two tiles (the baselines ran them in this order).
        paired = [a + b for a, b in zip(run["solo_rounds"]["t0"],
                                        run["solo_rounds"]["t1"])]
        runs[operator] = {
            "seconds": seconds, "members": stamps,
            "differing_from_baseline": differ,
            "coalesced_rounds": run["coalesced"],
            "rendezvous_launches": run["batch_launches"],
            "launches_per_coalesced_round": per_round,
            "iterations_per_coalesced_round": [r["iterations"]
                                               for r in coal],
            "coalesced_round_ms": round_ms,
            "solo_pair_round_ms": paired[:len(round_ms)],
            "solo_rounds": len(solo_rounds),
            "solo_round_ms": [r["ms"] for r in solo_rounds],
            "solo_serve_ms": {f"{n}@{d.date()}": v for (n, d), v
                              in run["solo_ms"].items()},
            "launches": {k: sum(r["launches"][k] for r in run["rounds"])
                         for k in ("fused_gn", "fused_update")},
        }
        checks[operator] = run["kept"]
        del run
    rec = {"phase": "serve_batch", "tile": [ny, nx], "n_pad": n_pad,
           "n_valid": n_valid,
           "batch_window_ms": SERVE_BATCH_WINDOW_MS, "max_batch": 2,
           "runs": runs}
    emit(rec)
    if failures:
        raise AssertionError("serve_batch: " + "; ".join(failures))
    return rec, {"gn": checks["twostream"].get("gn"),
                 "rows": checks["identity"].get("rows")}


def serve_batch_kernels(device, rec: dict, kept: dict):
    """The kept coalesced launches of phase serve_batch against their
    plain versions: fused_gn by phase kernel's float64 rule, and each
    member's slice equal bit for bit to a launch of the member alone;
    the (2, 2) fused update by phase kernel_update's rule, 0 pixels
    differing.  Returns the two kernel records."""
    from kafka_tpu_torch.core import fused_gn

    n_pad = rec["n_pad"]
    failures = []
    gn_rows, upd_rows = kept["gn"], kept["rows"]
    # The kept coalesced fused_gn launch: phase kernel's rule, and each
    # member's slice against a launch of the member alone.
    gn_rec = None
    if gn_rows is None:
        failures.append("no coalesced fused_gn launch kept")
    else:
        # The kernel is built with FMA contraction, so it cannot equal
        # the plain version bit for bit; its trips, verdicts, geometry
        # and finiteness are gated, and the float64 quantile rule is
        # recorded, not gated: the serve tile's first date is
        # ill-conditioned in float32 on most pixels, both float32
        # versions sit ~1e-4 from float64 at the median, and which of
        # them lands nearer is the data's (the record keeps
        # kernel_vs_f64, plain_vs_f64 and plain_ulp_vs_plain).  The
        # coalescing claim is gated below: each member's slice equals a
        # launch of the member alone, bit for bit.
        gn_rec = phase_kernel(device, "serve_batch_coalesced", gn_rows,
                              hold_f64_quantiles=False)
        both = fused_gn.fused_gn_raw(**gn_rows)
        member_differ = []
        for m in range(2):
            sl = slice(m * n_pad, (m + 1) * n_pad)
            one = {**gn_rows, **{k: gn_rows[k][:, sl].contiguous()
                                 for k in ROW_INPUTS}}
            if gn_rows.get("corrupt") is not None:
                one["corrupt"] = gn_rows["corrupt"][sl].contiguous()
            alone = fused_gn.fused_gn_raw(**one)
            member_differ.append(sum(
                int((~same_or_both_nan(a[:, sl], b)).sum())
                for a, b in zip(both, alone)))
        gn_rec["member_entries_differing_from_solo_launch"] = member_differ
        if any(member_differ):
            failures.append(f"fused_gn member slices differ from solo "
                            f"launches: {member_differ}")
    upd_rec = None
    if upd_rows is None:
        failures.append("no coalesced fused-update launch kept")
    else:
        upd_rec = phase_kernel_update(
            device, "serve_batch_coalesced (2, 2)", upd_rows)
        if any(upd_rec["pixels_differing_from_plain"].values()):
            failures.append("fused update (serve_batch): pixels differ "
                            "from the plain version: "
                            f"{upd_rec['pixels_differing_from_plain']}")
    emit({"phase": "serve_batch_kernels",
          "fused_gn_member_entries_differing_from_solo_launch":
              None if gn_rec is None
              else gn_rec["member_entries_differing_from_solo_launch"],
          "fused_gn_f64_quantile_rule":
              None if gn_rec is None else gn_rec["f64_quantile_rule"],
          "fused_update_pixels_differing_from_plain":
              None if upd_rec is None
              else upd_rec["pixels_differing_from_plain"]})
    if failures:
        raise AssertionError("serve_batch: " + "; ".join(failures))
    return gn_rec, upd_rec


def kernel_entry(name, route, source, replaces, launches, path, rec,
                 err_key="x", library_ms=None, **extra) -> dict:
    """One entry of the ``kernels`` line from a kernel phase record."""
    err = rec["max_abs_err"]
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": err[err_key] if isinstance(err, dict) else err,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": library_ms, "n_pix": rec["n_pix"], **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kafka_tpu_torch.core import _build, fused_gn, fused_update, \
        solve_rows

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build_all(_build.KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    emit({
        "phase": "device", "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "nvcc_flags": list(_build.NVCC_FLAGS),
        "source_flags": {k: list(v) for k, v in _build.SOURCE_FLAGS.items()},
        "ptxas": {nm: [ln.strip() for ln in
                       _build.BUILDS[nm]["log"].splitlines()
                       if "registers" in ln or "spill" in ln]
                  for nm in _build.KERNEL_SOURCES},
        "attributes": {
            "fused_gn": fused_gn.kernel_attributes(),
            **{f"fused_update_{p}x{nb}": fused_update.kernel_attributes(p, nb)
               for p, nb in fused_update.INSTANCES},
            **{f"solve_rows_{p}": solve_rows.kernel_attributes(p, 2 ** 19)
               for p in solve_rows.INSTANCES},
        },
    })
    phase_reference(device)
    ref_s2 = phase_reference_s2(device)
    main_rec, kept = phase_main(device)
    tile = phase_kernel(device, "main_path_date", kept)
    small = phase_kernel(device, "2^19", problem_rows(2 ** 19, device),
                         plain_reps=3)
    for label, n_pix, tol in GROUP_CASES:
        rows, observed = group_case_rows(n_pix, tol, device)
        phase_kernel(device, label, rows, observed=observed)
    phase_faults(device, kept)
    tip_rows = tip_update_rows(kept)
    del kept
    s2_rec, kept_s2, s2_date_args = phase_main_s2(device)
    upd = phase_kernel_update(device, "main_s2_date", kept_s2)
    upd_small = phase_kernel_update(device, "2^19",
                                    prosail_update_rows(2 ** 19, device))
    phase_faults_update(device, kept_s2)
    s2_a, s2_b = normal_equation_rows(kept_s2)
    del kept_s2
    solve_s2 = phase_kernel_solve(device, "main_s2_date", s2_a, s2_b)
    planted_a, planted = plant_solve_faults(s2_a, 10)
    solve_recs = [solve_s2, phase_kernel_solve(
        device, "main_s2_date planted", planted_a, s2_b, planted=planted)]
    del s2_a, s2_b, planted_a
    solve_recs.append(phase_kernel_solve(device, "main_tip_date",
                                         *normal_equation_rows(tip_rows)))
    upd_recs = {(10, 10): upd, (7, 2): phase_kernel_update(
        device, "main_tip_date (7, 2)",
        {**tip_rows, "esc_row": torch.zeros_like(tip_rows["y"][:1])})}
    del tip_rows
    for label, p, n in SOLVE_CASES:
        solve_recs.append(phase_kernel_solve(
            device, label, *spd_rows(p, n, device, seed=1000 * p + 19)))
    routes_run = {r: sum(rec["route"] == r for rec in solve_recs)
                  for r in solve_rows.ROUTES}
    if not all(routes_run.values()):
        raise AssertionError(f"kernel_solve: a route never ran: {routes_run}")
    phase_profile(device, main_rec["n_pad"])
    phase_profile_s2(device, s2_date_args)
    del s2_date_args
    joint_rec, kept_joint = phase_main_joint(device)
    for inst, date in JOINT_KEEP.items():
        rows = kept_joint.pop(inst)
        upd_recs[inst] = phase_kernel_update(
            device, f"main_joint_date_{date} {inst}", rows)
        phase_faults_update(device, rows)
        del rows
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_cli")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        cli_rec, cli_kept = phase_cli(device, workdir)
        smooth_rec = phase_smooth(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cli_kernel = phase_kernel(device, "cli_fused_date", cli_kept)
    del cli_kept
    os.makedirs(workdir)
    try:
        wcm_rec, wcm_kept = phase_cli_wcm(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    upd_recs[(2, 2)] = phase_kernel_update(device, "cli_wcm_date (2, 2)",
                                           wcm_kept)
    phase_faults_update(device, wcm_kept)
    del wcm_kept
    os.makedirs(workdir)
    try:
        s2_cli_rec, s2_cli_kept = phase_cli_s2(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    s2_cli_upd = phase_kernel_update(device, "cli_s2_date (10, 10)",
                                     s2_cli_kept)
    del s2_cli_kept
    if any(s2_cli_upd["pixels_differing_from_plain"].values()):
        raise AssertionError("kernel_update (cli_s2_date): pixels differ "
                             "from the plain version: "
                             f"{s2_cli_upd['pixels_differing_from_plain']}")
    os.makedirs(workdir)
    try:
        modis_rec, modis_kept = phase_cli_modis(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    modis_kernel = phase_kernel(device, "cli_modis_date", modis_kept)
    del modis_kept
    os.makedirs(workdir)
    try:
        phase_cli_mod09(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    pp_rec, pp_kept = phase_per_pixel(device)
    pp_upd = phase_kernel_update(device, "per_pixel_date (7, 2)", pp_kept)
    del pp_kept
    bs_rec, bs_kept = phase_band_seq(device)
    upd_recs[(7, 1)] = phase_kernel_update(device, "band_seq_date (7, 1)",
                                           bs_kept)
    phase_faults_update(device, bs_kept)
    del bs_kept
    fleet_rec, fleet_kept = phase_band_seq_fleet(device)
    fleet_upd = {}
    for inst in ((2, 1), (10, 1), (11, 1)):
        fleet_upd[inst] = phase_kernel_update(
            device, f"band_seq_fleet_date {inst}", fleet_kept.pop(inst))
        upd_recs[inst] = phase_kernel_update(
            device, f"2^19 {inst}",
            seeded_update_rows(*inst, 2 ** 19, device, seed=100 * inst[0]))
    for label, r in (("per_pixel", pp_upd), ("band_seq", upd_recs[(7, 1)]),
                     *((f"band_seq_fleet {inst}", r)
                       for inst, r in fleet_upd.items())):
        if any(r["pixels_differing_from_plain"].values()):
            raise AssertionError(
                f"kernel_update ({label}): pixels differ from the plain "
                f"version: {r['pixels_differing_from_plain']}")
    hess_rec = phase_hessian(device)
    os.makedirs(workdir)
    try:
        serve_rec = phase_serve(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        batch_rec, batch_kept = phase_serve_batch(device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    batch_gn, batch_upd = serve_batch_kernels(device, batch_rec, batch_kept)
    del batch_kept
    path_launches = {
        (10, 10): s2_rec["kernel_launches"]["fused_update"],
        (7, 2): ref_s2["tip_rowloop"]["launches"],
        (2, 2): wcm_rec["kernel_launches"]["fused_update_by_instance"]
        ["2x2"],
        (11, 10): joint_rec["kernel_launches"]["fused_update_by_instance"]
        ["11x10"],
        (11, 2): joint_rec["kernel_launches"]["fused_update_by_instance"]
        ["11x2"],
        (7, 1): bs_rec["kernel_launches"]["fused_update_by_instance"]["7x1"],
        **{inst: fleet_rec["runs"][name]["kernel_launches"]["fused_update"]
           for inst, name in (((2, 1), "wcm"), ((10, 1), "s2"),
                              ((11, 1), "joint"))}}
    update_instances = {}
    for inst in fused_update.INSTANCES:
        attr = fused_update.kernel_attributes(*inst)
        r = upd_recs[inst]
        update_instances[f"{inst[0]}x{inst[1]}"] = {
            "path": UPDATE_PATHS[inst], "launches": path_launches[inst],
            "case": r["case"], "n_pix": r["n_pix"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"]["x"],
            "registers": attr["registers"],
            "spill_bytes": attr["local_bytes"]}
        if inst in fleet_upd:
            r = fleet_upd[inst]
            update_instances[f"{inst[0]}x{inst[1]}"]["at_path_date"] = {
                **{k: r[k] for k in ("case", "n_pix", "ms", "plain_ms",
                                     "bound_ms")},
                "pixels_differing_from_plain":
                    r["pixels_differing_from_plain"]}
    print(smi, flush=True)

    def at(rec):
        return {k: rec[k] for k in ("n_pix", "max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")}

    def solve_at(rec):
        geo = rec["geometry"]
        return {**at(rec), "fill_route": rec["route"], **{k: rec[k] for k in (
            "p", "share_of_bound", "library_ms",
            "pixels_differing_from_plain")},
            "geometry": {k: geo[k] for k in (
                "tile", "stages", "grid", "consumer_warps", "threads",
                "smem_bytes", "registers")}}

    emit({"kernels": [
        kernel_entry(
            "fused_gn", "cuda", "kafka_tpu_torch/csrc/fused_gn.cu",
            KERNEL_REPLACES, main_rec["kernel_launches"],
            "phase main: KalmanFilter.run, MODIS tile", tile,
            max_abs_err_vs_f64=tile["kernel_vs_f64"]["x"]["max"],
            trips_per_group=tile["trips_per_group"],
            geometry=tile["geometry"], **{"at_2^19": at(small)},
            paths={"main": main_rec["kernel_launches"],
                   "cli": cli_rec["fused_gn_launches"],
                   "cli_modis": modis_rec["kernel_launches"]["fused_gn"],
                   "hessian": hess_rec["kernel_launches"]["fused_gn"],
                   "smooth": smooth_rec["kernel_launches"]["fused_gn"],
                   "serve": serve_rec["kernel_launches"]["fused_gn"],
                   "serve_batch": batch_rec["runs"]["twostream"]
                   ["launches"]["fused_gn"]},
            at_serve_batch_round={
                **at(batch_gn),
                "path": "phase serve_batch: a coalesced round of two "
                        "two-stream tiles, one launch over both members",
                "max_abs_err_vs_f64":
                    batch_gn["kernel_vs_f64"]["x"]["max"],
                "member_entries_differing_from_solo_launch":
                    batch_gn["member_entries_differing_from_solo_launch"],
                "trips_per_group": batch_gn["trips_per_group"]},
            at_cli_modis_date={
                **at(modis_kernel),
                "path": "phase cli_modis: run_modis over the MCD43 tile",
                "max_abs_err_vs_f64":
                    modis_kernel["kernel_vs_f64"]["x"]["max"],
                "trips_per_group": modis_kernel["trips_per_group"]},
            at_cli_fused_date={
                **at(cli_kernel),
                "path": "phase cli: run_synthetic --operator twostream, "
                        "MODIS tile, a date inside a fused block",
                "max_abs_err_vs_f64":
                    cli_kernel["kernel_vs_f64"]["x"]["max"],
                "trips_per_group": cli_kernel["trips_per_group"]}),
        kernel_entry(
            "fused_update", "cuda", "kafka_tpu_torch/csrc/fused_update.cu",
            UPDATE_REPLACES, s2_rec["kernel_launches"]["fused_update"],
            "phase main_s2: KalmanFilter.run, S2 sub-tile", upd,
            max_abs_err_vs_f64=upd["kernel_vs_f64"]["x"]["max"],
            **{"at_2^19": at(upd_small)},
            paths={"main_s2": s2_rec["kernel_launches"]["fused_update"],
                   "main_joint": joint_rec["kernel_launches"]
                   ["fused_update"],
                   "cli_wcm": wcm_rec["kernel_launches"]["fused_update"],
                   "cli_s2": s2_cli_rec["kernel_launches"]["fused_update"],
                   "per_pixel": pp_rec["kernel_launches"]["fused_update"],
                   "band_seq": bs_rec["kernel_launches"]["fused_update"],
                   **{f"band_seq_fleet_{name}": r["kernel_launches"]
                      ["fused_update"]
                      for name, r in fleet_rec["runs"].items()},
                   "smooth": smooth_rec["kernel_launches"]["fused_update"],
                   "serve_batch": batch_rec["runs"]["identity"]
                   ["launches"]["fused_update"]},
            at_serve_batch_round={
                **at(batch_upd),
                "path": "phase serve_batch: a coalesced round of two "
                        "identity tiles, (2, 2), one launch per iteration",
                "pixels_differing_from_plain":
                    batch_upd["pixels_differing_from_plain"]},
            at_per_pixel_date={
                **at(pp_upd),
                "path": "phase per_pixel: per_pixel_convergence, MODIS "
                        "tile, (7, 2)",
                "pixels_differing_from_plain":
                    pp_upd["pixels_differing_from_plain"]},
            at_cli_s2_date={
                **at(s2_cli_upd),
                "path": "phase cli_s2: run_s2 over four 1098 x 1098 chunks",
                "pixels_differing_from_plain":
                    s2_cli_upd["pixels_differing_from_plain"]},
            instances=update_instances),
        kernel_entry(
            "solve_rows", "cuda", "kafka_tpu_torch/csrc/solve_rows.cu",
            SOLVE_REPLACES, solve_s2["launches_on_path"],
            "phase kernel_solve: solve_spd_packed_kernel on the S2 date's "
            "normal equations", solve_s2,
            library_ms=solve_s2["library_ms"],
            max_abs_err_vs_f64=solve_s2["x_err_vs_f64"]["kernel"]["max"],
            **{k: v for k, v in solve_at(solve_s2).items() if k not in (
                "n_pix", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
            routes_run=routes_run,
            cases={rec["case"]: solve_at(rec) for rec in solve_recs[1:]}),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
