"""GPU smoke run of the PyTorch/CUDA port (kafka_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero without one, and without the
kafka_tpu_torch package beside it.  Imports neither JAX nor kafka_tpu.
The five kernels (csrc/fused_gn.cu, fused_update.cu with its nine
(p, bands) instances, solve_rows.cu, prosail_rows.cu, gp_rows.cu) are
built at the start, one nvcc each, in parallel.  Phases, each printing
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
9b. prosail_rows — the PROSAIL row kernel (the row loop's
   linearisation) against its plain version, the eager torch.func
   linearisation, at 65,536 and 1,205,760 px of states with 1/16 of the
   pixels on each bound of every parameter, under the benchmark's four
   S2 geometries (0-d angles) and per-pixel angles: both held to the
   plain version in float64 (``prosail_rows_case``); timed beside its
   bound; then one chunk date of make_prosail_problem through
   assimilate_date on the kernel and the torch.func route: trips and
   verdicts equal, x within the torch.func route's own one-ulp spread
   (``prosail_rows_date``).  Phase main_s2 gates one launch per trip;
9c. main_gp — KalmanFilter.run over one 2196 x 2196 chunk of the
   benchmark's s2_gp_bank.july_chunks cell on its four July dates, set
   up by the cell's own scenario (eight geometries' banks fitted by
   fit_gp, each date's picked by geometry_bank_aux_builder) and run as
   its harness runs a job: one gp_rows launch, one fused-update launch,
   one route-counter ``kernel`` tick and one kafka_gp_rows_launches_total
   tick a Gauss-Newton trip; the sampled outputs within the cell's
   limits of the float64 reference filter; the banks unchanged through
   save_bank_npz / load_bank_npz (``phase_main_gp``);
9d. gp_rows — the GP emulator bank's row kernel (the row loop's
   linearisation of GPBankOperator) against its plain version, the
   closed form in float32, at 65,536 and 4,822,528 px of the same states
   as 9b, on phase main_gp's eight banks: both held to the closed form
   in float64 (``gp_rows_case``); timed beside
   its bound; then one date through assimilate_date on the kernel and
   the torch.func route: trips and verdicts equal, x within
   GP_DATE_X_ATOL, one launch and one route-counter tick a trip
   (``gp_rows_date``);
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
   GeoTIFF outside the output folder: 5 windows of one acquisition,
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
   rasters, 4 daily dates from 2017-06-01) under phase main's land mask
   in four 1200 x 1200 chunks: the 21-parameter Ross-Li kernel-weight
   state on the dense large-p solve (torch.linalg Cholesky) under the
   exact information filter.  Gates: 4 chunks and 16 chunk-dates run, 0
   hand-kernel launches, every GeoTIFF present and finite on the mask,
   the median b1_iso of the last window within 0.02 of the truth, a
   restart that skips all 4 chunks and writes nothing, the first chunk
   run alone unfused equal to the fused run bit for bit; the dense
   update split into assembly, Cholesky and triangular solves on a kept
   chunk date, and the propagation.  Reduced: 4 of the config's 30
   days (8 until the fleet phases were added), 1200 x 1200 chunks
   instead of 256 x 256;
18. per_pixel — phase main's tile run (its first window, 2 dates) with
   per_pixel_convergence: (7, 2) fused-update launches equal the
   iterations, the converged fraction and its gauge equal the frozen
   mask's mean, held to the plain loop (use_pallas False) as phase
   reference holds its runs; the first date again in the engine's
   default linearisation blocks, its wall recorded; then kernel_update
   on a kept iteration's inputs (0 pixels may differ);
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
   plain versions: the fused update bit for bit, fused_gn as phase
   kernel holds it but under the float64 rule of a date float32 cannot
   resolve (``held_within_ulp_spread``: at each quantile at most the
   larger of ERR_MARGIN times the float32 plain version's error and
   that error plus the plain version's own one-ulp spread; on the serve
   tile's first date a one-ulp move of x_f moves the float32 plain
   version further than it lies from float64, and the JAX kernel lands
   where the port's plain version does, ROADMAP Queue 3 item 12), each
   member's slice equal to its solo launch, each member's float64
   figures recorded;
25. mesh (right after main_s2) — phase main's tile and phase main_s2's
   sub-tile again on a pixel mesh of MESH_SHARDS shards on the one card
   (``KalmanFilter(mesh=...)``, one thread per shard, the convergence
   norm the one collective), each held date by date to its unsharded
   run: every state and sigma raster within 2e-4, the final P^-1 within
   rtol 2e-4 / atol 2e-2 (the JAX mesh tests' budgets), QA equal;
   fused_gn launches = shards x dates and the tile the same bits,
   (10, 10) launches = shards x iterations; then the tile on
   MESH_SPLIT_SHARDS shards, which split some of the unsharded 2,048-px
   groups: fused_gn launches = (shards + 1) x dates (the straddling
   groups launched whole, once a date) and the same bits again;
   per-date walls beside the unsharded ones and peak device bytes; then
   MESH_CAPTURES one-second ``/profilez`` captures while this thread
   solves the tile's date on MESH_SHARDS shards in a loop: every capture
   holds fused_gn launches of every shard thread, and every tracing
   switch was made on this (the caller's) thread, after the join;
26. distributed (inside phase cli_modis's directory, after it) —
   ``run_modis_distributed`` over the MCD43 tile in 1200 x 1200 chunks,
   once in this process, then as two gloo ranks in child processes on
   the one card: each rank ran 2 of the 4 chunks, each rank's
   all_reduce of the counts equals the one-process run's, every .done
   marker, every raster bit-identical; each rank's peak device bytes;
27. queue (after distributed) — ``run_synthetic --chunk-size 1200`` over
   the tile static in this process (fused_gn launches = chunk-dates),
   then ``--queue --num-workers 2`` in
   a child process with one worker SIGKILLed while it holds a lease: the
   survivor reclaims it, queue_status ends all done with no lease, the
   rasters equal the static run's bit for bit; then one chunk through
   the chunk_worker subprocess, rc 0 and its rasters equal phase
   distributed's;
28. device_plane — ``run_synthetic`` over phase cli's tile and
   mask (4 windows, no checkpoint) plain and with ``--telemetry-dir``,
   ``--http-port`` and ``--profile-windows 2`` while a thread scrapes
   the live endpoint: the same bits, device reads equal to the
   dispatches, the engine's fused_gn launches equal to the dates (the
   probe's own launches taken out), the ``torch.profiler`` capture's kernel table counting
   the captured fused_gn launches at a time per launch near phase
   kernel's, the roofline/throughput/memory gauges, every device-plane
   metric name on ``/metrics``; the health probe on the idle card
   (healthy; fused_gn launches = the probe's solves) and in a fresh
   process (healthy on its first reading); a real CUDA OOM
   under a flight recorder (forensics in the crash dump) and a fused_gn
   launch after it held to its plain version; a ``/profilez`` capture
   asked on a handler thread, its tracing switched on and off by this
   (the launching) thread, holding this thread's kernels; COPY_CAPTURES
   more beside a thread that launches no package kernel and copies a
   tile's state to the card and back (a request's resume and dump): how
   many lost that thread's copies, recorded; ``kafka_serve`` with the
   fleet-plane flags answering phase serve's tile0 cold, cache and warm
   requests with phase serve's digests, nothing shed;
29. batch_modes (after serve_batch) — the coalesced round under
   per-pixel convergence at full width: the two serve tiles' first
   dates (pivot masks of 1,229,279 and 1,254,911 px, the smaller padded
   with unobserved pixels to the larger's 1,254,912), each solo and then
   as one ``assimilate_date_batch`` round: every member the bits of its
   solo solve, the round's (7, 2) launches equal to the larger member's
   step count, no plain-version call; then the dense p = 21 path on two
   seeded members of 2^20 px: the same bits, one stacked dense solve a
   step, and whether ``cholesky_ex`` and the triangular solves each keep
   a member's bits over the stacked matrices;
30. contracts (after device_plane) — every registered device program
   (``kafka_tpu_torch.analysis.programs``, 16) at its canonical shape,
   its census (``analysis.trace_program``: ATen operators, output dtypes,
   kernel nodes, host reads, collectives) taken on the CPU and on the
   card, the card's counted run under
   ``torch.cuda.set_sync_debug_mode("warn")``: the censuses equal, the
   synchronising warnings equal to the host reads, the launch counters
   moved by exactly the kernel nodes (no plain version on CUDA tensors),
   no checker finding, every tensor where the census placed it, no
   host-to-device copy in any program (its constants come from the
   per-device cache, ROADMAP Queue 3 item 10h); the flagship date
   program at the tile's 4,608,000 px with the census of
   256 px; each fingerprint beside the checked-in manifest's (printed);
31. route (after contracts) — the fleet: three ``kafka_serve`` replica
   processes (``route_replica``) at phase serve's width behind ``python -m
   kafka_tpu_torch.cli.kafka_route``, phase serve's requests for both
   tiles through the router's inbox, the tile0 owner SIGKILLed after its
   first tile0 answer: every request answered once, ok, with phase
   serve's digest, the re-routed ones resumed warm by a survivor; the
   victim alone flagged dead within TTL + refresh + one poll; the nine
   ``kafka_route_*`` families on the router's /metrics; the survivors
   on fused_gn, never its plain version; front-door latency, failover
   time, start-up seconds and peak device bytes per replica;
32. operator_tools (after route) — the port's operator tools
   (``kafka_tpu_torch.tools``), which run where there is no JAX: its
   loadgen (``run_load`` over ``_Target(root=...)`` with the live
   ``/metrics`` scrape) drives a full-width two-stream ``kafka_serve``
   (tile0 of phase serve's grid, fresh checkpoints) with 8 requests at
   concurrency 2: every request ok, every digest phase serve's, the
   fused_gn launches equal to the date solves; ``loadgen --synthetic``,
   ``--concurrency-sweep 1,4`` and ``--fleet 2`` (20 x 20 identity
   tiles): no error row, fused_update launched at (2, 2) only, the
   sweep's launches per round and members per launch; and the six
   report tools, each run as ``python -m kafka_tpu_torch.tools.<name>
   --json`` right after phases queue, device_plane and route over the
   directories they leave: rc 0, the tool's keys, no JAX or kafka_tpu
   module in any of their processes (``report_processes_without_jax``),
   and device_report's ``fused_gn_kernel`` row counting the launches
   phase device_plane's ``--profile-windows`` capture held;
33. lint (after operator_tools) — the port's source lints over this
   checkout, ``python -m kafka_tpu_torch.tools.kafkalint --json`` and
   ``python -m kafka_tpu_torch.tools.check_metric_names`` (through
   ``tool_child``): rc 0 from both, no finding, every baseline entry
   matched, no JAX, ``kafka_tpu`` or top-level ``tools`` module in
   either process; the finding, baseline and metric-name counts and the
   seconds;
34. bench (beside lint: its child runs while phase lint does) — the
   port's bench tools in a fresh process (``bench_child``) that imports
   no JAX: the bench's row functions at the JAX bench's widths (the
   health probe, the 16,384-px oracle, the TIP date solve at 16,384 and
   2^19 px on the plain loop and at 2^19 px through ``fused_update``
   (7, 2) and ``fused_gn``, the Barrax e2e at 204 x 235 px and 3 dates
   through ``fused_update`` (10, 10), the smoother),
   ``assemble_result`` (the contracts snapshot taken from phase
   contracts' census), ``bench_compare`` of the artifact against
   itself, ``bench_history`` over it, ``roofline --n 524288`` and
   ``measure_baseline barrax`` and ``oracle``.  Depth cut to fit
   (BENCH_SLOPE, one e2e pass, one oracle rep), widths not.  Gates: the
   artifact's keys the JAX bench's (BENCH_KEYS), both kernel rows
   finite, fused_gn and fused_update (7, 2) and (10, 10) launched in the
   phase, every roofline component at most BENCH_SHARE_LIMIT of its
   bound, the roofline's kernel bounds equal to this script's
   ``bound()`` of the same launches, every tool's exit code 0, no JAX
   module, and the phase within BENCH_LIMIT_S.

Then the card's name and power limit as nvidia-smi gives them, the
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

_T0 = time.perf_counter()

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
#: phase kernel's float64 rules by name: the record key of each one's
#: failures (``held_quantiles``, ``held_within_ulp_spread``).
F64_RULES = {"margin": "f64_quantile_rule",
             "ulp_spread": "f64_ulp_spread_rule"}
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
PROSAIL_ROWS_REPLACES = ("none: the JAX package leaves the PROSAIL "
                         "linearisation to jax.jacfwd under XLA "
                         "(kafka_tpu/obsops/protocol.py:101)")
GP_ROWS_REPLACES = ("none: the JAX package leaves the GP bank's "
                    "linearisation to jax.jacfwd under XLA "
                    "(kafka_tpu/obsops/protocol.py:101)")
#: the benchmark's Sentinel-2 acquisition geometries (sza, vza, raa in
#: degrees; benchmark/workloads/s2_prosail.july_chunks.json).
S2_GEOMETRIES = ((24.6, 5.2, -48.0), (25.1, 8.9, 62.5), (25.7, 3.1, -55.0),
                 (26.2, 7.4, 70.0))
#: pixel counts the PROSAIL row kernel is held to its plain version at: a
#: quarter of the engine's block and one 1098 x 1098 chunk's padded width.
PROSAIL_ROWS_SIZES = (65536, 1205760)
#: the floors of its float64 rule (``prosail_rows_case``): the value's
#: absolute error and each Jacobian entry's, of its column's largest
#: magnitude; and the chunk date's x budget against the torch.func route.
PROSAIL_H0_ATOL = 2e-6
PROSAIL_JAC_RTOL = 1e-4
PROSAIL_DATE_X_ATOL = 1e-5
#: bytes a pixel moves once (reads x, 10 floats; writes h0 and the
#: Jacobian rows, 110) and float32 operations a pixel needs: one per IEEE
#: operation, comparison or select and one per exp, log, sqrt, pow, cos,
#: sin or tan of csrc/prosail_rows.cu, 19,286 in its dual-number
#: operations (counted on a host build with a counter in each) and 760
#: in its scalar code (counted from the source).
PROSAIL_ROWS_BYTES_PER_PX = 4 * (10 + 110)
PROSAIL_ROWS_OPS_PER_PX = 20046
#: the benchmark cell whose scenario fits the GP emulator banks
#: (``benchmark/configs/s2_gp_bank_chunk.json``: one bank a geometry of
#: its grid) and whose one chunk phase main_gp runs; its seed, as large
#: as a benchmark run's.
GP_CELL = "s2_gp_bank.july_chunks"
GP_SEED = 2 ** 31 + 22
#: pixel counts the GP row kernel is held to its plain version at: a
#: quarter of the engine's block and one 2196 x 2196 chunk's padded width.
GP_ROWS_SIZES = (65536, 4822528)
#: the floors of its float64 rule (``gp_rows_case``): the value's absolute
#: error, a two-hundredth of the smallest observation sigma of the cell
#: (its floor, 1e-3), and each Jacobian entry's, of its column's largest
#: magnitude, as PROSAIL's; the pixel blocks of its plain versions; the
#: date's size, blocks and x budget against the torch.func route (whose
#: (block, p, m, k) tangents bound its block).
GP_H0_ATOL = 5e-6
GP_JAC_RTOL = 1e-4
GP_F64_BLOCK = 65536
GP_DATE_PX = 16384
GP_DATE_BLOCK = 2048
GP_DATE_X_ATOL = 1e-5

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
#: over CLI_DAYS days on a 4-day grid: 5 one-acquisition windows, the
#: fewest with two fused blocks; the smoke's time limit) and the
#: fused_gn call kept for the kernel phase (0-based date; date 0 is the
#: unfused head window, dates 1 and 2 the first fused block).
CLI_DAYS = 20
CLI_ARGS = ("--operator", "twostream", "--days", str(CLI_DAYS), "--step",
            "4", "--obs-every", "4", "--checkpoint")
CLI_KEEP_DATE = 2
CLI_RESUME_WINDOWS = 3
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
#: are kept on this 0-based date of the run.  Reduced from 8 dates to
#: 4 to keep the whole smoke inside its time limit as phases were added.
CLI_MOD09_DATES = 4
CLI_MOD09_END = datetime.datetime(2017, 6, 5)
CLI_MOD09_CHUNK = 1200
CLI_MOD09_KEEP_DATE = 1
#: the median b1_iso of the last window within this of the truth (the
#: JAX driver test's budget, tests/test_drivers.py:228-231).
MOD09_ISO_GATE = 0.02
#: phase per_pixel keeps the (7, 2) fused update's inputs on this date;
#: its runs cover phase main's first window (2 dates; all 3 windows until
#: phase bench needed the smoke's time: ~4.8 s a date for the per-pixel
#: and the plain run together).
PER_PIXEL_KEEP_DATE = 1
PER_PIXEL_GRID_DAYS = TIP_GRID_DAYS[:2]
PER_PIXEL_OBS_DAYS = TIP_OBS_DAYS[:2]
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
#: phase mesh: the shards of the pixel mesh (all on the one card), the
#: shards of its split-group tile run, and the JAX package's mesh
#: budgets: every output raster, state and sigma
#: (tests/test_engine_mesh.py:49-54), and P^-1 (tests/test_shard.py:58-62).
MESH_SHARDS = 2
MESH_SPLIT_SHARDS = 4
MESH_X_ATOL = 2e-4
MESH_P_RTOL, MESH_P_ATOL = 2e-4, 2e-2
#: phases distributed and queue: chunks of CHUNK_PX x CHUNK_PX (4 of the
#: tile), the queue run's --days (2 of the driver's 4 default windows),
#: its lease TTL and every child process's time limit.
CHUNK_PX = 1200
QUEUE_DAYS = 8
QUEUE_TTL_S = 5.0
CHILD_TIMEOUT_S = 300


def emit(obj) -> None:
    """Print one JSON line; a phase record gains ``smoke_s``, the seconds
    since this module was imported (where the time of the run goes)."""
    if "phase" in obj:
        obj = dict(obj, smoke_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _mem():
    """The port's device-memory funnel (``telemetry.device``): peak
    windows, allocated and card bytes."""
    from kafka_tpu_torch.telemetry import device as device_tel

    return device_tel


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
                 f64_rule: str = "margin", outputs=None) -> dict:
    """The CUDA kernel against its plain version on ``rows`` (float32,
    float64, and float32 on x_f moved by one ulp up and down), both
    timed, and the function's bound.  Both float64 rules are recorded
    (``f64_quantile_rule``, ``f64_ulp_spread_rule``: the failures of
    each); ``f64_rule`` names the one gated (F64_RULES).  ``outputs``, a
    dict, receives the raw outputs (``kern``, ``plain``, ``ref``,
    ``nudged``)."""
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
    if outputs is not None:
        outputs.update(kern=kern, plain=plain, ref=ref, nudged=nudged)
    finite = all(bool(torch.isfinite(t).all()) for t in kern)
    vs_plain = summary(pixel_errors(kern, plain, block))
    vs_ref = summary(pixel_errors(kern, ref, block))
    plain_vs_ref = summary(pixel_errors(plain, ref, block))
    ulp_vs_plain = summary(pixel_errors(plain_ulp, plain, block))
    ulp_down_vs_plain = summary(pixel_errors(nudged[1], plain, block))
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
        "plain_ulp_down_vs_plain": ulp_down_vs_plain,
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
    rec["f64_ulp_spread_rule"] = held_within_ulp_spread(
        vs_ref, plain_vs_ref, ulp_spread(ulp_vs_plain, ulp_down_vs_plain),
        ("x", "A", "diag"))
    emit(rec)
    failures = list(rec[F64_RULES[f64_rule]])
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


def phase_main(device, ny: int = TILE, nx: int = TILE, seed: int = 0,
               keep_run=None):
    """KalmanFilter.run over a full MODIS tile through the kernel
    (``tip_tile_run``: 4 windows, 6 dates).  Returns the phase record and
    the kernel's inputs on date KEEP_DATE; ``keep_run`` (a dict) receives
    the run's filter, outputs and final state for phase mesh."""
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
        _mem().reset_peak(device)
    solvers.fused_gn_rows = keep
    try:
        fused_gn_rows.launches = 0
        t0 = time.perf_counter()
        kf, out, run_s, final = tip_tile_run(device, ny, nx, seed,
                                             final=True)
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
        "peak_device_bytes": (_mem().peak_bytes(device)
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
    if keep_run is not None:
        keep_run.update(kf=kf, out=out, final=final)
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
    """The least time of a function on the card: its bytes over the HBM
    roof, its float32 operations over the peak rate (the H100 roofs of
    ``kafka_tpu_torch.telemetry.perf``, their one home)."""
    from kafka_tpu_torch.telemetry.perf import HBM_GBPS, PEAK_TFLOPS_F32

    bytes_ms = bytes_moved / (HBM_GBPS * 1e9) * 1e3
    ops_ms = flops / (PEAK_TFLOPS_F32 * 1e12) * 1e3
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


def ulp_spread(up_vs_plain: dict, down_vs_plain: dict,
               names=("x", "A", "diag")) -> dict:
    """The float32 plain version's own spread at each of QUANTILES: the
    larger of its errors against itself with x_f moved one ulp up and
    down."""
    return {nm: {q: max(up_vs_plain[nm][q], down_vs_plain[nm][q])
                 for q in map(str, QUANTILES)} for nm in names}


def held_within_ulp_spread(kernel_vs_ref: dict, plain_vs_ref: dict,
                           spread: dict, names) -> list:
    """The float64 rule of a date that float32 cannot resolve (ROADMAP
    Queue 3 item 12; the head of this file): at each of QUANTILES the
    kernel's error against the float64 plain version at most the
    larger of ERR_MARGIN times the float32 plain version's, that error
    plus the plain version's own one-ulp spread (``ulp_spread``), and
    ERR_FLOOR.  Returns the failures."""
    failures = []
    for nm in names:
        for q in map(str, QUANTILES):
            kq, pq, sq = (kernel_vs_ref[nm][q], plain_vs_ref[nm][q],
                          spread[nm][q])
            if kq > max(ERR_MARGIN * pq, pq + sq, ERR_FLOOR):
                failures.append(
                    f"{nm} error at quantile {q}: kernel {kq:.3g} > plain "
                    f"{pq:.3g} + its one-ulp spread {sq:.3g}")
    return failures


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
                  seed: int = 0, keep_run=None):
    """KalmanFilter.run over one S2 sub-tile through the row loop (its
    one-acquisition windows run as fused blocks where the engine's
    guards let them).  Returns the record, the fused update's inputs of
    the first iteration of date KEEP_DATE and that date's
    ``iterated_solve`` arguments; ``keep_run`` (a dict) receives the
    run's filter, outputs and final state for phase mesh."""
    import torch

    from kafka_tpu_torch.core import fused_update as fu_mod
    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.fused_update import fused_update_rows

    t_setup = time.perf_counter()
    kf, out, x0, p_inv0, grid, obs_days = s2_tile_filter(device, ny, nx,
                                                         seed)
    mask = kf.gather.mask
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
            _mem().reset_peak(device)
        res = real_solve(*args, **kwargs)
        _sync(device)
        peaks.append(_mem().peak_bytes(device) if cuda
                     else None)
        return res

    def keep(*args, **kwargs):
        if date_idx[0] == KEEP_DATE and not kept:
            kept.update((k, v.clone()) for k, v in zip(names, args))
        return fused_update_rows(*args, **kwargs)

    solvers.iterated_solve = date_wrap
    solvers.fused_update_rows = keep
    try:
        reset_launches()
        t0 = time.perf_counter()
        x_a, _, p_inv_a = kf.run(grid, x0, None, p_inv0)
        _sync(device)
        run_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        solvers.iterated_solve = real_solve
        solvers.fused_update_rows = fu_mod.fused_update_rows
    dates = kf.diagnostics_log
    finite = outputs_finite(out, mask.shape)
    per_date = date_records(dates, peaks)
    iterations = sum(r["n_iterations"] for r in dates)
    rec = {
        "phase": "main_s2", "tile": [ny, nx], "n_valid": kf.gather.n_valid,
        "n_pad": kf.gather.n_pad, "windows": len(grid) - 1,
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
    if device.type == "cuda" and launches["prosail_rows"] != iterations:
        raise AssertionError(f"{launches['prosail_rows']} PROSAIL row "
                             f"kernel launches for {iterations} iterations")
    if not finite:
        raise AssertionError("non-finite output raster")
    if not kept or not kept_date_args:
        raise AssertionError(f"no fused update on date {KEEP_DATE}")
    if keep_run is not None:
        keep_run.update(kf=kf, out=out, final=(x_a, p_inv_a))
    return rec, kept, kept_date_args


def s2_tile_filter(device, ny: int, nx: int, seed: int, **filter_kwargs):
    """Phase main_s2's sub-tile configuration (PROSAIL, sail_prior, no
    propagation with Q = 0, relaxation 0.7, the Barrax grid, one
    acquisition per step) as a KalmanFilter with ``filter_kwargs``:
    ``(kf, out, x0, p_inv0, grid, obs_days)``."""
    from kafka_tpu_torch.engine import (PROSAIL_PARAMETER_LIST,
                                        KalmanFilter, sail_prior)
    from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                   s2_observations)

    def day(i):
        return datetime.datetime(2017, 7, 3) + datetime.timedelta(days=i)

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
                      solver_options={"relaxation": 0.7}, device=device,
                      **filter_kwargs)
    kf.set_trajectory_uncertainty(np.zeros(10))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    return kf, out, x0, p_inv0, [day(i) for i in grid_days], obs_days


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
        # kafkalint: disable=nonfinite-launder — the error measure of a
        # kernel-vs-plain comparison; non-finite pixels are counted apart.
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


def prosail_rows_states(n: int, device, seed: int):
    """``(10, n)`` float32 states inside ProsailOperator's bounds, with
    1/16 of the pixels on each bound of every parameter: the ties the
    solver's projection leaves, where the clips' half-tangent rule
    decides the Jacobian."""
    import torch

    from kafka_tpu_torch.obsops.prosail import ProsailOperator

    lo, hi = ProsailOperator.state_bounds
    rng = np.random.default_rng(seed)
    x = (lo + (hi - lo) * rng.uniform(0.0, 1.0, (n, 10))).astype(np.float32)
    for k in range(10):
        idx = rng.permutation(n)[: n // 8]
        x[idx[: n // 16], k] = lo[k]
        x[idx[n // 16:], k] = hi[k]
    return torch.as_tensor(np.ascontiguousarray(x.T), device=device)


def prosail_rows_aux(case, n: int, device, seed: int, dtype):
    """A ``ProsailAux`` in ``dtype``: case g in 0-3 the g-th of
    S2_GEOMETRIES as 0-d angles; ``per_pixel`` each pixel one of them,
    moved by up to 2 degrees."""
    import torch

    from kafka_tpu_torch.obsops.prosail import ProsailAux

    if case != "per_pixel":
        return ProsailAux(*(torch.tensor(v, dtype=dtype, device=device)
                            for v in S2_GEOMETRIES[case]))
    rng = np.random.default_rng(seed)
    geo = np.asarray(S2_GEOMETRIES, np.float32)[rng.integers(0, 4, n)]
    geo = geo + rng.uniform(-2.0, 2.0, geo.shape).astype(np.float32)
    geo[:, 1] = np.abs(geo[:, 1])
    return ProsailAux(*(torch.as_tensor(geo[:, i], device=device)
                        .to(dtype).contiguous() for i in range(3)))


def prosail_rows_case(op, x_rows, aux, aux64) -> dict:
    """The PROSAIL row kernel against its plain version (the eager
    ``torch.func`` linearisation in the engine's blocks) and both against
    the plain version in float64 on the same inputs.  Per pixel the
    errors are the value's largest absolute error over the bands
    (``h0``) and the Jacobian's largest over its 100 entries, each
    divided by its (band, parameter) column's largest float64 magnitude
    (``jac``).  The gate is the file head's float64 rule with the issue's
    budgets as floors: at each of QUANTILES and at the maximum the
    kernel may be at most ERR_MARGIN times as far off as the float32
    plain version, or PROSAIL_H0_ATOL / PROSAIL_JAC_RTOL.  Float32
    PROSAIL is ill-conditioned where ko meets m (the SAIL fluxes'
    removable singularities): there the plain version's own Jacobian is
    off float64 by up to ~1e-1 of its column, so no direct budget
    between the two float32 versions holds everywhere; the direct
    numbers are recorded."""
    import torch

    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.fused_update import jac_to_rows
    from kafka_tpu_torch.core.prosail_rows import (linearize_rows_plain,
                                                   prosail_linearize_rows)

    dev = x_rows.device
    h_k, j_k = prosail_linearize_rows(op, aux, x_rows)
    _sync(dev)
    h_p, j_p = linearize_rows_plain(op, aux, x_rows, ENGINE_BLOCK)
    lin = solvers._blocked_linearize(op.linearize, aux64,
                                     x_rows.T.to(torch.float64),
                                     ENGINE_BLOCK)
    h_r, j_r = lin.h0, jac_to_rows(lin.jac)
    del lin
    col = j_r.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    col_p = j_p.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    jac_vs_plain = ((j_k - j_p).abs() / col_p).amax(dim=1)

    def errors(h, j):
        return {"h0": (h.double() - h_r).abs().amax(dim=0),
                "jac": ((j.double() - j_r).abs() / col).amax(dim=0)}

    kernel_vs_ref = {k: quantile_summary(v)
                     for k, v in errors(h_k, j_k).items()}
    plain_vs_ref = {k: quantile_summary(v)
                    for k, v in errors(h_p, j_p).items()}
    floors = {"h0": PROSAIL_H0_ATOL, "jac": PROSAIL_JAC_RTOL}
    failures = []
    for nm, floor in floors.items():
        for q in (*map(str, QUANTILES), "max"):
            kq, pq = kernel_vs_ref[nm][q], plain_vs_ref[nm][q]
            if kq > max(ERR_MARGIN * pq, floor):
                failures.append(f"{nm} error at {q}: kernel {kq:.3g} > "
                                f"max({ERR_MARGIN} x plain {pq:.3g}, "
                                f"{floor:g})")
    nonfinite = int((~torch.isfinite(h_k)).sum() + (~torch.isfinite(j_k))
                    .sum())
    if nonfinite:
        failures.append(f"{nonfinite} non-finite kernel outputs")
    return {
        "n_pix": int(x_rows.shape[1]),
        "h0_vs_plain_max": float((h_k - h_p).abs().max()),
        "jac_vs_plain_worst_column": float(jac_vs_plain.max()),
        "jac_columns_within_rtol": int((jac_vs_plain <= PROSAIL_JAC_RTOL)
                                       .sum()),
        "kernel_vs_f64": kernel_vs_ref, "plain_vs_f64": plain_vs_ref,
        "nonfinite": nonfinite, "failures": failures}


def prosail_rows_date(device, n_pix: int = PROSAIL_ROWS_SIZES[-1],
                      seed: int = 11) -> dict:
    """One chunk date of make_prosail_problem through ``assimilate_date``
    on both routes of the row loop: the kernel (``op.linearize``, whose
    operator advertises ``linearize_rows``) and the eager ``torch.func``
    linearisation (a closure hides the operator), which also runs with
    x_f moved one ulp up: its own spread.  Trip counts and QA verdicts
    must be equal; at each of QUANTILES and at the maximum the kernel's
    x may differ from the torch.func route's by PROSAIL_DATE_X_ATOL or
    ERR_MARGIN times that route's one-ulp spread, whichever is larger
    (the file head's rule: the float32 solve resolves some pixels no
    better); the route counter must show every trip on the kernel."""
    import torch

    from kafka_tpu_torch.core.solvers import assimilate_date
    from kafka_tpu_torch.telemetry import MetricsRegistry, use
    from kafka_tpu_torch.testing.synthetic import make_prosail_problem

    op, bands, x0, p0, aux = make_prosail_problem(n_pix, seed=seed,
                                                  device=device)
    lo, hi = (torch.as_tensor(v, device=device) for v in op.state_bounds)
    opts = {"relaxation": 0.7, "linearize_block": ENGINE_BLOCK,
            "state_bounds": (lo, hi)}

    def torch_func(a, x):
        return op.linearize(a, x)

    out = {}
    for route, lin, x_f in (
            ("kernel", op.linearize, x0), ("torch_func", torch_func, x0),
            ("torch_func_ulp", torch_func,
             torch.nextafter(x0, torch.full_like(x0, float("inf"))))):
        reg = MetricsRegistry()
        with use(reg):
            t0 = time.perf_counter()
            x, _a, diags = assimilate_date(lin, bands, x_f, p0, aux, opts,
                                           device=device)
            trips = int(diags.n_iterations)
            wall_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in reg.flat().items()
                  if k.startswith("kafka_rowloop_linearizations_total")}
        out[route] = {"x": x, "verdicts": diags.health_verdicts.cpu(),
                      "trips": trips, "wall_ms": wall_ms, "counter": counts}
    k, t, u = out["kernel"], out["torch_func"], out["torch_func_ulp"]
    x_err = quantile_summary((k["x"] - t["x"]).abs().amax(dim=1))
    spread = quantile_summary((u["x"] - t["x"]).abs().amax(dim=1))
    rec = {"n_pix": n_pix, "trips": [k["trips"], t["trips"], u["trips"]],
           "wall_ms": [k["wall_ms"], t["wall_ms"]],
           "verdicts_equal": bool(torch.equal(k["verdicts"],
                                              t["verdicts"])),
           "x_vs_torch_func": x_err, "torch_func_ulp_spread": spread,
           "counter": {"kernel": k["counter"], "torch_func":
                       t["counter"]}}
    failures = []
    if k["trips"] != t["trips"]:
        failures.append(f"trips differ: {rec['trips']}")
    if not rec["verdicts_equal"]:
        failures.append("QA verdicts differ")
    for q in (*map(str, QUANTILES), "max"):
        if x_err[q] > max(PROSAIL_DATE_X_ATOL, ERR_MARGIN * spread[q]):
            failures.append(f"x at {q}: {x_err[q]:.3g} > max("
                            f"{PROSAIL_DATE_X_ATOL:g}, {ERR_MARGIN} x the "
                            f"one-ulp spread {spread[q]:.3g})")
    want = {'kafka_rowloop_linearizations_total{route="kernel"}':
            float(k["trips"])}
    if k["counter"] != want:
        failures.append(f"route counter {k['counter']}, expected {want}")
    rec["failures"] = failures
    return rec


def phase_prosail_rows(device, sizes=PROSAIL_ROWS_SIZES, seed: int = 21,
                       kernel_reps: int = 20, plain_reps: int = 2) -> dict:
    """The PROSAIL row kernel against its plain version at each of
    ``sizes`` on the S2 geometries (0-d angles) and per-pixel angles
    (``prosail_rows_case``), timed at the largest size, and one chunk
    date through ``assimilate_date`` on both routes
    (``prosail_rows_date``)."""
    import torch

    from kafka_tpu_torch.core import prosail_rows
    from kafka_tpu_torch.core.prosail_rows import (linearize_rows_plain,
                                                   prosail_linearize_rows)
    from kafka_tpu_torch.obsops.prosail import ProsailOperator

    op = ProsailOperator()
    cases, failures = [], []
    for i, n in enumerate(sizes):
        x_rows = prosail_rows_states(n, device, seed + i)
        for case in (0, 1, 2, 3, "per_pixel"):
            aux, aux64 = (prosail_rows_aux(case, n, device, seed + i, dt)
                          for dt in (torch.float32, torch.float64))
            r = prosail_rows_case(op, x_rows, aux, aux64)
            r["case"] = case if case == "per_pixel" else f"geometry_{case}"
            cases.append(r)
            failures += [f"{n} px {r['case']}: {f}" for f in r["failures"]]
    n = sizes[-1]
    x_rows = prosail_rows_states(n, device, seed)
    aux = prosail_rows_aux(0, n, device, seed, torch.float32)
    launches = prosail_linearize_rows.launches
    ms = time_ms(lambda: prosail_linearize_rows(op, aux, x_rows), device,
                 kernel_reps)
    plain_ms = time_ms(lambda: linearize_rows_plain(op, aux, x_rows,
                                                    ENGINE_BLOCK),
                       device, plain_reps)
    roof = bound(PROSAIL_ROWS_BYTES_PER_PX * n, PROSAIL_ROWS_OPS_PER_PX * n)
    date = prosail_rows_date(device)
    failures += [f"date: {f}" for f in date["failures"]]
    attr = prosail_rows.kernel_attributes()
    rec = {"phase": "prosail_rows", "cases": cases, "n_pix": n,
           "ms": ms, "plain_ms": plain_ms, **roof,
           "ops_per_px": PROSAIL_ROWS_OPS_PER_PX,
           "timed_launches": prosail_linearize_rows.launches - launches,
           "max_abs_err": max(c["h0_vs_plain_max"] for c in cases),
           "registers": attr["registers"], "spill_bytes": attr["local_bytes"],
           "date": date, "failures": failures}
    emit(rec)
    if failures:
        raise AssertionError(f"prosail_rows: {failures}")
    return rec


def phase_main_gp(device, seed: int = GP_SEED) -> tuple:
    """KalmanFilter.run over one chunk of the benchmark's GP_CELL, as its
    harness runs a job: the cell's scenario
    (``benchmark/scenarios/s2_gp_bank.py``) fits the banks of its
    geometries, picks each acquisition's by the program's
    ``geometry_bank_aux_builder`` and makes the chunk's data, and the
    job runs the row loop on the GP row kernel and the fused update at
    (10, 10).  Launch counts are reset and a fresh registry installed
    just before the job: gp_rows and fused-update launches, the route
    counter's ``kernel`` ticks and ``kafka_gp_rows_launches_total`` must
    each equal the dates' Gauss-Newton trips, every window must be
    dumped and its sampled outputs pass the cell's limits against the
    float64 reference filter.  Every bank also goes through
    ``save_bank_npz`` / ``load_bank_npz`` unchanged.  Returns the record
    and the banks."""
    import tempfile

    import torch

    from benchmark import harness
    from benchmark.sink import HostSink
    from kafka_tpu_torch.obsops.gp_import import load_bank_npz, \
        save_bank_npz
    from kafka_tpu_torch.telemetry import MetricsRegistry, use

    spec = harness.cell(GP_CELL)
    config = harness._merge(spec["config"], {"n_chunks": 1})
    work = spec["workload"]
    t0 = time.perf_counter()
    scn = harness.scenario_class(config)(config, work, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as folder:
        npz_equal = True
        for i, bank in enumerate(scn.banks.values()):
            path = os.path.join(folder, f"bank_{i}.npz")
            save_bank_npz(path, bank)
            back = load_bank_npz(path, device)
            npz_equal &= all(torch.equal(a, b) for a, b in zip(bank, back))
    sink = HostSink(scn.n_pad, len(scn.cfg.parameter_list), scn.n_valid,
                    pinned=device.type == "cuda")
    records, reg = [], MetricsRegistry()
    cuda = device.type == "cuda"
    reset_launches()
    if cuda:
        _mem().reset_peak(device)
    with use(reg):
        t1 = time.perf_counter()
        harness.run_jobs(scn, sink, device, 0, 0.0, True, records,
                         max_jobs=1)
        _sync(device)
        run_s = time.perf_counter() - t1
    launches = launch_counts()
    peak = _mem().peak_bytes(device) if cuda else None
    counts = {k: v for k, v in reg.flat().items()
              if k.startswith(("kafka_rowloop_linearizations_total",
                               "kafka_gp_rows_launches_total"))}
    trips = sum(int(r["n_iterations"]) for r in records)
    scn.reference_inputs()
    scn.release()
    values, correct, checks, failed = harness.check(
        scn, sink, work["limits"], torch.float64, work.get("share_over"))
    banks = scn.banks
    rec = {"phase": "main_gp", "cell": GP_CELL, "seed": seed,
           "chunk": config["chunk"], "n_valid": scn.n_valid,
           "n_pad": scn.n_pad, "dates_assimilated": len(records),
           "windows_dumped": len(sink.completed), "trips": trips,
           "kernel_launches": launches, "counter": counts,
           "setup_s": setup_s, "run_s": run_s, "peak_bytes": peak,
           "banks": len(banks), "banks_npz_equal": bool(npz_equal),
           "values": values, "checks": checks, "correct": bool(correct),
           "failed": failed, "per_date": date_records(records)}
    emit(rec)
    failures = []
    if len(records) != len(scn.dates) or trips == 0:
        failures.append(f"{len(records)} dates and {trips} trips "
                        f"assimilated, {len(scn.dates)} dates expected")
    if len(sink.completed) != len(scn.windows(0)):
        failures.append(f"{len(sink.completed)} windows dumped")
    want = {'kafka_rowloop_linearizations_total{route="kernel"}':
            float(trips), "kafka_gp_rows_launches_total": float(trips)}
    if counts != want or launches["gp_rows"] != trips \
            or launches["fused_update"] != trips:
        failures.append(f"launches {launches} and counters {counts} for "
                        f"{trips} trips, expected one of each a trip")
    if not correct or failed:
        failures.append(f"against the float64 reference: {checks}, "
                        f"{failed} non-finite windows")
    if not npz_equal:
        failures.append("a bank changed through save_bank_npz / "
                        "load_bank_npz")
    if failures:
        raise AssertionError(f"main_gp: {failures}")
    del scn, sink
    if cuda:
        torch.cuda.empty_cache()
    return rec, banks


def gp_rows_case(op, bank, x_rows, block: int = GP_F64_BLOCK) -> dict:
    """The GP row kernel against its plain version (the closed form in
    float32, in the engine's blocks) and both against the plain version
    in float64 on the same inputs.  Per pixel the errors are the value's
    largest absolute error over the bands (``h0``) and the Jacobian's
    largest over its entries, each divided by its (band, parameter)
    column's largest float64 magnitude (``jac``).  The gate is the file
    head's float64 rule with GP_H0_ATOL / GP_JAC_RTOL as floors: at each
    of QUANTILES and at the maximum the kernel may be at most ERR_MARGIN
    times as far off as the float32 plain version, or the floor."""
    import torch

    from kafka_tpu_torch.core.gp_rows import (gp_linearize_rows,
                                              linearize_rows_plain)

    dev = x_rows.device
    h_k, j_k = gp_linearize_rows(op, bank, x_rows)
    _sync(dev)
    h_p, j_p = linearize_rows_plain(op, bank, x_rows, block)
    h_r, j_r = linearize_rows_plain(op, bank, x_rows.double(), block,
                                    dtype=torch.float64)
    col = j_r.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)

    def errors(h, j):
        return {"h0": (h.double() - h_r).abs().amax(dim=0),
                "jac": ((j.double() - j_r).abs() / col).amax(dim=0)}

    kernel_vs_ref = {k: quantile_summary(v)
                     for k, v in errors(h_k, j_k).items()}
    plain_vs_ref = {k: quantile_summary(v)
                    for k, v in errors(h_p, j_p).items()}
    failures = []
    for nm, floor in (("h0", GP_H0_ATOL), ("jac", GP_JAC_RTOL)):
        for q in (*map(str, QUANTILES), "max"):
            kq, pq = kernel_vs_ref[nm][q], plain_vs_ref[nm][q]
            if kq > max(ERR_MARGIN * pq, floor):
                failures.append(f"{nm} error at {q}: kernel {kq:.3g} > "
                                f"max({ERR_MARGIN} x plain {pq:.3g}, "
                                f"{floor:g})")
    nonfinite = int((~torch.isfinite(h_k)).sum() + (~torch.isfinite(j_k))
                    .sum())
    if nonfinite:
        failures.append(f"{nonfinite} non-finite kernel outputs")
    return {"n_pix": int(x_rows.shape[1]),
            "h0_vs_plain_max": float((h_k - h_p).abs().max()),
            "jac_vs_plain_max": float(((j_k - j_p).abs() / col).max()),
            "kernel_vs_f64": kernel_vs_ref, "plain_vs_f64": plain_vs_ref,
            "nonfinite": nonfinite, "failures": failures}


def gp_rows_date(device, bank, n_pix: int = GP_DATE_PX,
                 seed: int = 13) -> dict:
    """One date of a GP-bank problem (states about the SAIL prior's
    mean, the bank's values there plus noise as observations) through
    ``assimilate_date`` on both routes of the row loop: the kernel
    (``op.linearize``, whose operator advertises ``linearize_rows``) and
    the eager ``torch.func`` linearisation (a closure hides the
    operator), which also runs with x_f moved one ulp up: its own
    spread.  Trip counts and QA verdicts must be equal; at each of
    QUANTILES and at the maximum the kernel's x may differ from the
    torch.func route's by GP_DATE_X_ATOL or ERR_MARGIN times that
    route's one-ulp spread, whichever is larger (``prosail_rows_date``'s
    rule); the route counter must show every trip on the kernel, and
    the kernel one launch a trip."""
    import torch

    from kafka_tpu_torch.core.gp_rows import gp_linearize_rows
    from kafka_tpu_torch.core.solvers import assimilate_date
    from kafka_tpu_torch.core.types import BandBatch
    from kafka_tpu_torch.engine.priors import sail_prior_arrays
    from kafka_tpu_torch.obsops.gp import GPBankOperator
    from kafka_tpu_torch.obsops.prosail import ProsailOperator
    from kafka_tpu_torch.telemetry import MetricsRegistry, use

    op = GPBankOperator(n_params=10, n_bands=10)
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(v, np.float32) for v in
              ProsailOperator.state_bounds)
    mean, _, inv_cov = sail_prior_arrays()
    truth = np.clip(mean + 0.02 * rng.normal(size=(n_pix, 10)), lo, hi)
    x_t = torch.as_tensor(truth.astype(np.float32), device=device)
    clean = op.forward(bank, x_t)
    sigma = torch.clamp(0.05 * clean.abs(), min=1e-3)
    y = clean + sigma * torch.as_tensor(rng.normal(size=tuple(clean.shape)),
                                        dtype=torch.float32, device=device)
    bands = BandBatch(y=y, r_inv=1.0 / sigma ** 2,
                      mask=torch.ones_like(y, dtype=torch.bool))
    x0 = torch.as_tensor(mean, device=device).expand(n_pix, 10) \
        .contiguous()
    p0 = torch.as_tensor(inv_cov, device=device).expand(n_pix, 10, 10) \
        .contiguous()
    opts = {"relaxation": 0.7, "linearize_block": GP_DATE_BLOCK,
            "state_bounds": (torch.as_tensor(lo, device=device),
                             torch.as_tensor(hi, device=device))}

    def torch_func(a, x):
        return op.linearize(a, x)

    out = {}
    for route, lin, x_f in (
            ("kernel", op.linearize, x0), ("torch_func", torch_func, x0),
            ("torch_func_ulp", torch_func,
             torch.nextafter(x0, torch.full_like(x0, float("inf"))))):
        reg = MetricsRegistry()
        launches = gp_linearize_rows.launches
        with use(reg):
            t0 = time.perf_counter()
            x, _a, diags = assimilate_date(lin, bands, x_f, p0, bank, opts,
                                           device=device)
            trips = int(diags.n_iterations)
            wall_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in reg.flat().items()
                  if k.startswith(("kafka_rowloop_linearizations_total",
                                   "kafka_gp_rows_launches_total"))}
        out[route] = {"x": x, "verdicts": diags.health_verdicts.cpu(),
                      "trips": trips, "wall_ms": wall_ms, "counter": counts,
                      "launches": gp_linearize_rows.launches - launches}
    k, t, u = out["kernel"], out["torch_func"], out["torch_func_ulp"]
    x_err = quantile_summary((k["x"] - t["x"]).abs().amax(dim=1))
    spread = quantile_summary((u["x"] - t["x"]).abs().amax(dim=1))
    rec = {"n_pix": n_pix, "trips": [k["trips"], t["trips"], u["trips"]],
           "wall_ms": [k["wall_ms"], t["wall_ms"]],
           "launches": [k["launches"], t["launches"]],
           "verdicts_equal": bool(torch.equal(k["verdicts"],
                                              t["verdicts"])),
           "x_vs_torch_func": x_err, "torch_func_ulp_spread": spread,
           "counter": {"kernel": k["counter"], "torch_func": t["counter"]}}
    failures = []
    if k["trips"] != t["trips"]:
        failures.append(f"trips differ: {rec['trips']}")
    if not rec["verdicts_equal"]:
        failures.append("QA verdicts differ")
    for q in (*map(str, QUANTILES), "max"):
        if x_err[q] > max(GP_DATE_X_ATOL, ERR_MARGIN * spread[q]):
            failures.append(f"x at {q}: {x_err[q]:.3g} > max("
                            f"{GP_DATE_X_ATOL:g}, {ERR_MARGIN} x the "
                            f"one-ulp spread {spread[q]:.3g})")
    want = {'kafka_rowloop_linearizations_total{route="kernel"}':
            float(k["trips"]), "kafka_gp_rows_launches_total":
            float(k["trips"])}
    if k["counter"] != want or k["launches"] != k["trips"] \
            or t["launches"] != 0:
        failures.append(f"route counter {k['counter']} and launches "
                        f"{rec['launches']}, expected {want}")
    rec["failures"] = failures
    return rec


def phase_gp_rows(device, banks: dict, sizes=GP_ROWS_SIZES, seed: int = 22,
                  kernel_reps: int = 10) -> dict:
    """The GP row kernel against its plain version at each of ``sizes``
    on every bank of ``banks`` (phase main_gp's), the states of
    ``prosail_rows_states``
    (1/16 of the pixels on each bound) (``gp_rows_case``), timed at the
    largest size beside its bound, and one date through
    ``assimilate_date`` on both routes (``gp_rows_date``)."""
    import torch

    from kafka_tpu_torch.core import gp_rows
    from kafka_tpu_torch.core.gp_rows import (gp_linearize_rows,
                                              linearize_rows_plain)
    from kafka_tpu_torch.obsops.gp import GPBankOperator

    op = GPBankOperator(n_params=10, n_bands=10)
    cases, failures = [], []
    for i, n in enumerate(sizes):
        x_rows = prosail_rows_states(n, device, seed + i)
        for gi, (geo, bank) in enumerate(banks.items()):
            r = gp_rows_case(op, bank, x_rows)
            r["case"] = f"geometry_{gi}"
            cases.append(r)
            failures += [f"{n} px {geo}: {f}" for f in r["failures"]]
    n = sizes[-1]
    bank = next(iter(banks.values()))
    x_rows = prosail_rows_states(n, device, seed)
    launches = gp_linearize_rows.launches
    ms = time_ms(lambda: gp_linearize_rows(op, bank, x_rows), device,
                 kernel_reps)
    plain_ms = time_ms(lambda: linearize_rows_plain(op, bank, x_rows,
                                                    GP_F64_BLOCK),
                       device, 1)
    # The benchmark's count of the kernel (operations and bytes from
    # csrc/gp_rows.cu).
    from benchmark.gp_roofline import gp_rows_work

    m, k = (int(v) for v in bank.x_train.shape[1:])
    roof = bound(*gp_rows_work(n, op.n_params, op.n_bands, m, k))
    date = gp_rows_date(device, bank)
    failures += [f"date: {f}" for f in date["failures"]]
    attr = gp_rows.kernel_attributes(k)
    rec = {"phase": "gp_rows", "cases": cases, "n_pix": n,
           "ms": ms, "plain_ms": plain_ms, **roof,
           "share_of_bound": roof["bound_ms"] / ms,
           "timed_launches": gp_linearize_rows.launches - launches,
           "max_abs_err": {nm: max(c[f"{nm}_vs_plain_max"] for c in cases)
                           for nm in ("h0", "jac")},
           "max_err_vs_f64": {nm: max(c["kernel_vs_f64"][nm]["max"]
                                      for c in cases)
                              for nm in ("h0", "jac")},
           "registers": attr["registers"], "spill_bytes": attr["local_bytes"],
           "date": date, "failures": failures}
    emit(rec)
    if failures:
        raise AssertionError(f"gp_rows: {failures}")
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
        # kafkalint: disable=nonfinite-launder — the error measure of a
        # kernel-vs-plain comparison; non-finite pixels are counted apart.
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
    before = _mem().allocated_bytes(device) if cuda else 0
    out = GeoTIFFOutput(("a", "b"), (0.0, 1.0, 0.0, 0.0, 0.0, -1.0),
                        folder=folder, async_writes=True)
    ts = datetime.datetime(2017, 7, 2)
    out.dump_data(ts, x, None, g, ("a", "b"))
    x.fill_(-1.0)
    del x
    out.close()
    after = _mem().allocated_bytes(device) if cuda else 0
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
    n_windows = CLI_DAYS // 4

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
        _mem().reset_peak(device)
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
    peak_bytes = _mem().peak_bytes(device) if cuda else None
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
    dates = [base + datetime.timedelta(days=d)
             for d in range(1, CLI_DAYS, 4)]
    grid = [base + datetime.timedelta(days=d)
            for d in range(0, CLI_DAYS + 4, 4)]
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
    from kafka_tpu_torch.core.gp_rows import gp_linearize_rows
    from kafka_tpu_torch.core.prosail_rows import prosail_linearize_rows
    from kafka_tpu_torch.core.solve_rows import solve_rows

    fused_gn_rows.launches = fused_update_rows.launches = \
        solve_rows.launches = prosail_linearize_rows.launches = \
        gp_linearize_rows.launches = 0
    fused_update_rows.launches_by_instance = {}


def launch_counts() -> dict:
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.core.fused_update import fused_update_rows
    from kafka_tpu_torch.core.gp_rows import gp_linearize_rows
    from kafka_tpu_torch.core.prosail_rows import prosail_linearize_rows
    from kafka_tpu_torch.core.solve_rows import solve_rows

    return {"fused_gn": fused_gn_rows.launches,
            "fused_update": fused_update_rows.launches,
            "fused_update_by_instance": {
                f"{p}x{nb}": n for (p, nb), n in
                sorted(fused_update_rows.launches_by_instance.items())},
            "solve_rows": solve_rows.launches,
            "prosail_rows": prosail_linearize_rows.launches,
            "gp_rows": gp_linearize_rows.launches}


UPDATE_ROW_NAMES = ("jac_rows", "h0", "y", "w", "m", "xl_rows", "xf_rows",
                    "pf_rows", "esc_row")


class UpdateKeeper:
    """Wraps ``solvers.iterated_solve``, ``solvers.build_normal_equations``
    and the fused update's two routes (``_launch_cuda`` and
    ``fused_update_raw_plain``, which ``fused_update_rows`` reaches by
    device) for one run: counts the dates, records each date's peak
    device bytes (and the peak between dates, ``run_peak``) and its
    per-pixel frozen mask (``frozen``, on the host; None without
    per-pixel convergence), and keeps (clones) the fused update's inputs
    of the first iteration on date ``keep[(p, n_bands)]`` of each
    instance, and the dense update's inputs (``build_normal_equations``,
    at p > 16) of the first iteration on date ``keep["dense"]``.  The
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
        self._real = (solvers.iterated_solve, solvers.build_normal_equations,
                      fu_mod._launch_cuda, fu_mod.fused_update_raw_plain)
        real_solve, real_dense = self._real[:2]
        cuda = self.device.type == "cuda"

        def date_wrap(*args, **kwargs):
            self.date += 1
            if cuda:
                # The peak since the last date's read (propagation,
                # observation reads), before the counter restarts.
                self._between.append(
                    _mem().peak_bytes(self.device))
                _mem().reset_peak(self.device)
            res = real_solve(*args, **kwargs)
            _sync(self.device)
            self.peaks.append(_mem().peak_bytes(self.device)
                              if cuda else None)
            mask = res[2].converged_mask
            self.frozen.append(None if mask is None else mask.cpu())
            return res

        def keep_dense(lin, obs, x_lin, x_f, p_inv):
            if self.keep.get("dense") == self.date and \
                    "dense" not in self.kept:
                self.kept["dense"] = dict(
                    lin=lin, obs=obs, x_lin=x_lin.clone(), x_f=x_f.clone(),
                    p_inv=p_inv.clone())
            return real_dense(lin, obs, x_lin, x_f, p_inv)

        def keeping(route):
            def keep(*args):
                inst = (args[6].shape[0], args[1].shape[0])
                if self.keep.get(inst) == self.date and \
                        inst not in self.kept:
                    rows = {k: None if v is None else v.clone()
                            for k, v in zip(UPDATE_ROW_NAMES, args)}
                    # The generic loop's fused step passes no escalation
                    # row.
                    if rows.get("esc_row") is None:
                        rows["esc_row"] = torch.zeros_like(rows["h0"][:1])
                    self.kept[inst] = rows
                return route(*args)
            return keep

        solvers.iterated_solve, solvers.build_normal_equations = \
            date_wrap, keep_dense
        fu_mod._launch_cuda = keeping(self._real[2])
        fu_mod.fused_update_raw_plain = keeping(self._real[3])
        return self

    def __exit__(self, *exc):
        (self._solvers.iterated_solve, self._solvers.build_normal_equations,
         self._fu._launch_cuda, self._fu.fused_update_raw_plain) = \
            self._real

    def run_peak(self):
        """Peak device bytes over the whole run (None off the card); read
        after the run."""
        import torch

        if self.device.type != "cuda":
            return None
        return max(self.peaks + self._between
                   + [_mem().peak_bytes(self.device)])


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
        _mem().reset_peak(device)
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
        _mem().reset_peak(device)
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
        _mem().reset_peak(device)
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
        _mem().reset_peak(device)
    with DriverProbe(BHRObservations, keep_gn=CLI_MODIS_KEEP_DATE) as probe:
        reset_launches()
        stats, printed, _ = run_driver(run_modis.main, argv)
        launches = launch_counts()
    peak = _mem().peak_bytes(device) if cuda else None
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
                 final: bool = False, **filter_kwargs):
    """The MODIS tile configuration of phase main and the phases after
    it (the seeded land mask, the truth around the TIP prior, jrc_prior,
    prior-only advance, sigma 0.005 with 10 % masked) run by KalmanFilter
    with ``solver_options`` and ``filter_kwargs``.  Returns the filter,
    its MemoryOutput and the run's seconds (set-up excluded), and with
    ``final`` the run's final (x, P^-1) too."""
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
    x_a, _, p_inv_a = kf.run([day(i) for i in grid_days], x0, None, p_inv0)
    _sync(device)
    run_s = time.perf_counter() - t0
    if final:
        return kf, out, run_s, (x_a, p_inv_a)
    return kf, out, run_s


def phase_per_pixel(device, ny: int = TILE, nx: int = TILE, seed: int = 0):
    """phase main's tile run (its first window: PER_PIXEL_OBS_DAYS) with
    per_pixel_convergence (and ONE_BLOCK linearisation): every
    Gauss-Newton step is one launch of the fused update at (7, 2).
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
        _mem().reset_peak(device)
    with use(MetricsRegistry()) as reg, \
            UpdateKeeper(device, {(7, 2): PER_PIXEL_KEEP_DATE}) as keeper:
        reset_launches()
        kf, out, run_s = tip_tile_run(device, ny, nx, seed, opts,
                                      grid_days=PER_PIXEL_GRID_DAYS,
                                      obs_days=PER_PIXEL_OBS_DAYS)
        launches = launch_counts()
        peak = keeper.run_peak()
    gauge = reg.value("kafka_engine_converged_frac")
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
        device, ny, nx, seed, {**opts, "use_pallas": False},
        grid_days=PER_PIXEL_GRID_DAYS, obs_days=PER_PIXEL_OBS_DAYS)
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
        _mem().reset_peak(device)
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
            _mem().reset_peak(device)
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
        _mem().reset_peak(device)
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
        _mem().reset_peak(device)
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
    peak = (_mem().peak_bytes(device)
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
        # tile:label -> the response's state digest (phase device_plane
        # serves some of these requests again and must match them).
        "x_sha256": {f"{tile}:{label}": (responses[rid] or {})
                     .get("x_sha256")
                     for rid, (tile, label, _, _) in rids.items()},
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


def f64_rule(device, rows: dict) -> dict:
    """One fused_gn launch on ``rows`` held as phase kernel holds it,
    without timing: finite outputs, its per-pixel errors against the
    float64 plain version at QUANTILES and the rule's failures (empty
    when it holds), and the trip and verdict comparison of
    ``held_trips``."""
    import torch

    from kafka_tpu_torch.core import fused_gn

    n_pix = rows["pf_rows"].shape[1]
    block = fused_gn._block(n_pix, rows.get("block", 2048))
    ref = plain_f64(rows)
    plain = fused_gn.fused_gn_raw_plain(**rows)
    kern = fused_gn.fused_gn_raw(**rows)
    xf = rows["xf_rows"]
    nudged = [fused_gn.fused_gn_raw_plain(**{
        **rows, "xf_rows": torch.nextafter(xf, torch.full_like(xf, to))})
        for to in (float("inf"), float("-inf"))]
    _sync(device)
    vs_ref = summary(pixel_errors(kern, ref, block))
    plain_vs_ref = summary(pixel_errors(plain, ref, block))
    return {
        "n_pix": n_pix,
        "finite": all(bool(torch.isfinite(t).all()) for t in kern),
        "kernel_vs_f64": vs_ref,
        "f64_quantile_rule": held_quantiles(vs_ref, plain_vs_ref,
                                            ("x", "A", "diag")),
        **held_trips(kern, plain, ref, nudged, block),
    }


def serve_batch_kernels(device, rec: dict, kept: dict):
    """The kept coalesced launches of phase serve_batch against their
    plain versions: fused_gn by the float64 rule of a date float32
    cannot resolve (``held_within_ulp_spread``), each member's slice
    equal bit for bit to a launch of the member alone, and each member's
    float64 figures recorded (``member_f64``); the (2, 2) fused update
    by phase kernel_update's rule, 0 pixels differing.  Returns the two
    kernel records."""
    from kafka_tpu_torch.core import fused_gn

    n_pad = rec["n_pad"]
    failures = []
    gn_rows, upd_rows = kept["gn"], kept["rows"]
    # The kept coalesced fused_gn launch: phase kernel's gates, and each
    # member's slice against a launch of the member alone.
    gn_rec = None
    if gn_rows is None:
        failures.append("no coalesced fused_gn launch kept")
    else:
        # The kernel is built with FMA contraction, so it cannot equal
        # the plain version bit for bit; its trips, verdicts, geometry
        # and finiteness are gated as in phase kernel.  The serve tile's
        # first date is ill-conditioned in float32 on most pixels: a
        # one-ulp move of x_f moves the float32 plain version's x
        # further than the float32 solve lies from float64, so which
        # float32 version lands nearer float64 is the data's draw (the
        # JAX kernel lands where the port's plain version does:
        # tests/test_torch_fused_gn_serve_date.py).  The float64 rule
        # gated here is therefore the one-ulp spread rule; phase
        # kernel's margin rule is recorded beside it
        # (f64_quantile_rule), with each member's figures.
        out = {}
        gn_rec = phase_kernel(device, "serve_batch_coalesced", gn_rows,
                              f64_rule="ulp_spread", outputs=out)
        both = out["kern"]
        member_differ, member_f64 = [], []
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
            member_f64.append(member_figures(one, out, sl))
        gn_rec["member_entries_differing_from_solo_launch"] = member_differ
        gn_rec["member_f64"] = member_f64
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
          "fused_gn_f64_ulp_spread_rule":
              None if gn_rec is None else gn_rec["f64_ulp_spread_rule"],
          "fused_gn_f64_quantile_rule":
              None if gn_rec is None else gn_rec["f64_quantile_rule"],
          "fused_gn_member_f64":
              None if gn_rec is None else gn_rec["member_f64"],
          "fused_update_pixels_differing_from_plain":
              None if upd_rec is None
              else upd_rec["pixels_differing_from_plain"]})
    if failures:
        raise AssertionError("serve_batch: " + "; ".join(failures))
    return gn_rec, upd_rec


def member_figures(one: dict, out: dict, sl) -> dict:
    """One member of a coalesced fused_gn round on its own: its slice of
    the round's kernel (equal to its solo launch), float32 plain,
    float64 plain and one-ulp-nudged plain outputs (``out``, phase
    kernel's), held as phase kernel holds a date — the kernel and the
    float32 plain version against float64 at QUANTILES, the plain
    version's one-ulp spread and both float64 rules' failures — and
    whether the plain version at the member's own group size and pixel
    count (``scalar_n`` unset) gives the bits of its slice of the round
    (the fold's group size and ``scalar_n``)."""
    from kafka_tpu_torch.core import fused_gn

    block = fused_gn._block(one["pf_rows"].shape[1],
                            one.get("block", 2048))

    def part(raw):
        return [t[:, sl] for t in raw]

    kern, plain, ref = part(out["kern"]), part(out["plain"]), \
        part(out["ref"])
    up, down = (part(t) for t in out["nudged"])
    vs_ref = summary(pixel_errors(kern, ref, block))
    plain_vs_ref = summary(pixel_errors(plain, ref, block))
    spread = ulp_spread(summary(pixel_errors(up, plain, block)),
                        summary(pixel_errors(down, plain, block)))
    own = fused_gn.fused_gn_raw_plain(**{**one, "block": 2048,
                                         "scalar_n": None})
    names = ("x", "A", "diag")
    return {"n_pix": one["pf_rows"].shape[1], "block": block,
            "kernel_vs_f64": {nm: vs_ref[nm] for nm in names},
            "plain_vs_f64": {nm: plain_vs_ref[nm] for nm in names},
            "plain_ulp_spread": spread,
            "f64_quantile_rule": held_quantiles(vs_ref, plain_vs_ref,
                                                names),
            "f64_ulp_spread_rule": held_within_ulp_spread(
                vs_ref, plain_vs_ref, spread, names),
            "plain_own_group_equals_fold_slice": all(
                _outputs_equal(a, b) for a, b in zip(own, plain))}


def mesh_compare(base: dict, run: dict) -> dict:
    """A sharded run against its unsharded one (both ``{"out":
    MemoryOutput, "final": (x, P^-1)}``), date by date: each date's
    largest state-raster and sigma-raster differences, the largest
    relative sigma difference, the QA bands equal (and the pixels whose
    verdicts differ), the final x difference and the final P^-1 entries
    beyond the MESH_P budget, and whether all of it is the same bits."""
    import torch

    out_b, out_m = base["out"].output, run["out"].output
    unc_rel = 0.0
    x_by_date, sigma_by_date = [], []
    qa_equal = sorted(out_b) == sorted(out_m)
    same = qa_equal
    qa_differing = 0
    for ts in sorted(out_b):
        x_err = sigma_err = 0.0
        for key, ref in out_b[ts].items():
            got = out_m[ts][key]
            same = same and got.tobytes() == ref.tobytes()
            if key == "solver_qa":
                qa_differing += int((got != ref).sum())
            elif key.endswith("_unc"):
                diff = np.abs(got - ref)
                sigma_err = max(sigma_err, float(diff.max()))
                unc_rel = max(unc_rel, float(np.max(
                    diff / np.maximum(np.abs(ref), 1e-30))))
            else:
                x_err = max(x_err, float(np.abs(got - ref).max()))
        x_by_date.append(x_err)
        sigma_by_date.append(sigma_err)
    x_b, p_b = base["final"]
    x_m, p_m = (t.full(x_b.device) for t in run["final"])
    beyond = int(((p_m - p_b).abs()
                  > MESH_P_ATOL + MESH_P_RTOL * p_b.abs()).sum())
    same = same and bool(torch.equal(x_m, x_b)) and \
        bool(torch.equal(p_m, p_b))
    return {"x_max_abs_err": max(x_by_date, default=0.0),
            "x_max_abs_err_by_date": x_by_date,
            "sigma_max_abs_err": max(sigma_by_date, default=0.0),
            "sigma_max_abs_err_by_date": sigma_by_date,
            "sigma_max_rel_err": unc_rel,
            "solver_qa_equal": qa_equal and qa_differing == 0,
            "solver_qa_pixels_differing": qa_differing,
            "final_x_max_abs_err": float((x_m - x_b).abs().max()),
            "final_p_inv_entries_beyond_budget": beyond,
            "bit_identical": same}


def phase_mesh(device, main_run: dict, s2_run: dict, ny: int = TILE,
               nx: int = TILE, s2_ny: int = S2_TILE, s2_nx: int = S2_TILE,
               seed: int = 0):
    """Phase main's MODIS tile and phase main_s2's S2 sub-tile again,
    through KalmanFilter.run on a pixel mesh of MESH_SHARDS shards on the
    one card, each held date by date to the unsharded run of its phase:
    every state and sigma raster of every date within MESH_X_ATOL, the
    final P^-1 within the MESH_P budgets, QA bands equal; on the tile,
    where each shard holds whole 2,048-px groups of the unsharded run,
    fused_gn launches = shards x dates and the same bits; (10, 10)
    fused-update launches = shards x iterations on the sub-tile.  Then
    the tile on MESH_SPLIT_SHARDS shards of 1,152,000 px, which the
    groups do not divide: fused_gn launches = (shards + 1) x dates (the
    straddling groups launched once a date) and the same bits again.
    The per-date walls beside the unsharded run's and the peak device
    bytes."""
    import torch

    from kafka_tpu_torch.core.fused_gn import _block, shard_launches
    from kafka_tpu_torch.shard import make_pixel_mesh

    cuda = device.type == "cuda"
    failures = []

    def peak_reset():
        if cuda:
            _mem().reset_peak(device)

    def peak():
        return _mem().peak_bytes(device) if cuda else None

    def tile_on(shards: int) -> dict:
        mesh = make_pixel_mesh([device] * shards)
        peak_reset()
        reset_launches()
        kf, out, run_s, final = tip_tile_run(device, ny, nx, seed,
                                             final=True, mesh=mesh)
        launches = launch_counts()
        dates, base = kf.diagnostics_log, main_run["kf"].diagnostics_log
        n_pad = kf.gather.n_pad
        rec = {"shards": shards, "tile": [ny, nx], "n_pad": n_pad,
               "shard_px": n_pad // shards,
               "group_px": _block(n_pad, 2048),
               "groups_divide_shards": (n_pad // shards)
               % _block(n_pad, 2048) == 0,
               "launches_per_date": shard_launches(n_pad, shards),
               "kernel_launches": launches, "run_s": run_s,
               "n_iterations": [r["n_iterations"] for r in dates],
               "unsharded_n_iterations": [r["n_iterations"] for r in base],
               "date_wall_s": [r["wall_s"] for r in dates],
               "unsharded_date_wall_s": [r["wall_s"] for r in base],
               "peak_device_bytes": peak(),
               **mesh_compare(main_run, {"out": out, "final": final})}
        label = f"tile on {shards} shards"
        if len(dates) != len(base) or launches["fused_gn"] != \
                rec["launches_per_date"] * len(dates):
            failures.append(f"{label}: {launches['fused_gn']} fused_gn "
                            f"launches for {len(dates)} dates")
        if launches["fused_update"] or launches["solve_rows"]:
            failures.append(f"{label}: launches {launches}")
        if not rec["bit_identical"]:
            failures.append(f"{label}: same bits False")
        return rec

    tip = tile_on(MESH_SHARDS)
    split = tile_on(MESH_SPLIT_SHARDS)
    if split["groups_divide_shards"]:
        failures.append(f"tile on {MESH_SPLIT_SHARDS} shards: the groups "
                        "divide the shards")

    mesh = make_pixel_mesh([device] * MESH_SHARDS)
    peak_reset()
    reset_launches()
    kf, out, x0, p_inv0, grid, obs_days = s2_tile_filter(
        device, s2_ny, s2_nx, seed, mesh=mesh)
    t0 = time.perf_counter()
    x_a, _, p_inv_a = kf.run(grid, x0, None, p_inv0)
    _sync(device)
    s2_run_s = time.perf_counter() - t0
    launches = launch_counts()
    dates, base_dates = kf.diagnostics_log, s2_run["kf"].diagnostics_log
    iterations = sum(r["n_iterations"] for r in dates)
    s2 = {"shards": MESH_SHARDS, "tile": [s2_ny, s2_nx],
          "n_pad": kf.gather.n_pad,
          "shard_px": kf.gather.n_pad // mesh.size,
          "kernel_launches": launches, "run_s": s2_run_s,
          "iterations": iterations,
          "n_iterations": [r["n_iterations"] for r in dates],
          "unsharded_n_iterations": [r["n_iterations"]
                                     for r in base_dates],
          "fused": [r.get("fused") for r in dates],
          "date_wall_s": [r["wall_s"] for r in dates],
          "unsharded_date_wall_s": [r["wall_s"] for r in base_dates],
          "peak_device_bytes": peak(),
          **mesh_compare(s2_run, {"out": out, "final": (x_a, p_inv_a)})}
    del kf, out, x_a, p_inv_a
    upd = launches["fused_update_by_instance"].get("10x10", 0)
    if len(dates) != len(base_dates) or iterations == 0 or \
            upd != mesh.size * iterations or launches["fused_gn"]:
        failures.append(f"s2: {launches} for {iterations} iterations on "
                        f"{mesh.size} shards")
    pz_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "chip_smoke_mesh_profilez")
    shutil.rmtree(pz_dir, ignore_errors=True)
    try:
        pz = mesh_profilez(device, tip["n_pad"], pz_dir)
    finally:
        shutil.rmtree(pz_dir, ignore_errors=True)
    if cuda and (pz["captures"] < MESH_CAPTURES
                 or pz["captures_missing_a_shard"]
                 or pz["switches_off_the_caller"]):
        failures.append(
            f"profilez on the mesh: {pz['captures']} captures, "
            f"{pz['captures_missing_a_shard']} missing a shard's fused_gn, "
            f"{pz['switches_off_the_caller']} switches off the caller "
            f"({pz['switched_on']}); answers {pz['answers']}")
    for label, r in (("tile", tip), ("split tile", split), ("s2", s2)):
        if r["x_max_abs_err"] > MESH_X_ATOL or \
                r["final_x_max_abs_err"] > MESH_X_ATOL:
            failures.append(f"{label}: x off by {r['x_max_abs_err']} / "
                            f"{r['final_x_max_abs_err']}")
        if r["sigma_max_abs_err"] > MESH_X_ATOL:
            failures.append(f"{label}: sigma off by "
                            f"{r['sigma_max_abs_err_by_date']}")
        if r["final_p_inv_entries_beyond_budget"]:
            failures.append(f"{label}: "
                            f"{r['final_p_inv_entries_beyond_budget']} P^-1 "
                            "entries beyond the budget")
        if not r["solver_qa_equal"]:
            failures.append(f"{label}: QA verdicts differ")
    rec = {"phase": "mesh", "mesh": [str(d) for d in mesh.devices],
           "tip_tile": tip, "tip_tile_split_groups": split,
           "s2_subtile": s2, "profilez": pz, "failures": failures}
    emit(rec)
    if failures:
        raise AssertionError("mesh: " + "; ".join(failures))
    return rec


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_all(procs, timeout_s: float) -> list:
    """Each process's exit code; any still running at ``timeout_s`` is
    killed (and waited for) and the phase fails."""
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stuck = [p for p in procs if p.poll() is None]
        for p in stuck:
            p.kill()
            p.wait(timeout=60)
    if stuck:
        raise AssertionError(f"{len(stuck)} child process(es) outlived "
                             f"{timeout_s} s and were killed")
    return [p.returncode for p in procs]


def tif_names(folder: str) -> list:
    return sorted(f for f in os.listdir(folder) if f.endswith(".tif"))


def rasters_equal(dir_a: str, dir_b: str, names=None) -> dict:
    """Every GeoTIFF of ``dir_a`` (or ``names``) against ``dir_b``'s bit
    for bit: ``{"compared", "differing", "missing"}``."""
    names = tif_names(dir_a) if names is None else names
    present = set(tif_names(dir_b))
    missing = [n for n in names if n not in present]
    have = [n for n in names if n in present]
    a = read_rasters([os.path.join(dir_a, n) for n in have])
    b = read_rasters([os.path.join(dir_b, n) for n in have])
    differing = [n for n, u, v in zip(have, a, b)
                 if u.shape != v.shape or u.tobytes() != v.tobytes()]
    return {"compared": len(have), "differing": differing[:8],
            "n_differing": len(differing), "missing": missing[:8]}


def phase_distributed(device, workdir: str, ny: int = TILE, nx: int = TILE,
                      chunk: int = CHUNK_PX):
    """``run_modis_distributed`` over phase cli_modis's MCD43 tile and
    windows (its files in ``workdir``) in CHUNK_PX chunks: once in this
    process (every chunk), then as two ranks of ``python -m
    kafka_tpu_torch.cli.run_modis_distributed --num-processes 2
    --process-index i`` that meet at a gloo rendezvous on localhost and
    share the card.  Gates: each rank ran its round-robin half of the
    chunks, each rank's all_reduce of the counts equals the one-process
    run's, every .done marker, and every raster bit-identical to the
    one-process run.  Each rank's peak device bytes are printed."""
    import torch

    from kafka_tpu_torch.cli import drivers
    from kafka_tpu_torch.cli import run_modis_distributed as dist
    from kafka_tpu_torch.io import get_chunks

    t_phase = time.perf_counter()
    cfg = dist.default_config()
    cfg.end = CLI_MODIS_END
    cfg.extra["period"] = 1
    cfg.chunk_size = (chunk, chunk)
    cfg.data_folder = os.path.join(workdir, "mcd43")
    cfg.state_mask = os.path.join(workdir, "mask.tif")
    cfg_path = os.path.join(workdir, "distributed.json")
    cfg.save(cfg_path)
    n_chunks = len(list(get_chunks(nx, ny, cfg.chunk_size)))
    one, two = (os.path.join(workdir, d) for d in ("dist_one", "dist_two"))
    argv = ["--config", cfg_path, "--device", str(device)]
    cuda = device.type == "cuda"
    if cuda:
        _mem().reset_peak(device)
    reset_launches()
    stats, printed, one_s = run_driver(dist.main, argv + ["--outdir", one])
    launches = launch_counts()
    failures = []
    if printed != stats or stats["run"] != n_chunks:
        failures.append(f"one process: {stats}")
    if launches["fused_gn"] != stats["dates_assimilated"] or \
            stats["dates_assimilated"] == 0:
        failures.append(f"one process: {launches} for "
                        f"{stats['dates_assimilated']} chunk-dates")

    port = _free_port()
    logs = [os.path.join(workdir, f"rank_{i}.log") for i in range(2)]
    t0 = time.perf_counter()
    procs = []
    for i in range(2):
        with open(logs[i], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "kafka_tpu_torch.cli.run_modis_distributed", *argv,
                 "--outdir", two, "--num-processes", "2",
                 "--process-index", str(i),
                 "--coordinator", f"localhost:{port}"],
                env=drivers.child_env(), stdout=log, stderr=subprocess.STDOUT))
    rcs = _wait_all(procs, CHILD_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for i, (rc, path) in enumerate(zip(rcs, logs)):
        text = open(path, errors="replace").read()
        if rc != 0:
            failures.append(f"rank {i} rc={rc}: {text[-1500:]}")
            ranks.append(None)
            continue
        ranks.append(json.loads(text.strip().splitlines()[-1]))
    summed = ("run", "pixels", "dates_assimilated", "chunks_with_pixels")
    for i, r in enumerate(ranks):
        if r is None:
            continue
        if r["run"] != n_chunks // 2:
            failures.append(f"rank {i} ran {r['run']} chunks")
        if {k: r["all_ranks"][k] for k in summed} != \
                {k: stats[k] for k in summed}:
            failures.append(f"rank {i} all_reduce {r['all_ranks']} != the "
                            f"one-process run's counts")
    markers = sorted(f for f in os.listdir(two) if f.endswith(".done"))
    if len(markers) != n_chunks:
        failures.append(f"{len(markers)} .done markers of {n_chunks}")
    t0 = time.perf_counter()
    same = rasters_equal(one, two)
    if same["n_differing"] or same["missing"] or not same["compared"] or \
            tif_names(two) != tif_names(one):
        failures.append(f"rasters: {same}")
    rec = {
        "phase": "distributed", "tile": [ny, nx], "chunk": [chunk, chunk],
        "chunks": n_chunks, "windows": len(cfg.time_grid()) - 1,
        "one_process": {"stats": stats, "wall_s": one_s,
                        "kernel_launches": launches,
                        "peak_device_bytes": (
                            _mem().peak_bytes(device)
                            if cuda else None)},
        "ranks": [None if r is None else {
            k: r.get(k) for k in ("run", "assigned", "skipped", "wall_s",
                                  "all_ranks", "peak_device_bytes")}
            for r in ranks],
        "ranks_wall_s": ranks_s, "rasters": same,
        "seconds": {"compare": time.perf_counter() - t0,
                    "phase": time.perf_counter() - t_phase},
        "failures": failures,
    }
    emit(rec)
    if failures:
        raise AssertionError("distributed: " + "; ".join(failures))
    return rec


def _lease_holder(folder: str, skip_pid: int):
    """(prefix, pid) of a lease in ``folder`` held by another process than
    ``skip_pid``, or None."""
    for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else ():
        if not name.endswith(".lease"):
            continue
        try:
            with open(os.path.join(folder, name)) as f:
                lease = json.load(f)
        except (OSError, ValueError):
            continue
        pid = lease.get("pid")
        if isinstance(pid, int) and pid != skip_pid:
            return lease.get("prefix"), pid
    return None


def _reclaims(tel_dir: str) -> int:
    """``kafka_scheduler_reclaims_total`` of a worker's metrics.json (0
    when it has none)."""
    path = os.path.join(tel_dir, "metrics.json")
    if not os.path.exists(path):
        return 0
    series = json.load(open(path)).get(
        "kafka_scheduler_reclaims_total", {}).get("series", [])
    return int(sum(s["value"] for s in series))


def phase_queue(device, workdir: str, ny: int = TILE, nx: int = TILE,
                chunk: int = CHUNK_PX):
    """``run_synthetic --operator twostream --ny 2400 --nx 2400
    --chunk-size 1200 --days QUEUE_DAYS``, first static in this process,
    then as the queue's local fleet (``--queue --num-workers 2`` with a
    QUEUE_TTL_S lease) in a child process: as soon as a worker holds a
    lease (the lease file names its pid) it is SIGKILLed.  Gates: the
    fleet reports the victim's -9 and the survivor's 0; the survivor
    reclaimed at least one lease; queue_status ends with every chunk done
    and no lease; every raster bit-identical to the static run, whose
    fused_gn launches equal its chunk-dates.  Then
    one chunk of phase distributed's config through the chunk_worker
    subprocess (``drivers._run_chunk_subprocess``): rc 0 and its rasters
    equal to phase distributed's one-process run's."""
    import re
    import signal

    from kafka_tpu_torch.cli import drivers, run_synthetic
    from kafka_tpu_torch.engine.config import RunConfig
    from kafka_tpu_torch.io import get_chunks
    from kafka_tpu_torch.shard.queue import queue_status

    t_phase = time.perf_counter()
    base = ["--operator", "twostream", "--ny", str(ny), "--nx", str(nx),
            "--days", str(QUEUE_DAYS), "--step", "4", "--chunk-size",
            str(chunk), "--device", str(device)]
    static, fleet, tel = (os.path.join(workdir, d) for d in
                          ("queue_static", "queue_fleet", "queue_tel"))
    reset_launches()
    stats, printed, static_s = run_driver(run_synthetic.main,
                                          base + ["--outdir", static])
    launches = launch_counts()
    failures = []
    n_chunks = len(list(get_chunks(nx, ny, (chunk, chunk))))
    # One fused_gn launch per chunk-date, as in phase distributed.
    if printed != stats or stats["chunks_run"] != n_chunks or \
            stats["failed"] or launches["fused_gn"] == 0 or \
            launches["fused_gn"] != stats["chunks_run"] * stats["n_dates"]:
        failures.append(f"static run: {stats}, launches {launches}")

    log_path = os.path.join(workdir, "queue_fleet.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        parent = subprocess.Popen(
            [sys.executable, "-m", "kafka_tpu_torch.cli.run_synthetic",
             *base, "--queue", "--num-workers", "2", "--lease-ttl-s",
             str(QUEUE_TTL_S), "--outdir", fleet, "--telemetry-dir", tel],
            env=drivers.child_env(), stdout=log, stderr=subprocess.STDOUT)
    victim = None
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while victim is None and parent.poll() is None and \
                time.monotonic() < deadline:
            victim = _lease_holder(fleet, parent.pid)
            if victim is None:
                # kafkalint: disable=ad-hoc-retry — harness poll for the
                # child that holds a lease, bounded by its deadline.
                time.sleep(0.02)
        if victim is not None:
            os.kill(victim[1], signal.SIGKILL)
            kill_s = time.perf_counter() - t0
    finally:
        rc = _wait_all([parent], CHILD_TIMEOUT_S)[0]
    fleet_s = time.perf_counter() - t0
    text = open(log_path, errors="replace").read()
    found = re.search(r"all: \[(-?\d+), (-?\d+)\]", text)
    worker_rcs = None if found is None else \
        [int(found.group(1)), int(found.group(2))]
    if victim is None:
        failures.append(f"no worker lease seen (fleet rc={rc}): "
                        f"{text[-1500:]}")
    elif rc == 0 or worker_rcs is None or sorted(worker_rcs) != [-9, 0]:
        failures.append(f"fleet rc={rc}, worker rcs {worker_rcs}: "
                        f"{text[-1500:]}")
    reclaims = {w: _reclaims(os.path.join(tel, w))
                for w in ("worker_0", "worker_1")}
    if sum(reclaims.values()) < 1:
        failures.append(f"no reclaimed lease: {reclaims}")
    status = queue_status(fleet)
    counts = status["counts"]
    if (counts["done"], counts["leased"], counts["lease_expired"],
            counts["pending"], counts["failed"]) != (n_chunks, 0, 0, 0, 0):
        failures.append(f"queue_status {counts}")
    same = rasters_equal(static, fleet)
    if same["n_differing"] or same["missing"] or not same["compared"] or \
            tif_names(fleet) != tif_names(static):
        failures.append(f"fleet rasters: {same}")

    cfg = RunConfig.load(os.path.join(workdir, "distributed.json"))
    cfg.output_folder = os.path.join(workdir, "worker_out")
    os.makedirs(cfg.output_folder)
    first = list(get_chunks(nx, ny, cfg.chunk_size))[0]
    prefix = f"{first.chunk_no:04x}"
    t0 = time.perf_counter()
    w_rc, w_summary = drivers._run_chunk_subprocess(cfg, first, prefix,
                                                    device=str(device))
    worker_s = time.perf_counter() - t0
    ref_dir = os.path.join(workdir, "dist_one")
    mine = [n for n in tif_names(ref_dir) if chunk_prefix(n) == prefix]
    w_same = rasters_equal(ref_dir, cfg.output_folder, mine)
    if w_rc != 0 or not mine or w_same["n_differing"] or \
            w_same["missing"] or tif_names(cfg.output_folder) != mine:
        failures.append(f"chunk_worker rc={w_rc}, rasters {w_same}")
    rec = {
        "phase": "queue", "tile": [ny, nx], "chunk": [chunk, chunk],
        "chunks": n_chunks,
        "reduced": {"windows": f"2 of the driver's default 4 (--days "
                               f"{QUEUE_DAYS}, --step 4: windows ending "
                               "day 4 and day 8)"},
        "static": {"summary": stats, "wall_s": static_s,
                   "kernel_launches": launches},
        "fleet": {"rc": rc, "worker_rcs": worker_rcs,
                  "victim": None if victim is None else
                  {"prefix": victim[0], "killed_after_s": kill_s},
                  "reclaims": reclaims, "lease_ttl_s": QUEUE_TTL_S,
                  "wall_s": fleet_s, "queue_status": counts,
                  "rasters": same},
        "chunk_worker": {"rc": w_rc, "summary": w_summary,
                         "wall_s": worker_s, "rasters": w_same},
        "seconds": {"phase": time.perf_counter() - t_phase},
        "failures": failures,
    }
    emit(rec)
    if failures:
        raise AssertionError("queue: " + "; ".join(failures))
    return rec


#: phase device_plane: run_synthetic over phase cli's tile and mask, 4
#: one-acquisition windows, no checkpoint; run 2 adds the telemetry dir,
#: the live endpoint and a capture of DEVICE_PLANE_PROFILE_WINDOWS.
DEVICE_PLANE_ARGS = ("--operator", "twostream", "--days", "16", "--step",
                     "4", "--obs-every", "4")
DEVICE_PLANE_PROFILE_WINDOWS = 2
#: the assimilated dates of each device_plane run: one fused_gn launch
#: each.
DEVICE_PLANE_DATES = 4
#: the kernel table's row of the fused Gauss-Newton kernel.
FUSED_GN_KERNEL = "fused_gn_kernel"
#: the capture's ms per fused_gn launch against phase kernel's CUDA-event
#: time of the kernel (another date, other trips): within these factors.
CAPTURE_MS_RANGE = (0.5, 2.0)
#: the device-plane metric names (the JAX package's); the serving
#: daemon with a fleet dir alone owns FLEET_NAMES.
DEVICE_PLANE_NAMES = (
    "kafka_compile_program_seconds", "kafka_device_memory_bytes_in_use",
    "kafka_device_memory_headroom_bytes", "kafka_device_memory_peak_bytes",
    "kafka_devprof_captures_parsed_total",
    "kafka_devprof_collective_fraction", "kafka_devprof_kernel_ms_total",
    "kafka_devprof_live_buffer_bytes", "kafka_devprof_live_buffers",
    "kafka_devprof_parse_failures_total", "kafka_engine_device_reads_total",
    "kafka_fleet_dead_hosts", "kafka_health_probe_device_ms",
    "kafka_health_probe_host_ms", "kafka_health_unhealthy",
    "kafka_httpd_requests_total", "kafka_live_publish_errors_total",
    "kafka_live_snapshots_total", "kafka_perf_capture_evictions_total",
    "kafka_perf_device_fraction", "kafka_perf_phase_fraction",
    "kafka_perf_profile_captures_total", "kafka_perf_px_steps_per_s",
    "kafka_perf_roofline_utilization", "kafka_slo_alerts_fired_total",
    "kafka_slo_alerts_firing", "kafka_slo_evaluations_total")
FLEET_NAMES = ("kafka_fleet_dead_hosts",)
#: device readings a fresh process takes after its gated probe round
#: (recorded: how the reading moves as the process warms).
FRESH_PROBE_READINGS = 4
#: phase serve's requests the device-plane server answers again.
DEVICE_PLANE_SERVE = ("cold", "cache", "warm")
#: the tiles those requests ask for (tile0 of phase serve's two).
DEVICE_PLANE_SERVE_TILES = ("tile0",)


def fresh_probe() -> None:
    """Phase device_plane's child process: one probe round
    (``health.probe_health`` with no wait before its retry; on the card
    the device probe runs fused_gn), then FRESH_PROBE_READINGS more
    device readings on a card.  Prints the verdict and the readings as
    one JSON line."""
    import torch

    from kafka_tpu_torch.telemetry import health
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use

    t0 = time.perf_counter()
    with use(MetricsRegistry()):
        verdict = health.probe_health(retry_wait_s=0.0)
        later = [health.probe_device() for _ in range(FRESH_PROBE_READINGS)
                 ] if torch.cuda.is_available() else []
    print(json.dumps({**verdict, "later_device_ms": later,
                      "probe_s": time.perf_counter() - t0}), flush=True)


def http_get(url: str, timeout: float = 120.0) -> tuple:
    """``(status, body text)`` of a GET; an HTTP error status is returned,
    not raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode("utf-8", "replace")


class Scraper:
    """A thread that GETs ``paths`` of a live endpoint every
    ``interval_s`` until stopped, keeping each path's last 200 answer.
    Connection errors (before the endpoint is up, after it closed) are
    counted."""

    def __init__(self, base: str, paths, interval_s: float = 0.5):
        import threading

        self.base, self.paths = base, tuple(paths)
        self.interval_s = interval_s
        self.last, self.answers, self.errors = {}, {}, 0
        self.stop_event = threading.Event()
        # kafkalint: disable=untracked-thread — an external scraper's
        # model: it reads the endpoint as another process would, outside
        # the run's trace.
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="chip-smoke-scraper")

    def _get(self, path):
        status, body = http_get(self.base + path)
        self.answers.setdefault(path, []).append(status)
        if status == 200:
            self.last[path] = body
        return status, body

    def _run(self):
        while True:
            for path in self.paths:
                try:
                    self._get(path)
                except OSError:
                    self.errors += 1
            if self.stop_event.wait(self.interval_s):
                return

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop_event.set()
        self.thread.join(timeout=300)


def prom_values(text: str) -> dict:
    """name -> {sorted label tuple: value} of a Prometheus text page
    (the port's own parser, which also checks the format)."""
    from kafka_tpu_torch.telemetry.aggregate import parse_prom_text

    return {name: {tuple(sorted(s["labels"].items())): s["value"]
                   for s in fam["samples"]}
            for name, fam in parse_prom_text(text).items()}


def prom_names(text: str) -> set:
    """Every metric family named on a Prometheus text page (its HELP and
    TYPE lines, samples or not)."""
    from kafka_tpu_torch.telemetry.aggregate import parse_prom_text

    return set(parse_prom_text(text))


def engine_dispatches(filters) -> int:
    """Solve dispatches of the filters' runs: one per unfused window and
    one per fused block (its windows' records carry ``fused`` k)."""
    n = 0.0
    for kf in filters:
        for rec in kf.diagnostics_log:
            n += 1.0 / rec["fused"] if "fused" in rec else 1.0
    return int(round(n))


def phase_device_plane(device, workdir: str, kernel_ms=None,
                       serve_shas=None, ny: int = TILE, nx: int = TILE,
                       seed: int = 0, probe_n: int = 1 << 19):
    """The device plane on the card, in three parts.

    a. ``run_synthetic`` (DEVICE_PLANE_ARGS) over phase cli's tile and
       mask twice: plain, then with ``--telemetry-dir``, ``--http-port``
       and ``--profile-windows`` while a thread scrapes ``/metrics``,
       ``/kernelz`` and ``/meshz`` and, once the capture has stopped,
       ``/healthz?probe=1``.  Gates: run 2's rasters the bits of run 1's;
       ``kafka_engine_device_reads_total`` equal to the engine's
       dispatches in each run; the fused_gn launches counted at the
       launch site, less the probe's solves (from its answer), equal to
       the DEVICE_PLANE_DATES dates in each run; the capture parsed, its kernel table's
       ``fused_gn_kernel`` row counting the fused_gn launches made while
       it ran, at CAPTURE_MS_RANGE of ``kernel_ms`` a launch (phase
       kernel's CUDA-event time; not gated when None, as in a CPU
       rehearsal); the gn_inkernel roofline gauge in (0, 1.05];
       throughput above 0; the peak memory gauge above 0 and at most the
       card's bytes; every DEVICE_PLANE_NAMES name but FLEET_NAMES on
       the scraped ``/metrics``.
    b. ``health.probe_health()`` on the idle card: fused_gn launches grow
       by the probe's solves and the verdict is healthy; a probe round in
       a fresh process (``fresh_probe``, what a newly started daemon's
       readiness check meets) healthy on its first reading.  Then a real
       ``torch.cuda.OutOfMemoryError`` (one allocation larger than the
       card) under a flight recorder: the crash dump carries the
       forensics (memory stats, a non-empty allocator census), and a
       fused_gn launch after it still holds to its plain version.  Then
       ``/profilez?seconds=1`` asked on a handler thread while this
       thread launches fused_gn: this thread switches the capture's
       tracing on and off, and the capture holds those kernels.
    c. ``kafka_serve`` (phase serve's tiles and grid) with the fleet-plane
       flags, answering phase serve's cold, cache and warm requests of
       DEVICE_PLANE_SERVE_TILES (one tile: the smoke's time limit):
       every ``x_sha256`` equal to phase serve's (``serve_shas``), live
       snapshots in the fleet dir, ``/alertz`` (the SLO endpoint)
       answering, all DEVICE_PLANE_NAMES on ``/metrics``, nothing shed.
    """
    import contextlib
    import io
    import threading

    import torch

    from kafka_tpu_torch.cli import drivers, kafka_serve, run_synthetic as rs
    from kafka_tpu_torch.core import fused_gn
    from kafka_tpu_torch.io import read_geotiff, write_geotiff
    from kafka_tpu_torch.serve import (read_response, submit_request,
                                       synthetic_dates)
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE
    from kafka_tpu_torch.telemetry import (devprof, flight_recorder,
                                           get_registry, health, perf)
    from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use
    from kafka_tpu_torch.testing.fixtures import DEFAULT_GEO

    t_phase = time.perf_counter()
    failures = []
    mask_path = os.path.join(workdir, "dp_mask.tif")
    write_geotiff(mask_path, land_mask(ny, nx, seed).astype(np.uint8),
                  DEFAULT_GEO)
    base = [*DEVICE_PLANE_ARGS, "--ny", str(ny), "--nx", str(nx), "--mask",
            mask_path, "--device", str(device)]

    # -- a. the engine, twice -------------------------------------------
    runs = {}
    capture = {}
    real_start, real_stop = perf.start_windowed_capture, \
        perf.stop_windowed_capture
    probe = {}

    def start_capture(*args, **kwargs):
        capture["launches_at_start"] = fused_gn.fused_gn_rows.launches
        return real_start(*args, **kwargs)

    def stop_capture(*args, **kwargs):
        stopping = perf._windowed["directory"] and \
            "launches_at_stop" not in capture
        if stopping:
            capture["launches_at_stop"] = fused_gn.fused_gn_rows.launches
        out = real_stop(*args, **kwargs)
        if stopping:
            url = f"http://127.0.0.1:{port}"
            # The capture has just been parsed: /kernelz must show it
            # now, while the run goes on.
            capture["kernelz"] = http_get(url + "/kernelz?json=1")
            # The health probe, asked from a thread of its own while the
            # run goes on (after the capture, so its launches stay out of
            # the captured count); joined after the run.
            # kafkalint: disable=untracked-thread — an HTTP client of
            # the endpoint, outside the run's trace.
            probe["thread"] = threading.Thread(
                target=lambda: probe.update(
                    answer=http_get(url + "/healthz?probe=1")),
                daemon=True)
            probe["thread"].start()
        return out

    for name in ("plain", "device_plane"):
        outdir = os.path.join(workdir, f"dp_{name}")
        argv = base + ["--outdir", outdir]
        filters = []
        real_kf = rs.KalmanFilter

        def make_kf(*args, **kwargs):
            kf = real_kf(*args, **kwargs)
            filters.append(kf)
            return kf

        scraper = contextlib.nullcontext()
        if name == "device_plane":
            tel = os.path.join(workdir, "dp_tel")
            port = _free_port()
            argv += ["--telemetry-dir", tel, "--http-port", str(port),
                     "--profile-windows", str(DEVICE_PLANE_PROFILE_WINDOWS)]
            scraper = Scraper(f"http://127.0.0.1:{port}",
                              ("/metrics", "/kernelz?json=1",
                               "/meshz?json=1"))
        reset_launches()
        with use(MetricsRegistry()), scraper, patched(
                (rs, "KalmanFilter", make_kf),
                (perf, "start_windowed_capture", start_capture),
                (perf, "stop_windowed_capture", stop_capture)):
            stats, printed, wall = run_driver(rs.main, argv)
            # The run's registry (--telemetry-dir configures its own).
            reg = get_registry()
            if "thread" in probe:
                probe["thread"].join(timeout=300)
        launches = launch_counts()
        # The fused_gn launches of the engine: the run's count at the
        # launch site less the health probe's (run 2 asks for one during
        # the run), which its answer accounts for.
        probe_solves = 0
        if name == "device_plane":
            body = json.loads((probe.get("answer") or (0, "{}"))[1] or "{}")
            if body.get("probe_device_ms") is not None:
                probe_solves = health.probe_solves() * (
                    2 if body.get("probe_retried") else 1)
        runs[name] = {
            "wall_s": wall, "summary": stats, "outdir": outdir,
            "kernel_launches": launches,
            "dates": sum(len(kf.diagnostics_log) for kf in filters),
            "probe_solves": probe_solves,
            "engine_fused_gn_launches": launches["fused_gn"] - probe_solves,
            "dispatches": engine_dispatches(filters),
            "device_reads": reg.value("kafka_engine_device_reads_total"),
            "registry": reg, "scraper": scraper}
        if runs[name]["device_reads"] != runs[name]["dispatches"]:
            failures.append(
                f"{name}: kafka_engine_device_reads_total "
                f"{runs[name]['device_reads']} != dispatches "
                f"{runs[name]['dispatches']}")
        if not runs[name]["engine_fused_gn_launches"] == \
                runs[name]["dates"] == DEVICE_PLANE_DATES:
            failures.append(
                f"{name}: {runs[name]['engine_fused_gn_launches']} engine "
                f"fused_gn launches ({launches['fused_gn']} less the "
                f"probe's {probe_solves}) against "
                f"{runs[name]['dates']} dates, expected "
                f"{DEVICE_PLANE_DATES}")
    differ = [n for n in tif_names(runs["plain"]["outdir"])
              if not same_bits(*(read_geotiff(os.path.join(
                  runs[k]["outdir"], n))[0] for k in
                  ("plain", "device_plane")))]
    if differ or tif_names(runs["plain"]["outdir"]) != \
            tif_names(runs["device_plane"]["outdir"]):
        failures.append(f"device-plane run rasters differ: {differ[:5]}")
    dp = runs["device_plane"]
    reg, scraper = dp["registry"], dp["scraper"]
    sessions = devprof.find_capture_sessions(os.path.join(tel, "profile"))
    table = devprof.parse_capture(sessions[-1]) if sessions else None
    kernels = (table or {}).get("kernels") or []
    gn_row = next((k for k in kernels if FUSED_GN_KERNEL in k["name"]),
                  None)
    captured = capture.get("launches_at_stop", 0) - \
        capture.get("launches_at_start", 0)
    ms_per_launch = None
    if table is None:
        failures.append(f"the capture under {tel} did not parse")
    elif gn_row is None or gn_row["count"] != captured or captured <= 0:
        failures.append(f"kernel table row {gn_row} against {captured} "
                        "fused_gn launches in the captured windows")
    else:
        ms_per_launch = gn_row["ms"] / gn_row["count"]
        if kernel_ms is not None and not (
                CAPTURE_MS_RANGE[0] * kernel_ms <= ms_per_launch
                <= CAPTURE_MS_RANGE[1] * kernel_ms):
            failures.append(f"capture ms/launch {ms_per_launch} outside "
                            f"{CAPTURE_MS_RANGE} x {kernel_ms}")
    # The gauges as the run left them (a scrape may predate the last
    # window); the names as the live endpoint served them.
    metrics = scraper.last.get("/metrics", "")
    values = prom_values(reg.prom_text())
    util = (values.get("kafka_perf_roofline_utilization") or {}).get(
        (("component", "gn_inkernel"),))
    if util is None or not 0.0 < util <= 1.05:
        failures.append(f"roofline utilization gn_inkernel {util}")
    px_rate = (values.get("kafka_perf_px_steps_per_s") or {}).get(())
    if not px_rate or px_rate <= 0:
        failures.append(f"kafka_perf_px_steps_per_s {px_rate}")
    peak = max((values.get("kafka_device_memory_peak_bytes") or {})
               .values(), default=None)
    card_bytes = _mem().mem_info(device)[1] \
        if device.type == "cuda" else None
    if device.type == "cuda" and (peak is None or not
                                  0 < peak <= card_bytes):
        failures.append(f"peak memory gauge {peak} against the card's "
                        f"{card_bytes} bytes")
    missing = sorted(set(DEVICE_PLANE_NAMES) - set(FLEET_NAMES)
                     - prom_names(metrics))
    if missing:
        failures.append(f"names missing from /metrics: {missing}")
    kernelz = json.loads((capture.get("kernelz") or (0, "{}"))[1])
    meshz = json.loads(scraper.last.get("/meshz?json=1", "{}"))
    status, healthz = probe.get("answer", (None, None))
    if not kernelz.get("captures_parsed") or not meshz.get("devices"):
        failures.append(f"/kernelz {kernelz.get('captures_parsed')}, "
                        f"/meshz {meshz.get('devices')}")
    if status not in (200, 503):
        failures.append(f"/healthz?probe=1 answered {status}")
    probe_live = {k: reg.value(k) for k in (
        "kafka_health_probe_device_ms", "kafka_health_probe_host_ms",
        "kafka_health_unhealthy")}
    if failures:
        # Parts b and c need a working engine path: stop here.
        emit({"phase": "device_plane", "part": "engine",
              "engine": {k: {"wall_s": r["wall_s"],
                             "dispatches": r["dispatches"],
                             "device_reads": r["device_reads"],
                             "kernel_launches": r["kernel_launches"],
                             "engine_fused_gn_launches":
                                 r["engine_fused_gn_launches"]}
                         for k, r in runs.items()},
              "top_kernels": kernels[:6], "failures": failures})
        raise AssertionError("device_plane: " + "; ".join(failures))

    # -- b. health probe and OOM forensics ------------------------------
    t_b = time.perf_counter()
    with use(MetricsRegistry()) as hreg:
        before = fused_gn.fused_gn_rows.launches
        verdict = health.probe_health()
        solves = {}
        if device.type != "cuda":
            # The CPU rehearsal: probe_health probes no device there; a
            # short probe of the plain version stands in.
            solves = {"ks": (1, 2), "reps": 1}
            health.probe_device(n_pix=probe_n, device=device, **solves)
            verdict["probe_device_ms"] = hreg.value(
                "kafka_health_probe_device_ms")
        probe_launches = fused_gn.fused_gn_rows.launches - before
    expected = (2 if verdict["probe_retried"] else 1) * \
        health.probe_solves(**solves)
    if probe_launches != expected:
        failures.append(f"probe launched fused_gn {probe_launches} times, "
                        f"expected {expected}")
    if device.type == "cuda" and verdict["unhealthy"]:
        failures.append(f"idle card unhealthy: {verdict}")
    # The state a newly started daemon's readiness check meets: one probe
    # round in a fresh process, its first reading gated (no retry).
    t_fresh = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.fresh_probe()"],
        env=drivers.child_env(),
        capture_output=True, text=True, timeout=300)
    fresh = {"rc": child.returncode,
             "wall_s": time.perf_counter() - t_fresh}
    try:
        fresh.update(json.loads(child.stdout.strip().splitlines()[-1]))
    except (IndexError, ValueError):
        fresh["stderr"] = child.stderr[-2000:]
    if child.returncode != 0 or "unhealthy" not in fresh:
        failures.append(f"fresh-process probe failed: {fresh}")
    elif device.type == "cuda" and (fresh["unhealthy"]
                                    or fresh["probe_retried"]):
        failures.append(f"fresh-process probe off-band: {fresh}")
    oom_dir = os.path.join(workdir, "dp_oom")
    hold = torch.empty(1 << 24, device=device)  # resident during the OOM
    oom = {"raised": None}
    with use(MetricsRegistry()):
        recorder = flight_recorder.FlightRecorder(oom_dir)
        too_big = (_mem().mem_info(device)[1] + (1 << 30)
                   if device.type == "cuda" else None)
        try:
            with recorder:
                if too_big is None:
                    raise torch.cuda.OutOfMemoryError(
                        "CUDA out of memory (CPU rehearsal)")
                torch.empty(too_big, dtype=torch.uint8, device=device)
        except torch.cuda.OutOfMemoryError as exc:
            oom["raised"] = type(exc).__name__
    del hold
    dumps = sorted(n for n in os.listdir(oom_dir)
                   if n.startswith("crash_")) if os.path.isdir(oom_dir) \
        else []
    forensics = (json.load(open(os.path.join(oom_dir, dumps[-1])))
                 .get("device_forensics") if dumps else None)
    if oom["raised"] is None or not forensics:
        failures.append(f"OOM raised {oom['raised']}, dumps {dumps}")
    elif device.type == "cuda" and (not forensics["memory"]
                                    or not forensics["buffer_census"]):
        failures.append(f"OOM forensics incomplete: {forensics}")
    rows = problem_rows(probe_n, device)
    after_oom = f64_rule(device, rows)
    if not after_oom["finite"] or after_oom["f64_quantile_rule"] or \
            after_oom["groups_differing"] or after_oom["verdicts_differing"]:
        failures.append(f"fused_gn after the OOM: {after_oom}")
    # /profilez: asked on an endpoint handler thread while this thread
    # launches fused_gn; this thread switches the CUDA tracing on and off
    # just after a launch (perf._on_launching_thread), and the capture
    # must hold those kernels.
    pz = {}
    with use(MetricsRegistry(os.path.join(workdir, "dp_profilez"))) as preg:
        httpd = TelemetryHTTPd(port=0, registry=preg).start()
        # kafkalint: disable=untracked-thread — an HTTP client of the
        # endpoint, outside the run's trace.
        asker = threading.Thread(target=lambda: pz.update(answer=http_get(
            httpd.url + "/profilez?seconds=1")), daemon=True)
        try:
            asker.start()
            while asker.is_alive():
                fused_gn.fused_gn_raw(**rows)
                _sync(device)
            asker.join(timeout=120)
        finally:
            httpd.close()
    pz_summary = devprof.kernel_summary(preg)
    pz_row = next((k for k in pz_summary["kernels"]
                   if FUSED_GN_KERNEL in k["name"]), None)
    pz_switched = next((e.get("switched_on") for e in preg.events
                        if e["event"] == "profile_capture"), None)
    if (pz.get("answer") or (None,))[0] != 200 or \
            (device.type == "cuda" and pz_row is None):
        failures.append(
            f"/profilez {pz.get('answer')}: no fused_gn row in "
            f"{[(k['name'][:60], k['count']) for k in pz_summary['kernels'][:5]]}"
            f" ({pz_summary['captures_parsed']} parsed, parse failures "
            f"{preg.value('kafka_devprof_parse_failures_total')}, "
            f"switched on {pz_switched})")
    elif device.type == "cuda" and pz_switched != ["MainThread"] * 2:
        failures.append(f"/profilez tracing switched on {pz_switched}, "
                        "not by the launching thread")
    # Beside a thread that launches no package kernel (a request's resume
    # and dump copies): recorded, not gated — the loss it records lies
    # in CUPTI's activity stream of a long-lived process, not in state
    # the port leaves behind (copier_profilez; ROADMAP Queue 3 item 7).
    copier = copier_profilez(device, rows,
                             os.path.join(workdir, "dp_copier"),
                             n_floats=ny * nx * 7)

    # -- c. the server with the fleet plane -----------------------------
    t_c = time.perf_counter()
    root = os.path.join(workdir, "dp_serve")
    fleet = os.path.join(workdir, "dp_fleet")
    dates = synthetic_dates(DEFAULT_BASE_DATE, SERVE_DAYS, 2)
    rids = {}
    for k, (label, date, smoothed, want) in enumerate(serve_ladder(dates)):
        if label not in DEVICE_PLANE_SERVE:
            continue
        for tile in DEVICE_PLANE_SERVE_TILES:
            rid = f"r{k:02d}_{tile}_{label}"
            rids[rid] = (tile, label, want)
            submit_request(root, {"request_id": rid, "tile": tile,
                                  "date": date.isoformat(),
                                  "smoothed": smoothed})
    port = _free_port()
    argv = ["--root", root, "--tiles", "2", "--operator", "twostream",
            "--ny", str(ny), "--nx", str(nx), "--days", str(SERVE_DAYS),
            "--step", "4", "--obs-every", "2", "--exit-when-idle",
            "--no-aot", "--telemetry-dir", fleet, "--fleet-dir", fleet,
            "--http-port", str(port), "--live-interval-s", "1",
            "--shed-slo", "--slo-fast-window-s", "60",
            "--slo-slow-window-s", "600", "--slo-interval-s", "1",
            "--device", str(device)]
    serve_scraper = Scraper(f"http://127.0.0.1:{port}",
                            ("/metrics", "/alertz?json=1"), interval_s=0.3)
    reset_launches()
    with use(MetricsRegistry()), serve_scraper, \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        summary = kafka_serve.main(argv)
        serve_s = time.perf_counter() - t0
    serve_launches = launch_counts()
    responses = {rid: read_response(root, rid) or {} for rid in rids}
    sha_diff = []
    for rid, (tile, label, want) in rids.items():
        r = responses[rid]
        if r.get("status") != "ok" or r.get("served_from") != want:
            failures.append(f"{rid}: {r.get('status')} "
                            f"{r.get('served_from')}")
        elif serve_shas is not None and \
                r.get("x_sha256") != serve_shas.get(f"{tile}:{label}"):
            sha_diff.append(rid)
    if sha_diff:
        failures.append(f"x_sha256 differ from phase serve: {sha_diff}")
    snaps = sorted(n for n in os.listdir(fleet) if n.startswith("live_"))
    if not snaps:
        failures.append("no live snapshot in the fleet dir")
    alertz = serve_scraper.last.get("/alertz?json=1")
    if alertz is None:
        failures.append("/alertz never answered")
    missing_serve = sorted(set(DEVICE_PLANE_NAMES) - prom_names(
        serve_scraper.last.get("/metrics", "")))
    if missing_serve:
        failures.append(f"names missing from the server's /metrics: "
                        f"{missing_serve}")
    if summary.get("rejected") or summary.get("errors") or \
            summary.get("failed"):
        failures.append(f"server summary {summary}")
    if serve_launches["fused_gn"] <= 0:
        failures.append("no fused_gn launch during the serve")

    rec = {
        "phase": "device_plane", "tile": [ny, nx],
        "argv": list(DEVICE_PLANE_ARGS),
        "engine": {k: {"wall_s": r["wall_s"], "dispatches": r["dispatches"],
                       "device_reads": r["device_reads"],
                       "kernel_launches": r["kernel_launches"],
                       "dates": r["dates"],
                       "probe_solves": r["probe_solves"],
                       "engine_fused_gn_launches":
                           r["engine_fused_gn_launches"]}
                   for k, r in runs.items()},
        "rasters_differing": len(differ),
        "capture": {"sessions": len(sessions),
                    "device_ms": None if table is None
                    else table["device_ms"],
                    "by_bucket": None if table is None
                    else table["by_bucket"],
                    "top_kernels": kernels[:6],
                    "fused_gn_launches_captured": captured,
                    "fused_gn_ms_per_launch": ms_per_launch,
                    "phase_kernel_ms": kernel_ms},
        "gauges": {"roofline_utilization_gn_inkernel": util,
                   "px_steps_per_s": px_rate, "peak_bytes": peak,
                   "card_bytes": card_bytes},
        "scrapes": {p: len(v) for p, v in scraper.answers.items()},
        "scrape_errors": scraper.errors,
        "healthz_probe": healthz, "probe_during_run": probe_live,
        "probe_idle": verdict, "probe_launches": probe_launches,
        "probe_fresh_process": fresh,
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "oom": {"raised": oom["raised"], "dump": dumps[-1:] or None,
                "memory": None if not forensics else forensics["memory"],
                "census_groups": None if not forensics
                else len(forensics["buffer_census"]),
                "census_top": None if not forensics
                else forensics["buffer_census"][:3]},
        "after_oom": {k: after_oom[k] for k in (
            "n_pix", "finite", "f64_quantile_rule", "groups_differing",
            "verdicts_differing")},
        "profilez_thread_fused_gn": pz_row,
        "profilez_switched_on": pz_switched,
        "profilez_beside_a_copier": copier,
        "serve": {"wall_s": serve_s, "summary": {
            k: summary.get(k) for k in ("admitted", "rejected", "errors",
                                        "http_port")},
            "requests": {rid: responses[rid].get("served_from")
                         for rid in rids},
            "sha_compared": serve_shas is not None,
            "live_snapshots": len(snaps),
            "alertz": None if alertz is None
            else json.loads(alertz).get("enabled"),
            "kernel_launches": serve_launches},
        "seconds": {"phase": time.perf_counter() - t_phase,
                    "engine": t_b - t_phase, "probe_oom": t_c - t_b,
                    "serve": time.perf_counter() - t_c},
        "failures": failures,
    }
    emit(rec)
    if failures:
        raise AssertionError("device_plane: " + "; ".join(failures))
    return rec


# -- /profilez captures by thread (phases mesh and device_plane) ---------

#: phase mesh: one-second /profilez captures across a 2-shard mesh run of
#: the tile (20 until phase operator_tools, 10 until phase bench needed
#: the smoke's time: ~1.7 s a capture); phase device_plane: captures
#: beside a thread that only copies (a request's resume and dump).
MESH_CAPTURES = 3
COPY_CAPTURES = 4
CAPTURE_SECONDS = 1.0
#: the thread of phase device_plane that copies and launches nothing.
COPIER_THREAD = "request-copier"
#: seconds between two sharded solves / two launches of the capture
#: loops: a few solves or launches a capture, not thousands.
MESH_PAUSE_S = 0.05
COPY_PAUSE_S = 0.05


def thread_ids() -> set:
    """The ids a capture may give the calling thread: its OS id (what the
    profiler records for a thread whose operators it traced) and the low
    32 bits of its pthread id (what CUPTI records for a thread it knows
    only by its CUDA calls)."""
    import threading

    return {threading.get_native_id(), threading.get_ident() & 0xFFFFFFFF}


def capture_launchers(session: str, match) -> tuple:
    """``({thread id: count}, summary)`` of one capture session: the GPU
    events ``match(event)`` selects, each traced back to the thread whose
    runtime call launched it (the CUDA runtime or driver event with the
    same ``correlation`` id; the id as the capture gives the thread), and
    the session's device events by category and runtime calls by thread
    id."""
    from kafka_tpu_torch.telemetry import devprof

    events, _ = devprof.load_capture_events(session)
    device = devprof.device_events(events)
    launcher, calls, kinds, out = {}, {}, {}, {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in (
                "cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launcher[corr] = e.get("tid")
            calls[str(e.get("tid"))] = calls.get(str(e.get("tid")), 0) + 1
    for e in device:
        kinds[e.get("cat")] = kinds.get(e.get("cat"), 0) + 1
        if match(e):
            tid = launcher.get((e.get("args") or {}).get("correlation"))
            out[tid] = out.get(tid, 0) + 1
    return out, {"device_events": kinds, "runtime_calls_by_tid": calls,
                 "events": len(events)}


def capture_by_thread(reg, match) -> dict:
    """The newest ``profile_capture`` of ``reg``, read at once (the
    endpoint keeps only its newest few captures on disk): the threads
    that switched its tracing, the GPU events ``match`` selects by the
    id of their launching thread, and a summary of the session (device
    events by category, runtime calls by thread id)."""
    from kafka_tpu_torch.telemetry import devprof

    e = [ev for ev in reg.events if ev["event"] == "profile_capture"][-1]
    by_tid, diag = {}, []
    for session in devprof.find_capture_sessions(e["directory"]):
        launched, summary = capture_launchers(session, match)
        diag.append(summary)
        for tid, n in launched.items():
            by_tid[tid] = by_tid.get(tid, 0) + n
    return {"switched_on": e.get("switched_on"), "wall_s": e.get("wall_s"),
            "by_tid": by_tid, "sessions": diag}


def profilez_loop(device, workdir: str, work, captures: int, read,
                  extra=None, pause_s: float = 0.0):
    """``captures`` sequential ``/profilez?seconds=CAPTURE_SECONDS`` asked
    on a handler thread of a TelemetryHTTPd over a registry in
    ``workdir``, each answered capture read at once by ``read(registry)``
    on the asking thread, while this thread calls ``work()`` in a loop,
    ``pause_s`` apart (which keeps each capture's trace, and its export,
    small), and ``extra``, a thread, runs beside it.  Returns
    ``(answers, reads, works)``."""
    import threading

    from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use

    answers, reads, works = [], [], 0
    with use(MetricsRegistry(workdir)) as reg:
        httpd = TelemetryHTTPd(port=0, registry=reg).start()

        def ask():
            for _ in range(captures):
                status, body = http_get(
                    httpd.url + f"/profilez?seconds={CAPTURE_SECONDS}")
                answers.append(status if status == 200
                               else [status, body[:160]])
                if status == 200:
                    reads.append(read(reg))

        # kafkalint: disable=untracked-thread — an HTTP client of the
        # endpoint, outside the run's trace.
        asker = threading.Thread(target=ask, daemon=True)
        try:
            if extra is not None:
                extra.start()
            asker.start()
            while asker.is_alive():
                work()
                _sync(device)
                works += 1
                # kafkalint: disable=ad-hoc-retry — the measured pause
                # between the launching thread's work items.
                time.sleep(pause_s)
            asker.join(timeout=120)
        finally:
            httpd.close()
    return answers, reads, works


def mesh_profilez(device, n_pix: int, workdir: str,
                  captures: int = MESH_CAPTURES) -> dict:
    """``captures`` one-second ``/profilez`` captures while this thread
    solves the tile's date on a pixel mesh of MESH_SHARDS shards of the
    card in a loop (``shard.step.sharded_solve``: every shard launches
    fused_gn from its own thread).  Each capture must hold fused_gn
    launches of every shard's thread, and every tracing switch must have
    been made on this (the caller's) thread, after the shards were
    joined (``core._build.shard_group``).  The shards launch at once, so
    their threads carry distinct ids: a capture holds every shard's
    launches when at least MESH_SHARDS threads other than this one
    launched fused_gn in it and the launches are whole solves (a switch
    falls between two solves).  Gated on the card only (the CPU's
    capture has no launching thread to trace)."""
    from kafka_tpu_torch.core import fused_gn
    from kafka_tpu_torch.shard import make_pixel_mesh
    from kafka_tpu_torch.shard.step import sharded_solve
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    mesh = make_pixel_mesh([device] * MESH_SHARDS)
    op, bands, x0, p_inv0 = make_tip_problem(n_pix, device=device)
    before = fused_gn.fused_gn_rows.launches
    answers, caps, solves = profilez_loop(
        device, workdir, lambda: sharded_solve(
            mesh, op.linearize, bands, x0, p_inv0, n_valid=n_pix),
        captures, lambda reg: capture_by_thread(
            reg, lambda e: FUSED_GN_KERNEL in str(e.get("name", ""))),
        pause_s=MESH_PAUSE_S)
    mine = thread_ids()
    launchers = [sorted(n for tid, n in c["by_tid"].items()
                        if tid not in mine) for c in caps]
    lost = sum(1 for ns in launchers
               if len(ns) < mesh.size or sum(ns) % mesh.size)
    switches = [t for c in caps for t in (c["switched_on"] or [])]
    return {"captures": len(caps), "answers": answers,
            "sharded_solves": solves, "n_pix": n_pix,
            "fused_gn_launches": fused_gn.fused_gn_rows.launches - before,
            "captures_missing_a_shard": lost,
            "switches_off_the_caller": sum(t != "MainThread"
                                           for t in switches),
            "switched_on": sorted(set(switches)),
            "fused_gn_by_launching_thread": launchers,
            "sessions": [c["sessions"] for c in caps]}


def copier_profilez(device, rows: dict, workdir: str, n_floats: int,
                    captures: int = COPY_CAPTURES) -> dict:
    """``captures`` one-second ``/profilez`` captures while this thread
    launches fused_gn in a loop and a thread that launches no package
    kernel (COPIER_THREAD) copies a tile's state to the card and back,
    as a request's resume and dump do.  Recorded, not gated: how many
    captures lost that thread's copies.  In a process that has run the
    smoke's phases up to ``cli`` with such captures between them, the
    lost captures' raw Kineto traces hold every thread's runtime calls
    but no GPU activity record of any thread (the launching thread's
    kernels included), and the loss grows with the GPU work the process
    has run; no thread, stream or profiler session of the port is left
    behind (MainThread alone at each capture), the phase run alone or
    the history without captures between phases loses none, and a gate
    that holds each switch until the copier is between copies does not
    prevent it (ROADMAP Queue 3 item 7, PERF.md §6, PR 17)."""
    import threading

    import torch

    from kafka_tpu_torch.core import fused_gn

    stop = threading.Event()
    copies = [0]
    host = torch.ones(n_floats, dtype=torch.float32)

    def copier():
        while not stop.is_set():
            back = host.to(device).cpu()
            copies[0] += int(back.numel() == n_floats)

    # kafkalint: disable=untracked-thread — synthetic copy load that
    # launches no package kernel; it records no span.
    extra = threading.Thread(target=copier, name=COPIER_THREAD,
                             daemon=True)
    try:
        answers, caps, launches = profilez_loop(
            device, workdir, lambda: fused_gn.fused_gn_raw(**rows),
            captures, lambda reg: capture_by_thread(
                reg, lambda e: str(e.get("cat", "")).lower() == "gpu_memcpy"),
            extra=extra, pause_s=COPY_PAUSE_S)
    finally:
        stop.set()
        if extra.is_alive():
            extra.join(timeout=60)
    mine = thread_ids()
    copier_copies = [sum(n for tid, n in c["by_tid"].items()
                         if tid not in mine) for c in caps]
    return {"captures": len(caps), "answers": answers,
            "launches": launches, "copies": copies[0],
            "bytes_per_copy": 4 * n_floats,
            "captures_without_copier_memcpy": copier_copies.count(0)
            + sum(a != 200 for a in answers),
            "switched_on": sorted({t for c in caps
                                   for t in (c["switched_on"] or [])}),
            "copier_memcpy_per_capture": copier_copies,
            "sessions": [c["sessions"] for c in caps]}


# -- phase contracts -------------------------------------------------------

#: the census fields the card's run of a program must share with the
#: CPU's.
CENSUS_FIELDS = ("primitives", "dtypes", "kernels", "host_syncs",
                 "collectives")
#: the flagship program run again at the MODIS tile's width (phase
#: main's 4,608,000 px): its census must equal the 256-px one; the
#: out-of-kernel row loop's is recorded (its linearisation may block).
FULL_WIDTH = 4_608_000
FULL_WIDTH_GATED = "date_twostream_inkernel"
FULL_WIDTH_RECORDED = "date_twostream_jac_to_rows"
SYNC_WARNING = "called a synchronizing CUDA operation"
CONTRACTS_LIMIT_S = 30.0


def kernel_nodes() -> dict:
    """The package kernels' launch counters as census node names."""
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.core.fused_update import fused_update_rows
    from kafka_tpu_torch.core.solve_rows import solve_rows

    out = {"fused_gn": fused_gn_rows.launches}
    out.update({f"fused_update[{p},{nb}]": n for (p, nb), n in
                fused_update_rows.launches_by_instance.items()})
    out.update({f"solve_rows[{r}]": n
                for r, n in solve_rows.route_launches.items()})
    return out


class CardRun:
    """The context of one program's counted run on the card: the CUDA
    sync debug mode set to ``warn`` (process-wide, reset after) with the
    synchronising warnings of every thread counted, the kernel launch
    counters read before and after, and the plain versions' calls on
    CUDA tensors counted."""

    def __init__(self, device):
        self.device = device
        self.syncs = 0
        self.launches = {}
        self.plain_calls = 0

    def __call__(self):
        return self

    def __enter__(self):
        import warnings

        import torch

        from kafka_tpu_torch.core import fused_gn, fused_update, solve_rows

        def counted(fn, at):
            def plain(*args, **kwargs):
                t = args[at] if len(args) > at else None
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    self.plain_calls += 1
                return fn(*args, **kwargs)
            return plain

        self._patches = patched(
            (fused_gn, "fused_gn_raw_plain",
             counted(fused_gn.fused_gn_raw_plain, 4)),
            (fused_update, "fused_update_raw_plain",
             counted(fused_update.fused_update_raw_plain, 6)),
            (solve_rows, "solve_rows_plain",
             counted(solve_rows.solve_rows_plain, 1)))
        self._patches.__enter__()
        self._before = kernel_nodes()
        self._warnings = warnings.catch_warnings(record=True)
        self._caught = self._warnings.__enter__()
        warnings.simplefilter("always")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        try:
            if self.device.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize(self.device)
        finally:
            self._warnings.__exit__(*exc)
            self._patches.__exit__(*exc)
        self.syncs = sum(SYNC_WARNING in str(w.message)
                         for w in self._caught)
        after = kernel_nodes()
        self.launches = {k: after[k] - self._before.get(k, 0)
                         for k in after if after[k] != self._before.get(k, 0)}
        return False


def census_of(tp) -> dict:
    return {f: getattr(tp, f) for f in CENSUS_FIELDS}


def census_diff(a: dict, b: dict) -> dict:
    """The census fields where ``a`` and ``b`` differ, each as its keys'
    ``[a, b]`` counts."""
    out = {}
    for f in CENSUS_FIELDS:
        x, y = a.get(f), b.get(f)
        if x == y:
            continue
        if not isinstance(x, dict) or not isinstance(y, dict):
            out[f] = [x, y]
            continue
        out[f] = {k: [x.get(k, 0), y.get(k, 0)]
                  for k in sorted(set(x) | set(y))
                  if x.get(k, 0) != y.get(k, 0)}
    return out


def contracts_gates(name: str, cpu: dict, card: dict, run: "CardRun",
                    findings: list, mismatches: int) -> list:
    """The failures of one program's pair of censuses (CPU, card):
    census fields unequal; the card's synchronising warnings not the
    census's host reads; the launch counters not moved by exactly the
    kernel nodes; a plain version called on CUDA tensors; a checker's
    finding; a tensor whose tracked placement was not where it lay; a
    host-to-device copy in the card's run (no host constant is copied
    per call: they come from ``core.device_constants``)."""
    out = []
    diff = census_diff(cpu, card)
    if card["host_syncs"].get("h2d"):
        out.append(f"{name}: {card['host_syncs']['h2d']} host-to-device "
                   "copies per run on the card")
    if diff:
        out.append(f"{name}: the card's census differs from the CPU's: "
                   f"{json.dumps(diff)[:600]}")
    if run.syncs != sum(card["host_syncs"].values()):
        out.append(f"{name}: {run.syncs} synchronising warnings on the "
                   f"card, census host reads {card['host_syncs']}")
    if run.launches != card["kernels"]:
        out.append(f"{name}: kernel launches {run.launches}, census "
                   f"nodes {card['kernels']}")
    if run.plain_calls:
        out.append(f"{name}: {run.plain_calls} plain-version calls on "
                   "CUDA tensors")
    if findings:
        out.append(f"{name}: findings on the card: {findings}")
    if mismatches:
        out.append(f"{name}: {mismatches} tensors not where the census "
                   "placed them")
    return out


def phase_contracts(device, names=None, full_width: int = FULL_WIDTH,
                    trace=None) -> dict:
    """Every registered program (``kafka_tpu_torch.analysis.programs``)
    at its canonical shape, twice in this process: a census on the CPU
    (the plain versions) and one on ``device`` (the hand kernels), the
    card's counted run under ``torch.cuda.set_sync_debug_mode("warn")``
    (``CardRun``); the mesh programs' shards run from their own threads.
    Gates (``contracts_gates``): the two censuses equal on CENSUS_FIELDS,
    the card's synchronising warnings equal to the census's host reads,
    the launch counters moved by exactly the kernel nodes with no plain
    version called on CUDA tensors, no checker finding on the card's
    census (the manifest's waivers applied), no tensor away from where
    the census placed it; then FULL_WIDTH_GATED at ``full_width`` px on
    the card, its census equal to its 256-px one, and
    FULL_WIDTH_RECORDED's recorded.  Printed, not gated: each card
    fingerprint against the checked-in manifest (written on the CPU,
    each naming its torch), each program's ms, the phase's wall.
    ``trace`` stands in for ``analysis.trace_program`` in the CPU
    tests."""
    import torch

    from kafka_tpu_torch import analysis
    from kafka_tpu_torch.analysis import checkers, programs  # noqa: F401

    trace = trace or analysis.trace_program
    t_phase = time.perf_counter()
    failures, progs = [], {}
    cdir = analysis.contracts_dir()
    cards = {}
    for spec in analysis.get_specs(names):
        t0 = time.perf_counter()
        cpu = trace(spec, torch.device("cpu"))
        t1 = time.perf_counter()
        run = CardRun(device)
        card = trace(spec, device, run_context=run)
        t2 = time.perf_counter()
        stored = checkers.load_manifest(cdir, spec.name)
        waivers = list((stored or {}).get("waivers") or ())
        found = [f.format() for f in checkers.apply_waivers(
            checkers.run_checkers(card), waivers, spec.name)
            if f.checker != "stale-waiver"]
        cards[spec.name] = card
        failures += contracts_gates(spec.name, census_of(cpu),
                                    census_of(card), run, found,
                                    card.placement_mismatches)
        fp = checkers.fingerprint(card)
        progs[spec.name] = {
            "cpu_s": t1 - t0, "card_s": t2 - t1,
            "fingerprint": fp, "cpu_fingerprint": checkers.fingerprint(cpu),
            "manifest_fingerprint": (stored or {}).get("fingerprint"),
            "manifest_torch": (stored or {}).get("torch"),
            "eqns": card.n_eqns, "kernels": card.kernels,
            "host_syncs": card.host_syncs, "sync_warnings": run.syncs,
            "launches": run.launches, "collectives": card.collectives,
            "placement_mismatches": card.placement_mismatches,
            "placements": [e for e in card.events
                           if e["kind"] == "placement"]}
    width = {}
    if FULL_WIDTH_GATED in cards:
        for name in (FULL_WIDTH_GATED, FULL_WIDTH_RECORDED):
            if name not in cards:
                continue
            t0 = time.perf_counter()
            run = CardRun(device)
            wide = trace(analysis.REGISTRY[name], device, run_context=run,
                         n_pix=full_width)
            diff = census_diff(census_of(cards[name]), census_of(wide))
            width[name] = {"n_pix": full_width, "s": time.perf_counter() - t0,
                           "equal_to_canonical": not diff,
                           "diff": diff, "sync_warnings": run.syncs,
                           "launches": run.launches,
                           "gated": name == FULL_WIDTH_GATED}
            if name == FULL_WIDTH_GATED and diff:
                failures.append(f"{name} at {full_width} px: census differs "
                                f"from the canonical one: "
                                f"{json.dumps(diff)[:600]}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    runs = list(progs.values()) + list(width.values())
    rec = {"phase": "contracts", "programs": progs, "full_width": width,
           "torch": torch.__version__, "wall_s": wall,
           "budget_s": CONTRACTS_LIMIT_S,
           "kernel_launches": {k: sum(r["launches"].get(k, 0) for r in runs)
                               for k in sorted({k for r in runs
                                                for k in r["launches"]})},
           "failures": failures}
    emit(rec)
    if failures:
        raise AssertionError("contracts: " + "; ".join(failures))
    return rec


# -- phases batch_modes and route ----------------------------------------

#: phase batch_modes: the serve tiles' observation seeds (their pivot
#: masks of 1,229,279 and 1,254,911 px at 2400 x 2400), the first
#: observation date of their grid, and the dense case's seeded members
#: (the p = 21 Ross-Li state, 7 bands).
BATCH_MODES_SEEDS = (0, 1)
BATCH_MODES_DENSE_PX = 1 << 20
BATCH_MODES_DENSE_RELAX = (0.6, 0.9)
#: phase route: the replica ids, the live heartbeat cadence of each
#: replica (TTL = 3 x 0.5 s = 1.5 s), the router's fleet-view refresh and
#: inbox/response poll.
ROUTE_REPLICAS = ("rep0", "rep1", "rep2")
ROUTE_LIVE_INTERVAL_S = 0.5
ROUTE_REFRESH_S = 0.2
ROUTE_POLL_S = 0.05
#: tile -> the JAX package's ring walk over ROUTE_REPLICAS
#: (``kafka_tpu.serve.router.HashRing``, 64 vnodes), pinned here because
#: this script imports no JAX; tests/test_torch_chip_smoke_route.py holds
#: it to the JAX ring.
ROUTE_JAX_PREFERENCE = {"tile0": ("rep0", "rep2", "rep1"),
                        "tile1": ("rep1", "rep2", "rep0")}
#: the nine router metric families the router's /metrics must carry.
ROUTE_NAMES = (
    "kafka_route_forwarded_total", "kafka_route_inflight",
    "kafka_route_latency_seconds", "kafka_route_rebalanced_total",
    "kafka_route_rejected_total", "kafka_route_relayed_total",
    "kafka_route_replayed_total", "kafka_route_replicas_routable",
    "kafka_route_rerouted_total")
ROUTE_CHILD_TIMEOUT_S = 600


def _capture_date(device, seed: int, ny: int, nx: int):
    """The first observation date's ``assimilate_date`` arguments of the
    serve tile of ``seed`` (phase serve's tile at this size): the
    filter's date dispatcher records them and stops the run."""
    import tempfile

    from kafka_tpu_torch.serve import make_synthetic_tile, synthetic_dates
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE

    class _Captured(Exception):
        pass

    spec = make_synthetic_tile(
        f"tile{seed}", tempfile.mkdtemp(prefix="bm_ckpt_"),
        operator="twostream", ny=ny, nx=nx, days=SERVE_DAYS, step_days=4,
        obs_every=2, seed=seed, device=device)
    kf, x0, p_inv0, _ = spec.make_filter()
    first = synthetic_dates(DEFAULT_BASE_DATE, SERVE_DAYS, 2)[0]
    got = {}

    def dispatch(linearize, bands, x, p_inv, aux, opts, hessian):
        # As the engine hands them: the first date's prior broadcast
        # over the batch.
        got.update(linearize=linearize, bands=bands, x=x, p_inv=p_inv,
                   aux=aux, opts=dict(opts or {}),
                   n_valid=int(kf.gather.n_valid))
        raise _Captured

    kf.date_dispatcher = dispatch
    try:
        kf.run(spec.grid_through(first), x0, None, p_inv0)
    except _Captured:
        pass
    return got


def _pad_member(m: dict, n: int) -> dict:
    """A member padded to ``n`` pixels with unobserved copies of its last
    pixel (the batch stacks members of one pixel count)."""
    import torch

    from kafka_tpu_torch.core.types import BandBatch

    extra = n - m["x"].shape[0]
    if extra == 0:
        return m

    def tail(t, dim, zero=False):
        fill = t.narrow(dim, t.shape[dim] - 1, 1).repeat(
            *[extra if d == dim else 1 for d in range(t.ndim)])
        return torch.cat([t, torch.zeros_like(fill) if zero else fill],
                         dim=dim)

    b = m["bands"]
    bands = BandBatch(*(tail(getattr(b, f), 1, zero=True)
                        for f in BandBatch._fields))
    return dict(m, bands=bands, x=tail(m["x"], 0), p_inv=tail(m["p_inv"], 0))


def _outputs_equal(a, b) -> bool:
    """Exact equality, NaN equal to NaN."""
    import torch

    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        same_nan = torch.equal(a.isnan(), b.isnan())
        # kafkalint: disable=nonfinite-launder — bit equality with NaN
        # equal to NaN: the NaN masks are compared first.
        return bool(same_nan and torch.equal(a.nan_to_num(), b.nan_to_num()))
    return bool(torch.equal(a, b))


def _batch_vs_solo(device, linearize, members, opts_list, aux=None):
    """Each member's solo ``assimilate_date`` (launches counted per
    member), then ``assimilate_date_batch`` over all of them (launches
    counted for the round): the fields that differ per member, the
    iterations, the launches and the walls."""
    import torch

    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.core.types import BandBatch

    solo, solo_launches, solo_ms = [], [], []
    for k, m in enumerate(members):
        reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        solo.append(solvers.assimilate_date(
            linearize, m["bands"], m["x"], m["p_inv"],
            None if aux is None else aux[k], opts_list[k],
            device=device))
        _sync(device)
        solo_ms.append((time.perf_counter() - t0) * 1e3)
        solo_launches.append(launch_counts())
    stacked = BandBatch(*(torch.stack([getattr(m["bands"], f)
                                       for m in members])
                          for f in BandBatch._fields))
    reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    xb, pib, diags = solvers.assimilate_date_batch(
        linearize, stacked, torch.stack([m["x"] for m in members]),
        torch.stack([m["p_inv"] for m in members]),
        None if aux is None else solvers.stack_aux(aux),
        solvers.stack_solver_options(opts_list), device=device)
    _sync(device)
    batch_ms = (time.perf_counter() - t0) * 1e3
    batch_launches = launch_counts()
    differing = []
    for k, (x, p_inv, d) in enumerate(solo):
        if not _outputs_equal(xb[k], x):
            differing.append(f"member {k} x")
        if not _outputs_equal(pib[k], p_inv):
            differing.append(f"member {k} p_inv")
        got = solvers.diagnostics_at(diags, k)
        for field in d._fields:
            a, b = getattr(got, field), getattr(d, field)
            if (a is None) != (b is None) or (
                    b is not None and not _outputs_equal(a, b)):
                differing.append(f"member {k} {field}")
    iters = [int(d.n_iterations) for _, _, d in solo]
    return {"iterations": iters, "solo_launches": solo_launches,
            "batch_launches": batch_launches, "solo_ms": solo_ms,
            "batch_ms": batch_ms, "fields_differing": differing,
            "frozen_fraction": [
                None if d.converged_mask is None
                else float(d.converged_mask.float().mean())
                for _, _, d in solo]}


def dense_members(device, n: int, seeds=(21, 22)):
    """Seeded members of the p = 21 Ross-Li kernel-weight state (7
    bands): per-pixel kernels, a truth near the prior, noisy
    reflectances, 20 % of the band entries masked with zero nodata."""
    import torch

    from kafka_tpu_torch.core.types import BandBatch
    from kafka_tpu_torch.obsops.kernels import KernelsAux

    p, nb = 21, 7
    members, aux = [], []
    for seed in seeds:
        g = torch.Generator(device="cpu").manual_seed(seed)

        def u(lo, hi, *shape):
            return lo + (hi - lo) * torch.rand(*shape, generator=g)

        k_vol, k_geo = u(-0.1, 0.4, n), u(-1.5, -0.5, n)
        prior = torch.tensor([0.15, 0.05, 0.02] * nb)
        truth = torch.tensor([0.12, 0.05, 0.02] * nb) \
            + 0.02 * torch.randn(n, p, generator=g)
        w = truth.reshape(n, nb, 3)
        y = (w[..., 0] + k_vol[:, None] * w[..., 1]
             + k_geo[:, None] * w[..., 2]).T
        y = y + 0.005 * torch.randn(y.shape, generator=g)
        mask = torch.rand(y.shape, generator=g) > 0.2
        bands = BandBatch(
            y=torch.where(mask, y, 0.0).to(device),
            r_inv=torch.where(mask, 1.0 / 0.005 ** 2, 0.0).to(device),
            mask=mask.to(device))
        members.append({
            "bands": bands, "x": prior.expand(n, p).contiguous().to(device),
            "p_inv": (torch.eye(p) / 0.2 ** 2).expand(n, p, p)
            .contiguous().to(device)})
        aux.append(KernelsAux(k_vol.to(device), k_geo.to(device)))
    return members, aux


def dense_calls(device, members, aux) -> dict:
    """Which library call of the dense update keeps a member's bits when
    the members' matrices are stacked: the first step's normal equations
    of each member through ``cholesky_ex`` (``linalg.cholesky_dense``)
    and the two triangular solves, once per member and once over the
    stacked batch."""
    import torch

    from kafka_tpu_torch.core import linalg
    from kafka_tpu_torch.core.solvers import build_normal_equations
    from kafka_tpu_torch.obsops.kernels import KernelsOperator

    op = KernelsOperator()
    eqs = [build_normal_equations(op.linearize(a, m["x"]), m["bands"],
                                  m["x"], m["x"], m["p_inv"])
           for m, a in zip(members, aux)]
    sizes = [e[1].shape[0] for e in eqs]
    chol = [linalg.cholesky_dense(a) for a, _ in eqs]
    chol_cat = linalg.cholesky_dense(torch.cat([a for a, _ in eqs]))
    x = [linalg._solve_chol_dense(c, b[..., None])[..., 0]
         for c, (_, b) in zip(chol, eqs)]
    # The stacked factor in the layout cholesky_ex gives it (the solves'
    # bits depend on the factor's memory layout, as the round runs them).
    x_cat = linalg._solve_chol_dense(
        chol_cat, torch.cat([b for _, b in eqs])[..., None])[..., 0]
    _sync(device)
    return {
        "cholesky_ex": _outputs_equal(chol_cat, torch.cat(chol)),
        "solve_triangular": _outputs_equal(x_cat, torch.cat(x)),
        "matrices": sizes}


def phase_batch_modes(device, ny: int = TILE, nx: int = TILE,
                      dense_px: int = BATCH_MODES_DENSE_PX):
    """The coalesced round under per-pixel convergence at full width: the
    two serve tiles' first dates (their pivot masks, the TIP prior; the
    smaller member padded with unobserved pixels to the larger's count)
    with ``per_pixel_convergence`` in one linearisation block, each solo
    and then as one ``assimilate_date_batch`` round.  Gates: each
    member's x, P^-1 and every diagnostic the bits of its solo solve;
    the round's (7, 2) fused-update launches equal to the larger
    member's step count (each solo run's to its own); the plain version
    never called.  Then the dense p = 21 path on two seeded members of
    ``dense_px`` pixels (global norm over sqrt(dense_px), relaxations
    0.6 and 0.9, so they stop at different steps): the round (one
    stacked dense solve per step) the same bits as their solo solves,
    and which library call keeps a member's bits when their matrices
    are stacked (``dense_calls``)."""
    from kafka_tpu_torch.core import fused_update
    from kafka_tpu_torch.obsops.kernels import KernelsOperator

    t_phase = time.perf_counter()
    failures = []
    members = [_capture_date(device, s, ny, nx) for s in BATCH_MODES_SEEDS]
    n = max(m["x"].shape[0] for m in members)
    n_pads = [int(m["x"].shape[0]) for m in members]
    n_valid = [m["n_valid"] for m in members]
    members = [_pad_member(m, n) for m in members]
    opts = [dict(m["opts"], per_pixel_convergence=True,
                 linearize_block=ONE_BLOCK) for m in members]
    plain = []
    real_plain = fused_update.fused_update_raw_plain

    def counted_plain(*args, **kwargs):
        plain.append(None)
        return real_plain(*args, **kwargs)

    with patched((fused_update, "fused_update_raw_plain", counted_plain)):
        pp = _batch_vs_solo(device, members[0]["linearize"], members, opts)
    if pp["fields_differing"]:
        failures.append(f"per_pixel: batched members differ from solo: "
                        f"{pp['fields_differing']}")
    want = {"7x2": max(pp["iterations"])}
    if pp["batch_launches"]["fused_update_by_instance"] != want:
        failures.append(f"per_pixel: round launches "
                        f"{pp['batch_launches']['fused_update_by_instance']}"
                        f", expected {want}")
    for k, it in enumerate(pp["iterations"]):
        if pp["solo_launches"][k]["fused_update_by_instance"] != \
                {"7x2": it}:
            failures.append(f"per_pixel: solo member {k} launches "
                            f"{pp['solo_launches'][k]}, {it} steps")
    if device.type == "cuda" and plain:
        failures.append(f"{len(plain)} calls of the plain version on the "
                        "card")
    del members
    t_dense = time.perf_counter()
    dense, aux = dense_members(device, dense_px)
    calls = dense_calls(device, dense, aux)
    # The norm per sqrt(pixel): the members stop at different steps at
    # any size (6 and 3 on these seeds).
    dopts = [{"relaxation": r, "norm_denominator": float(dense_px) ** 0.5}
             for r in BATCH_MODES_DENSE_RELAX]
    dn = _batch_vs_solo(device, KernelsOperator().linearize, dense, dopts,
                        aux=aux)
    del dense, aux
    if dn["fields_differing"]:
        failures.append(f"dense: batched members differ from solo: "
                        f"{dn['fields_differing']} (stacked calls: "
                        f"{calls})")
    if any(v["fused_update"] or v["fused_gn"] for v in
           [dn["batch_launches"]] + dn["solo_launches"]):
        failures.append("dense: a hand kernel launched on the dense path")
    if len(set(dn["iterations"])) < 2:
        failures.append(f"dense: the members stopped together "
                        f"{dn['iterations']}: no member dropped out")
    rec = {
        "phase": "batch_modes", "tile": [ny, nx],
        "per_pixel": {"n_valid": n_valid, "n_pad": n_pads, "n_batch": n,
                      **pp},
        "dense": {"n_pix": dense_px, "stacked_calls_identical": calls,
                  **dn},
        "plain_calls": len(plain),
        "seconds": {"phase": time.perf_counter() - t_phase,
                    "dense": time.perf_counter() - t_dense},
        "failures": failures,
    }
    emit(rec)
    if failures:
        raise AssertionError("batch_modes: " + "; ".join(failures))
    return rec


def count_plain_calls(as_launches: bool = False) -> dict:
    """Wrap the kernels' plain versions for the rest of this process so
    their calls are counted in the returned dict (by kernel) and, with
    ``as_launches`` (a rehearsal on the CPU), also counted as launches
    of their wrappers."""
    from kafka_tpu_torch.core import _build, fused_gn, fused_update

    plain = {"fused_gn": 0, "fused_update": 0}
    real_gn = fused_gn.fused_gn_raw_plain
    real_upd = fused_update.fused_update_raw_plain

    def gn(*args, **kwargs):
        plain["fused_gn"] += 1
        if as_launches:
            _build.count_launch(fused_gn.fused_gn_rows)
        return real_gn(*args, **kwargs)

    def upd(*args, **kwargs):
        plain["fused_update"] += 1
        if as_launches:
            rows = dict(zip(UPDATE_ROW_NAMES, args), **kwargs)
            _build.count_launch(fused_update.fused_update_rows,
                                (rows["xf_rows"].shape[0],
                                 rows["h0"].shape[0]))
        return real_upd(*args, **kwargs)

    fused_gn.fused_gn_raw_plain = gn
    fused_update.fused_update_raw_plain = upd
    return plain


def route_replica() -> None:
    """Phase route's replica process: ``kafka_serve.main`` over the
    arguments after ``-c``, with the launch counts reset first and the
    plain versions' calls counted (``--count-plain-as-launches``, for a
    rehearsal on the CPU, also counts them as launches).  On its way out
    it prints one JSON line: its launches by kernel, its plain-version
    calls and its peak device bytes."""
    import torch

    from kafka_tpu_torch.cli import kafka_serve

    argv = list(sys.argv[1:])
    as_launches = "--count-plain-as-launches" in argv
    if as_launches:
        argv.remove("--count-plain-as-launches")
    plain = count_plain_calls(as_launches)
    reset_launches()
    t0 = time.perf_counter()
    summary = kafka_serve.main(argv)
    cuda = torch.cuda.is_available() and "--device" not in argv
    print(json.dumps({
        "route_replica": True, "serve_s": time.perf_counter() - t0,
        "launches": launch_counts(), "plain_calls": plain,
        "max_memory_allocated": _mem().peak_bytes()
        if cuda else None,
        "summary": {k: summary.get(k) for k in (
            "admitted", "rejected", "errors", "drained")}}), flush=True)


def _last_json(text: str):
    for line in reversed((text or "").strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    return None


def _events(path: str, names) -> list:
    out = []
    try:
        with open(path) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if e.get("event") in names:
                    out.append(e)
    except OSError:
        pass
    return out


def phase_route(device, workdir: str, serve_shas=None, ny: int = TILE,
                nx: int = TILE, days: int = SERVE_DAYS, tiles: int = 2,
                count_plain: bool = False):
    """The fleet on the card: three ``kafka_serve`` replica processes
    (``route_replica``) at phase serve's width, sharing one checkpoint
    root, each heartbeating into ``<fleet>/<rid>`` every 0.5 s, behind
    ``python -m kafka_tpu_torch.cli.kafka_route --fleet-dir <fleet>
    --refresh-s 0.2 --http-port <port>``.  Once every replica has
    published its first snapshot, phase serve's ``serve_ladder`` requests
    of both tiles go into the router's inbox; the ring's tile0 owner
    (checked against the JAX ring's pinned walk) is SIGKILLed as soon as
    it has answered its first tile0 request with a further one forwarded
    to it.  Gates: every request answered exactly once, ok, with phase
    serve's x_sha256 for its tile and date (``serve_shas``), the
    re-routed ones included, and at least one re-routed; the victim
    flagged dead within TTL + refresh + one poll of the kill and no other
    replica ever flagged; the nine ``kafka_route_*`` families on the
    router's /metrics; each survivor launched fused_gn and called no
    plain version; every child exits as it should.  Records the
    front-door latency (router inbox -> relayed answer) beside the
    replica's own wall_ms, the failover time (kill -> first re-routed
    answer), each replica's start-up seconds and peak device bytes, and
    the phase's wall."""
    import signal

    import torch

    from kafka_tpu_torch.cli import drivers
    from kafka_tpu_torch.serve import (HashRing, read_response,
                                       submit_request, synthetic_dates)
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE

    t_phase = time.perf_counter()
    failures = []
    if device.type == "cuda":
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    fleet = os.path.join(workdir, "route_fleet")
    ckpt = os.path.join(workdir, "route_ckpt")
    front = os.path.join(workdir, "route_front")
    roots = {rid: os.path.join(workdir, f"route_{rid}")
             for rid in ROUTE_REPLICAS}
    ring = HashRing(roots)
    preference = {f"tile{t}": tuple(ring.preference(f"tile{t}"))
                  for t in range(tiles)}
    if any(preference[t] != ROUTE_JAX_PREFERENCE.get(t)
           for t in preference):
        raise AssertionError(f"route: ring walk {preference} differs from "
                             f"the JAX ring's {ROUTE_JAX_PREFERENCE}")
    victim_rid = preference["tile0"][0]
    env = drivers.child_env()
    env["KAFKA_TPU_LIVE_INTERVAL_S"] = str(ROUTE_LIVE_INTERVAL_S)
    here = os.path.dirname(os.path.abspath(__file__))
    serve_argv = ["--tiles", str(tiles), "--ckpt-root", ckpt,
                  "--operator", "twostream", "--ny", str(ny), "--nx",
                  str(nx), "--days", str(days), "--step", "4",
                  "--obs-every", "2", "--fleet-dir", fleet]
    if device.type != "cuda":
        serve_argv += ["--device", str(device)]
    if count_plain:
        serve_argv.append("--count-plain-as-launches")
    procs, started, first_beat = {}, {}, {}
    router = None
    logs = {}
    try:
        for rid, root in roots.items():
            tel = os.path.join(fleet, rid)
            logs[rid] = open(os.path.join(workdir, f"{rid}.log"), "w+")
            started[rid] = time.perf_counter()
            procs[rid] = subprocess.Popen(
                [sys.executable, "-c",
                 "import chip_smoke; chip_smoke.route_replica()",
                 "--root", root, "--telemetry-dir", tel, *serve_argv],
                cwd=here, env=env, stdout=logs[rid],
                stderr=subprocess.STDOUT, text=True)
        deadline = time.monotonic() + ROUTE_CHILD_TIMEOUT_S
        while len(first_beat) < len(roots):
            for rid in roots:
                tel = os.path.join(fleet, rid)
                if rid not in first_beat and os.path.isdir(tel) and any(
                        nm.startswith("live_") for nm in os.listdir(tel)):
                    first_beat[rid] = time.perf_counter() - started[rid]
                if procs[rid].poll() is not None:
                    raise AssertionError(
                        f"route: replica {rid} exited "
                        f"{procs[rid].returncode} before its first "
                        "heartbeat")
            if time.monotonic() > deadline:
                raise AssertionError("route: a replica never heartbeat")
            # kafkalint: disable=ad-hoc-retry — harness poll for the
            # replicas' first heartbeats, bounded by its deadline.
            time.sleep(0.05)
        port = _free_port()
        router_tel = os.path.join(fleet, "router")
        router = subprocess.Popen(
            [sys.executable, "-m", "kafka_tpu_torch.cli.kafka_route",
             "--root", front, "--replicas",
             ",".join(f"{rid}={root}" for rid, root in roots.items()),
             "--fleet-dir", fleet, "--refresh-s", str(ROUTE_REFRESH_S),
             "--poll-interval-s", str(ROUTE_POLL_S), "--http-port",
             str(port), "--telemetry-dir", router_tel],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                if http_get(url + "/healthz", timeout=2.0)[0] in (200, 503):
                    break
            except OSError:
                pass
            if router.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("route: the router never answered "
                                     f"/healthz ({router.poll()})")
            # kafkalint: disable=ad-hoc-retry — harness poll for the
            # router's /healthz, bounded by its deadline.
            time.sleep(0.05)

        dates = synthetic_dates(DEFAULT_BASE_DATE, days, 2)
        ladder = serve_ladder(dates)
        rids, submitted = {}, {}
        for k, (label, date, smoothed, _) in enumerate(ladder):
            for t in range(tiles):
                rid = f"r{k:02d}_tile{t}_{label}"
                rids[rid] = (f"tile{t}", label)
                submitted[rid] = time.time()
                submit_request(front, {"request_id": rid,
                                       "tile": f"tile{t}",
                                       "date": date.isoformat(),
                                       "smoothed": smoothed})
        first_t0 = next(r for r in rids if rids[r][0] == "tile0")
        victim_root = roots[victim_rid]
        relayed_at, kill_ts = {}, None
        deadline = time.monotonic() + ROUTE_CHILD_TIMEOUT_S
        while len(relayed_at) < len(rids):
            for rid in rids:
                if rid not in relayed_at and \
                        read_response(front, rid) is not None:
                    relayed_at[rid] = time.time()
            if kill_ts is None and \
                    read_response(victim_root, first_t0) is not None:
                journal = os.path.join(victim_root, "requests.jsonl")
                text = open(journal).read() \
                    if os.path.exists(journal) else ""
                if any(r != first_t0 and rids[r][0] == "tile0"
                       and r in text for r in rids):
                    procs[victim_rid].send_signal(signal.SIGKILL)
                    kill_ts = time.time()
            for rid, proc in procs.items():
                if rid != victim_rid and proc.poll() is not None:
                    raise AssertionError(f"route: survivor {rid} exited "
                                         f"{proc.returncode}")
            if router.poll() is not None:
                raise AssertionError(f"route: the router exited "
                                     f"{router.returncode}")
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"route: {len(rids) - len(relayed_at)} requests "
                    f"unanswered after {ROUTE_CHILD_TIMEOUT_S} s")
            # kafkalint: disable=ad-hoc-retry — harness poll for the
            # relayed answers, bounded by its deadline.
            time.sleep(0.002)
        metrics = http_get(url + "/metrics", timeout=30.0)[1]
        statusz = http_get(url + "/statusz", timeout=30.0)
        router.send_signal(signal.SIGTERM)
        r_out, r_err = router.communicate(timeout=120)
        router_summary = _last_json(r_out) or {}
        for rid, proc in procs.items():
            if rid != victim_rid:
                proc.send_signal(signal.SIGTERM)
        rcs = {rid: proc.wait(timeout=ROUTE_CHILD_TIMEOUT_S)
               for rid, proc in procs.items()}
    finally:
        for proc in list(procs.values()) + [router]:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    children = {}
    for rid, f in logs.items():
        f.seek(0)
        text = f.read()
        f.close()
        children[rid] = _last_json(text) if rid != victim_rid else None
        if rid != victim_rid and (children[rid] is None or
                                  not children[rid].get("route_replica")):
            failures.append(f"replica {rid} printed no result: "
                            f"{text[-1500:]}")

    # -- the answers ------------------------------------------------------
    responses = {rid: read_response(front, rid) or {} for rid in rids}
    rerouted, sha_diff, not_ok = [], [], []
    latency = {}
    for rid, (tile, label) in rids.items():
        r = responses[rid]
        if r.get("status") != "ok":
            not_ok.append(f"{rid}: {r.get('status')} "
                          f"{r.get('error') or r.get('reason')}")
            continue
        if serve_shas is not None and \
                r.get("x_sha256") != serve_shas.get(f"{tile}:{label}"):
            sha_diff.append(rid)
        trace = r.get("trace") or {}
        if trace.get("reroutes"):
            rerouted.append(rid)
        latency[rid] = {
            "front_door_ms": (relayed_at[rid] - submitted[rid]) * 1e3,
            "replica_wall_ms": r.get("wall_ms"),
            "replica": r.get("replica"),
            "served_from": r.get("served_from"),
            "failover_ms": (trace.get("phases") or {}).get("failover_ms")}
    if not_ok:
        failures.append(f"answers not ok: {not_ok}")
    if sha_diff:
        failures.append(f"x_sha256 differ from phase serve: {sha_diff}")
    if not rerouted:
        failures.append("no request was re-routed to a survivor")
    if any(latency.get(r, {}).get("replica") == victim_rid
           for r in rerouted):
        failures.append("a re-routed request was answered by the victim")
    if latency.get(first_t0, {}).get("replica") != victim_rid:
        failures.append(f"{first_t0} was not answered by the victim")
    # Exactly once: one relay per request, one router request_log row.
    relayed = router_summary.get("relayed")
    if relayed != len(rids):
        failures.append(f"router relayed {relayed}, expected {len(rids)}")
    route_rows = {}
    rows_path = os.path.join(router_tel, "request_log.jsonl")
    if os.path.exists(rows_path):
        with open(rows_path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if row.get("role") == "route":
                    route_rows[row["request_id"]] = \
                        route_rows.get(row["request_id"], 0) + 1
    if route_rows != {rid: 1 for rid in rids}:
        failures.append(f"router request_log rows {route_rows}")
    # -- failover ---------------------------------------------------------
    events = _events(os.path.join(router_tel, "events.jsonl"),
                     ("route_rebalanced", "route_failover"))
    left = sorted({rid for e in events if e["event"] == "route_rebalanced"
                   for rid in e.get("left") or ()})
    if left != [victim_rid]:
        failures.append(f"replicas flagged dead {left}, expected only "
                        f"{victim_rid}")
    ttl = 3.0 * ROUTE_LIVE_INTERVAL_S
    limit = ttl + ROUTE_REFRESH_S + ROUTE_POLL_S
    flagged = next((e["ts"] for e in events
                    if e["event"] == "route_rebalanced"
                    and victim_rid in (e.get("left") or ())), None)
    detect_s = None if flagged is None or kill_ts is None \
        else flagged - kill_ts
    if detect_s is None or detect_s > limit:
        failures.append(f"victim flagged dead {detect_s} s after the kill "
                        f"(limit {limit} s)")
    first_rerouted = min((relayed_at[r] for r in rerouted), default=None)
    failover_s = None if first_rerouted is None or kill_ts is None \
        else first_rerouted - kill_ts
    missing = sorted(set(ROUTE_NAMES) - prom_names(metrics))
    if missing:
        failures.append(f"router /metrics lacks {missing}")
    if not router_summary.get("rerouted") or \
            not router_summary.get("rebalanced"):
        failures.append(f"router summary {router_summary}")
    if rcs.get(victim_rid) != -signal.SIGKILL:
        failures.append(f"victim rc {rcs.get(victim_rid)}")
    if router.returncode != 0:
        failures.append(f"router rc {router.returncode}: {r_err[-1500:]}")
    for rid, child in children.items():
        if child is None:
            continue
        if rcs[rid] != 0:
            failures.append(f"survivor {rid} rc {rcs[rid]}")
        if child["launches"]["fused_gn"] <= 0:
            failures.append(f"survivor {rid} launched no fused_gn")
        if device.type == "cuda" and child["plain_calls"]["fused_gn"]:
            failures.append(f"survivor {rid} called the plain version "
                            f"{child['plain_calls']} times")
        if child["summary"].get("errors") or \
                child["summary"].get("rejected"):
            failures.append(f"survivor {rid} summary {child['summary']}")
    rec = {
        "phase": "route", "tile": [ny, nx], "tiles": tiles, "days": days,
        "replicas": list(ROUTE_REPLICAS), "preference": preference,
        "victim": victim_rid, "requests": len(rids),
        "rerouted": rerouted, "latency": latency,
        "kill_to_flagged_dead_s": detect_s, "flag_limit_s": limit,
        "failover_s": failover_s, "flagged_dead": left,
        "replica_startup_s": first_beat,
        "replicas_out": children, "rcs": rcs,
        "router_summary": router_summary,
        "router_statusz": statusz[0],
        "router_metric_families": sorted(
            set(ROUTE_NAMES) & prom_names(metrics)),
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "seconds": {"phase": time.perf_counter() - t_phase},
        "failures": failures,
    }
    if days != SERVE_DAYS:
        rec["reduced"] = {"days": f"{days} of {SERVE_DAYS}"}
    emit(rec)
    if failures:
        raise AssertionError("route: " + "; ".join(failures))
    return rec


# -- phase operator_tools ------------------------------------------------

#: phase operator_tools: the port's loadgen drives a kafka_serve daemon of
#: phase serve's width and grid (tile0, a fresh checkpoint root) through
#: its inbox: the plan's dates (indexes into the grid's observation
#: dates, whose answers phase serve digested as cold_replay, cold and
#: warm_noop), its requests and concurrency, and the seconds one request
#: may take.
TOOLS_LOAD_DATES = (0, 2, 3)
TOOLS_LOAD_REQUESTS = 8
TOOLS_LOAD_CONCURRENCY = 2
TOOLS_LOAD_TIMEOUT_S = 300.0
#: observation dates a window of phase serve's grid holds (--step 4,
#: --obs-every 2): one fused_gn launch each.
SERVE_DATES_PER_WINDOW = 2
#: loadgen's self-contained modes, as ``loadgen.main`` arguments: the
#: JAX defaults' 20 x 20 identity tiles, fused_update instance (2, 2).
TOOLS_MODES = (
    ("synthetic", ("--synthetic", "--requests", "8", "--concurrency", "2")),
    ("concurrency_sweep", ("--concurrency-sweep", "1,4")),
    ("fleet", ("--fleet", "2", "--requests", "8", "--concurrency", "2")),
)
#: the instance the self-contained modes launch.
TOOLS_MODES_INSTANCE = "2x2"
#: each report tool's top-level ``--json`` keys.
REPORT_KEYS = {
    "queue_status": ("chunks", "counts", "manifest", "n_chunks", "outdir",
                     "workers"),
    "slo_report": ("episodes", "objectives", "records", "skipped_lines",
                   "sources"),
    "quality_report": ("bands", "sources", "tiles", "version"),
    "device_report": ("mesh_history", "n_sessions", "root", "sessions"),
    "trace_report": ("by_status", "coverage_ok_fraction", "exemplars",
                     "requests_total", "root", "slowest", "torn_lines",
                     "unattributed"),
    "fleet_status": ("counters", "dead_hosts", "histograms", "n_workers",
                     "queue", "run_ids", "workers"),
}
#: the module roots a report tool's process must not hold: JAX, the JAX
#: package and its top-level ``tools``.
FOREIGN_ROOTS = ("jax", "jaxlib", "kafka_tpu", "tools")
REPORT_TIMEOUT_S = 180
#: the executor's rendezvous counters (serve.batch).
ROUNDS = "kafka_serve_batch_launches_total"
ROUND_MEMBERS = "kafka_serve_batch_launch_members_total"


def tool_child() -> None:
    """A report tool's process: ``python -c "import chip_smoke;
    chip_smoke.tool_child()" <module> <args>`` runs ``<module>`` as
    ``python -m`` does, then prints last on its standard error one JSON
    line naming every module of FOREIGN_ROOTS the process imported."""
    import runpy

    sys.argv = sys.argv[1:]
    code = 0
    try:
        runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
    except SystemExit as exc:
        code = exc.code
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in FOREIGN_ROOTS)
    print(json.dumps({"tool_child": True, "foreign_modules": foreign}),
          file=sys.stderr, flush=True)
    sys.exit(code)


def run_reports(specs) -> dict:
    """Each ``(label, tool, argv)`` of ``specs`` as ``python -m
    kafka_tpu_torch.tools.<tool> <argv>`` (through ``tool_child``), all
    started at once.  Returns label -> the tool, its argv, exit code,
    seconds from the start of the batch to its end, the foreign modules
    it held (None when it printed no check), its parsed ``--json``
    output, and the batch (its first label) with the batch's wall."""
    from kafka_tpu_torch.cli import drivers

    here = os.path.dirname(os.path.abspath(__file__))
    env = drivers.child_env()
    t0 = time.perf_counter()
    batch = specs[0][0] if specs else None
    procs = {}
    for label, tool, argv in specs:
        procs[label] = (tool, list(argv), subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.tool_child()",
             f"kafka_tpu_torch.tools.{tool}", *argv],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    for label, (tool, argv, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=REPORT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        try:
            report = json.loads(stdout)
        except ValueError:
            report = None
        out[label] = {"tool": tool, "argv": argv, "rc": proc.returncode,
                      "wall_s": time.perf_counter() - t0,
                      "foreign_modules": (_last_json(stderr) or {}).get(
                          "foreign_modules"),
                      "report": report, "batch": batch,
                      "stderr": stderr[-1500:] if proc.returncode else ""}
    wall = time.perf_counter() - t0
    for r in out.values():
        r["batch_wall_s"] = wall
    return out


def queue_reports(workdir: str) -> list:
    """The report runs over phase queue's fleet directory and its
    workers' heartbeats."""
    return [("queue_status", "queue_status",
             [os.path.join(workdir, "queue_fleet"), "--telemetry-dir",
              os.path.join(workdir, "queue_tel"), "--json"])]


def device_plane_reports(workdir: str) -> list:
    """The report runs over phase device_plane's telemetry (run 2's,
    with its ``--profile-windows`` capture) and its server's fleet dir
    (request log, alerts ledger, quality ledger, heartbeats)."""
    tel, fleet = (os.path.join(workdir, d) for d in ("dp_tel", "dp_fleet"))
    return [("device_report", "device_report", [tel, "--n", "64",
                                                "--json"]),
            ("slo_report", "slo_report", [fleet, "--json"]),
            ("quality_report", "quality_report", [tel, fleet, "--json"]),
            ("trace_report", "trace_report", [fleet, "--json"]),
            ("fleet_status", "fleet_status", [fleet, "--json"])]


def route_reports(workdir: str) -> list:
    """The report runs over phase route's fleet dir: the router's and
    the replicas' heartbeats and request logs."""
    fleet = os.path.join(workdir, "route_fleet")
    return [("fleet_status route", "fleet_status", [fleet, "--json"]),
            ("trace_report route", "trace_report", [fleet, "--json"])]


def report_gates(reports: dict, fused_gn_captured=None) -> list:
    """Failures of the report runs: an exit code other than 0, ``--json``
    output without the tool's top-level keys, a process that held a
    foreign module (or printed no check); and, given the fused_gn
    launches phase device_plane's capture held, a ``device_report``
    whose newest session's kernel table has no ``fused_gn_kernel`` row of
    that count."""
    failures = []
    for label, r in reports.items():
        missing = sorted(set(REPORT_KEYS[r["tool"]])
                         - set(r["report"] or {}))
        if r["rc"] != 0:
            failures.append(f"{label}: rc {r['rc']}: {r['stderr'][-300:]}")
        elif not isinstance(r["report"], dict) or missing:
            failures.append(f"{label}: --json output lacks {missing}")
        if r["foreign_modules"] is None:
            failures.append(f"{label}: printed no module check")
        elif r["foreign_modules"]:
            failures.append(f"{label}: imported {r['foreign_modules'][:5]}")
    dev = reports.get("device_report")
    if dev is not None and fused_gn_captured is not None:
        row = device_report_row(dev)
        if row is None or row["count"] != fused_gn_captured:
            failures.append(f"device_report: fused_gn row {row} against "
                            f"{fused_gn_captured} captured launches")
    return failures


def device_report_row(run: dict):
    """The ``fused_gn_kernel`` row of a device_report run's newest
    session, or None."""
    sessions = (run.get("report") or {}).get("sessions") or []
    kernels = (sessions[-1].get("kernels") or []) if sessions else []
    return next((k for k in kernels if FUSED_GN_KERNEL in k["name"]), None)


def report_summary(run: dict) -> dict:
    """A few numbers of one report run, for the phase's record."""
    r = run["report"] or {}
    tool = run["tool"]
    out = {"tool": tool, "rc": run["rc"], "wall_s": run["wall_s"],
           "foreign_modules": run["foreign_modules"]}
    if tool == "device_report":
        out["fused_gn_row"] = device_report_row(run)
        out["n_sessions"] = r.get("n_sessions")
    elif tool == "queue_status":
        out["counts"] = r.get("counts")
        out["workers"] = sorted(r.get("liveness") or {})
    elif tool == "slo_report":
        out.update(records=r.get("records"),
                   episodes=len(r.get("episodes") or ()),
                   objectives=sorted(r.get("objectives") or {}))
    elif tool == "quality_report":
        out["tiles"] = {t: v.get("overall")
                        for t, v in (r.get("tiles") or {}).items()}
    elif tool == "trace_report":
        out.update(requests_total=r.get("requests_total"),
                   by_status=r.get("by_status"),
                   coverage_ok_fraction=r.get("coverage_ok_fraction"))
    elif tool == "fleet_status":
        out.update(n_workers=r.get("n_workers"),
                   dead_hosts=r.get("dead_hosts"),
                   roles=sorted(w.get("role") for w in
                                r.get("workers") or ()))
    return out


def loadgen_root_drive(device, workdir: str, serve_shas=None,
                       ny: int = TILE, nx: int = TILE,
                       days: int = SERVE_DAYS) -> tuple:
    """``kafka_serve.main`` in-process over tile0 of phase serve's grid
    (a fresh checkpoint root, ``--http-port``, the fleet plane into its
    own telemetry dir) while a thread drives it with the port's loadgen
    (``run_load`` over ``_Target(root=...)``, ``_MetricsScraper`` on its
    ``/metrics``) and drains it when the load is done.  Returns
    ``(record, failures)``."""
    import contextlib
    import io
    import threading

    from kafka_tpu_torch.cli import kafka_serve
    from kafka_tpu_torch.serve import (ServeDaemon, read_response,
                                       synthetic_dates)
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use
    from kafka_tpu_torch.tools import loadgen

    root = os.path.join(workdir, "tools_serve")
    tel = os.path.join(workdir, "tools_tel")
    dates = synthetic_dates(DEFAULT_BASE_DATE, days, 2)
    # date -> the label of phase serve's forward answer for it (whose
    # digest an answer must have).
    labels = {}
    for label, date, smoothed, _ in serve_ladder(dates):
        if not smoothed:
            labels.setdefault(date, label)
    plan = loadgen.synthetic_request_plan(
        [dates[i] for i in TOOLS_LOAD_DATES], ["tile0"],
        TOOLS_LOAD_REQUESTS)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    argv = ["--root", root, "--tiles", "1", "--operator", "twostream",
            "--ny", str(ny), "--nx", str(nx), "--days", str(days),
            "--step", "4", "--obs-every", "2", "--no-aot",
            "--telemetry-dir", tel, "--fleet-dir", tel, "--http-port",
            str(port), "--live-interval-s", "1", "--slo-interval-s", "1",
            "--slo-fast-window-s", "60", "--slo-slow-window-s", "600",
            "--device", str(device)]
    daemon, drive = {}, {}
    real_run = ServeDaemon.run

    def run(self):
        daemon["it"] = self
        return real_run(self)

    def driver():
        try:
            scraper = loadgen._MetricsScraper(url).start()
            try:
                t0 = time.perf_counter()
                drive["rows"] = loadgen.run_load(
                    loadgen._Target(root=root), plan,
                    concurrency=TOOLS_LOAD_CONCURRENCY,
                    timeout_s=TOOLS_LOAD_TIMEOUT_S)
                drive["load_s"] = time.perf_counter() - t0
            finally:
                drive["live_telemetry"] = scraper.stop()
        except Exception as exc:  # noqa: BLE001 — a failure of the phase
            drive["error"] = repr(exc)
        finally:
            deadline = time.monotonic() + TOOLS_LOAD_TIMEOUT_S
            while "it" not in daemon and time.monotonic() < deadline:
                # kafkalint: disable=ad-hoc-retry — harness wait for the
                # daemon thread to publish itself, bounded.
                time.sleep(0.05)
            if "it" in daemon:
                daemon["it"].drain()

    # kafkalint: disable=untracked-thread — the load generator's
    # carrier; the daemon's own service worker follows the tracing
    # convention.
    thread = threading.Thread(target=driver, name="loadgen-driver",
                              daemon=True)
    reset_launches()
    t0 = time.perf_counter()
    thread.start()
    with use(MetricsRegistry()), patched((ServeDaemon, "run", run)), \
            contextlib.redirect_stdout(io.StringIO()):
        summary = kafka_serve.main(argv)
    thread.join(timeout=TOOLS_LOAD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    failures = []
    rows = drive.get("rows") or {}
    if "error" in drive or thread.is_alive():
        failures.append(f"loadgen: {drive.get('error', 'still running')}")
    answers = {f"load{i:05d}": read_response(root, f"load{i:05d}") or {}
               for i in range(len(plan))}
    sha_diff, windows = [], 0
    for rid, r in answers.items():
        if r.get("status") != "ok":
            failures.append(f"{rid}: {r.get('status')} "
                            f"{r.get('error') or r.get('reason')}")
            continue
        if r.get("served_from") in ("cold", "warm", "cold_replay"):
            windows += int(r.get("windows_run") or 0)
        date = datetime.datetime.fromisoformat(r["date"])
        if serve_shas is not None and r.get("x_sha256") != serve_shas.get(
                f"tile0:{labels.get(date)}"):
            sha_diff.append(rid)
    if sha_diff:
        failures.append(f"x_sha256 differ from phase serve: {sha_diff}")
    if rows.get("serve_ok_total") != len(plan) or \
            rows.get("serve_error_total") or \
            rows.get("serve_rejected_total") or \
            rows.get("serve_cancelled_total"):
        failures.append(f"loadgen rows {rows}")
    solves = SERVE_DATES_PER_WINDOW * windows
    if launches["fused_gn"] != solves or solves <= 0:
        failures.append(f"{launches['fused_gn']} fused_gn launches "
                        f"against {solves} date solves")
    live = drive.get("live_telemetry") or {}
    series = sorted(live.get("series") or {})
    if not live.get("samples") or not series:
        failures.append(f"the live scrape took {live.get('samples')} "
                        f"samples ({live.get('scrape_errors')} errors), "
                        f"{len(series)} kafka_serve_ series")
    if summary.get("errors") or summary.get("rejected") or \
            not summary.get("drained"):
        failures.append(f"daemon summary {summary}")
    rec = {
        "argv": argv, "plan": [[p["date"], labels.get(
            datetime.datetime.fromisoformat(p["date"]))] for p in plan],
        "concurrency": TOOLS_LOAD_CONCURRENCY, "wall_s": wall,
        "load_s": drive.get("load_s"),
        "rows": {k: rows.get(k) for k in (
            "serve_p50_ms", "serve_p99_ms", "serve_ok_total",
            "serve_rejected_total", "serve_cancelled_total",
            "serve_error_total", "serve_rps", "serve_wall_s",
            "serve_solved_total", "serve_trace_coverage",
            "serve_slowest_ms", "serve_queue_wait_p99_ms")},
        "served_from": {rid: r.get("served_from")
                        for rid, r in answers.items()},
        "wall_ms": {rid: r.get("wall_ms") for rid, r in answers.items()},
        "windows_run": windows, "date_solves": solves,
        "kernel_launches": launches, "sha_compared": serve_shas is not None,
        "live_telemetry": {"samples": live.get("samples"),
                           "scrape_errors": live.get("scrape_errors"),
                           "series": len(series)},
        "daemon_summary": {k: summary.get(k) for k in (
            "admitted", "rejected", "errors", "drained", "http_port")},
        "telemetry_dir": tel,
    }
    return rec, failures


def loadgen_modes(device) -> tuple:
    """``loadgen.main`` in each self-contained mode on ``device``, each
    under a registry of its own, its launch counts reset before and read
    after; every ``run_load`` call of a mode records its fused-update
    launches and the executor's rendezvous rounds and members (the
    sweep's levels).  Returns ``(record, failures)``."""
    import contextlib
    import io

    from kafka_tpu_torch.telemetry import get_registry
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry, use
    from kafka_tpu_torch.tools import loadgen

    real_run_load = loadgen.run_load
    out, failures = {}, []
    for name, args in TOOLS_MODES:
        calls = []

        def counted(target, requests, *a, **kw):
            reg = get_registry()
            before = (launch_counts()["fused_update_by_instance"].get(
                TOOLS_MODES_INSTANCE, 0), reg.value(ROUNDS) or 0,
                reg.value(ROUND_MEMBERS) or 0)
            rows = real_run_load(target, requests, *a, **kw)
            after = (launch_counts()["fused_update_by_instance"].get(
                TOOLS_MODES_INSTANCE, 0), reg.value(ROUNDS) or 0,
                reg.value(ROUND_MEMBERS) or 0)
            launches, rounds, members = (b - a for a, b in
                                         zip(before, after))
            calls.append({
                "requests": len(requests),
                "concurrency": kw.get("concurrency", a[0] if a else None),
                "ok": rows["serve_ok_total"],
                "errors": rows["serve_error_total"],
                "fused_update_launches": launches, "rounds": rounds,
                "round_members": members,
                "launches_per_round": launches / rounds if rounds
                else None,
                "members_per_launch": members / rounds if rounds
                else None})
            return rows

        argv = [*args, "--device", str(device)]
        reset_launches()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with use(MetricsRegistry()), \
                patched((loadgen, "run_load", counted)), \
                contextlib.redirect_stdout(printed):
            rc = loadgen.main(argv)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        rows = _last_json(printed.getvalue()) or {}
        errors = rows.get("serve_error_total",
                          rows.get("serve_fleet_error_total"))
        by_inst = launches["fused_update_by_instance"]
        if rc != 0 or errors != 0:
            failures.append(f"{name}: rc {rc}, error rows {errors}")
        if set(by_inst) != {TOOLS_MODES_INSTANCE} or \
                not by_inst[TOOLS_MODES_INSTANCE]:
            failures.append(f"{name}: fused_update launches {by_inst}")
        keep = {k: v for k, v in rows.items()
                if k not in ("live_telemetry", "serve_sweep")}
        if "serve_sweep" in rows:
            keep["serve_sweep"] = [
                {k: lv.get(k) for k in (
                    "concurrency", "serve_p50_ms", "serve_p99_ms",
                    "serve_ok_total", "serve_error_total",
                    "serve_batch_mean_size", "serve_device_batch_mean",
                    "serve_px_s")} for lv in rows["serve_sweep"]]
        out[name] = {"argv": argv, "rc": rc, "wall_s": wall,
                     "rows": keep, "kernel_launches": launches,
                     "run_load_calls": calls}
    return out, failures


def phase_operator_tools(device, workdir: str, serve_shas=None,
                         reports=None, fused_gn_captured=None,
                         ny: int = TILE, nx: int = TILE):
    """The port's operator tools on the card, in three parts.

    a. ``loadgen_root_drive``: the port's loadgen drives a full-width
       two-stream ``kafka_serve`` (tile0 of phase serve's grid, a fresh
       checkpoint root) with TOOLS_LOAD_REQUESTS requests at concurrency
       TOOLS_LOAD_CONCURRENCY over three of phase serve's dates, the
       daemon's ``/metrics`` scraped the while.  Gates: every request
       ok, no error, rejected or cancelled row; every answer's x_sha256
       phase serve's for its tile and date; the fused_gn launches at the
       launch site equal to the date solves (SERVE_DATES_PER_WINDOW a
       window run); the scrape took kafka_serve_* samples.
    b. ``loadgen_modes``: ``--synthetic``, ``--concurrency-sweep 1,4`` and
       ``--fleet 2`` on the card: rc 0, no error row, fused_update
       launched at (2, 2) and no other instance; the sweep's levels with
       their launches per round and members per launch.
    c. ``reports`` (``run_reports`` after phases queue, device_plane and
       route, each while its directories existed): ``report_gates``,
       with the device_report's fused_gn row held to
       ``fused_gn_captured``."""
    t_phase = time.perf_counter()
    drive, failures = loadgen_root_drive(device, workdir, serve_shas,
                                         ny=ny, nx=nx)
    t_modes = time.perf_counter()
    modes_rec, mode_failures = loadgen_modes(device)
    failures += mode_failures
    reports = reports or {}
    failures += report_gates(reports, fused_gn_captured)
    foreign = sorted({m for r in reports.values()
                      for m in r["foreign_modules"] or ()})
    rec = {
        "phase": "operator_tools", "tile": [ny, nx],
        "loadgen_root": drive, "modes": modes_rec,
        "reports": {label: report_summary(r)
                    for label, r in reports.items()},
        "report_processes": len(reports),
        "report_processes_without_jax": bool(reports) and not foreign and
        all(r["foreign_modules"] is not None for r in reports.values()),
        "fused_gn_captured": fused_gn_captured,
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "seconds": {"phase": time.perf_counter() - t_phase,
                    "loadgen_root": t_modes - t_phase,
                    "modes": time.perf_counter() - t_modes,
                    "report_batches": {r["batch"]: r["batch_wall_s"]
                                       for r in reports.values()}},
        "failures": failures,
    }
    emit(rec)
    if failures:
        raise AssertionError("operator_tools: " + "; ".join(failures))
    return rec


# -- phase lint --------------------------------------------------------

#: phase lint: the port's source lints, each run as ``python -m
#: kafka_tpu_torch.tools.<name> <checkout> <args>`` through ``tool_child``.
LINT_TOOLS = (("kafkalint", ("--json",)), ("check_metric_names", ()))
LINT_TIMEOUT_S = 300


def phase_lint(root=None) -> dict:
    """The port's source lints over the checkout this smoke runs in
    (``root``, by default this file's directory), both started at once:
    ``kafkalint --json`` and ``check_metric_names``.  Gates: rc 0 from
    both, no finding, every baseline entry matched, and no module of
    FOREIGN_ROOTS (JAX, the JAX package, its top-level ``tools``) in
    either process.  Records the finding, baseline and metric-name
    counts and the seconds."""
    import re

    from kafka_tpu_torch.cli import drivers

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(root or here)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.tool_child()",
         f"kafka_tpu_torch.tools.{name}", root, *argv],
        cwd=here, env=drivers.child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, argv in LINT_TOOLS}
    runs = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=LINT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        runs[name] = {"rc": proc.returncode,
                      "wall_s": time.perf_counter() - t0,
                      "foreign_modules": (_last_json(stderr) or {}).get(
                          "foreign_modules"),
                      "stdout": stdout, "stderr": stderr}
    try:
        lint = json.loads(runs["kafkalint"]["stdout"])
    except ValueError:
        lint = None
    names = re.search(r"(\d+) metric names OK",
                      runs["check_metric_names"]["stdout"])
    failures = [f"{name}: rc {r['rc']}: {r['stderr'][-800:]}"
                for name, r in runs.items() if r["rc"] != 0]
    failures += [f"{name} imported {r['foreign_modules']}"
                 for name, r in runs.items() if r["foreign_modules"]]
    failures += [f"{name} printed no module check"
                 for name, r in runs.items()
                 if r["foreign_modules"] is None]
    if lint is None:
        failures.append("kafkalint printed no --json report")
    else:
        failures += [f"finding {f['path']}:{f['line']} [{f['rule']}]"
                     for f in lint["findings"][:20]]
        if lint["baseline"]["matched"] < lint["baseline"]["entries"]:
            failures.append("a baseline entry matched no finding")
    rec = {
        "phase": "lint", "root": root,
        "files_scanned": lint and lint["files_scanned"],
        "rules": lint and len(lint["rules"]),
        "findings": lint and len(lint["findings"]),
        "baseline_entries": lint and lint["baseline"]["entries"],
        "baseline_matched": lint and lint["baseline"]["matched"],
        "metric_names": int(names.group(1)) if names else None,
        "rc": {name: r["rc"] for name, r in runs.items()},
        "processes_without_jax": all(r["foreign_modules"] == []
                                     for r in runs.values()),
        "seconds": {"phase": time.perf_counter() - t0,
                    **{name: r["wall_s"] for name, r in runs.items()}},
        "failures": failures,
    }
    emit(rec)
    if failures:
        raise AssertionError("lint: " + "; ".join(failures))
    return rec


# -- phase bench -------------------------------------------------------

#: phase bench: the JAX bench's widths — the device rows at 2^19 px and
#: at the reference's 16,384-px chunk (the oracle's size), the Barrax e2e
#: at bench_end_to_end's defaults (204 x 235 px, 3 dates), roofline at
#: 2^19 px.  Its depth is cut to fit the smoke: the queued slope's target
#: and reps (BENCH_SLOPE, BENCH_ROOFLINE_ARGS), one e2e pass, one oracle
#: rep, one smoother rep.
BENCH_N_DEVICE = 1 << 19
BENCH_N_MATCHED = 16384
BENCH_SLOPE = {"target_s": 0.1, "reps": 2, "ks": (1, 3)}
BENCH_ROOFLINE_ARGS = ("--reps", "1", "--target-s", "0.1", "--ks", "1,2")
BENCH_LIMIT_S = 75.0
BENCH_TIMEOUT_S = 600
#: a component's time may not fall below its bound by more than this:
#: the bound is a least time, so a share above 1 is a wrong count or a
#: wrong clock.
BENCH_SHARE_LIMIT = 1.05
#: the roofline components that launch the hand kernels (card only).
BENCH_KERNEL_COMPONENTS = ("tip/gn_full_pallas", "tip/gn_inkernel",
                           "prosail/update_pallas")
#: the JAX bench artifact's key set (``bench.assemble_result``; pinned by
#: tests/test_bench_schema.py, and this copy by
#: tests/test_torch_chip_smoke_bench.py).
BENCH_KEYS = frozenset({
    "metric", "value", "unit", "vs_baseline", "vs_baseline_at_scale",
    "oracle_ms_median", "oracle_ms_spread", "oracle_ms_min",
    "n_pix_device", "n_pix_matched", "device_px_s_matched",
    "device_ms_matched_median", "device_ms_matched_spread",
    "device_xla_ms", "device_xla_ms_spread", "device_pallas_ms",
    "device_pallas_ms_spread", "device_pallas_px_s",
    "device_pallas_fused_lin_ms", "device_pallas_fused_lin_ms_spread",
    "device_pallas_fused_lin_px_s", "device_smoother_ms",
    "device_smoother_px_s", "e2e_pixel_steps_per_s",
    "e2e_pixel_steps_per_s_spread", "e2e_device_fraction", "e2e_n_pixels",
    "serve_p50_ms", "serve_p99_ms", "serve_cold_ms", "serve_rejected_total",
    "serve_requests_total", "serve_smoothed_p50_ms",
    "serve_smoothed_p99_ms", "serve_trace_coverage", "serve_slowest_ms",
    "live_telemetry", "serve_fleet_p50_ms", "serve_fleet_p99_ms",
    "serve_fleet_replicas", "serve_fleet_requests_total",
    "serve_fleet_rerouted_total", "serve_backoff_total",
    "serve_slo_alerts_total", "serve_slo_budget_remaining",
    "probe_device_ms", "probe_host_ms", "probe_retried",
    "unhealthy_reasons", "probe_host_after_ms", "unhealthy", "serve_sweep",
    "serve_batched_px_s", "serve_batch_mean_size",
    "serve_queue_wait_p99_ms", "serve_unbatched_p99_ms",
    "serve_unbatched_queue_wait_p99_ms", "telemetry", "solver_health",
    "quality", "perf", "slo", "device_profile", "program_contracts"})
#: the artifact rows phase bench prints.
BENCH_ROWS = ("value", "vs_baseline", "vs_baseline_at_scale",
              "oracle_ms_median", "oracle_ms_min", "device_ms_matched_median",
              "device_ms_matched_spread", "device_xla_ms",
              "device_xla_ms_spread", "device_pallas_ms",
              "device_pallas_ms_spread", "device_pallas_fused_lin_ms",
              "device_pallas_fused_lin_ms_spread", "device_smoother_ms",
              "e2e_pixel_steps_per_s", "e2e_device_fraction",
              "e2e_n_pixels", "probe_device_ms", "probe_host_ms",
              "probe_host_after_ms", "unhealthy", "unhealthy_reasons")


def contracts_snapshot_of(rec: dict) -> dict:
    """``analysis.contracts_snapshot``'s shape from phase contracts'
    record: the card census's fingerprint of every program and no
    finding (the phase raises on one)."""
    return {"programs": {name: prog["fingerprint"] for name, prog in
                         sorted(rec["programs"].items())},
            "findings": 0, "clean": True, "error": None}


def bench_run(cfg: dict) -> dict:
    """Phase bench's work in ``bench_child``'s process: the bench's row
    functions, ``assemble_result`` (its artifact written to
    ``cfg["workdir"]/bench.json``), then each tool's ``main`` with its
    output captured: its exit code, seconds and the launches it made."""
    import contextlib
    import io

    import torch

    from kafka_tpu_torch import bench
    from kafka_tpu_torch.tools import (bench_compare, bench_history,
                                       measure_baseline, roofline)

    dev = torch.device(cfg["device"])
    n_device, n_matched = cfg["n_device"], cfg["n_matched"]
    slope = cfg["slope"]
    plain = count_plain_calls(cfg["count_plain"])
    reset_launches()
    seconds, by_step = {}, {}

    def step(name, fn):
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        after = launch_counts()
        by_step[name] = {
            "fused_gn": after["fused_gn"] - before["fused_gn"],
            **{k: n - before["fused_update_by_instance"].get(k, 0)
               for k, n in after["fused_update_by_instance"].items()
               if n != before["fused_update_by_instance"].get(k, 0)}}
        return out

    health = step("probe_health", lambda: bench.probe_health(
        retry_wait_s=0.0))
    oracle = step("oracle", lambda: bench.bench_oracle(n_matched, reps=1))
    rows = step("device_plain", lambda: bench.bench_device_sizes(
        [n_matched, n_device, n_matched], device=dev, **slope))
    pallas, fused_lin = step("device_kernels", lambda: bench.
                             bench_kernel_rows(n_device, device=dev,
                                               **slope))
    e2e = step("e2e", lambda: bench.bench_end_to_end(
        **cfg["e2e"], passes=1, device=dev))
    smoother = step("smoother", lambda: bench.bench_smoother_rows(
        reps=1, device=dev))
    contracts = None
    if cfg.get("contracts"):
        with open(cfg["contracts"]) as f:
            contracts = json.load(f)
    artifact = step("assemble", lambda: bench.assemble_result(
        health, oracle=oracle, device_matched=rows[n_matched],
        device=rows[n_device], pallas=pallas, fused_lin=fused_lin, e2e=e2e,
        smoother=smoother, host_after_ms=bench.probe_host(),
        n_matched=n_matched, n_device=n_device,
        program_contracts=contracts, run_device=dev))
    path = os.path.join(cfg["workdir"], "bench.json")
    with open(path, "w") as f:
        json.dump(artifact, f)
    roof_path = os.path.join(cfg["workdir"], "roofline.json")
    e2e_size = [] if cfg["e2e"] == {} else [
        "--size", str(cfg["e2e"]["ny"]), "--dates",
        str(cfg["e2e"]["n_dates"])]
    tools = {}
    for name, main, argv in (
            ("bench_compare", bench_compare.main, [path, path]),
            ("bench_history", bench_history.main, [path, "--json"]),
            ("roofline", roofline.main,
             ["--n", str(cfg["roofline_n"]), "--json", roof_path,
              "--device", cfg["device"], *BENCH_ROOFLINE_ARGS]),
            ("measure_baseline_barrax", measure_baseline.main,
             ["barrax", "--passes", "1", "--device", cfg["device"],
              *e2e_size]),
            ("measure_baseline_oracle", measure_baseline.main,
             ["oracle", "--oracle-n", str(n_matched), "--reps", "1"])):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = step(name, lambda: main(argv))
        tools[name] = {"argv": argv, "rc": rc, "s": seconds[name],
                       "stdout_tail": out.getvalue()[-600:],
                       "stderr_tail": err.getvalue()[-1500:]}
    return {"bench_child": True, "artifact": path, "roofline": roof_path,
            "seconds": seconds, "launches": launch_counts(),
            "launches_by_step": by_step, "plain_calls": plain,
            "tools": tools}


def bench_child() -> None:
    """Phase bench's process: ``python -c "import chip_smoke;
    chip_smoke.bench_child()" CONFIG.json`` runs ``bench_run`` on the
    config and prints last one JSON line: its result and every module of
    FOREIGN_ROOTS the process imported."""
    with open(sys.argv[1]) as f:
        cfg = json.load(f)
    out = bench_run(cfg)
    out["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in FOREIGN_ROOTS)
    print(json.dumps(out), flush=True)


def bench_gates(child, artifact, roof, rc: int, wall_s: float,
                limit_s: float) -> list:
    """The failures of phase bench: the child's exit code and modules,
    the artifact's keys and kernel rows, the phase's launches, the
    roofline's shares and kernel bounds, the tools' exit codes, the
    wall."""
    if child is None or rc != 0:
        return [f"bench child rc {rc}, printed {child is not None}"]
    failures = []
    if child["foreign_modules"]:
        failures.append(f"bench child imported {child['foreign_modules']}")
    if artifact is None or set(artifact) != BENCH_KEYS:
        got = set(artifact or ())
        failures.append(f"artifact keys: missing {sorted(BENCH_KEYS - got)}"
                        f", extra {sorted(got - BENCH_KEYS)}")
    for key in ("device_pallas_ms", "device_pallas_fused_lin_ms"):
        v = (artifact or {}).get(key)
        if not isinstance(v, (int, float)) or not np.isfinite(v):
            failures.append(f"{key} is {v}")
    launched = child["launches"]
    by_inst = launched["fused_update_by_instance"]
    if not launched["fused_gn"] or not by_inst.get("7x2") or \
            not by_inst.get("10x10"):
        failures.append(f"launches {launched}: fused_gn and fused_update "
                        "(7, 2) and (10, 10) must each launch")
    failures += [f"{name}: rc {t['rc']}: {t['stderr_tail'][-500:]}"
                 for name, t in child["tools"].items() if t["rc"] != 0]
    rows = {r["component"]: r for r in (roof or {}).get("rows", ())}
    missing = [c for c in BENCH_KERNEL_COMPONENTS if c not in rows]
    if missing:
        failures.append(f"roofline components missing: {missing}")
    for name, r in rows.items():
        shares = [r.get("share_of_bound"),
                  (r.get("pct_hbm_roof_lower_bound") or 0.0) / 100.0]
        if any(v is None or v > BENCH_SHARE_LIMIT for v in shares):
            failures.append(f"roofline {name}: share of bound {shares}")
        want = roofline_kernel_bound(r, roof["n_pix"])
        if want is not None and \
                abs(r["bound_ms"] - want) > 1e-9 * want:
            failures.append(f"roofline {name}: bound {r['bound_ms']} ms, "
                            f"this script's {want} ms")
    if wall_s > limit_s:
        failures.append(f"phase took {wall_s:.1f} s, budget {limit_s} s")
    return failures


def roofline_kernel_bound(row: dict, n: int):
    """This script's ``bound()`` of the hand-kernel launches a roofline
    row reports (None for a row without one): the same counts as the
    kernel phases, so the roofline's bound column is PERF.md's."""
    kernel = row.get("kernel")
    if kernel is None:
        return None
    k = row["launches"]
    if kernel == "fused_gn":
        group = row["group"]
        return bound(
            k * 4 * (MIN_FLOATS_PER_PIXEL * n
                     + MIN_FLOATS_PER_GROUP * (n // group)),
            k * (FLOPS_PER_PIXEL_TRIP * row["trips"] * group
                 + FLOPS_PER_PIXEL_ONCE * n))["bound_ms"]
    p, nb = (int(v) for v in kernel[len("fused_update["):-1].split(","))
    read, written = update_floats(p, nb)
    return bound(k * 4.0 * (read + written) * n,
                 k * update_flops(p, nb) * n)["bound_ms"]


def phase_bench(device, workdir: str, contracts=None,
                n_device: int = BENCH_N_DEVICE,
                n_matched: int = BENCH_N_MATCHED, e2e=None,
                roofline_n: int = BENCH_N_DEVICE, slope=None,
                count_plain: bool = False,
                limit_s: float = BENCH_LIMIT_S, beside=None) -> dict:
    """The port's bench tools on ``device`` in a fresh process
    (``bench_child`` through ``bench_run``), gated by ``bench_gates``.
    ``contracts`` is phase contracts' record: its census stands in for
    the artifact's contracts snapshot (``contracts_snapshot_of``), which
    would trace the 16 programs again.  ``e2e`` overrides the Barrax
    grid (``ny``, ``nx``, ``n_dates``; a CPU rehearsal) and
    ``count_plain`` counts the plain versions as launches in the
    child.  ``beside`` runs in this process while the child runs (main
    passes phase lint, which touches no device); the child is killed if
    it raises."""
    import torch

    from kafka_tpu_torch.cli import drivers

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    cfg = {"device": str(device), "workdir": workdir, "n_device": n_device,
           "n_matched": n_matched, "e2e": dict(e2e or {}),
           "roofline_n": roofline_n, "slope": dict(slope or BENCH_SLOPE),
           "count_plain": count_plain, "contracts": None}
    if contracts is not None:
        cfg["contracts"] = os.path.join(workdir, "contracts.json")
        with open(cfg["contracts"], "w") as f:
            json.dump(contracts_snapshot_of(contracts), f)
    cfg_path = os.path.join(workdir, "bench_config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    logs = [os.path.join(workdir, f"bench_child.{n}") for n in ("out", "err")]
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.bench_child()", cfg_path],
            cwd=here, env=drivers.child_env(), stdout=out, stderr=err,
            text=True)
        try:
            if beside is not None:
                beside()
            proc.wait(timeout=BENCH_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    stdout, stderr = (pathlib.Path(path).read_text() for path in logs)
    child = _last_json(stdout)
    child = child if isinstance(child, dict) and child.get("bench_child") \
        else None
    docs = {}
    for name in ("artifact", "roofline") if child is not None else ():
        if os.path.exists(child[name]):
            with open(child[name]) as f:
                docs[name] = json.load(f)
    artifact, roof = docs.get("artifact"), docs.get("roofline")
    failures = bench_gates(child, artifact, roof, proc.returncode, wall,
                           limit_s)
    rec = {
        "phase": "bench", "device": str(device), "rc": proc.returncode,
        "n_device": n_device, "n_matched": n_matched, "e2e": cfg["e2e"],
        "slope": cfg["slope"], "roofline_args": list(BENCH_ROOFLINE_ARGS),
        "rows": {k: (artifact or {}).get(k) for k in BENCH_ROWS},
        "artifact_keys_match": artifact is not None and
        set(artifact) == BENCH_KEYS,
        "roofline": [{k: r.get(k) for k in (
            "component", "ms", "ms_spread", "min_traffic_bytes",
            "pct_hbm_roof_lower_bound", "kernel", "launches", "bound_ms",
            "bound_by", "share_of_bound", "n_iterations")}
            for r in (roof or {}).get("rows", ())],
        "launches": child and child["launches"],
        "launches_by_step": child and child["launches_by_step"],
        "plain_calls": child and child["plain_calls"],
        "tools": child and {name: {k: t[k] for k in ("argv", "rc", "s")}
                            for name, t in child["tools"].items()},
        "tool_tails": child and {name: t["stdout_tail"][-300:]
                                 for name, t in child["tools"].items()},
        "foreign_modules": child and child["foreign_modules"],
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
        "seconds": {"phase": wall, "budget": limit_s,
                    **((child or {}).get("seconds") or {})},
        "stderr_tail": stderr[-1500:] if child is None else None,
        "failures": failures,
    }
    emit(rec)
    if failures:
        raise AssertionError("bench: " + "; ".join(failures))
    return rec


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
        gp_rows, prosail_rows, solve_rows

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
            "prosail_rows": prosail_rows.kernel_attributes(),
            "gp_rows_10": gp_rows.kernel_attributes(10),
        },
    })
    phase_reference(device)
    ref_s2 = phase_reference_s2(device)
    main_run, s2_run = {}, {}
    main_rec, kept = phase_main(device, keep_run=main_run)
    tile = phase_kernel(device, "main_path_date", kept)
    small = phase_kernel(device, "2^19", problem_rows(2 ** 19, device),
                         plain_reps=3)
    for label, n_pix, tol in GROUP_CASES:
        rows, observed = group_case_rows(n_pix, tol, device)
        phase_kernel(device, label, rows, observed=observed)
    phase_faults(device, kept)
    tip_rows = tip_update_rows(kept)
    del kept
    s2_rec, kept_s2, s2_date_args = phase_main_s2(device, keep_run=s2_run)
    mesh_rec = phase_mesh(device, main_run, s2_run)
    del main_run, s2_run
    upd = phase_kernel_update(device, "main_s2_date", kept_s2)
    upd_small = phase_kernel_update(device, "2^19",
                                    prosail_update_rows(2 ** 19, device))
    phase_faults_update(device, kept_s2)
    lin_rec = phase_prosail_rows(device)
    gp_main, gp_banks = phase_main_gp(device)
    gp_rec = phase_gp_rows(device, gp_banks)
    del gp_banks
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
        dist_rec = phase_distributed(device, workdir)
        queue_rec = phase_queue(device, workdir)
        reports = run_reports(queue_reports(workdir))
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
    modes_rec = phase_batch_modes(device)
    os.makedirs(workdir)
    try:
        dp_rec = phase_device_plane(device, workdir,
                                    kernel_ms=cli_kernel["ms"],
                                    serve_shas=serve_rec["x_sha256"])
        reports.update(run_reports(device_plane_reports(workdir)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    contracts_rec = phase_contracts(device)
    os.makedirs(workdir)
    try:
        route_rec = phase_route(device, workdir,
                                serve_shas=serve_rec["x_sha256"])
        reports.update(run_reports(route_reports(workdir)))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        tools_rec = phase_operator_tools(
            device, workdir, serve_shas=serve_rec["x_sha256"],
            reports=reports, fused_gn_captured=dp_rec["capture"]
            ["fused_gn_launches_captured"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        bench_rec = phase_bench(device, workdir, contracts=contracts_rec,
                                beside=phase_lint)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    route_gn = sum(c["launches"]["fused_gn"]
                   for c in route_rec["replicas_out"].values() if c)
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
                   "mesh": mesh_rec["tip_tile"]["kernel_launches"]
                   ["fused_gn"],
                   "mesh_split_groups": mesh_rec["tip_tile_split_groups"]
                   ["kernel_launches"]["fused_gn"],
                   "distributed": dist_rec["one_process"]
                   ["kernel_launches"]["fused_gn"],
                   "queue": queue_rec["static"]["kernel_launches"]
                   ["fused_gn"],
                   "cli": cli_rec["fused_gn_launches"],
                   "cli_modis": modis_rec["kernel_launches"]["fused_gn"],
                   "hessian": hess_rec["kernel_launches"]["fused_gn"],
                   "smooth": smooth_rec["kernel_launches"]["fused_gn"],
                   "serve": serve_rec["kernel_launches"]["fused_gn"],
                   "serve_batch": batch_rec["runs"]["twostream"]
                   ["launches"]["fused_gn"],
                   "device_plane": dp_rec["engine"]["device_plane"]
                   ["engine_fused_gn_launches"],
                   "device_plane_serve": dp_rec["serve"]
                   ["kernel_launches"]["fused_gn"],
                   "route_survivors": route_gn,
                   "mesh_profilez": mesh_rec["profilez"]
                   ["fused_gn_launches"],
                   "device_plane_copier": dp_rec[
                       "profilez_beside_a_copier"]["launches"],
                   "contracts": contracts_rec["kernel_launches"]
                   .get("fused_gn", 0),
                   "operator_tools_loadgen": tools_rec["loadgen_root"]
                   ["kernel_launches"]["fused_gn"],
                   "bench": bench_rec["launches"]["fused_gn"]},
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
                   "mesh_s2": mesh_rec["s2_subtile"]["kernel_launches"]
                   ["fused_update"],
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
                   ["launches"]["fused_update"],
                   "batch_modes": modes_rec["per_pixel"]["batch_launches"]
                   ["fused_update"],
                   "contracts": sum(
                       n for k, n in contracts_rec["kernel_launches"].items()
                       if k.startswith("fused_update[")),
                   **{f"operator_tools_{name}": m["kernel_launches"]
                      ["fused_update_by_instance"].get(
                          TOOLS_MODES_INSTANCE, 0)
                      for name, m in tools_rec["modes"].items()},
                   "bench": bench_rec["launches"]["fused_update"]},
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
        kernel_entry(
            "prosail_rows", "cuda", "kafka_tpu_torch/csrc/prosail_rows.cu",
            PROSAIL_ROWS_REPLACES, s2_rec["kernel_launches"]["prosail_rows"],
            "phase main_s2: KalmanFilter.run, S2 sub-tile, one launch a "
            "Gauss-Newton trip", lin_rec,
            registers=lin_rec["registers"],
            spill_bytes=lin_rec["spill_bytes"],
            ops_per_px=lin_rec["ops_per_px"],
            paths={"main_s2": s2_rec["kernel_launches"]["prosail_rows"],
                   "cli_s2": s2_cli_rec["kernel_launches"]["prosail_rows"]},
            date=lin_rec["date"]),
        kernel_entry(
            "gp_rows", "cuda", "kafka_tpu_torch/csrc/gp_rows.cu",
            GP_ROWS_REPLACES, gp_main["kernel_launches"]["gp_rows"],
            f"phase main_gp: KalmanFilter.run, one chunk of {GP_CELL}, "
            "one launch a Gauss-Newton trip", gp_rec, err_key="h0",
            max_abs_err_jac=gp_rec["max_abs_err"]["jac"],
            max_err_vs_f64=gp_rec["max_err_vs_f64"],
            paths={"main_gp": gp_main["kernel_launches"]["gp_rows"],
                   "main_gp_trips": gp_main["trips"],
                   "gp_rows_date": gp_rec["date"]["launches"][0]},
            registers=gp_rec["registers"],
            spill_bytes=gp_rec["spill_bytes"],
            share_of_bound=gp_rec["share_of_bound"],
            date=gp_rec["date"]),
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
