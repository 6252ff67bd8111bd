"""The filter orchestrator (port of ``kafka_tpu/engine/filter.py``).

Drives the time loop of the reference's ``LinearKalman.run``: iterate the
temporal grid, advance the state between steps, assimilate every
acquisition in the window (all bands jointly), dump each timestep's
analysis.  Each date is one ``core.solvers.assimilate_date`` call; for
the two-stream operator that is one launch of the fused Gauss-Newton
kernel, for PROSAIL one launch of the fused update per Gauss-Newton
iteration.  The date's ``obs.aux`` reaches the solver as the operator
params.

As in the JAX engine:

- observations are read ahead on worker threads
  (``engine.prefetch.ObservationPrefetcher``, ``prefetch_depth``), with
  retries under a ``RetryPolicy``; a date whose read exhausts its
  transient retries is assimilated as missing (predict-only), up to
  ``max_degraded_dates`` per run;
- runs of consecutive one-acquisition windows are fused
  (``scan_window``, default 8): up to that many windows, bucketed to a
  power of two and bounded by the ``_SCAN_MAX_*`` element guards, run as
  one ``core.solvers.assimilate_windows_scan`` call with one packed
  diagnostic read per block.  The fused and the unfused path run the
  same operations in the same order, so they give the same bits;
- checkpoints are cadenced (``checkpoint_every_n``, the forecast sidecar
  on adjacent windows) and ``run(..., advance_first=True)`` resumes from
  one; a state padded for another pixel batch is re-padded.

- ``hessian_correction`` hands the operator's ``forward_pixel`` to the
  solver (unfused, fused and band-sequential alike), which subtracts
  the second-order term under an eigenvalue floor;
- ``band_sequential`` assimilates an acquisition one band at a time
  through ``BandView``s (each band's posterior the next band's prior;
  fusion off), merging the diagnostics as the JAX engine does;
- ``per_pixel_convergence`` adds the frozen fraction to the date's one
  packed read (``kafka_engine_converged_frac``).

- every window lands in the quality ledger (``telemetry.quality``:
  ``record_window`` from the same host record, adding
  ``quality_verdict`` and ``quality_drift`` to it; ``record_missing``
  for a degraded date), and the ``obs.bias`` chaos site biases the
  fetched observations of armed fetch-order dates;
- ``date_dispatcher`` (None by default) replaces the per-date
  ``assimilate_date`` call of the unfused joint-band path with the same
  signature and result: the serving layer's batch executor points it
  at its rendezvous (``serve.batch``).

Not ported: mesh sharding (raises ``NotImplementedError`` when set) and
the performance gauges (``perf.record_window``), which come with the
device-plane slice.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import propagators as prop
from ..core import solver_health
from ..core.linalg import spd_inverse_batched
from ..core.solvers import assimilate_date
from ..core.time_grid import iterate_time_grid
from ..core.types import BandBatch
from ..resilience import (DEFAULT_READ_POLICY, TRANSIENT, DegradedDateError,
                          RetryPolicy, classify_failure, faults)
from ..telemetry import get_registry, quality, span, tracing
from .prefetch import ObservationPrefetcher
from .protocols import DateObservation, ObservationSource, OutputWriter, Prior
from .state import make_pixel_gather

LOG = logging.getLogger(__name__)


class KalmanFilter:
    """Raster-time-series Kalman/information filter on one device.

    Injection points as in the JAX package: ``observations`` (an
    ``ObservationSource``), ``output`` (an ``OutputWriter``), the operator
    (inside each ``DateObservation``), ``state_propagation`` (a
    propagator callable, or None for prior-only advance) and ``prior``.
    The other arguments mean what they mean in the JAX ``KalmanFilter``.
    ``device`` defaults to CUDA and raises without one.
    """

    def __init__(
        self,
        observations: ObservationSource,
        output: OutputWriter,
        state_mask: np.ndarray,
        parameter_list: Sequence[str],
        state_propagation: Optional[Callable] = None,
        prior: Optional[Prior] = None,
        pad_multiple: int = 256,
        diagnostics: bool = True,
        solver_options: Optional[dict] = None,
        hessian_correction: bool = False,
        prefetch_depth: int = 2,
        prefetch_workers: int = 1,
        scan_window: int = 8,
        mesh=None,
        checkpoint_every_n: int = 1,
        band_sequential: bool = False,
        read_retry_policy: Optional[RetryPolicy] = None,
        max_degraded_dates: int = 8,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh is not ported yet (ROADMAP.md, Queue 1)")
        self.device = resolve_device(device)
        self.observations = observations
        self.output = output
        self.parameter_list = tuple(parameter_list)
        self.n_params = len(self.parameter_list)
        self.gather = make_pixel_gather(state_mask, pad_multiple)
        self._state_propagator = state_propagation
        self.prior = prior
        self.solver_options = solver_options
        # Second-order correction of the posterior information (the
        # operator's forward_pixel goes to the solver).
        self.hessian_correction = bool(hessian_correction)
        # The reference's band-by-band assimilation; disables fusion.
        self.band_sequential = bool(band_sequential)
        self._band_views: dict = {}
        # Depth of the observation prefetch; 0 reads synchronously.
        self.prefetch_depth = int(prefetch_depth)
        self.prefetch_workers = max(1, int(prefetch_workers))
        self._prefetcher = None
        # Temporal fusion: up to this many consecutive one-acquisition
        # windows run as one assimilate_windows_scan call; 1 disables it.
        self.scan_window = max(1, int(scan_window))
        # Observations fetched while probing a fusion block but consumed
        # by the unfused path instead (prefetcher dates pop exactly once).
        self._pending_obs: dict = {}
        self._window_verdicts = None
        self._read_policy = read_retry_policy \
            if read_retry_policy is not None else DEFAULT_READ_POLICY
        self.max_degraded_dates = max_degraded_dates
        self._degraded_count = 0
        # Dates the fusion-probing path already consumed as degraded; the
        # unfused window path reads the degradation from here.
        self._degraded_pending: set = set()
        # Save at most every N grid windows (the last window always
        # saves); fused blocks count as their window span.
        self.checkpoint_every_n = max(1, int(checkpoint_every_n))
        self._windows_since_ckpt = 0
        # Per-date dispatch hook: the serving layer's batch executor
        # points this at its rendezvous so compatible concurrent serves
        # coalesce into one launch (serve.batch).  None dispatches
        # ``assimilate_date`` directly — same signature, same result.
        # Only the unfused joint-band path honours it; fused blocks and
        # band-sequential keep their own launches.
        self.date_dispatcher = None
        # Fetch-order date number (the obs.bias address); reset per run.
        self._obs_date_no = 0
        self.diagnostics = diagnostics
        self.diagnostics_log: list = []
        self.set_trajectory_model()
        self.trajectory_uncertainty = torch.zeros(
            self.n_params, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # configuration (reference API parity)
    # ------------------------------------------------------------------

    def set_trajectory_model(self, m: Optional[np.ndarray] = None) -> None:
        """Identity by default (``linear_kf.py:123``)."""
        self.trajectory_model = (
            torch.eye(self.n_params, dtype=torch.float32, device=self.device)
            if m is None else torch.as_tensor(m, dtype=torch.float32,
                                              device=self.device))

    def set_trajectory_uncertainty(self, q_diag) -> None:
        """Per-parameter model-error diagonal Q (linear_kf.py:131-146)."""
        q = np.asarray(q_diag, np.float32)
        if q.ndim == 0:
            q = np.full((self.n_params,), float(q), np.float32)
        self.trajectory_uncertainty = torch.as_tensor(q, device=self.device)

    # ------------------------------------------------------------------
    # the time loop
    # ------------------------------------------------------------------

    def _prior_arrays(self, date):
        prior_mean, prior_inv = self.prior.process_prior(date, self.gather)
        return prior_mean.to(self.device), prior_inv.to(self.device)

    def advance(self, x_analysis, p_analysis, p_analysis_inverse,
                date: datetime.datetime):
        """State propagation + prior blending (``LinearKalman.advance``)."""
        prior_mean = prior_inv = None
        if self.prior is not None:
            prior_mean, prior_inv = self._prior_arrays(date)
        return prop.advance(
            x_analysis, p_analysis, p_analysis_inverse,
            self.trajectory_model, self.trajectory_uncertainty,
            prior_mean=prior_mean, prior_cov_inverse=prior_inv,
            state_propagator=self._state_propagator,
        )

    def _fetch(self, date) -> Optional[DateObservation]:
        """The date's observation, or None when its read DEGRADED (the
        caller must then treat the date as having no observation)."""
        if self._pending_obs:
            hit = self._pending_obs.pop(date, None)
            if hit is not None:
                return hit
        if date in self._degraded_pending:
            self._degraded_pending.discard(date)
            return None
        # One number per date, in fetch order (pending replays above
        # were numbered when first fetched) — the obs.bias address.
        self._obs_date_no += 1
        date_no = self._obs_date_no
        if self._prefetcher is not None:
            try:
                return self._apply_obs_bias(self._prefetcher.get(date),
                                            date_no)
            except DegradedDateError as exc:
                self._note_degraded(date, exc.cause)
                return None

        def read():
            faults.fault_point("prefetch.read_date", date=str(date))
            return self.observations.get_observations(date, self.gather)

        try:
            obs = self._read_policy.call(read, site="prefetch.read_date")
        except BaseException as exc:
            if classify_failure(exc) != TRANSIENT:
                raise
            self._note_degraded(date, exc)
            return None
        return self._apply_obs_bias(obs, date_no)

    def _apply_obs_bias(self, obs: DateObservation,
                        date_no: int) -> DateObservation:
        """The ``obs.bias`` chaos site: when an armed fault spec matches
        this fetch-order date number, add the scripted bias to the
        date's VALID observations (masked entries stay untouched);
        disarmed, nothing is touched at all."""
        bias = quality.observation_bias(date_no)
        if bias is None:
            return obs
        bands = obs.bands
        y = torch.as_tensor(bands.y)
        mask = torch.as_tensor(bands.mask, device=y.device)
        y = torch.where(mask, y + torch.tensor(bias, dtype=y.dtype,
                                               device=y.device), y)
        return obs._replace(bands=BandBatch(
            y=y, r_inv=bands.r_inv, mask=bands.mask,
        ))

    def _note_degraded(self, date, exc: BaseException) -> None:
        """Record one degraded date (counter + event + budget check)."""
        self._degraded_count += 1
        reg = get_registry()
        reg.counter(
            "kafka_engine_dates_degraded_total",
            "observation dates whose read exhausted transient-failure "
            "retries and were assimilated as missing (predict-only)",
        ).inc()
        reg.emit(
            "date_degraded", date=str(date), error=repr(exc)[:300],
            degraded_total=self._degraded_count,
            budget=self.max_degraded_dates,
        )
        LOG.warning(
            "observation read for %s degraded after retries (%r); "
            "treating as a missing observation (%d of %s budget)",
            date, exc, self._degraded_count, self.max_degraded_dates,
        )
        # The quality ledger keeps the hole visible: a thinned series
        # is itself a quality signal.
        ctx = tracing.current_context()
        quality.get_ledger(reg).record_missing(
            date, reason="degraded_read",
            prefix=None if ctx is None else ctx.chunk_id,
        )
        if self.max_degraded_dates is not None and \
                self._degraded_count > self.max_degraded_dates:
            raise RuntimeError(
                f"{self._degraded_count} degraded observation dates "
                f"exceed max_degraded_dates={self.max_degraded_dates}; "
                "aborting (systemic read outage, not transient weather)"
            ) from exc

    def date_solver_options(self, operator) -> dict:
        """The per-date solver-option dict as the time loop dispatches it:
        the operator's state bounds, the convergence norm over valid
        pixels only, and blocked linearisation on big batches (used by
        the row loop and the plain loop; the in-kernel fused Gauss-Newton
        path ignores it)."""
        opts = dict(self.solver_options or {})
        if "state_bounds" not in opts and \
                getattr(operator, "state_bounds", None) is not None:
            lo, hi = operator.state_bounds
            opts["state_bounds"] = (
                torch.as_tensor(lo, dtype=torch.float32, device=self.device),
                torch.as_tensor(hi, dtype=torch.float32, device=self.device),
            )
        opts.setdefault("norm_denominator",
                        float(self.gather.n_valid * self.n_params))
        if self.gather.n_pad > 262144:
            opts.setdefault("linearize_block", 262144)
        return opts

    def assimilate_dates(self, dates, x_forecast, p_forecast,
                         p_forecast_inverse):
        """Assimilate each acquisition in the window in turn, each
        posterior becoming the next forecast."""
        x_a, p_a, p_inv_a = x_forecast, p_forecast, p_forecast_inverse
        if p_inv_a is None and p_a is not None:
            p_inv_a = spd_inverse_batched(p_a.float())
        self._window_verdicts = None
        for date in dates:
            obs = self._fetch(date)
            if obs is None:
                # Degraded date: the forecast passes through unchanged.
                LOG.info("Skipping degraded date %s (predict-only)", date)
                continue
            faults.fault_point("device.oom", date=str(date))
            t0 = time.perf_counter()
            opts = self.date_solver_options(obs.operator)
            if self.band_sequential:
                x_a, p_inv_a, diags = self._assimilate_band_sequential(
                    obs, x_a, p_inv_a, opts)
            elif self.date_dispatcher is not None:
                x_a, p_inv_a, diags = self.date_dispatcher(
                    obs.operator.linearize, obs.bands, x_a, p_inv_a,
                    obs.aux, opts or None,
                    self._hessian_forward(obs.operator),
                )
            else:
                x_a, p_inv_a, diags = assimilate_date(
                    obs.operator.linearize, obs.bands, x_a, p_inv_a,
                    obs.aux, opts or None,
                    self._hessian_forward(obs.operator),
                    device=self.device,
                )
            p_a = None
            if diags.health_verdicts is not None:
                self._window_verdicts = (
                    diags.health_verdicts if self._window_verdicts is None
                    else solver_health.merge_verdicts(
                        self._window_verdicts, diags.health_verdicts)
                )
            if self.diagnostics:
                self._record_window(self._date_record(date, obs, diags, t0))
        return x_a, p_a, p_inv_a

    def _hessian_forward(self, operator):
        """The per-pixel forward model for the Hessian correction, or
        None when the correction is off."""
        if not self.hessian_correction:
            return None
        return getattr(operator, "forward_pixel", None)

    def _band_view(self, operator, band: int):
        """The cached single-band view of ``operator``.  A linearize-only
        operator fails here with a clear message: the sequential mode
        slices the operator's ``forward_pixel`` per band."""
        from ..obsops.protocol import BandView, ObservationModel

        fwd = getattr(type(operator), "forward_pixel", None)
        if fwd is None or fwd is ObservationModel.forward_pixel:
            raise TypeError(
                "band_sequential=True requires the operator to "
                "implement forward_pixel; "
                f"{type(operator).__name__} only provides linearize"
            )
        key = (id(operator), band)
        view = self._band_views.get(key)
        if view is None or view.inner is not operator:
            view = self._band_views[key] = BandView(operator, band)
        return view

    def _assimilate_band_sequential(self, obs, x_a, p_inv_a, opts):
        """One acquisition with its bands assimilated one after another
        (the reference's ``assimilate_band`` semantics): per band a full
        Gauss-Newton loop, its posterior the next band's prior, the
        Hessian correction per band.  Merged as the JAX engine merges:
        iterations summed, the worst band's norm, converged masks ANDed,
        innovations, residuals and chi^2 concatenated, nodata summed,
        the last band's clipped counts; verdicts ORed (NODATA only where
        no band observed) with their counts recomputed, non-finite
        counts summed."""
        n_bands = obs.bands.y.shape[0]
        iters_total = 0
        norms, masks, innovations, fwds, chi2s = [], [], [], [], []
        verds, nonfins = [], []
        nodata_total = None
        last = None
        for b in range(n_bands):
            band_obs = BandBatch(y=obs.bands.y[b:b + 1],
                                 r_inv=obs.bands.r_inv[b:b + 1],
                                 mask=obs.bands.mask[b:b + 1])
            view = self._band_view(obs.operator, b)
            x_a, p_inv_a, last = assimilate_date(
                view.linearize, band_obs, x_a, p_inv_a, obs.aux,
                opts or None, self._hessian_forward(view),
                device=self.device,
            )
            iters_total = iters_total + last.n_iterations
            norms.append(last.convergence_norm)
            innovations.append(last.innovations)
            fwds.append(last.fwd_modelled)
            chi2s.append(last.chi2_per_band)
            nodata_total = last.nodata_count if nodata_total is None \
                else nodata_total + last.nodata_count
            if last.converged_mask is not None:
                masks.append(last.converged_mask)
            if last.health_verdicts is not None:
                verds.append(last.health_verdicts)
                nonfins.append(last.nonfinite_count)
        diags = last._replace(
            n_iterations=iters_total,
            convergence_norm=torch.stack(norms).max(),
            innovations=torch.cat(innovations),
            fwd_modelled=torch.cat(fwds),
            converged_mask=(torch.stack(masks).all(dim=0) if masks
                            else None),
            chi2_per_band=torch.cat(chi2s),
            nodata_count=nodata_total,
        )
        if verds and len(verds) == n_bands:
            merged = verds[0]
            for v in verds[1:]:
                merged = solver_health.merge_verdicts(merged, v)
            cap, damped, quar = solver_health.verdict_counts(merged)
            diags = diags._replace(
                health_verdicts=merged, cap_bailout_count=cap,
                damped_recovered_count=damped, quarantined_count=quar,
                nonfinite_count=sum(nonfins),
            )
        return x_a, p_inv_a, diags

    def _nodata_valid(self, raw: int, n_bands: int) -> int:
        """Nodata count over real pixels: the device-side count includes
        the padding rows (mask False in every band there)."""
        pad = self.gather.n_pad - self.gather.n_valid
        return max(0, raw - n_bands * pad)

    def _date_record(self, date, obs, diags, t0) -> dict:
        """The per-date diagnostic record, from ONE packed device->host
        read of every scalar (the wall time includes that sync)."""
        n_bands = obs.bands.y.shape[0]
        parts = [
            torch.stack([
                torch.as_tensor(diags.n_iterations).float(),
                torch.as_tensor(diags.convergence_norm).float(),
                torch.as_tensor(diags.clipped_count).float(),
                torch.as_tensor(diags.nodata_count).float(),
            ]),
            diags.chi2_per_band.float(),
        ]
        has_frac = diags.converged_mask is not None
        if has_frac:
            # The frozen fraction over valid pixels joins the same read.
            parts.append(diags.converged_mask[:self.gather.n_valid]
                         .float().mean()[None])
        has_health = diags.health_verdicts is not None
        if has_health:
            parts.append(torch.stack([
                diags.cap_bailout_count.float(),
                diags.damped_recovered_count.float(),
                diags.quarantined_count.float(),
                diags.nonfinite_count.float(),
            ]))
            parts.append(diags.clip_saturated_count.float())
        packed = torch.cat(parts).cpu().numpy()
        rec = {
            "date": date,
            "n_iterations": int(packed[0]),
            "convergence_norm": float(packed[1]),
            "bounds_clipped": int(packed[2]),
            "nodata": self._nodata_valid(int(packed[3]), n_bands),
            "chi2_per_band": [float(v) for v in packed[4:4 + n_bands]],
            "wall_s": time.perf_counter() - t0,
        }
        if has_frac:
            rec["converged_frac"] = float(packed[4 + n_bands])
        if has_health:
            h0 = 4 + n_bands + int(has_frac)
            rec["cap_bailouts"] = int(packed[h0])
            rec["damped_recovered"] = int(packed[h0 + 1])
            rec["quarantined"] = int(packed[h0 + 2])
            rec["nonfinite"] = int(packed[h0 + 3])
            rec["clip_saturated"] = [
                int(v) for v in packed[h0 + 4:h0 + 4 + self.n_params]]
        LOG.info("Assimilated %s: %d iterations, norm %.3g, %.2fs", date,
                 rec["n_iterations"], rec["convergence_norm"], rec["wall_s"])
        return rec

    def _record_window(self, rec: dict) -> None:
        """Keep one window's record and land it in the telemetry
        registry (the JAX package's metric names, help strings, labels
        and buckets), from the host record alone: no device read."""
        self.diagnostics_log.append(rec)
        reg = get_registry()
        reg.counter(
            "kafka_engine_windows_total", "assimilated observation windows",
        ).inc(mode="fused" if "fused" in rec else "single")
        reg.counter(
            "kafka_engine_pixels_total",
            "valid pixels assimilated, summed over windows",
        ).inc(self.gather.n_valid)
        reg.histogram(
            "kafka_engine_gn_iterations",
            "Gauss-Newton iterations to convergence per window",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 25, 40),
        ).observe(rec["n_iterations"])
        reg.gauge(
            "kafka_engine_convergence_norm",
            "final Gauss-Newton step norm of the latest window",
        ).set(rec["convergence_norm"])
        chi2_hist = reg.histogram(
            "kafka_engine_innovation_chi2",
            "mean innovation chi^2 per band per window (~1 when the "
            "assumed observation uncertainty matches residuals)",
            buckets=(0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0, 10.0,
                     100.0),
        )
        for b, v in enumerate(rec["chi2_per_band"]):
            chi2_hist.observe(v, band=b)
        reg.counter(
            "kafka_engine_bounds_clipped_total",
            "state entries projected onto state_bounds (observed "
            "pixels only)",
        ).inc(rec["bounds_clipped"])
        reg.counter(
            "kafka_engine_nodata_pixels_total",
            "masked-out (NaN/nodata) observation entries across bands",
        ).inc(rec["nodata"])
        if "converged_frac" in rec:
            reg.gauge(
                "kafka_engine_converged_frac",
                "fraction of valid pixels frozen at convergence "
                "(per_pixel_convergence mode)",
            ).set(rec["converged_frac"])
        if "quarantined" in rec:
            self._record_solver_health(reg, rec)
        # Quality ledger: the window's consistency record, built from
        # the same host-side scalars (the packed read already paid) —
        # zero added device transfers.  The verdict is folded back into
        # the record so serve responses can report it.
        ctx = tracing.current_context()
        entry = quality.get_ledger(reg).record_window(
            date=rec["date"],
            chi2_per_band=rec["chi2_per_band"],
            n_valid=self.gather.n_valid,
            solver_health=(
                {
                    "quarantined": rec["quarantined"],
                    "cap_bailouts": rec["cap_bailouts"],
                    "damped_recovered": rec["damped_recovered"],
                    "nonfinite": rec["nonfinite"],
                } if "quarantined" in rec else None
            ),
            prefix=None if ctx is None else ctx.chunk_id,
            fused=rec.get("fused"),
        )
        rec["quality_verdict"] = entry["verdict"]
        rec["quality_drift"] = entry["drift"]["active"]
        reg.emit("solve", **{k: (str(v) if k == "date" else v)
                             for k, v in rec.items()})

    def _record_solver_health(self, reg, rec: dict) -> None:
        """Solve-health counters and events of one window's record."""
        reg.counter(
            "kafka_solver_cap_bailouts_total",
            "observed pixels still moving when the Gauss-Newton loop "
            "hit its iteration cap (the reference's silent bailout, "
            "counted)",
        ).inc(rec["cap_bailouts"])
        reg.counter(
            "kafka_solver_damped_recoveries_total",
            "pixels that went numerically bad mid-loop, took the "
            "Levenberg-Marquardt damping escalation and recovered",
        ).inc(rec["damped_recovered"])
        reg.counter(
            "kafka_solver_quarantined_pixels_total",
            "pixels still bad after damping escalation, served as "
            "forecast with deflated information (QA_QUARANTINED)",
        ).inc(rec["quarantined"])
        reg.counter(
            "kafka_solver_nonfinite_total",
            "observed pixels whose raw Gauss-Newton step went "
            "non-finite at least once during the loop",
        ).inc(rec["nonfinite"])
        sat = rec.get("clip_saturated") or []
        c_sat = reg.counter(
            "kafka_solver_clip_saturated_total",
            "pixels clipped to a state_bounds limit on EVERY "
            "iteration, per parameter — a pinned pixel is a masked "
            "divergence",
        )
        for name, v in zip(self.parameter_list, sat):
            if v:
                c_sat.inc(v, param=name)
        if any(sat):
            reg.emit(
                "solver_clip_saturated", date=str(rec["date"]),
                counts={name: int(v)
                        for name, v in zip(self.parameter_list, sat) if v},
            )
        if rec["quarantined"]:
            reg.emit(
                "solver_pixels_quarantined", date=str(rec["date"]),
                count=rec["quarantined"],
            )

    def run(self, time_grid, x_forecast, p_forecast, p_forecast_inverse,
            checkpointer=None, advance_first=False):
        """Full assimilation run (``LinearKalman.run``).  ``x_forecast``
        may be (n_pad, p) or the flat interleaved layout; arrays may be
        tensors or numpy and are placed on the filter's device.

        ``advance_first=True`` applies the state propagation/prior blend
        before the FIRST grid step too — required when resuming from a
        checkpoint, where the loaded state is an analysis whose advance
        into the first resumed window hasn't happened yet."""
        f32 = torch.float32

        def on_device(a):
            return None if a is None else torch.as_tensor(
                a, dtype=f32, device=self.device)

        x_forecast = on_device(x_forecast).reshape(-1, self.n_params)
        p_forecast = on_device(p_forecast)
        p_forecast_inverse = on_device(p_forecast_inverse)
        if x_forecast.shape[0] != self.gather.n_pad:
            # A state checkpointed under another padding carries the
            # same n_valid real pixels in its leading rows: re-pad it.
            x_forecast, p_forecast, p_forecast_inverse = self._repad(
                x_forecast, p_forecast, p_forecast_inverse)
        # Snapshot the grid windowing ONCE: the loop and the prefetch
        # plan must see the identical date sequence.
        windows = list(iterate_time_grid(time_grid, self.observations.dates))
        if self.prefetch_depth > 0:
            plan = [d for _, locate_times, _ in windows
                    for d in locate_times]
            if plan:
                # A fused block collects all its observations before it
                # runs; a shallower prefetch would serialise those reads.
                depth = self.prefetch_depth
                if self._fusion_possible():
                    depth = max(depth, self.scan_window)
                self._prefetcher = ObservationPrefetcher(
                    self.observations, self.gather, plan, depth=depth,
                    workers=self.prefetch_workers,
                    retry_policy=self._read_policy,
                )
        try:
            with tracing.push():
                return self._run_loop(
                    windows, x_forecast, p_forecast, p_forecast_inverse,
                    checkpointer, advance_first,
                )
        finally:
            if self._prefetcher is not None:
                self._prefetcher.close()
                self._prefetcher = None

    def _repad(self, x, p_f, p_inv):
        """Re-pad a pixel-state triple to this gather's ``n_pad``: the
        leading ``n_valid`` rows are the real pixels (PixelGather layout
        invariant), new padding rows get zero state and identity
        information — inert in every solve, never scattered out."""
        n_valid, n_pad, p = self.gather.n_valid, self.gather.n_pad, \
            self.n_params
        if x.shape[0] < n_valid:
            raise ValueError(
                f"state has {x.shape[0]} rows but the mask holds "
                f"{n_valid} valid pixels — not a state of this chunk"
            )
        if x.shape[0] == self.gather.mask.size and \
                self.gather.mask.size != n_valid:
            # A row per raster cell is NOT PixelGather layout — slicing
            # its first n_valid rows would silently scramble pixels.
            raise ValueError(
                f"state has one row per raster cell ({x.shape[0]}); "
                "expected PixelGather layout (valid pixels first) — "
                "gather it with PixelGather.gather before run()"
            )
        LOG.info("re-padding state from %d to %d rows (%d valid pixels)",
                 x.shape[0], n_pad, n_valid)
        n_fill = n_pad - n_valid
        dev, f32 = self.device, torch.float32

        def pad2(a):
            return torch.cat([a[:n_valid],
                              torch.zeros((n_fill, p), dtype=f32,
                                          device=dev)])

        def pad3(a):
            eye = torch.eye(p, dtype=f32, device=dev)
            return torch.cat([a[:n_valid], eye.expand(n_fill, p, p)])

        return (pad2(x), None if p_f is None else pad3(p_f),
                None if p_inv is None else pad3(p_inv))

    # ------------------------------------------------------------------
    # temporal fusion
    # ------------------------------------------------------------------

    # Memory guards of a fused block (the JAX package's constants, counted
    # the same way — elements, not bytes, and aux bytes apart): K*n*p
    # elements for each of the two stacked result arrays, three stacked
    # band arrays of K*B*n, and the stacked aux bytes.
    _SCAN_MAX_STATE_ELEMS = 100_000_000
    _SCAN_MAX_BAND_ELEMS = 100_000_000
    _SCAN_MAX_AUX_BYTES = 64 * 1024 * 1024

    def _fusion_possible(self) -> bool:
        """Engine-level fusability: fusion on, not band-sequential, and a
        date-invariant (or absent) prior."""
        if self.scan_window <= 1 or self.band_sequential:
            return False
        return self.prior is None or bool(
            getattr(self.prior, "date_invariant", False))

    @staticmethod
    def _aux_leaves(aux):
        from ..core.solvers import _aux_leaves

        return [] if aux is None else _aux_leaves(aux)

    def _stackable(self, first: DateObservation,
                   other: DateObservation) -> bool:
        if other.operator is not first.operator:
            return False
        if other.bands.y.shape != first.bands.y.shape:
            return False
        if (first.aux is None) != (other.aux is None):
            return False
        la, lb = self._aux_leaves(first.aux), self._aux_leaves(other.aux)
        if len(la) != len(lb):
            return False
        return all(np.shape(a) == np.shape(b) for a, b in zip(la, lb))

    def _block_fits(self, obs: DateObservation, k: int) -> bool:
        n, p = self.gather.n_pad, self.n_params
        if k * n * p > self._SCAN_MAX_STATE_ELEMS:
            return False
        # Three stacked band arrays (y, r_inv, mask) are materialised.
        if 3 * k * int(np.prod(obs.bands.y.shape)) > \
                self._SCAN_MAX_BAND_ELEMS:
            return False
        aux_bytes = sum(
            int(np.prod(np.shape(a)) or 1)
            * int(getattr(getattr(a, "dtype", None), "itemsize", 4))
            for a in self._aux_leaves(obs.aux)
        )
        return k * aux_bytes <= self._SCAN_MAX_AUX_BYTES

    def _maybe_checkpoint(self, checkpointer, timestep, x, p_analysis,
                          p_inv, n_windows: int, is_last: bool,
                          forecast=None) -> None:
        """Cadenced checkpoint: counts processed grid windows and saves
        every ``checkpoint_every_n`` (the run's last window always saves).
        Queued output writes are flushed first; the state is persisted in
        information form.  ``forecast`` — the window's pre-update
        ``(x_f, p_f, p_f_inv)`` — is stored as the smoother's sidecar only
        when exactly one window elapsed since the previous save."""
        if checkpointer is None:
            return
        self._windows_since_ckpt += n_windows
        if not is_last and \
                self._windows_since_ckpt < self.checkpoint_every_n:
            return
        adjacent = n_windows == 1 and self._windows_since_ckpt == 1
        self._windows_since_ckpt = 0
        flush = getattr(self.output, "flush", None)
        if flush is not None:
            flush()
        p_inv_ck = p_inv
        if p_inv_ck is None and p_analysis is not None:
            p_inv_ck = spd_inverse_batched(p_analysis.float())
        x_f = p_f_inv = None
        if forecast is not None and adjacent:
            x_f, p_f, p_f_inv = forecast
            if p_f_inv is None and p_f is not None:
                p_f_inv = spd_inverse_batched(p_f.float())
            if x_f is None or p_f_inv is None:
                x_f = p_f_inv = None
        checkpointer.save(timestep, x, p_inv_ck, x_forecast=x_f,
                          p_forecast_inverse=p_f_inv)

    def _run_fused_block(self, block, x_analysis, p_analysis,
                         p_analysis_inverse, checkpointer,
                         is_last: bool = True):
        """Run K collected (timestep, obs) windows as one
        ``assimilate_windows_scan`` call."""
        from ..core.solvers import assimilate_windows_scan, stack_aux

        p_inv = p_analysis_inverse
        if p_inv is None and p_analysis is not None:
            p_inv = spd_inverse_batched(p_analysis.float())
        prior_mean = prior_inv = None
        if self.prior is not None:
            prior_mean, prior_inv = self._prior_arrays(block[0][0])
        first = block[0][1]
        opts = self.date_solver_options(first.operator)
        faults.fault_point("device.oom", date=str(block[0][0]))
        t0 = time.perf_counter()
        bands = BandBatch(
            y=torch.stack([o.bands.y for _, o in block]),
            r_inv=torch.stack([o.bands.r_inv for _, o in block]),
            mask=torch.stack([o.bands.mask for _, o in block]),
        )
        aux_stacked = stack_aux([o.aux for _, o in block])
        x_fin, p_inv_fin, xs, diag_s, iters, norms, converged, wstats = (
            assimilate_windows_scan(
                first.operator.linearize, bands, x_analysis, p_inv,
                aux_stacked, self.trajectory_model,
                self.trajectory_uncertainty, prior_mean, prior_inv,
                self._state_propagator, opts or None,
                self._hessian_forward(first.operator),
            )
        )
        timesteps = [ts for ts, _ in block]
        with span("dump"):
            dump_block = getattr(self.output, "dump_block", None)
            if dump_block is not None:
                dump_block(timesteps, xs, diag_s, self.gather,
                           self.parameter_list)
            else:
                for k, ts in enumerate(timesteps):
                    self.output.dump_data(ts, xs[k], diag_s[k], self.gather,
                                          self.parameter_list)
            if wstats.health_verdicts is not None:
                qa_block = getattr(self.output, "dump_qa_block", None)
                if qa_block is not None:
                    qa_block(timesteps, wstats.health_verdicts, self.gather)
                else:
                    qa_one = getattr(self.output, "dump_qa", None)
                    if qa_one is not None:
                        for k, ts in enumerate(timesteps):
                            qa_one(ts, wstats.health_verdicts[k],
                                   self.gather)
        if self.diagnostics:
            self._block_records(timesteps, first, iters, norms, converged,
                                wstats, t0)
        self._maybe_checkpoint(
            checkpointer, timesteps[-1], x_fin, None, p_inv_fin,
            n_windows=len(timesteps), is_last=is_last,
        )
        return x_fin, None, p_inv_fin

    def _block_records(self, timesteps, first, iters, norms, converged,
                       wstats, t0) -> None:
        """One record per fused window, from ONE packed device->host read
        of the whole block's scalars; ``wall_s`` is the block's wall time
        over its windows and ``fused`` the block's length."""
        k = len(timesteps)
        n_bands = first.bands.y.shape[0]
        p = self.n_params
        scalars = [iters.float(), norms.float(),
                   wstats.clipped_count.float(), wstats.nodata_count.float(),
                   wstats.chi2_per_band.float().reshape(-1)]
        if converged is not None:
            # Per window, the frozen fraction over valid pixels.
            scalars.append(converged[:, :self.gather.n_valid].float()
                           .mean(dim=1))
        has_health = wstats.health_verdicts is not None
        if has_health:
            scalars += [wstats.cap_bailout_count.float(),
                        wstats.damped_recovered_count.float(),
                        wstats.quarantined_count.float(),
                        wstats.nonfinite_count.float(),
                        wstats.clip_saturated_count.float().reshape(-1)]
        packed = torch.cat(scalars).cpu().numpy()
        wall = time.perf_counter() - t0
        chi0 = 4 * k
        h0 = chi0 + k * n_bands + (k if converged is not None else 0)
        for j, ts in enumerate(timesteps):
            rec = {
                "date": ts,
                "n_iterations": int(packed[j]),
                "convergence_norm": float(packed[k + j]),
                "bounds_clipped": int(packed[2 * k + j]),
                "nodata": self._nodata_valid(int(packed[3 * k + j]),
                                             n_bands),
                "chi2_per_band": [
                    float(v) for v in
                    packed[chi0 + j * n_bands:chi0 + (j + 1) * n_bands]],
                "wall_s": wall / k,
                "fused": k,
            }
            if converged is not None:
                rec["converged_frac"] = float(packed[chi0 + k * n_bands + j])
            if has_health:
                rec["cap_bailouts"] = int(packed[h0 + j])
                rec["damped_recovered"] = int(packed[h0 + k + j])
                rec["quarantined"] = int(packed[h0 + 2 * k + j])
                rec["nonfinite"] = int(packed[h0 + 3 * k + j])
                sat0 = h0 + 4 * k + j * p
                rec["clip_saturated"] = [int(v)
                                         for v in packed[sat0:sat0 + p]]
            self._record_window(rec)
        LOG.info("Assimilated %d fused windows ending %s in %.2fs", k,
                 timesteps[-1], wall)

    def _run_loop(self, windows, x_forecast, p_forecast,
                  p_forecast_inverse, checkpointer, advance_first):
        x_analysis, p_analysis, p_analysis_inverse = (
            x_forecast, p_forecast, p_forecast_inverse)
        self._pending_obs = {}
        self._degraded_pending = set()
        self._degraded_count = 0
        self._obs_date_no = 0
        self._windows_since_ckpt = 0
        idx = 0
        while idx < len(windows):
            with tracing.push(window_id=idx):
                timestep, locate_times, is_first = windows[idx]
                # Try to collect a run of fusable windows: each advances,
                # holds exactly one acquisition, and stacks with the head.
                if (self._fusion_possible()
                        and ((not is_first) or advance_first)
                        and len(locate_times) == 1):
                    block, block_dates = [], []
                    j = idx
                    while j < len(windows) and len(block) < self.scan_window:
                        ts_j, lt_j, _ = windows[j]
                        if len(lt_j) != 1:
                            break
                        obs_j = self._fetch(lt_j[0])
                        if obs_j is None:
                            # A degraded date can't join a fused block;
                            # park it so the unfused path sees None again.
                            self._degraded_pending.add(lt_j[0])
                            break
                        if (block and not self._stackable(block[0][1],
                                                          obs_j)) \
                                or not self._block_fits(obs_j,
                                                        len(block) + 1):
                            self._pending_obs[lt_j[0]] = obs_j
                            break
                        block.append((ts_j, obs_j))
                        block_dates.append(lt_j[0])
                        j += 1
                    # Bucket the block length to a power of two, as the
                    # JAX engine does (there, to bound recompiles): the
                    # buckets decide the block composition, the records'
                    # ``fused`` fields and the checkpoints.  Trimmed
                    # windows return their observations via _pending_obs.
                    k_bucket = 1
                    while k_bucket * 2 <= len(block):
                        k_bucket *= 2
                    for (_, obs_j), date_j in zip(block[k_bucket:],
                                                  block_dates[k_bucket:]):
                        self._pending_obs[date_j] = obs_j
                    block = block[:k_bucket]
                    if len(block) >= 2:
                        LOG.info("Advancing + assimilating %d fused windows "
                                 "%s..%s", len(block), block[0][0],
                                 block[-1][0])
                        with span("fused_scan"):
                            x_analysis, p_analysis, p_analysis_inverse = (
                                self._run_fused_block(
                                    block, x_analysis, p_analysis,
                                    p_analysis_inverse, checkpointer,
                                    is_last=(idx + len(block)
                                             == len(windows)),
                                ))
                        idx += len(block)
                        continue
                    if len(block) == 1:
                        # Hand the fetched observation to the unfused path.
                        self._pending_obs[locate_times[0]] = block[0][1]
                x_analysis, p_analysis, p_analysis_inverse = (
                    self._run_one_window(
                        windows[idx], x_analysis, p_analysis,
                        p_analysis_inverse, checkpointer, advance_first,
                        is_last=(idx == len(windows) - 1),
                    ))
                idx += 1
        return x_analysis, p_analysis, p_analysis_inverse

    def _run_one_window(self, window, x_analysis, p_analysis,
                        p_analysis_inverse, checkpointer, advance_first,
                        is_last: bool = True):
        timestep, locate_times, is_first = window
        x_forecast, p_forecast, p_forecast_inverse = (
            x_analysis, p_analysis, p_analysis_inverse)
        if (not is_first) or advance_first:
            LOG.info("Advancing state to %s", timestep)
            with span("advance"):
                x_forecast, p_forecast, p_forecast_inverse = self.advance(
                    x_analysis, p_analysis, p_analysis_inverse, timestep)
        if len(locate_times) == 0:
            LOG.info("No observations in window ending %s", timestep)
            x_analysis, p_analysis, p_analysis_inverse = (
                x_forecast, p_forecast, p_forecast_inverse)
            self._window_verdicts = None
        else:
            with span("assimilate"):
                x_analysis, p_analysis, p_analysis_inverse = \
                    self.assimilate_dates(locate_times, x_forecast,
                                          p_forecast, p_forecast_inverse)
        p_inv_diag = self._information_diagonal(p_analysis,
                                                p_analysis_inverse)
        with span("dump"):
            self.output.dump_data(timestep, x_analysis, p_inv_diag,
                                  self.gather, self.parameter_list)
            if self._window_verdicts is not None:
                dump_qa = getattr(self.output, "dump_qa", None)
                if dump_qa is not None:
                    dump_qa(timestep, self._window_verdicts, self.gather)
        self._maybe_checkpoint(
            checkpointer, timestep, x_analysis, p_analysis,
            p_analysis_inverse, n_windows=1, is_last=is_last,
            forecast=(x_forecast, p_forecast, p_forecast_inverse),
        )
        return x_analysis, p_analysis, p_analysis_inverse

    @staticmethod
    def _information_diagonal(p_analysis, p_analysis_inverse):
        """Per-pixel information diagonal for the sigma outputs."""
        if p_analysis_inverse is not None:
            return torch.diagonal(p_analysis_inverse, dim1=-2, dim2=-1)
        if p_analysis is not None:
            return 1.0 / torch.diagonal(p_analysis, dim1=-2,
                                        dim2=-1).clamp(min=1e-30)
        return None
