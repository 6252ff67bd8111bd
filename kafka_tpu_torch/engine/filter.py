"""The filter orchestrator (port of ``kafka_tpu/engine/filter.py``).

Drives the time loop of the reference's ``LinearKalman.run``: iterate the
temporal grid, advance the state between steps, assimilate every
acquisition in the window (all bands jointly), dump each timestep's
analysis.  Each date is one ``core.solvers.assimilate_date`` call; for
the two-stream operator that is one launch of the fused Gauss-Newton
kernel, for PROSAIL one launch of the fused update per Gauss-Newton
iteration.  The date's ``obs.aux`` reaches the solver as the operator
params.

This slice runs the unfused loop (one window at a time) with
synchronous reads.  Not ported yet: prefetch, temporal fusion,
checkpoint/resume, mesh sharding, band-sequential mode, the Hessian
correction and the telemetry registry/exporters.  The per-date
diagnostic record (``diagnostics_log``) is kept, read from the device in
one packed transfer per date.
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
from .protocols import ObservationSource, OutputWriter, Prior
from .state import make_pixel_gather

LOG = logging.getLogger(__name__)


class KalmanFilter:
    """Raster-time-series Kalman/information filter on one device.

    Injection points as in the JAX package: ``observations`` (an
    ``ObservationSource``), ``output`` (an ``OutputWriter``), the operator
    (inside each ``DateObservation``), ``state_propagation`` (a
    propagator callable, or None for prior-only advance) and ``prior``.
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
        solver_options: Optional[dict] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.observations = observations
        self.output = output
        self.parameter_list = tuple(parameter_list)
        self.n_params = len(self.parameter_list)
        self.gather = make_pixel_gather(state_mask, pad_multiple)
        self._state_propagator = state_propagation
        self.prior = prior
        self.solver_options = solver_options
        self.diagnostics_log: list = []
        self._window_verdicts = None
        self.trajectory_model = torch.eye(self.n_params, dtype=torch.float32,
                                          device=self.device)
        self.trajectory_uncertainty = torch.zeros(
            self.n_params, dtype=torch.float32, device=self.device)

    def set_trajectory_uncertainty(self, q_diag) -> None:
        """Per-parameter model-error diagonal Q (linear_kf.py:131-146)."""
        q = np.asarray(q_diag, np.float32)
        if q.ndim == 0:
            q = np.full((self.n_params,), float(q), np.float32)
        self.trajectory_uncertainty = torch.as_tensor(q, device=self.device)

    def advance(self, x_analysis, p_analysis, p_analysis_inverse,
                date: datetime.datetime):
        """State propagation + prior blending (``LinearKalman.advance``)."""
        prior_mean = prior_inv = None
        if self.prior is not None:
            prior_mean, prior_inv = self.prior.process_prior(date,
                                                             self.gather)
            prior_mean = prior_mean.to(self.device)
            prior_inv = prior_inv.to(self.device)
        return prop.advance(
            x_analysis, p_analysis, p_analysis_inverse,
            self.trajectory_model, self.trajectory_uncertainty,
            prior_mean=prior_mean, prior_cov_inverse=prior_inv,
            state_propagator=self._state_propagator,
        )

    def _fetch(self, date):
        """The date's observation, read synchronously."""
        return self.observations.get_observations(date, self.gather)

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
            t0 = time.perf_counter()
            opts = self.date_solver_options(obs.operator)
            x_a, p_inv_a, diags = assimilate_date(
                obs.operator.linearize, obs.bands, x_a, p_inv_a, obs.aux,
                opts or None, None, device=self.device,
            )
            p_a = None
            if diags.health_verdicts is not None:
                self._window_verdicts = (
                    diags.health_verdicts if self._window_verdicts is None
                    else solver_health.merge_verdicts(
                        self._window_verdicts, diags.health_verdicts)
                )
            self.diagnostics_log.append(
                self._date_record(date, obs, diags, t0))
        return x_a, p_a, p_inv_a

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
        pad = self.gather.n_pad - self.gather.n_valid
        rec = {
            "date": date,
            "n_iterations": int(packed[0]),
            "convergence_norm": float(packed[1]),
            "bounds_clipped": int(packed[2]),
            "nodata": max(0, int(packed[3]) - n_bands * pad),
            "chi2_per_band": [float(v) for v in packed[4:4 + n_bands]],
            "wall_s": time.perf_counter() - t0,
        }
        if has_health:
            h0 = 4 + n_bands
            rec["cap_bailouts"] = int(packed[h0])
            rec["damped_recovered"] = int(packed[h0 + 1])
            rec["quarantined"] = int(packed[h0 + 2])
            rec["nonfinite"] = int(packed[h0 + 3])
            rec["clip_saturated"] = [
                int(v) for v in packed[h0 + 4:h0 + 4 + self.n_params]]
        LOG.info("Assimilated %s: %d iterations, norm %.3g, %.2fs", date,
                 rec["n_iterations"], rec["convergence_norm"], rec["wall_s"])
        return rec

    def run(self, time_grid, x_forecast, p_forecast, p_forecast_inverse):
        """Full assimilation run (``LinearKalman.run``).  ``x_forecast``
        may be (n_pad, p) or the flat interleaved layout; arrays may be
        tensors or numpy and are placed on the filter's device."""
        f32 = torch.float32
        x_forecast = torch.as_tensor(x_forecast, dtype=f32,
                                     device=self.device).reshape(
            -1, self.n_params)
        if x_forecast.shape[0] != self.gather.n_pad:
            raise ValueError(
                f"state has {x_forecast.shape[0]} rows; this filter's "
                f"pixel batch has {self.gather.n_pad}")
        if p_forecast is not None:
            p_forecast = torch.as_tensor(p_forecast, dtype=f32,
                                         device=self.device)
        if p_forecast_inverse is not None:
            p_forecast_inverse = torch.as_tensor(
                p_forecast_inverse, dtype=f32, device=self.device)
        windows = list(iterate_time_grid(time_grid, self.observations.dates))
        return self._run_loop(windows, x_forecast, p_forecast,
                              p_forecast_inverse)

    def _run_loop(self, windows, x_forecast, p_forecast,
                  p_forecast_inverse):
        state = (x_forecast, p_forecast, p_forecast_inverse)
        for window in windows:
            state = self._run_one_window(window, *state)
        return state

    def _run_one_window(self, window, x_analysis, p_analysis,
                        p_analysis_inverse):
        timestep, locate_times, is_first = window
        x_forecast, p_forecast, p_forecast_inverse = (
            x_analysis, p_analysis, p_analysis_inverse)
        if not is_first:
            LOG.info("Advancing state to %s", timestep)
            x_forecast, p_forecast, p_forecast_inverse = self.advance(
                x_analysis, p_analysis, p_analysis_inverse, timestep)
        if len(locate_times) == 0:
            LOG.info("No observations in window ending %s", timestep)
            x_analysis, p_analysis, p_analysis_inverse = (
                x_forecast, p_forecast, p_forecast_inverse)
            self._window_verdicts = None
        else:
            x_analysis, p_analysis, p_analysis_inverse = \
                self.assimilate_dates(locate_times, x_forecast, p_forecast,
                                      p_forecast_inverse)
        p_inv_diag = self._information_diagonal(p_analysis,
                                                p_analysis_inverse)
        self.output.dump_data(timestep, x_analysis, p_inv_diag, self.gather,
                              self.parameter_list)
        if self._window_verdicts is not None:
            dump_qa = getattr(self.output, "dump_qa", None)
            if dump_qa is not None:
                dump_qa(timestep, self._window_verdicts, self.gather)
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
