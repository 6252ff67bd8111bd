"""Pieces the scenarios share: the grid windows, the device observation
source, the configuration's ``RunConfig`` and the filter built from it
as ``cli/drivers.py:run_one_chunk`` builds one for a chunk."""

from __future__ import annotations

import datetime
import json

import numpy as np


def day(text: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(text)


def daily(start: str, end: str, step_days: int = 1) -> list:
    """Dates from ``start`` to ``end`` inclusive, ``step_days`` apart."""
    out, t = [], day(start)
    while t <= day(end):
        out.append(t)
        t += datetime.timedelta(days=step_days)
    return out


def time_grid(run_config: dict) -> list:
    """The assimilation grid of the configuration: ``start`` to ``end``
    inclusive in steps of ``step_days``."""
    return daily(run_config["start"], run_config["end"],
                 int(run_config["step_days"]))


def padded(n_valid: int, multiple: int) -> int:
    """The pixel batch the engine pads ``n_valid`` pixels to."""
    return max(-(-n_valid // multiple) * multiple, multiple)


def grid_windows(grid, dates) -> list:
    """``(timestep, dates in [previous step, timestep), is_first)`` per
    grid step after the first: the engine's windowing."""
    out = []
    for k in range(1, len(grid)):
        inside = [d for d in sorted(dates) if grid[k - 1] <= d < grid[k]]
        out.append((grid[k], inside, k == 1))
    return out


def run_config(config: dict):
    """The program's ``RunConfig`` of the deployment, field for field from
    the configuration file."""
    from kafka_tpu_torch.engine.config import RunConfig

    return RunConfig.from_json(json.dumps(config["run_config"]))


class DeviceObservations:
    """An observation source over tensors made on the card at set-up:
    ``y``, ``r_inv`` (D, B, n_pad) float32 and ``mask`` (D, B, n_pad)
    bool, one row per date of ``dates``; ``aux[d]`` is the date's
    operator aux.  Each fetch hands out views, as a reader hands out the
    bands it read."""

    def __init__(self, dates, y, r_inv, mask, operator, aux=None):
        self._dates = list(dates)
        self._row = {d: i for i, d in enumerate(self._dates)}
        self.y, self.r_inv, self.mask = y, r_inv, mask
        self.operator = operator
        self.aux = aux

    @property
    def dates(self):
        return self._dates

    def get_observations(self, date, gather):
        from kafka_tpu_torch.core.types import BandBatch
        from kafka_tpu_torch.engine.protocols import DateObservation

        i = self._row[date]
        return DateObservation(
            bands=BandBatch(y=self.y[i], r_inv=self.r_inv[i],
                            mask=self.mask[i]),
            operator=self.operator,
            aux=None if self.aux is None else self.aux[i])


def make_filter(cfg, observations, sink, mask, device):
    """``(kf, x0, p_inv0)``: the filter of one job, wired as the driver
    wires one chunk (propagator, prior, padding, solver options, prefetch,
    fusion, Q), with the benchmark's source and sink."""
    from kafka_tpu_torch.engine import KalmanFilter

    kf = KalmanFilter(
        observations, sink, mask, cfg.parameter_list,
        state_propagation=cfg.make_propagator(),
        prior=cfg.make_prior(device),
        pad_multiple=cfg.pad_multiple,
        solver_options=cfg.resolved_solver_options(),
        hessian_correction=cfg.hessian_correction,
        prefetch_depth=cfg.prefetch_depth,
        prefetch_workers=cfg.prefetch_workers,
        scan_window=cfg.scan_window,
        checkpoint_every_n=cfg.checkpoint_every_n,
        band_sequential=cfg.band_sequential,
        device=device,
    )
    kf.set_trajectory_model()
    q = cfg.q_diag if cfg.q_diag is not None else np.zeros(cfg.n_params)
    kf.set_trajectory_uncertainty(np.asarray(q, np.float32))
    x0, p_inv0 = cfg.make_initial_prior(device).process_prior(None,
                                                              kf.gather)
    return kf, x0, p_inv0


def f32_thresh_sq(tol: float, numel: float, share: float) -> float:
    """The squared step-norm threshold of a convergence group as the
    program rounds it: ``(tol * numel * share)^2`` in float32."""
    f32 = np.float32
    t = f32(tol) * f32(numel) * f32(share)
    return float(t * t)
