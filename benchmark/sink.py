"""The product sink of the timed path: every dumped window's state, its
information diagonal and its QA band copied to host memory, as a product
writer receives them, and the window's completion time on the host
clock."""

from __future__ import annotations

import time

import numpy as np
import torch


class StopWindow(Exception):
    """Raised by the sink at the first completed window at or after the
    stop time: it ends the job that is running."""


class HostSink:
    """An output writer for ``KalmanFilter``.  ``dump_data`` copies ``x``
    and the information diagonal into page-locked host buffers
    (synchronously: the copy has completed when it returns) and
    ``dump_qa`` the verdicts; a window is complete once its QA is on the
    host (at once for a window without dates, which dumps none).  Of each
    window the sampled pixels' rows are kept for the check.

    ``windows`` is the job's ``(timestep, n_dates)`` list in grid order;
    the ``k``-th dumped window of a job is its ``k``-th window."""

    def __init__(self, n_pad: int, n_params: int, n_valid: int,
                 pinned: bool = True):
        self.n_valid = n_valid
        self._x = torch.empty((n_pad, n_params), dtype=torch.float32,
                              pin_memory=pinned)
        self._d = torch.empty((n_pad, n_params), dtype=torch.float32,
                              pin_memory=pinned)
        self._q = torch.empty((n_pad,), dtype=torch.int32,
                              pin_memory=pinned)
        self.stop_at = None
        self.stop_after = None
        self.completed = []          # (job, window, n_dates, time)
        self.kept = {}               # (job, window) -> {"x", "info", "qa"}
        self.job_filter = None
        self._job = None

    def start_job(self, job: int, windows, sample):
        self._job = job
        self._windows = list(windows)
        self._sample = sample
        self._next = 0
        self._pending = {}

    def dump_data(self, timestep, x, p_inv_diag, gather, parameter_list):
        self._x.copy_(x)
        self._d.copy_(p_inv_diag)
        k = self._next
        self._next += 1
        if self._windows[k][0] != timestep:
            raise RuntimeError(f"window {k} dumped as {timestep}, expected "
                               f"{self._windows[k][0]}")
        kept = {"x": self._x.numpy()[self._sample].copy(),
                "info": self._d.numpy()[self._sample].copy(), "qa": None}
        if self._windows[k][1] == 0:
            self._complete(k, kept)
        else:
            self._pending[timestep] = (k, kept)

    def dump_qa(self, timestep, verdicts, gather):
        self._q.copy_(verdicts)
        k, kept = self._pending.pop(timestep)
        kept["qa"] = self._q.numpy()[self._sample].copy()
        self._complete(k, kept)

    def _complete(self, k: int, kept: dict) -> None:
        now = time.perf_counter()
        self.kept[(self._job, k)] = kept
        self.completed.append((self._job, k, self._windows[k][1], now))
        done = len(self.completed)
        if (self.stop_at is not None and now >= self.stop_at) or \
                (self.stop_after is not None and done >= self.stop_after):
            raise StopWindow()

    def job_finished(self) -> bool:
        """Every window of the job dumped and complete."""
        return self._next == len(self._windows) and not self._pending

    def reset(self):
        self.completed, self.kept = [], {}
        self.stop_at = self.stop_after = None


def pixel_dates(completed, n_valid: int, since: float, until: float):
    """``(pixel-dates, seconds)`` of the windows completed in
    ``(since, until]``: each valid pixel of each assimilated date once,
    over the time from ``since`` to the last such window."""
    done = [(n, t) for _, _, n, t in completed if since < t <= until]
    if not done:
        return 0, 0.0
    return n_valid * sum(n for n, _ in done), max(t for _, t in done) - since


def finite_rows(kept: dict) -> bool:
    return all(np.isfinite(kept[k]).all() for k in ("x", "info"))
