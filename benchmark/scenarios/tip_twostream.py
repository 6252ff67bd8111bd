"""MODIS TIP scenario: one tile under a seeded land mask, two-stream
albedo observations of a seasonal truth, the driver's information filter
with TLAI propagation, one job = the tile over the grid.

The data are made on the card from the seed: a truth per pixel (the TIP
parameters scattered about the prior, a seasonal LAI curve per pixel),
then per date the reference operator's albedo plus Gaussian noise, with
each pixel-date clouded at random (a cloud hides both bands).  The reference recomputes whole convergence groups of
the fused Gauss-Newton kernel (``gcd(n_pad, group_block)`` pixels), so
its trip counts follow the program's rule.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import filter as rf
from ..reference import twostream as rt
from .common import (DeviceObservations, daily, f32_thresh_sq, grid_windows,
                     make_filter, padded, run_config, time_grid)


def land_mask(ny: int, nx: int, n_valid: int, rng) -> np.ndarray:
    """Exactly ``n_valid`` land cells: the highest of a smooth field of
    coarse noise, so every seed holds the same pixel count."""
    cell = 32
    coarse = rng.normal(size=(ny // cell + 2, nx // cell + 2))
    fine = np.kron(coarse, np.ones((cell, cell)))[:ny, :nx]
    for axis in (0, 1):
        fine = (fine + np.roll(fine, cell // 2, axis=axis)) / 2.0
    flat = fine.ravel()
    mask = np.zeros(flat.size, bool)
    mask[np.argpartition(-flat, n_valid - 1)[:n_valid]] = True
    return mask.reshape(ny, nx)


class Scenario:
    kinds = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = device
        self.cfg = run_config(config)
        self.run_config = config["run_config"]
        self.solver = config["solver"]
        ny, nx = config["tile"]
        rng = np.random.default_rng([seed, 1])
        self.n_valid = int(config["n_valid"])
        self.mask = land_mask(ny, nx, self.n_valid, rng)
        self.n_pad = padded(self.n_valid, self.run_config["pad_multiple"])
        self.grid = time_grid(self.run_config)
        dates = [d for d in daily(traffic["obs_start"], traffic["obs_end"],
                                  traffic.get("obs_step_days", 1))
                 if self.grid[0] <= d < self.grid[-1]]
        self.window_list = grid_windows(self.grid, dates)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        self._make_observations(dates, traffic, gen)
        self.operator = self.cfg.make_operator()
        self.obs = DeviceObservations(dates, self.y, self.r_inv,
                                      self.obs_mask, self.operator)
        # Whole convergence groups of the fused kernel, drawn from the seed.
        self.group = math.gcd(self.n_pad, int(self.solver["group_block"]))
        n_groups = self.n_pad // self.group
        pick = np.sort(rng.choice(n_groups, min(int(
            traffic["sample_groups"]), n_groups), replace=False))
        self.sample_groups = pick
        self._sample = (pick[:, None] * self.group
                        + np.arange(self.group)[None, :]).ravel()

    # -- data ------------------------------------------------------------

    def _make_observations(self, dates, traffic, gen):
        dev, f32, n = self.device, torch.float32, self.n_pad
        t = traffic["truth"]
        mean, cov, _ = rt.tip_prior()
        sig = float(t["spread_of_prior_sigma"]) * np.sqrt(np.diag(cov))

        def uniform(lo, hi, shape):
            return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                               device=dev, dtype=f32)

        base = torch.as_tensor(mean[:6], dtype=f32, device=dev) \
            + torch.as_tensor(sig[:6], dtype=f32, device=dev) \
            * torch.randn((n, 6), generator=gen, device=dev, dtype=f32)
        margin = float(t["bound_margin"])
        self.base = torch.minimum(torch.maximum(
            base, torch.as_tensor(rt.LOWER[:6] + margin, dtype=f32,
                                  device=dev)),
            torch.as_tensor(rt.UPPER[:6] - margin, dtype=f32, device=dev))
        self.lai_lo = uniform(*t["lai_min"], (n,))
        self.lai_hi = uniform(*t["lai_max"], (n,))
        self.lai_peak = uniform(*t["peak_doy"], (n,))
        self.lai_width = uniform(*t["width_days"], (n,))
        d_count, nb = len(dates), rt.N_BANDS
        self.y = torch.empty((d_count, nb, n), dtype=f32, device=dev)
        self.r_inv = torch.empty((d_count, nb, n), dtype=f32, device=dev)
        self.obs_mask = torch.empty((d_count, nb, n), dtype=torch.bool,
                                    device=dev)
        valid = torch.arange(n, device=dev) < self.n_valid
        gap = float(traffic["gap_fraction"])
        rel, floor = (float(traffic["sigma_relative"]),
                      float(traffic["sigma_floor"]))
        for i, d in enumerate(dates):
            clean = rt.forward(self.truth(d)).T
            sigma = torch.clamp(rel * clean, min=floor)
            noise = torch.randn((nb, n), generator=gen, device=dev,
                                dtype=f32)
            seen = ((torch.rand((n,), generator=gen, device=dev,
                                dtype=f32) > gap) & valid).expand(nb, n)
            self.obs_mask[i] = seen
            self.y[i] = torch.where(seen, clean + sigma * noise, 0.0)
            self.r_inv[i] = torch.where(seen, 1.0 / sigma ** 2, 0.0)

    def truth(self, date):
        """The (n_pad, 7) truth on ``date``: the seasonal LAI as TLAI."""
        doy = float(date.timetuple().tm_yday)
        lai = self.lai_lo + (self.lai_hi - self.lai_lo) * torch.exp(
            -0.5 * ((doy - self.lai_peak) / self.lai_width) ** 2)
        return torch.cat([self.base, torch.exp(-0.5 * lai)[:, None]], dim=1)

    # -- the program -----------------------------------------------------

    def windows(self, kind: int) -> list:
        return [(ts, len(ds)) for ts, ds, _ in self.window_list]

    def run_job(self, kind: int, sink):
        """One job, the tile over the grid; the sink holds its filter."""
        kf, x0, p_inv0 = make_filter(self.cfg, self.obs, sink, self.mask,
                                     self.device)
        sink.job_filter = kf
        kf.run(self.grid, x0, None, p_inv0)

    def sample(self, kind: int) -> np.ndarray:
        return self._sample

    # -- the reference ---------------------------------------------------

    def reference_inputs(self):
        """The sampled pixels' observations, gathered before the
        program's tensors are freed."""
        idx = torch.as_tensor(self._sample, device=self.device)
        self._ref_obs = tuple(t[:, :, idx].transpose(1, 2).contiguous()
                              for t in (self.y, self.r_inv, self.obs_mask))

    def release(self):
        for name in ("y", "r_inv", "obs_mask", "obs", "base", "lai_lo",
                     "lai_hi", "lai_peak", "lai_width"):
            setattr(self, name, None)

    def reference(self, kind: int, dtype, lin_dtype=None) -> list:
        """Per grid window ``{"x", "info", "qa"}`` of the sampled pixels,
        computed by the plain reference in ``dtype`` on the card."""
        dev = self.device
        y, w, m = (t.to(dtype) if t.dtype != torch.bool else t
                   for t in self._ref_obs)
        s = y.shape[1]
        mean, _, inv_cov = rt.jrc_prior()
        x = torch.as_tensor(mean, dtype=dtype, device=dev).expand(s, 7) \
            .clone()
        a = torch.as_tensor(inv_cov, dtype=dtype, device=dev) \
            .expand(s, 7, 7).clone()
        lower = torch.as_tensor(rt.LOWER, dtype=dtype, device=dev)
        upper = torch.as_tensor(rt.UPPER, dtype=dtype, device=dev)
        q = self.run_config["q_diag"]
        tol, min_it, max_it = (self.solver["tol"],
                               self.solver["min_iterations"],
                               self.solver["max_iterations"])
        n_g = len(self.sample_groups)
        group = torch.arange(n_g, device=dev).repeat_interleave(self.group)
        thresh = torch.full((n_g,), f32_thresh_sq(
            tol, self.n_valid * 7, self.group / self.n_pad), dtype=dtype,
            device=dev)
        scale = torch.ones(n_g, dtype=dtype, device=dev)
        moving_sq = float(np.float32(np.float32(tol) * np.float32(7)) ** 2)
        relax = float((self.run_config["solver_options"] or {}).get(
            "relaxation", 1.0))
        row = {d: i for i, d in enumerate(self.obs_dates)}
        out = []
        for ts, ds, first in self.window_list:
            if not first:
                x, a = rt.propagate_lai(x, a, q)
            verdict = None
            for d in ds:
                i = row[d]
                x, a, v = rf.gn_date(
                    rt.forward, x, a, y[i], w[i], m[i], lower, upper,
                    relax, group, thresh, scale, min_it, max_it, moving_sq,
                    lin_dtype)
                verdict = v if verdict is None else rf.merge_verdicts(
                    verdict, v)
            out.append({
                "x": x.double().cpu().numpy(),
                "info": torch.diagonal(a, dim1=1, dim2=2).double()
                .cpu().numpy(),
                "qa": None if verdict is None else verdict.cpu().numpy()})
        return out

    @property
    def obs_dates(self):
        return [d for _, ds, _ in self.window_list for d in ds]
