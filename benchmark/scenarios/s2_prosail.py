"""Sentinel-2 PROSAIL scenario: chunks of a tile, each a job over the
grid with one acquisition per window, the SAIL prior as every window's
forecast, the row loop with the (10, 10) fused update.

The data are made on the card from the seed: per chunk a truth (the
SAIL prior mean at LAI 3 plus Gaussian scatter, inside the state
bounds), then per acquisition the reference operator's reflectance under
the acquisition's angles plus Gaussian noise under a random gap mask.
The row loop's convergence test is one norm over the whole chunk; the
reference estimates it from its sample (``scale`` = valid pixels over
sampled pixels).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import filter as rf
from ..reference import prosail as rp
from .common import (DeviceObservations, day, f32_thresh_sq, grid_windows,
                     make_filter, padded, run_config, time_grid)


class Scenario:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from kafka_tpu_torch.obsops.prosail import ProsailAux

        self.device = device
        self.cfg = run_config(config)
        self.run_config = config["run_config"]
        self.solver = config["solver"]
        ny, nx = config["chunk"]
        self.kinds = int(config["n_chunks"])
        self.mask = np.ones((ny, nx), bool)
        self.n_valid = ny * nx
        self.n_pad = padded(self.n_valid, self.run_config["pad_multiple"])
        self.grid = time_grid(self.run_config)
        acq = traffic["acquisitions"]
        dates = [day(a["date"]) for a in acq]
        self.angles = [(float(a["sza"]), float(a["vza"]), float(a["raa"]))
                       for a in acq]
        self.window_list = grid_windows(self.grid, dates)
        self.dates = dates
        dev = device
        aux = [ProsailAux(*(torch.tensor(v, dtype=torch.float32, device=dev)
                            for v in ang)) for ang in self.angles]
        self.operator = self.cfg.make_operator()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        rng = np.random.default_rng([seed, 2])
        self.obs, self._ref_obs, self._samples = [], [], []
        n_sample = min(int(traffic["sample_pixels"]), self.n_valid)
        for _ in range(self.kinds):
            y, r_inv, mask = self._make_chunk(traffic, gen)
            self.obs.append(DeviceObservations(dates, y, r_inv, mask,
                                               self.operator, aux))
            self._samples.append(np.sort(rng.choice(
                self.n_valid, n_sample, replace=False)))

    def _make_chunk(self, traffic, gen):
        dev, f32, n = self.device, torch.float32, self.n_pad
        t = traffic["truth"]
        mean, _, _ = rp.sail_prior()
        mean = mean.copy()
        mean[6] = np.exp(-0.5 * float(t["lai"]))
        lo = torch.as_tensor(rp.LOWER, dtype=f32, device=dev)
        hi = torch.as_tensor(rp.UPPER, dtype=f32, device=dev)
        truth = torch.as_tensor(mean, dtype=f32, device=dev) \
            + float(t["spread"]) * torch.randn(
                (n, 10), generator=gen, device=dev, dtype=f32)
        truth = torch.minimum(torch.maximum(truth, lo), hi)
        d_count, nb = len(self.dates), rp.N_BANDS
        y = torch.empty((d_count, nb, n), dtype=f32, device=dev)
        r_inv = torch.empty((d_count, nb, n), dtype=f32, device=dev)
        mask = torch.empty((d_count, nb, n), dtype=torch.bool, device=dev)
        valid = torch.arange(n, device=dev) < self.n_valid
        gap = float(traffic["gap_fraction"])
        rel, floor = (float(traffic["sigma_relative"]),
                      float(traffic["sigma_floor"]))
        for i, ang in enumerate(self.angles):
            clean = rp.forward(truth, *ang).T
            sigma = torch.clamp(rel * clean, min=floor)
            noise = torch.randn((nb, n), generator=gen, device=dev,
                                dtype=f32)
            seen = (torch.rand((nb, n), generator=gen, device=dev,
                               dtype=f32) > gap) & valid
            mask[i] = seen
            y[i] = torch.where(seen, clean + sigma * noise, 0.0)
            r_inv[i] = torch.where(seen, 1.0 / sigma ** 2, 0.0)
        return y, r_inv, mask

    # -- the program -----------------------------------------------------

    def windows(self, kind: int) -> list:
        return [(ts, len(ds)) for ts, ds, _ in self.window_list]

    def run_job(self, kind: int, sink):
        """One job, chunk ``kind`` over the grid; the sink holds its filter."""
        kf, x0, p_inv0 = make_filter(self.cfg, self.obs[kind], sink,
                                     self.mask, self.device)
        sink.job_filter = kf
        kf.run(self.grid, x0, None, p_inv0)

    def sample(self, kind: int) -> np.ndarray:
        return self._samples[kind]

    # -- the reference ---------------------------------------------------

    def reference_inputs(self):
        self._ref_obs = []
        for obs, smp in zip(self.obs, self._samples):
            idx = torch.as_tensor(smp, device=self.device)
            self._ref_obs.append(tuple(
                t[:, :, idx].transpose(1, 2).contiguous()
                for t in (obs.y, obs.r_inv, obs.mask)))

    def release(self):
        self.obs = None

    def reference(self, kind: int, dtype, lin_dtype=None) -> list:
        """Per grid window ``{"x", "info", "qa"}`` of chunk ``kind``'s
        sampled pixels, by the plain reference in ``dtype`` on the card:
        every window starts from the SAIL prior (prior-only advance)."""
        dev = self.device
        y, w, m = (t.to(dtype) if t.dtype != torch.bool else t
                   for t in self._ref_obs[kind])
        s = y.shape[1]
        mean, _, inv_cov = rp.sail_prior()
        x_prior = torch.as_tensor(mean, dtype=dtype, device=dev) \
            .expand(s, 10).clone()
        a_prior = torch.as_tensor(inv_cov, dtype=dtype, device=dev) \
            .expand(s, 10, 10).clone()
        lower = torch.as_tensor(rp.LOWER, dtype=dtype, device=dev)
        upper = torch.as_tensor(rp.UPPER, dtype=dtype, device=dev)
        tol, min_it, max_it = (self.solver["tol"],
                               self.solver["min_iterations"],
                               self.solver["max_iterations"])
        group = torch.zeros(s, dtype=torch.long, device=dev)
        thresh = torch.full((1,), f32_thresh_sq(tol, self.n_valid * 10,
                                                1.0), dtype=dtype,
                            device=dev)
        scale = torch.full((1,), self.n_valid / s, dtype=dtype, device=dev)
        moving_sq = float(np.float32(np.float32(tol) * np.float32(10))
                          ** 2)
        relax = float((self.run_config["solver_options"] or {}).get(
            "relaxation", 1.0))
        row = {d: i for i, d in enumerate(self.dates)}
        out = []
        x, a = x_prior, a_prior
        for ts, ds, first in self.window_list:
            if not first:
                x, a = x_prior, a_prior
            verdict = None
            for d in ds:
                i = row[d]
                ang = self.angles[i]
                x, a, v = rf.gn_date(
                    lambda z, ang=ang: rp.forward(z, *ang), x, a, y[i],
                    w[i], m[i], lower, upper, relax, group, thresh, scale,
                    min_it, max_it, moving_sq, lin_dtype)
                verdict = v if verdict is None else rf.merge_verdicts(
                    verdict, v)
            out.append({
                "x": x.double().cpu().numpy(),
                "info": torch.diagonal(a, dim1=1, dim2=2).double()
                .cpu().numpy(),
                "qa": None if verdict is None else verdict.cpu().numpy()})
        return out
