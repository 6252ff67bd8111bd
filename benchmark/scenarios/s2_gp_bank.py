"""Sentinel-2 through per-geometry GP emulator banks: chunks of a tile,
each a job over the grid with one acquisition per window, the SAIL prior
as every window's forecast, the row loop with the GP bank's
linearisation and the (10, 10) fused update.

The data are made from the seed at set-up:

- the emulators: per geometry of the configuration's grid and per band,
  ``training_points`` samples of the reference PROSAIL over the state
  bounds, one GP each, all fitted at once by the program's ``fit_gp``
  (the marginal-likelihood fit, ``optimize=True``); each band's
  held-out RMSE against PROSAIL on ``holdout`` samples must stay under
  ``rmse_of_range`` of the band's range there, or set-up raises (a
  degenerate emulator has a trivial Jacobian);
- each acquisition's bank, the grid geometry nearest its angles, picked
  by the program's ``geometry_bank_aux_builder`` as ``run_s2
  --emulators`` picks one per date;
- per chunk a truth (the SAIL prior mean at the workload's LAI plus
  Gaussian scatter, inside the state bounds), then per acquisition the
  bank's values at the truth plus Gaussian noise under a random gap
  mask.

The reference is ``reference/gp.py``'s bank in float64, linearised by
``reference/filter.gn_date``, with no state bounds (the bank operator
has none, so the program projects nothing); the row loop's convergence
test is one norm over the whole chunk, estimated from the sample
(``scale``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..reference import filter as rf
from ..reference import gp as rg
from ..reference import prosail as rp
from .common import (DeviceObservations, day, f32_thresh_sq, grid_windows,
                     make_filter, padded, run_config, time_grid)

#: pixels a block of the set-up's bank evaluations.
BLOCK = 1 << 18


def geometries(em: dict) -> list:
    """The emulators' grid of ``(sza, vza, raa)``."""
    return [(float(s), float(v), float(r)) for s in em["sza"]
            for v in em["vza"] for r in em["raa"]]


def prosail_samples(rng, n: int, shape=()):
    """``shape + (n, 10)`` float64 states uniform over the bounds."""
    return rp.LOWER + (rp.UPPER - rp.LOWER) * rng.uniform(
        size=tuple(shape) + (n, rp.N_PARAMS))


def bank_values(bank, x):
    """``(B, n)`` float32 means of ``bank`` at ``x`` (n, k) float32, in
    blocks, by the matrix form of the squared distance (one product of
    the inputs and training points, each widened by their squared norm
    and a one): for the data only, whose noise (5 % of reflectance) lies
    far above its float32 rounding.  ``reference/gp.py:predict``'s direct
    differences would hold a (block, m, k) tensor a band: at a chunk's
    width, seconds of set-up a chunk."""
    n_bands = bank.x_train.shape[0]
    out = torch.empty((n_bands, x.shape[0]), dtype=torch.float32,
                      device=x.device)
    for b in range(n_bands):
        inv_ell = torch.exp(-bank.log_lengthscales[b])
        xt = bank.x_train[b] * inv_ell
        ones = torch.ones_like(xt[:, :1])
        # -s/2 = x.X - |x|^2/2 - |X|^2/2 as one product.
        right = torch.cat([xt, ones, -0.5 * (xt * xt).sum(1, True)], 1)
        amp = torch.exp(bank.log_amplitude[b])
        for lo in range(0, x.shape[0], BLOCK):
            xs = x[lo:lo + BLOCK] * inv_ell
            left = torch.cat([xs, -0.5 * (xs * xs).sum(1, True),
                              torch.ones_like(xs[:, :1])], 1)
            e = (left @ right.T).clamp_(max=0.0).exp_()
            out[b, lo:lo + BLOCK] = amp * (e @ bank.alpha[b]) \
                + bank.y_mean[b]
    return out


def fit_banks(em: dict, seed: int, device) -> dict:
    """``{(sza, vza, raa): bank}`` for the configuration's ``emulators``:
    fitted at once by the program's ``fit_gp`` on samples of the
    reference PROSAIL drawn from ``seed``, and checked on held-out
    samples (set-up raises where a band is off by more than
    ``rmse_of_range`` of its range)."""
    from kafka_tpu_torch.obsops.gp import GPParams, fit_gp

    nb = rp.N_BANDS
    geos = geometries(em)
    m = int(em["training_points"])
    rng = np.random.default_rng([seed, 3])
    t_samples = time.perf_counter()
    x = prosail_samples(rng, m, (len(geos), nb))
    y = np.empty(x.shape[:-1])
    for g, geo in enumerate(geos):
        for b in range(nb):
            y[g, b] = rp.forward(torch.as_tensor(x[g, b]), *geo)[:, b] \
                .numpy()
    t0 = time.perf_counter()
    fit = fit_gp(x, y, amplitude=y.var(axis=-1), noise=float(em["noise"]),
                 optimize=True, steps=int(em["fit_steps"]), device=device)
    print(f"emulators: samples {t0 - t_samples!r} s, fit "
          f"{time.perf_counter() - t0!r} s", file=sys.stderr)
    banks = {geo: GPParams(*(leaf[g] for leaf in fit))
             for g, geo in enumerate(geos)}
    held = torch.as_tensor(prosail_samples(rng, int(em["holdout"])),
                           device=device)
    shares = []
    for geo, bank in banks.items():
        truth = rp.forward(held, *geo)
        pred = rg.predict(bank, held)
        rmse = torch.sqrt(torch.mean((pred - truth) ** 2, dim=0))
        share = rmse / (truth.amax(dim=0) - truth.amin(dim=0))
        shares.append(share.tolist())
        if float(share.max()) > float(em["rmse_of_range"]):
            raise RuntimeError(
                f"emulators: a band of bank {geo} is off PROSAIL by "
                f"{share.tolist()} of its range on held-out samples, "
                f"over {em['rmse_of_range']}")
    print(f"emulators: {len(banks)} banks x {nb} bands, {m} points; "
          f"held-out RMSE over each band's range, by bank: {shares}",
          file=sys.stderr)
    return banks


def date_banks(banks: dict, acquisitions) -> list:
    """Each acquisition's bank, picked by the program's
    ``geometry_bank_aux_builder`` from its angles as ``run_s2
    --emulators`` picks one per date (the nearest geometry by
    ``find_nearest_geometry``, relative azimuth ``vaa - saa``)."""
    from kafka_tpu_torch.io.sentinel2 import geometry_bank_aux_builder

    build = geometry_bank_aux_builder(banks)
    return [build({"sza": a["sza"], "vza": a["vza"], "saa": 0.0,
                   "vaa": a["raa"]}, None) for a in acquisitions]


class Scenario:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
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
        self.window_list = grid_windows(self.grid, dates)
        self.dates = dates
        t0 = time.perf_counter()
        self.banks = fit_banks(config["emulators"], seed, device)
        self.date_banks = date_banks(self.banks, acq)
        keys = [next(k for k, b in self.banks.items() if b is bank)
                for bank in self.date_banks]
        print(f"emulators: acquisitions on banks {keys}", file=sys.stderr)
        self.operator = self.cfg.make_operator()
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        rng = np.random.default_rng([seed, 2])
        self.obs, self._ref_obs, self._samples = [], [], []
        n_sample = min(int(traffic["sample_pixels"]), self.n_valid)
        t1 = time.perf_counter()
        for _ in range(self.kinds):
            y, r_inv, mask = self._make_chunk(traffic, gen)
            self.obs.append(DeviceObservations(dates, y, r_inv, mask,
                                               self.operator,
                                               self.date_banks))
            self._samples.append(np.sort(rng.choice(
                self.n_valid, n_sample, replace=False)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"data: emulators {t1 - t0!r} s, observations "
              f"{time.perf_counter() - t1!r} s", file=sys.stderr)

    # -- data ------------------------------------------------------------

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
        values = {}
        for i, bank in enumerate(self.date_banks):
            if id(bank) not in values:
                values[id(bank)] = bank_values(bank, truth)
            clean = values[id(bank)]
            sigma = torch.clamp(rel * clean.abs(), min=floor)
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
        # The GP bank operator carries no state bounds (the PROSAIL
        # operator's clip limits are its own): the program projects
        # nothing, and neither does the reference.
        upper = torch.full((10,), float("inf"), dtype=dtype, device=dev)
        lower = -upper
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
                x, a, v = rf.gn_date(
                    rg.forward(self.date_banks[i]), x, a, y[i], w[i], m[i],
                    lower, upper, relax, group, thresh, scale, min_it,
                    max_it, moving_sq, lin_dtype)
                verdict = v if verdict is None else rf.merge_verdicts(
                    verdict, v)
            out.append({
                "x": x.double().cpu().numpy(),
                "info": torch.diagonal(a, dim1=1, dim2=2).double()
                .cpu().numpy(),
                "qa": None if verdict is None else verdict.cpu().numpy()})
        return out
