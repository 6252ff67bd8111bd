"""Synthetic observation source + in-memory output sink (port of
``kafka_tpu/testing/synthetic.py``).

Noise and masks are drawn with numpy from the same seeds, in the same
order and with the same shapes as the JAX package, so both packages see
the same observations; only the clean forward model runs in PyTorch.
"""

from __future__ import annotations

import datetime
from typing import Dict, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.types import BandBatch
from ..engine.protocols import DateObservation
from ..engine.state import PixelGather
from ..obsops.protocol import ObservationModel


class SyntheticObservations:
    """Observations from a forward operator on a known truth plus noise,
    with random masking; tensors are made on ``device``.  ``aux_fn(date,
    gather)`` gives the date's operator aux (None by default), which
    reaches the solver as the operator params."""

    def __init__(self, dates: Sequence[datetime.datetime],
                 operator: ObservationModel, truth_fn, sigma: float = 0.01,
                 aux_fn=None, mask_prob: float = 0.1, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self._dates = list(dates)
        self.operator = operator
        self.truth_fn = truth_fn
        self.sigma = sigma
        self.aux_fn = aux_fn or (lambda date, gather: None)
        self.mask_prob = mask_prob
        self.seed = seed
        self.bands_per_observation = {d: operator.n_bands
                                      for d in self._dates}

    @property
    def dates(self):
        return self._dates

    def get_observations(self, date, gather: PixelGather) -> DateObservation:
        truth = self.truth_fn(date)
        x_true = torch.as_tensor(gather.gather(truth), dtype=torch.float32,
                                 device=self.device)
        aux = self.aux_fn(date, gather)
        y_clean = self.operator.forward(aux, x_true).cpu().numpy()
        rng = np.random.default_rng((self.seed, date.toordinal()))
        noise = rng.normal(0.0, self.sigma, y_clean.shape)
        y = (y_clean + noise).astype(np.float32)
        mask = rng.uniform(size=y.shape) > self.mask_prob
        mask &= gather.valid[None, :]
        r_inv = np.where(mask, 1.0 / self.sigma**2, 0.0).astype(np.float32)
        dev = self.device
        bands = BandBatch(
            y=torch.as_tensor(np.where(mask, y, 0.0), device=dev),
            r_inv=torch.as_tensor(r_inv, device=dev),
            mask=torch.as_tensor(mask, device=dev),
        )
        return DateObservation(bands=bands, operator=self.operator, aux=aux)


def make_tip_problem(n_pix: int, seed: int = 0, sigma: float = 0.005,
                     mask_prob: float = 0.1, device=None):
    """The synthetic TIP/two-stream problem of the JAX package (same
    draws): returns ``(operator, bands, x0, p_inv0)`` on ``device`` with
    ``x0``/``p_inv0`` the broadcast TIP prior (expanded views)."""
    from ..core.propagators import tip_prior_arrays
    from ..obsops.twostream import TwoStreamOperator

    dev = resolve_device(device)
    op = TwoStreamOperator()
    rng = np.random.default_rng(seed)
    mean_h, _, inv_h = tip_prior_arrays()
    truth = np.clip(mean_h + rng.normal(0, 0.05, (n_pix, op.n_params)),
                    0.05, 0.95).astype(np.float32)
    y = op.forward(None, torch.as_tensor(truth, device=dev)).cpu().numpy()
    y = y + rng.normal(0, sigma, y.shape)
    mask = rng.uniform(size=y.shape) > mask_prob
    r_inv = np.where(mask, 1.0 / sigma**2, 0.0).astype(np.float32)
    y_masked = np.where(mask, y, 0.0).astype(np.float32)
    bands = BandBatch(
        y=torch.as_tensor(y_masked, device=dev),
        r_inv=torch.as_tensor(r_inv, device=dev),
        mask=torch.as_tensor(mask, device=dev),
    )
    p = op.n_params
    x0 = torch.as_tensor(mean_h, device=dev).expand(n_pix, p)
    p_inv0 = torch.as_tensor(inv_h, device=dev).expand(n_pix, p, p)
    return op, bands, x0, p_inv0


def make_prosail_problem(n_pix: int, seed: int = 11, sigma: float = 0.005,
                         obs_frac: float = 0.8, angles=(30.0, 5.0, 90.0),
                         device=None):
    """The synthetic PROSAIL problem of the JAX package's p=10 fused-path
    test (``tests/test_solvers.py:544-567``, same draws): the SAIL prior
    mean plus N(0, 0.02) clipped to [0.02, 0.98] as forecast and truth,
    observations from the forward model plus N(0, sigma), ``obs_frac`` of
    the entries observed and NaN under the mask.  Returns ``(operator,
    bands, x0, p_inv0, aux)`` on ``device``; ``p_inv0`` is the broadcast
    prior information (an expanded view)."""
    from ..convert import prosail_aux
    from ..engine.priors import sail_prior_arrays
    from ..obsops.prosail import ProsailAux, ProsailOperator

    dev = resolve_device(device)
    op = ProsailOperator()
    rng = np.random.default_rng(seed)
    p = op.n_params
    mean, _, inv_cov = sail_prior_arrays()
    x0 = np.clip(mean + rng.normal(0, 0.02, (n_pix, p)), 0.02, 0.98) \
        .astype(np.float32)
    aux = prosail_aux(ProsailAux(*angles), dev)
    x0_t = torch.as_tensor(x0, device=dev)
    h0 = op.forward(aux, x0_t).cpu().numpy()
    y = (h0 + rng.normal(0, sigma, h0.shape)).astype(np.float32)
    mask = rng.uniform(size=y.shape) > 1.0 - obs_frac
    bands = BandBatch(
        y=torch.as_tensor(np.where(mask, y, np.nan).astype(np.float32),
                          device=dev),
        r_inv=torch.as_tensor(
            np.where(mask, 1 / sigma**2, 0.0).astype(np.float32), device=dev),
        mask=torch.as_tensor(mask, device=dev),
    )
    p_inv0 = torch.as_tensor(inv_cov, device=dev).expand(n_pix, p, p)
    return op, bands, x0_t, p_inv0, aux


def s2_observations(dates, truth_fn, angles=(30.5, 5.0, -50.0),
                    sigma: float = 0.005, mask_prob: float = 0.1,
                    seed: int = 0, device=None) -> SyntheticObservations:
    """A synthetic Sentinel-2 source: ``ProsailOperator`` observations of
    ``truth_fn(date)`` under scene-constant geometry ``(sza, vza, raa)``
    (default the JAX S2 fixture's, ``testing/fixtures.py:68``), passed to
    the solver as a ``ProsailAux``."""
    from ..convert import prosail_aux
    from ..obsops.prosail import ProsailAux, ProsailOperator

    dev = resolve_device(device)
    aux = prosail_aux(ProsailAux(*angles), dev)
    return SyntheticObservations(
        dates, ProsailOperator(), truth_fn, sigma=sigma,
        aux_fn=lambda date, gather: aux, mask_prob=mask_prob, seed=seed,
        device=dev,
    )


def run_s2_engine(ny: int = 16, nx: int = 16, obs_days=(1, 3, 5),
                  grid_days=(0, 2, 4, 6), pad_multiple: int = 128,
                  solver_options=None, scan_window: int = 8, device=None):
    """A complete (small) Sentinel-2 PROSAIL assimilation through
    ``KalmanFilter.run``: ``sail_prior``, no propagation with Q = 0,
    relaxation 0.7 (the Barrax configuration, ``cli/run_s2.py``), a
    circular field mask, truth the SAIL mean with LAI 3, 2-day grid;
    ``scan_window`` is the engine's temporal fusion.

    Returns ``(kf, out, x_analysis, p_inv_analysis)``."""
    from ..engine.filter import KalmanFilter
    from ..engine.priors import PROSAIL_PARAMETER_LIST, sail_prior

    dev = resolve_device(device)

    def day(i):
        return datetime.datetime(2017, 7, 3) + datetime.timedelta(days=i)

    yy, xx = np.mgrid[:ny, :nx]
    mask = (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 \
        < (min(ny, nx) / 2.2) ** 2
    prior = sail_prior(dev)
    truth = prior.prior.mean.cpu().numpy().copy()
    truth[6] = np.exp(-1.5)
    truth = np.broadcast_to(truth, mask.shape + (10,))
    obs = s2_observations([day(i) for i in obs_days], lambda date: truth,
                          device=dev)
    out = MemoryOutput()
    kf = KalmanFilter(
        obs, out, mask, PROSAIL_PARAMETER_LIST, state_propagation=None,
        prior=prior, pad_multiple=pad_multiple,
        solver_options=({"relaxation": 0.7} if solver_options is None
                        else solver_options),
        scan_window=scan_window, device=dev,
    )
    kf.set_trajectory_uncertainty(np.zeros(10))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    x_a, _, p_inv_a = kf.run([day(i) for i in grid_days], x0, None, p_inv0)
    return kf, out, x_a, p_inv_a


def joint_truth(mask_shape, sm: float = 0.4) -> np.ndarray:
    """The joint S2 + S1 truth raster ``mask_shape + (11,)``: the joint
    prior mean with LAI 3 (slot 6 = exp(-1.5)) and soil moisture ``sm``
    (slot 10), as the JAX package's joint test and baseline harness."""
    from ..engine.priors import joint_prior_arrays

    truth = joint_prior_arrays()[0].copy()
    truth[6] = np.float32(np.exp(-1.5))
    truth[10] = sm
    return np.broadcast_to(truth, tuple(mask_shape) + (11,))


def joint_observations(s2_dates, s1_dates, truth_fn, theta_deg,
                       s2_angles=None, s1_sigma: float = 0.01,
                       device=None):
    """A joint Sentinel-2 + Sentinel-1 stream on the 11-parameter joint
    state: the ``CompositeObservations`` of an S2 source on
    ``ProsailJointOperator`` (sigma 0.005; scene geometry ``s2_angles`` =
    (sza, vza, raa) as a ``ProsailAux``, or None for the operator's
    default) and an S1 source on ``WCMJointOperator`` (sigma
    ``s1_sigma``) whose ``WCMAux`` carries the incidence angle
    ``theta_deg``: a scalar or a ``(ny, nx)`` raster, gathered per pixel
    (padding rows get 0 degrees).  The draws are those of two
    ``SyntheticObservations`` with seeds 3 and 4 and 10 % masked, as the
    JAX package's joint test builds them."""
    from ..convert import prosail_aux
    from ..io.multi import CompositeObservations
    from ..obsops.joint import ProsailJointOperator, WCMJointOperator
    from ..obsops.prosail import ProsailAux
    from ..obsops.wcm import WCMAux

    dev = resolve_device(device)
    s2_aux = None if s2_angles is None \
        else prosail_aux(ProsailAux(*s2_angles), dev)
    theta_host = np.asarray(theta_deg, np.float32)

    def s1_aux(date, gather):
        if theta_host.ndim == 0:
            theta = np.full(gather.n_pad, theta_host, np.float32)
        else:
            theta = gather.gather(theta_host)
        return WCMAux(theta_deg=torch.as_tensor(theta, device=dev))

    s2 = SyntheticObservations(
        s2_dates, ProsailJointOperator(), truth_fn, sigma=0.005,
        aux_fn=lambda date, gather: s2_aux, seed=3, device=dev)
    s1 = SyntheticObservations(
        s1_dates, WCMJointOperator(), truth_fn, sigma=s1_sigma,
        aux_fn=s1_aux, seed=4, device=dev)
    return CompositeObservations([s2, s1])


def plant_solver_faults(y, r_inv, mask_f, xf_rows, pf_rows,
                        n_each: int = 64, seed: int = 0):
    """Copies of the fused solve's TIP row inputs with disjoint sets of
    ``n_each`` pixels planted to drive each solve-health branch.  Returns
    ``(rows, corrupt, planted)``: ``rows`` the planted copies under the
    argument names, ``corrupt`` the (n,) float32 corruption row, and
    ``planted`` each branch's pixel indices:

    - ``corrupt``: flagged in the corruption row, so the forward model
      reads NaN -> quarantined;
    - ``breakdown``: P_f^-1[0, 0] = -1e9, so every Cholesky breaks down,
      LM inflation included -> quarantined;
    - ``recovered``: forecast omega_vis (parameter 0) above the
      two-stream's clip, so its Jacobian column is zero, and P_f^-1 row 0
      = (-1e-4, 0, ...): the first factorisation breaks down, the state
      bound then pulls omega inside the clip and the escalated, damped
      steps succeed -> damped-recovered;
    - ``nodata``: NaN y under a zero mask in both bands -> NODATA, inert;
    - ``half_nan``: NaN y under a zero mask in band 0 only -> band 1
      alone drives the solve.

    The first three are drawn from pixels observed in both bands."""
    rows = {"y": y.clone(), "r_inv": r_inv.clone(),
            "mask_f": mask_f.clone(), "xf_rows": xf_rows.clone(),
            "pf_rows": pf_rows.clone()}
    n = y.shape[1]
    p = xf_rows.shape[0]
    both = (mask_f > 0).all(dim=0).cpu().numpy()
    rng = np.random.default_rng(seed)
    pick = rng.permutation(np.nonzero(both)[0])[:5 * n_each]
    if pick.size < 5 * n_each:
        raise ValueError(f"{pick.size} pixels observed in both bands; "
                         f"{5 * n_each} needed")
    names = ("corrupt", "breakdown", "recovered", "nodata", "half_nan")
    planted = {
        nm: torch.as_tensor(np.sort(pick[i * n_each:(i + 1) * n_each]),
                            device=y.device)
        for i, nm in enumerate(names)
    }
    corrupt = torch.zeros(n, dtype=torch.float32, device=y.device)
    corrupt[planted["corrupt"]] = 1.0
    rows["pf_rows"][0, planted["breakdown"]] = -1e9
    rec = planted["recovered"]
    rows["xf_rows"][0, rec] = 0.9999999
    rows["pf_rows"][0, rec] = -1e-4
    for r in range(1, p):
        rows["pf_rows"][r * (r + 1) // 2, rec] = 0.0
    for px, bands in ((planted["nodata"], slice(None)),
                      (planted["half_nan"], slice(0, 1))):
        idx = (bands, px)
        rows["y"][idx] = float("nan")
        rows["r_inv"][idx] = 0.0
        rows["mask_f"][idx] = 0.0
    return rows, corrupt, planted


def run_tip_engine(obs_days: Sequence[int] = (1, 3, 5, 7),
                   grid_days: Sequence[int] = (0, 2, 4, 6, 8),
                   ny: int = 12, nx: int = 14, pad_multiple: int = 128,
                   solver_options=None, scan_window: int = 1, device=None,
                   mesh=None, mesh_lane: int = 8):
    """A complete (tiny) TIP assimilation through ``KalmanFilter.run``
    with prior-only advance — the port of the JAX ``run_tip_engine``;
    ``scan_window`` is the engine's temporal fusion, 1 by default as in
    the JAX helper (fused and unfused give the same bits in the port),
    and ``mesh`` / ``mesh_lane`` the engine's pixel sharding (the device
    is then the mesh's first).  ``solver_options`` defaults to the JAX
    run's ``{"relaxation": 0.7, "max_iterations": 40}``.

    Returns ``(kf, out, x_analysis, p_inv_analysis)``."""
    from ..core.propagators import PixelPrior, tip_prior_arrays
    from ..engine.filter import KalmanFilter
    from ..engine.priors import TIP_PARAMETER_LIST, FixedGaussianPrior
    from ..obsops.twostream import TwoStreamOperator

    dev = resolve_device(mesh.devices[0] if mesh is not None else device)

    def day(i):
        return datetime.datetime(2021, 3, 1) + datetime.timedelta(days=i)

    yy, xx = np.mgrid[:ny, :nx]
    mask = (yy - ny / 2) ** 2 + (xx - nx / 2) ** 2 \
        < (min(ny, nx) / 2.4) ** 2
    mean = tip_prior_arrays()[0].copy()
    mean[6] = np.exp(-0.5 * 2.0)  # the jrc_prior mean
    truth = np.broadcast_to(mean, mask.shape + (7,)).copy()
    truth[..., 6] = 0.45
    sigma = np.full(7, 0.01, np.float32)
    sigma[6] = 0.5
    cov = np.diag(sigma**2).astype(np.float32)
    op = TwoStreamOperator()
    obs = SyntheticObservations(
        dates=[day(i) for i in obs_days], operator=op,
        truth_fn=lambda date: truth, sigma=0.001, mask_prob=0.05,
        device=dev,
    )
    out = MemoryOutput()

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    prior = FixedGaussianPrior(
        PixelPrior(mean=t(mean), cov=t(cov), inv_cov=t(np.linalg.inv(cov))),
        TIP_PARAMETER_LIST,
    )
    if solver_options is None:
        solver_options = {"relaxation": 0.7, "max_iterations": 40}
    kf = KalmanFilter(
        obs, out, mask, TIP_PARAMETER_LIST, state_propagation=None,
        prior=prior, pad_multiple=pad_multiple,
        solver_options=solver_options, scan_window=scan_window, device=dev,
        mesh=mesh, mesh_lane=mesh_lane,
    )
    kf.set_trajectory_uncertainty(np.zeros(7))
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    x_a, _, p_inv_a = kf.run([day(i) for i in grid_days], x0, None, p_inv0)
    return kf, out, x_a, p_inv_a


class MemoryOutput:
    """In-memory output sink: per-parameter mean and sigma rasters, and
    the ``solver_qa`` band, keyed by timestep (numpy on the host)."""

    def __init__(self):
        self.output: Dict[datetime.datetime, Dict[str, np.ndarray]] = {}

    def dump_data(self, timestep, x, p_inv_diag, gather: PixelGather,
                  parameter_list) -> None:
        sol = self.output.setdefault(timestep, {})
        x = x.detach().cpu().numpy()
        diag = None if p_inv_diag is None \
            else p_inv_diag.detach().cpu().numpy()
        for ii, param in enumerate(parameter_list):
            sol[param] = gather.scatter(x[:, ii])
            if diag is not None:
                sigma = 1.0 / np.sqrt(np.maximum(diag[:, ii], 1e-30))
                sol[param + "_unc"] = gather.scatter(sigma.astype(np.float32))

    def dump_qa(self, timestep, verdicts, gather: PixelGather) -> None:
        self.output.setdefault(timestep, {})["solver_qa"] = \
            gather.scatter(verdicts.cpu().numpy().astype(np.uint8))
