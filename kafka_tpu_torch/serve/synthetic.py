"""Synthetic tile specs for the serving layer (port of
``kafka_tpu/serve/synthetic.py``).

Tiles that are deterministic and raster-free — the serving twin of
``cli.run_synthetic``.  Observation draws are seeded per (tile, date) by
``SyntheticObservations``, so an incremental serve, a cold rerun and a
crash-replayed serve all see identical inputs.

Numerics are chosen for EXACT warm-resume parity: the diagonal
information propagator (``propagate_information_filter_approx``) keeps
the per-pixel information matrix exactly diagonal, and the identity /
two-stream operators add exactly-symmetric ``J^T R^-1 J`` terms — so
the packed-triangle checkpoint roundtrip is bit-exact and the
incremental serve path reproduces a cold full-series rerun to the bit.
"""

from __future__ import annotations

import datetime
from typing import List, Optional

import numpy as np

from .. import resolve_device
from ..core.propagators import propagate_information_filter_approx
from ..engine import KalmanFilter
from ..testing.fixtures import make_pivot_mask
from ..testing.synthetic import MemoryOutput, SyntheticObservations
from .session import TileSpec

DEFAULT_BASE_DATE = datetime.datetime(2017, 7, 1)


def synthetic_dates(base: datetime.datetime, days: int,
                    obs_every: int) -> List[datetime.datetime]:
    """The tile's observation calendar (run_synthetic's convention)."""
    return [base + datetime.timedelta(days=d)
            for d in range(1, days, obs_every)]


def make_synthetic_tile(
    name: str,
    ckpt_dir: str,
    operator: str = "identity",
    ny: int = 20,
    nx: int = 20,
    days: int = 16,
    step_days: int = 4,
    obs_every: int = 2,
    sigma: Optional[float] = None,
    scan_window: int = 1,
    seed: int = 0,
    base_date: datetime.datetime = DEFAULT_BASE_DATE,
    mask_seed: Optional[int] = None,
    device=None,
) -> TileSpec:
    """One deterministic synthetic tile for the serving daemon, its
    filter on ``device`` (default CUDA; raises without one).

    ``scan_window=1`` (the default) keeps the unfused per-window path —
    the bit-exact serving configuration.  ``mask_seed`` (default
    ``seed``) seeds the pivot mask apart from the observations, so two
    tiles can share one mask (and one shape bucket) with distinct
    observation draws.
    """
    from ..cli.run_synthetic import build_operator

    dev = resolve_device(device)
    op, params, prior, truth_val, aux_fn, op_sigma = build_operator(
        operator, dev
    )
    sigma = op_sigma if sigma is None else sigma
    mask = make_pivot_mask(ny, nx, seed=seed if mask_seed is None
                           else mask_seed)
    truth = np.broadcast_to(
        truth_val, mask.shape + (len(truth_val),)
    ).astype(np.float32)
    dates = synthetic_dates(base_date, days, obs_every)

    def make_filter():
        obs = SyntheticObservations(
            dates=dates, operator=op,
            truth_fn=lambda date: truth, sigma=sigma, aux_fn=aux_fn,
            mask_prob=0.1, seed=seed, device=dev,
        )
        output = MemoryOutput()
        kf = KalmanFilter(
            obs, output, mask, params,
            state_propagation=propagate_information_filter_approx,
            prior=None,
            solver_options={"relaxation": 0.5},
            scan_window=scan_window, device=dev,
        )
        kf.set_trajectory_model()
        kf.set_trajectory_uncertainty(
            np.full(len(params), 1e-3, np.float32)
        )
        x0, p_inv0 = prior.process_prior(None, kf.gather)
        return kf, x0, p_inv0, output

    return TileSpec(
        name=name, make_filter=make_filter, base_date=base_date,
        step_days=step_days, ckpt_dir=ckpt_dir,
    )
