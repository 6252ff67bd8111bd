"""The plain references against the port on the CPU at tiny sizes: the
forward models and their Jacobians, one date's Gauss-Newton analysis,
and a whole sound run of each cell (``correct`` true)."""

import math

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import filter as rf
from benchmark.reference import prosail as rp
from benchmark.reference import twostream as rt
from benchmark.scenarios.common import f32_thresh_sq
from benchmark.tests.tiny import CELLS, SEED, TINY

F64 = torch.float64


def _states(lo, hi, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo), np.asarray(hi)
    return torch.as_tensor(lo + (hi - lo) * rng.uniform(0.05, 0.95, (
        n, lo.size)), dtype=F64)


def test_twostream_forward_and_jacobian_match_the_port():
    from kafka_tpu_torch.obsops.twostream import TwoStreamOperator

    op = TwoStreamOperator()
    x = _states(rt.LOWER, rt.UPPER, 64, 0)
    lin = op.linearize(None, x.float())
    h0, jac = rf.linearize(rt.forward, x)
    np.testing.assert_allclose(lin.h0.T.double(), h0, atol=2e-6)
    np.testing.assert_allclose(lin.jac.permute(1, 0, 2).double(), jac,
                               atol=2e-5)


def test_prosail_forward_and_jacobian_match_the_port():
    from kafka_tpu_torch.obsops.prosail import ProsailAux, ProsailOperator

    op = ProsailOperator()
    ang = (30.0, 5.0, 90.0)
    aux = ProsailAux(*(torch.tensor(v) for v in ang))
    mean = rp.sail_prior()[0]
    x = torch.as_tensor(np.clip(mean + np.random.default_rng(1).normal(
        0, 0.02, (64, 10)), 0.02, 0.98), dtype=F64)
    lin = op.linearize(aux, x.float())
    h0, jac = rf.linearize(lambda z: rp.forward(z, *ang), x)
    np.testing.assert_allclose(lin.h0.T.double(), h0, atol=2e-6)
    np.testing.assert_allclose(lin.jac.permute(1, 0, 2).double(), jac,
                               atol=2e-5, rtol=1e-4)


def test_one_tip_date_matches_the_port():
    from kafka_tpu_torch.core.solvers import assimilate_date
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    n = 2048
    op, bands, x0, p_inv0 = make_tip_problem(n, seed=2, device="cpu")
    x_p, a_p, diags = assimilate_date(
        op.linearize, bands, x0, p_inv0, None,
        {"state_bounds": op.state_bounds, "norm_denominator": n * 7.0},
        device="cpu")
    group = torch.zeros(n, dtype=torch.long)
    thresh = torch.full((1,), f32_thresh_sq(1e-3, n * 7, 1.0), dtype=F64)
    x_r, a_r, verdict = rf.gn_date(
        rt.forward, x0.double(), p_inv0.double(), bands.y.T.double(),
        bands.r_inv.T.double(), bands.mask.T, torch.as_tensor(rt.LOWER),
        torch.as_tensor(rt.UPPER), 1.0, group, thresh,
        torch.ones(1, dtype=F64), 2, 25, float(np.float32(7e-3) ** 2))
    gap = (x_p.double() - x_r).abs()
    assert float(gap.median()) < 2e-5 and float(gap.max()) < 2e-3
    info = torch.diagonal(a_r, dim1=1, dim2=2)
    rel = (torch.diagonal(a_p, dim1=1, dim2=2).double() - info).abs() / info
    assert float(rel.median()) < 1e-4
    assert torch.equal(diags.health_verdicts.int(), verdict)


@pytest.mark.parametrize("name", CELLS)
def test_sound_tiny_run_is_correct(name):
    r = harness.run_cell(name, SEED, 0.0, False, device="cpu",
                         overrides=TINY[name])
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"px_dates_per_s", "setup_s"}
    for c in r["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]
