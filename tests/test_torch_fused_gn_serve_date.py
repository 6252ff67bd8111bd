"""The serve tile's first date: how far float32 Gauss-Newton lands from
float64 there, in the JAX kernel and in the port (ROADMAP Queue 3 item
12).

``chip_smoke.py`` phase ``serve_batch`` folds two serve tiles' first
dates into one ``fused_gn`` launch, and holds the round to the float64
plain version.  That date is ill-conditioned in float32 on most pixels
(sigma 0.002, a flat prior, relaxation 0.5): moving x_f by one ulp moves
the float32 plain version's x further than the float32 solve lies from
float64.  So which float32 implementation lands nearer float64 is the
data's draw, not a fault of either.

Here a seeded crop of that date (the serve tile's configuration at
256 x 256, 13,312 px) runs through the JAX ``fused_gn_rows`` (the Pallas
kernel in interpret mode, as the JAX package's tests run it off-TPU),
the port's float32 plain version, the same on x_f nudged one ulp up and
down, and the port's plain version in float64.  Pinned: at each of the
smoke's QUANTILES of the per-pixel error in x, the JAX kernel and the
port's plain version differ by at most ERR_MARGIN (1.25) times the plain
version's own one-ulp spread, and each lies from float64 within the
smoke's rule for this date (``chip_smoke.held_within_ulp_spread``: at
most the larger of ERR_MARGIN times the other's error and that error
plus the one-ulp spread).  Trip counts and verdicts are equal.  ``-s``
prints the figures.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import chip_smoke as cs  # noqa: E402
from kafka_tpu.core.pallas_solve import (  # noqa: E402
    fused_gn_rows as jax_fused,
)
from kafka_tpu.obsops.twostream import (  # noqa: E402
    TwoStreamOperator as JaxTwoStream,
)
from kafka_tpu_torch.core import fused_gn, solvers  # noqa: E402

CROP = 256


def _x(a, b) -> dict:
    """Phase kernel's summary of the per-pixel x error (max over
    parameters) of ``a`` against ``b`` at QUANTILES."""
    return {"x": cs.quantile_summary((a - b).abs().max(dim=0).values)}


@pytest.fixture(scope="module")
def runs():
    got = cs._capture_date(torch.device("cpu"), 0, CROP, CROP)
    y, w, m, xf, pf, _ = solvers._gn_rows_inputs(
        got["bands"], got["x"].contiguous(), got["p_inv"].contiguous(),
        None)
    lo, hi = (v.numpy() for v in got["opts"]["state_bounds"])
    common = dict(tol=solvers.CONVERGENCE_TOL,
                  min_iterations=solvers.MIN_ITERATIONS,
                  max_iterations=solvers.MAX_ITERATIONS,
                  relaxation=got["opts"]["relaxation"],
                  norm_denominator=got["opts"]["norm_denominator"])
    rows = dict(lin_rows=got["linearize"].__self__.kernel_linearize_rows,
                y=y, r_inv=w, mask_f=m, xf_rows=xf, pf_rows=pf,
                state_bounds_rows=(lo, hi), **common)
    plain = fused_gn.fused_gn_raw_plain(**rows)
    nudged = [fused_gn.fused_gn_raw_plain(**{
        **rows, "xf_rows": torch.nextafter(xf, torch.full_like(xf, to))})
        for to in (float("inf"), float("-inf"))]
    f64 = cs.plain_f64(rows)
    jax_out = jax_fused(
        JaxTwoStream().kernel_linearize_rows,
        *(jnp.asarray(t.numpy()) for t in (y, w, m, xf, pf)),
        state_bounds_rows=(lo, hi), **common)
    port = fused_gn.summarise(plain, xf.shape[1],
                              fused_gn._block(xf.shape[1], 2048),
                              common["norm_denominator"])
    return {"n_pix": xf.shape[1], "n_valid": got["n_valid"],
            "plain": plain, "nudged": nudged, "f64": f64,
            "jax": [np.array(v) for v in jax_out], "port": port}


def _figures(r):
    jx = torch.as_tensor(r["jax"][0])
    x_plain, x_f64 = r["plain"][0], r["f64"][0]
    up, down = (_x(t[0], x_plain) for t in r["nudged"])
    return {"plain_vs_f64": _x(x_plain, x_f64),
            "jax_vs_f64": _x(jx, x_f64),
            "jax_vs_plain": _x(jx, x_plain),
            "ulp_up_vs_plain": up, "ulp_down_vs_plain": down,
            "ulp_spread": cs.ulp_spread(up, down, ("x",))}


def test_the_crop_is_the_serve_date_at_the_interpret_size(runs):
    assert runs["n_pix"] == 13312 and runs["n_valid"] == 13149


def test_jax_kernel_and_port_plain_sit_within_the_ulp_spread(runs):
    f = _figures(runs)
    qs = [str(q) for q in cs.QUANTILES]
    print("\nserve date crop, x error at quantiles " + ", ".join(qs))
    for k, v in f.items():
        print(f"  {k:17s} " + " ".join(f"{v['x'][q]:.3e}" for q in qs))
    # Each other's one-ulp spread: the JAX kernel differs from the
    # port's plain version as a one-ulp move of x_f moves the latter.
    for q in qs:
        assert f["jax_vs_plain"]["x"][q] <= \
            cs.ERR_MARGIN * f["ulp_spread"]["x"][q], q
    # The smoke's rule for this date, with the JAX kernel as the kernel
    # (and the other way round).
    assert cs.held_within_ulp_spread(f["jax_vs_f64"], f["plain_vs_f64"],
                                     f["ulp_spread"], ("x",)) == []
    assert cs.held_within_ulp_spread(f["plain_vs_f64"], f["jax_vs_f64"],
                                     f["ulp_spread"], ("x",)) == []
    # The date is float32-sensitive: one ulp of x_f moves x further
    # than the float32 solve lies from float64, at the median.
    assert f["ulp_spread"]["x"]["0.5"] > f["plain_vs_f64"]["x"]["0.5"]


def test_trips_and_verdicts_equal_the_jax_kernel(runs):
    jax_out, port = runs["jax"], runs["port"]
    assert int(port[4]) == int(jax_out[4])
    np.testing.assert_array_equal(port[6].numpy(), jax_out[6])
    np.testing.assert_array_equal(port[8].numpy(), jax_out[8])
