"""The port's fused update (kernel 2's plain version) against the JAX
``_fused_update_rows`` in Pallas interpret mode, on the same numpy rows.

Inputs: random Jacobians and SPD prior information, NaN y under the mask
(as the warp produces nodata), a few pixels under LM escalation
(esc = 1) and one pixel with indefinite prior information (Cholesky
breakdown, NaN x).  Tolerances are the JAX package's own for one fused
update (tests/test_solvers.py:485-486): x and A rtol/atol 1e-4 (the same
float32 operations in the same order, different libraries); the
innovations and the breakdown/non-finite flags must be bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu.core import pallas_solve as jps
from kafka_tpu.core.types import BandBatch as JBandBatch
from kafka_tpu.core.types import Linearization as JLin
from kafka_tpu_torch import convert
from kafka_tpu_torch.core import fused_update as tfu
from kafka_tpu_torch.core import solvers as tsolvers
from kafka_tpu_torch.core.types import Linearization as TLin

RTOL = ATOL = 1e-4
BREAKDOWN_PX = 3
ESC_PX = (5, 17, 40)


def _rows(p, n_bands, n, seed):
    """Numpy row-layout inputs of one fused update."""
    rng = np.random.default_rng(seed)
    jac = rng.normal(size=(n_bands, n, p)).astype(np.float32)
    h0 = rng.normal(size=(n_bands, n)).astype(np.float32)
    y = rng.normal(size=(n_bands, n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=(n_bands, n)).astype(np.float32)
    mask = rng.uniform(size=(n_bands, n)) > 0.3
    x_f = rng.normal(size=(n, p)).astype(np.float32)
    x_lin = (x_f + 0.1 * rng.normal(size=(n, p))).astype(np.float32)
    m = rng.normal(size=(n, p, p)).astype(np.float32)
    p_inv = (np.einsum("npq,nrq->npr", m, m)
             + 3.0 * np.eye(p, dtype=np.float32)).astype(np.float32)
    pf = np.stack([p_inv[:, i, j] for i in range(p) for j in range(i + 1)])
    pf[0, BREAKDOWN_PX] = -1e6
    esc = np.zeros((1, n), np.float32)
    esc[0, list(ESC_PX)] = 1.0
    return dict(
        jac_rows=np.moveaxis(jac, 2, 1).reshape(n_bands * p, n),
        h0=h0, y=np.where(mask, y, np.nan).astype(np.float32),
        w=np.where(mask, w, 0.0).astype(np.float32),
        m=mask.astype(np.float32), xl_rows=np.ascontiguousarray(x_lin.T),
        xf_rows=np.ascontiguousarray(x_f.T), pf_rows=pf, esc_row=esc,
    ), (jac, h0, y, w, mask, x_f, x_lin, p_inv)


@pytest.mark.parametrize("p,n_bands,n", [
    (p, nb, n) for n in (256, 1280)
    for p, nb in ((7, 2), (10, 10), (2, 2), (11, 10), (11, 2))
] + [(2, 1, 256), (7, 1, 256), (10, 1, 256), (11, 1, 256)])
def test_plain_fused_update_matches_jax_kernel(p, n_bands, n):
    rows, _ = _rows(p, n_bands, n, seed=p * 1000 + n)
    order = ("jac_rows", "h0", "y", "w", "m", "xl_rows", "xf_rows",
             "pf_rows", "esc_row")
    xj, aj, ij, hj = (np.asarray(v) for v in jps._fused_update_rows(
        *(jnp.asarray(rows[k]) for k in order), 2048, True))
    xt, at, it, ht = (v.numpy() for v in tfu.fused_update_rows(
        *(torch.as_tensor(rows[k]) for k in order)))
    assert xt.shape == (p, n) and at.shape == (p * (p + 1) // 2, n)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(it, ij)
    assert ht[0, BREAKDOWN_PX] == 1.0 and ht[0].sum() == 1.0
    assert np.isfinite(it).all(), "NaN nodata leaked into the innovations"
    good = np.ones(n, bool)
    good[BREAKDOWN_PX] = False
    assert np.isfinite(xt[:, good]).all() and np.isfinite(at).all()
    print(f"parity fused_update[{p},{n_bands},{n}]: x "
          f"{np.nanmax(np.abs(xt - xj)):.3g} A {np.abs(at - aj).max():.3g}")
    np.testing.assert_allclose(xt, xj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(at, aj, rtol=RTOL, atol=ATOL)


def test_escalation_inflates_the_factored_diagonal_only():
    """esc = 1 changes x (LM-inflated factor) but never the stored A."""
    rows, _ = _rows(10, 10, 256, seed=9)
    t = {k: torch.as_tensor(v) for k, v in rows.items()}
    x1, a1, _, _ = tfu.fused_update_rows(**t)
    x0, a0, _, _ = tfu.fused_update_rows(
        **{**t, "esc_row": torch.zeros_like(t["esc_row"])})
    np.testing.assert_array_equal(a1.numpy(), a0.numpy())
    same = (x1 == x0) | (x1.isnan() & x0.isnan())
    moved = (~same).any(dim=0).numpy()
    assert set(np.nonzero(moved)[0]) == set(ESC_PX)


@pytest.mark.parametrize("p,n_bands", [(7, 2), (10, 10), (2, 2), (11, 10),
                                       (11, 2), (2, 1), (7, 1), (10, 1),
                                       (11, 1)])
def test_kalman_update_use_pallas_matches_jax_fused_update(p, n_bands):
    _, (jac, h0, y, w, mask, x_f, x_lin, p_inv) = _rows(p, n_bands, 256,
                                                        seed=p)
    bands = (np.where(mask, y, np.nan).astype(np.float32),
             np.where(mask, w, 0.0).astype(np.float32), mask)
    xj, aj = jps.fused_update_pallas(
        JLin(h0=jnp.asarray(h0), jac=jnp.asarray(jac)),
        JBandBatch(*(jnp.asarray(v) for v in bands)), jnp.asarray(x_lin),
        jnp.asarray(x_f), jnp.asarray(p_inv), interpret=True)
    aj = np.stack([np.asarray(aj[i][k]) for i in range(p)
                   for k in range(i + 1)])
    xt, at = tsolvers.kalman_update(
        TLin(h0=torch.as_tensor(h0), jac=torch.as_tensor(jac)),
        convert.band_batch(*bands, "cpu"), torch.as_tensor(x_lin),
        torch.as_tensor(x_f), torch.as_tensor(p_inv), use_pallas=True)
    assert xt.shape == (256, p) and at.shape == (256, p, p)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=RTOL,
                               atol=ATOL)
    at_rows = np.stack([at[:, i, k].numpy() for i in range(p)
                        for k in range(i + 1)])
    np.testing.assert_allclose(at_rows, aj, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(at.numpy(), at.transpose(1, 2).numpy())


def test_jac_to_rows_is_the_jax_relayout():
    jac = np.random.default_rng(0).normal(size=(3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tfu.jac_to_rows(torch.as_tensor(jac)).numpy(),
        np.asarray(jps.jac_to_rows(jnp.asarray(jac))))


@pytest.mark.parametrize("p,n_bands", [(3, 2), (10, 2), (7, 10), (21, 7),
                                       (2, 10), (11, 7)])
def test_unsupported_instance_raises(p, n_bands):
    """The CUDA kernel has the (10, 10), (7, 2), (2, 2), (11, 10),
    (11, 2), (2, 1), (7, 1), (10, 1) and (11, 1) instances; any other
    shape on a CUDA tensor raises, naming them, before any launch (the
    p = 21 kernel-weight state takes the dense library path instead)."""
    with pytest.raises(NotImplementedError, match=r"\(10, 10\), \(7, 2\)"):
        tfu.check_instance(p, n_bands)


@pytest.mark.parametrize("p,n_bands", [(10, 10), (7, 2), (2, 2), (11, 10),
                                       (11, 2), (2, 1), (7, 1), (10, 1),
                                       (11, 1)])
def test_supported_instances_pass_the_check(p, n_bands):
    tfu.check_instance(p, n_bands)


def test_every_instance_is_dispatched_by_the_cuda_source():
    """Each (p, n_bands) of INSTANCES has its case in the C dispatch of
    csrc/fused_update.cu (launch and attributes share the list)."""
    import re

    from kafka_tpu_torch.core import _build

    text = (_build.CSRC / "fused_update.cu").read_text()
    listed = {tuple(int(v) for v in m) for m in re.findall(
        r"^\s*X\((\d+), (\d+)\)", text, flags=re.M)}
    assert listed == set(tfu.INSTANCES)


def test_wrapper_refuses_other_devices():
    rows, _ = _rows(7, 2, 64, seed=1)
    t = {k: torch.as_tensor(v, device="meta") for k, v in rows.items()}
    with pytest.raises(ValueError, match="no fused update"):
        tfu.fused_update_rows(**t)
