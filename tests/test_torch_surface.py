"""The port's public import surface against the JAX package's: the
re-exported names and the helpers added beside them (layout helpers,
``blend_gaussians``, ``linear_solve``), on the same numpy inputs.

Tolerances: the layout helpers are exact; ``blend_gaussians`` and
``linear_solve`` solve small SPD systems in float32 in two libraries and
are held to rtol 1e-5 / atol 1e-6."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kafka_tpu
import kafka_tpu.core as jcore
import kafka_tpu_torch
import kafka_tpu_torch.core as tcore
from kafka_tpu_torch import convert

RTOL, ATOL = 1e-5, 1e-6


def test_root_and_core_reexport_the_jax_names():
    for name in ("BandBatch", "GaussianState", "Linearization",
                 "PixelPrior", "iterate_time_grid", "tip_prior"):
        assert hasattr(kafka_tpu, name) and hasattr(kafka_tpu_torch, name)
    jax_names = {n for n in dir(jcore) if not n.startswith("_")
                 and not hasattr(getattr(jcore, n), "__path__")
                 and type(getattr(jcore, n)).__name__ != "module"}
    missing = jax_names - set(tcore.__all__)
    assert missing == {"assimilate_date_jit"}, missing
    doc = tcore.__doc__
    assert all(name in doc for name in missing)


@pytest.mark.parametrize("package", ["serve", "smoother", "telemetry"])
def test_slice_packages_export_the_jax_names(package):
    """``serve``, ``smoother`` and ``telemetry`` export the JAX package's
    names; each one left out (the router's) is named in the port
    package's docstring."""
    import importlib

    jax_mod = importlib.import_module(f"kafka_tpu.{package}")
    port = importlib.import_module(f"kafka_tpu_torch.{package}")
    missing = set(jax_mod.__all__) - set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
    assert all(name in port.__doc__ for name in missing), missing
    expected = {
        "serve": {"HashRing", "RoutePolicy", "TileRouter", "stable_hash"},
        "smoother": set(),
        "telemetry": set(),
    }[package]
    assert missing == expected, missing


def test_layout_helpers_match_jax():
    rng = np.random.default_rng(0)
    flat = rng.normal(size=12).astype(np.float32)
    np.testing.assert_array_equal(
        tcore.flat_to_pixel_major(torch.as_tensor(flat), 3).numpy(),
        np.asarray(jcore.flat_to_pixel_major(jnp.asarray(flat), 3)))
    x = rng.normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcore.pixel_major_to_flat(torch.as_tensor(x)).numpy(),
        np.asarray(jcore.pixel_major_to_flat(jnp.asarray(x))))
    blocks = rng.normal(size=(5, 2, 2)).astype(np.float32)
    dense = np.zeros((10, 10), np.float32)
    for i in range(5):
        dense[2 * i:2 * i + 2, 2 * i:2 * i + 2] = blocks[i]
    np.testing.assert_array_equal(tcore.block_diag_to_batched(dense, 2),
                                  blocks)
    np.testing.assert_array_equal(
        tcore.block_diag_to_batched(dense, 2),
        np.asarray(jcore.block_diag_to_batched(dense, 2)))


def _spd(rng, n, p):
    m = rng.normal(size=(n, p, p)).astype(np.float32)
    return (m @ m.transpose(0, 2, 1) + 2 * np.eye(p)).astype(np.float32)


def test_blend_gaussians_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _spd(rng, 16, 4), _spd(rng, 16, 4)
    ma, mb = (rng.normal(size=(16, 4)).astype(np.float32) for _ in range(2))
    jx, ja = jcore.blend_gaussians(*(jnp.asarray(v) for v in (ma, a, mb, b)))
    tx, ta = tcore.blend_gaussians(*(torch.as_tensor(v)
                                     for v in (ma, a, mb, b)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("masked", [False, True])
def test_linear_solve_matches_jax(masked):
    rng = np.random.default_rng(2)
    n, p, nb = 24, 3, 2
    jac = np.zeros((nb, n, p), np.float32)
    jac[0, :, 0] = jac[1, :, 2] = 1.0
    h0 = np.zeros((nb, n), np.float32)
    y = rng.normal(size=(nb, n)).astype(np.float32)
    mask = rng.uniform(size=(nb, n)) > (0.3 if masked else -1.0)
    r_inv = np.where(mask, 4.0, 0.0).astype(np.float32)
    x_f = rng.normal(size=(n, p)).astype(np.float32)
    p_inv = _spd(rng, n, p)
    jx, ja, jd = jcore.linear_solve(
        jcore.Linearization(h0=jnp.asarray(h0), jac=jnp.asarray(jac)),
        jcore.BandBatch(jnp.asarray(y), jnp.asarray(r_inv),
                        jnp.asarray(mask)),
        jnp.asarray(x_f), jnp.asarray(p_inv))
    tx, ta, td = tcore.linear_solve(
        tcore.Linearization(h0=torch.as_tensor(h0), jac=torch.as_tensor(jac)),
        convert.band_batch(y, r_inv, mask, "cpu"), torch.as_tensor(x_f),
        torch.as_tensor(p_inv))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(td.innovations.numpy(),
                               np.asarray(jd.innovations), rtol=RTOL,
                               atol=ATOL)
    assert int(td.n_iterations) == int(jd.n_iterations) == 1
