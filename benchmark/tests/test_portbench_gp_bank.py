"""The cells ``s2_gp_bank.july_chunks`` and ``modis_tip.composite_year``
on the CPU at tiny sizes: the manifest's entries and the configuration's
widths, the GP reference against the port, the GP row kernel's count,
its two per-layer readers, and a whole sound run of each cell (traced,
``correct`` true)."""

import numpy as np
import pytest
import torch

from benchmark import gp_roofline, harness, roofline
from benchmark.reference import filter as rf
from benchmark.reference import gp as rg
from benchmark.tests.tiny import SEED

GP_CELL = "s2_gp_bank.july_chunks"
COMPOSITE = "modis_tip.composite_year"
TINY = {
    GP_CELL: {
        "config": {"chunk": [16, 16], "n_chunks": 2,
                   "emulators": {"training_points": 100, "fit_steps": 200,
                                 "holdout": 200}},
        "workload": {"sample_pixels": 128},
    },
    COMPOSITE: {
        "config": {"tile": [32, 40], "n_valid": 1024,
                   "run_config": {"end": "2017-03-07T00:00:00"}},
        "workload": {"warmup_windows": 4},
    },
}


def test_the_new_entries_and_the_configuration_widths():
    man = harness.manifest()
    spec = harness.cell(GP_CELL, man)
    conf, em = spec["config"], spec["config"]["emulators"]
    assert len(conf["run_config"]["parameter_list"]) == 10
    assert (em["bands"], em["inputs"], em["training_points"]) == (10, 10,
                                                                  250)
    assert conf["run_config"]["extra"]["gp_n_bands"] == em["bands"]
    assert conf["run_config"]["operator"] == "gp_bank"
    assert conf["chunk"] == [2196, 2196] and conf["reduced"] == [
        "chunk", "n_chunks"]
    assert {"training_points", "geometries"} <= set(conf["assumed"])
    names = [m["name"] for m in spec["per_layer"]]
    assert {"gp_rows.roofline_share", "gp_rows.ms_per_date",
            "fused_update.roofline_share"} <= set(names)
    comp = harness.cell(COMPOSITE, man)
    assert comp["workload"]["obs_step_days"] == 16
    assert comp["config"]["name"] == "modis_tip_tile"
    assert "fused_gn.roofline_share" in [m["name"]
                                         for m in comp["per_layer"]]
    assert "gp_rows.roofline_share" not in [m["name"]
                                            for m in comp["per_layer"]]


def test_gp_reference_matches_the_port_and_its_own_gradient():
    from kafka_tpu_torch.obsops.gp import GPBankOperator, fit_gp

    rng = np.random.default_rng(0)
    x = rng.uniform(0.1, 0.9, (3, 50, 4))
    bank = fit_gp(x, np.sin(x.sum(-1)), device="cpu")
    maps = np.array([[0, 1, 6, 2], [3, 4, 6, 5], [0, 0, 1, 2]])
    z = torch.as_tensor(rng.uniform(0.1, 0.9, (64, 7)))
    h0, jac = rg.jacobian(bank, z, maps)
    h_a, j_a = rf.linearize(rg.forward(bank, maps), z)
    np.testing.assert_allclose(h0, h_a, atol=1e-14)
    np.testing.assert_allclose(jac, j_a, atol=1e-12)
    lin = GPBankOperator(7, 3, maps).linearize(bank, z.float())
    np.testing.assert_allclose(lin.h0.T.double(), h0, atol=1e-5)
    np.testing.assert_allclose(lin.jac.permute(1, 0, 2).double(), jac,
                               atol=1e-4)


def test_gp_rows_count():
    """53 operations a (pixel, band, training point) at 10 inputs; one
    launch over a 2196 x 2196 chunk bound by its operations."""
    assert gp_roofline.ops_per_point(10) == 53
    bytes_moved, flops = gp_roofline.gp_rows_work(4_822_528, 10, 10, 250,
                                                  10)
    assert bytes_moved == 4.0 * 4_822_528 * 120
    assert flops == 4_822_528 * 10 * (250 * 53 + 42)
    assert gp_roofline.gp_rows_bound_s(4_822_528, 10, 10, 250, 10) == \
        pytest.approx(flops / roofline.PEAK_F32_FLOPS)


def _run(kernels, dates, emulators=True):
    config = harness.cell(GP_CELL)["config"]
    if not emulators:
        config = {k: v for k, v in config.items() if k != "emulators"}
    return {"trace": {"window_s": 1.0, "kernels": kernels},
            "dates": dates, "config": config}


def test_gp_rows_readers():
    share = harness.metric_reader("gp_rows.roofline_share")
    per_date = harness.metric_reader("gp_rows.ms_per_date")
    bound = gp_roofline.gp_rows_bound_s(4_822_528, 10, 10, 250, 10)
    kernels = [("void (anonymous namespace)::gp_rows_kernel<10>(...)",
                2 * bound), ("fused_update_kernel<10, 10>", 1.0)] * 3
    dates = [{"n_pad": 4_822_528, "gp_rows_ms": v} for v in (30.0, 40.0)]
    assert share(_run(kernels, dates)) == pytest.approx(50.0)
    assert per_date(_run(kernels, dates)) == pytest.approx(35.0)
    # Nothing to read: no launches (the parent, or another operator), no
    # field (the CPU, untraced), no trace, no emulators.
    assert share(_run(kernels[1:2], dates)) is None
    assert share(_run(kernels, dates, emulators=False)) is None
    assert share({"dates": dates, "config": {}}) is None
    assert per_date(_run(kernels, [{"n_pad": 256}])) is None
    assert per_date({}) is None


@pytest.mark.parametrize("cell", [GP_CELL, COMPOSITE])
def test_a_traced_tiny_run_is_correct(cell):
    r = harness.run_cell(cell, SEED, 0.0, True, device="cpu",
                         overrides=TINY[cell])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["metrics"]["engine.host_ms_per_date"]["value"] > 0
    for name in ("gp_rows.roofline_share", "gp_rows.ms_per_date"):
        assert name not in r["metrics"]
