"""The port's MOD09 path against the JAX package: the fixture's granule
files, the reader's ``BandBatch`` and ``KernelsAux``, and ``run_mod09``
through both packages' ``main`` at the JAX driver test's 16 x 16 state
grid (tests/test_drivers.py:188-231: six dates two days apart, noise
0.002, seed 5, the config cut to 2017-06-15 and one 16 x 16 chunk).

Budgets: the fixture's int16 DN within one count (the kernels are two
libraries' float32 chains), the reader's reflectances and kernels to
float32 rounding of those chains; the driver's stats equal but
``wall_s``, state rasters within atol 2e-3 and sigma rasters within
rtol 1e-2 / atol 2e-3 (the drivers' budgets, tests/test_torch_drivers.py),
the median b1_iso of the last date within 0.02 of the truth (the JAX
test's).  The port's fused run (blocks of consecutive daily windows)
equals its unfused run bit for bit."""

import datetime
import glob
import os

import numpy as np
import pytest
import torch

from kafka_tpu_torch.cli import run_mod09 as tmod09
from kafka_tpu_torch.engine.state import make_pixel_gather
from kafka_tpu_torch.io.geotiff import GeoInfo, read_geotiff, write_geotiff
from kafka_tpu_torch.io.mod09 import MOD09Observations
from kafka_tpu_torch.obsops.kernels import KernelsOperator
from kafka_tpu_torch.testing.fixtures import make_mod09_granules

GEO = GeoInfo(geotransform=(576000.0, 10.0, 0.0, 4325000.0, 0.0, -10.0),
              projection="WGS 84 / UTM zone 30N", epsg=32630)
STATE_ATOL = 2e-3
SIGMA_RTOL, SIGMA_ATOL = 1e-2, 2e-3
NY = NX = 8
DATES = [datetime.datetime(2017, 6, 1) + datetime.timedelta(days=2 * i)
         for i in range(6)]


def _tifs(folder):
    return sorted(n for n in os.listdir(folder) if n.endswith(".tif"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from kafka_tpu.testing.fixtures import make_mod09_granules as jax_make

    root = tmp_path_factory.mktemp("mod09")
    truth = make_mod09_granules(str(root / "torch"), DATES, ny=NY, nx=NX,
                                noise=0.002, seed=5, geo=GEO)
    jtruth = jax_make(str(root / "jax"), DATES, ny=NY, nx=NX, noise=0.002,
                      seed=5, geo=GEO)
    return root, truth, jtruth


def test_fixture_files_match_jax(trees):
    root, truth, jtruth = trees
    np.testing.assert_array_equal(truth, jtruth)
    grans = sorted(os.listdir(root / "torch"))
    assert grans == sorted(os.listdir(root / "jax")) and len(grans) == 6
    for g in grans:
        names = _tifs(root / "torch" / g)
        assert names == _tifs(root / "jax" / g) and len(names) == 12
        for name in names:
            a, ia = read_geotiff(str(root / "torch" / g / name))
            b, ib = read_geotiff(str(root / "jax" / g / name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert ia.geo == ib.geo
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert diff.max() <= 1, (g, name)


def test_reader_batch_and_aux_match_jax(trees):
    from kafka_tpu.engine.state import make_pixel_gather as jgather
    from kafka_tpu.io.mod09 import MOD09Observations as JObs
    from kafka_tpu.obsops.kernels import KernelsOperator as JKernels

    root, _, _ = trees
    mask = np.ones((2 * NY, 2 * NX), bool)
    mask[:3, :5] = False
    tobs = MOD09Observations(str(root / "jax"), KernelsOperator(7),
                             device="cpu")
    jobs = JObs(str(root / "jax"), JKernels(7))
    assert tobs.dates == jobs.dates == DATES
    assert tobs.define_output() == jobs.define_output()
    for date in DATES[::5]:
        t = tobs.get_observations(date, make_pixel_gather(mask, 64))
        j = jobs.get_observations(date, jgather(mask, 64))
        np.testing.assert_array_equal(t.bands.mask.numpy(),
                                      np.asarray(j.bands.mask))
        np.testing.assert_array_equal(t.bands.r_inv.numpy(),
                                      np.asarray(j.bands.r_inv))
        np.testing.assert_array_equal(t.bands.y.numpy(),
                                      np.asarray(j.bands.y))
        for f in ("k_vol", "k_geo"):
            got = getattr(t.aux, f)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(j.aux, f)),
                                       rtol=1e-5, atol=2e-6, err_msg=f)


def test_reader_defaults_to_cuda(trees, monkeypatch):
    root, _, _ = trees
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MOD09Observations(str(root / "jax"), KernelsOperator(7))


@pytest.fixture(scope="module")
def runs(trees):
    from kafka_tpu.cli.run_mod09 import main as jax_main

    root, truth, _ = trees
    mask = np.ones((2 * NY, 2 * NX), bool)
    write_geotiff(str(root / "mask.tif"), mask.astype(np.uint8), GEO)
    cfg = tmod09.default_config()
    cfg.end = datetime.datetime(2017, 6, 15)
    cfg.chunk_size = (16, 16)
    cfg.pad_multiple = 64
    cfg.save(str(root / "cfg.json"))
    cfg.scan_window = 1
    cfg.save(str(root / "cfg_unfused.json"))

    def args(out, cfg_name="cfg.json"):
        return ["--config", str(root / cfg_name), "--data-folder",
                str(root / "jax"), "--state-mask", str(root / "mask.tif"),
                "--outdir", str(root / out)]

    return {"root": root, "truth": truth, "mask": mask,
            "jax": jax_main(args("jax_out")),
            "torch": tmod09.main(args("torch_out") + ["--device", "cpu"]),
            "unfused": tmod09.main(args("unfused_out", "cfg_unfused.json")
                                   + ["--device", "cpu"])}


def test_default_config_matches_jax():
    from kafka_tpu.cli.run_mod09 import default_config

    assert tmod09.default_config().to_json() == default_config().to_json()


def test_run_mod09_matches_jax(runs):
    root = runs["root"]
    st, sj = dict(runs["torch"]), dict(runs["jax"])
    st.pop("wall_s"), sj.pop("wall_s")
    assert st == sj and st["run"] == 1
    names = sorted(os.listdir(root / "torch_out"))
    assert names == sorted(os.listdir(root / "jax_out"))
    tifs = [n for n in names if n.endswith(".tif")]
    # 14 daily windows x 21 kernel weights x (mean, sigma).
    assert len(tifs) == 14 * 21 * 2
    for name in tifs:
        a, ia = read_geotiff(str(root / "torch_out" / name))
        b, ib = read_geotiff(str(root / "jax_out" / name))
        assert a.shape == b.shape and ia.geo == ib.geo, name
        assert np.isfinite(a).all(), name
        if name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=SIGMA_RTOL,
                                       atol=SIGMA_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=STATE_ATOL, err_msg=name)
    iso = sorted(glob.glob(str(root / "torch_out" / "b1_iso_*.tif")))
    iso = [f for f in iso if "_unc" not in f]
    vals = read_geotiff(iso[-1])[0][runs["mask"]]
    # truth b1 iso = 0.05; the weak prior starts at 0.15
    assert abs(np.median(vals) - runs["truth"][0]) < 0.02


def test_fused_run_equals_unfused_bit_for_bit(runs):
    root = runs["root"]
    tifs = [n for n in sorted(os.listdir(root / "torch_out"))
            if n.endswith(".tif")]
    assert tifs == [n for n in sorted(os.listdir(root / "unfused_out"))
                    if n.endswith(".tif")]
    for name in tifs:
        a, _ = read_geotiff(str(root / "torch_out" / name))
        b, _ = read_geotiff(str(root / "unfused_out" / name))
        assert a.tobytes() == b.tobytes(), name


def test_run_mod09_restart_skips_the_chunk(runs):
    root = runs["root"]
    before = sorted(os.listdir(root / "torch_out"))
    stats = tmod09.main(["--data-folder", str(root / "jax"), "--config",
                         str(root / "cfg.json"), "--state-mask",
                         str(root / "mask.tif"), "--outdir",
                         str(root / "torch_out"), "--device", "cpu"])
    assert stats["run"] == 0
    assert sorted(os.listdir(root / "torch_out")) == before


def test_run_mod09_defaults_to_cuda(runs, monkeypatch):
    root = runs["root"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmod09.main(["--config", str(root / "cfg.json"), "--data-folder",
                     str(root / "jax"), "--state-mask",
                     str(root / "mask.tif"), "--outdir",
                     str(root / "refused")])
    assert not os.path.exists(root / "refused")
