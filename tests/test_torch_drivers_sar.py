"""The port's Sentinel-1 drivers against the JAX drivers on the CPU
(mirroring tests/test_drivers.py's TestS1Driver and TestJointDriver):
``run_s1`` (the Water-Cloud state, LAI and soil moisture) and
``run_joint`` (S2 + S1 on the 11-parameter joint state) run through both
packages' ``main`` over the same NetCDF and granule trees and the same
saved ``RunConfig``, two chunks each.  Equal stats (but ``wall_s``),
equal file sets and restart markers, state rasters within atol 2e-3,
sigma rasters within rtol 1e-2 / atol 2e-3, QA rasters equal (the
budgets of tests/test_torch_cli.py), and the port's analysis moved from
the prior toward the SAR truth.  The S1 reader needs ``h5py``, which
this machine has."""

import datetime
import glob
import os

import numpy as np
import pytest

from kafka_tpu_torch.io.geotiff import GeoInfo, read_geotiff, write_geotiff
from kafka_tpu_torch.testing.fixtures import (make_pivot_mask,
                                              make_s1_series,
                                              make_s2_granule_tree)

GEO = GeoInfo(geotransform=(576000.0, 10.0, 0.0, 4325000.0, 0.0, -10.0),
              projection="WGS 84 / UTM zone 30N", epsg=32630)
LAI, SM = 3.0, 0.4


def write_mask(path, ny, nx, seed=3):
    mask = make_pivot_mask(ny, nx, n_pivots=3, seed=seed)
    write_geotiff(path, mask.astype(np.uint8), GEO)
    return mask


def but_wall(stats):
    return {k: v for k, v in stats.items() if k != "wall_s"}


def same_outputs(port_dir, jax_dir):
    """Equal file sets (markers included); state rasters within atol
    2e-3, sigma rasters within rtol 1e-2 / atol 2e-3, QA equal.  Returns
    the number of rasters compared."""
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    n = 0
    for name in (x for x in names if x.endswith(".tif")):
        a, ia = read_geotiff(os.path.join(port_dir, name))
        b, ib = read_geotiff(os.path.join(jax_dir, name))
        assert a.dtype == b.dtype and ia.geo == ib.geo, name
        if name.startswith("solver_qa_"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=2e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=2e-3, err_msg=name)
        n += 1
    return n


def _last(folder, param):
    files = sorted(f for f in glob.glob(os.path.join(folder,
                                                     f"{param}_*.tif"))
                   if not f.endswith("_unc.tif"))
    assert files, param
    return files[-1]


def _median(path):
    arr, _ = read_geotiff(path)
    vals = arr[arr > 0]
    assert vals.size
    return float(np.median(vals))


def test_s1_driver_matches_jax(tmp_path):
    from kafka_tpu.cli.run_s1 import main as jax_main

    from kafka_tpu_torch.cli.run_s1 import default_config, main

    write_mask(str(tmp_path / "mask.tif"), 40, 40)
    make_s1_series(str(tmp_path / "s1"),
                   [datetime.datetime(2017, 7, 2 + 6 * i, 17)
                    for i in range(3)],
                   truth_lai=LAI, truth_sm=SM, ny=40, nx=40, geo=GEO,
                   noise=0.01)
    cfg = default_config()
    cfg.chunk_size = (20, 40)
    cfg.pad_multiple = 256
    cfg.save(str(tmp_path / "cfg.json"))

    def args(out):
        return ["--config", str(tmp_path / "cfg.json"), "--data-folder",
                str(tmp_path / "s1"), "--state-mask",
                str(tmp_path / "mask.tif"), "--outdir", str(tmp_path / out),
                "--enl", "auto"]

    st = main(args("torch") + ["--device", "cpu"])
    sj = jax_main(args("jax"))
    assert but_wall(st) == but_wall(sj)
    assert (st["run"], st["chunks_with_pixels"], st["dates_assimilated"]) \
        == (2, 2, 6)
    assert sorted(f for f in os.listdir(tmp_path / "torch")
                  if f.startswith(".chunk_")) == [".chunk_0001.done",
                                                  ".chunk_0002.done"]
    assert same_outputs(tmp_path / "torch", tmp_path / "jax") > 0
    for param, truth, prior0 in (("sm", SM, 0.25), ("lai", LAI, 2.0)):
        got = _median(_last(str(tmp_path / "torch"), param))
        assert abs(got - truth) < abs(prior0 - truth), param


def test_joint_driver_matches_jax(tmp_path):
    from kafka_tpu.cli.run_joint import main as jax_main

    from kafka_tpu_torch.cli.run_joint import default_config, main
    from kafka_tpu_torch.engine.priors import joint_prior_arrays

    write_mask(str(tmp_path / "pivots.tif"), 48, 48)
    truth10 = joint_prior_arrays()[0][:10].copy()
    truth10[6] = np.exp(-LAI / 2.0)
    make_s2_granule_tree(str(tmp_path / "s2"),
                         [datetime.datetime(2017, 7, 4),
                          datetime.datetime(2017, 7, 8)],
                         truth_state=truth10, ny=48, nx=48, geo=GEO,
                         noise=0.002)
    make_s1_series(str(tmp_path / "s1"),
                   [datetime.datetime(2017, 7, 6, 17, 55)],
                   truth_lai=LAI, truth_sm=SM, ny=48, nx=48, geo=GEO,
                   noise=0.01)
    cfg = default_config()
    cfg.chunk_size = (24, 48)
    cfg.pad_multiple = 256
    cfg.save(str(tmp_path / "cfg.json"))

    def args(out):
        return ["--config", str(tmp_path / "cfg.json"), "--data-folder",
                str(tmp_path / "s2"), "--s1-folder", str(tmp_path / "s1"),
                "--state-mask", str(tmp_path / "pivots.tif"), "--outdir",
                str(tmp_path / out)]

    st = main(args("torch") + ["--device", "cpu"])
    sj = jax_main(args("jax"))
    assert but_wall(st) == but_wall(sj)
    assert (st["run"], st["chunks_with_pixels"], st["dates_assimilated"]) \
        == (2, 2, 6)
    assert same_outputs(tmp_path / "torch", tmp_path / "jax") > 0
    got = _median(_last(str(tmp_path / "torch"), "sm"))
    assert abs(got - SM) < abs(0.25 - SM)


def test_joint_driver_needs_the_s1_folder(tmp_path):
    from kafka_tpu_torch.cli.run_joint import main

    with pytest.raises(SystemExit):
        main(["--outdir", str(tmp_path), "--device", "cpu"])
