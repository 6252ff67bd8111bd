"""The port's tiling, warp, ROI plumbing, sensor readers and fixtures
against the JAX package's, on the CPU: the same seeded inputs and the
same files on disk through both.  The host chains are the same numpy
code, so tilings, warps, band batches and aux are compared exactly; the
fixtures' forward models run in PyTorch in the port, so their float
files agree within 1e-5 relative and their uint16 DN within one count.
The port must import without ``h5py`` (the S1 decoder)."""

import datetime
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kafka_tpu_torch.engine.state import make_pixel_gather
from kafka_tpu_torch.io import modis as tmodis
from kafka_tpu_torch.io import roi as troi
from kafka_tpu_torch.io import sentinel1 as ts1
from kafka_tpu_torch.io import sentinel2 as ts2
from kafka_tpu_torch.io import tiling as ttiling
from kafka_tpu_torch.io import warp as twarp
from kafka_tpu_torch.io.geotiff import GeoInfo, read_geotiff, write_geotiff
from kafka_tpu_torch.testing import fixtures as tfix

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GEO = GeoInfo(geotransform=(576000.0, 10.0, 0.0, 4325000.0, 0.0, -10.0),
              projection="WGS 84 / UTM zone 30N", epsg=32630)


def day(y, m, d, h=0):
    return datetime.datetime(y, m, d, h)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _gathers(mask, pad=64):
    """The JAX and the port PixelGather of one mask."""
    from kafka_tpu.engine.state import make_pixel_gather as jgather

    return jgather(mask, pad), make_pixel_gather(mask, pad)


def _same_bands(jobs, tobs):
    for f in ("y", "r_inv", "mask"):
        a, b = _np(getattr(jobs.bands, f)), _np(getattr(tobs.bands, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert tobs.bands.y.device == CPU


# --- tiling, warp, roi -----------------------------------------------------

@pytest.mark.parametrize("nx,ny,block", [
    (80, 48, (40, 48)), (100, 37, (32, 16)), (2400, 2400, (1098, 1098)),
    (5, 7, (256, 256))])
def test_tiling_equals_jax(nx, ny, block):
    from kafka_tpu.io import tiling as jt

    jc = list(jt.get_chunks(nx, ny, block))
    tc = list(ttiling.get_chunks(nx, ny, block))
    assert [tuple(c) for c in tc] == [tuple(c) for c in jc]
    mask = np.random.default_rng(nx).uniform(size=(ny, nx)) > 0.5
    gt = GEO.geotransform
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(ttiling.chunk_mask(mask, b),
                                      jt.chunk_mask(mask, a))
        assert ttiling.chunk_geotransform(gt, b) == \
            jt.chunk_geotransform(gt, a)


def test_warp_transforms_equal_jax():
    from kafka_tpu.io import warp as jw

    rng = np.random.default_rng(0)
    lon = rng.uniform(-6.0, 0.0, 500)
    lat = rng.uniform(35.0, 45.0, 500)
    for epsg in (32630, 32730):
        e_t = twarp.lonlat_to_utm(lon, lat, epsg)
        np.testing.assert_array_equal(e_t, jw.lonlat_to_utm(lon, lat, epsg))
        np.testing.assert_array_equal(twarp.utm_to_lonlat(*e_t, epsg),
                                      jw.utm_to_lonlat(*e_t, epsg))
    for crs in (4326, "EPSG:32630", "sinusoidal", 6974):
        xy = twarp.from_lonlat(crs, lon, lat)
        np.testing.assert_array_equal(xy, jw.from_lonlat(crs, lon, lat))
        np.testing.assert_array_equal(twarp.to_lonlat(crs, *xy),
                                      jw.to_lonlat(crs, *xy))


@pytest.mark.parametrize("src_crs,method", [
    (32630, "nearest"), (32630, "bilinear"), ("sinusoidal", "nearest"),
    (4326, "bilinear")])
def test_grid_mapping_and_resample_equal_jax(src_crs, method):
    from kafka_tpu.io import warp as jw

    rng = np.random.default_rng(1)
    dst_gt = (576000.0, 10.0, 0.0, 4325000.0, 0.0, -10.0)
    if src_crs == 32630:
        src_gt = (575990.0, 20.0, 0.0, 4325010.0, 0.0, -20.0)
    else:
        lon, lat = twarp.utm_to_lonlat(576000.0, 4325000.0, 32630)
        x0, y0 = twarp.from_lonlat(src_crs, lon, lat)
        step = 1e-4 if src_crs == 4326 else 15.0
        src_gt = (float(x0) - step, step, 0.0, float(y0) + step, 0.0, -step)
    src = rng.normal(size=(40, 50, 3)).astype(np.float32)
    tm = twarp.grid_mapping(src_gt, (30, 36), dst_gt, src_crs, 32630)
    jm = jw.grid_mapping(src_gt, (30, 36), dst_gt, src_crs, 32630)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        twarp.resample(src, *tm, method=method),
        jw.resample(src, *jm, method=method))
    np.testing.assert_array_equal(
        twarp.reproject_raster(src[..., 0], src_gt, (30, 36), dst_gt,
                               src_crs, 32630, method=method),
        jw.reproject_raster(src[..., 0], src_gt, (30, 36), dst_gt,
                            src_crs, 32630, method=method))


def test_roi_helpers_equal_jax(tmp_path):
    from kafka_tpu.io import roi as jr

    names = ["X.A2017001.tif", "X.A2017017.tif", "X.A2017033.tif",
             "Y.A2017017.tif", "nodate.tif"]
    for n in names:
        (tmp_path / n).write_text("")
    rx = re.compile(r"\.A(\d{7})")
    for start, end in ((None, None), (day(2017, 1, 2), day(2017, 2, 1))):
        got = troi.index_dated_paths(str(tmp_path / "*.tif"), rx, start, end)
        want = jr.index_dated_paths(str(tmp_path / "*.tif"), rx, start, end)
        assert got == want and got

    raster = np.arange(24 * 30, dtype=np.float32).reshape(24, 30)
    path = str(tmp_path / "r.tif")
    write_geotiff(path, raster, GEO)

    class T(troi.RoiWindowMixin):
        pass

    class J(jr.RoiWindowMixin):
        pass

    t, j = T(), J()
    for obj in (t, j):
        obj.apply_roi(3, 5, 17, 21)
    np.testing.assert_array_equal(t._read_windowed(path),
                                  j._read_windowed(path))
    np.testing.assert_array_equal(t._read_windowed(path),
                                  raster[5:21, 3:17])
    assert t._shift_geotransform(GEO.geotransform) == \
        j._shift_geotransform(GEO.geotransform)
    np.testing.assert_array_equal(t._window(raster), j._window(raster))


# --- readers on JAX-written fixtures ---------------------------------------

def _s2_tree(root, dtype=np.float32):
    from kafka_tpu.testing.fixtures import make_s2_granule_tree

    return make_s2_granule_tree(str(root), [day(2017, 7, 4), day(2017, 7, 8)],
                                ny=40, nx=48, geo=GEO, noise=0.01,
                                dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_sentinel2_reader_equals_jax(tmp_path, dtype):
    from kafka_tpu.cli.drivers import prosail_aux_builder as jaux
    from kafka_tpu.io.sentinel2 import Sentinel2Observations as JS2

    from kafka_tpu_torch.cli.drivers import prosail_aux_builder as taux

    _s2_tree(tmp_path / "s2", dtype)
    mask = tfix.make_pivot_mask(40, 48, n_pivots=3, seed=3)
    # The state grid: a chunk offset into the granule's grid, so the warp
    # is not the identity.
    gt = (576050.0, 10.0, 0.0, 4324950.0, 0.0, -10.0)
    jg, tg = _gathers(mask)
    jr = JS2(str(tmp_path / "s2"), "op", (gt, 32630), aux_builder=jaux)
    tr = ts2.Sentinel2Observations(str(tmp_path / "s2"), "op", (gt, 32630),
                                   aux_builder=taux, device=CPU)
    assert tr.dates == jr.dates and len(tr.dates) == 2
    assert tr.define_output() == jr.define_output()
    for d in tr.dates:
        jo, to = jr.get_observations(d, jg), tr.get_observations(d, tg)
        _same_bands(jo, to)
        assert to.operator == "op"
        for f in ("sza", "vza", "raa"):
            a, b = getattr(jo.aux, f), getattr(to.aux, f)
            assert b.dtype == torch.float32 and b.shape == ()
            assert float(b) == float(a)
    # The default aux (no builder) is the metadata dict, as in JAX.
    tdef = ts2.Sentinel2Observations(str(tmp_path / "s2"), None, (gt, 32630),
                                     device=CPU, band_workers=1)
    meta = tdef.get_observations(tr.dates[0], tg).aux
    assert meta == dict(zip(("sza", "saa", "vza", "vaa"),
                            ts2.parse_s2_xml(os.path.join(
                                tr.date_data[tr.dates[0]], "metadata.xml"))))


def test_reader_aux_moves_to_the_reader_device():
    aux = {"a": torch.zeros(2), "b": [torch.ones(1), 3.0],
           "c": ts2.to_device(None, CPU)}
    out = ts2.to_device(aux, "meta")
    assert out["a"].device.type == "meta"
    assert out["b"][0].device.type == "meta" and out["b"][1] == 3.0
    from kafka_tpu_torch.obsops.prosail import ProsailAux

    pa = ts2.to_device(ProsailAux(torch.zeros(()), torch.ones(()),
                                  torch.ones(())), "meta")
    assert isinstance(pa, ProsailAux) and pa.vza.device.type == "meta"


def test_parse_s2_xml_equals_jax(tmp_path):
    from kafka_tpu.io.sentinel2 import parse_s2_xml as jparse

    _s2_tree(tmp_path / "s2")
    meta = next((tmp_path / "s2").rglob("metadata.xml"))
    assert ts2.parse_s2_xml(str(meta)) == jparse(str(meta))
    bad = tmp_path / "bad.xml"
    bad.write_text("<granule><Mean_Sun_Angle><ZENITH_ANGLE>1"
                   "</ZENITH_ANGLE></Mean_Sun_Angle></granule>")
    with pytest.raises(ValueError, match="Mean_Sun_Angle"):
        ts2.parse_s2_xml(str(bad))


def test_mcd43_bhr_reader_with_roi_equals_jax(tmp_path):
    from kafka_tpu.io.modis import BHRObservations as JB
    from kafka_tpu.testing.fixtures import make_mcd43_series

    dates = [day(2017, 1, 1) + datetime.timedelta(days=8 * i)
             for i in range(6)]
    make_mcd43_series(str(tmp_path), dates, ny=40, nx=48, geo=GEO,
                      noise=0.01)
    # QA 1 (7 % sigma) and 255 (no data) on a few pixels of one date.
    qa_path = str(tmp_path / "MCD43_A2017009_nir_qa.tif")
    qa, _ = read_geotiff(qa_path)
    qa = qa.copy()
    qa[2:6, 3:9] = 1
    qa[10:12, :] = 255
    write_geotiff(qa_path, qa, GEO)
    mask = tfix.make_pivot_mask(20, 24, n_pivots=2, seed=1)
    jg, tg = _gathers(mask)
    for period in (1, 2, 16):
        jr = JB(str(tmp_path), "op", start_time=dates[0],
                end_time=dates[-1], period=period)
        tr = tmodis.BHRObservations(str(tmp_path), "op",
                                    start_time=dates[0], end_time=dates[-1],
                                    period=period, device=CPU)
        assert tr.dates == jr.dates
        for r in (jr, tr):
            r.apply_roi(4, 0, 28, 20)
        assert tr.define_output() == jr.define_output()
        for d in tr.dates:
            jo, to = jr.get_observations(d, jg), tr.get_observations(d, tg)
            _same_bands(jo, to)
            assert to.aux is None


def test_synergy_reader_equals_jax(tmp_path):
    from kafka_tpu.io.modis import SynergyKernels as JS
    from kafka_tpu.testing.fixtures import make_synergy_series

    dates = [day(2017, 3, 1), day(2017, 3, 9)]
    make_synergy_series(str(tmp_path), dates, ny=24, nx=24, geo=GEO)
    mask = tfix.make_pivot_mask(12, 16, n_pivots=2, seed=2)
    jg, tg = _gathers(mask)
    jr = JS(str(tmp_path), "op")
    tr = tmodis.SynergyKernels(str(tmp_path), "op", device=CPU)
    assert tr.dates == jr.dates == dates
    for r in (jr, tr):
        r.apply_roi(2, 5, 18, 17)
    assert tr.define_output() == jr.define_output()
    for d in dates:
        _same_bands(jr.get_observations(d, jg), tr.get_observations(d, tg))


@pytest.mark.parametrize("enl", [None, 4.5, "auto"])
def test_s1_reader_equals_jax(tmp_path, enl):
    from kafka_tpu.io.sentinel1 import S1Observations as JS1
    from kafka_tpu.testing.fixtures import make_s1_series

    dates = [day(2017, 7, 2, 17), day(2017, 7, 8, 17)]
    make_s1_series(str(tmp_path), dates, ny=64, nx=64, geo=GEO, noise=0.3,
                   seed=4)
    mask = tfix.make_pivot_mask(30, 40, n_pivots=3, seed=5)
    gt = (576100.0, 10.0, 0.0, 4324900.0, 0.0, -10.0)
    jg, tg = _gathers(mask)
    kw = dict(enl=enl, noise_floor=1e-3)
    jr = JS1(str(tmp_path), (gt, 32630), operator="op", **kw)
    tr = ts1.S1Observations(str(tmp_path), (gt, 32630), operator="op",
                            device=CPU, **kw)
    assert tr.dates == jr.dates == dates
    if enl == "auto":
        assert tr._auto_enl(tr.date_data[dates[0]]) is not None
    for d in dates:
        jo, to = jr.get_observations(d, jg), tr.get_observations(d, tg)
        _same_bands(jo, to)
        np.testing.assert_array_equal(_np(to.aux.theta_deg),
                                      _np(jo.aux.theta_deg))
        assert to.aux.theta_deg.shape == (tg.n_pad,)


def test_estimate_enl_equals_jax():
    from kafka_tpu.io.sentinel1 import estimate_enl as jenl

    rng = np.random.default_rng(7)
    img = rng.gamma(5.0, 0.02, (90, 120))
    img[:10, :10] = ts1.MISSING_VALUE
    assert ts1.estimate_enl(img) == jenl(img)
    assert ts1.estimate_enl(img[:20, :20]) is None


# --- emulator-bank selection ------------------------------------------------

GRID = [(sza, vza, raa) for sza in (20.0, 40.0, 60.0)
        for vza in (0.0, 10.0) for raa in (0.0, 90.0, 180.0)]


@pytest.mark.parametrize("keys", [GRID, GRID[::3], GRID[1::4]],
                         ids=["complete", "thin", "sparse"])
def test_nearest_geometry_picks_the_jax_bank(keys):
    from kafka_tpu.io.sentinel2 import (find_nearest_geometry as jfind,
                                        geometry_bank_aux_builder as jbuild)

    banks = {k: f"bank{i}" for i, k in enumerate(keys)}
    tb, jb = ts2.geometry_bank_aux_builder(banks), jbuild(banks)
    rng = np.random.default_rng(len(keys))
    for _ in range(40):
        sza, vza = rng.uniform(15, 65), rng.uniform(0, 12)
        saa, vaa = rng.uniform(0, 360, 2)
        assert ts2.find_nearest_geometry(keys, sza, vza, vaa - saa) == \
            jfind(keys, sza, vza, vaa - saa)
        meta = {"sza": sza, "vza": vza, "saa": saa, "vaa": vaa}
        assert tb(meta, None) == jb(meta, None)


# --- import without h5py ----------------------------------------------------

def test_port_imports_without_h5py():
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import kafka_tpu_torch.io, kafka_tpu_torch.io.sentinel1\n"
        "import kafka_tpu_torch.cli, kafka_tpu_torch.cli.run_s1\n"
        "import kafka_tpu_torch.cli.run_joint, kafka_tpu_torch.cli.drivers\n"
        "import kafka_tpu_torch.testing.fixtures\n"
        "from kafka_tpu_torch.engine.config import RunConfig\n"
        "try:\n"
        "    import h5py\n"
        "except ImportError:\n"
        "    print('no h5py')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no h5py"


# --- the fixtures -----------------------------------------------------------

def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _same_files(troot, jroot, rtol=1e-5, dn=1):
    names = _tree(troot)
    assert names and names == _tree(jroot)
    for name in names:
        if name.endswith(".xml"):
            assert (troot / name).read_text() == (jroot / name).read_text()
            continue
        if name.endswith(".nc"):
            import h5py

            with h5py.File(troot / name) as a, h5py.File(jroot / name) as b:
                assert set(a) == set(b) and dict(a.attrs).keys() == \
                    dict(b.attrs).keys()
                for k in a.attrs:
                    np.testing.assert_array_equal(a.attrs[k], b.attrs[k])
                for k in a:
                    np.testing.assert_allclose(a[k][...], b[k][...],
                                               rtol=rtol, err_msg=name)
            continue
        a, ia = read_geotiff(str(troot / name))
        b, ib = read_geotiff(str(jroot / name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert ia.geo == ib.geo, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name)
        else:
            assert np.abs(a.astype(np.int64) - b).max() <= dn, name


@pytest.mark.parametrize("name", ["s2_float32", "s2_uint16", "mcd43",
                                  "synergy", "s1"])
def test_fixtures_write_the_jax_files(tmp_path, name):
    from kafka_tpu.testing import fixtures as jfix

    dates = [day(2017, 7, 4), day(2017, 7, 6, 17)]
    kw = dict(ny=20, nx=24, geo=GEO)
    calls = {
        "s2_float32": ("make_s2_granule_tree",
                       dict(noise=0.01, dtype=np.float32)),
        "s2_uint16": ("make_s2_granule_tree",
                      dict(noise=0.01, dtype=np.uint16)),
        "mcd43": ("make_mcd43_series", dict(noise=0.01)),
        "synergy": ("make_synergy_series", {}),
        "s1": ("make_s1_series", dict(noise=0.05, truth_sm=0.35)),
    }
    fn, extra = calls[name]
    for sub in ("t", "j"):  # make_mcd43_series writes into an existing dir
        (tmp_path / sub).mkdir()
    got = getattr(tfix, fn)(str(tmp_path / "t"), dates, **kw, **extra)
    want = getattr(jfix, fn)(str(tmp_path / "j"), dates, **kw, **extra)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)
    _same_files(tmp_path / "t", tmp_path / "j")
