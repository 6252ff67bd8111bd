"""The port's GeoTIFF codec and output writer against the JAX package's:
files written by one read in the other to the same arrays, the
writers' files identical in array content on the same inputs, the
asynchronous writer holding a snapshot (a tensor mutated after the dump
keeps its old values in the file), the float16 wire, and the native
codec decoding to the zlib path's arrays."""

import datetime

import numpy as np
import pytest
import torch

from kafka_tpu_torch.engine.state import make_pixel_gather
from kafka_tpu_torch.io import GeoInfo, GeoTIFFOutput, read_geotiff, \
    write_geotiff
from kafka_tpu_torch.testing.fixtures import (DEFAULT_GEO, make_pivot_mask,
                                              write_pivot_mask)

RNG = np.random.default_rng(5)
GEO = GeoInfo(geotransform=(576000.0, 10.0, 0.0, 4325000.0, 0.0, -10.0),
              projection="WGS 84 / UTM zone 30N", epsg=32630)


def _array(dtype, shape=(70, 300)):
    if np.issubdtype(dtype, np.floating):
        return RNG.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return RNG.integers(max(info.min, -1000), min(info.max, 1000),
                        size=shape).astype(dtype)


CASES = [
    (np.float32, "deflate", 1), (np.float32, "deflate", 3),
    (np.float32, "lzw", 1), (np.float32, False, 1),
    (np.float64, "deflate", 1), (np.uint8, "deflate", 2),
    (np.int16, "lzw", 2), (np.uint16, "deflate", 1),
    (np.int32, "deflate", 1),
]


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
@pytest.mark.parametrize("dtype,compress,predictor", CASES)
def test_write_read_across_packages(tmp_path, direction, dtype, compress,
                                    predictor):
    from kafka_tpu.io.geotiff import read_geotiff as jax_read
    from kafka_tpu.io.geotiff import write_geotiff as jax_write

    arr = _array(dtype)
    path = str(tmp_path / "r.tif")
    writer, reader = (write_geotiff, jax_read) if direction == "torch->jax" \
        else (jax_write, read_geotiff)
    writer(path, arr, GEO, compress=compress, predictor=predictor)
    got, info = reader(path)
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == arr.dtype
    assert tuple(info.geo.geotransform) == GEO.geotransform
    assert info.geo.epsg == GEO.epsg


def test_multiband_and_nan_across_packages(tmp_path):
    from kafka_tpu.io.geotiff import read_geotiff as jax_read

    arr = _array(np.float32, (33, 45, 3))
    arr[0, 0, 1] = np.nan
    arr[5, 7, 2] = np.inf
    write_geotiff(str(tmp_path / "m.tif"), arr, GEO, predictor=3)
    got, _ = jax_read(str(tmp_path / "m.tif"))
    np.testing.assert_array_equal(got, arr)


def test_fixtures_match_jax(tmp_path):
    from kafka_tpu.io.geotiff import read_geotiff as jax_read
    from kafka_tpu.testing import fixtures as jf

    assert vars(DEFAULT_GEO) == vars(jf.DEFAULT_GEO)
    for args in ((24, 28), (204, 235), (50, 60, 3, 4)):
        np.testing.assert_array_equal(make_pivot_mask(*args),
                                      jf.make_pivot_mask(*args))
    mask = write_pivot_mask(str(tmp_path / "mask.tif"), 24, 28)
    got, info = jax_read(str(tmp_path / "mask.tif"))
    np.testing.assert_array_equal(got.astype(bool), mask)
    assert info.geo.epsg == DEFAULT_GEO.epsg


def _gather():
    mask = np.zeros((20, 30), bool)
    mask[3:17, 4:26] = True
    mask[8, 10] = False
    return make_pixel_gather(mask, pad_multiple=128)


def _outputs(folder):
    return sorted(p.name for p in folder.glob("*.tif"))


@pytest.mark.parametrize("async_writes", [False, True])
def test_writer_files_match_jax_writer(tmp_path, async_writes):
    """dump_data, dump_block, dump_qa and dump_qa_block through both
    writers on the same arrays (tensors to the port, numpy to the JAX
    writer): the same file names and the same rasters."""
    from kafka_tpu.engine.state import make_pixel_gather as jax_gather
    from kafka_tpu.io import GeoTIFFOutput as JaxOutput
    from kafka_tpu.io import read_geotiff as jax_read

    g = _gather()
    jg = jax_gather(g.mask, pad_multiple=128)
    params = ("lai", "sm")
    k = 3
    xs = RNG.uniform(0.1, 1.0, (k, g.n_pad, 2)).astype(np.float32)
    diags = RNG.uniform(1.0, 30.0, (k, g.n_pad, 2)).astype(np.float32)
    verd = RNG.integers(0, 32, (k, g.n_pad)).astype(np.int32)
    ts = [datetime.datetime(2017, 7, 1 + i) for i in range(k + 1)]
    kw = dict(epsg=GEO.epsg, prefix="0xa")
    t_out = GeoTIFFOutput(params, GEO.geotransform, GEO.projection,
                          str(tmp_path / "t"), async_writes=async_writes,
                          **kw)
    j_out = JaxOutput(params, GEO.geotransform, GEO.projection,
                      str(tmp_path / "j"), **kw)
    t_out.dump_data(ts[0], torch.as_tensor(xs[0]), torch.as_tensor(diags[0]),
                    g, params)
    t_out.dump_qa(ts[0], torch.as_tensor(verd[0]), g)
    t_out.dump_block(ts[1:], torch.as_tensor(xs), torch.as_tensor(diags), g,
                     params)
    t_out.dump_qa_block(ts[1:], torch.as_tensor(verd), g)
    t_out.close()
    j_out.dump_data(ts[0], xs[0], diags[0], jg, params)
    j_out.dump_qa(ts[0], verd[0], jg)
    j_out.dump_block(ts[1:], xs, diags, jg, params)
    j_out.dump_qa_block(ts[1:], verd, jg)
    j_out.close()
    names = _outputs(tmp_path / "j")
    assert names == _outputs(tmp_path / "t")
    assert len(names) == (k + 1) * (2 * len(params) + 1)
    for name in names:
        a, info_t = read_geotiff(str(tmp_path / "t" / name))
        b, _ = jax_read(str(tmp_path / "j" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype
        assert info_t.geo.epsg == GEO.epsg


def test_async_writer_holds_a_snapshot(tmp_path):
    """The engine may write into a dumped tensor once the dump returns:
    the file keeps the values it had at the dump."""
    g = _gather()
    x = torch.rand(g.n_pad, 2)
    diag = torch.rand(g.n_pad, 2) + 1.0
    verd = torch.ones(g.n_pad, dtype=torch.int32)
    x0, diag0 = x.clone(), diag.clone()
    out = GeoTIFFOutput(("a", "b"), GEO.geotransform, folder=str(tmp_path),
                        async_writes=True)
    ts = datetime.datetime(2018, 1, 5)
    out.dump_data(ts, x, diag, g, ("a", "b"))
    out.dump_qa(ts, verd, g)
    x.fill_(-7.0)
    diag.fill_(1e6)
    verd.fill_(0)
    out.close()
    a, _ = read_geotiff(str(tmp_path / "a_A2018005.tif"))
    np.testing.assert_array_equal(a, g.scatter(x0[:, 0].numpy()))
    unc, _ = read_geotiff(str(tmp_path / "b_A2018005_unc.tif"))
    np.testing.assert_array_equal(
        unc, g.scatter((1.0 / np.sqrt(diag0[:, 1].numpy()))
                       .astype(np.float32)))
    qa, _ = read_geotiff(str(tmp_path / "solver_qa_A2018005.tif"))
    np.testing.assert_array_equal(qa, g.scatter(np.ones(g.n_pad, np.uint8)))
    assert out.peak_backlog >= 1


def test_async_writer_error_surfaces(tmp_path, monkeypatch):
    """A failed background write raises at the next flush, not never."""
    import kafka_tpu_torch.io.output as output

    g = _gather()
    out = GeoTIFFOutput(("a",), GEO.geotransform, folder=str(tmp_path),
                        async_writes=True)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(output, "write_geotiff", boom)
    out.dump_data(datetime.datetime(2018, 1, 5), torch.zeros(g.n_pad, 1),
                  None, g, ("a",))
    with pytest.raises(RuntimeError, match="asynchronous GeoTIFF write"):
        out.flush()
    out.close()


def test_float16_wire_matches_jax(tmp_path):
    """The opt-in float16 wire: the port's files equal the JAX writer's
    (the same downcast, sigma clamped at the float16 maximum)."""
    import jax.numpy as jnp

    from kafka_tpu.engine.state import make_pixel_gather as jax_gather
    from kafka_tpu.io import GeoTIFFOutput as JaxOutput
    from kafka_tpu.io import read_geotiff as jax_read

    mask = np.ones((8, 16), bool)
    g, jg = make_pixel_gather(mask, 128), jax_gather(mask, 128)
    x = RNG.uniform(0.05, 2.0, (g.n_pad, 2)).astype(np.float32)
    p_inv_diag = np.full((g.n_pad, 2), 16.0, np.float32)
    p_inv_diag[3, :] = 0.0
    ts = datetime.datetime(2019, 6, 1)
    for folder, out, xx, dd, gg in (
            ("t", GeoTIFFOutput, torch.as_tensor(x),
             torch.as_tensor(p_inv_diag), g),
            ("j", JaxOutput, jnp.asarray(x), jnp.asarray(p_inv_diag), jg)):
        w = out(["lai", "sm"], (0, 10, 0, 0, 0, -10),
                folder=str(tmp_path / folder), wire_dtype="float16")
        w.dump_data(ts, xx, dd, gg, ["lai", "sm"])
        w.close()
    for name in _outputs(tmp_path / "j"):
        a, _ = read_geotiff(str(tmp_path / "t" / name))
        b, _ = jax_read(str(tmp_path / "j" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    unc, _ = read_geotiff(str(tmp_path / "t" / "lai_A2019152_unc.tif"))
    assert np.isfinite(unc).all() and unc.max() == np.float32(65504.0)


def test_native_codec_decodes_like_zlib(tmp_path, monkeypatch):
    """The C++ codec (built at first use into build/) and the serial zlib
    path give the same array for the same file, both ways round."""
    import kafka_tpu_torch.io.native_codec as nc
    from kafka_tpu_torch.native import library_path, load_library

    lib = load_library(strict=True)
    assert "build" in library_path().parts
    assert nc.codec_path() == "native"
    arr = _array(np.float32, (300, 520))
    write_geotiff(str(tmp_path / "n.tif"), arr, GEO, predictor=3, level=1)
    monkeypatch.setattr(nc, "_native", False)
    assert nc.codec_path() == "zlib"
    got_zlib, _ = read_geotiff(str(tmp_path / "n.tif"))
    write_geotiff(str(tmp_path / "z.tif"), arr, GEO, predictor=3, level=1)
    monkeypatch.setattr(nc, "_native", lib)
    got_native, _ = read_geotiff(str(tmp_path / "z.tif"))
    np.testing.assert_array_equal(got_zlib, arr)
    np.testing.assert_array_equal(got_native, arr)
