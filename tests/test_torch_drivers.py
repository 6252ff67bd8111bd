"""The port's real-sensor drivers against the JAX drivers, both run
in-process on the CPU over the same fixture trees and the same saved
``RunConfig`` (mirroring tests/test_drivers.py): ``run_s2`` over two
chunks and ``run_modis`` over one tile give equal stats (but
``wall_s``), equal file sets and restart markers, state rasters within
atol 2e-3, sigma rasters within rtol 1e-2 / atol 2e-3 and equal QA
rasters (the budgets of tests/test_torch_cli.py).  Then the harness:
markers read across packages both ways, a mid-chunk resume from a
checkpoint, the OOM quarter split, ``RunConfig`` JSON both ways,
``resolved_solver_options`` reading no file, ``mosaic`` and
``import_emulators`` equal to the JAX tools, and the refusals.

The S2 comparison runs unfused (``scan_window`` 1) in both packages:
the JAX driver's fused block compiles a second PROSAIL program (40 s
more on the CPU), and the port's fused run is held to its unfused run
bit for bit here instead."""

import datetime
import glob
import json
import os
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from kafka_tpu_torch.cli import drivers
from kafka_tpu_torch.cli import run_modis as tmodis
from kafka_tpu_torch.cli import run_s2 as ts2
from kafka_tpu_torch.engine.config import RunConfig
from kafka_tpu_torch.io.geotiff import GeoInfo, read_geotiff, write_geotiff
from kafka_tpu_torch.testing.fixtures import (make_mcd43_series,
                                              make_pivot_mask,
                                              make_s2_granule_tree)

GEO = GeoInfo(geotransform=(576000.0, 10.0, 0.0, 4325000.0, 0.0, -10.0),
              projection="WGS 84 / UTM zone 30N", epsg=32630)
STATE_ATOL = 2e-3
SIGMA_RTOL, SIGMA_ATOL = 1e-2, 2e-3


def day(y, m, d):
    return datetime.datetime(y, m, d)


def write_mask(path, ny, nx, seed=3):
    mask = make_pivot_mask(ny, nx, n_pivots=3, seed=seed)
    write_geotiff(path, mask.astype(np.uint8), GEO)
    return mask


def listing(folder):
    return sorted(os.listdir(folder))


def same_outputs(port_dir, jax_dir):
    """Equal file sets; rasters within the budgets; QA equal.  Returns
    the number of rasters compared."""
    names = listing(port_dir)
    assert names == listing(jax_dir)
    n = 0
    for name in names:
        if not name.endswith(".tif"):
            continue
        a, ia = read_geotiff(os.path.join(port_dir, name))
        b, ib = read_geotiff(os.path.join(jax_dir, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert ia.geo == ib.geo, name
        if name.startswith("solver_qa_"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=SIGMA_RTOL,
                                       atol=SIGMA_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=STATE_ATOL, err_msg=name)
        n += 1
    return n


def same_bits(dir_a, dir_b):
    names = [n for n in listing(dir_a) if n.endswith(".tif")]
    assert names and names == [n for n in listing(dir_b)
                               if n.endswith(".tif")]
    for name in names:
        a, _ = read_geotiff(os.path.join(dir_a, name))
        b, _ = read_geotiff(os.path.join(dir_b, name))
        assert a.tobytes() == b.tobytes(), name


def but_wall(stats):
    return {k: v for k, v in stats.items() if k != "wall_s"}


def markers(folder):
    return sorted(n for n in listing(folder) if n.startswith(".chunk_"))


# --- run_s2 ----------------------------------------------------------------

S2_DATES = [day(2017, 7, 4), day(2017, 7, 6), day(2017, 7, 8)]


@pytest.fixture(scope="module")
def s2(tmp_path_factory):
    """A 48 x 80 S2 tree of three dates under a three-pivot mask, two
    chunks of 40 x 48, run by both packages' ``run_s2.main``."""
    from kafka_tpu.cli.run_s2 import main as jax_main

    root = tmp_path_factory.mktemp("s2")
    mask = write_mask(str(root / "pivots.tif"), 48, 80)
    truth = make_s2_granule_tree(str(root / "s2"), S2_DATES, ny=48, nx=80,
                                 geo=GEO, noise=0.002)
    cfg = ts2.default_config()
    cfg.chunk_size = (40, 48)
    cfg.pad_multiple = 256
    cfg.scan_window = 1
    cfg.save(str(root / "cfg.json"))

    def args(out, cfg_name="cfg.json"):
        return ["--config", str(root / cfg_name), "--data-folder",
                str(root / "s2"), "--state-mask", str(root / "pivots.tif"),
                "--outdir", str(root / out)]

    return {"root": root, "mask": mask, "truth": truth, "args": args,
            "torch": ts2.main(args("torch") + ["--device", "cpu"]),
            "jax": jax_main(args("jax"))}


def test_s2_driver_matches_jax(s2):
    root = s2["root"]
    assert but_wall(s2["torch"]) == but_wall(s2["jax"])
    st = s2["torch"]
    assert (st["assigned"], st["run"], st["chunks_with_pixels"],
            st["dates_assimilated"]) == (2, 2, 2, 6)
    assert markers(root / "torch") == [".chunk_0001.done",
                                       ".chunk_0002.done"]
    # 2 chunks x (4 windows x (10 states + 10 sigmas) + 3 observed
    # windows' QA)
    assert same_outputs(root / "torch", root / "jax") == 2 * (4 * 20 + 3)
    # The analysis moved from the SAIL prior toward the truth.
    vals = np.concatenate([
        a[a > 0] for a in (read_geotiff(f)[0] for f in glob.glob(
            str(root / "torch" / "lai_A2017190_*[0-9].tif")))])
    tlai = float(s2["truth"][6])
    assert abs(np.median(vals) - tlai) < abs(np.exp(-2.0) - tlai)


def test_s2_fused_run_equals_unfused(s2):
    """The port's default (fused blocks of up to 8 windows) gives the
    unfused run's bits."""
    root = s2["root"]
    cfg = RunConfig.load(str(root / "cfg.json"))
    cfg.scan_window = 8
    cfg.save(str(root / "fused.json"))
    stats = ts2.main(s2["args"]("fused", "fused.json") + ["--device", "cpu"])
    assert but_wall(stats) == but_wall(s2["torch"])
    same_bits(root / "fused", root / "torch")


def test_restart_markers_read_across_packages(s2, tmp_path):
    """Either package's restart sees the other's chunks as done: a second
    main over the other's output folder runs nothing and writes
    nothing; the JAX scheduler finds no pending chunk in the port's
    folder and the marker payloads carry the same keys."""
    from kafka_tpu.cli.run_s2 import main as jax_main
    from kafka_tpu.io.tiling import get_chunks
    from kafka_tpu.shard import scheduler as jsched

    from kafka_tpu_torch.shard import scheduler as tsched

    root = s2["root"]
    for pkg, src in (("torch", "jax"), ("jax", "torch")):
        out = tmp_path / f"{pkg}_over_{src}"
        shutil.copytree(root / src, out)
        before = listing(out)
        argv = s2["args"](out.name)
        argv[argv.index("--outdir") + 1] = str(out)
        stats = ts2.main(argv + ["--device", "cpu"]) if pkg == "torch" \
            else jax_main(argv)
        assert (stats["run"], stats["skipped"]) == (0, 2), pkg
        assert listing(out) == before
    chunks = list(get_chunks(80, 48, (40, 48)))
    assert jsched.pending_chunks(jsched.assign_chunks(chunks, 1),
                                 str(root / "torch"), 0) == []
    assert tsched.pending_chunks(tsched.assign_chunks(chunks),
                                 str(root / "jax")) == []
    for name in markers(root / "torch"):
        a = json.loads((root / "torch" / name).read_text())
        b = json.loads((root / "jax" / name).read_text())
        assert set(a) == set(b) == {"finished", "chunk", "wall_s"}
        assert a["chunk"] == b["chunk"]


def test_mosaic_equals_jax(s2, tmp_path):
    """The port's mosaic of the JAX run's chunk rasters equals the JAX
    mosaic of the same files, bit for bit, and reassembles the chunks."""
    from kafka_tpu.cli.mosaic import main as jax_mosaic

    from kafka_tpu_torch.cli.mosaic import main as port_mosaic

    root = s2["root"]
    common = [str(root / "jax"), "--include-unc", "--like",
              str(root / "pivots.tif")]
    tw = port_mosaic(common + ["--outdir", str(tmp_path / "t")])
    jw = jax_mosaic(common + ["--outdir", str(tmp_path / "j")])
    assert tw == jw and len(tw) == 4 * 20 + 3
    same_bits(tmp_path / "t", tmp_path / "j")
    mos, _ = read_geotiff(str(tmp_path / "t" / "lai_A2017190.tif"))
    for prefix, x0 in (("0001", 0), ("0002", 40)):
        part, _ = read_geotiff(str(root / "jax" /
                                   f"lai_A2017190_{prefix}.tif"))
        assert mos[:, x0:x0 + 40].tobytes() == part.tobytes()


def test_mid_chunk_resume(tmp_path):
    """checkpoint_folder: an interrupted chunk resumes from its latest
    complete checkpoint instead of re-assimilating every date, and ends
    on the uninterrupted run's bits."""
    from kafka_tpu_torch.cli.drivers import prosail_aux_builder, run_config

    data = str(tmp_path / "s2")
    mask_path = str(tmp_path / "pivots.tif")
    write_mask(mask_path, 32, 32)
    make_s2_granule_tree(data, S2_DATES, ny=32, nx=32, geo=GEO, noise=0.002)

    def build(end, out, ck):
        cfg = ts2.default_config()
        cfg.chunk_size = (32, 32)
        cfg.pad_multiple = 64
        cfg.data_folder = data
        cfg.state_mask = mask_path
        cfg.output_folder = str(tmp_path / out)
        cfg.checkpoint_folder = str(tmp_path / ck) if ck else None
        cfg.end = end
        return cfg

    def run(cfg):
        return run_config(cfg, aux_builder=prosail_aux_builder,
                          device="cpu")

    stats1 = run(build(day(2017, 7, 7), "out", "ck"))
    assert stats1["dates_assimilated"] == 2
    cks = os.listdir(str(tmp_path / "ck"))
    assert cks and all(c.startswith("0001_state_") for c in cks)
    for m in glob.glob(str(tmp_path / "out" / ".chunk_*.done")):
        os.remove(m)
    stats2 = run(build(day(2017, 7, 9), "out", "ck"))
    assert stats2["dates_assimilated"] == 1
    run(build(day(2017, 7, 9), "whole", None))
    for name in ("lai_A2017190_0001.tif", "lai_A2017190_0001_unc.tif"):
        a, _ = read_geotiff(str(tmp_path / "out" / name))
        b, _ = read_geotiff(str(tmp_path / "whole" / name))
        assert a.tobytes() == b.tobytes(), name


# --- run_modis -------------------------------------------------------------

MODIS_DATES = [day(2017, 1, 1) + datetime.timedelta(days=i)
               for i in range(0, 64, 16)]


@pytest.fixture(scope="module")
def modis(tmp_path_factory):
    # The JAX package caches its TIP prior on first use; when that first
    # use is inside the trace of a fused block (information_filter_lai
    # under the scan), it caches tracers and the next call fails with
    # UnexpectedTracerError.  Building it eagerly first sidesteps that
    # (a fault of the JAX reference, listed in ROADMAP; the port has no
    # trace).
    from kafka_tpu.core.propagators import _tip_prior_cached

    _tip_prior_cached()
    root = tmp_path_factory.mktemp("modis")
    os.makedirs(root / "mcd43")
    mask = write_mask(str(root / "mask.tif"), 40, 40)
    truth = make_mcd43_series(str(root / "mcd43"), MODIS_DATES, ny=40,
                              nx=40, geo=GEO, noise=0.001)
    cfg = tmodis.default_config()
    # The files already sit on the 16-day grid: one per window.
    cfg.end = day(2017, 3, 6)
    cfg.extra["period"] = 1
    cfg.pad_multiple = 512
    cfg.save(str(root / "cfg.json"))
    return {"root": root, "mask": mask, "truth": truth,
            "args": lambda out: [
                "--config", str(root / "cfg.json"), "--data-folder",
                str(root / "mcd43"), "--state-mask", str(root / "mask.tif"),
                "--outdir", str(root / out)]}


def test_modis_driver_matches_jax(modis):
    from kafka_tpu.cli.run_modis import main as jax_main

    root = modis["root"]
    st = tmodis.main(modis["args"]("torch") + ["--device", "cpu"])
    sj = jax_main(modis["args"]("jax"))
    assert but_wall(st) == but_wall(sj)
    # the whole tile is one chunk
    assert (st["run"], st["chunks_with_pixels"], st["dates_assimilated"]) \
        == (1, 1, 4)
    # 4 windows x (7 states + 7 sigmas + QA)
    assert same_outputs(root / "torch", root / "jax") == 4 * 15
    telai = sorted(f for f in glob.glob(str(root / "torch" / "TeLAI_*.tif"))
                   if "_unc" not in f)
    vals = read_geotiff(telai[-1])[0][modis["mask"]]
    vals = vals[vals > 0]
    truth = float(modis["truth"][6])
    assert abs(np.median(vals) - truth) < abs(np.exp(-1.0) - truth)


def test_oom_splits_the_chunk_into_the_jax_quarters(modis, monkeypatch,
                                                    tmp_path):
    """A CUDA OOM on the whole tile splits it into quarters in-process:
    the JAX quarter prefixes and files (its subprocess worker replaced by
    an in-process JAX run of the same quarter), the whole chunk's stale
    rasters removed, a neighbouring chunk's files kept, the quarters
    within the budgets of the JAX quarters."""
    from kafka_tpu.cli import drivers as jd
    from kafka_tpu.cli.chunk_worker import OOM_EXIT_CODE
    from kafka_tpu.engine.config import RunConfig as JaxConfig
    from kafka_tpu.io.tiling import Chunk as JaxChunk

    from kafka_tpu_torch.io.tiling import Chunk

    root = modis["root"]
    mask = modis["mask"]

    def cfg_for(cls, out):
        cfg = cls.load(str(root / "cfg.json"))
        cfg.data_folder = str(root / "mcd43")
        cfg.output_folder = str(tmp_path / out)
        os.makedirs(cfg.output_folder, exist_ok=True)
        for name in ("TeLAI_A2017001_0001.tif", "TeLAI_A2017001_0001a.tif"):
            open(os.path.join(cfg.output_folder, name), "w").close()
        return cfg

    tried = []
    real = drivers.run_one_chunk

    def oom_over_20(cfg, chunk, prefix, *a, **k):
        tried.append((prefix, chunk.nx_valid, chunk.ny_valid))
        if chunk.nx_valid > 20:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(cfg, chunk, prefix, *a, **k)

    monkeypatch.setattr(drivers, "run_one_chunk", oom_over_20)
    tcfg = cfg_for(RunConfig, "torch")
    s = drivers.run_one_chunk_resilient(
        tcfg, Chunk(0, 0, 40, 40, 1), "0001", mask, GEO, device="cpu")
    assert tried == [("0001", 40, 40)] + [
        (f"0001-{t}", 20, 20) for t in "abcd"]
    assert s["oom_split"] and s["n_pixels"] == int(mask.sum())
    assert s["n_dates_assimilated"] == 4

    jcfg = cfg_for(JaxConfig, "jax")
    jop = jcfg.make_operator()
    jreal = jd.run_one_chunk

    def in_process_worker(cfg, chunk, prefix):
        if chunk.nx_valid > 20:
            return OOM_EXIT_CODE, None
        return 0, jreal(cfg, chunk, prefix, mask, GEO, operator=jop)

    def oom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(jd, "run_one_chunk", oom)
    monkeypatch.setattr(jd, "_DEVICE_POISONED", False)
    monkeypatch.setattr(jd, "_run_chunk_subprocess", in_process_worker)
    sj = jd.run_one_chunk_resilient(jcfg, JaxChunk(0, 0, 40, 40, 1), "0001",
                                    mask, GEO)
    monkeypatch.undo()
    assert {k: v for k, v in s.items() if k != "wall_s"} == \
        {k: v for k, v in sj.items() if k != "wall_s"}
    names = listing(tmp_path / "torch")
    assert "TeLAI_A2017001_0001.tif" not in names
    assert "TeLAI_A2017001_0001a.tif" in names
    quarters = [f"0001-{t}" for t, q in zip(
        "abcd", drivers.split_chunk(Chunk(0, 0, 40, 40, 1)))
        if mask[q.y0:q.y0 + q.ny_valid, q.x0:q.x0 + q.nx_valid].any()]
    assert len(quarters) >= 3
    assert {n.split("_")[-1].split(".")[0] for n in names
            if n.endswith(".tif") and "_unc" not in n} == \
        {*quarters, "0001a"}
    os.remove(tmp_path / "torch" / "TeLAI_A2017001_0001a.tif")
    os.remove(tmp_path / "jax" / "TeLAI_A2017001_0001a.tif")
    assert same_outputs(tmp_path / "torch", tmp_path / "jax") == \
        len(quarters) * 4 * 15


def test_oom_split_limit_and_other_errors(monkeypatch):
    from kafka_tpu_torch.io.tiling import Chunk

    calls = []

    def always_oom(cfg, chunk, prefix, *a, **k):
        calls.append(prefix)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(drivers, "run_one_chunk", always_oom)
    with pytest.raises(RuntimeError, match="split limit"):
        drivers.run_one_chunk_resilient(None, Chunk(0, 0, 8, 8, 1), "0001",
                                        None, None, max_splits=1)
    assert calls == ["0001", "0001-a"]

    def broken(*a, **k):
        raise ValueError("broken reader")

    monkeypatch.setattr(drivers, "run_one_chunk", broken)
    with pytest.raises(ValueError, match="broken reader"):
        drivers.run_one_chunk_resilient(None, Chunk(0, 0, 8, 8, 1), "0001",
                                        None, None)


def test_split_chunk_equals_jax():
    from kafka_tpu.cli.drivers import split_chunk as jsplit
    from kafka_tpu.io.tiling import Chunk as JChunk

    from kafka_tpu_torch.io.tiling import Chunk

    for c in ((0, 0, 40, 40, 1), (128, 256, 97, 33, 7), (0, 0, 1, 5, 2)):
        assert [tuple(q) for q in drivers.split_chunk(Chunk(*c))] == \
            [tuple(q) for q in jsplit(JChunk(*c))]


# --- config, tools and refusals --------------------------------------------

def _configs():
    from kafka_tpu_torch.cli import run_joint, run_s1

    custom = ts2.default_config()
    custom.extra = {"period": 3, "fault_tolerance": {"chunk_attempts": 2}}
    custom.solver_options = {"relaxation": 0.5, "use_pallas": False}
    custom.checkpoint_folder = "/ck"
    custom.chunk_size = (33, 17)
    return [ts2.default_config(), tmodis.default_config(),
            run_s1.default_config(), run_joint.default_config(), custom]


@pytest.mark.parametrize("i", range(5))
def test_runconfig_json_loads_in_both_packages(i):
    from kafka_tpu.engine.config import RunConfig as JaxConfig

    cfg = _configs()[i]
    jcfg = JaxConfig.from_json(cfg.to_json())
    assert json.loads(jcfg.to_json()) == json.loads(cfg.to_json())
    back = RunConfig.from_json(jcfg.to_json())
    assert json.loads(back.to_json()) == json.loads(cfg.to_json())
    assert [f.name for f in __import__("dataclasses").fields(RunConfig)] \
        == [f.name for f in __import__("dataclasses").fields(JaxConfig)]


def test_resolved_solver_options_read_no_file(monkeypatch):
    def no_io(*a, **k):
        raise AssertionError("resolved_solver_options touched the disk")

    import builtins
    import glob as glob_mod

    configs = _configs()
    for mod, name in ((builtins, "open"), (os, "listdir"), (os, "scandir"),
                      (os.path, "exists"), (glob_mod, "glob")):
        monkeypatch.setattr(mod, name, no_io)
    opts = [c.resolved_solver_options() for c in configs]
    monkeypatch.undo()
    assert opts == [{"relaxation": 0.7}, None, None, {"relaxation": 0.7},
                    {"relaxation": 0.5, "use_pallas": False}]


def _fake_gp(m, seed):
    """A minimal ``gp_emulator.GaussianProcess`` stand-in (4 inputs)."""
    rng = np.random.default_rng(seed)
    gp = _fake_module().GaussianProcess()
    gp.inputs = rng.uniform(0.0, 1.0, (m, 4))
    gp.targets = np.sin(gp.inputs.sum(axis=1))
    gp.theta = np.concatenate([np.log(rng.uniform(2.0, 20.0, 4)),
                               [np.log(1.3)], [np.log(1e-4)]])
    gp.invQt = rng.normal(size=m)
    return gp


def _fake_module():
    if not hasattr(_fake_module, "mod"):
        mod = types.ModuleType("gp_emulator")

        class GaussianProcess:
            pass

        GaussianProcess.__module__ = "gp_emulator"
        GaussianProcess.__qualname__ = "GaussianProcess"
        mod.GaussianProcess = GaussianProcess
        _fake_module.mod = mod
    return _fake_module.mod


def test_import_emulators_writes_the_jax_banks(tmp_path, capsys):
    from kafka_tpu.cli.import_emulators import main as jax_main

    from kafka_tpu_torch.cli.import_emulators import main as port_main
    from kafka_tpu_torch.io.sentinel2 import EMULATOR_BAND_MAP

    src = tmp_path / "pickles"
    src.mkdir()
    sys.modules["gp_emulator"] = _fake_module()
    try:
        for k, (vza, sza, raa) in enumerate(((0, 20, 50), (10, 40, 120))):
            bank = {b"S2A_MSI_%02d" % n: _fake_gp(20 + n, 10 * k + n)
                    for n in EMULATOR_BAND_MAP}
            with open(src / f"prosail_{vza}_{sza}_{raa}.pkl", "wb") as f:
                pickle.dump(bank, f, protocol=2)
    finally:
        del sys.modules["gp_emulator"]
    (src / "no_geometry.pkl").write_bytes(b"")
    assert port_main([str(src), str(tmp_path / "t")]) == 0
    assert jax_main([str(src), str(tmp_path / "j")]) == 0
    assert "converted 2 emulator bank(s)" in capsys.readouterr().out
    names = listing(tmp_path / "t")
    assert names == listing(tmp_path / "j") == [
        "prosail_0_20_50.npz", "prosail_10_40_120.npz"]
    for name in names:
        a, b = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    with pytest.raises(SystemExit):
        port_main([str(tmp_path / "t"), str(tmp_path / "x")])


def test_drivers_default_to_cuda(modis, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodis.main(modis["args"]("refused"))
    assert not os.path.exists(modis["root"] / "refused")


@pytest.fixture(scope="module")
def mod09(tmp_path_factory):
    """A 16 x 16 MOD09 tree (four dates, two days apart) under a full
    mask, with the MOD09 driver's config cut to 2017-06-07."""
    from kafka_tpu_torch.cli import run_mod09 as tmod09
    from kafka_tpu_torch.testing.fixtures import make_mod09_granules

    root = tmp_path_factory.mktemp("mod09")
    dates = [day(2017, 6, 1) + datetime.timedelta(days=2 * i)
             for i in range(4)]
    make_mod09_granules(str(root / "mod09"), dates, ny=8, nx=8,
                        noise=0.002, seed=5, geo=GEO)
    write_geotiff(str(root / "mask.tif"), np.ones((16, 16), np.uint8), GEO)
    cfg = tmod09.default_config()
    cfg.end = day(2017, 6, 7)
    cfg.chunk_size = (16, 16)
    cfg.pad_multiple = 64
    cfg.save(str(root / "cfg.json"))
    return {"root": root, "data": root / "mod09"}


@pytest.mark.parametrize("change,match", [
    (dict(device_mesh="local"), "slice 5"),
    (dict(operator="kernels"), "13b"),
    (dict(prior="kernels", initial_prior=None), "13b"),
    (dict(observations="mod09"), "13b"),
    (dict(band_sequential=True), "band_sequential"),
    (dict(hessian_correction=True), "hessian_correction"),
])
def test_unported_options_raise(modis, mod09, tmp_path, change, match):
    """Of these options only ``device_mesh="local"`` is still refused
    (ROADMAP slice 5).  The others run, each through both packages'
    ``run_config`` on the same tree and held to the JAX driver by the
    budgets of ``same_outputs``: the kernel-weight ones (``match``
    "13b") over the MOD09 tree with the MOD09 driver's config, the
    engine modes over the MCD43 tile with the MODIS driver's."""
    from kafka_tpu.cli import drivers as jdrivers
    from kafka_tpu.engine.config import RunConfig as JRunConfig

    tree = mod09 if match == "13b" else modis
    root = tree["root"]
    cfg = RunConfig.load(str(root / "cfg.json"))
    cfg.data_folder = str(tree.get("data", root / "mcd43"))
    cfg.state_mask = str(root / "mask.tif")
    cfg.output_folder = str(tmp_path / "torch")
    for k, v in change.items():
        setattr(cfg, k, v)
    if match == "slice 5":
        with pytest.raises(NotImplementedError, match=match):
            drivers.run_config(cfg, device="cpu")
        return
    st = drivers.run_config(cfg, device="cpu")
    jcfg = JRunConfig.from_json(cfg.to_json())
    jcfg.output_folder = str(tmp_path / "jax")
    sj = jdrivers.run_config(jcfg)
    assert but_wall(st) == but_wall(sj) and st["run"] == 1
    assert same_outputs(tmp_path / "torch", tmp_path / "jax") > 0


def test_synergy_driver_matches_jax(modis, tmp_path):
    """``observations="synergy"`` (broadband VIS/NIR BHR from per-band
    kernel-weight series) through the two-stream operator and the JRC
    prior: the MODIS driver's config with the Synergy reader, run by
    both packages' ``run_config`` on one ``make_synergy_series`` tree."""
    from kafka_tpu.cli import drivers as jdrivers
    from kafka_tpu.engine.config import RunConfig as JRunConfig
    from kafka_tpu_torch.testing.fixtures import make_synergy_series

    root = modis["root"]
    make_synergy_series(str(tmp_path / "syn"), MODIS_DATES, ny=40, nx=40,
                        geo=GEO)
    cfg = RunConfig.load(str(root / "cfg.json"))
    cfg.observations = "synergy"
    cfg.data_folder = str(tmp_path / "syn")
    cfg.state_mask = str(root / "mask.tif")
    cfg.output_folder = str(tmp_path / "torch")
    st = drivers.run_config(cfg, device="cpu")
    jcfg = JRunConfig.from_json(cfg.to_json())
    jcfg.output_folder = str(tmp_path / "jax")
    sj = jdrivers.run_config(jcfg)
    assert but_wall(st) == but_wall(sj)
    assert (st["run"], st["dates_assimilated"]) == (1, 4)
    # 4 windows x (7 states + 7 sigmas + QA)
    assert same_outputs(tmp_path / "torch", tmp_path / "jax") == 4 * 15


@pytest.mark.parametrize("kw", [dict(num_processes=2), dict(queue=True)])
def test_multi_process_runs_raise(modis, tmp_path, kw):
    cfg = RunConfig.load(str(modis["root"] / "cfg.json"))
    cfg.state_mask = str(modis["root"] / "mask.tif")
    cfg.output_folder = str(tmp_path)
    with pytest.raises(NotImplementedError, match="slice 5"):
        drivers.run_config(cfg, device="cpu", **kw)


def test_s2_driver_runs_through_converted_emulators(tmp_path):
    """``run_s2 --emulators``: gp_emulator pickles fitted to the port's
    PROSAIL at the scene geometry, converted by ``import_emulators``,
    drive the S2 assimilation through the ``gp_bank`` operator (the
    geometry's bank picked per date, on the run's device)."""
    from kafka_tpu_torch.cli.import_emulators import main as import_main
    from kafka_tpu_torch.engine.priors import sail_prior_arrays
    from kafka_tpu_torch.io.sentinel2 import EMULATOR_BAND_MAP
    from kafka_tpu_torch.obsops.prosail import ProsailAux, ProsailOperator

    dates = [day(2017, 7, 4), day(2017, 7, 6)]
    make_s2_granule_tree(str(tmp_path / "s2"), dates, ny=24, nx=24, geo=GEO)
    write_mask(str(tmp_path / "mask.tif"), 24, 24, seed=1)
    op = ProsailOperator()
    rng = np.random.default_rng(0)
    lo, hi = op.state_bounds
    x_train = np.clip(sail_prior_arrays()[0] + rng.normal(0, 0.08, (150, 10)),
                      lo + 1e-3, hi - 1e-3).astype(np.float32)
    # the fixture's scene: sza 30.5, vza 5, raa = vaa - saa = -50
    aux = ProsailAux(*(torch.tensor(v) for v in (30.5, 5.0, -50.0)))
    y = op.forward(aux, torch.as_tensor(x_train)).numpy().astype(np.float64)
    ell = x_train.std(0).astype(np.float64) * 2.0 + 0.05
    theta = np.concatenate([np.log(1.0 / ell**2), [np.log(0.05)],
                            [np.log(1e-6)]])
    z = x_train.astype(np.float64) * np.sqrt(np.exp(theta[:10]))
    d2 = (z * z).sum(1)[:, None] + (z * z).sum(1)[None, :] - 2.0 * z @ z.T
    k = np.exp(theta[10]) * np.exp(-0.5 * np.maximum(d2, 0.0))
    k[np.diag_indices_from(k)] += np.exp(theta[11])
    bank = {}
    for b, num in enumerate(EMULATOR_BAND_MAP):
        gp = _fake_module().GaussianProcess()
        gp.inputs, gp.targets, gp.theta = x_train.astype(np.float64), y[b], \
            theta
        gp.invQt = np.linalg.solve(k, y[b])
        bank[b"S2A_MSI_%02d" % num] = gp
    (tmp_path / "pickles").mkdir()
    sys.modules["gp_emulator"] = _fake_module()
    try:
        with open(tmp_path / "pickles" / "prosail_5_30_310.pkl", "wb") as f:
            pickle.dump(bank, f, protocol=2)
    finally:
        del sys.modules["gp_emulator"]
    import_main([str(tmp_path / "pickles"), str(tmp_path / "banks")])
    cfg = ts2.default_config()
    cfg.start, cfg.end = day(2017, 7, 3), day(2017, 7, 7)
    cfg.chunk_size = (24, 24)
    cfg.pad_multiple = 64
    cfg.save(str(tmp_path / "cfg.json"))
    stats = ts2.main(["--config", str(tmp_path / "cfg.json"),
                      "--data-folder", str(tmp_path / "s2"),
                      "--state-mask", str(tmp_path / "mask.tif"),
                      "--outdir", str(tmp_path / "out"),
                      "--emulators", str(tmp_path / "banks"),
                      "--device", "cpu"])
    assert (stats["run"], stats["dates_assimilated"]) == (1, 2)
    lai, _ = read_geotiff(str(tmp_path / "out" / "lai_A2017188_0001.tif"))
    mask = make_pivot_mask(24, 24, n_pivots=3, seed=1)
    vals = lai[mask]
    assert np.isfinite(lai).all() and ((vals > 0) & (vals < 1)).all()
    assert np.abs(vals - sail_prior_arrays()[0][6]).max() > 1e-3
