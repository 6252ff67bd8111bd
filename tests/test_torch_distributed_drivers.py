"""The port's distributed drivers (mirroring tests/test_drivers.py's OOM
recovery, chunk-worker and mesh-mode tests): device-OOM routing to
``chunk_worker`` subprocesses, the subprocess worker end to end and its
hang guard, ``make_run_mesh``, a chunked S2 run on a local mesh against
no mesh (atol 3e-4, the JAX test's), ``run_modis_distributed`` over two
``gloo`` ranks bit-identical to one process, and ``run_synthetic``'s
chunked and queue modes against the JAX driver at the budgets of
tests/test_torch_drivers.py (state atol 2e-3, sigma rtol 1e-2 / atol
2e-3, QA equal) and against each other bit for bit.  Every child process
carries its own timeout."""

import datetime
import glob
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kafka_tpu_torch.cli import drivers
from kafka_tpu_torch.cli import run_modis_distributed as tdist
from kafka_tpu_torch.cli.chunk_worker import OOM_EXIT_CODE
from kafka_tpu_torch.engine.config import RunConfig
from kafka_tpu_torch.io.geotiff import GeoInfo, read_geotiff, write_geotiff
from kafka_tpu_torch.io.tiling import Chunk
from kafka_tpu_torch.testing.fixtures import (make_mcd43_series,
                                              make_pivot_mask,
                                              make_s2_granule_tree)

REPO = pathlib.Path(__file__).resolve().parents[1]
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


def tifs(folder):
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(str(folder), "*.tif")))


def same_bits(dir_a, dir_b):
    names = tifs(dir_a)
    assert names and names == tifs(dir_b)
    for name in names:
        a, _ = read_geotiff(os.path.join(str(dir_a), name))
        b, _ = read_geotiff(os.path.join(str(dir_b), name))
        assert a.tobytes() == b.tobytes(), name


@pytest.fixture(autouse=True)
def _fresh_poison_flag(monkeypatch):
    monkeypatch.setattr(drivers, "_DEVICE_POISONED", False)


@pytest.fixture(scope="module")
def modis(tmp_path_factory):
    """A 40 x 40 MCD43 tree of 4 dates under a three-pivot mask and the
    distributed driver's config cut to those dates, in 20 x 20 chunks
    (4 chunks)."""
    root = tmp_path_factory.mktemp("modis_dist")
    os.makedirs(root / "mcd43")
    mask = write_mask(str(root / "mask.tif"), 40, 40)
    dates = [day(2017, 1, 1) + datetime.timedelta(days=i)
             for i in range(0, 64, 16)]
    make_mcd43_series(str(root / "mcd43"), dates, ny=40, nx=40, geo=GEO,
                      noise=0.001)
    cfg = tdist.default_config()
    cfg.end = day(2017, 3, 6)
    cfg.extra["period"] = 1
    cfg.chunk_size = (20, 20)
    cfg.pad_multiple = 128
    cfg.data_folder = str(root / "mcd43")
    cfg.state_mask = str(root / "mask.tif")
    cfg.save(str(root / "cfg.json"))
    return {"root": root, "mask": mask, "cfg": cfg}


def _cfg(modis, out):
    cfg = RunConfig.load(str(modis["root"] / "cfg.json"))
    cfg.output_folder = str(out)
    return cfg


# --- OOM routing ------------------------------------------------------------

def test_oom_routes_to_subprocesses_and_splits(tmp_path, monkeypatch):
    sub_calls = []

    def oom(cfg, chunk, prefix, *a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    def fake_subprocess(cfg, chunk, prefix, device=None):
        sub_calls.append((prefix, chunk.nx_valid, chunk.ny_valid, device))
        if chunk.nx_valid > 64 or chunk.ny_valid > 64:
            return OOM_EXIT_CODE, None
        return 0, {"prefix": prefix,
                   "n_pixels": chunk.nx_valid * chunk.ny_valid,
                   "n_dates_assimilated": 3, "wall_s": 0.5}

    monkeypatch.setattr(drivers, "run_one_chunk", oom)
    monkeypatch.setattr(drivers, "_run_chunk_subprocess", fake_subprocess)
    outdir = str(tmp_path)
    stale = os.path.join(outdir, "lai_A2017183_0001.tif")
    keep = os.path.join(outdir, "lai_A2017183_0001a.tif")
    open(stale, "w").close()
    open(keep, "w").close()

    class Cfg:
        output_folder = outdir

    s = drivers.run_one_chunk_resilient(Cfg(), Chunk(0, 0, 128, 100, 1),
                                        "0001", None, None, device="cpu")
    assert not os.path.exists(stale) and os.path.exists(keep)
    assert sub_calls[0] == ("0001", 128, 100, "cpu")
    assert sorted(c[0] for c in sub_calls[1:]) == [
        "0001-a", "0001-b", "0001-c", "0001-d"]
    assert all(c[1] <= 64 and c[2] <= 64 for c in sub_calls[1:])
    assert s["oom_split"] and s["n_pixels"] == 128 * 100
    assert s["n_dates_assimilated"] == 3
    assert drivers._DEVICE_POISONED


def test_poisoned_process_skips_in_process_path(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("in-process path used after poisoning")

    monkeypatch.setattr(drivers, "run_one_chunk", boom)
    monkeypatch.setattr(
        drivers, "_run_chunk_subprocess",
        lambda cfg, chunk, prefix, device=None: (
            0, {"prefix": prefix, "n_pixels": 1}))
    monkeypatch.setattr(drivers, "_DEVICE_POISONED", True)
    s = drivers.run_one_chunk_resilient(None, Chunk(0, 0, 32, 32, 1),
                                        "0002", None, None)
    assert s == {"prefix": "0002", "n_pixels": 1}


def test_non_oom_errors_propagate(monkeypatch):
    def broken(*a, **k):
        raise ValueError("broken reader")

    monkeypatch.setattr(drivers, "run_one_chunk", broken)
    with pytest.raises(ValueError, match="broken reader"):
        drivers.run_one_chunk_resilient(None, Chunk(0, 0, 32, 32, 1),
                                        "0001", None, None)
    assert not drivers._DEVICE_POISONED


def test_worker_failures_surface(monkeypatch):
    """A worker's non-OOM failure raises with its rc; a killed worker
    (hang guard, rc 124) raises TimeoutError, which the retry policy
    counts as transient."""
    from kafka_tpu_torch.resilience import TRANSIENT, classify_failure

    monkeypatch.setattr(drivers, "_DEVICE_POISONED", True)
    for rc, exc in ((3, RuntimeError), (124, TimeoutError)):
        monkeypatch.setattr(drivers, "_run_chunk_subprocess",
                            lambda *a, rc=rc, **k: (rc, None))
        with pytest.raises(exc) as err:
            drivers.run_one_chunk_resilient(None, Chunk(0, 0, 8, 8, 1),
                                            "0001", None, None)
    assert classify_failure(err.value) == TRANSIENT


# --- the subprocess worker --------------------------------------------------

def test_chunk_worker_subprocess_end_to_end(modis, tmp_path):
    """The real worker entry point: serialise a config, run one chunk in a
    child interpreter on the CPU, read the summary back; its rasters equal
    the same chunk run in this process bit for bit, and its telemetry
    lands in the chunk's own subdirectory."""
    cfg = _cfg(modis, tmp_path / "sub")
    cfg.telemetry_dir = str(tmp_path / "tel")
    chunk = Chunk(0, 0, 20, 20, 1)
    rc, summary = drivers._run_chunk_subprocess(cfg, chunk, "0001",
                                                device="cpu")
    assert rc == 0, summary
    assert summary["prefix"] == "0001" and summary["n_pixels"] > 0
    assert summary["n_dates_assimilated"] == 4
    for artifact in ("events.jsonl", "metrics.json", "trace.json"):
        assert (tmp_path / "tel" / "chunk_0001" / artifact).exists()
    ref = _cfg(modis, tmp_path / "in_process")
    os.makedirs(ref.output_folder)
    mask = modis["mask"]
    s = drivers.run_one_chunk(ref, chunk, "0001", mask, GEO, device="cpu")
    assert s["n_pixels"] == summary["n_pixels"]
    same_bits(tmp_path / "sub", tmp_path / "in_process")


def test_hang_guard_kills_the_worker_with_rc_124(modis, tmp_path):
    cfg = _cfg(modis, tmp_path / "out")
    cfg.extra["chunk_worker_timeout"] = 0.2
    rc, summary = drivers._run_chunk_subprocess(cfg, Chunk(0, 0, 20, 20, 1),
                                                "0001", device="cpu")
    assert (rc, summary) == (124, None)


def test_worker_defaults_to_cuda(modis, tmp_path):
    """Without ``--device`` the worker runs on CUDA and, with no card,
    fails with a nonzero rc (no fallback to the CPU)."""
    cfg = _cfg(modis, tmp_path / "out")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    cfg_path = tmp_path / "cfg.json"
    cfg.save(str(cfg_path))
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_tpu_torch.cli.chunk_worker",
         str(cfg_path), "0", "0", "20", "20", "1", "0001"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode not in (0, OOM_EXIT_CODE)
    assert "device='cpu'" in proc.stderr


# --- mesh mode --------------------------------------------------------------

def test_make_run_mesh_modes(monkeypatch):
    from kafka_tpu_torch.shard import mesh as mesh_mod

    def cfg(mode):
        return RunConfig(parameter_list=("a",), start=day(2020, 1, 1),
                         end=day(2020, 1, 2), device_mesh=mode)

    assert drivers.make_run_mesh(cfg("none"), "cpu") is None
    # One local CPU: "auto" gives no mesh, "local" a mesh of one.
    assert drivers.make_run_mesh(cfg("auto"), "cpu") is None
    assert drivers.make_run_mesh(cfg("local"), "cpu").size == 1
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda kind: [torch.device("cpu")] * 8)
    assert drivers.make_run_mesh(cfg("auto"), "cpu").size == 8
    assert drivers.make_run_mesh(cfg("local"), "cpu").size == 8
    with pytest.raises(ValueError, match="device_mesh"):
        drivers.make_run_mesh(cfg("nonne"), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drivers.make_run_mesh(cfg("local"))


def test_chunked_s2_driver_on_local_mesh_matches_no_mesh(tmp_path,
                                                         monkeypatch):
    """``device_mesh='local'`` through the chunked S2 driver, with the
    local devices standing at eight CPU entries: chunk scheduling and the
    engine mesh compose, and the outputs equal the unsharded run's."""
    from kafka_tpu_torch.cli.run_s2 import default_config
    from kafka_tpu_torch.shard import mesh as mesh_mod

    ny, nx = 32, 48
    mask_path = str(tmp_path / "pivots.tif")
    write_mask(mask_path, ny, nx)
    make_s2_granule_tree(str(tmp_path / "s2"),
                         [day(2017, 7, 4), day(2017, 7, 6)], ny=ny, nx=nx,
                         geo=GEO, noise=0.002)
    monkeypatch.setattr(mesh_mod, "local_devices",
                        lambda kind: [torch.device("cpu")] * 8)

    def run(mode, out):
        cfg = default_config()
        cfg.data_folder = str(tmp_path / "s2")
        cfg.state_mask = mask_path
        cfg.output_folder = str(tmp_path / out)
        cfg.chunk_size = (32, 24)
        cfg.pad_multiple = 64
        cfg.end = day(2017, 7, 7)
        cfg.device_mesh = mode
        return drivers.run_config(cfg, drivers.prosail_aux_builder,
                                  device="cpu")

    stats_m = run("local", "out_mesh")
    stats_r = run("none", "out_ref")
    assert stats_m["run"] == stats_r["run"] >= 1
    names = tifs(tmp_path / "out_ref")
    assert names and names == tifs(tmp_path / "out_mesh")
    for name in names:
        a, _ = read_geotiff(str(tmp_path / "out_ref" / name))
        b, _ = read_geotiff(str(tmp_path / "out_mesh" / name))
        np.testing.assert_allclose(b, a, atol=3e-4, err_msg=name)


# --- run_modis_distributed over two gloo ranks ------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_modis_distributed_two_ranks_equal_one_process(modis, tmp_path):
    """Two ranks meet at a gloo rendezvous, split the 4 chunks 2 + 2 by
    round-robin, each reports the run-wide counts from its all_reduce,
    and the rasters equal a one-process run bit for bit."""
    root = modis["root"]
    args = ["--config", str(root / "cfg.json"), "--device", "cpu"]
    one = tdist.main(args + ["--outdir", str(tmp_path / "one")])
    assert one["run"] == 4

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    port = _free_port()
    logs = [open(tmp_path / f"rank_{i}.log", "w+") for i in range(2)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "kafka_tpu_torch.cli.run_modis_distributed", *args,
             "--outdir", str(tmp_path / "two"), "--num-processes", "2",
             "--process-index", str(i),
             "--coordinator", f"localhost:{port}"],
            env=env, stdout=logs[i], stderr=subprocess.STDOUT)
            for i in range(2)]
        try:
            for p in procs:
                p.wait(timeout=240)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
    finally:
        for f in logs:
            f.close()
    for i, p in enumerate(procs):
        assert p.returncode == 0, texts[i][-3000:]
    ranks = [json.loads(t.strip().splitlines()[-1]) for t in texts]
    assert [r["run"] for r in ranks] == [2, 2]
    for r in ranks:
        assert r["all_ranks"]["run"] == 4
        assert r["all_ranks"]["pixels"] == one["pixels"]
        assert r["all_ranks"]["dates_assimilated"] == \
            one["dates_assimilated"]
    same_bits(tmp_path / "one", tmp_path / "two")
    assert sorted(n for n in os.listdir(tmp_path / "two")
                  if n.endswith(".done")) == sorted(
        n for n in os.listdir(tmp_path / "one") if n.endswith(".done"))


# --- run_synthetic: chunked and queue modes ---------------------------------

SYN = ["--operator", "twostream", "--ny", "24", "--nx", "28", "--days",
       "12", "--obs-every", "4", "--chunk-size", "14"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from kafka_tpu.cli.run_synthetic import main as jax_main

    from kafka_tpu_torch.cli.run_synthetic import main as port_main

    root = tmp_path_factory.mktemp("syn")
    return {
        "root": root,
        "jax": jax_main(SYN + ["--outdir", str(root / "jax")]),
        "chunked": port_main(SYN + ["--outdir", str(root / "chunked"),
                                    "--device", "cpu"]),
        "queue": port_main(SYN + ["--outdir", str(root / "queue"),
                                  "--queue", "--lease-ttl-s", "5",
                                  "--device", "cpu"]),
    }


def test_synthetic_chunked_mode_matches_jax(synthetic):
    root, st, sj = synthetic["root"], synthetic["chunked"], synthetic["jax"]
    for key in ("mode", "chunks_assigned", "chunks_run", "skipped",
                "failed", "n_pixels", "outputs_written", "n_dates"):
        assert st[key] == sj[key], key
    assert st["chunks_run"] == 4 and st["failed"] == 0
    names = tifs(root / "jax")
    assert names == tifs(root / "chunked")
    for name in names:
        a, _ = read_geotiff(str(root / "chunked" / name))
        b, _ = read_geotiff(str(root / "jax" / name))
        if name.startswith("solver_qa"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=SIGMA_RTOL,
                                       atol=SIGMA_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=STATE_ATOL, err_msg=name)


def test_synthetic_queue_mode_equals_chunked_mode(synthetic):
    q = synthetic["queue"]
    assert (q["mode"], q["chunks_total"], q["chunks_run"], q["failed"],
            q["pending"], q["reclaimed"]) == ("queue", 4, 4, 0, 0, 0)
    assert q["n_pixels"] == synthetic["chunked"]["n_pixels"]
    same_bits(synthetic["root"] / "chunked", synthetic["root"] / "queue")


def test_synthetic_queue_requires_chunks(tmp_path, capsys):
    from kafka_tpu_torch.cli.run_synthetic import main as port_main

    with pytest.raises(SystemExit):
        port_main(["--queue", "--outdir", str(tmp_path), "--device", "cpu"])
    assert "--queue requires --chunk-size" in capsys.readouterr().err
