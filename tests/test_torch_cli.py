"""The port's ``run_synthetic`` driver against the JAX driver, both run
in-process on the CPU on the same arguments: the same summary fields
(``outputs_written``, ``n_pixels``, ``mean_iterations``, the grid
counts), the same files, the rasters within the JAX package's fusion
budgets (state rasters atol 2e-3, sigma rasters rtol 1e-2 / atol 2e-3)
and the QA bands equal; the port's fused run equal to its unfused run
to the bit; and the device-plane flags leaving the outputs' bits alone.
The chunked, queue and fleet modes are held to the JAX driver in
tests/test_torch_distributed_drivers.py.

The two-stream case runs the driver with one acquisition every 4 days
over 12 days (three dates, two of them in a fused block) so every solve
converges.  On the driver's default grid (two acquisitions per 4-day
window, sigma 0.002, relaxation 0.5) some dates stop at the iteration
cap on oscillating pixels, where a float32 rounding difference moves a
pixel by more than any budget; the JAX test of fusion itself
(tests/test_fusion.py) holds parity only on converged solves for that
reason."""

import json
import os

import numpy as np
import pytest
import torch

from kafka_tpu_torch.cli import run_synthetic as port
from kafka_tpu_torch.io import read_geotiff

SMALL = ["--ny", "24", "--nx", "28"]
CASES = {
    "identity": ["--operator", "identity"],
    "twostream": ["--operator", "twostream", "--days", "12",
                  "--obs-every", "4"],
}


def _run_port(outdir, args):
    return port.main(args + SMALL + ["--outdir", str(outdir),
                                     "--device", "cpu"])


def _run_jax(outdir, args):
    from kafka_tpu.cli.run_synthetic import main as jax_main

    return jax_main(args + SMALL + ["--outdir", str(outdir)])


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    name = request.param
    root = tmp_path_factory.mktemp(name)
    args = CASES[name]
    return {
        "name": name,
        "jax": (root / "jax", _run_jax(root / "jax", args)),
        "torch": (root / "torch", _run_port(root / "torch", args)),
        "unfused": (root / "unfused",
                    _run_port(root / "unfused", args + ["--scan-window",
                                                        "1"])),
    }


def _tifs(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".tif"))


def test_summary_matches_jax(runs):
    j, t = runs["jax"][1], runs["torch"][1]
    for key in ("outputs_written", "n_pixels", "mean_iterations",
                "operator", "n_dates", "n_timesteps"):
        assert t[key] == j[key], key
    assert set(t) == set(j)
    assert t["wall_s"] > 0 and t["pixel_steps_per_s"] > 0
    assert t["outdir"] == str(runs["torch"][0])


def test_rasters_match_jax(runs):
    jdir, tdir = runs["jax"][0], runs["torch"][0]
    names = _tifs(jdir)
    assert names == _tifs(tdir)
    for name in names:
        a, _ = read_geotiff(str(tdir / name))
        b, _ = read_geotiff(str(jdir / name))
        assert np.isfinite(a).all(), name
        if name.startswith("solver_qa"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=2e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=2e-3, err_msg=name)


def test_fused_run_equals_unfused_run(runs):
    tdir, udir = runs["torch"][0], runs["unfused"][0]
    names = _tifs(tdir)
    assert names == _tifs(udir)
    for name in names:
        a, _ = read_geotiff(str(tdir / name))
        b, _ = read_geotiff(str(udir / name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_summary_line_is_printed(tmp_path, capsys):
    summary = _run_port(tmp_path, CASES["identity"] + ["--days", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == summary
    assert summary["outputs_written"] == summary["n_timesteps"] * (2 * 2 + 1)


def test_checkpoint_flag_writes_resumable_state(tmp_path):
    from kafka_tpu_torch.engine.checkpoint import Checkpointer

    summary = _run_port(tmp_path, CASES["twostream"] + ["--checkpoint"])
    ck = Checkpointer(str(tmp_path / "ckpt"))
    saved = ck.list_checkpoints()
    assert len(saved) >= 2
    ts, x, p_inv = ck.load_latest()
    assert x.shape[1] == 7 and p_inv.shape[1:] == (7, 7)
    assert np.isfinite(x).all()
    assert summary["outputs_written"] == summary["n_timesteps"] * 15


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("flags,slice_name", [
    (["--http-port", "9100"], "slice 7"),
    (["--profile-windows", "2"], "slice 7"),
])
def test_unported_flags_exit_with_their_slice(tmp_path, flags, slice_name):
    """Named for the refusal these flags met before their slice (the
    device plane) was ported; now the live endpoint and the windowed
    profiler capture run beside the engine and change none of its
    outputs."""
    from kafka_tpu_torch.telemetry import MetricsRegistry, use

    flag = flags[0]
    value = str(_free_port()) if flag == "--http-port" else flags[1]
    base = _run_port(tmp_path / "base", CASES["identity"])
    tel = tmp_path / "tel"
    with use(MetricsRegistry()):
        got = _run_port(tmp_path / "flag", CASES["identity"] + [
            flag, value, "--telemetry-dir", str(tel)])
    assert got["outputs_written"] == base["outputs_written"]
    for name in sorted(os.listdir(tmp_path / "base")):
        if name.endswith(".tif"):
            a, _ = read_geotiff(str(tmp_path / "base" / name))
            b, _ = read_geotiff(str(tmp_path / "flag" / name))
            assert np.array_equal(a, b, equal_nan=True), name
    if flag == "--profile-windows":
        assert any(n.endswith(".trace.json.gz")
                   for _, _, fs in os.walk(tel / "profile") for n in fs)
    events = [json.loads(line)["event"]
              for line in open(tel / "events.jsonl")]
    assert ("httpd_started" if flag == "--http-port"
            else "devprof_capture_parsed") in events


def test_device_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.main(CASES["identity"] + SMALL + ["--outdir", str(tmp_path)])


def test_mask_file_is_read(tmp_path):
    """``--mask`` reads a GeoTIFF mask and its georeferencing."""
    from kafka_tpu_torch.io import GeoInfo, write_geotiff

    mask = np.zeros((12, 16), np.uint8)
    mask[2:9, 3:12] = 1
    geo = GeoInfo(geotransform=(100.0, 30.0, 0.0, 900.0, 0.0, -30.0),
                  projection="WGS 84 / UTM zone 31N", epsg=32631)
    write_geotiff(str(tmp_path / "mask.tif"), mask, geo)
    out = tmp_path / "out"
    summary = port.main(["--operator", "identity", "--days", "4",
                         "--mask", str(tmp_path / "mask.tif"),
                         "--outdir", str(out), "--device", "cpu"])
    assert summary["n_pixels"] == int(mask.sum())
    a, info = read_geotiff(str(out / _tifs(out)[0]))
    assert a.shape == mask.shape and info.geo.epsg == 32631
    assert tuple(info.geo.geotransform) == geo.geotransform
