"""Phase ``device_plane`` of chip_smoke.py rehearsed on the CPU at 48 x 48,
on the plain versions: each call of the fused Gauss-Newton kernel's plain
version is counted as a launch and marked in the profiler capture by a
top-level operator named like the CUDA kernel, so the phase's launch,
capture, gauge, probe, OOM-forensics and server gates run as they run on
the card (the capture's time per launch, which needs the card's kernel
timing, is not held here).  Without the counted launches the phase
fails on its first part."""

import os
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def marker_op():
    """``kafka_rehearsal::fused_gn_kernel``: a trivial operator whose
    name carries the CUDA kernel's, so one call shows up as one top-level
    operator on the CPU capture's device lane."""
    lib = torch.library.Library("kafka_rehearsal", "DEF")
    lib.define("fused_gn_kernel(Tensor x) -> Tensor")
    lib.impl("fused_gn_kernel", lambda x: x.clone(), "CPU")
    yield torch.ops.kafka_rehearsal.fused_gn_kernel
    del lib


@pytest.fixture
def counted_gn_marked(monkeypatch, marker_op):
    from kafka_tpu_torch.core import fused_gn as fg

    real = fg.fused_gn_raw_plain

    def counted(*args, **kwargs):
        fg.fused_gn_rows.launches += 1
        out = real(*args, **kwargs)
        marker_op(out[0])
        return out

    monkeypatch.setattr(fg, "fused_gn_raw_plain", counted)


def test_phase_device_plane_rehearsal(tmp_path, counted_gn_marked,
                                      monkeypatch):
    from kafka_tpu_torch.telemetry import health

    # This shared CPU is no healthy host for the host probe's band; the
    # verdict gate holds on the card only, and a retry would wait 15 s.
    monkeypatch.setattr(health, "HEALTHY_HOST_MS", 1e9)
    serve = cs.phase_serve(CPU, str(tmp_path / "serve"), ny=48, nx=48)
    os.makedirs(tmp_path / "dp")
    rec = cs.phase_device_plane(CPU, str(tmp_path / "dp"), kernel_ms=None,
                                serve_shas=serve["x_sha256"], ny=48, nx=48,
                                probe_n=1024)
    eng = rec["engine"]
    assert eng["plain"]["dispatches"] == eng["device_plane"]["dispatches"] \
        == eng["device_plane"]["device_reads"]
    assert eng["plain"]["engine_fused_gn_launches"] == \
        eng["device_plane"]["engine_fused_gn_launches"] == \
        cs.DEVICE_PLANE_DATES
    assert rec["rasters_differing"] == 0
    cap = rec["capture"]
    assert cap["fused_gn_launches_captured"] == 3
    assert cap["top_kernels"]
    assert rec["probe_launches"] == health.probe_solves(ks=(1, 2), reps=1)
    fresh = rec["probe_fresh_process"]
    assert fresh["rc"] == 0 and fresh["probe_host_ms"] > 0
    assert fresh["probe_device_ms"] is None  # no card: no device probe
    assert rec["oom"]["raised"] == "OutOfMemoryError" and rec["oom"]["dump"]
    assert rec["serve"]["sha_compared"]
    assert set(rec["serve"]["requests"].values()) == {"cold", "cache",
                                                      "warm"}
    assert rec["failures"] == []


def test_phase_device_plane_fails_without_kernel_launches(tmp_path):
    with pytest.raises(AssertionError, match="fused_gn launches"):
        cs.phase_device_plane(CPU, str(tmp_path), ny=48, nx=48,
                              probe_n=1024)
