"""Phase ``operator_tools`` of chip_smoke.py rehearsed on the CPU at
48 x 48, with the kernels' plain versions counted as launches: the port's
loadgen drives an in-process ``kafka_serve`` over tile0 of phase serve's
grid and every answer holds phase serve's digest; the self-contained
modes (``--synthetic``, ``--concurrency-sweep 1,4``, ``--fleet 2``) run
at (2, 2); and the six report tools run as ``python -m
kafka_tpu_torch.tools.<name>`` over directories named and filled as
phases queue, device_plane and route leave them (a queue run, a
``--profile-windows`` capture whose fused_gn calls a marker operator
named like the CUDA kernel stands for, a server with the fleet plane, a
two-replica fleet behind the router), their processes free of JAX.
The gates fail on a foreign digest, on missing launches and on a report
that failed or held a foreign module."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")


def _count_plain(mp, marker=None):
    """The plain versions counted as launches (``marker``, when given, is
    called on each fused_gn call's first output, inside the call)."""
    from kafka_tpu_torch.core import _build
    from kafka_tpu_torch.core import fused_gn as fg
    from kafka_tpu_torch.core import fused_update as fu

    real_gn, real_fu = fg.fused_gn_raw_plain, fu.fused_update_raw_plain

    def gn(*args, **kwargs):
        _build.count_launch(fg.fused_gn_rows)
        out = real_gn(*args, **kwargs)
        if marker is not None:
            marker(out[0])
        return out

    def upd(*args, **kwargs):
        rows = dict(zip(cs.UPDATE_ROW_NAMES, args), **kwargs)
        _build.count_launch(fu.fused_update_rows, (rows["xf_rows"].shape[0],
                                                   rows["h0"].shape[0]))
        return real_fu(*args, **kwargs)

    mp.setattr(fg, "fused_gn_raw_plain", gn)
    mp.setattr(fu, "fused_update_raw_plain", upd)


@pytest.fixture(scope="module")
def serve_shas(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _count_plain(mp)
        rec = cs.phase_serve(CPU, str(tmp_path_factory.mktemp("serve")),
                             ny=48, nx=48)
    return rec["x_sha256"]


@pytest.fixture(scope="module")
def marker_op():
    """``kafka_rehearsal_tools::fused_gn_kernel``: one call is one
    top-level operator named like the CUDA kernel on the CPU capture's
    device lane."""
    lib = torch.library.Library("kafka_rehearsal_tools", "DEF")
    lib.define("fused_gn_kernel(Tensor x) -> Tensor")
    lib.impl("fused_gn_kernel", lambda x: x.clone(), "CPU")
    yield torch.ops.kafka_rehearsal_tools.fused_gn_kernel
    del lib


@pytest.fixture(scope="module")
def report_dirs(tmp_path_factory, marker_op):
    """A work directory holding what the report runs read, under the
    names phases queue, device_plane and route give their directories;
    and the fused_gn calls the capture held."""
    from kafka_tpu_torch import telemetry
    from kafka_tpu_torch.cli import kafka_serve, run_synthetic
    from kafka_tpu_torch.core import fused_gn
    from kafka_tpu_torch.serve import submit_request, synthetic_dates
    from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE
    from kafka_tpu_torch.telemetry import live, perf
    from kafka_tpu_torch.telemetry.registry import MetricsRegistry
    from kafka_tpu_torch.tools import loadgen

    wd = str(tmp_path_factory.mktemp("reports"))
    p = {d: os.path.join(wd, d) for d in (
        "queue_fleet", "queue_tel", "dp_tel", "dp_fleet", "dp_serve",
        "route_fleet", "route_run", "out")}
    small = ["--ny", "24", "--nx", "24", "--days", "8", "--device", "cpu"]
    capture = {}
    real_start, real_stop = perf.start_windowed_capture, \
        perf.stop_windowed_capture

    def start(*args, **kwargs):
        capture["start"] = fused_gn.fused_gn_rows.launches
        return real_start(*args, **kwargs)

    def stop(*args, **kwargs):
        if perf._windowed["directory"] and "stop" not in capture:
            capture["stop"] = fused_gn.fused_gn_rows.launches
        return real_stop(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        _count_plain(mp, marker=marker_op)
        mp.setattr(perf, "start_windowed_capture", start)
        mp.setattr(perf, "stop_windowed_capture", stop)
        with telemetry.use(MetricsRegistry()):
            run_synthetic.main(["--operator", "identity", *small,
                                "--chunk-size", "12", "--queue",
                                "--num-workers", "1", "--outdir",
                                p["queue_fleet"], "--telemetry-dir",
                                p["queue_tel"]])
        with telemetry.use(MetricsRegistry()):
            run_synthetic.main(["--operator", "twostream", *small,
                                "--outdir", p["out"], "--telemetry-dir",
                                p["dp_tel"], "--profile-windows", "1"])
        dates = synthetic_dates(DEFAULT_BASE_DATE, 16, 2)
        for i, d in enumerate((dates[2], dates[2], dates[6])):
            submit_request(p["dp_serve"], {"request_id": f"r{i}",
                                           "tile": "tile0",
                                           "date": d.isoformat()})
        # A date the tile lacks: an error answer, so the SLO engine's
        # availability objective burns and writes its ledger (on the
        # card, phase device_plane's seconds-long serves burn latency).
        submit_request(p["dp_serve"], {"request_id": "r9", "tile": "tile0",
                                       "date": "2017-07-03"})
        with telemetry.use(MetricsRegistry()):
            kafka_serve.main([
                "--root", p["dp_serve"], "--tiles", "1", "--device", "cpu",
                "--telemetry-dir", p["dp_fleet"], "--fleet-dir",
                p["dp_fleet"], "--exit-when-idle", "--slo-interval-s",
                "0.1", "--slo-fast-window-s", "5"])
        with telemetry.use(MetricsRegistry(p["route_fleet"])) as reg:
            loadgen.bench_fleet(p["route_run"], replicas=2, requests=4,
                                concurrency=2, tiles=2, device="cpu")
            live.LivePublisher(p["route_fleet"], role="route",
                               interval_s=60.0,
                               registry=reg).publish_now(final=True)
            reg.dump()
    return wd, capture["stop"] - capture["start"]


def test_phase_operator_tools_rehearsal(tmp_path, serve_shas, report_dirs,
                                        monkeypatch):
    wd, captured = report_dirs
    reports = cs.run_reports(cs.queue_reports(wd)
                             + cs.device_plane_reports(wd)
                             + cs.route_reports(wd))
    _count_plain(monkeypatch)
    rec = cs.phase_operator_tools(CPU, str(tmp_path), serve_shas=serve_shas,
                                  reports=reports,
                                  fused_gn_captured=captured, ny=48, nx=48)
    assert rec["failures"] == []
    drive = rec["loadgen_root"]
    assert drive["rows"]["serve_ok_total"] == cs.TOOLS_LOAD_REQUESTS
    assert drive["sha_compared"] and drive["date_solves"] > 0
    assert drive["kernel_launches"]["fused_gn"] == drive["date_solves"]
    assert set(drive["served_from"].values()) >= {"cache"}
    assert drive["live_telemetry"]["samples"] > 0
    assert drive["daemon_summary"]["drained"]
    modes = rec["modes"]
    assert sorted(modes) == ["concurrency_sweep", "fleet", "synthetic"]
    for m in modes.values():
        assert m["rc"] == 0
        assert m["kernel_launches"]["fused_update_by_instance"][
            cs.TOOLS_MODES_INSTANCE] > 0
    levels = modes["concurrency_sweep"]["run_load_calls"]
    # warm-up, the levels 1 and 4, the unbatched baseline at 4
    assert [c["concurrency"] for c in levels] == [1, 1, 4, 4]
    assert levels[2]["rounds"] > 0 and levels[2]["members_per_launch"] > 1
    assert levels[2]["launches_per_round"] >= 1
    assert rec["report_processes"] == 8
    assert rec["report_processes_without_jax"] is True
    assert all(r["rc"] == 0 for r in rec["reports"].values())
    assert captured > 0
    assert rec["reports"]["device_report"]["fused_gn_row"]["count"] == \
        captured
    assert rec["reports"]["queue_status"]["counts"]["done"] == 4
    assert rec["reports"]["slo_report"]["records"] > 0
    assert "route" in rec["reports"]["fleet_status route"]["roles"]


def test_phase_operator_tools_fails_on_a_foreign_digest(tmp_path,
                                                        serve_shas,
                                                        monkeypatch):
    _count_plain(monkeypatch)
    monkeypatch.setattr(cs, "TOOLS_MODES", ())
    shas = dict(serve_shas, **{"tile0:warm_noop": "0" * 64})
    with pytest.raises(AssertionError, match="x_sha256 differ"):
        cs.phase_operator_tools(CPU, str(tmp_path), serve_shas=shas,
                                ny=48, nx=48)


def test_phase_operator_tools_fails_without_kernel_launches(tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(cs, "TOOLS_MODES", ())
    with pytest.raises(AssertionError, match="fused_gn launches"):
        cs.phase_operator_tools(CPU, str(tmp_path), ny=48, nx=48)


def _run(tool="queue_status", rc=0, report=None, foreign=(), **extra):
    return {"tool": tool, "argv": [], "rc": rc, "wall_s": 1.0,
            "foreign_modules": None if foreign is None else list(foreign),
            "report": {k: 0 for k in cs.REPORT_KEYS[tool]}
            if report is None else report, "stderr": "", "batch": "b",
            "batch_wall_s": 1.0, **extra}


def _device_run(count):
    row = {"name": f"void {cs.FUSED_GN_KERNEL}<7>(...)", "count": count}
    return _run("device_report", report={
        "mesh_history": [], "n_sessions": 1, "root": "r",
        "sessions": [{"kernels": [{"name": "other", "count": 9}, row]}]})


@pytest.mark.parametrize("runs,captured,match", [
    ({"a": _run()}, None, None),
    ({"device_report": _device_run(3)}, 3, None),
    ({"a": _run(rc=2)}, None, "rc 2"),
    ({"a": _run(report={"counts": {}})}, None, "lacks"),
    ({"a": _run(report=None, rc=0, tool="slo_report") | {"report": None}},
     None, "lacks"),
    ({"a": _run(foreign=["jax", "jax.numpy"])}, None, "imported"),
    ({"a": _run(foreign=None)}, None, "no module check"),
    ({"device_report": _device_run(2)}, 3, "captured"),
    ({"device_report": _run("device_report")}, 3, "captured"),
])
def test_report_gates(runs, captured, match):
    failures = cs.report_gates(runs, captured)
    if match is None:
        assert failures == []
    else:
        assert len(failures) == 1 and match in failures[0]


def test_tool_child_names_foreign_modules(tmp_path):
    """The module check itself: clean for the port's tool, and naming
    the JAX package and its ``tools`` for the JAX tool."""
    from kafka_tpu_torch.cli import drivers

    checks = {}
    for module in ("kafka_tpu_torch.tools.queue_status",
                   "tools.queue_status"):
        proc = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.tool_child()", module,
             str(tmp_path), "--json"], cwd=REPO,
            env=dict(drivers.child_env(), JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout)["n_chunks"] == 0
        checks[module] = json.loads(
            proc.stderr.strip().splitlines()[-1])["foreign_modules"]
    assert checks["kafka_tpu_torch.tools.queue_status"] == []
    assert {"jax", "kafka_tpu", "tools"} <= set(checks["tools.queue_status"])
