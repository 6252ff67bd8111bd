"""The device plane's wiring in the port: the engine's one counted packed
read (``kafka_engine_device_reads_total`` equal to the dispatches, with
and without a telemetry dir, as in the JAX engine), the CUDA memory
watermark (a no-op on the CPU), kernel-build observability and the
build cache, ``torch.profiler`` traces of a run, the health probes, the
drivers run with every device-plane flag (the same bits), and the
metric-name census: the port registers the JAX package's names, less
the router's, with the same kinds, help strings and buckets."""

import ast
import datetime
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from kafka_tpu_torch import telemetry  # noqa: E402
from kafka_tpu_torch.core import _build  # noqa: E402
from kafka_tpu_torch.telemetry import (  # noqa: E402
    MetricsRegistry, compilemon, devprof, health)
from test_torch_devprof import run_identity_engine  # noqa: E402


# ---------------------------------------------------------------------------
# The engine's packed read.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_dir", [False, True])
@pytest.mark.parametrize("scan_window", [1, 4])
def test_device_reads_equal_dispatches(tmp_path, with_dir, scan_window):
    kf, _, reg = run_identity_engine(
        telemetry_dir=str(tmp_path) if with_dir else None,
        scan_window=scan_window, obs_every=4)
    dispatches = sum(1.0 / r.get("fused", 1) for r in kf.diagnostics_log)
    assert reg.value("kafka_engine_device_reads_total") == dispatches
    if scan_window > 1:
        assert any("fused" in r for r in kf.diagnostics_log)


def test_device_reads_equal_the_jax_engines():
    """The same unfused run in both packages makes the same number of
    packed reads."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_devprof import run_identity_engine as jax_run

    _, _, jreg = jax_run(scan_window=1)
    _, _, treg = run_identity_engine(scan_window=1)
    assert treg.value("kafka_engine_device_reads_total") == \
        jreg.value("kafka_engine_device_reads_total")


def test_memory_watermark_is_a_noop_on_the_cpu():
    from kafka_tpu_torch.telemetry import record_memory_watermark
    from kafka_tpu_torch.telemetry.device import use_device, used_devices

    use_device("cpu")
    assert used_devices() == []
    reg = MetricsRegistry()
    record_memory_watermark(reg)
    assert reg.value("kafka_device_memory_peak_bytes") is None
    assert reg.value("kafka_devprof_live_buffers") == 0


def test_memory_gauges_from_the_allocator(monkeypatch):
    """The gauges' definitions: in use = allocated current, peak =
    allocated peak, headroom = free + reserved - allocated."""
    from kafka_tpu_torch.telemetry import device

    monkeypatch.setattr(devprof, "memory_stats", lambda: [{
        "device": 0, "bytes_in_use": 100, "peak_bytes_in_use": 300,
        "bytes_reserved": 160, "bytes_free": 1000, "bytes_limit": 2000,
        "num_ooms": 0}])
    reg = MetricsRegistry()
    device.record_memory_watermark(reg)
    assert reg.value("kafka_device_memory_bytes_in_use", device=0) == 100
    assert reg.value("kafka_device_memory_peak_bytes", device=0) == 300
    assert reg.value("kafka_device_memory_headroom_bytes",
                     device=0) == 1060


# ---------------------------------------------------------------------------
# Kernel builds: the listener and the cache directory.
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes its ``-o`` output; the build root
    under ``tmp_path``."""
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                      "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                      "  shift\ndone\necho 'ptxas info: 32 registers'\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "BUILD_LISTENERS", [])
    monkeypatch.setattr(compilemon, "_installed", False)
    return script


def test_compile_listener_counts_misses_and_hits(fake_nvcc):
    assert compilemon.install_compile_listeners()
    assert compilemon.install_compile_listeners()
    assert _build.BUILD_LISTENERS == [compilemon._on_build]
    with telemetry.use(MetricsRegistry()) as reg:
        _build.build("fused_gn")
        _build.build("fused_gn")
        _build.build("solve_rows")
    assert reg.value("kafka_compile_cache_misses_total") == 2
    assert reg.value("kafka_compile_cache_hits_total") == 1
    assert reg.value("kafka_compile_program_seconds")["count"] == 2
    events = [e for e in reg.events if e["event"] == "compile"]
    assert [e["program"] for e in events] == ["fused_gn", "solve_rows"]
    spans = [e for e in reg.trace.to_chrome()["traceEvents"]
             if e.get("cat") == "compile"]
    assert len(spans) == 2


def test_compilation_cache_points_the_build_root(tmp_path, monkeypatch):
    from kafka_tpu_torch.utils.compilation_cache import \
        enable_compilation_cache

    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.delenv("KAFKA_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("KAFKA_TPU_COMPILE_CACHE_DIR", raising=False)
    default = _build.BUILD_ROOT
    assert enable_compilation_cache() == str(default)
    assert default == REPO / "build" / "kafka_tpu_torch"
    assert enable_compilation_cache(str(tmp_path / "a")) == \
        str(tmp_path / "a")
    assert _build.BUILD_ROOT == tmp_path / "a"
    monkeypatch.setenv("KAFKA_TPU_COMPILE_CACHE_DIR", str(tmp_path / "b"))
    assert enable_compilation_cache() == str(tmp_path / "b")
    monkeypatch.setenv("KAFKA_TPU_NO_COMPILE_CACHE", "1")
    assert enable_compilation_cache() is None
    assert _build.BUILD_ROOT not in (tmp_path / "a", tmp_path / "b",
                                     default)


# ---------------------------------------------------------------------------
# torch.profiler traces of a run.
# ---------------------------------------------------------------------------

def test_profiling_trace_writes_a_capture_session(tmp_path):
    from kafka_tpu_torch.utils.profiling import annotate, trace

    with trace(None):
        pass
    with trace(str(tmp_path)):
        with annotate("kafka/test"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    (session,) = devprof.find_capture_sessions(str(tmp_path))
    names = [k["name"] for k in devprof.parse_capture(session)["kernels"]]
    assert "aten::matmul" in names
    events, _ = devprof.load_capture_events(session)
    assert any(e.get("name") == "kafka/test" for e in events)


def test_engine_run_profile_dir(tmp_path):
    kf, _, _ = run_identity_engine()
    x0 = np.zeros((kf.gather.n_pad, 2), np.float32)
    p_inv0 = np.broadcast_to(np.eye(2, dtype=np.float32) * 4.0,
                             (kf.gather.n_pad, 2, 2)).copy()
    with telemetry.use(MetricsRegistry()):
        kf.run([datetime.datetime(2021, 3, 1) + datetime.timedelta(days=d)
                for d in (0, 4, 8)], x0, None, p_inv0,
               profile_dir=str(tmp_path / "prof"))
    assert devprof.find_capture_sessions(str(tmp_path / "prof"))


# ---------------------------------------------------------------------------
# Health probes.
# ---------------------------------------------------------------------------

def test_probe_device_runs_the_fused_solve(monkeypatch):
    from kafka_tpu_torch.core import fused_gn

    calls = []
    real = fused_gn.fused_gn_raw_plain
    monkeypatch.setattr(fused_gn, "fused_gn_raw_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    reg = MetricsRegistry()
    ms = health.probe_device(n_pix=256, ks=(1, 2), reps=1, registry=reg,
                             device="cpu")
    assert ms == reg.value("kafka_health_probe_device_ms")
    assert len(calls) == health.probe_solves(ks=(1, 2), reps=1) == 5


def test_probe_health_on_the_cpu_has_no_device_band(monkeypatch):
    monkeypatch.setattr(health, "HEALTHY_HOST_MS", 1e9)
    reg = MetricsRegistry()
    verdict = health.probe_health(retry_wait_s=0.0, registry=reg)
    assert verdict["probe_device_ms"] is None
    assert verdict["unhealthy"] is False
    assert health.latest_verdict(reg)["probed"] is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # device=None means the card
            health.probe_device(n_pix=256)


def test_no_tpu_figure_in_the_port():
    from kafka_tpu_torch.telemetry import perf

    assert health.HEALTHY_DEVICE_MS != 6.4
    assert (perf.HBM_GBPS, perf.PEAK_TFLOPS_F32) == (3350.0, 67.0)
    for path in (REPO / "kafka_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for figure in ("819", "197.0", "v5e"):
            assert figure not in text, f"{path.name} carries {figure}"


# ---------------------------------------------------------------------------
# Drivers with the whole device plane on.
# ---------------------------------------------------------------------------

def test_run_synthetic_with_every_device_plane_flag_same_bits(tmp_path):
    from kafka_tpu_torch.cli.run_synthetic import main
    from kafka_tpu_torch.io import read_geotiff
    from test_torch_cli import _free_port

    args = ["--operator", "twostream", "--ny", "24", "--nx", "24",
            "--days", "12", "--obs-every", "4", "--device", "cpu"]
    with telemetry.use(MetricsRegistry()):
        main(args + ["--outdir", str(tmp_path / "a")])
    tel = tmp_path / "tel"
    with telemetry.use(MetricsRegistry()):
        main(args + ["--outdir", str(tmp_path / "b"), "--telemetry-dir",
                     str(tel), "--http-port", str(_free_port()),
                     "--profile-windows", "2"])
        reg = telemetry.get_registry()
        dispatches = reg.value("kafka_engine_windows_total",
                               mode="single") or 0
    names = sorted(n for n in os.listdir(tmp_path / "a")
                   if n.endswith(".tif"))
    assert names == sorted(n for n in os.listdir(tmp_path / "b")
                           if n.endswith(".tif"))
    for n in names:
        a = read_geotiff(str(tmp_path / "a" / n))[0]
        b = read_geotiff(str(tmp_path / "b" / n))[0]
        assert np.array_equal(a, b, equal_nan=True), n
    assert reg.value("kafka_engine_device_reads_total") >= dispatches > 0
    assert devprof.find_capture_sessions(str(tel / "profile"))
    assert [f for f in os.listdir(tel) if f.startswith("live_")]


def test_kafka_smooth_runs_the_device_plane(tmp_path):
    from kafka_tpu_torch.cli import kafka_smooth
    from kafka_tpu_torch.cli.run_synthetic import main

    grid = ["--operator", "identity", "--ny", "16", "--nx", "16",
            "--device", "cpu"]
    with telemetry.use(MetricsRegistry()):
        main(grid + ["--days", "8", "--checkpoint", "--outdir",
                     str(tmp_path / "run")])
    tel = tmp_path / "tel"
    with telemetry.use(MetricsRegistry()):
        out = kafka_smooth.main(grid + [
            "--ckpt-dir", str(tmp_path / "run" / "ckpt"),
            "--telemetry-dir", str(tel)])
    assert out["windows"] >= 2 and "error" not in out
    snaps = [f for f in os.listdir(tel) if f.startswith("live_")]
    assert json.load(open(tel / snaps[0]))["role"] == "smooth"
    events = [json.loads(line)["event"] for line in open(tel /
                                                          "events.jsonl")]
    assert "slo_engine_started" in events and "smooth_done" in events


# ---------------------------------------------------------------------------
# The metric-name census.
# ---------------------------------------------------------------------------

def _registrations(pkg: pathlib.Path) -> dict:
    """name -> (kind, help or None when computed, buckets) of every
    ``.counter/.gauge/.histogram("kafka_...", ...)`` call under ``pkg``."""
    out = {}
    for path in pkg.rglob("*.py"):
        tree = ast.parse(path.read_text())
        consts = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                try:
                    consts[node.targets[0].id] = ast.literal_eval(
                        node.value)
                except ValueError:
                    pass
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("counter", "gauge", "histogram")
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and str(node.args[0].value).startswith("kafka_")):
                continue
            help_node = node.args[1] if len(node.args) > 1 else None
            help_text = help_node.value if isinstance(
                help_node, ast.Constant) else None
            buckets = None
            for kw in node.keywords:
                if kw.arg == "buckets":
                    buckets = consts[kw.value.id] if isinstance(
                        kw.value, ast.Name) else ast.literal_eval(kw.value)
            out[node.args[0].value] = (node.func.attr, help_text, buckets)
    return out


#: help strings that carried a figure taken for the TPU (the probes'
#: healthy values): the port states its own.
HELP_WITH_TPU_FIGURES = ("kafka_health_probe_device_ms",
                         "kafka_health_probe_host_ms")
#: help strings the port extends: the JAX text with the port's own
#: additions inside its closing parenthesis (the sub-date phases).
HELP_EXTENDED = {
    "kafka_engine_phase_seconds": (
        "wall seconds per engine phase (advance/assimilate/dump/"
        "fused_scan, and inside a date date_fetch/date_solve/date_record/"
        "linearize/loop_sync/row_layout)"),
}


def test_the_port_registers_the_jax_names_less_the_routers():
    """Every metric name of the JAX package, the router's nine
    ``kafka_route_*`` included (nothing is left out now), with the JAX
    kinds, help strings (``HELP_EXTENDED``: the JAX text extended) and
    buckets."""
    from kafka_tpu_torch.tools.kafkalint.rules_telemetry import \
        REGISTRATION_RE

    def regex_names(pkg):
        return {m.group(2) for p in (REPO / pkg).rglob("*.py")
                for m in REGISTRATION_RE.finditer(p.read_text())}

    jax_names, port_names = regex_names("kafka_tpu"), \
        regex_names("kafka_tpu_torch")
    route = {n for n in jax_names if n.startswith("kafka_route_")}
    assert len(jax_names) == 95 and len(route) == 9
    assert port_names == jax_names
    assert route <= port_names and len(port_names) == 95
    jax_regs = _registrations(REPO / "kafka_tpu")
    port_regs = _registrations(REPO / "kafka_tpu_torch")
    for name in sorted(port_names):
        jkind, jhelp, jbuckets = jax_regs[name]
        kind, help_text, buckets = port_regs[name]
        assert (kind, buckets) == (jkind, jbuckets), name
        if name in HELP_WITH_TPU_FIGURES:
            assert help_text is None  # computed from the port's constants
        elif name in HELP_EXTENDED:
            assert help_text == HELP_EXTENDED[name], name
            assert jhelp.endswith(")") and help_text.startswith(jhelp[:-1])
        else:
            assert help_text == jhelp, name


def test_label_sets_equal_on_the_same_engine_run():
    sys.path.insert(0, str(REPO / "tests"))
    from test_devprof import run_identity_engine as jax_run

    _, _, jreg = jax_run(scan_window=1)
    _, _, treg = run_identity_engine(scan_window=1)

    def labels(reg):
        return {m.name: sorted({tuple(k for k, _ in key)
                                for key, _ in m._series()})
                for m in reg.metrics()}

    jl, tl = labels(jreg), labels(treg)
    for name in set(jl) & set(tl):
        if name.startswith(("kafka_perf_", "kafka_engine_device_reads")):
            assert tl[name] == jl[name], name
    assert "kafka_perf_phase_fraction" in tl
