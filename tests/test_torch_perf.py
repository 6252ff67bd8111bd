"""The port's performance plane (``kafka_tpu_torch.telemetry.perf``)
against the JAX package's: the same minimum-traffic bounds, the H100
roofs in one home (``chip_smoke.py``'s ``bound()`` reads them), the
route labels of the utilization gauge, always-on attribution through the
port's engine (reads == dispatches with it active), and the
``torch.profiler`` capture paths (``capture``, ``--profile-windows``,
``/profilez``) with their one-at-a-time and 503 semantics.  The capture
mechanics run on the JAX tests' marker-file stub of the profiler seam;
one test takes a real ``torch.profiler`` capture."""

import json
import os
import sys
import urllib.error
import urllib.request

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import chip_smoke as cs  # noqa: E402
from kafka_tpu.telemetry import perf as jax_perf  # noqa: E402
from kafka_tpu_torch import telemetry  # noqa: E402
from kafka_tpu_torch.telemetry import MetricsRegistry, devprof, perf  # noqa
from test_torch_devprof import run_identity_engine  # noqa: E402

REC = {"wall_s": 0.002, "chi2_per_band": [1.0]}


@pytest.fixture
def stub_profiler(monkeypatch, tmp_path):
    """The JAX tests' marker-file stub of the profiler seam."""
    def fake_start(directory):
        os.makedirs(directory, exist_ok=True)
        open(os.path.join(directory, "capture.marker"), "w").close()

    monkeypatch.setattr(perf, "_start_trace", fake_start)
    monkeypatch.setattr(perf, "_stop_trace", lambda: None)
    return tmp_path


class TestTrafficBounds:
    @pytest.mark.parametrize("name", [
        "min_traffic_linearize", "min_traffic_update",
        "min_traffic_gn_full", "min_traffic_gn_inkernel"])
    def test_bounds_equal_the_jax_packages(self, name):
        for args in ((1000, 7, 2), (2000, 7, 2), (4096, 10, 10)):
            assert getattr(perf, name)(*args) == \
                getattr(jax_perf, name)(*args)

    def test_h100_roofs_in_one_home(self):
        assert (perf.HBM_GBPS, perf.PEAK_TFLOPS_F32) == (3350.0, 67.0)
        b = cs.bound(3.35e9, 0.0)
        assert b["bound_ms"] == pytest.approx(1.0) and \
            b["bound_by"] == "bytes"
        assert cs.bound(0.0, 67e9)["bound_ms"] == pytest.approx(1.0)

    def test_inkernel_bound_agrees_with_the_smoke_on_the_tile(self):
        """The kept tile date (4,608,000 px): the live gauge's bound and
        chip_smoke.py's own bound of the kernel within 2 %."""
        n = 4_608_000
        live_ms = perf.min_traffic_gn_inkernel(n, 7, 2) / \
            (perf.HBM_GBPS * 1e9) * 1e3
        smoke = cs.bound(4 * (cs.MIN_FLOATS_PER_PIXEL * n
                              + cs.MIN_FLOATS_PER_GROUP * (n // 2048)), 0.0)
        assert smoke["bound_ms"] == pytest.approx(0.4457, abs=1e-4)
        assert live_ms == pytest.approx(smoke["bound_ms"], rel=0.02)

    def test_component_follows_the_ports_routes(self):
        from kafka_tpu_torch.obsops import IdentityOperator, \
            TwoStreamOperator

        two, ident = TwoStreamOperator(), IdentityOperator(2, (0, 1))
        assert perf.component_for(None, two) == "gn_inkernel"
        assert perf.component_for({"use_pallas": True}, two) == \
            "gn_inkernel"
        assert perf.component_for({"inkernel_linearize": False}, two) == \
            "gn_full_pallas"
        assert perf.component_for({}, ident) == "gn_full_pallas"
        assert perf.component_for({"use_pallas": False}, two) == "gn_full"
        assert set(perf.TRAFFIC_BOUNDS) == set(jax_perf.TRAFFIC_BOUNDS)

    def test_utilization_is_bound_over_traffic_time(self):
        u = perf.roofline_utilization("gn_inkernel", 1 << 19, 7, 2, 0.001)
        assert u == pytest.approx(perf.min_traffic_gn_inkernel(
            1 << 19, 7, 2) / (0.001 * 3350e9))
        assert perf.roofline_utilization("gn_full", 10, 7, 2, 0.0) is None


class TestAttribution:
    @pytest.mark.parametrize("scan_window", [1, 4])
    def test_engine_publishes_perf_gauges(self, scan_window):
        kf, _, reg = run_identity_engine(scan_window=scan_window)
        assert reg.value("kafka_perf_px_steps_per_s") > 0
        assert 0 < reg.value("kafka_perf_device_fraction") <= 1.0
        assert reg.value("kafka_perf_roofline_utilization",
                         component="gn_full_pallas") > 0
        assert 0 < reg.value("kafka_perf_phase_fraction",
                             phase="solve") <= 1.0
        for phase in ("fetch", "advance", "dump", "write"):
            assert reg.value("kafka_perf_phase_fraction",
                             phase=phase) is not None

    def test_record_window_gauges_equal_the_jax_arithmetic(self):
        """The same records through both modules give the same gauges
        (the roofline differs only by the roof: 3350 against 819 GB/s)."""
        from kafka_tpu.telemetry import MetricsRegistry as JaxRegistry

        regs = {"jax": JaxRegistry(), "torch": MetricsRegistry()}
        for name, mod in (("jax", jax_perf), ("torch", perf)):
            for k in range(3):
                mod.record_window({"wall_s": 0.01 * (k + 1),
                                   "chi2_per_band": [1.0, 2.0]},
                                  n_valid=1000, n_pad=1024, n_params=7,
                                  n_bands=2, solver_options={
                                      "use_pallas": False},
                                  registry=regs[name])
        j, t = regs["jax"], regs["torch"]
        uj = j.value("kafka_perf_roofline_utilization", component="gn_full")
        ut = t.value("kafka_perf_roofline_utilization", component="gn_full")
        assert ut == pytest.approx(uj * 819.0 / 3350.0)
        assert set(perf.summary(t)) == set(jax_perf.summary(j))

    def test_device_reads_invariant_with_attribution_active(self):
        for scan_window in (1, 4):
            kf, _, reg = run_identity_engine(scan_window=scan_window)
            expected = sum(1.0 / rec.get("fused", 1)
                           for rec in kf.diagnostics_log)
            assert expected == int(expected)
            assert reg.value("kafka_engine_device_reads_total") == \
                int(expected)

    def test_summary_shape(self):
        _, _, reg = run_identity_engine()
        s = perf.summary(reg)
        assert set(s) == {"px_steps_per_s", "device_fraction",
                          "roofline_utilization", "phases"}
        empty = perf.summary(MetricsRegistry())
        assert empty["px_steps_per_s"] is None
        assert empty["roofline_utilization"] == {}


class TestProfilerCapture:
    def test_real_capture_writes_a_parseable_session(self, tmp_path):
        """The one real-profiler test: a torch.profiler capture of a
        little CPU work lands as a capture session that parses."""
        reg = MetricsRegistry()
        d = str(tmp_path / "profile")
        perf._capture_lock.acquire()
        try:
            perf._start_trace(d)
            torch.ones(64, 64) @ torch.ones(64, 64)
            perf._stop_trace()
        finally:
            perf._capture_lock.release()
        sessions = devprof.find_capture_sessions(d)
        assert len(sessions) == 1
        table = devprof.parse_capture(sessions[0])
        assert "aten::matmul" in [k["name"] for k in table["kernels"]]
        assert devprof.capture_epoch(sessions[0], stop_at=d) is not None
        assert reg.value("kafka_perf_profile_captures_total") is None

    def test_one_capture_at_a_time(self, stub_profiler):
        tmp_path = stub_profiler
        reg = MetricsRegistry()
        perf.start_windowed_capture(5, str(tmp_path / "w"), registry=reg)
        try:
            with pytest.raises(perf.CaptureBusy):
                perf.capture(0.05, str(tmp_path / "p"), registry=reg)
        finally:
            assert perf.stop_windowed_capture(registry=reg) is not None
        assert perf.stop_windowed_capture(registry=reg) is None
        perf.capture(0.05, str(tmp_path / "p2"), registry=reg)
        assert not perf._capture_lock.locked()

    def test_windowed_capture_stops_after_n_windows(self, stub_profiler):
        reg = MetricsRegistry()
        perf.start_windowed_capture(2, str(stub_profiler / "w"),
                                    registry=reg)
        try:
            for _ in range(2):
                perf.record_window(REC, n_valid=10, n_pad=16, n_params=2,
                                   n_bands=1, registry=reg)
            assert perf._windowed["directory"] is None
            assert reg.value("kafka_perf_profile_captures_total") == 1
        finally:
            perf.stop_windowed_capture(registry=reg)

    def test_unavailable_profiler_releases_the_slot(self, monkeypatch,
                                                    tmp_path):
        def refuse(directory):
            raise perf.CaptureUnavailable("no profiler here")

        monkeypatch.setattr(perf, "_start_trace", refuse)
        with pytest.raises(perf.CaptureUnavailable):
            perf.capture(0.05, str(tmp_path / "p"))
        with pytest.raises(perf.CaptureUnavailable):
            perf.start_windowed_capture(2, str(tmp_path / "w"))
        assert not perf._capture_lock.locked()

    def test_a_refusing_profiler_raises_capture_unavailable(
            self, monkeypatch, tmp_path):
        """torch.profiler refusing to start (another session running)
        surfaces as CaptureUnavailable, the 503 of /profilez."""
        from torch import profiler

        def refuse(self):
            raise RuntimeError("Profiler is already enabled")

        monkeypatch.setattr(profiler.profile, "start", refuse)
        with pytest.raises(perf.CaptureUnavailable):
            perf._start_trace(str(tmp_path / "p"))


class TestTracingSwitchedByTheLaunchingThread:
    """On a card, a capture's CUDA tracing is switched on and off by a
    thread that launches the package's kernels, just after a launch
    (``perf._on_launching_thread``, ``core._build.after_next_launch``):
    switched by another thread, CUPTI lost the launching thread's GPU
    records.  The CPU stands in with ``torch.cuda.is_available`` faked
    and a thread that counts launches as the kernel wrappers do."""

    @pytest.fixture
    def launcher(self, monkeypatch):
        import threading
        import types

        from kafka_tpu_torch.core import _build

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        wrapper = types.SimpleNamespace(launches=0)
        stop = threading.Event()

        def launch():
            while not stop.is_set():
                _build.count_launch(wrapper)
                stop.wait(0.001)

        thread = threading.Thread(target=launch, name="launcher",
                                  daemon=True)
        thread.start()
        yield wrapper
        stop.set()
        thread.join()
        assert not _build._AFTER_LAUNCH

    def test_job_runs_once_on_the_next_launching_thread(self):
        import threading
        import types

        from kafka_tpu_torch.core import _build

        ran = []
        _build.after_next_launch(
            lambda: ran.append(threading.current_thread().name))
        wrapper = types.SimpleNamespace(launches=0)
        worker = threading.Thread(
            target=lambda: [_build.count_launch(wrapper) for _ in range(3)],
            name="worker")
        worker.start()
        worker.join()
        assert ran == ["worker"] and wrapper.launches == 3
        job = ran.append
        _build.after_next_launch(job)
        _build.discard_launch_job(job)
        _build.count_launch(wrapper)
        assert ran == ["worker"] and not _build._AFTER_LAUNCH

    def test_the_launching_thread_switches_and_errors_reach_the_asker(
            self, launcher):
        value, thread = perf._on_launching_thread(lambda x: x + 1, 41)
        assert (value, thread) == (42, "launcher")

        def refuse():
            raise perf.CaptureUnavailable("no profiler here")

        with pytest.raises(perf.CaptureUnavailable):
            perf._on_launching_thread(refuse)

    def test_without_a_launch_the_asker_switches(self, monkeypatch):
        from kafka_tpu_torch.core import _build

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(perf, "LAUNCH_WAIT_S", 0.05)
        value, thread = perf._on_launching_thread(lambda: "here")
        assert value == "here" and thread == "MainThread"
        assert not _build._AFTER_LAUNCH

    def test_capture_is_switched_by_the_launching_thread(
            self, stub_profiler, launcher):
        reg = MetricsRegistry()
        perf.capture(0.05, str(stub_profiler / "p"), registry=reg)
        [event] = [e for e in reg.events if e["event"] == "profile_capture"]
        assert event["switched_on"] == ["launcher", "launcher"]
        assert not perf._capture_lock.locked()

    def test_halted_session_is_written_once(self, tmp_path):
        """The launching thread halts the session; the asker writes it."""
        reg = MetricsRegistry()
        d = str(tmp_path / "profile")
        perf._capture_lock.acquire()
        try:
            perf._start_trace(d)
            torch.ones(64, 64) @ torch.ones(64, 64)
            perf._halt_trace()
            perf._halt_trace()
            assert perf._stop_trace() is False
        finally:
            perf._capture_lock.release()
        [session] = devprof.find_capture_sessions(d)
        assert "aten::matmul" in [
            k["name"] for k in devprof.parse_capture(session)["kernels"]]
        assert not perf._session
        assert reg.value("kafka_perf_profile_captures_total") is None

class TestProfilezEndpoint:
    def _get(self, url):
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.read().decode()

    def test_profilez_smoke_capture_file_appears(self, stub_profiler):
        from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd

        reg = MetricsRegistry(str(stub_profiler))
        httpd = TelemetryHTTPd(port=0, registry=reg).start()
        try:
            code, body = self._get(httpd.url + "/profilez?seconds=0.1")
            payload = json.loads(body)
            assert code == 200, body
            assert os.path.exists(os.path.join(payload["directory"],
                                               "capture.marker"))
            assert reg.value("kafka_perf_profile_captures_total") == 1
        finally:
            httpd.close()
            reg.close()

    def test_profilez_unavailable_profiler_is_clean_503(self, monkeypatch,
                                                        tmp_path):
        from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd

        def refuse(directory):
            raise perf.CaptureUnavailable("no profiler here")

        monkeypatch.setattr(perf, "_start_trace", refuse)
        reg = MetricsRegistry(str(tmp_path))
        httpd = TelemetryHTTPd(port=0, registry=reg).start()
        try:
            code, body = self._get(httpd.url + "/profilez?seconds=0.1")
            assert code == 503 and "profiler" in json.loads(body)["error"]
        finally:
            httpd.close()
            reg.close()

    def test_profilez_cuda_capture_without_gpu_work_is_503(
            self, monkeypatch, tmp_path):
        """A session that traced CUDA activity but caught no GPU work
        answers 503 and counts a parse failure: its host operators never
        stand in for kernels."""
        from torch import profiler

        from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd
        from test_torch_devprof import cpu_ops_doc

        class CudaSessionWithoutKernels:
            def __init__(self, activities):
                self.activities = set(activities) | {
                    profiler.ProfilerActivity.CUDA}

            def start(self):
                pass

            def stop(self):
                pass

            def export_chrome_trace(self, path):
                with open(path, "w") as f:
                    json.dump(cpu_ops_doc(), f)

        monkeypatch.setattr(profiler, "profile", CudaSessionWithoutKernels)
        reg = MetricsRegistry(str(tmp_path))
        httpd = TelemetryHTTPd(port=0, registry=reg).start()
        try:
            code, body = self._get(httpd.url + "/profilez?seconds=0.1")
            assert code == 503 and "no GPU work" in json.loads(body)["error"]
            assert reg.value("kafka_devprof_parse_failures_total") == 1
            assert devprof.kernel_summary(reg)["captures_parsed"] == 0
        finally:
            httpd.close()
            reg.close()
        assert not perf._capture_lock.locked()

    def test_profilez_busy_is_409(self, stub_profiler):
        from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd

        reg = MetricsRegistry(str(stub_profiler))
        perf.start_windowed_capture(5, str(stub_profiler / "w"),
                                    registry=reg)
        httpd = TelemetryHTTPd(port=0, registry=reg).start()
        try:
            code, body = self._get(httpd.url + "/profilez?seconds=0.1")
            assert code == 409
        finally:
            httpd.close()
            perf.stop_windowed_capture(registry=reg)
            reg.close()

    def test_profilez_without_telemetry_dir_is_503(self):
        from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd

        httpd = TelemetryHTTPd(port=0, registry=MetricsRegistry()).start()
        try:
            code, body = self._get(httpd.url + "/profilez")
            assert code == 503 and "telemetry" in json.loads(body)["error"]
        finally:
            httpd.close()

    def test_metrics_page_declares_the_device_plane(self):
        """/metrics names every device-plane family from the first
        scrape, failure counters at zero included."""
        from kafka_tpu_torch.telemetry.aggregate import parse_prom_text
        from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd

        httpd = TelemetryHTTPd(port=0, registry=MetricsRegistry()).start()
        try:
            code, body = self._get(httpd.url + "/metrics")
        finally:
            httpd.close()
        assert code == 200
        names = set(parse_prom_text(body))
        assert set(cs.DEVICE_PLANE_NAMES) - set(cs.FLEET_NAMES) <= names


class TestRunSyntheticLive:
    def test_driver_publishes_perf_plane(self, tmp_path):
        from kafka_tpu_torch.cli.run_synthetic import main
        from tools.fleet_status import build_view, render

        tel = str(tmp_path / "tel")
        with telemetry.use(MetricsRegistry()):
            main(["--operator", "twostream", "--ny", "24", "--nx", "24",
                  "--days", "8", "--outdir", str(tmp_path / "out"),
                  "--telemetry-dir", tel, "--device", "cpu"])
            reg = telemetry.get_registry()
            assert reg.value("kafka_perf_px_steps_per_s") > 0
            assert reg.value("kafka_perf_roofline_utilization",
                             component="gn_inkernel") > 0
        prom = open(os.path.join(tel, "metrics.prom")).read()
        assert 'kafka_perf_roofline_utilization{component="gn_inkernel"}' \
            in prom
        view = build_view(tel)
        assert [w for w in view["workers"] if w.get("perf")]
        assert "perf=" in render(view)

    def test_profile_windows_flag(self, stub_profiler):
        from kafka_tpu_torch.cli.run_synthetic import main

        tel = str(stub_profiler / "tel")
        with telemetry.use(MetricsRegistry()):
            try:
                main(["--operator", "identity", "--ny", "24", "--nx", "24",
                      "--days", "8", "--outdir", str(stub_profiler / "out"),
                      "--telemetry-dir", tel, "--profile-windows", "2",
                      "--device", "cpu"])
                assert telemetry.get_registry().value(
                    "kafka_perf_profile_captures_total") == 1
            finally:
                perf.stop_windowed_capture()
        assert os.path.exists(os.path.join(tel, "profile",
                                           "capture.marker"))
