"""The port's fleet plane against the JAX package's readers: a
``LivePublisher`` snapshot of the port, read by the JAX
``aggregate.load_live_snapshots`` / ``aggregate_fleet`` and by
``tools/fleet_status.py``; the port's telemetry dir read by
``tools/slo_report.py`` and ``tools/trace_report.py``; the live HTTP
endpoint (``/metrics``, ``/healthz``, ``/statusz``, ``/requestz``, 404);
the port's own aggregation equal to the JAX one on the same snapshots;
and the daemon's fleet gauge feeding admission.  Mirrors
``tests/test_live_telemetry.py`` on the port."""

import json
import os
import sys
import time
import urllib.error
import urllib.request

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from kafka_tpu.telemetry import aggregate as jax_aggregate  # noqa: E402
from kafka_tpu_torch import telemetry  # noqa: E402
from kafka_tpu_torch.telemetry import MetricsRegistry, aggregate, live  # noqa
from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd, maybe_start  # noqa


def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def busy_registry(directory=None):
    reg = MetricsRegistry(directory)
    reg.counter("kafka_engine_windows_total", "w").inc(3, mode="single")
    reg.gauge("kafka_prefetch_queue_depth", "d").set(2)
    h = reg.histogram("kafka_serve_latency_seconds", "l")
    for v in (0.01, 0.02, 0.2, 1.5):
        h.observe(v)
    return reg


class TestLivePublisher:
    def test_snapshot_read_by_the_jax_fleet_plane(self, tmp_path):
        reg = busy_registry(str(tmp_path))
        pub = live.LivePublisher(str(tmp_path), role="engine",
                                 interval_s=60.0, registry=reg)
        path = pub.publish_now()
        pub.publish_now(final=True)
        snap = json.load(open(path))
        assert snap["schema"] == live.SCHEMA_VERSION and snap["final"]
        assert {"quality", "perf", "slo", "devprof"} <= set(snap)
        theirs = jax_aggregate.load_live_snapshots(str(tmp_path))
        ours = aggregate.load_live_snapshots(str(tmp_path))
        assert theirs == ours and len(ours) == 1
        now = time.time()
        fleet = jax_aggregate.aggregate_fleet(theirs, now=now)
        assert fleet == aggregate.aggregate_fleet(ours, now=now)
        key = 'kafka_engine_windows_total{mode="single"}'
        assert fleet["counters"][key] == 3

    def test_fleet_status_renders_a_port_worker(self, tmp_path, capsys):
        from tools.fleet_status import build_view, main, render

        reg = busy_registry(str(tmp_path))
        live.LivePublisher(str(tmp_path), role="serve", interval_s=60.0,
                           registry=reg).publish_now()
        view = build_view(str(tmp_path))
        assert len(view["workers"]) == 1
        assert view["workers"][0]["role"] == "serve"
        assert "serve" in render(view)
        assert main([str(tmp_path), "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["workers"]

    def test_background_thread_republishes_and_stops_final(self, tmp_path):
        with telemetry.use(MetricsRegistry(str(tmp_path))) as reg:
            pub = live.start_publisher(role="engine", interval_s=0.05)
            try:
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline and \
                        (reg.value("kafka_live_snapshots_total") or 0) < 3:
                    time.sleep(0.02)
                assert reg.value("kafka_live_snapshots_total") >= 3
            finally:
                live.stop_publisher()
            assert live.active_publisher() is None
            assert json.load(open(pub.path))["final"] is True

    def test_start_publisher_requires_directory(self):
        with telemetry.use(MetricsRegistry()):
            assert live.start_publisher() is None

    def test_a_failed_write_is_counted_not_raised(self, tmp_path):
        reg = MetricsRegistry()
        pub = live.LivePublisher(str(tmp_path / "gone"), interval_s=60.0,
                                 registry=reg)
        assert pub.publish_now() is None
        assert reg.value("kafka_live_publish_errors_total") == 1

    def test_flight_recorder_dump_refreshes_snapshot(self, tmp_path):
        from kafka_tpu_torch.telemetry.flight_recorder import FlightRecorder

        with telemetry.use(MetricsRegistry(str(tmp_path))):
            live.start_publisher(interval_s=60.0)
            try:
                FlightRecorder(str(tmp_path)).dump("manual")
                snap = json.load(open(live.active_publisher().path))
                assert snap["crash_dumps"] == live.crash_dump_index(
                    str(tmp_path))
                assert snap["crash_dumps"]
            finally:
                live.stop_publisher()


class TestHTTPd:
    def test_port_zero_means_disabled(self):
        assert maybe_start(0) is None

    def test_endpoints(self, tmp_path):
        reg = busy_registry(str(tmp_path))
        httpd = TelemetryHTTPd(port=0, registry=reg,
                               status_provider=lambda: {"k": 1}).start()
        try:
            code, body = http_get(httpd.url + "/metrics")
            assert code == 200
            parsed = jax_aggregate.parse_prom_text(body)
            assert "kafka_serve_latency_seconds_bucket" in parsed
            code, body = http_get(httpd.url + "/healthz")
            assert code == 200
            assert json.loads(body)["verdict"] == "unprobed"
            reg.gauge("kafka_health_unhealthy", "u").set(1)
            assert http_get(httpd.url + "/healthz")[0] == 503
            status = json.loads(http_get(httpd.url + "/statusz")[1])
            assert status["status"] == {"k": 1}
            assert {"perf", "slo", "devprof", "quality"} <= set(status)
            code, body = http_get(httpd.url + "/requestz?json=1")
            assert code == 200 and "recent" in json.loads(body)
            assert http_get(httpd.url + "/nope")[0] == 404
            index = json.loads(http_get(httpd.url + "/")[1])["endpoints"]
            assert {"/kernelz", "/meshz", "/alertz"} <= set(index)
            assert reg.value("kafka_httpd_requests_total",
                             endpoint="/metrics") == 1
        finally:
            httpd.close()

    def test_healthz_probe_runs_the_host_probe_on_the_cpu(self):
        reg = MetricsRegistry()
        httpd = TelemetryHTTPd(port=0, registry=reg).start()
        try:
            code, body = http_get(httpd.url + "/healthz?probe=1")
        finally:
            httpd.close()
        verdict = json.loads(body)
        assert verdict["probe_host_ms"] > 0
        assert verdict["probe_device_ms"] is None  # no card: no device probe
        assert isinstance(verdict["probe_retried"], bool)
        assert reg.value("kafka_health_probe_host_ms") > 0


class TestAggregate:
    def _snap(self, pid, ts, final=False, windows=1.0):
        return {"schema": 1, "ts": ts, "host": "h", "pid": pid,
                "role": "queue_worker", "seq": 1, "interval_s": 2.0,
                "final": final, "run_id": "r", "chunk_id": None,
                "health": {"unhealthy": None},
                "counters": {"kafka_engine_windows_total": windows},
                "gauges": {"kafka_prefetch_queue_depth": float(pid)},
                "histograms": {}, "series_truncated": 0, "crash_dumps": [],
                "status": {}}

    def test_same_fleet_view_as_the_jax_aggregate(self, tmp_path):
        now = time.time()
        snaps = [self._snap(1, now), self._snap(2, now - 3600),
                 self._snap(3, now - 3600, final=True)]
        for s in snaps:
            (tmp_path / f"live_h_{s['pid']}.json").write_text(json.dumps(s))
        ours = aggregate.aggregate_fleet(
            aggregate.load_live_snapshots(str(tmp_path)), now=now)
        theirs = jax_aggregate.aggregate_fleet(
            jax_aggregate.load_live_snapshots(str(tmp_path)), now=now)
        assert ours == theirs
        assert ours["dead_hosts"] == ["h:2"]
        assert aggregate.worker_liveness(
            aggregate.load_live_snapshots(str(tmp_path)), now=now) == \
            jax_aggregate.worker_liveness(
                jax_aggregate.load_live_snapshots(str(tmp_path)), now=now)

    def test_quantiles_equal(self):
        le = [0.1, 0.5, 1.0, 5.0]
        cumulative = [1, 4, 5, 5]
        for q in (0.5, 0.9, 0.99):
            assert aggregate.quantile_from_buckets(le, cumulative, 6, q) == \
                jax_aggregate.quantile_from_buckets(le, cumulative, 6, q)


class TestReportTools:
    def test_trace_report_reads_a_port_run(self, tmp_path, capsys):
        """The port's telemetry dir of a serving run: trace_report ranks
        its request log (the JAX tool, unchanged)."""
        from kafka_tpu_torch.serve import (AssimilationService,
                                           AdmissionPolicy)
        from tools.trace_report import main

        class Stub:
            name, serves = "t", 0

            def serve(self, date):
                return {"status": "ok", "x_sha256": "s",
                        "date": date.isoformat()}

        tel = str(tmp_path / "tel")
        with telemetry.use(MetricsRegistry(tel)) as reg:
            svc = AssimilationService({"t": Stub()}, str(tmp_path / "root"),
                                      policy=AdmissionPolicy())
            svc.start()
            try:
                for k in range(3):
                    svc.submit({"request_id": f"r{k}", "tile": "t",
                                "date": "2017-07-02"})
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline and svc.pending():
                    time.sleep(0.02)
                svc.drain(timeout_s=20)
            finally:
                svc.close()
            reg.dump()
        assert main([tel, "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["requests_total"] == 3
        assert report["by_status"] == {"ok": 3}


class TestFleetAdmission:
    def test_daemon_refreshes_gauge_and_admission_sheds(self, tmp_path):
        from kafka_tpu_torch.serve import (AdmissionController,
                                           AdmissionPolicy,
                                           AssimilationService, ServeDaemon)

        fleet = tmp_path / "fleet"
        fleet.mkdir()
        stale = TestAggregate()._snap(99, time.time() - 3600)
        (fleet / "live_h_99.json").write_text(json.dumps(stale))
        with telemetry.use(MetricsRegistry()) as reg:
            svc = AssimilationService({}, str(tmp_path / "root"))
            daemon = ServeDaemon(svc, str(tmp_path / "root"),
                                 fleet_dir=str(fleet))
            daemon._refresh_fleet_gauge()
            assert reg.value("kafka_fleet_dead_hosts") == 1
            assert AdmissionController(AdmissionPolicy(
                max_dead_hosts=0)).decide(queue_depth=0) == "fleet_degraded"
            svc.close()
