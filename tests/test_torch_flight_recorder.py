"""The port's crash flight recorder (``kafka_tpu_torch.telemetry.
flight_recorder``), mirroring ``tests/test_flight_recorder.py``: dump
contents, the mid-run-exception path through the port's engine and
driver, signal handling, the unhealthy-probe trigger, and the OOM
forensics a ``torch.cuda.OutOfMemoryError`` attaches.  A port dump holds
the JAX dump's keys, so either package's readers take it."""

import glob
import json
import os
import signal
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import torch  # noqa: E402

from kafka_tpu.telemetry import MetricsRegistry as JaxRegistry  # noqa: E402
from kafka_tpu.telemetry.flight_recorder import \
    FlightRecorder as JaxRecorder  # noqa: E402
from kafka_tpu_torch import telemetry  # noqa: E402
from kafka_tpu_torch.telemetry import (  # noqa: E402
    MetricsRegistry, flight_recorder, tracing)
from kafka_tpu_torch.telemetry.flight_recorder import FlightRecorder  # noqa


def crash_files(directory):
    return sorted(glob.glob(os.path.join(str(directory), "crash_*.json")))


class TestDump:
    def test_dump_carries_the_jax_dumps_keys(self, tmp_path):
        with telemetry.use(MetricsRegistry()) as reg:
            reg.counter("kafka_test_total").inc(3)
            reg.emit("solve", date="2021-01-01", n_iterations=4)
            with tracing.push(run_id="rr", chunk_id="0001"):
                path = FlightRecorder(str(tmp_path / "t")).dump("sigterm")
        from kafka_tpu import telemetry as jax_telemetry

        with jax_telemetry.use(JaxRegistry()):
            jpath = JaxRecorder(str(tmp_path / "j")).dump("sigterm")
        dump, jdump = json.load(open(path)), json.load(open(jpath))
        assert set(dump) == set(jdump)
        assert dump["context"]["run_id"] == "rr"
        assert dump["metrics"]["kafka_test_total"] == 3
        assert any(e["event"] == "solve" for e in dump["events"])
        assert "MainThread" in {t["name"] for t in dump["threads"]}
        assert os.path.exists(tmp_path / "t" / "metrics.json")

    def test_no_destination_no_dump(self):
        with telemetry.use(MetricsRegistry()):
            assert FlightRecorder(None).dump(
                "exception", exc=RuntimeError("x")) is None

    def test_same_exception_dumped_once(self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            rec = FlightRecorder(str(tmp_path))
            exc = RuntimeError("boom")
            assert rec.dump("exception", exc=exc) is not None
            assert rec.dump("exception", exc=exc) is None
        assert len(crash_files(tmp_path)) == 1


class TestOOM:
    def test_cuda_oom_attaches_forensics(self, tmp_path, monkeypatch):
        """A torch.cuda.OutOfMemoryError unwinding through the guard
        gets the forensic bundle: allocator census and memory stats
        (faked here: the CPU has no allocator to read)."""
        from kafka_tpu_torch.telemetry import devprof

        monkeypatch.setattr(devprof, "buffer_census", lambda: [
            {"device": 0, "pool": "large", "block_bytes": 1 << 21,
             "count": 1, "bytes": 1 << 21}])
        monkeypatch.setattr(devprof, "memory_stats", lambda: [
            {"device": 0, "bytes_in_use": 1 << 21}])
        with telemetry.use(MetricsRegistry()):
            with pytest.raises(torch.cuda.OutOfMemoryError):
                with FlightRecorder(str(tmp_path)):
                    raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        dump = json.load(open(crash_files(tmp_path)[0]))
        assert dump["exception"]["type"] == "OutOfMemoryError"
        assert dump["device_forensics"]["buffer_census"][0]["bytes"] == \
            1 << 21
        assert dump["device_forensics"]["memory"][0]["device"] == 0


class TestMidRunException:
    def test_run_synthetic_crash_writes_dump(self, tmp_path, monkeypatch):
        from kafka_tpu_torch.cli import run_synthetic
        from kafka_tpu_torch.io import GeoTIFFOutput

        calls = {"n": 0}
        orig = GeoTIFFOutput.dump_data

        def dying_dump(self, *a, **kw):
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("disk on fire")
            return orig(self, *a, **kw)

        monkeypatch.setattr(GeoTIFFOutput, "dump_data", dying_dump)
        monkeypatch.setattr(run_synthetic.KalmanFilter, "_fusion_possible",
                            lambda self: False)
        tel = str(tmp_path / "tel")
        prev = telemetry.get_registry()
        try:
            with pytest.raises(RuntimeError, match="disk on fire"):
                run_synthetic.main([
                    "--operator", "identity", "--outdir",
                    str(tmp_path / "out"), "--telemetry-dir", tel,
                    "--days", "8", "--step", "2", "--ny", "16", "--nx",
                    "16", "--device", "cpu"])
        finally:
            telemetry.set_registry(prev)
            flight_recorder.uninstall()
        files = crash_files(tel)
        assert len(files) == 1
        dump = json.load(open(files[0]))
        assert dump["exception"]["message"] == "disk on fire"
        assert any(e["event"] == "solve" for e in dump["events"])
        assert dump["metrics"]["kafka_engine_device_reads_total"] >= 1
        assert "device_forensics" not in dump


class TestHooks:
    def test_install_uninstall_restores_hooks(self, tmp_path):
        flight_recorder.uninstall()  # a driver run earlier may have one
        prev_hook = sys.excepthook
        prev_term = signal.getsignal(signal.SIGTERM)
        rec = flight_recorder.install(str(tmp_path))
        try:
            assert signal.getsignal(signal.SIGTERM) == rec._on_signal
            assert flight_recorder.install("/elsewhere") is rec
            assert rec.directory == "/elsewhere"
        finally:
            flight_recorder.uninstall()
        assert sys.excepthook is prev_hook
        assert signal.getsignal(signal.SIGTERM) == prev_term
        assert flight_recorder.active_recorder() is None

    def test_sigterm_dumps_and_chains_previous_handler(self, tmp_path):
        hits = []
        prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
        try:
            with telemetry.use(MetricsRegistry()):
                rec = FlightRecorder(str(tmp_path)).install()
                try:
                    signal.raise_signal(signal.SIGTERM)
                finally:
                    rec.uninstall()
        finally:
            signal.signal(signal.SIGTERM, prev)
        files = crash_files(tmp_path)
        assert json.load(open(files[0]))["reason"] == "sigterm"
        assert hits == [signal.SIGTERM]


class TestUnhealthyProbeTrigger:
    def test_unhealthy_probe_verdict_dumps(self, tmp_path, monkeypatch):
        from kafka_tpu_torch.telemetry import health

        monkeypatch.setattr(health, "HEALTHY_HOST_MS", -1.0)
        with telemetry.use(MetricsRegistry()):
            rec = FlightRecorder(str(tmp_path))
            monkeypatch.setattr(flight_recorder, "_active", rec)
            verdict = health.probe_health(retry_wait_s=0.0)
        assert verdict["unhealthy"] and verdict["probe_retried"]
        dump = json.load(open(crash_files(tmp_path)[0]))
        assert dump["reason"] == "unhealthy_probe"
        assert [e for e in dump["events"] if e["event"] == "health_probe"]
        assert "kafka_health_probe_host_ms" in dump["metrics"]
