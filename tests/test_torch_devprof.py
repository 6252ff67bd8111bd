"""The port's device plane (``kafka_tpu_torch.telemetry.devprof``) against
the JAX package's: kernel-time attribution from profiler captures, the
CUDA memory ledger with OOM forensics, and mesh introspection.

A capture the port writes (``devprof.write_capture``: a Kineto Chrome
trace laid out as the JAX profiler lays its captures out, GPU tracks
named ``/device:GPU:<i>``) parses into the same kernel table in both
packages and is read by ``tools/device_report.py``; the JAX package's
checked-in capture parses the same in the port.  The rest mirrors
``tests/test_devprof.py`` on the port's own engine, on the CPU (where the
allocator census is empty and the device lane holds the outermost CPU
operators)."""

import datetime
import gzip
import json
import os
import shutil
import sys
import urllib.request

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from kafka_tpu.telemetry import devprof as jax_devprof  # noqa: E402
from kafka_tpu_torch import telemetry  # noqa: E402
from kafka_tpu_torch.resilience import faults  # noqa: E402
from kafka_tpu_torch.telemetry import (  # noqa: E402
    MetricsRegistry, devprof, perf,
)
from kafka_tpu_torch.telemetry.aggregate import stitch_traces  # noqa: E402

FIXTURE_CAPTURE = os.path.join(REPO_ROOT, "tests", "fixtures",
                               "devprof_capture")
FIXTURE_SESSION = os.path.join(FIXTURE_CAPTURE, "plugins", "profile",
                               "2026_08_07_00_00_00")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def day(i):
    return datetime.datetime(2021, 3, 1) + datetime.timedelta(days=i)


def run_identity_engine(telemetry_dir=None, scan_window=1, obs_every=2):
    """The JAX test's small identity-operator run on the port, CPU
    (``obs_every`` 4 puts one acquisition in each 4-day window, so
    ``scan_window`` > 1 fuses)."""
    from kafka_tpu_torch.core.propagators import (
        PixelPrior, propagate_information_filter_approx)
    from kafka_tpu_torch.engine import FixedGaussianPrior, KalmanFilter
    from kafka_tpu_torch.obsops import IdentityOperator
    from kafka_tpu_torch.testing import MemoryOutput, SyntheticObservations
    from kafka_tpu_torch.testing.fixtures import make_pivot_mask

    mask = make_pivot_mask(20, 20, seed=0)
    p = 2
    op = IdentityOperator(n_params=p, obs_indices=(0, 1))
    cov = np.diag(np.full(p, 0.4 ** 2)).astype(np.float32)
    prior = FixedGaussianPrior(PixelPrior(
        mean=torch.full((p,), 0.5), cov=torch.as_tensor(cov),
        inv_cov=torch.as_tensor(np.linalg.inv(cov))), ("a", "b"))
    truth = np.broadcast_to(np.array([0.3, 0.7], np.float32),
                            mask.shape + (2,)).astype(np.float32)
    with telemetry.use(MetricsRegistry(telemetry_dir)) as reg:
        obs = SyntheticObservations(
            dates=[day(i) for i in range(1, 16, obs_every)], operator=op,
            truth_fn=lambda d: truth, sigma=0.02, mask_prob=0.1, seed=0,
            device="cpu")
        out = MemoryOutput()
        kf = KalmanFilter(
            obs, out, mask, ("a", "b"),
            state_propagation=propagate_information_filter_approx,
            prior=None, solver_options={"relaxation": 0.5},
            scan_window=scan_window, prefetch_depth=0, device="cpu")
        kf.set_trajectory_model()
        kf.set_trajectory_uncertainty(np.full(p, 1e-3, np.float32))
        x0, p_inv0 = prior.process_prior(None, kf.gather)
        kf.run([day(i) for i in range(0, 20, 4)], x0, None, p_inv0)
    return kf, out, reg


def kineto_doc():
    """A Kineto-shaped Chrome trace: a host process with CPU ops and a
    user annotation, GPU 0's kernels, a memcpy and a memset on pid 0,
    an annotation range repeated on the GPU lane, and an NCCL kernel."""
    host = 4242
    ev = [
        {"ph": "M", "name": "process_name", "pid": host, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": host,
         "tid": 1, "ts": 10.0, "dur": 2.0, "args": {}},
        {"ph": "X", "cat": "user_annotation", "name": "kafka/assimilate",
         "pid": host, "tid": 1, "ts": 5.0, "dur": 3000.0, "args": {}},
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": "kafka/assimilate", "pid": 0, "tid": 7, "ts": 20.0,
         "dur": 2900.0, "args": {"device": 0}},
    ]
    for k, (name, cat, dur) in enumerate((
            ("fused_gn_kernel", "kernel", 1500.0),
            ("fused_gn_kernel", "kernel", 1300.0),
            ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 40.0),
            ("Memset (Device)", "gpu_memset", 3.0),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", 60.0),
            ("void at::native::vectorized_elementwise_kernel<4>", "kernel",
             97.0))):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                   "tid": 7, "ts": 1000.0 + 2000.0 * k, "dur": dur,
                   "args": {"device": 0, "stream": 7}})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def cpu_ops_doc():
    """A trace of host operators only: two outermost ops on thread 1
    (one with a child) and one on thread 2."""
    return {"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1,
         "tid": 1, "ts": 10.0, "dur": 80.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
         "tid": 1, "ts": 200.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1,
         "tid": 2, "ts": 50.0, "dur": 30.0},
    ]}


class TestCaptureParser:
    def test_fixture_parses_the_same_in_both_packages(self):
        """The JAX package's checked-in capture: the port's parser gives
        the JAX parser's kernel table."""
        assert devprof.parse_capture(FIXTURE_SESSION) == \
            jax_devprof.parse_capture(FIXTURE_SESSION)

    def test_written_capture_parses_the_same_in_both_packages(
            self, tmp_path):
        root = str(tmp_path / "profile")
        session = devprof.write_capture(kineto_doc(), root,
                                        epoch_unix_s=1700000000.0)
        assert devprof.find_capture_sessions(root) == [session]
        assert session.startswith(os.path.join(root, "plugins", "profile"))
        ours = devprof.parse_capture(session)
        assert ours == jax_devprof.parse_capture(session)
        names = [k["name"] for k in ours["kernels"]]
        assert names[0] == "fused_gn_kernel"
        assert ours["kernels"][0]["count"] == 2
        assert ours["kernels"][0]["ms"] == pytest.approx(2.8)
        # The annotation range on the GPU lane is dropped: device time
        # is the kernels', memcpy's and memset's, once.
        assert "kafka/assimilate" not in names
        assert ours["device_ms"] == pytest.approx(3.0)
        assert ours["by_bucket"] == {
            "collective": 0.06, "other": 2.9, "transfer": 0.04}
        assert ours["device_split"] == {"/device:GPU:0": 1.0}
        assert devprof.capture_epoch(session, stop_at=root) == \
            pytest.approx(1700000000.0)

    def test_device_report_reads_a_port_capture(self, tmp_path):
        from tools.device_report import build_report

        root = str(tmp_path / "tel")
        devprof.write_capture(kineto_doc(), os.path.join(root, "profile"))
        report = build_report(root)
        assert report["n_sessions"] == 1
        assert report["sessions"][0]["parseable"]
        assert report["sessions"][0]["kernels"][0]["name"] == \
            "fused_gn_kernel"

    def test_cpu_capture_lane_holds_outermost_ops(self, tmp_path):
        """A session that traced no CUDA activity (no card): the
        outermost cpu_op events become the ``/device:CPU:0`` lane, their
        children left out, and the sidecar says so."""
        session = devprof.write_capture(cpu_ops_doc(), str(tmp_path),
                                        cuda=False)
        table = devprof.parse_capture(session)
        assert {k["name"] for k in table["kernels"]} == {
            "aten::linear", "aten::add", "aten::mul"}
        assert table["device_ms"] == pytest.approx(0.15)
        assert table["device_split"] == {"/device:CPU:0": 1.0}
        assert jax_devprof.parse_capture(session) == table
        with open(tmp_path / devprof.CAPTURE_META) as f:
            assert json.load(f)["activities"] == ["CPU"]

    def test_cuda_capture_without_gpu_work_is_a_parse_failure(
            self, tmp_path):
        """A session that traced CUDA but caught no GPU work (the
        profiler set up off the main thread, say) has no device lane:
        its host operators are never read as kernels, and ingesting it
        counts a parse failure."""
        root = str(tmp_path / "profile")
        session = devprof.write_capture(cpu_ops_doc(), root, cuda=True)
        assert devprof.parse_capture(session) is None
        assert jax_devprof.parse_capture(session) is None
        with open(os.path.join(root, devprof.CAPTURE_META)) as f:
            assert json.load(f)["activities"] == ["CPU", "CUDA"]
        reg = MetricsRegistry()
        assert devprof.ingest_capture(root, registry=reg) is None
        assert reg.value("kafka_devprof_parse_failures_total") == 1
        assert devprof.kernel_summary(reg)["captures_parsed"] == 0

    def test_bucket_vocabulary(self):
        for name in ("loop_fusion.3", "all-reduce.7", "AllGather.1",
                     "copy-start.2", "dot.9", "Memcpy HtoD (Pinned)",
                     "fused_gn_kernel"):
            assert devprof.bucket_for(name) == jax_devprof.bucket_for(name)
        assert devprof.bucket_for("ncclDevKernel_Broadcast_RING") == \
            "collective"
        assert devprof.bucket_for("gloo:all_gather") == "collective"
        assert devprof.bucket_for("fused_update_kernel") == "other"
        assert devprof.bucket_for("solve_rows_kernel") == "other"

    def test_ingest_publishes_metrics_and_event(self, tmp_path):
        root = str(tmp_path / "profile")
        shutil.copytree(FIXTURE_CAPTURE, root)
        reg = MetricsRegistry()
        table = devprof.ingest_capture(root, registry=reg)
        assert table is not None
        assert reg.value("kafka_devprof_captures_parsed_total") == 1
        assert reg.value("kafka_devprof_kernel_ms_total",
                         bucket="fusion") == pytest.approx(6.0)
        assert reg.value("kafka_devprof_collective_fraction") == \
            pytest.approx(1.5 / 10.5, abs=1e-3)
        assert any(e["event"] == "devprof_capture_parsed"
                   for e in reg.events)
        ks = devprof.kernel_summary(reg, n=2)
        assert ks["captures_parsed"] == 1 and len(ks["kernels"]) == 2

    def test_malformed_capture_degrades_with_counted_event(self, tmp_path):
        sess = tmp_path / "plugins" / "profile" / "2026_01_01"
        sess.mkdir(parents=True)
        (sess / "bad.trace.json.gz").write_bytes(b"not gzip at all")
        reg = MetricsRegistry()
        assert devprof.ingest_capture(str(tmp_path), registry=reg) is None
        assert reg.value("kafka_devprof_parse_failures_total") == 1
        with gzip.open(sess / "bad.trace.json.gz", "wt") as f:
            json.dump({"traceEvents": []}, f)
        assert devprof.ingest_capture(str(tmp_path), registry=reg) is None
        assert reg.value("kafka_devprof_parse_failures_total") == 2

    def test_no_captures_at_all_is_a_counted_failure(self, tmp_path):
        reg = MetricsRegistry()
        assert devprof.ingest_capture(str(tmp_path / "nowhere"),
                                      registry=reg) is None
        assert reg.value("kafka_devprof_parse_failures_total") == 1

    def test_roofline_crosscheck_needs_both_sides(self):
        reg = MetricsRegistry()
        assert devprof.roofline_crosscheck(reg) is None
        perf.record_window({"wall_s": 0.001, "chi2_per_band": [1.0]},
                           n_valid=10, n_pad=16, n_params=2, n_bands=1,
                           registry=reg)
        assert devprof.roofline_crosscheck(reg) is None
        st = devprof._state_for(reg)
        with st.lock:
            st.device_ms = 10.5
            st.n_captures_parsed = 1
        rc = devprof.roofline_crosscheck(reg)
        assert rc["measured_device_ms"] == pytest.approx(10.5)
        # No operator: the packed path's row loop.
        assert rc["component"] == "gn_full_pallas"
        assert rc["measured_over_analytic"] > 0


class TestDeviceLaneStitching:
    def test_port_capture_joins_the_stitched_trace(self, tmp_path):
        root = str(tmp_path / "tel")
        os.makedirs(root)
        host = {"traceEvents": [
            {"name": "solve", "ph": "X", "ts": 100.0, "dur": 4e5,
             "pid": 7, "tid": 1, "args": {}}],
            "otherData": {"epoch_unix_s": 1700000000.0,
                          "run_ids": ["r1"]}}
        with open(os.path.join(root, "trace.json"), "w") as f:
            json.dump(host, f)
        devprof.write_capture(kineto_doc(), os.path.join(root, "profile"),
                              epoch_unix_s=1700000000.25)
        doc = stitch_traces(root)
        dev = [s for s in doc["otherData"]["sources"]
               if s.get("device_lane")]
        assert len(dev) == 1
        kernels = [e for e in doc["traceEvents"]
                   if e.get("pid") == dev[0]["pid"] and e.get("ph") == "X"]
        assert min(e["ts"] for e in kernels) == pytest.approx(250000.0,
                                                              abs=1.0)
        assert stitch_traces(root, request_id="req-1")["otherData"][
            "sources"] == [s for s in stitch_traces(
                root, request_id="req-1")["otherData"]["sources"]
                if not s.get("device_lane")]

    def test_device_lane_aligns_on_the_program_phase_spans(self, tmp_path):
        """A capture whose first kernel comes 300 ms after the capture
        started: pinned to the capture epoch, every kernel would land
        300 ms early; matched on its ``kafka/<phase>`` ranges, each
        kernel lands within 1 ms of the host span that launched it."""
        root = str(tmp_path / "tel")
        os.makedirs(root)
        # Host spans (TraceBuffer, us from the buffer epoch).
        spans = [("assimilate", 400_000.0, 200_000.0),
                 ("date_fetch", 410_000.0, 1_500.0),
                 ("linearize", 420_000.0, 30_000.0),
                 ("date_record", 560_000.0, 5_000.0),
                 ("dump", 650_000.0, 40_000.0)]
        host = {"traceEvents": [
            {"name": n, "cat": "phase", "ph": "X", "ts": ts, "dur": dur,
             "pid": 7, "tid": 1, "args": {}} for n, ts, dur in spans],
            "otherData": {"epoch_unix_s": 1700000000.0,
                          "run_ids": ["r1"]}}
        with open(os.path.join(root, "trace.json"), "w") as f:
            json.dump(host, f)
        # The capture started at host 100 ms, Kineto tick 5 s there; its
        # ranges read a few us off the buffer's, as two clocks do.
        def tick(host_us):
            return host_us - 100_000.0 + 5_000_000.0

        ev = [{"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
               "args": {"name": "python3"}},
              {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "GPU 0"}}]
        for k, (n, ts, dur) in enumerate(spans):
            ev.append({"ph": "X", "cat": "user_annotation",
                       "name": f"kafka/{n}", "pid": 4242, "tid": 1,
                       "ts": tick(ts) + 3.0 * (k % 2), "dur": dur - 2.0,
                       "args": {}})
        # One kernel a span, launched 20 us into it.
        for n, ts, _ in spans:
            ev.append({"ph": "X", "cat": "kernel", "name": f"k_{n}",
                       "pid": 0, "tid": 7, "ts": tick(ts) + 20.0,
                       "dur": 10.0, "args": {"device": 0}})
        devprof.write_capture({"traceEvents": ev}, os.path.join(
            root, "profile"), epoch_unix_s=1700000000.1)
        doc = stitch_traces(root)
        lane = [s["pid"] for s in doc["otherData"]["sources"]
                if s.get("device_lane")]
        kernels = {e["name"]: e["ts"] for e in doc["traceEvents"]
                   if e.get("pid") in lane and e.get("ph") == "X"}
        for n, ts, _ in spans:
            assert abs(kernels[f"k_{n}"] - (ts + 20.0)) < 1_000.0, n
        # The epoch pin alone puts the first kernel at the capture's
        # start, 300 ms before its span.
        pinned, _ = devprof.device_lane_tracks(root, 1700000000.0, 1)
        first = min(e["ts"] for e in pinned if e.get("ph") == "X")
        assert first == pytest.approx(100_000.0, abs=1.0)


class TestCaptureRetention:
    def test_prune_keeps_newest_n_and_counts_evictions(self, tmp_path):
        root = str(tmp_path / "profile")
        for i in range(5):
            d = os.path.join(root, f"2026010{i}T000000")
            sess = devprof.write_capture(kineto_doc(), d)
            os.utime(sess, (1700000000 + i, 1700000000 + i))
        reg = MetricsRegistry()
        assert perf.prune_captures(root, keep=2, registry=reg) == 3
        assert sorted(os.listdir(root)) == ["20260103T000000",
                                            "20260104T000000"]
        assert reg.value("kafka_perf_capture_evictions_total") == 3
        assert perf.prune_captures(root, keep=2, registry=reg) == 0


class TestMemoryLedger:
    def test_census_is_empty_without_cuda(self):
        assert devprof.buffer_census() == []
        assert devprof.memory_stats() == []

    def test_census_groups_active_allocator_blocks(self, monkeypatch):
        snapshot = [
            {"device": 0, "segment_type": "large", "blocks": [
                {"size": 1 << 21, "state": "active_allocated"},
                {"size": 1 << 21, "state": "active_allocated"},
                {"size": 1 << 20, "state": "inactive"}]},
            {"device": 0, "segment_type": "small", "blocks": [
                {"size": 512, "state": "active_allocated"},
                {"size": 512, "state": "active_pending_free"}]},
        ]
        monkeypatch.setattr(devprof, "_cuda_ready", lambda: True)
        monkeypatch.setattr(torch.cuda, "memory_snapshot",
                            lambda: snapshot)
        census = devprof.buffer_census()
        assert census == [
            {"device": 0, "pool": "large", "block_bytes": 1 << 21,
             "count": 2, "bytes": 1 << 22},
            {"device": 0, "pool": "small", "block_bytes": 512,
             "count": 2, "bytes": 1024}]
        reg = MetricsRegistry()
        devprof.update_ledger(reg, force=True)
        assert reg.value("kafka_devprof_live_buffer_bytes") == \
            (1 << 22) + 1024
        assert reg.value("kafka_devprof_live_buffers") == 4

    def test_is_oom_vocabulary(self):
        assert devprof.is_oom(faults.InjectedFault("device.oom", 1,
                                                   "fatal"))
        assert devprof.is_oom(torch.cuda.OutOfMemoryError("CUDA oom"))
        assert devprof.is_oom(RuntimeError(
            "CUDA out of memory. Tried to allocate 2.00 GiB"))
        assert not devprof.is_oom(RuntimeError("shape mismatch"))
        assert not devprof.is_oom(None)
        assert not devprof.is_oom(faults.InjectedFault(
            "io.read_band", 1, "transient"))

    def test_forensics_bundle_shape(self):
        bundle = devprof.forensics(MetricsRegistry())
        assert set(bundle) == {"buffer_census", "kernel_table", "memory"}
        assert jax_devprof.forensics(MetricsRegistry()).keys() == \
            bundle.keys()


class TestOOMForensics:
    def test_oom_chaos_run_dump_carries_forensics(self, tmp_path):
        from kafka_tpu_torch.telemetry.flight_recorder import FlightRecorder

        tel = str(tmp_path / "tel")
        faults.script("device.oom", "1")
        with pytest.raises(faults.InjectedFault) as ei:
            with telemetry.use(MetricsRegistry(tel)):
                with FlightRecorder(tel):
                    run_identity_engine()
        assert ei.value.site == "device.oom"
        dumps = [f for f in os.listdir(tel) if f.startswith("crash_")]
        assert len(dumps) == 1
        rec = json.load(open(os.path.join(tel, dumps[0])))
        assert set(rec["device_forensics"]) == {
            "buffer_census", "kernel_table", "memory"}

    def test_non_oom_crash_has_no_forensics(self, tmp_path):
        from kafka_tpu_torch.telemetry.flight_recorder import FlightRecorder

        tel = str(tmp_path / "tel")
        with telemetry.use(MetricsRegistry(tel)):
            FlightRecorder(tel).dump("exception",
                                     exc=ValueError("not an oom"))
        dumps = [f for f in os.listdir(tel) if f.startswith("crash_")]
        assert "device_forensics" not in json.load(
            open(os.path.join(tel, dumps[0])))


class TestMeshIntrospection:
    def test_mesh_summary_on_the_cpu(self):
        s = devprof.mesh_summary(MetricsRegistry())
        assert s["backend"] == "cpu" and s["n_devices"] == 1
        assert s["mesh"] is None and s["programs"] == {}

    def test_note_mesh_registers_the_pixel_mesh(self):
        from kafka_tpu_torch.shard.mesh import make_pixel_mesh

        reg = MetricsRegistry()
        devprof.note_mesh(make_pixel_mesh(["cpu"] * 4), registry=reg)
        mesh = devprof.mesh_summary(reg)["mesh"]
        assert mesh["axes"] == {"pixels": 4} and mesh["n_devices"] == 4
        assert devprof.summary(reg)["mesh"]["n_devices"] == 4

    def test_note_compiled_keeps_kernel_attributes(self):
        reg = MetricsRegistry()
        attrs = {"registers": 128, "local_bytes": 0,
                 "static_shared_bytes": 0, "threads": 256}
        devprof.note_compiled("fused_gn", attrs, registry=reg)
        assert devprof.mesh_summary(reg)["programs"] == {"fused_gn": attrs}

    def test_engine_mesh_path_registers_the_mesh(self):
        from kafka_tpu_torch.engine import KalmanFilter
        from kafka_tpu_torch.shard.mesh import make_pixel_mesh
        from kafka_tpu_torch.testing import MemoryOutput

        with telemetry.use(MetricsRegistry()) as reg:
            KalmanFilter(None, MemoryOutput(), np.ones((8, 8), bool),
                         ("a", "b"), mesh=make_pixel_mesh(["cpu"] * 2),
                         mesh_lane=8)
        assert devprof.mesh_summary(reg)["mesh"]["n_devices"] == 2


class TestEndpoints:
    def _get(self, url):
        with urllib.request.urlopen(url, timeout=30) as resp:
            return json.load(resp)

    def test_kernelz_and_meshz_live(self, tmp_path):
        from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd

        reg = MetricsRegistry()
        httpd = TelemetryHTTPd(port=0, registry=reg).start()
        try:
            kz = self._get(httpd.url + "/kernelz?json=1")
            assert kz["captures_parsed"] == 0 and kz["kernels"] == []
            devprof.write_capture(kineto_doc(), str(tmp_path))
            devprof.ingest_capture(str(tmp_path), registry=reg)
            kz = self._get(httpd.url + "/kernelz?json=1&n=1")
            assert kz["captures_parsed"] == 1
            assert kz["kernels"][0]["name"] == "fused_gn_kernel"
            mz = self._get(httpd.url + "/meshz?json=1")
            assert mz["device_time_split"] == {"/device:GPU:0": 1.0}
            sz = self._get(httpd.url + "/statusz")
            assert sz["devprof"]["top_kernel"]["name"] == "fused_gn_kernel"
        finally:
            httpd.close()


class TestAcceptance:
    def test_profile_windows_yields_device_lane_and_kernel_table(
            self, tmp_path):
        """run_synthetic --profile-windows on the CPU with the real
        torch.profiler: the capture parses (outermost CPU operators on
        the device lane), the stitched trace carries it beside the host
        spans, and tools/device_report.py reads it."""
        from kafka_tpu_torch.cli.run_synthetic import main
        from tools.device_report import build_report

        tel = str(tmp_path / "tel")
        with telemetry.use(MetricsRegistry()):
            main(["--operator", "identity", "--ny", "24", "--nx", "24",
                  "--days", "8", "--outdir", str(tmp_path / "out"),
                  "--telemetry-dir", tel, "--profile-windows", "2",
                  "--device", "cpu"])
            reg = telemetry.get_registry()
            assert reg.value("kafka_devprof_captures_parsed_total") == 1
            assert devprof.kernel_summary(reg)["kernels"]
        doc = stitch_traces(tel)
        assert any(s.get("device_lane") for s in doc["otherData"]["sources"])
        report = build_report(tel)
        assert report["sessions"][0]["kernels"]
        snap = [f for f in os.listdir(tel) if f.startswith("live_")]
        assert "devprof" in json.load(open(os.path.join(tel, snap[0])))
