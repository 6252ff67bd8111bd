"""The port's single-daemon serving layer (``kafka_tpu_torch.serve``,
``cli/kafka_serve.py``) against the JAX package's, on the CPU:

- request parsing, admission signals and the journal on the cases of
  tests/test_serve.py:116-240, in both packages;
- a journal and its responses written by one package replayed and read
  by the other;
- warm = cold bit for bit in the port, and every ``served_from``
  outcome (cold, cache, warm_noop, warm, cold_replay, smoothed_chain);
- the port's responses against the JAX package's for the same tile and
  requests: ``served_from``, ``windows_run``, ``n_pixels``,
  ``solver_health`` and the quality verdict equal, ``x_mean`` within
  the engine's budget;
- the in-process daemon's inbox round trip and idle exit, and one
  SIGTERM drain of the ``kafka_serve`` daemon in a subprocess.
"""

import datetime
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import kafka_tpu.serve as jax_serve
import kafka_tpu.telemetry as jax_telemetry
import kafka_tpu_torch.serve as port_serve
import kafka_tpu_torch.telemetry as port_telemetry
from kafka_tpu.resilience import faults as jax_faults
from kafka_tpu_torch.resilience import RetryPolicy, faults

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jax_serve, jax_telemetry),
            "torch": (port_serve, port_telemetry)}
FAST2 = RetryPolicy(max_attempts=2, base_delay=0.0, jitter=0.0)
DATES = port_serve.synthetic_dates(
    port_serve.synthetic.DEFAULT_BASE_DATE, 16, 2)
#: the engine parity budget on an analysis mean (tests/test_torch_engine.py)
X_MEAN_ATOL = 2e-3


def day(i):
    return datetime.datetime(2017, 7, 1) + datetime.timedelta(days=i)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# ---------------------------------------------------------------------------
# request parsing, admission, journal: the JAX cases in both packages
# ---------------------------------------------------------------------------

def test_parse_request_roundtrip(pkg):
    serve, _ = pkg
    req = serve.parse_request({"request_id": "r-1", "tile": "t",
                               "date": "2017-07-05", "deadline_s": 3.5})
    assert req.tile == "t" and req.date == day(4)
    assert req.deadline is not None and req.deadline_s == 3.5
    assert req.payload()["date"] == "2017-07-05T00:00:00"
    smoothed = serve.parse_request({"tile": "t", "date": "2017-07-05",
                                    "smoothed": True})
    assert smoothed.smoothed and smoothed.payload()["smoothed"] is True


def test_generated_id_and_default_deadline(pkg):
    serve, _ = pkg
    req = serve.parse_request({"tile": "t", "date": "2017-07-05"},
                              default_deadline_s=9.0)
    assert len(req.request_id) == 16 and req.deadline_s == 9.0


@pytest.mark.parametrize("payload", [
    "not a dict",
    {"tile": "t"},
    {"tile": "t", "date": "yesterday-ish"},
    {"date": "2017-07-05"},
    {"tile": "t", "date": "2017-07-05", "request_id": "../../etc"},
    {"tile": "t", "date": "2017-07-05", "deadline_s": -1},
    {"tile": "t", "date": "2017-07-05", "deadline_s": "soon"},
    {"tile": "t", "date": "2017-07-05", "smoothed": "yes"},
])
def test_bad_requests_raise(pkg, payload):
    serve, _ = pkg
    with pytest.raises(serve.BadRequest):
        serve.parse_request(payload)


def test_replayed_requests_have_no_live_deadline(pkg):
    serve, _ = pkg
    req = serve.parse_request(
        {"tile": "t", "date": "2017-07-05", "deadline_s": 0.001,
         "submitted_ts": 1.0}, replayed=True)
    assert req.deadline is None and req.submitted_ts == 1.0


@pytest.mark.parametrize("signal_name, policy, gauge, value, reason", [
    ("queue", {"max_queue_depth": 4}, None, None, "queue_full"),
    ("writer", {"max_writer_backlog": 10}, "kafka_io_writer_backlog", 11,
     "writer_backlog"),
    ("prefetch", {"max_prefetch_queue_depth": 8},
     "kafka_prefetch_queue_depth", 9, "prefetch_backlog"),
    ("unhealthy", {}, "kafka_health_unhealthy", 1.0, "unhealthy"),
    ("drift", {"shed_on_quality_drift": True}, "kafka_quality_drift_active",
     2, "quality_degraded"),
    ("disabled", {"max_writer_backlog": None,
                  "max_prefetch_queue_depth": None,
                  "shed_when_unhealthy": False},
     "kafka_io_writer_backlog", 1e9, None),
])
def test_admission_signals(pkg, signal_name, policy, gauge, value, reason):
    serve, telemetry = pkg
    with telemetry.use(telemetry.MetricsRegistry()) as reg:
        ctl = serve.AdmissionController(serve.AdmissionPolicy(**policy))
        assert ctl.decide(queue_depth=0) is None
        if gauge is None:
            assert ctl.decide(queue_depth=3) is None
            got = ctl.decide(queue_depth=4)
        else:
            reg.gauge(gauge, "").set(value)
            got = ctl.decide(queue_depth=0)
        assert got == reason
        if reason is not None:
            assert ctl.retry_after(reason) == 0.5
        assert ctl.retry_after("bad_request") is None


def test_journal_replay_skips_answered_and_dedupes(pkg, tmp_path):
    serve, _ = pkg
    j = serve.RequestJournal(str(tmp_path))
    j.record({"request_id": "a", "tile": "t", "date": "d"})
    j.record({"request_id": "b", "tile": "t", "date": "d"})
    j.record({"request_id": "a", "tile": "t", "date": "d"})
    j.respond("a", {"status": "ok"})
    assert [p["request_id"] for p in j.replay()] == ["b"]
    j.close()


def test_journal_torn_tail_is_skipped_with_event(pkg, tmp_path):
    serve, telemetry = pkg
    with telemetry.use(telemetry.MetricsRegistry()) as reg:
        j = serve.RequestJournal(str(tmp_path))
        j.record({"request_id": "a", "tile": "t", "date": "d"})
        with open(j.journal_path, "a") as f:
            f.write('{"request_id": "tor')
        assert [p["request_id"] for p in j.replay()] == ["a"]
        assert any(e["event"] == "journal_torn_line" for e in reg.events)
        j.close()


def test_journal_response_write_is_atomic(pkg, tmp_path):
    serve, _ = pkg
    j = serve.RequestJournal(str(tmp_path))
    j.respond("r", {"status": "ok", "n": 1})
    assert os.listdir(j.responses_dir) == ["r.json"]
    assert j.response("r")["n"] == 1
    assert j.response("missing") is None
    j.close()


def test_journal_compaction_keeps_pending_replayable(pkg, tmp_path):
    serve, _ = pkg
    j = serve.RequestJournal(str(tmp_path), rotate_bytes=200, keep=2)
    for k in range(8):
        j.record({"request_id": f"r{k}", "tile": "t", "date": "d" * 20})
        if k % 2 == 0:
            j.respond(f"r{k}", {"status": "ok"})
    assert [p["request_id"] for p in j.replay()] == \
        ["r1", "r3", "r5", "r7"]
    j.close()


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_journal_written_by_one_package_replays_in_the_other(tmp_path,
                                                             writer):
    reader = "torch" if writer == "jax" else "jax"
    w, r = PACKAGES[writer][0], PACKAGES[reader][0]
    j = w.RequestJournal(str(tmp_path))
    for rid in ("a", "b", "c"):
        j.record(w.parse_request({"request_id": rid, "tile": "t",
                                  "date": "2017-07-05"}).payload())
    j.respond("b", {"status": "ok", "x_sha256": "00"})
    j.close()
    k = r.RequestJournal(str(tmp_path))
    pending = [r.parse_request(p, replayed=True) for p in k.replay()]
    assert [p.request_id for p in pending] == ["a", "c"]
    assert all(p.date == day(4) for p in pending)
    assert k.response("b") == {"status": "ok", "x_sha256": "00"}
    assert r.read_response(str(tmp_path), "b")["x_sha256"] == "00"
    k.close()


# ---------------------------------------------------------------------------
# sessions: warm = cold, every served_from, the port against JAX
# ---------------------------------------------------------------------------

def _port_tile(path, **kw):
    return port_serve.TileSession(port_serve.make_synthetic_tile(
        "t", str(path), device="cpu", **kw))


def test_warm_serve_equals_a_cold_rerun_bit_for_bit(tmp_path):
    warm = _port_tile(tmp_path / "ck_warm")
    assert warm.serve(DATES[2])["served_from"] == "cold"
    r2 = warm.serve(DATES[6])
    assert r2["served_from"] == "warm"
    assert 0 < r2["windows_run"] < len(warm.spec.grid_through(DATES[6])) - 1
    cold = _port_tile(tmp_path / "ck_cold")
    rc = cold.serve(DATES[6])
    assert rc["served_from"] == "cold"
    assert r2["x_sha256"] == rc["x_sha256"]
    np.testing.assert_array_equal(warm.last_state[0], cold.last_state[0])
    np.testing.assert_array_equal(warm.last_state[1], cold.last_state[1])


@pytest.mark.parametrize("operator", ["identity", "twostream"])
def test_every_served_from_outcome(tmp_path, operator):
    sess = _port_tile(tmp_path / "ck", operator=operator)
    seen = [sess.serve(DATES[6])]
    seen.append(sess.serve(DATES[7]))
    before = sess.checkpointer.list_checkpoints()
    seen.append(sess.serve(DATES[2]))
    assert sess.checkpointer.list_checkpoints() == before
    seen.append(sess.serve(DATES[2], smoothed=True))
    assert [r["served_from"] for r in seen] == \
        ["cold", "warm_noop", "cold_replay", "smoothed_chain"]
    assert seen[1]["x_sha256"] == seen[0]["x_sha256"]
    assert seen[2]["x_sha256"] == _port_tile(
        tmp_path / "ck2", operator=operator).serve(DATES[2])["x_sha256"]
    assert seen[3]["windows_run"] == 0 and seen[3]["smoothed"] is True
    assert seen[3]["quality"]["verdict"] in ("CONSISTENT", "OVERCONFIDENT")
    with pytest.raises(port_serve.UnknownDateError):
        sess.serve(day(40))
    with pytest.raises(port_serve.UnknownDateError):
        sess.serve(DATES[7] + datetime.timedelta(days=8), smoothed=True)


def test_cache_and_warm_through_the_service(tmp_path):
    sess = _port_tile(tmp_path / "ck")
    svc = port_serve.AssimilationService({"t": sess}, str(tmp_path / "root"),
                                         retry_policy=FAST2)
    svc.start()
    try:
        got = {}
        for rid, d in (("a", DATES[2]), ("b", DATES[2]), ("c", DATES[6])):
            svc.submit({"request_id": rid, "tile": "t",
                        "date": d.isoformat()})
            got[rid] = svc.result(rid, timeout_s=120)
    finally:
        svc.close()
    assert [got[k]["served_from"] for k in "abc"] == \
        ["cold", "cache", "warm"]
    assert got["b"]["x_sha256"] == got["a"]["x_sha256"]
    trace = got["c"]["trace"]
    assert {"resume_ms", "solve_ms", "dump_ms", "queue_wait_ms"} <= \
        set(trace["phases"])


def test_responses_match_jax(tmp_path):
    """The same tile and requests through both packages' sessions."""
    kw = dict(operator="identity", ny=16, nx=20)
    port = port_serve.TileSession(port_serve.make_synthetic_tile(
        "t", str(tmp_path / "port"), device="cpu", **kw))
    ref = jax_serve.TileSession(jax_serve.make_synthetic_tile(
        "t", str(tmp_path / "jax"), **kw))
    for date, smoothed in ((DATES[2], False), (DATES[3], False),
                           (DATES[6], False), (DATES[0], False),
                           (DATES[2], True)):
        a = port.serve(date, smoothed=smoothed)
        b = ref.serve(date, smoothed=smoothed)
        for key in ("status", "served_from", "windows_run", "n_pixels",
                    "solver_health", "timestep", "windows_smoothed",
                    "rederived"):
            assert a.get(key) == b.get(key), (date, key)
        assert a["quality"]["verdict"] == b["quality"]["verdict"]
        np.testing.assert_allclose(a["x_mean"], b["x_mean"],
                                   atol=X_MEAN_ATOL)


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

class StubSession:
    def __init__(self, name="t"):
        self.name = name
        self.serves = 0

    def serve(self, date):
        self.serves += 1
        return {"status": "ok", "x_sha256": "stub",
                "date": date.isoformat()}


def test_daemon_inbox_roundtrip_and_idle_exit(tmp_path):
    with port_telemetry.use(port_telemetry.MetricsRegistry()):
        root = str(tmp_path)
        svc = port_serve.AssimilationService(
            {"t": StubSession()}, root,
            policy=port_serve.AdmissionPolicy(max_queue_depth=8),
            retry_policy=FAST2)
        rid = port_serve.submit_request(root, {"tile": "t",
                                               "date": "2017-07-05"})
        bad = port_serve.submit_request(root, {"tile": "nope",
                                               "date": "2017-07-05"})
        with open(os.path.join(root, "inbox", "garbage.json"), "w") as f:
            f.write("{not json")
        daemon = port_serve.ServeDaemon(svc, root, poll_interval_s=0.01,
                                        exit_when_idle=True,
                                        idle_grace_s=0.1)
        summary = daemon.run()
    assert summary["admitted"] == 1 and summary["rejected"] == 1
    assert port_serve.read_response(root, rid)["status"] == "ok"
    rejected = port_serve.read_response(root, bad)
    assert rejected["status"] == "rejected"
    assert rejected["reason"] == "unknown_tile"
    assert os.listdir(os.path.join(root, "inbox")) == []
    with open(os.path.join(root, "requests.jsonl")) as f:
        assert [json.loads(line)["request_id"] for line in f] == [rid]


def test_daemon_refuses_the_fleet_option(tmp_path):
    """Named for the refusal ``fleet_dir`` met before the device plane
    was ported; now a stale heartbeat without a final marker under
    ``fleet_dir`` counts as a dead host in ``kafka_fleet_dead_hosts``
    (the JAX daemon's gauge)."""
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    snap = {"schema": 1, "ts": time.time() - 3600, "host": "h", "pid": 1,
            "role": "serve", "seq": 3, "interval_s": 2.0, "final": False}
    (fleet / "live_h_1.json").write_text(json.dumps(snap))
    svc = port_serve.AssimilationService({"t": StubSession()},
                                         str(tmp_path))
    with port_telemetry.use(port_telemetry.MetricsRegistry()) as reg:
        daemon = port_serve.ServeDaemon(svc, str(tmp_path),
                                        fleet_dir=str(fleet))
        daemon._refresh_fleet_gauge()
        assert reg.value("kafka_fleet_dead_hosts") == 1
    svc.close()


def test_kafka_serve_cli_in_process(tmp_path, capsys):
    from kafka_tpu_torch.cli import kafka_serve

    root = str(tmp_path)
    # The inbox is read in name order: the forward serves come first.
    rids = [port_serve.submit_request(root, {
        "request_id": f"r{n}_tile{t}", "tile": f"tile{t}",
        "date": DATES[2].isoformat(), "smoothed": smoothed})
        for n, smoothed in enumerate((False, True)) for t in range(2)]
    with port_telemetry.use(port_telemetry.MetricsRegistry()):
        summary = kafka_serve.main([
            "--root", root, "--tiles", "2", "--ny", "16", "--nx", "20",
            "--exit-when-idle", "--idle-grace-s", "0.2", "--device", "cpu"])
    assert summary["admitted"] == 4 and summary["errors"] == 0
    aot = summary["serve_aot_buckets"]
    assert sum(len(b["tiles"]) for b in aot["buckets"]) == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        ["admitted"] == 4
    got = [port_serve.read_response(root, r)["served_from"] for r in rids]
    assert got == ["cold", "cold", "smoothed_chain", "smoothed_chain"]


@pytest.mark.parametrize("flag", [
    ["--http-port", "0"], ["--live-interval-s", "1"],
    ["--fleet-dir", "fleet"], ["--max-dead-hosts", "1"], ["--shed-slo"],
    ["--slo-fast-window-s", "60"], ["--slo-slow-window-s", "600"],
    ["--slo-interval-s", "2"], ["--compile-cache-dir", "cache"]])
def test_kafka_serve_refuses_unported_flags(tmp_path, monkeypatch, flag):
    """Named for the refusal these flags met before the device plane was
    ported; now each one runs the daemon: one request served, its
    telemetry dir holding the final live snapshot."""
    from kafka_tpu_torch.cli import kafka_serve
    from kafka_tpu_torch.core import _build

    # --compile-cache-dir re-points the build root: restore it after.
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)

    root, tel = str(tmp_path / "root"), str(tmp_path / "tel")
    flag = [str(tmp_path / v) if v in ("fleet", "cache") else v
            for v in flag]
    if flag[0] == "--http-port":
        flag = ["--http-port", str(_free_port())]
    port_serve.submit_request(root, {"request_id": "r0", "tile": "tile0",
                                     "date": DATES[1].isoformat()})
    with port_telemetry.use(port_telemetry.MetricsRegistry()):
        summary = kafka_serve.main([
            "--root", root, "--ny", "8", "--nx", "8", "--no-aot",
            "--exit-when-idle", "--idle-grace-s", "0.1", "--device", "cpu",
            "--telemetry-dir", tel, *flag])
    assert summary["admitted"] == 1 and summary["errors"] == 0
    assert port_serve.read_response(root, "r0")["status"] == "ok"
    snaps = [n for n in os.listdir(tel) if n.startswith("live_")]
    assert snaps and json.load(open(os.path.join(tel, snaps[0])))["final"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_kafka_serve_sigterm_drains(tmp_path):
    """SIGTERM: the admitted requests finish, a latecomer is answered
    ``rejected: draining``, the daemon exits 0."""
    root = tmp_path / "serve"
    root.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", faults.ENV_VAR)}
    env["PYTHONPATH"] = REPO_ROOT
    daemon = subprocess.Popen(
        [sys.executable, "-m", "kafka_tpu_torch.cli.kafka_serve",
         "--root", str(root), "--tiles", "2", "--operator", "identity",
         "--ny", "16", "--nx", "20", "--days", "40", "--step", "2",
         "--obs-every", "2", "--poll-interval-s", "0.02", "--device",
         "cpu"],
        env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    dates = port_serve.synthetic_dates(
        port_serve.synthetic.DEFAULT_BASE_DATE, 40, 2)
    try:
        r1 = port_serve.submit_request(str(root), {
            "tile": "tile0", "date": dates[-1].isoformat()})
        r2 = port_serve.submit_request(str(root), {
            "tile": "tile1", "date": dates[-1].isoformat()})
        journal = root / "requests.jsonl"
        deadline = time.time() + 120
        while time.time() < deadline:
            if daemon.poll() is not None:
                pytest.fail(f"daemon exited rc={daemon.returncode} "
                            "before SIGTERM")
            text = journal.read_text() if journal.exists() else ""
            if r1 in text and r2 in text and \
                    port_serve.read_response(str(root), r2) is None:
                break
            time.sleep(0.002)
        else:
            pytest.fail("daemon never admitted both requests")
        daemon.send_signal(signal.SIGTERM)
        r3 = port_serve.submit_request(str(root), {
            "tile": "tile0", "date": dates[0].isoformat()})
        out, _ = daemon.communicate(timeout=120)
    finally:
        if daemon.poll() is None:
            daemon.kill()
    assert daemon.returncode == 0
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["drained"] is True
    for rid in (r1, r2):
        got = port_serve.read_response(str(root), rid)
        assert got is not None and got["status"] == "ok", rid
    got3 = port_serve.read_response(str(root), r3)
    assert got3 is not None and got3["status"] == "rejected"
    assert got3["reason"] == "draining"


def test_make_synthetic_tile_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.make_synthetic_tile("t", str(tmp_path))
