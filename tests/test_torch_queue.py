"""The port's self-healing chunk queue (mirroring tests/test_queue.py):
lease-based claiming, heartbeats, crash-reclaim, SIGTERM drain and the
chaos acceptance tests, with ``kafka_tpu_torch.cli.run_synthetic`` on the
CPU as the worker:

(a) SIGKILL one of two local worker processes mid-chunk: the survivor
    reclaims the expired lease, every chunk reaches ``.done``, the
    survivor exits 0, and every output GeoTIFF is identical to a
    fault-free single-worker run;
(b) ``scheduler.commit@1:transient`` via ``KAFKA_TPU_FAULTS``: the
    double-execution (at-least-once) path converges to identical bytes;
(c) SIGTERM drain: the worker finishes its current chunk, releases
    leases, exits cleanly; ``queue_status`` reports the rest pending and
    a fresh worker finishes the run.

Then the queue directory across packages: the JAX package's
``queue_status`` and the unchanged ``tools/queue_status.py`` read a
directory the port wrote, and the port reads and finishes one the JAX
package wrote.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from kafka_tpu_torch import telemetry
from kafka_tpu_torch.io.tiling import get_chunks
from kafka_tpu_torch.resilience import POISON, RetryPolicy, faults
from kafka_tpu_torch.shard.queue import (
    DONE,
    FAILED,
    LEASE_EXPIRED,
    LEASED,
    PENDING,
    _Heartbeat,
    _try_claim,
    lease_path,
    queue_status,
    read_marker,
    run_queue,
    scan_chunk,
    write_manifest,
)
from kafka_tpu_torch.shard.scheduler import (
    failed_marker_path,
    mark_done,
    marker_path,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: zero-wait deterministic retry for tests.
FAST2 = RetryPolicy(max_attempts=2, base_delay=0.0, jitter=0.0)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def _chunks(n=4):
    return list(get_chunks(32 * n, 32, (32, 32)))[:n]


def _subprocess_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    return env


# ---------------------------------------------------------------------------
# lease mechanics
# ---------------------------------------------------------------------------

class TestLease:
    def test_claim_is_exclusive(self, tmp_path):
        d = str(tmp_path)
        assert _try_claim(d, "0001", "w1", 30.0) is not None
        assert _try_claim(d, "0001", "w2", 30.0) is None
        lease = read_marker(lease_path(d, "0001"))
        assert lease["owner"] == "w1" and lease["requeues"] == 0
        assert lease["deadline"] > time.time()
        # No tmp litter from either the winner or the loser.
        assert not [f for f in os.listdir(d) if ".tmp" in f]

    def test_scan_states(self, tmp_path):
        d = str(tmp_path)
        assert scan_chunk(d, "0001").state == PENDING
        _try_claim(d, "0001", "w1", 30.0)
        assert scan_chunk(d, "0001").state == LEASED
        # Expired: deadline in the past.
        _try_claim(d, "0002", "w1", -1.0)
        assert scan_chunk(d, "0002").state == LEASE_EXPIRED
        mark_done(d, "0003")
        assert scan_chunk(d, "0003").state == DONE

    def test_done_wins_over_stale_lease(self, tmp_path):
        d = str(tmp_path)
        _try_claim(d, "0001", "w1", 30.0)
        mark_done(d, "0001")
        s = scan_chunk(d, "0001", cleanup=True)
        assert s.state == DONE
        # The stale lease was garbage-collected on sight.
        assert not os.path.exists(lease_path(d, "0001"))

    def test_corrupt_lease_counts_expired(self, tmp_path):
        d = str(tmp_path)
        with open(lease_path(d, "0001"), "wb") as f:
            f.write(b"\x00torn")
        assert scan_chunk(d, "0001").state == LEASE_EXPIRED
        # ...and is therefore reclaimable.
        lease = _try_claim(d, "0001", "w2", 30.0, requeues=1, reclaim=True)
        assert lease is not None and lease["owner"] == "w2"

    def test_reclaim_replaces_expired_lease(self, tmp_path):
        d = str(tmp_path)
        _try_claim(d, "0001", "dead", 0.0)
        lease = _try_claim(d, "0001", "w2", 30.0, requeues=1, reclaim=True)
        assert lease["owner"] == "w2" and lease["requeues"] == 1
        assert read_marker(lease_path(d, "0001"))["owner"] == "w2"

    def test_heartbeat_renews_and_detects_loss(self, tmp_path):
        d = str(tmp_path)
        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            hb = _Heartbeat(d, "w1", 30.0, interval_s=1000.0)
            try:
                lease = _try_claim(d, "0001", "w1", 30.0)
                hb.watch(lease)
                before = read_marker(lease_path(d, "0001"))["deadline"]
                time.sleep(0.01)
                hb.beat()
                after = read_marker(lease_path(d, "0001"))["deadline"]
                assert after > before
                # Another worker steals the lease: the next beat must
                # notice, stop renewing, and record the takeover.
                os.unlink(lease_path(d, "0001"))
                _try_claim(d, "0001", "thief", 30.0)
                hb.beat()
                assert hb.lost.is_set()
                assert read_marker(
                    lease_path(d, "0001"))["owner"] == "thief"
                assert [e["event"] for e in reg.events] == ["lease_lost"]
            finally:
                hb.stop()

    def test_heartbeat_fault_is_survived(self, tmp_path):
        d = str(tmp_path)
        faults.script("scheduler.heartbeat", "1")
        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            hb = _Heartbeat(d, "w1", 30.0, interval_s=1000.0)
            try:
                lease = _try_claim(d, "0001", "w1", 30.0)
                hb.watch(lease)
                hb.beat()  # injected failure — recorded, not raised
                kinds = [e["event"] for e in reg.events]
                assert "heartbeat_failed" in kinds
                hb.beat()  # next beat renews normally
                assert read_marker(
                    lease_path(d, "0001"))["owner"] == "w1"
            finally:
                hb.stop()


# ---------------------------------------------------------------------------
# run_queue
# ---------------------------------------------------------------------------

class TestRunQueue:
    def test_single_worker_completes_all(self, tmp_path):
        d = str(tmp_path)
        chunks = _chunks(4)
        ran = []
        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            stats = run_queue(chunks, lambda c, p: ran.append(p), d,
                              lease_ttl_s=5.0)
            assert reg.value("kafka_shard_chunks_completed_total") == 4
            kinds = [e["event"] for e in reg.events]
            assert kinds.count("chunk_claimed") == 4
            assert kinds.count("chunk_done") == 4
        assert stats["run"] == 4 and stats["failed"] == 0
        assert stats["reclaimed"] == 0 and stats["pending_at_exit"] == 0
        assert sorted(ran) == ["0001", "0002", "0003", "0004"]
        for p in ran:
            assert os.path.exists(marker_path(d, p))
            assert not os.path.exists(lease_path(d, p))

    def test_restart_skips_done_and_failed(self, tmp_path):
        d = str(tmp_path)
        chunks = _chunks(4)
        mark_done(d, "0001")
        from kafka_tpu_torch.shard.scheduler import mark_failed

        mark_failed(d, "0002", {"failure_class": "poison"})
        ran = []
        stats = run_queue(chunks, lambda c, p: ran.append(p), d,
                          lease_ttl_s=5.0)
        assert sorted(ran) == ["0003", "0004"]
        assert stats["run"] == 2 and stats["skipped"] == 2

    def test_reclaims_dead_workers_lease(self, tmp_path):
        """A lease whose owner stopped heartbeating expires and is
        reclaimed: the chunk re-runs, the reclaim is counted and the
        per-chunk requeue count lands in telemetry."""
        d = str(tmp_path)
        chunks = _chunks(4)
        _try_claim(d, "0002", "deadhost:1", 0.1)
        time.sleep(0.15)
        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            stats = run_queue(chunks, lambda c, p: None, d,
                              lease_ttl_s=0.5, poll_interval_s=0.05)
            assert stats["run"] == 4 and stats["reclaimed"] == 1
            assert reg.value("kafka_scheduler_reclaims_total") == 1
            assert reg.value("kafka_scheduler_chunk_requeues_total",
                             prefix="0002") == 1
            reclaims = [e for e in reg.events
                        if e["event"] == "chunk_reclaimed"]
            assert len(reclaims) == 1
            assert reclaims[0]["prefix"] == "0002"
            assert reclaims[0]["prev_owner"] == "deadhost:1"
        assert os.path.exists(marker_path(d, "0002"))
        assert not os.path.exists(lease_path(d, "0002"))

    def test_waits_for_live_lease_then_reclaims(self, tmp_path):
        """A LIVE lease is respected (no premature steal); once the
        deadline passes without renewal the worker takes over."""
        d = str(tmp_path)
        chunks = _chunks(2)
        _try_claim(d, "0001", "slowhost:1", 0.4)
        t0 = time.time()
        stats = run_queue(chunks, lambda c, p: None, d,
                          lease_ttl_s=0.5, poll_interval_s=0.05)
        assert stats["run"] == 2 and stats["reclaimed"] == 1
        # It actually waited for the deadline instead of stealing.
        assert time.time() - t0 >= 0.3

    def test_poison_chunk_quarantined(self, tmp_path):
        d = str(tmp_path)
        chunks = _chunks(4)

        def run_one(chunk, prefix):
            if prefix == "0003":
                raise ValueError("poison pixel block")

        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            stats = run_queue(chunks, run_one, d, lease_ttl_s=5.0,
                              retry_policy=FAST2, quarantine=True)
            assert stats["run"] == 3 and stats["failed"] == 1
            assert reg.value("kafka_shard_chunks_failed_total") == 1
            kinds = [e["event"] for e in reg.events]
            assert kinds.count("chunk_quarantined") == 1
        payload = json.load(open(failed_marker_path(d, "0003")))
        assert payload["failure_class"] == POISON
        assert not os.path.exists(lease_path(d, "0003"))
        # All hosts honour the marker: a second worker skips it.
        stats2 = run_queue(chunks, run_one, d, lease_ttl_s=5.0,
                           quarantine=True)
        assert stats2["run"] == 0 and stats2["skipped"] == 4

    def test_fail_fast_releases_lease(self, tmp_path):
        d = str(tmp_path)
        chunks = _chunks(2)

        def run_one(chunk, prefix):
            raise ValueError("boom")

        with pytest.raises(ValueError, match="boom"):
            run_queue(chunks, run_one, d, lease_ttl_s=30.0)
        # The dying worker released its lease on the way out, so a
        # replacement need not wait for TTL expiry.
        assert not [f for f in os.listdir(d) if f.endswith(".lease")]

    def test_commit_fault_double_executes_to_identical_bytes(
            self, tmp_path):
        """``scheduler.commit`` transient failure: the retry re-runs the
        whole chunk — at-least-once — and the second completion
        overwrites the first's outputs with identical bytes."""
        d = str(tmp_path)
        chunks = _chunks(3)
        runs = []

        def run_one(chunk, prefix):
            runs.append(prefix)
            # Deterministic per-chunk output, atomically overwritten on
            # re-execution (same contract as the GeoTIFF writers).
            with open(os.path.join(d, f"out_{prefix}.bin"), "wb") as f:
                f.write((prefix * 100).encode())

        faults.script("scheduler.commit", "1")
        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            stats = run_queue(chunks, run_one, d, lease_ttl_s=5.0,
                              retry_policy=FAST2, quarantine=True)
            assert reg.value("kafka_resilience_retries_total",
                             site="scheduler.run_one") == 1
        assert stats["run"] == 3 and stats["failed"] == 0
        # One chunk executed twice (the commit fault), others once.
        assert len(runs) == 4 and len(set(runs)) == 3
        doubled = [p for p in set(runs) if runs.count(p) == 2][0]
        data = open(os.path.join(d, f"out_{doubled}.bin"), "rb").read()
        assert data == (doubled * 100).encode()
        for p in ("0001", "0002", "0003"):
            assert os.path.exists(marker_path(d, p))

    def test_claim_fault_is_survivable(self, tmp_path):
        d = str(tmp_path)
        chunks = _chunks(2)
        faults.script("scheduler.claim", "1")
        stats = run_queue(chunks, lambda c, p: None, d, lease_ttl_s=5.0,
                          poll_interval_s=0.05)
        assert stats["run"] == 2 and stats["claim_errors"] == 1

    def test_max_requeues_quarantines_crash_looper(self, tmp_path):
        """A chunk that keeps killing its workers must not be reclaimed
        forever: past the requeue budget it is quarantined."""
        d = str(tmp_path)
        chunks = _chunks(2)
        # A lease that already burned 3 requeues, expired again.
        _try_claim(d, "0001", "deadhost:1", 0.0, requeues=3)
        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            stats = run_queue(chunks, lambda c, p: None, d,
                              lease_ttl_s=0.3, poll_interval_s=0.05,
                              quarantine=True, max_requeues=3)
            kinds = [e["event"] for e in reg.events]
            assert "chunk_quarantined" in kinds
        assert stats["failed"] == 1 and stats["run"] == 1
        payload = json.load(open(failed_marker_path(d, "0001")))
        assert "requeue budget" in payload["error"]

    def test_sigterm_drains_gracefully(self, tmp_path):
        """(c) first SIGTERM: finish the current chunk, commit it,
        release everything, exit cleanly; the remaining chunks stay
        pending for the next worker."""
        d = str(tmp_path)
        chunks = _chunks(4)
        ran = []

        def run_one(chunk, prefix):
            if not ran:
                os.kill(os.getpid(), signal.SIGTERM)
            ran.append(prefix)

        prev = signal.getsignal(signal.SIGTERM)
        with telemetry.use(telemetry.MetricsRegistry()) as reg:
            stats = run_queue(chunks, run_one, d, lease_ttl_s=5.0)
            assert "worker_drain" in [e["event"] for e in reg.events]
        # Handler chain restored after the drain.
        assert signal.getsignal(signal.SIGTERM) == prev
        assert stats["drained"] is True
        assert stats["run"] == 1 and len(ran) == 1
        # The drained worker's chunk committed; the rest are PENDING
        # with no leases held.
        status = queue_status(d)
        assert status["counts"]["done"] == 1
        assert status["counts"]["pending"] == 3
        assert status["counts"]["leased"] == 0
        # A fresh worker finishes the run.
        stats2 = run_queue(chunks, lambda c, p: ran.append(p), d,
                           lease_ttl_s=5.0)
        assert stats2["run"] == 3 and stats2["pending_at_exit"] == 0
        assert queue_status(d)["counts"]["done"] == 4


# ---------------------------------------------------------------------------
# queue_status + tools/queue_status.py
# ---------------------------------------------------------------------------

class TestQueueStatus:
    def _mixed_dir(self, tmp_path):
        d = str(tmp_path)
        chunks = _chunks(5)
        write_manifest(d, chunks)
        mark_done(d, "0001")
        from kafka_tpu_torch.shard.scheduler import mark_failed

        mark_failed(d, "0002", {"failure_class": "poison"})
        _try_claim(d, "0003", "alive:1", 60.0)
        _try_claim(d, "0004", "dead:9", 0.0)
        return d

    def test_counts_and_ownership(self, tmp_path):
        d = self._mixed_dir(tmp_path)
        status = queue_status(d)
        assert status["manifest"] and status["n_chunks"] == 5
        assert status["counts"] == {
            PENDING: 1, LEASED: 1, LEASE_EXPIRED: 1, DONE: 1, FAILED: 1,
        }
        assert status["workers"]["alive:1"]["live"] == ["0003"]
        assert status["workers"]["dead:9"]["expired"] == ["0004"]
        assert status["chunks"]["0005"]["state"] == PENDING

    def test_no_manifest_falls_back_to_markers(self, tmp_path):
        d = str(tmp_path)
        mark_done(d, "0001")
        _try_claim(d, "0002", "w", 60.0)
        status = queue_status(d)
        assert not status["manifest"]
        assert status["n_chunks"] == 2
        assert status["counts"][DONE] == 1
        assert status["counts"][LEASED] == 1

    def test_status_is_read_only(self, tmp_path):
        d = str(tmp_path)
        _try_claim(d, "0001", "w1", 60.0)
        mark_done(d, "0001")  # stale lease next to .done
        queue_status(d)
        assert os.path.exists(lease_path(d, "0001"))  # NOT cleaned

    def test_cli_smoke(self, tmp_path, capsys):
        from tools.queue_status import main

        d = self._mixed_dir(tmp_path)
        assert main([d]) == 0
        out = capsys.readouterr().out
        assert "done            1" in out
        assert "alive:1" in out and "dead:9" in out
        assert main([d, "--json"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["counts"]["done"] == 1
        assert payload["n_chunks"] == 5

    def test_cli_missing_dir(self, tmp_path, capsys):
        from tools.queue_status import main

        assert main([str(tmp_path / "nope")]) == 2


# ---------------------------------------------------------------------------
# end-to-end chaos acceptance: run_synthetic --queue
# ---------------------------------------------------------------------------

def _synthetic_args(outdir, tel_dir=None, extra=()):
    args = [
        "--operator", "identity", "--outdir", str(outdir),
        "--ny", "48", "--nx", "48", "--days", "8", "--step", "4",
        "--obs-every", "2", "--chunk-size", "16",
        "--retry-delay-s", "0.01", "--queue", "--num-workers", "1",
        "--device", "cpu",
    ]
    if tel_dir is not None:
        args += ["--telemetry-dir", str(tel_dir)]
    return args + list(extra)


def _tif_map(outdir):
    return sorted(f for f in os.listdir(outdir) if f.endswith(".tif"))


def _assert_outputs_identical(ref_dir, got_dir):
    from kafka_tpu_torch.io import read_geotiff

    ref_files = _tif_map(ref_dir)
    got_files = _tif_map(got_dir)
    assert ref_files == got_files and ref_files
    for fn in ref_files:
        a, _ = read_geotiff(os.path.join(str(ref_dir), fn))
        b, _ = read_geotiff(os.path.join(str(got_dir), fn))
        np.testing.assert_array_equal(a, b, err_msg=fn)


class TestSyntheticQueueChaos:
    def _reference_run(self, tmp_path, monkeypatch):
        """Fault-free single-worker queue run (in-process)."""
        from kafka_tpu_torch.cli.run_synthetic import main

        monkeypatch.delenv(faults.ENV_VAR, raising=False)
        faults.reset()
        ref = main(_synthetic_args(tmp_path / "ref"))
        assert ref["failed"] == 0 and ref["pending"] == 0
        assert ref["chunks_run"] == 9
        return ref

    def test_chaos_sigkill_worker_survivor_reclaims(
            self, tmp_path, monkeypatch):
        """(a) Two local worker processes; one is SIGKILLed mid-chunk.
        The survivor reclaims the expired lease, all chunks reach .done,
        the survivor exits 0, and every output GeoTIFF equals the
        fault-free single-worker run."""
        self._reference_run(tmp_path, monkeypatch)
        outdir = tmp_path / "chaos"
        cmd = [sys.executable, "-m", "kafka_tpu_torch.cli.run_synthetic",
               *_synthetic_args(outdir, extra=["--lease-ttl-s", "1.0"])]
        env = _subprocess_env()
        env.pop(faults.ENV_VAR, None)

        # Empty-mask chunks commit in milliseconds; a lease on a
        # NON-empty chunk lives for the whole solve, so killing at that
        # sighting is reliably mid-chunk.
        from kafka_tpu_torch.io.tiling import chunk_mask
        from kafka_tpu_torch.testing.fixtures import make_pivot_mask

        mask = make_pivot_mask(48, 48)
        slow_leases = {
            f".chunk_{c.chunk_no:04x}.lease"
            for c in get_chunks(48, 48, (16, 16))
            if chunk_mask(mask, c).any()
        }
        assert slow_leases

        victim = subprocess.Popen(
            cmd, env=env, cwd=REPO_ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        try:
            deadline = time.time() + 120
            while time.time() < deadline:
                if victim.poll() is not None:
                    pytest.fail(
                        f"victim exited rc={victim.returncode} before "
                        "it could be killed"
                    )
                names = set(
                    os.listdir(outdir) if os.path.isdir(outdir) else ()
                )
                if names & slow_leases:
                    break
                time.sleep(0.02)
            else:
                pytest.fail("victim never claimed a non-empty chunk")
            victim.kill()
            victim.wait(timeout=30)
        finally:
            if victim.poll() is None:
                victim.kill()

        orphaned = [
            n for n in os.listdir(outdir) if n.endswith(".lease")
            and not os.path.exists(
                os.path.join(outdir, n.replace(".lease", ".done")))
        ]
        assert orphaned, "SIGKILL must strand the victim's lease"

        tel = tmp_path / "tel_survivor"
        survivor = subprocess.run(
            [sys.executable, "-m", "kafka_tpu_torch.cli.run_synthetic",
             *_synthetic_args(outdir, tel_dir=tel,
                              extra=["--lease-ttl-s", "1.0"])],
            env=env, cwd=REPO_ROOT, capture_output=True, text=True,
            timeout=300,
        )
        assert survivor.returncode == 0, survivor.stderr[-2000:]
        summary = json.loads(survivor.stdout.strip().splitlines()[-1])
        assert summary["failed"] == 0 and summary["pending"] == 0
        assert summary["reclaimed"] >= 1

        # Queue fully drained: 9/9 done, no leases left.
        status = queue_status(str(outdir))
        assert status["counts"]["done"] == 9
        assert status["counts"]["leased"] == 0
        assert status["counts"]["lease_expired"] == 0

        # The reclaim is in the survivor's forensic record.
        events = [json.loads(line)
                  for line in open(tel / "events.jsonl")]
        kinds = [e["event"] for e in events]
        assert "chunk_reclaimed" in kinds
        metrics = json.load(open(tel / "metrics.json"))
        series = metrics["kafka_scheduler_reclaims_total"]["series"]
        assert series and series[0]["value"] >= 1

        # At-least-once safety: outputs identical to the fault-free run
        # even though the killed worker half-ran (and the survivor
        # re-ran) some chunks.
        _assert_outputs_identical(tmp_path / "ref", outdir)

    def test_chaos_commit_fault_converges_bit_identical(
            self, tmp_path, monkeypatch):
        """(b) scheduler.commit@1:transient via KAFKA_TPU_FAULTS: the
        first chunk executes twice (at-least-once) and the final outputs
        are identical to the fault-free run."""
        from kafka_tpu_torch.cli.run_synthetic import main

        self._reference_run(tmp_path, monkeypatch)
        monkeypatch.setenv(faults.ENV_VAR, "scheduler.commit@1:transient")
        faults.reset()
        tel = tmp_path / "tel_commit"
        chaos = main(_synthetic_args(tmp_path / "chaos", tel_dir=tel,
                                     extra=["--chunk-attempts", "2"]))
        assert chaos["failed"] == 0 and chaos["pending"] == 0
        assert chaos["chunks_run"] == 9
        events = [json.loads(line) for line in open(tel / "events.jsonl")]
        kinds = [e["event"] for e in events]
        assert "fault_injected" in kinds and "retry" in kinds
        injected = [e for e in events if e["event"] == "fault_injected"]
        assert injected[0]["site"] == "scheduler.commit"
        _assert_outputs_identical(tmp_path / "ref", tmp_path / "chaos")

    def test_chaos_sigterm_drain_subprocess(self, tmp_path, monkeypatch):
        """(c) SIGTERM mid-run: the worker drains (finishes its chunk,
        releases leases, exits 0), queue_status reports the remainder
        pending, and a fresh worker finishes the run."""
        from kafka_tpu_torch.cli.run_synthetic import main

        outdir = tmp_path / "drain"
        env = _subprocess_env()
        env.pop(faults.ENV_VAR, None)
        worker = subprocess.Popen(
            [sys.executable, "-m", "kafka_tpu_torch.cli.run_synthetic",
             *_synthetic_args(outdir)],
            env=env, cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        try:
            deadline = time.time() + 120
            while time.time() < deadline:
                if worker.poll() is not None:
                    pytest.fail(
                        f"worker exited rc={worker.returncode} before "
                        "SIGTERM"
                    )
                names = (os.listdir(outdir)
                         if os.path.isdir(outdir) else [])
                if any(n.endswith(".lease") for n in names):
                    break
                time.sleep(0.02)
            else:
                pytest.fail("worker never claimed a lease")
            worker.send_signal(signal.SIGTERM)
            out, _ = worker.communicate(timeout=300)
        finally:
            if worker.poll() is None:
                worker.kill()
        # Clean exit, not a crash: drained with the current chunk done.
        assert worker.returncode == 0
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["drained"] is True
        assert summary["failed"] == 0
        assert summary["chunks_run"] >= 1
        assert summary["pending"] == 9 - summary["chunks_run"]

        status = queue_status(str(outdir))
        assert status["counts"]["leased"] == 0
        assert status["counts"]["lease_expired"] == 0
        assert status["counts"]["pending"] == summary["pending"]
        assert status["counts"]["done"] == summary["chunks_run"]

        # A fresh worker (in-process) finishes the run.
        monkeypatch.delenv(faults.ENV_VAR, raising=False)
        faults.reset()
        finish = main(_synthetic_args(outdir))
        assert finish["failed"] == 0 and finish["pending"] == 0
        assert queue_status(str(outdir))["counts"]["done"] == 9


# ---------------------------------------------------------------------------
# one queue directory, two packages
# ---------------------------------------------------------------------------

def _mixed(d, claim, done, failed, manifest, chunks):
    """A queue directory in every state: done, failed, live lease,
    expired lease, pending."""
    manifest(d, chunks)
    done(d, "0001")
    failed(d, "0002", {"failure_class": "poison"})
    claim(d, "0003", "alive:1", 60.0)
    claim(d, "0004", "dead:9", 0.0)


def _comparable(status):
    return {k: v for k, v in status.items() if k != "chunks"}, {
        p: {k: v for k, v in c.items() if k != "deadline_in_s"}
        for p, c in status["chunks"].items()}


def test_jax_package_reads_a_port_queue(tmp_path):
    """A directory the port wrote: the JAX package's ``queue_status``
    gives the port's counts, ownership and states."""
    from kafka_tpu.shard.queue import queue_status as jax_status

    from kafka_tpu_torch.shard.scheduler import mark_failed

    d = str(tmp_path)
    _mixed(d, _try_claim, mark_done, mark_failed, write_manifest,
           _chunks(5))
    now = time.time()
    assert _comparable(jax_status(d, now=now)) == \
        _comparable(queue_status(d, now=now))
    assert jax_status(d)["counts"] == {
        PENDING: 1, LEASED: 1, LEASE_EXPIRED: 1, DONE: 1, FAILED: 1}


def test_port_reads_and_finishes_a_jax_queue(tmp_path):
    """A directory the JAX package wrote: the port reads the same state,
    then finishes it — reclaiming the dead worker's lease, honouring the
    quarantine and the live lease's holder until it expires — and the
    JAX package reads the result."""
    from kafka_tpu.io.tiling import get_chunks as jchunks
    from kafka_tpu.shard.queue import _try_claim as jclaim
    from kafka_tpu.shard.queue import queue_status as jax_status
    from kafka_tpu.shard.queue import write_manifest as jmanifest
    from kafka_tpu.shard.scheduler import mark_done as jdone
    from kafka_tpu.shard.scheduler import mark_failed as jfailed

    d = str(tmp_path)
    _mixed(d, jclaim, jdone, jfailed, jmanifest,
           list(jchunks(32 * 5, 32, (32, 32)))[:5])
    # The live lease expires soon: the port must wait for it, not steal.
    jclaim_path = lease_path(d, "0003")
    os.unlink(jclaim_path)
    jclaim(d, "0003", "alive:1", 0.4)
    now = time.time()
    assert _comparable(queue_status(d, now=now)) == \
        _comparable(jax_status(d, now=now))
    ran = []
    stats = run_queue(_chunks(5), lambda c, p: ran.append(p), d,
                      lease_ttl_s=0.5, poll_interval_s=0.05)
    assert sorted(ran) == ["0003", "0004", "0005"]
    assert stats["reclaimed"] == 2 and stats["skipped"] == 2
    final = jax_status(d)
    assert final["counts"][DONE] == 4 and final["counts"][FAILED] == 1
    assert not final["workers"]
