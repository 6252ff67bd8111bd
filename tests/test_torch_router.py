"""The port's fleet front door (``kafka_tpu_torch/serve/router.py`` and
``cli/kafka_route.py``) against tests/test_router.py and against the JAX
router itself, on the CPU:

- the stable hash (the JAX test's pinned digests), the ring's ownership,
  minimal movement on join and leave, the preference walk;
- the retry-after hints, the router journal's compaction and replay,
  the router mechanics over in-process stub replicas (forward, relay,
  shedding re-route, all-shedding rejection, router restart replay,
  draining, bad requests), the fleet watch on live snapshots (dead,
  the default TTL, shedding, failover and rebalance), warm migration
  over a shared checkpoint set, and the ``tools/fleet_status`` router
  view of a port router's status;
- across packages: the same ring owners for 30 tiles over 3 and 4
  replicas and the same movement on join and leave; a journal written by
  either package's router replayed by the other's; the same inbox
  sequence forwarded to the same replica inboxes by both routers;
- the chaos acceptance: three port replicas (``--device cpu``, the JAX
  test's 16 x 20 identity tiles) behind the port's ``kafka_route``, the
  tile0 owner SIGKILLed mid-request: flagged dead, the tile re-routed
  warm, no request lost, the answer bit-identical to an uninterrupted
  run's.

Every comparison is exact (host code: ids, digests, file contents).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from kafka_tpu import telemetry as jtelemetry
from kafka_tpu.serve import router as jrouter
from kafka_tpu_torch import telemetry
from kafka_tpu_torch.serve import (
    AdmissionController,
    AdmissionPolicy,
    AssimilationService,
    HashRing,
    RequestJournal,
    RoutePolicy,
    ServeDaemon,
    TileRouter,
    TileSession,
    make_synthetic_tile,
    read_response,
    stable_hash,
    submit_request,
    synthetic_dates,
)
from kafka_tpu_torch.serve.router import FleetWatch
from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE
from kafka_tpu_torch.telemetry import MetricsRegistry

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATES = synthetic_dates(DEFAULT_BASE_DATE, 16, 2)

TILES_30 = [f"tile{i}" for i in range(30)]


def _subprocess_env():
    from kafka_tpu_torch.resilience import faults

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    env["KAFKA_TPU_LIVE_INTERVAL_S"] = "0.2"
    env.pop(faults.ENV_VAR, None)
    return env


class StubSession:
    """Duck-typed tile session (no solve) for router-mechanics tests."""

    def __init__(self, name):
        self.name = name
        self.serves = 0

    def serve(self, date):
        self.serves += 1
        return {"status": "ok", "tile": self.name,
                "date": date.isoformat(), "x_sha256": f"stub-{self.name}"}


class StubFleet:
    """N in-process stub replicas of the port (daemon threads)."""

    def __init__(self, tmp_path, n=2, tiles=4, policies=None):
        self.roots = {}
        self.daemons = []
        self.threads = []
        for i in range(n):
            rid = f"rep{i}"
            root = str(tmp_path / rid)
            sessions = {f"tile{t}": StubSession(f"tile{t}")
                        for t in range(tiles)}
            policy = (policies or {}).get(
                rid, AdmissionPolicy(max_queue_depth=64)
            )
            svc = AssimilationService(sessions, root, policy=policy)
            d = ServeDaemon(svc, root, poll_interval_s=0.01)
            self.daemons.append(d)
            self.roots[rid] = root
            self.threads.append(threading.Thread(
                target=d.run, name=f"stub-{rid}", daemon=True,
            ))

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def stop(self):
        for d in self.daemons:
            d.drain()
        for t in self.threads:
            t.join(timeout=60)


def run_router(router):
    t = threading.Thread(target=router.run, name="router", daemon=True)
    t.start()
    return t


def wait_response(root, rid, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = read_response(root, rid)
        if got is not None:
            return got
        time.sleep(0.01)
    return None


# ---------------------------------------------------------------------------
# the stable hash + ring
# ---------------------------------------------------------------------------

class TestStableHash:
    def test_pinned_cross_process_values(self):
        """The JAX test's pinned digests (tests/test_router.py:142)."""
        assert stable_hash("tile0") == 18108283901022872304
        assert stable_hash("rep0#0") == 245196271913887815
        assert stable_hash("") == 16476032584258269876

    def test_distinct_and_64bit(self):
        vals = {stable_hash(t) for t in TILES_30}
        assert len(vals) == len(TILES_30)
        assert all(0 <= v < 2 ** 64 for v in vals)

    def test_equals_the_jax_hash(self):
        for text in TILES_30 + [f"rep{i}#{v}" for i in range(4)
                                for v in range(64)]:
            assert stable_hash(text) == jrouter.stable_hash(text)


class TestHashRing:
    def test_owner_deterministic_and_covering(self):
        ring = HashRing(["a", "b", "c"])
        asg = ring.assignments(TILES_30)
        assert sorted(sum(asg.values(), [])) == sorted(TILES_30)
        assert all(asg[r] for r in ("a", "b", "c"))
        ring2 = HashRing(["c", "a", "b"])  # insertion order irrelevant
        assert {t: ring2.owner(t) for t in TILES_30} == \
            {t: ring.owner(t) for t in TILES_30}

    def test_join_moves_only_the_new_replicas_segments(self):
        ring = HashRing(["a", "b"])
        before = {t: ring.owner(t) for t in TILES_30}
        ring.add("c")
        after = {t: ring.owner(t) for t in TILES_30}
        moved = [t for t in TILES_30 if before[t] != after[t]]
        assert moved, "join moved nothing — ring is degenerate"
        assert all(after[t] == "c" for t in moved)
        assert len(moved) < len(TILES_30) / 2

    def test_leave_restores_previous_ownership_exactly(self):
        ring = HashRing(["a", "b"])
        before = {t: ring.owner(t) for t in TILES_30}
        ring.add("c")
        ring.remove("c")
        assert {t: ring.owner(t) for t in TILES_30} == before

    def test_preference_walk_and_exclude(self):
        ring = HashRing(["a", "b", "c"])
        for t in TILES_30:
            pref = ring.preference(t)
            assert sorted(pref) == ["a", "b", "c"]
            assert ring.owner(t) == pref[0]
            assert ring.owner(t, exclude=[pref[0]]) == pref[1]
            assert ring.owner(t, exclude=pref) is None

    def test_empty_ring(self):
        ring = HashRing()
        assert ring.owner("tile0") is None
        assert ring.preference("tile0") == []


class TestRingAgainstJax:
    @pytest.mark.parametrize("n", [3, 4])
    def test_same_owners_and_preferences(self, n):
        reps = [f"rep{i}" for i in range(n)]
        port, ref = HashRing(reps), jrouter.HashRing(reps)
        assert {t: port.preference(t) for t in TILES_30} == \
            {t: ref.preference(t) for t in TILES_30}
        assert port.assignments(TILES_30) == ref.assignments(TILES_30)

    @pytest.mark.parametrize("n", [3, 4])
    def test_same_movement_on_join_and_leave(self, n):
        reps = [f"rep{i}" for i in range(n)]
        port, ref = HashRing(reps), jrouter.HashRing(reps)
        for ring in (port, ref):
            ring.add("repX")
        assert {t: port.owner(t) for t in TILES_30} == \
            {t: ref.owner(t) for t in TILES_30}
        for ring in (port, ref):
            ring.remove("repX")
            ring.remove("rep0")
        assert {t: port.owner(t) for t in TILES_30} == \
            {t: ref.owner(t) for t in TILES_30}


# ---------------------------------------------------------------------------
# retry_after_s backoff hints
# ---------------------------------------------------------------------------

class TestRetryAfterHint:
    def test_load_state_rejections_carry_hint(self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            svc = AssimilationService(
                {"t": StubSession("t")}, str(tmp_path),
                policy=AdmissionPolicy(max_queue_depth=0,
                                       retry_after_s=1.25),
            )
            try:
                ack = svc.submit({"tile": "t", "date": "2017-07-05",
                                  "request_id": "r1"})
                assert ack["reason"] == "queue_full"
                assert ack["retry_after_s"] == 1.25
                assert svc.journal.response("r1")["retry_after_s"] \
                    == 1.25
                svc.stop_admitting()
                drained = svc.submit({"tile": "t",
                                      "date": "2017-07-05",
                                      "request_id": "r2"})
                assert drained["reason"] == "draining"
                assert drained["retry_after_s"] == 1.25
            finally:
                svc.close()

    def test_request_shaped_rejections_carry_no_hint(self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            svc = AssimilationService(
                {"t": StubSession("t")}, str(tmp_path),
            )
            try:
                bad = svc.submit({"tile": "t", "request_id": "rb"})
                assert bad["reason"] == "bad_request"
                assert "retry_after_s" not in bad
                unk = svc.submit({"tile": "nope", "date": "2017-07-05",
                                  "request_id": "ru"})
                assert unk["reason"] == "unknown_tile"
                assert "retry_after_s" not in unk
            finally:
                svc.close()

    def test_admission_controller_retry_after(self):
        ctl = AdmissionController(AdmissionPolicy(retry_after_s=0.75))
        assert ctl.retry_after("queue_full") == 0.75
        assert ctl.retry_after("fleet_degraded") == 0.75
        assert ctl.retry_after("draining") == 0.75
        assert ctl.retry_after("bad_request") is None
        assert ctl.retry_after("unknown_tile") is None


# ---------------------------------------------------------------------------
# journal compaction
# ---------------------------------------------------------------------------

class TestJournalCompaction:
    def _fill(self, j, n, answered=True, start=0):
        for i in range(start, start + n):
            rid = f"r{i:04d}"
            j.record({"request_id": rid, "tile": "t",
                      "date": "2017-07-05", "pad": "x" * 40})
            if answered:
                j.respond(rid, {"status": "ok"})

    def test_answered_entries_rotate_into_segments(self, tmp_path):
        with telemetry.use(MetricsRegistry()) as reg:
            j = RequestJournal(str(tmp_path), rotate_bytes=2000, keep=2)
            self._fill(j, 60, answered=True)
            names = sorted(n for n in os.listdir(tmp_path)
                           if n.startswith("requests.jsonl"))
            assert "requests.jsonl.1" in names
            assert "requests.jsonl.3" not in names
            assert os.path.getsize(j.journal_path) < 2000
            for n in names:
                with open(tmp_path / n) as f:
                    for line in f:
                        assert json.loads(line)["tile"] == "t"
            assert reg.value(
                "kafka_serve_journal_compactions_total") >= 1
            assert any(e["event"] == "journal_compacted"
                       for e in reg.events)
            j.close()

    def test_replay_correct_across_rotation_boundary(self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            j = RequestJournal(str(tmp_path), rotate_bytes=600, keep=3)
            pending = []
            for i in range(40):
                rid = f"r{i:04d}"
                j.record({"request_id": rid, "tile": "t",
                          "date": "2017-07-05", "pad": "x" * 30})
                if i % 5 == 0:
                    pending.append(rid)
                else:
                    j.respond(rid, {"status": "ok"})
            assert os.path.exists(str(tmp_path / "requests.jsonl.1"))
            j.close()
            j2 = RequestJournal(str(tmp_path))
            assert [p["request_id"] for p in j2.replay()] == pending
            j2.close()

    def test_compaction_never_rotates_pending_entries(self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            j = RequestJournal(str(tmp_path), rotate_bytes=400, keep=2)
            self._fill(j, 20, answered=False)
            assert not os.path.exists(
                str(tmp_path / "requests.jsonl.1"))
            assert len(j.replay()) == 20
            j.close()

    def test_no_rotation_without_cap(self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            j = RequestJournal(str(tmp_path))
            self._fill(j, 50, answered=True)
            assert sorted(
                n for n in os.listdir(tmp_path)
                if n.startswith("requests.jsonl")
            ) == ["requests.jsonl"]
            j.close()


# ---------------------------------------------------------------------------
# router mechanics (stub replicas)
# ---------------------------------------------------------------------------

class TestRouterMechanics:
    def test_forward_relay_and_ring_ownership(self, tmp_path):
        with telemetry.use(MetricsRegistry()) as reg:
            fleet = StubFleet(tmp_path, n=2, tiles=4).start()
            router = TileRouter(fleet.roots, str(tmp_path / "front"),
                                poll_interval_s=0.01)
            rt = run_router(router)
            try:
                rids = {}
                for t in range(4):
                    tile = f"tile{t}"
                    rids[tile] = submit_request(
                        str(tmp_path / "front"),
                        {"tile": tile, "date": "2017-07-05"},
                    )
                ring = HashRing(fleet.roots)
                for tile, rid in rids.items():
                    got = wait_response(str(tmp_path / "front"), rid)
                    assert got is not None and got["status"] == "ok"
                    assert got["replica"] == ring.owner(tile)
                    assert got["x_sha256"] == f"stub-{tile}"
                assert reg.value("kafka_route_relayed_total") == 4
                st = router.status()
                assert sorted(sum(st["router_ring"].values(), [])) == \
                    [f"tile{t}" for t in range(4)]
                assert st["router_inflight"] == 0
            finally:
                router.drain()
                rt.join(timeout=30)
                fleet.stop()

    def test_shedding_replica_rerouted_to_survivor(self, tmp_path):
        with telemetry.use(MetricsRegistry()) as reg:
            ring = HashRing(["rep0", "rep1"])
            asg = ring.assignments([f"tile{t}" for t in range(4)])
            tile = asg["rep0"][0] if asg["rep0"] else asg["rep1"][0]
            shedder = ring.owner(tile)
            fleet = StubFleet(
                tmp_path, n=2, tiles=4,
                policies={shedder: AdmissionPolicy(max_queue_depth=0)},
            ).start()
            router = TileRouter(fleet.roots, str(tmp_path / "front"),
                                poll_interval_s=0.01)
            rt = run_router(router)
            try:
                rid = submit_request(
                    str(tmp_path / "front"),
                    {"tile": tile, "date": "2017-07-05"},
                )
                got = wait_response(str(tmp_path / "front"), rid)
                assert got is not None and got["status"] == "ok"
                assert got["replica"] != shedder
                assert reg.value("kafka_route_rerouted_total",
                                 reason="rejected") >= 1
            finally:
                router.drain()
                rt.join(timeout=30)
                fleet.stop()

    def test_all_replicas_shedding_rejects_with_retry_after(
            self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            fleet = StubFleet(
                tmp_path, n=2, tiles=2,
                policies={
                    "rep0": AdmissionPolicy(max_queue_depth=0),
                    "rep1": AdmissionPolicy(max_queue_depth=0),
                },
            ).start()
            router = TileRouter(
                fleet.roots, str(tmp_path / "front"),
                policy=RoutePolicy(retry_after_s=0.9),
                poll_interval_s=0.01,
            )
            rt = run_router(router)
            try:
                rid = submit_request(
                    str(tmp_path / "front"),
                    {"tile": "tile0", "date": "2017-07-05"},
                )
                got = wait_response(str(tmp_path / "front"), rid)
                assert got is not None
                assert got["status"] == "rejected"
                assert got["reason"] == "fleet_degraded"
                assert got["retry_after_s"] == 0.9
            finally:
                router.drain()
                rt.join(timeout=30)
                fleet.stop()

    def test_router_restart_replays_unanswered(self, tmp_path):
        with telemetry.use(MetricsRegistry()) as reg:
            root0 = str(tmp_path / "rep0")
            front = str(tmp_path / "front")
            router1 = TileRouter({"rep0": root0}, front,
                                 poll_interval_s=0.01)
            ack = router1.submit({"tile": "tile0",
                                  "date": "2017-07-05",
                                  "request_id": "lost1"})
            assert ack["status"] == "queued"
            router1.journal.close()
            fleet = StubFleet(tmp_path, n=1, tiles=1).start()
            router2 = TileRouter(fleet.roots, front,
                                 poll_interval_s=0.01)
            rt = run_router(router2)
            try:
                got = wait_response(front, "lost1")
                assert got is not None and got["status"] == "ok"
                assert reg.value("kafka_route_replayed_total") == 1
            finally:
                router2.drain()
                rt.join(timeout=30)
                fleet.stop()

    def test_draining_router_rejects_with_hint(self, tmp_path):
        with telemetry.use(MetricsRegistry()):
            router = TileRouter({"rep0": str(tmp_path / "rep0")},
                                str(tmp_path / "front"))
            router.drain()
            ack = router.submit({"tile": "tile0",
                                 "date": "2017-07-05",
                                 "request_id": "late"})
            assert ack["status"] == "rejected"
            assert ack["reason"] == "draining"
            assert ack["retry_after_s"] == router.policy.retry_after_s
            router.journal.close()

    def test_bad_request_rejected_not_forwarded(self, tmp_path):
        with telemetry.use(MetricsRegistry()) as reg:
            router = TileRouter({"rep0": str(tmp_path / "rep0")},
                                str(tmp_path / "front"))
            ack = router.submit({"date": "2017-07-05",
                                 "request_id": "nob"})
            assert ack["status"] == "rejected"
            assert ack["reason"] == "bad_request"
            assert "retry_after_s" not in ack
            assert reg.value("kafka_route_rejected_total",
                             reason="bad_request") == 1
            assert router.journal.replay() == []
            router.journal.close()

    def test_metrics_vocabulary_matches_jax(self):
        """The nine kafka_route_* families with the JAX router's kinds,
        help strings and buckets, registered at one site."""
        from kafka_tpu_torch.serve.router import _route_metrics

        mine = _route_metrics(MetricsRegistry())
        ref = jrouter._route_metrics(jtelemetry.MetricsRegistry())
        assert sorted(mine) == sorted(ref) and len(mine) == 9

        def spec(m):
            return (m.name, m.kind, m.help, getattr(m, "buckets", None))

        for key in mine:
            assert spec(mine[key]) == spec(ref[key]), key


# ---------------------------------------------------------------------------
# across packages: journals and forwarding targets
# ---------------------------------------------------------------------------

def _inbox_targets(roots):
    """request id -> the replica whose inbox holds its forwarded file,
    with the forwarded payload."""
    out = {}
    for rid, root in roots.items():
        inbox = os.path.join(root, "inbox")
        for name in sorted(os.listdir(inbox)) if os.path.isdir(inbox) \
                else ():
            with open(os.path.join(inbox, name)) as f:
                payload = json.load(f)
            out[payload["request_id"]] = (rid, payload)
    return out


PLAN = [{"tile": f"tile{i % 7}", "date": DATES[i % 5].isoformat(),
         "request_id": f"q{i:03d}"} for i in range(20)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(tmp_path, writer):
    """A journal the one package's router wrote (no replica serving) is
    replayed by the other's: every unanswered request re-forwarded to
    its ring owner's inbox, with the same payload."""
    front = str(tmp_path / "front")
    roots_a = {f"rep{i}": str(tmp_path / "a" / f"rep{i}") for i in range(3)}
    roots_b = {f"rep{i}": str(tmp_path / "b" / f"rep{i}") for i in range(3)}
    routers = {"jax": jrouter.TileRouter, "port": TileRouter}
    reader = "port" if writer == "jax" else "jax"
    with jtelemetry.use(jtelemetry.MetricsRegistry()) as jreg, \
            telemetry.use(MetricsRegistry()) as treg:
        r1 = routers[writer](roots_a, front)
        for payload in PLAN:
            assert r1.submit(dict(payload))["status"] == "queued"
        r1.journal.close()
        r2 = routers[reader](roots_b, front)
        r2._replay()
        r2.journal.close()
        reg = treg if reader == "port" else jreg
        assert reg.value("kafka_route_replayed_total") == len(PLAN)
    sent, replayed = _inbox_targets(roots_a), _inbox_targets(roots_b)
    assert sorted(replayed) == [p["request_id"] for p in PLAN]
    ring = HashRing(roots_b)
    for payload in PLAN:
        rid = payload["request_id"]
        assert replayed[rid][0] == sent[rid][0] == \
            ring.owner(payload["tile"])
        for key in ("tile", "date", "request_id"):
            assert replayed[rid][1][key] == sent[rid][1][key] == \
                payload[key]


def test_same_inbox_sequence_same_forwarding_targets(tmp_path):
    """The same inbox files, scanned by either package's router, land in
    the same replica inboxes."""
    targets = {}
    for pkg, mod, tel in (("jax", jrouter, jtelemetry),
                          ("port", None, telemetry)):
        front = str(tmp_path / pkg / "front")
        roots = {f"rep{i}": str(tmp_path / pkg / f"rep{i}")
                 for i in range(4)}
        for payload in PLAN:
            submit_request(front, dict(payload))
        with tel.use(tel.MetricsRegistry()):
            router = (mod.TileRouter if mod else TileRouter)(roots, front)
            assert router._scan_inbox() == len(PLAN)
            router.journal.close()
        targets[pkg] = {rid: v[0]
                        for rid, v in _inbox_targets(roots).items()}
    assert len(targets["port"]) == len(PLAN)
    assert targets["port"] == targets["jax"]


# ---------------------------------------------------------------------------
# fleet watch: dead / shedding detection from live snapshots
# ---------------------------------------------------------------------------

def _write_snapshot(fleet_dir, host, pid, serve_root, ts, final=False,
                    interval_s=0.2, counters=None, gauges=None,
                    role="serve"):
    os.makedirs(fleet_dir, exist_ok=True)
    snap = {
        "schema": 1, "ts": ts, "host": host, "pid": pid, "role": role,
        "seq": 1, "interval_s": interval_s, "final": final,
        "run_id": None, "chunk_id": None,
        "health": {"unhealthy": None}, "quality": {}, "perf": {},
        "counters": counters or {}, "gauges": gauges or {},
        "histograms": {}, "series_truncated": 0, "crash_dumps": [],
        "status": {"serve_root": os.path.abspath(serve_root)},
    }
    path = os.path.join(fleet_dir, f"live_{host}_{pid}.json")
    with open(path, "w") as f:
        json.dump(snap, f)
    return snap


class TestFleetWatch:
    def test_stale_heartbeat_without_final_is_dead(self, tmp_path):
        fleet_dir = str(tmp_path / "tel")
        roots = {"rep0": str(tmp_path / "rep0"),
                 "rep1": str(tmp_path / "rep1"),
                 "rep2": str(tmp_path / "rep2")}
        now = time.time()
        _write_snapshot(fleet_dir, "h", 1, roots["rep0"], ts=now - 30)
        _write_snapshot(fleet_dir, "h", 2, roots["rep1"], ts=now)
        _write_snapshot(fleet_dir, "h", 3, roots["rep2"], ts=now - 30,
                        final=True)
        watch = FleetWatch(fleet_dir, roots, RoutePolicy(ttl_s=1.0))
        view = watch.refresh()
        assert view["rep0"]["dead"] is True
        assert view["rep1"]["dead"] is False
        assert view["rep2"]["dead"] is False
        assert view["rep2"]["final"] is True

    def test_default_ttl_is_three_heartbeats(self, tmp_path):
        fleet_dir = str(tmp_path / "tel")
        roots = {"rep0": str(tmp_path / "rep0")}
        now = time.time()
        _write_snapshot(fleet_dir, "h", 1, roots["rep0"], ts=now - 4,
                        interval_s=2.0)
        watch = FleetWatch(fleet_dir, roots, RoutePolicy())
        assert watch.refresh()["rep0"]["dead"] is False
        _write_snapshot(fleet_dir, "h", 1, roots["rep0"], ts=now - 7,
                        interval_s=2.0)
        assert watch.refresh()["rep0"]["dead"] is True

    def test_queue_full_counter_climb_marks_shedding(self, tmp_path):
        fleet_dir = str(tmp_path / "tel")
        roots = {"rep0": str(tmp_path / "rep0")}
        tag = 'kafka_serve_rejected_total{reason="queue_full"}'
        _write_snapshot(fleet_dir, "h", 1, roots["rep0"],
                        ts=time.time(), counters={tag: 2})
        watch = FleetWatch(fleet_dir, roots,
                           RoutePolicy(ttl_s=5.0, shed_backoff_s=30.0))
        watch.refresh()  # baseline
        assert watch.shedding("rep0") is False
        _write_snapshot(fleet_dir, "h", 1, roots["rep0"],
                        ts=time.time(), counters={tag: 5})
        watch.refresh()
        assert watch.shedding("rep0") is True

    def test_reads_the_ports_own_live_snapshots(self, tmp_path,
                                                monkeypatch):
        """A snapshot the port's LivePublisher wrote (a replica's
        ``serve_root`` status fact) is matched to its replica: alive
        while fresh, and not dead once final."""
        from kafka_tpu_torch.telemetry import live

        fleet_dir = str(tmp_path / "tel")
        os.makedirs(fleet_dir)
        roots = {"rep0": str(tmp_path / "rep0")}
        monkeypatch.setattr(live, "_status", {})
        with telemetry.use(MetricsRegistry()):
            live.update_status(serve_root=os.path.abspath(roots["rep0"]))
            pub = live.LivePublisher(fleet_dir, role="serve",
                                     interval_s=0.2)
            pub.publish_now()
            watch = FleetWatch(fleet_dir, roots, RoutePolicy(ttl_s=5.0))
            view = watch.refresh()
            assert (view["rep0"]["dead"], view["rep0"]["final"]) == \
                (False, False)
            pub.publish_now(final=True)
            assert watch.refresh()["rep0"]["final"] is True

    def test_dead_replica_triggers_failover_and_rebalance(
            self, tmp_path):
        with telemetry.use(MetricsRegistry()) as reg:
            fleet_dir = str(tmp_path / "tel")
            fleet = StubFleet(tmp_path, n=2, tiles=4).start()
            ring = HashRing(fleet.roots)
            tile = ring.assignments(
                [f"tile{t}" for t in range(4)])["rep0"][0]
            now = time.time()
            _write_snapshot(fleet_dir, "h", 10, fleet.roots["rep0"],
                            ts=now)
            _write_snapshot(fleet_dir, "h", 11, fleet.roots["rep1"],
                            ts=now)
            router = TileRouter(
                dict(fleet.roots), str(tmp_path / "front"),
                fleet_dir=fleet_dir,
                policy=RoutePolicy(ttl_s=1.0, refresh_s=0.05),
                poll_interval_s=0.01,
            )
            fleet.daemons[0].drain()
            fleet.threads[0].join(timeout=30)
            rt = run_router(router)
            try:
                rid = submit_request(
                    str(tmp_path / "front"),
                    {"tile": tile, "date": "2017-07-05"},
                )
                time.sleep(0.1)
                _write_snapshot(fleet_dir, "h", 10,
                                fleet.roots["rep0"], ts=now - 60)
                got = wait_response(str(tmp_path / "front"), rid,
                                    timeout_s=30)
                assert got is not None and got["status"] == "ok"
                assert got["replica"] == "rep1"
                assert reg.value("kafka_route_rerouted_total",
                                 reason="dead") >= 1
                assert reg.value("kafka_route_rebalanced_total") >= 1
                st = router.status()
                assert st["router_dead"] == ["rep0"]
                assert st["router_last_failover_ts"] is not None
                assert got["trace"]["reroutes"][0] == {
                    "reason": "dead", "replica": "rep0",
                    "held_ms": got["trace"]["reroutes"][0]["held_ms"]}
            finally:
                router.drain()
                rt.join(timeout=30)
                fleet.stop()


# ---------------------------------------------------------------------------
# warm-state replica migration (real solve)
# ---------------------------------------------------------------------------

class TestWarmMigration:
    def test_reassigned_tile_resumes_warm_and_bit_identical(
            self, tmp_path):
        """A tile re-assigned to a FRESH replica resumes from the shared
        checkpoint set: zero windows re-run for an already-answered date,
        and the continued chain is bit-identical to the original owner's
        uninterrupted run."""
        with telemetry.use(MetricsRegistry()):
            shared_ckpt = str(tmp_path / "ckpt_shared")

            def session(ckpt=shared_ckpt):
                return TileSession(make_synthetic_tile(
                    "t", ckpt, seed=0, device="cpu"))

            owner_a = session()
            r1 = owner_a.serve(DATES[0])
            r2 = owner_a.serve(DATES[3])
            assert r2["served_from"] == "warm"
            owner_b = session()
            noop = owner_b.serve(DATES[3])
            assert noop["served_from"] == "warm_noop"
            assert noop["windows_run"] == 0
            assert noop["x_sha256"] == r2["x_sha256"]
            cont = owner_b.serve(DATES[-1])
            assert cont["served_from"] == "warm"
            ref = session(str(tmp_path / "ckpt_ref"))
            ref.serve(DATES[0])
            ref.serve(DATES[3])
            ref_final = ref.serve(DATES[-1])
            assert cont["x_sha256"] == ref_final["x_sha256"]
            assert r1["x_sha256"] == session(
                str(tmp_path / "ckpt_cold")).serve(DATES[0])["x_sha256"]


# ---------------------------------------------------------------------------
# fleet_status router view
# ---------------------------------------------------------------------------

class TestFleetStatusRouterView:
    def _router_snapshot(self, fleet_dir, status=None):
        os.makedirs(fleet_dir, exist_ok=True)
        snap = {
            "schema": 1, "ts": time.time(), "host": "rhost", "pid": 77,
            "role": "route", "seq": 3, "interval_s": 2.0,
            "final": False, "run_id": None, "chunk_id": None,
            "health": {"unhealthy": None}, "quality": {}, "perf": {},
            "counters": {"kafka_route_relayed_total": 9},
            "gauges": {"kafka_route_inflight": 2},
            "histograms": {}, "series_truncated": 0, "crash_dumps": [],
            "status": status or {
                "router_root": "/front",
                "router_replicas": {"rep0": "/r0", "rep1": "/r1",
                                    "rep2": "/r2"},
                "router_routable": ["rep0", "rep1"],
                "router_dead": ["rep2"],
                "router_ring": {"rep0": ["tile0", "tile3"],
                                "rep1": ["tile1", "tile2"],
                                "rep2": []},
                "router_inflight": 2,
                "router_rerouted_total": 4,
                "router_rebalanced_total": 1,
                "router_last_failover_ts": 1700000000.0,
            },
        }
        with open(os.path.join(fleet_dir, "live_rhost_77.json"),
                  "w") as f:
            json.dump(snap, f)

    def test_render_includes_ring_and_failover(self, tmp_path):
        from tools.fleet_status import build_view, render

        self._router_snapshot(str(tmp_path))
        text = render(build_view(str(tmp_path), ttl_s=60.0))
        assert "router rhost:77" in text
        assert "routable=2/3" in text
        assert "inflight=2" in text
        assert "rerouted=4" in text
        assert "rebalanced=1" in text
        assert "dead replicas: rep2" in text
        assert "ring rep0: 2 tile(s) [tile0,tile3]" in text
        assert "ring rep2 DEAD: 0 tile(s)" in text
        assert "last_failover=-" not in text
        assert "last_failover=20" in text

    def test_cli_json_carries_router_status(self, tmp_path, capsys):
        from tools.fleet_status import main

        self._router_snapshot(str(tmp_path))
        assert main([str(tmp_path), "--json", "--ttl-s", "60"]) == 0
        payload = json.loads(capsys.readouterr().out)
        worker = payload["workers"][0]
        assert worker["role"] == "route"
        assert worker["status"]["router_rerouted_total"] == 4

    def test_renders_a_port_routers_status(self, tmp_path):
        """The status facts of a port router that routed four tiles read
        in ``tools/fleet_status`` as the JAX router's do."""
        from tools.fleet_status import build_view, render

        with telemetry.use(MetricsRegistry()):
            fleet = StubFleet(tmp_path, n=2, tiles=4).start()
            router = TileRouter(fleet.roots, str(tmp_path / "front"),
                                poll_interval_s=0.01)
            rt = run_router(router)
            try:
                rids = [submit_request(str(tmp_path / "front"),
                                       {"tile": f"tile{t}",
                                        "date": "2017-07-05"})
                        for t in range(4)]
                for rid in rids:
                    assert wait_response(str(tmp_path / "front"), rid)
                status = json.loads(json.dumps(router.status()))
            finally:
                router.drain()
                rt.join(timeout=30)
                fleet.stop()
        self._router_snapshot(str(tmp_path / "tel"), status=status)
        text = render(build_view(str(tmp_path / "tel"), ttl_s=60.0))
        assert "routable=2/2" in text and "rerouted=0" in text
        ring = HashRing(fleet.roots).assignments(
            [f"tile{t}" for t in range(4)])
        for rid, tiles in ring.items():
            assert f"ring {rid}: {len(tiles)} tile(s) " \
                f"[{','.join(tiles)}]" in text


# ---------------------------------------------------------------------------
# the chaos acceptance: 3 port replicas, SIGKILL the tile0 owner
# ---------------------------------------------------------------------------

def _replica_cmd(root, ckpt_root, tel_dir):
    return [
        sys.executable, "-m", "kafka_tpu_torch.cli.kafka_serve",
        "--root", str(root), "--ckpt-root", str(ckpt_root),
        "--tiles", "2", "--operator", "identity",
        "--ny", "16", "--nx", "20", "--days", "40", "--step", "2",
        "--obs-every", "2", "--poll-interval-s", "0.02",
        "--telemetry-dir", str(tel_dir), "--device", "cpu",
    ]


def _router_cmd(front, replicas, fleet_dir, tel_dir):
    spec = ",".join(f"{rid}={root}" for rid, root in replicas.items())
    return [
        sys.executable, "-m", "kafka_tpu_torch.cli.kafka_route",
        "--root", str(front), "--replicas", spec,
        "--fleet-dir", str(fleet_dir), "--ttl-s", "1.0",
        "--refresh-s", "0.2", "--poll-interval-s", "0.02",
        "--telemetry-dir", str(tel_dir),
    ]


class TestFleetChaosAcceptance:
    def test_sigkill_replica_rerouted_warm_zero_loss(self, tmp_path):
        """Three port replicas behind the port's kafka_route; the tile0
        owner is SIGKILLed mid-request.  The router flags it dead within
        one heartbeat TTL and re-routes, the new owner resumes the tile
        WARM from the shared checkpoint set, no admitted request is lost
        and the answer equals an uninterrupted run's bit for bit."""
        from tools.loadgen import _Target, run_load

        env = _subprocess_env()
        tel = tmp_path / "tel"
        ckpt = tmp_path / "ckpt"
        front = str(tmp_path / "front")
        dates = synthetic_dates(DEFAULT_BASE_DATE, 40, 2)
        date = dates[-1]
        replicas = {f"rep{i}": str(tmp_path / f"rep{i}")
                    for i in range(3)}
        victim_rid = HashRing(replicas).owner("tile0")
        assert victim_rid == jrouter.HashRing(replicas).owner("tile0")
        procs = {}
        router_proc = None
        try:
            for rid, root in replicas.items():
                procs[rid] = subprocess.Popen(
                    _replica_cmd(root, ckpt, tel / rid), env=env,
                    cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                )
            router_proc = subprocess.Popen(
                _router_cmd(front, replicas, tel, tel / "router"),
                env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True,
            )
            victim = procs[victim_rid]
            rid = submit_request(front, {
                "tile": "tile0", "date": date.isoformat(),
                "request_id": "victimreq",
            })
            victim_journal = tmp_path / victim_rid / "requests.jsonl"
            ck_dir = ckpt / "ckpt_tile0"
            deadline = time.time() + 50
            while time.time() < deadline:
                if victim.poll() is not None:
                    pytest.fail(
                        f"victim exited rc={victim.returncode} before "
                        "it could be killed"
                    )
                if read_response(front, rid) is not None:
                    pytest.fail("fleet answered before the kill — "
                                "widen the request")
                journal_text = victim_journal.read_text() \
                    if victim_journal.exists() else ""
                if rid in journal_text and ck_dir.is_dir() and any(
                        n.endswith(".npz")
                        for n in os.listdir(ck_dir)):
                    break
                time.sleep(0.005)
            else:
                pytest.fail("victim never admitted + checkpointed")
            kill_ts = time.time()
            victim.kill()
            victim.wait(timeout=30)
            assert read_response(front, rid) is None

            got = wait_response(front, rid, timeout_s=50)
            assert got is not None, "re-routed request was lost"
            assert got["status"] == "ok"
            assert got["replica"] != victim_rid
            assert got["served_from"] in ("warm", "warm_noop")
            assert got["trace"]["phases"]["failover_ms"] > 0
            assert got["trace"]["reroutes"][0]["replica"] == victim_rid

            ref = TileSession(make_synthetic_tile(
                "tile0", str(tmp_path / "ck_ref"), operator="identity",
                ny=16, nx=20, days=40, step_days=2, obs_every=2,
                seed=0, device="cpu",
            ))
            assert got["x_sha256"] == ref.serve(date)["x_sha256"]

            # Post-failover load through the JAX client helpers (the
            # same file wire): every request lands.
            plan = [{"tile": f"tile{i % 2}",
                     "date": dates[-1 - (i % 2)].isoformat()}
                    for i in range(6)]
            rows = run_load(_Target(root=front), plan, concurrency=3,
                            timeout_s=50, backoff_budget=8)
            assert rows["serve_ok_total"] == 6
            assert rows["serve_error_total"] == 0

            router_proc.send_signal(signal.SIGTERM)
            out, _ = router_proc.communicate(timeout=30)
            assert router_proc.returncode == 0
            summary = json.loads(out.strip().splitlines()[-1])
            assert summary["rerouted"] >= 1
            assert summary["rebalanced"] >= 1
            assert summary["relayed"] >= 7

            failovers = []
            with open(tel / "router" / "events.jsonl") as f:
                for line in f:
                    e = json.loads(line)
                    if e["event"] == "route_failover":
                        failovers.append(e)
            assert failovers, "router recorded no failover event"
            assert failovers[0]["lost"] == [victim_rid]
            victim_snaps = [n for n in os.listdir(tel / victim_rid)
                            if n.startswith("live_")]
            assert victim_snaps, "victim published no heartbeat"
            with open(tel / victim_rid / victim_snaps[0]) as f:
                last_beat = json.load(f)["ts"]
            detect_lag = failovers[0]["ts"] - last_beat
            assert detect_lag <= 1.0 + 0.2 + 8.0, detect_lag
            assert failovers[0]["ts"] >= kill_ts

            from tools.fleet_status import build_view

            fleet_view = build_view(str(tel), ttl_s=1.0)
            dead_pids = {w["pid"] for w in fleet_view["workers"]
                         if w["dead"]}
            assert victim.pid in dead_pids
        finally:
            for proc in list(procs.values()) + [router_proc]:
                if proc is not None and proc.poll() is None:
                    proc.kill()
            for proc in list(procs.values()) + [router_proc]:
                if proc is not None:
                    proc.wait(timeout=30)


def test_route_cli_parses_like_the_jax_cli():
    """The same flags, the same replica-spec parsing."""
    from kafka_tpu.cli import kafka_route as jcli
    from kafka_tpu_torch.cli import kafka_route as tcli

    spec = "a=/r/a, b=/r/b,/r/c"
    assert tcli.parse_replicas(spec) == jcli.parse_replicas(spec)

    def flags(parser):
        return sorted(a.dest for a in parser._actions)

    assert flags(tcli.build_parser()) == flags(jcli.build_parser())
