"""The router half of tests/test_request_trace.py on the port (its
``TestRequestTracingChaosAcceptance``): three port replicas
(``--device cpu``, the JAX test's 16 x 20 identity tiles) behind the
port's ``kafka_route``, the tile0 owner SIGKILLed mid-request.

The relayed answer carries the merged attribution with the failover hop;
every admitted request leaves a router ``request_log.jsonl`` row; the
JAX ``tools/trace_report.py`` ranks the victim request slowest, >= 95 %
attributed with failover the dominant phase; the port's
``aggregate.stitch_traces`` stitches the victim request's waterfall from
the router, victim and survivor tracks with a ``route_failover`` span and
flow events across the hops, and both packages' stitchers read the same
files.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from kafka_tpu.telemetry import aggregate as jaggregate
from kafka_tpu_torch.serve import (HashRing, read_response, submit_request,
                                   synthetic_dates)
from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE
from kafka_tpu_torch.telemetry import request_log
from kafka_tpu_torch.telemetry.aggregate import stitch_traces

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _subprocess_env():
    from kafka_tpu_torch.resilience import faults

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    env["KAFKA_TPU_LIVE_INTERVAL_S"] = "0.2"
    env.pop(faults.ENV_VAR, None)
    return env


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


def _trace_has_request(path, rid):
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return False
    return any(
        (e.get("args") or {}).get("request_id") == rid
        for e in doc.get("traceEvents") or ()
    )


def wait_response(root, rid, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = read_response(root, rid)
        if got is not None:
            return got
        time.sleep(0.01)
    return None


class TestRequestTracingChaosAcceptance:
    def test_failover_trace_attributes_tail_latency(self, tmp_path):
        from tools.loadgen import _Target, run_load
        from tools.trace_report import build_report

        env = _subprocess_env()
        tel = tmp_path / "tel"
        ckpt = tmp_path / "ckpt"
        front = str(tmp_path / "front")
        dates = synthetic_dates(DEFAULT_BASE_DATE, 40, 2)
        date = dates[-1]
        replicas = {f"rep{i}": str(tmp_path / f"rep{i}")
                    for i in range(3)}
        victim_rid = HashRing(replicas).owner("tile0")
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

            # Wait for the router's first heartbeat: the victim request's
            # admission wait must measure inbox wait, not router boot.
            router_tel = tel / "router"
            deadline = time.time() + 50
            while time.time() < deadline:
                if router_tel.is_dir() and any(
                        n.startswith("live_")
                        for n in os.listdir(router_tel)):
                    break
                time.sleep(0.05)
            else:
                pytest.fail("router never published a heartbeat")

            rid = submit_request(front, {
                "tile": "tile0", "date": date.isoformat(),
                "request_id": "victimreq",
            })
            victim_journal = tmp_path / victim_rid / "requests.jsonl"
            victim_trace = tel / victim_rid / "trace.json"
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
                        for n in os.listdir(ck_dir)) and \
                        _trace_has_request(victim_trace, rid):
                    break
                time.sleep(0.005)
            else:
                pytest.fail("victim never admitted + checkpointed + "
                            "published its trace")
            victim.kill()
            victim.wait(timeout=30)

            got = wait_response(front, rid, timeout_s=50)
            assert got is not None, "re-routed request was lost"
            assert got["status"] == "ok"
            assert got["replica"] != victim_rid
            trace = got["trace"]
            assert trace["request_id"] == rid
            assert trace["phases"]["failover_ms"] > 0
            assert trace["reroutes"][0]["replica"] == victim_rid
            assert trace["reroutes"][0]["reason"] == "dead"

            plan = [{"tile": f"tile{i % 2}",
                     "date": dates[-1 - (i % 2)].isoformat()}
                    for i in range(6)]
            rows = run_load(_Target(root=front), plan, concurrency=3,
                            timeout_s=50, backoff_budget=8)
            assert rows["serve_ok_total"] == 6
            assert rows["serve_trace_coverage"] == 1.0
            assert rows["serve_slowest_ms"] > 0

            router_proc.send_signal(signal.SIGTERM)
            router_proc.communicate(timeout=30)
            assert router_proc.returncode == 0
            for rep_rid, proc in procs.items():
                if rep_rid != victim_rid:
                    proc.send_signal(signal.SIGTERM)
            for rep_rid, proc in procs.items():
                if rep_rid != victim_rid:
                    assert proc.wait(timeout=30) == 0

            records, torn = request_log.load_records(str(tel))
            assert torn == 0
            route_rows = {r["request_id"]: r for r in records
                          if r["role"] == "route"}
            assert len(route_rows) == 7  # victimreq + 6 loadgen
            assert all(r["status"] == "ok" for r in route_rows.values())

            report = build_report(str(tel), slowest=10)
            slowest = report["slowest"][0]
            assert slowest["request_id"] == rid
            assert slowest["coverage"] >= 0.95
            phases = slowest["phases"]
            assert phases["failover_ms"] == max(phases.values())
            assert report["unattributed"] == []
            assert report["coverage_ok_fraction"] == 1.0

            p99 = report["exemplars"]["p99"]
            assert p99["request_id"] in route_rows
            doc = stitch_traces(str(tel), request_id=p99["request_id"])
            assert len(doc["otherData"]["sources"]) >= 2
            for e in doc["traceEvents"]:
                assert "name" in e and "ph" in e and "pid" in e

            doc = stitch_traces(str(tel), request_id=rid)
            src_dirs = {os.path.dirname(s["path"])
                        for s in doc["otherData"]["sources"]}
            assert "router" in src_dirs
            assert victim_rid in src_dirs, sorted(src_dirs)
            assert len(src_dirs) >= 3
            span_names = {e["name"] for e in doc["traceEvents"]
                          if e.get("ph") == "X"}
            assert "route_failover" in span_names
            assert "route_forward" in span_names
            flows = [e for e in doc["traceEvents"]
                     if e.get("ph") in ("s", "f")]
            assert flows, "no flow events across the failover hops"
            # The JAX package's stitcher reads the port's files alike.
            jdoc = jaggregate.stitch_traces(str(tel), request_id=rid)
            assert {e["name"] for e in jdoc["traceEvents"]
                    if e.get("ph") == "X"} == span_names
        finally:
            for proc in list(procs.values()) + [router_proc]:
                if proc is not None and proc.poll() is None:
                    proc.kill()
            for proc in list(procs.values()) + [router_proc]:
                if proc is not None:
                    proc.wait(timeout=30)
