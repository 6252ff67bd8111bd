"""The port's SLO engine (``kafka_tpu_torch.telemetry.slo``) against the
JAX package's: the same scripted traffic through both engines gives the
same statuses, burn rates, budgets and firing alerts at every
evaluation; the port's ``alerts.jsonl`` reads with the JAX loader and
``tools/slo_report.py``; and the outward wiring (``/alertz``, ``/healthz``
503, admission ``slo_burn``, live snapshots, the fleet view, the driver's
evaluator) mirrors ``tests/test_slo.py`` on the port."""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from kafka_tpu import telemetry as jax_telemetry  # noqa: E402
from kafka_tpu.telemetry import slo as jax_slo  # noqa: E402
from kafka_tpu_torch import telemetry  # noqa: E402
from kafka_tpu_torch.serve.admission import (  # noqa: E402
    AdmissionController, AdmissionPolicy)
from kafka_tpu_torch.telemetry import MetricsRegistry, slo  # noqa: E402
from kafka_tpu_torch.telemetry.httpd import TelemetryHTTPd  # noqa: E402

TEST_WINDOWS = dict(fast_window_s=5.0, slow_window_s=20.0,
                    pending_for_s=0.0)


def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


#: (now, traffic) steps: latencies observed, rejections, errors, gauges.
SCRIPT = (
    (100.0, {}),
    (100.5, {"lat": [0.01, 0.02, 0.9], "rej": 10, "drift": 2,
             "frac": 0.001, "pixels": 1000, "quar": 3}),
    (101.0, {"lat": [0.01] * 20}),
    (103.0, {"err": 1, "lat": [0.3, 0.4]}),
    (110.0, {"lat": [0.01] * 5, "drift": 0, "frac": 0.8}),
    (125.0, {"lat": [0.02]}),
    (140.0, {}),
)


def _feed(reg, traffic):
    for v in traffic.get("lat", ()):
        reg.histogram("kafka_serve_latency_seconds",
                      "serve latency").observe(v)
    if traffic.get("rej"):
        reg.counter("kafka_serve_rejected_total", "shed").inc(
            traffic["rej"], reason="queue_full")
    if traffic.get("err"):
        reg.counter("kafka_serve_errors_total", "errors").inc(
            traffic["err"])
    if "drift" in traffic:
        reg.gauge("kafka_quality_drift_active", "d").set(traffic["drift"])
    if "frac" in traffic:
        reg.gauge("kafka_perf_device_fraction", "f").set(traffic["frac"])
    if traffic.get("pixels"):
        reg.counter("kafka_engine_pixels_total", "p").inc(
            traffic["pixels"])
    if traffic.get("quar"):
        reg.counter("kafka_solver_quarantined_pixels_total", "q").inc(
            traffic["quar"])


def _view(summary):
    """The comparable part of an engine summary (no paths, no clocks)."""
    return {
        "firing": sorted((a["objective"], a["severity"])
                         for a in summary["firing"]),
        "fired": summary["alerts_fired"],
        "resolved": summary["alerts_resolved"],
        "objectives": {
            name: {k: o[k] for k in ("status", "alerts", "burn_fast",
                                     "burn_slow", "budget")}
            for name, o in summary["objectives"].items()},
    }


def test_same_traffic_same_burn_rates_and_alert_states(tmp_path):
    views = {}
    for name, tel, mod, Reg in (
            ("jax", jax_telemetry, jax_slo, jax_telemetry.MetricsRegistry),
            ("torch", telemetry, slo, MetricsRegistry)):
        with tel.use(Reg(str(tmp_path / name))) as reg:
            eng = mod.SLOEngine(registry=reg, **TEST_WINDOWS)
            views[name] = []
            for now, traffic in SCRIPT:
                _feed(reg, traffic)
                views[name].append(_view(eng.evaluate_once(now=now)))
    assert views["torch"] == views["jax"]
    # The script exercised the machine: alerts fired and resolved.
    assert views["torch"][2]["firing"]
    assert views["torch"][-1]["resolved"] > 0
    # The port's ledger reads with the JAX loader, record for record.
    ours = jax_slo.load_alerts(str(tmp_path / "torch"))[0]
    theirs = jax_slo.load_alerts(str(tmp_path / "jax"))[0]
    assert [(r["objective"], r["severity"], r["kind"]) for r in ours] == \
        [(r["objective"], r["severity"], r["kind"]) for r in theirs]


@pytest.mark.parametrize("objective", ["availability", "latency",
                                       "quality", "solver", "perf"])
def test_objective_signals_equal(objective):
    regs = (jax_telemetry.MetricsRegistry(), MetricsRegistry())
    for reg in regs:
        for _, traffic in SCRIPT[:4]:
            _feed(reg, traffic)
    (jo,) = [o for o in jax_slo.default_objectives() if o.name == objective]
    (to,) = [o for o in slo.default_objectives() if o.name == objective]
    assert to.signal(regs[1]) == jo.signal(regs[0])
    assert (to.target, to.kind) == (jo.target, jo.kind)


def test_slo_report_reads_the_ports_ledger(tmp_path, capsys):
    from tools.slo_report import main

    with telemetry.use(MetricsRegistry(str(tmp_path))) as reg:
        eng = slo.SLOEngine(registry=reg, **TEST_WINDOWS)
        eng.evaluate_once(now=100.0)
        reg.histogram("kafka_serve_latency_seconds", "t").observe(0.01)
        _feed(reg, {"rej": 10})
        eng.evaluate_once(now=100.5)
        eng.evaluate_once(now=101.0)
        eng.evaluate_once(now=140.0)
        live = eng.summary()
    assert main([str(tmp_path), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    page = {(e["objective"], e["severity"]): e
            for e in report["episodes"]}[("availability", "page")]
    assert (page["firing_ts"], page["resolved_ts"]) == (101.0, 140.0)
    assert report["objectives"]["availability"]["budget"]["remaining"] == \
        pytest.approx(live["objectives"]["availability"]["budget"]
                      ["remaining"], abs=1e-6)


def test_alertz_and_healthz_flip_on_firing_page():
    with telemetry.use(MetricsRegistry()) as reg:
        eng = slo.get_engine(reg, **TEST_WINDOWS)
        httpd = TelemetryHTTPd(port=0, role="serve").start()
        try:
            assert json.loads(http_get(httpd.url + "/alertz?json=1")[1])[
                "enabled"] is True
            eng.evaluate_once(now=100.0)
            _feed(reg, {"rej": 10})
            eng.evaluate_once(now=100.5)
            eng.evaluate_once(now=101.0)
            assert "FIRING [page] availability" in \
                http_get(httpd.url + "/alertz")[1]
            code, body = http_get(httpd.url + "/healthz")
            assert code == 503
            assert json.loads(body)["slo_firing"] == ["availability"]
            eng.evaluate_once(now=140.0)
            assert http_get(httpd.url + "/healthz")[0] == 200
        finally:
            httpd.close()


def test_admission_sheds_slo_burn_when_opted_in():
    with telemetry.use(MetricsRegistry()) as reg:
        reg.gauge("kafka_slo_alerts_firing", "t").set(1, severity="page")
        assert AdmissionController(AdmissionPolicy(
            shed_on_slo=True)).decide(queue_depth=0) == "slo_burn"
        assert AdmissionController(AdmissionPolicy()).decide(
            queue_depth=0) is None
        reg.gauge("kafka_slo_alerts_firing", "t").set(0, severity="page")
        assert AdmissionController(AdmissionPolicy(
            shed_on_slo=True)).decide(queue_depth=0) is None


def test_live_snapshot_slo_folds_into_the_jax_fleet_view():
    from kafka_tpu.telemetry.aggregate import aggregate_fleet
    from kafka_tpu_torch.telemetry.live import build_snapshot

    with telemetry.use(MetricsRegistry()) as reg:
        eng = slo.get_engine(reg, **TEST_WINDOWS)
        eng.evaluate_once(now=100.0)
        _feed(reg, {"rej": 10})
        eng.evaluate_once(now=100.5)
        eng.evaluate_once(now=101.0)
        snap = build_snapshot(reg, role="serve")
    assert snap["slo"]["enabled"] is True
    fleet = aggregate_fleet([snap])
    assert ("availability", "page") in {
        (f["objective"], f["severity"]) for f in fleet["slo"]["firing"]}


def test_evaluator_thread_smoke():
    with telemetry.use(MetricsRegistry()) as reg:
        eng = slo.SLOEngine(registry=reg, interval_s=0.05, **TEST_WINDOWS)
        eng.start()
        deadline = time.monotonic() + 10.0
        try:
            while time.monotonic() < deadline and \
                    not reg.value("kafka_slo_evaluations_total"):
                time.sleep(0.02)
            _feed(reg, {"rej": 20})
            while time.monotonic() < deadline and not reg.value(
                    "kafka_slo_alerts_firing", severity="page"):
                time.sleep(0.02)
            assert reg.value("kafka_slo_alerts_firing", severity="page") == 1
        finally:
            eng.stop()


def test_run_synthetic_starts_and_stops_the_evaluator(tmp_path):
    from kafka_tpu_torch.cli.run_synthetic import main

    tel = str(tmp_path / "tel")
    with telemetry.use(MetricsRegistry()):
        summary = main(["--operator", "identity", "--ny", "24", "--nx",
                        "24", "--days", "8", "--outdir",
                        str(tmp_path / "out"), "--telemetry-dir", tel,
                        "--device", "cpu"])
    assert summary["n_pixels"] > 0
    prom = open(os.path.join(tel, "metrics.prom")).read()
    assert "kafka_slo_evaluations_total" in prom
    assert 'kafka_slo_alerts_firing{severity="page"} 0' in prom
    assert not os.path.exists(os.path.join(tel, slo.ALERTS_FILENAME))
    events = [json.loads(line)["event"]
              for line in open(os.path.join(tel, "events.jsonl"))]
    assert "slo_engine_started" in events
