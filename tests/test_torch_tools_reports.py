"""The port's report tools (``kafka_tpu_torch/tools/``: queue_status,
slo_report, quality_report, device_report, trace_report, fleet_status)
against the JAX package's (``tools/``), both ways: on directories the
port wrote and on directories the JAX package wrote, each tool pair
prints byte-equal ``--json`` and text output and exits with the same
code, usage errors included.

Each package writes its own set of artifact directories with its own
code, all small and on the CPU: ``run_synthetic --telemetry-dir
--profile-windows 1`` (a capture, the quality ledger, live snapshots),
``run_synthetic --queue`` (the lease queue, plus a pending and an
expired chunk written with the package's own lease code), an in-process
``kafka_serve`` with the fleet plane and the SLO engine (request log,
alerts ledger, heartbeats; one request for a date the tile lacks, and
one solve retried after an injected transient fault) and a
two-replica fleet behind the router (``loadgen.bench_fleet`` in a
registry with a directory: router and replica request logs, and a route
heartbeat carrying the ring).  Both tools run in this process with the
clock fixed, since heartbeat ages, lease deadlines and budgets read it.
"""

import contextlib
import importlib
import io
import json
import os
import sys
import time

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

JAX_CAPTURE = os.path.join(REPO_ROOT, "tests", "fixtures", "devprof_capture")
HISTORY = [os.path.join(REPO_ROOT, f"MULTICHIP_r0{i}.json") for i in (1, 5)]

#: per package: (cli package, serve package, telemetry package, shard
#: queue module, loadgen module, extra driver flags, extra bench kwargs).
PACKAGES = {
    "torch": ("kafka_tpu_torch.cli", "kafka_tpu_torch.serve",
              "kafka_tpu_torch.telemetry", "kafka_tpu_torch.shard.queue",
              "kafka_tpu_torch.tools.loadgen", ["--device", "cpu"],
              {"device": "cpu"}),
    "jax": ("kafka_tpu.cli", "kafka_tpu.serve", "kafka_tpu.telemetry",
            "kafka_tpu.shard.queue", "tools.loadgen", [], {}),
}


def _mod(name):
    return importlib.import_module(name)


def _write_dirs(pkg: str, base: str) -> dict:
    """One package's artifact directories under ``base``."""
    cli, serve, tel, queue, loadgen, flags, bench_kw = PACKAGES[pkg]
    telemetry = _mod(tel)
    run_synthetic = _mod(f"{cli}.run_synthetic")
    kafka_serve = _mod(f"{cli}.kafka_serve")
    srv = _mod(serve)
    d = {k: os.path.join(base, k) for k in (
        "tel", "out", "q", "qtel", "serve", "stel", "fleet_run", "ftel")}
    small = ["--operator", "identity", "--ny", "24", "--nx", "24",
             "--days", "8", *flags]
    with telemetry.use(telemetry.MetricsRegistry()):
        run_synthetic.main(small + ["--outdir", d["out"], "--telemetry-dir",
                                    d["tel"], "--profile-windows", "1"])
    with telemetry.use(telemetry.MetricsRegistry()):
        run_synthetic.main(small + [
            "--step", "4", "--obs-every", "2", "--chunk-size", "12",
            "--queue", "--num-workers", "1", "--outdir", d["q"],
            "--telemetry-dir", d["qtel"]])
    # Two chunks beyond the run's four: one pending, one whose lease
    # expires long before the tools' clock.
    q = _mod(queue)
    manifest = os.path.join(d["q"], q.MANIFEST_NAME)
    doc = json.load(open(manifest))
    doc["chunks"] += [dict(doc["chunks"][0], prefix=p, chunk_no=n)
                      for p, n in (("0005", 5), ("0006", 6))]
    with open(manifest, "w") as f:
        json.dump(doc, f)
    assert q._try_claim(d["q"], "0005", "ghost:9", 1.0) is not None

    dates = srv.synthetic_dates(srv.synthetic.DEFAULT_BASE_DATE, 16, 2)
    for i, (date, smoothed) in enumerate(
            [(dates[2], False), (dates[2], False), (dates[6], False),
             (dates[0], False), (dates[2], True)]):
        srv.submit_request(d["serve"], {
            "request_id": f"r{i}", "tile": "tile0",
            "date": date.isoformat(), "smoothed": smoothed})
    srv.submit_request(d["serve"], {"request_id": "r9", "tile": "tile0",
                                    "date": "2017-07-03"})
    # The first solve fails once, transiently: the service retries it
    # after its policy's 100 ms backoff, which no named phase covers, so
    # one request carries unattributed wall time whatever the process
    # imported before (the {base} --unattributed case reads it).
    faults = _mod(cli.rsplit(".", 1)[0] + ".resilience.faults")
    faults.reset()
    faults.script("serve.solve", "1")
    try:
        with telemetry.use(telemetry.MetricsRegistry()), \
                contextlib.redirect_stdout(io.StringIO()):
            kafka_serve.main([
                "--root", d["serve"], "--tiles", "1", "--telemetry-dir",
                d["stel"], "--fleet-dir", d["stel"], "--exit-when-idle",
                "--live-interval-s", "0.2", "--slo-interval-s", "0.1",
                "--slo-fast-window-s", "5", "--slo-slow-window-s", "20",
                *flags])
    finally:
        faults.reset()

    with telemetry.use(telemetry.MetricsRegistry(d["ftel"])) as reg:
        rows = _mod(loadgen).bench_fleet(d["fleet_run"], replicas=2,
                                         requests=4, concurrency=2,
                                         tiles=2, **bench_kw)
        assert rows["serve_fleet_ok_total"] == 4
        _mod(f"{tel}.live").LivePublisher(
            d["ftel"], role="route", interval_s=60.0,
            registry=reg).publish_now(final=True)
        reg.dump()
    routed = [json.loads(line)["request_id"]
              for line in open(os.path.join(d["ftel"], "request_log.jsonl"))
              if json.loads(line).get("role") == "route"]
    d["routed"] = routed[0]
    return d


@pytest.fixture(scope="module", params=sorted(PACKAGES))
def dirs(request, tmp_path_factory):
    """The artifact directories one package wrote (``torch`` or
    ``jax``), and the fixed clock the tools read them at."""
    base = str(tmp_path_factory.mktemp(f"written_by_{request.param}"))
    d = _write_dirs(request.param, base)
    d["base"] = base
    d["now"] = time.time() + 30.0
    return d


def _run(module: str, argv, now: float):
    """``main(argv)`` of one tool with the clock at ``now``: (rc, stdout,
    stderr); an argparse error's SystemExit gives its code."""
    main = _mod(module).main
    out, err = io.StringIO(), io.StringIO()
    real = time.time
    time.time = lambda: now
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                rc = main(list(argv))
            except SystemExit as exc:
                rc = exc.code
    finally:
        time.time = real
    return rc, out.getvalue(), err.getvalue()


def _both(tool: str, argv, now: float, outfile=None):
    """Run the JAX tool, then the port's, on the same arguments; each
    side's result with the file it wrote at ``outfile`` (both write the
    same path, so paths in the reports agree)."""
    got = {}
    for side, module in (("jax", f"tools.{tool}"),
                         ("torch", f"kafka_tpu_torch.tools.{tool}")):
        if outfile and os.path.exists(outfile):
            os.unlink(outfile)
        rc, out, err = _run(module, argv, now)
        written = open(outfile).read() if outfile and \
            os.path.exists(outfile) else None
        got[side] = (rc, out, err, written)
    return got["jax"], got["torch"]


#: (tool, argv template, expected rc).  ``{name}`` expands to the
#: fixture's directories (``{out}`` is run_synthetic's raster folder, which
#: holds no ledger); ``{file}`` to a file the tool writes.
CASES = [
    ("queue_status", ["{q}", "--telemetry-dir", "{qtel}"], 0),
    ("queue_status", ["{q}", "--telemetry-dir", "{qtel}", "--ttl-s",
                      "0.5"], 0),
    ("queue_status", ["{q}"], 0),
    ("queue_status", ["{base}/nope"], 2),
    ("queue_status", [], 2),
    ("slo_report", ["{stel}"], 0),
    ("slo_report", ["{base}"], 0),
    ("slo_report", ["{stel}/alerts.jsonl", "{tel}"], 0),
    ("slo_report", ["{out}"], 2),
    ("slo_report", [], 2),
    ("quality_report", ["{base}"], 0),
    ("quality_report", ["{tel}", "--worst", "2"], 0),
    ("quality_report", ["{stel}/quality.jsonl", "--worst", "0"], 0),
    ("quality_report", ["{out}"], 2),
    ("quality_report", ["{tel}", "--worst", "two"], 2),
    ("device_report", ["{tel}"], 0),
    ("device_report", ["{tel}", "--all-sessions", "--n", "3",
                       "--mesh-history", *HISTORY], 0),
    ("device_report", [JAX_CAPTURE], 0),
    ("device_report", ["--mesh-history", HISTORY[0]], 0),
    ("device_report", ["{out}"], 0),
    ("device_report", ["--mesh-history", "{base}/nope.json"], 2),
    ("device_report", ["{base}/nope"], 2),
    ("device_report", [], 2),
    ("trace_report", ["{stel}"], 0),
    ("trace_report", ["{ftel}", "--slowest", "2"], 0),
    ("trace_report", ["{base}", "--unattributed", "--coverage", "1.01"], 1),
    ("trace_report", ["{stel}", "--unattributed", "--coverage", "0"], 0),
    ("trace_report", ["{stel}", "--request", "r0"], 0),
    ("trace_report", ["{ftel}", "--request", "{routed}", "--stitch",
                      "{file}"], 0),
    ("trace_report", ["{stel}", "--request", "nope"], 2),
    ("trace_report", ["{stel}", "--stitch", "{file}"], 2),
    ("trace_report", ["{base}/nope"], 2),
    ("fleet_status", ["{base}"], 0),
    ("fleet_status", ["{ftel}", "--ttl-s", "60"], 0),
    ("fleet_status", ["{qtel}", "--queue-dir", "{q}"], 0),
    ("fleet_status", ["{stel}", "--stitch-trace", "{file}"], 0),
    ("fleet_status", ["{ftel}", "--stitch-trace", "{file}",
                      "--request-id", "{routed}"], 0),
    ("fleet_status", ["{stel}", "--watch", "0", "--watch-count", "2"], 0),
    ("fleet_status", ["{base}/nope"], 2),
    ("fleet_status", ["{stel}", "--ttl-s", "soon"], 2),
]


def _case_id(case):
    tool, argv, _ = case
    words = [a.strip("{}").replace("/", "_") if a.startswith("{")
             else os.path.basename(a) for a in argv]
    return "-".join([tool] + words)[:80]


@pytest.mark.parametrize("fmt", ["json", "text"])
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_port_tool_prints_what_the_jax_tool_prints(dirs, case, fmt,
                                                   tmp_path):
    tool, template, want_rc = case
    outfile = str(tmp_path / "written.json")
    names = {k: v for k, v in dirs.items() if isinstance(v, str)}
    argv = [a.format(**names, file=outfile) for a in template]
    if fmt == "json" and want_rc != 2 and not (
            tool == "fleet_status" and "--watch" in argv):
        argv.append("--json")
    theirs, ours = _both(tool, argv, dirs["now"], outfile)
    assert ours[0] == theirs[0] == want_rc, (ours[2], theirs[2])
    assert ours[1] == theirs[1]
    assert ours[3] == theirs[3]
    if want_rc == 2:
        # A usage error names the tool (argparse prints the program
        # name) or the missing input in the same words.
        assert ours[2] == theirs[2] and ours[2]
    elif "--json" in argv:
        assert json.loads(ours[1])


def test_the_directories_hold_what_the_reports_read(dirs):
    """The fixture's directories are not empty reports: the capture,
    the queue states, the alerts, the routed requests and the route
    heartbeat are there for both packages' writers."""
    def report(tool, *argv):
        rc, out, err = _run(f"kafka_tpu_torch.tools.{tool}",
                            [*argv, "--json"], dirs["now"])
        assert rc == 0, err
        return json.loads(out)

    dev = report("device_report", dirs["tel"])
    assert dev["n_sessions"] == 1 and dev["sessions"][0]["parseable"]
    assert dev["sessions"][0]["kernels"]
    q = report("queue_status", dirs["q"], "--telemetry-dir", dirs["qtel"])
    assert q["counts"] == {"done": 4, "failed": 0, "lease_expired": 1,
                           "leased": 0, "pending": 1}
    assert q["workers"]["ghost:9"]["expired"] == ["0005"]
    assert q["liveness"]
    slo = report("slo_report", dirs["stel"])
    assert slo["records"] and slo["episodes"]
    tr = report("trace_report", dirs["ftel"])
    assert tr["requests_total"] >= 4
    assert any(r.get("role") == "route" for r in tr["slowest"])
    fleet = report("fleet_status", dirs["ftel"], "--ttl-s", "60")
    route = [w for w in fleet["workers"] if w["role"] == "route"]
    assert route and route[0]["status"]["router_ring"]
    quality = report("quality_report", dirs["base"])
    assert quality["tiles"]
