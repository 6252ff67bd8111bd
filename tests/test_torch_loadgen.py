"""The port's load generator (``kafka_tpu_torch/tools/loadgen.py``)
against the JAX package's (``tools/loadgen.py``), on the CPU at the JAX
defaults (20 x 20 identity tiles):

- the same request plans and percentiles;
- ``run_load`` over a ``--root`` inbox answered by one scripted
  responder (ok / cache / smoothed / rejected with and without a
  backoff hint / cancelled / error / unanswered): the same row keys and
  the same counts;
- ``bench_serve``, ``bench_fleet`` and ``bench_concurrency_sweep`` with
  ``device="cpu"``: the JAX row schema and counts, and every answer's
  state within the port-vs-JAX serving budget of
  ``tests/test_torch_serve.py``;
- ``main``'s exit codes, usage errors included;
- in-process replicas that solve at once (``bench_fleet``) share
  ``torch.func``'s process-wide forward-AD level safely.
"""

import contextlib
import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import tools.loadgen as jax_loadgen  # noqa: E402
from kafka_tpu_torch.serve import (read_response,  # noqa: E402
                                   synthetic_dates)
from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE  # noqa: E402
from kafka_tpu_torch.tools import loadgen  # noqa: E402

DATES = synthetic_dates(DEFAULT_BASE_DATE, 16, 2)
#: the engine parity budget on an analysis mean (tests/test_torch_serve.py)
X_MEAN_ATOL = 2e-3
#: rows that count requests or sum what the responses carry: equal in
#: both packages whatever the timing.
COUNT_ROWS = ("serve_requests_total", "serve_ok_total",
              "serve_rejected_total", "serve_cancelled_total",
              "serve_error_total", "serve_smoothed_ok_total",
              "serve_backoff_total", "serve_solved_total",
              "serve_quarantined_pixels", "serve_cap_bailouts",
              "serve_damped_recovered")


@pytest.mark.parametrize("n,every,tiles", [
    (8, 0, ["tile0"]), (13, 4, ["a", "b", "c"]), (32, 3, ["t0", "t1"]),
    (1, 1, ["tile0"]), (0, 4, ["tile0"])])
def test_request_plans_equal(n, every, tiles):
    for dates in (DATES, DATES[-4:], DATES[:1]):
        assert loadgen.synthetic_request_plan(dates, tiles, n, every) == \
            jax_loadgen.synthetic_request_plan(dates, tiles, n, every)


@pytest.mark.parametrize("lat", [[], [3.0], [1.0, 2.0, 10.0, 4.5],
                                 list(np.linspace(0.1, 99.0, 101))])
def test_percentiles_equal(lat):
    assert loadgen._percentiles(lat) == jax_loadgen._percentiles(lat)


# ---------------------------------------------------------------------------
# run_load over a --root inbox: one scripted responder for both packages
# ---------------------------------------------------------------------------

def _answer(payload: dict):
    """The scripted response to one request (None: never answered).
    The plan index is the request id's number; a backoff resubmission
    (``load00003b1``) is answered ok."""
    rid = payload["request_id"]
    base = {"request_id": rid, "tile": payload["tile"],
            "date": payload["date"]}
    if "b" in rid[4:]:
        return dict(base, status="ok", served_from="warm",
                    trace={"phases": {"solve_ms": 5.0}, "e2e_ms": 5.0})
    i = int(rid[4:])
    if payload.get("smoothed"):
        return dict(base, status="ok", served_from="smoothed_chain",
                    trace={"phases": {"smooth_ms": 3.0}, "e2e_ms": 3.2})
    kind = ("cold", "cache", "hinted", "cancelled", "error", "rejected",
            "batched", "silent")[i % 8]
    if kind == "silent" and i >= 8:
        return None
    if kind in ("cold", "silent"):
        return dict(base, status="ok", served_from="cold",
                    solver_health={"quarantined": 2, "cap_bailouts": 1,
                                   "damped_recovered": 3},
                    quality={"verdict": "CONSISTENT"},
                    trace={"phases": {"solve_ms": 9.0, "dump_ms": 0.5},
                           "e2e_ms": 10.0})
    if kind == "cache":
        return dict(base, status="ok", served_from="cache",
                    trace={"phases": {}, "e2e_ms": 40.0})
    if kind == "batched":
        return dict(base, status="ok", served_from="warm",
                    trace={"phases": {"queue_wait_ms": 7.0,
                                      "solve_ms": 2.0},
                           "e2e_ms": 9.1, "batch_size": 3})
    if kind == "hinted":
        return dict(base, status="rejected", reason="queue_full",
                    retry_after_s=0.01)
    if kind == "rejected":
        return dict(base, status="rejected", reason="draining")
    return dict(base, status=kind, error="scripted")


class Responder:
    """A thread that answers every inbox file of ``root`` with
    :func:`_answer`, as a daemon's filesystem transport would."""

    def __init__(self, root: str):
        self.root = root
        self.inbox = os.path.join(root, "inbox")
        self.responses = os.path.join(root, "responses")
        os.makedirs(self.inbox, exist_ok=True)
        os.makedirs(self.responses, exist_ok=True)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            for name in sorted(os.listdir(self.inbox)):
                if not name.endswith(".json") or name.startswith("."):
                    continue
                path = os.path.join(self.inbox, name)
                payload = json.load(open(path))
                os.unlink(path)
                body = _answer(payload)
                if body is None:
                    continue
                tmp = os.path.join(self.responses, f".{name}.tmp")
                with open(tmp, "w") as f:
                    json.dump(body, f)
                os.replace(tmp, os.path.join(self.responses, name))
            self.stop.wait(0.005)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=10)


@pytest.mark.parametrize("concurrency,backoff", [(1, 0), (3, 1), (8, 2)])
def test_run_load_rows_over_one_root(tmp_path, concurrency, backoff):
    plan = loadgen.synthetic_request_plan(DATES, ["tile0", "tile1"], 17,
                                          smoothed_every=5)
    rows = {}
    for name, mod in (("jax", jax_loadgen), ("torch", loadgen)):
        root = str(tmp_path / name)
        with Responder(root):
            rows[name] = mod.run_load(mod._Target(root=root), plan,
                                      concurrency=concurrency,
                                      timeout_s=0.5,
                                      backoff_budget=backoff)
    assert set(rows["torch"]) == set(rows["jax"])
    for key in COUNT_ROWS + ("serve_trace_coverage",
                             "serve_batch_mean_size",
                             "serve_batch_coalesced_total"):
        assert rows["torch"][key] == rows["jax"][key], key
    got = rows["torch"]
    # The script's outcomes: 17 requests, 3 smoothed; one unanswered (a
    # timeout, an error row), one error, two cancelled, two shed for
    # good and two shed with a hint (ok after a backoff when allowed);
    # four cold answers with 2 quarantined pixels each.
    assert got["serve_requests_total"] == 17
    assert got["serve_smoothed_ok_total"] == 3
    assert got["serve_error_total"] == 2
    assert got["serve_cancelled_total"] == 2
    assert got["serve_backoff_total"] == (2 if backoff else 0)
    assert got["serve_rejected_total"] == (2 if backoff else 4)
    assert got["serve_solved_total"] == (7 if backoff else 5)
    assert got["serve_quarantined_pixels"] == 4 * 2


# ---------------------------------------------------------------------------
# the self-contained benches, on the CPU
# ---------------------------------------------------------------------------

def _answers(root: str, n: int) -> dict:
    return {f"load{i:05d}": read_response(root, f"load{i:05d}")
            for i in range(n)}


def _same_states(theirs: dict, ours: dict) -> None:
    """Per request: the same outcome and tile/date; the analysis mean
    within the serving budget."""
    assert sorted(ours) == sorted(theirs)
    for rid, t in theirs.items():
        o = ours[rid]
        assert (o or {}).get("status") == (t or {}).get("status") == "ok"
        for key in ("tile", "date", "n_pixels", "windows_run"):
            assert o.get(key) == t.get(key), (rid, key)
        np.testing.assert_allclose(o["x_mean"], t["x_mean"],
                                   atol=X_MEAN_ATOL, err_msg=rid)


def test_bench_serve_schema_counts_and_states(tmp_path):
    jax_rows = jax_loadgen.bench_serve(str(tmp_path / "jax"), requests=8,
                                       concurrency=2)
    rows = loadgen.bench_serve(str(tmp_path / "torch"), requests=8,
                               concurrency=2, device="cpu")
    assert set(rows) == set(jax_rows)
    assert set(rows["live_telemetry"]) == set(jax_rows["live_telemetry"])
    for key in COUNT_ROWS:
        assert rows[key] == jax_rows[key], key
    assert rows["serve_ok_total"] == 8 and rows["serve_error_total"] == 0
    assert rows["serve_smoothed_ok_total"] == 2
    assert rows["live_telemetry"]["samples"] > 0
    assert any(k.startswith("kafka_serve_")
               for k in rows["live_telemetry"]["series"])
    _same_states(_answers(str(tmp_path / "jax"), 8),
                 _answers(str(tmp_path / "torch"), 8))


def test_bench_fleet_schema_counts_and_states(tmp_path):
    kw = dict(replicas=2, requests=8, concurrency=2, tiles=2)
    jax_rows = jax_loadgen.bench_fleet(str(tmp_path / "jax"), **kw)
    rows = loadgen.bench_fleet(str(tmp_path / "torch"), device="cpu", **kw)
    assert set(rows) == set(jax_rows)
    for key in ("serve_fleet_requests_total", "serve_fleet_ok_total",
                "serve_fleet_rejected_total", "serve_fleet_error_total",
                "serve_fleet_replicas", "serve_backoff_total"):
        assert rows[key] == jax_rows[key], key
    assert rows["serve_fleet_ok_total"] == 8
    assert rows["serve_fleet_error_total"] == 0
    _same_states(_answers(str(tmp_path / "jax" / "router"), 8),
                 _answers(str(tmp_path / "torch" / "router"), 8))


def test_concurrency_sweep_schema_and_counts(tmp_path):
    kw = dict(concurrencies=(1, 2), tiles=2)
    jax_rows = jax_loadgen.bench_concurrency_sweep(str(tmp_path / "jax"),
                                                   **kw)
    rows = loadgen.bench_concurrency_sweep(str(tmp_path / "torch"),
                                           device="cpu", **kw)
    assert set(rows) == set(jax_rows)
    assert rows["serve_sweep_concurrencies"] == [1, 2]
    assert rows["serve_error_total"] == jax_rows["serve_error_total"] == 0
    for ours, theirs in zip(rows["serve_sweep"], jax_rows["serve_sweep"]):
        assert set(ours) == set(theirs)
        for key in ("concurrency", "serve_ok_total", "serve_error_total",
                    "serve_solved_total"):
            assert ours[key] == theirs[key], key


def test_in_process_replicas_linearise_at_once():
    """Threads that linearise at once (two in-process replicas' service
    workers, as in bench_fleet) take ``collective.transforms()``: without
    it forward-mode AD's process-wide dual level breaks them."""
    import torch

    from kafka_tpu_torch.core import solvers
    from kafka_tpu_torch.obsops import IdentityOperator

    op = IdentityOperator(2, obs_indices=(0, 1))
    x = torch.rand(400, 2, generator=torch.Generator().manual_seed(0))
    want = solvers._call_linearize(op.linearize, None, x)
    errors, got = [], []
    n_threads, calls = min(32, (os.cpu_count() or 2) + 1), 10

    def work():
        try:
            for _ in range(calls):
                got.append(solvers._call_linearize(op.linearize, None, x))
        except Exception as exc:  # noqa: BLE001 — collected and asserted
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(got) == n_threads * calls
    for lin in got:
        for a, b in zip(lin, want):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# main: exit codes
# ---------------------------------------------------------------------------

def _main(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(argv)
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv,rc", [
    (["--concurrency-sweep", "1,8", "--root", "{root}"], 2),
    (["--root", "{root}", "--requests", "0"], 0),
    (["--root", "{root}", "--requests", "2", "--timeout-s", "0.2",
      "--concurrency", "2", "--tiles", "tile0,tile1", "--dates",
      "2017-07-02,2017-07-04", "--deadline-s", "5", "--smoothed", "2",
      "--backoff", "1"], 1),
    (["--requests", "many"], 2),
    (["--root", "{root}", "--bogus"], 2),
])
def test_main_exit_codes_equal(tmp_path, argv, rc):
    argv = [a.format(root=str(tmp_path / "root")) for a in argv]
    theirs = _main(jax_loadgen, argv)
    ours = _main(loadgen, argv)
    assert ours[0] == theirs[0] == rc, (ours[2], theirs[2])
    if rc != 2:
        assert set(json.loads(ours[1])) == set(json.loads(theirs[1]))
    else:
        assert ours[2].splitlines()[-1] == theirs[2].splitlines()[-1]


@pytest.mark.parametrize("argv,key", [
    (["--synthetic", "--requests", "4", "--concurrency", "2"],
     "serve_p50_ms"),
    (["--fleet", "2", "--requests", "4", "--concurrency", "2"],
     "serve_fleet_p50_ms"),
])
def test_main_in_process_modes_on_the_cpu(argv, key):
    rc, out, err = _main(loadgen, argv + ["--device", "cpu"])
    assert rc == 0, err
    rows = json.loads(out)
    assert key in rows and not rows.get(
        "serve_error_total", rows.get("serve_fleet_error_total"))


def test_root_mode_needs_no_device(tmp_path, monkeypatch):
    """``--root`` drives a daemon in another process: no CUDA needed."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, _ = _main(loadgen, ["--root", str(tmp_path), "--requests",
                                 "0"])
    assert rc == 0 and json.loads(out)["serve_requests_total"] == 0
    start = time.perf_counter()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loadgen.main(["--synthetic"])
    assert time.perf_counter() - start < 30
