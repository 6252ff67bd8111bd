"""Phase ``bench`` of ``chip_smoke.py`` rehearsed on the CPU: the bench
child (a fresh process, no JAX) runs the bench's rows, the artifact and
the five tools at toy sizes with the plain versions counted as launches;
the gates that only a card can pass fail here and name themselves, and
no other gate fails.  Then ``bench_gates`` on synthetic results, and the
pinned key set against both packages' ``assemble_result``."""

import json
import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402
import torch  # noqa: E402

from kafka_tpu_torch.tools import roofline  # noqa: E402

#: the failures a CPU run must give, and only these: the kernel rows are
#: null, fused_gn and fused_update (7, 2) never launch (their rows and
#: roofline components are card only) and the roofline skips its kernel
#: components.
CPU_ONLY = ("device_pallas_ms is None", "device_pallas_fused_lin_ms is None",
            "launches", "roofline components missing")


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """phase_bench on the CPU at toy sizes: its record, the raised
    failures and the child's artifact."""
    import contextlib
    import io

    workdir = str(tmp_path_factory.mktemp("bench"))
    contracts = {"programs": {"date_twostream_inkernel": {
        "fingerprint": "a" * 16}}}
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(AssertionError) as info:
        chip_smoke.phase_bench(
            torch.device("cpu"), workdir, contracts=contracts, n_device=512,
            n_matched=256, e2e={"ny": 32, "nx": 32, "n_dates": 2},
            roofline_n=512,
            slope={"target_s": 0.0, "reps": 1, "ks": [1, 2]},
            count_plain=True, limit_s=600.0)
    rec = next(json.loads(ln) for ln in out.getvalue().splitlines()
               if ln.startswith('{"phase": "bench"'))
    with open(os.path.join(workdir, "bench.json")) as f:
        artifact = json.load(f)
    return rec, str(info.value), artifact


def test_cpu_run_fails_only_the_card_gates(cpu_run):
    rec, text, _ = cpu_run
    assert text.startswith("bench: ")
    assert len(rec["failures"]) == len(CPU_ONLY)
    for failure, want in zip(rec["failures"], CPU_ONLY):
        assert failure.startswith(want), failure
    assert rec["rc"] == 0 and rec["foreign_modules"] == []
    assert rec["artifact_keys_match"]


def test_cpu_run_drives_every_tool_to_rc_0(cpu_run):
    rec, _, _ = cpu_run
    assert {name: t["rc"] for name, t in rec["tools"].items()} == {
        "bench_compare": 0, "bench_history": 0, "roofline": 0,
        "measure_baseline_barrax": 0, "measure_baseline_oracle": 0}
    assert "no device timing regression" in \
        rec["tool_tails"]["bench_compare"]
    assert rec["launches"]["fused_update_by_instance"]["10x10"] > 0
    assert rec["launches_by_step"]["e2e"]["10x10"] > 0
    assert [r["component"] for r in rec["roofline"]] == [
        "tip/linearize", "tip/update", "tip/gn_full", "prosail/linearize",
        "prosail/update"]


def test_cpu_run_artifact_carries_the_contracts_census(cpu_run):
    _, _, artifact = cpu_run
    assert artifact["program_contracts"] == {
        "programs": {"date_twostream_inkernel": "a" * 16},
        "findings": 0, "clean": True, "error": None}
    assert artifact["n_pix_device"] == 512
    assert artifact["device_pallas_ms"] is None


def _passing():
    child = {"foreign_modules": [], "tools": {"roofline": {"rc": 0}},
             "launches": {"fused_gn": 3, "fused_update_by_instance":
                          {"7x2": 2, "10x10": 1}}}
    artifact = {k: 1.0 for k in chip_smoke.BENCH_KEYS}
    n = 1 << 19
    rows = []
    for name, kernel, extra in (
            ("tip/gn_full_pallas", "fused_update[7,2]", {}),
            ("tip/gn_inkernel", "fused_gn", {"group": 2048,
                                              "trips": 640.0}),
            ("prosail/update_pallas", "fused_update[10,10]", {})):
        row = {"component": name, "kernel": kernel, "launches": 2,
               "pct_hbm_roof_lower_bound": 40.0, **extra}
        row["bound_ms"] = chip_smoke.roofline_kernel_bound(row, n)
        row["share_of_bound"] = 0.5
        rows.append(row)
    return child, artifact, {"n_pix": n, "rows": rows}


def test_bench_gates_pass_a_healthy_card_run():
    assert chip_smoke.bench_gates(*_passing(), 0, 50.0, 75.0) == []


@pytest.mark.parametrize("spoil,match", [
    (lambda c, a, r: c.update(foreign_modules=["jax"]), "imported"),
    (lambda c, a, r: a.pop("telemetry"), "artifact keys"),
    (lambda c, a, r: a.update(device_pallas_ms=float("nan")),
     "device_pallas_ms is nan"),
    (lambda c, a, r: c["launches"].update(fused_gn=0), "launches"),
    (lambda c, a, r: c["launches"]["fused_update_by_instance"].pop("10x10"),
     "launches"),
    (lambda c, a, r: c["tools"]["roofline"].update(rc=1, stderr_tail="x"),
     "roofline: rc 1"),
    (lambda c, a, r: r["rows"][1].update(share_of_bound=1.2),
     "share of bound"),
    (lambda c, a, r: r["rows"][0].update(pct_hbm_roof_lower_bound=110.0),
     "share of bound"),
    (lambda c, a, r: r["rows"][2].update(bound_ms=0.2), "this script's"),
    (lambda c, a, r: r["rows"].pop(0), "components missing"),
], ids=["foreign", "keys", "kernel_row", "fused_gn", "update_10x10",
        "tool_rc", "share", "pct", "bound", "component"])
def test_bench_gates_fail_each_spoiled_result(spoil, match):
    child, artifact, roof = _passing()
    spoil(child, artifact, roof)
    failures = chip_smoke.bench_gates(child, artifact, roof, 0, 50.0, 75.0)
    assert len(failures) == 1 and match in failures[0], failures


def test_bench_gates_budget_and_dead_child():
    assert "budget" in chip_smoke.bench_gates(*_passing(), 0, 80.0,
                                              75.0)[0]
    assert chip_smoke.bench_gates(None, None, None, 1, 5.0, 75.0) == [
        "bench child rc 1, printed False"]


def test_roofline_kernel_bounds_are_the_tools():
    """The script's bound of a roofline row's launches equals the
    tool's own for the same row: the two counts agree."""
    n = 1 << 19
    gn = {"kernel": "fused_gn", "launches": 1, "group": 2048,
          "trips": 512.0}
    assert chip_smoke.roofline_kernel_bound(gn, n) == roofline.bound(
        *roofline.fused_gn_work(n, 2048, 512.0))["bound_ms"]
    upd = {"kernel": "fused_update[7,2]", "launches": 3}
    b, f = roofline.fused_update_work(n, 7, 2)
    assert chip_smoke.roofline_kernel_bound(upd, n) == pytest.approx(
        roofline.bound(3 * b, 3 * f)["bound_ms"], rel=1e-12)
    assert chip_smoke.roofline_kernel_bound({"kernel": None}, n) is None


def test_bench_keys_are_both_packages_assemble_result_keys(monkeypatch):
    import bench as jax_bench
    from kafka_tpu import telemetry as jax_telemetry
    from kafka_tpu.telemetry import MetricsRegistry as JaxRegistry
    from kafka_tpu_torch import bench, telemetry
    from kafka_tpu_torch.telemetry import MetricsRegistry

    rows = dict(oracle=(1.0, 1.0, 0.0, 1.0), device_matched=(1.0, 1.0, 0.0),
                device=(1.0, 1.0, 0.0), pallas=None, e2e=(1.0, 0.5, 4),
                host_after_ms=0.1)
    health = {"probe_device_ms": None, "probe_host_ms": 0.1,
              "probe_retried": False, "unhealthy": False,
              "unhealthy_reasons": []}
    snap = {"programs": {}, "findings": 0, "clean": True, "error": None}
    monkeypatch.setattr(jax_bench, "program_contracts_snapshot",
                        lambda: snap)
    with telemetry.use(MetricsRegistry()) as reg:
        port = bench.assemble_result(health, registry=reg,
                                     program_contracts=snap, **rows)
    with jax_telemetry.use(JaxRegistry()) as reg:
        want = jax_bench.assemble_result(health, registry=reg, **rows)
    assert set(port) == set(want) == chip_smoke.BENCH_KEYS


def test_contracts_snapshot_of_phase_contracts_record():
    rec = {"programs": {"b": {"fingerprint": "2" * 16},
                        "a": {"fingerprint": "1" * 16}}}
    assert chip_smoke.contracts_snapshot_of(rec) == {
        "programs": {"a": "1" * 16, "b": "2" * 16}, "findings": 0,
        "clean": True, "error": None}


def test_beside_runs_while_the_child_does_and_a_raise_kills_it(tmp_path):
    """phase_bench runs ``beside`` (phase lint in main) while its child
    runs; when ``beside`` raises, the child is killed and the error
    propagates."""
    import subprocess

    seen = []
    real = subprocess.Popen

    def popen(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    def beside():
        assert seen and seen[0].poll() is None
        raise RuntimeError("lint failed")

    mp = pytest.MonkeyPatch()
    mp.setattr(subprocess, "Popen", popen)
    try:
        with pytest.raises(RuntimeError, match="lint failed"):
            chip_smoke.phase_bench(torch.device("cpu"), str(tmp_path),
                                   beside=beside)
    finally:
        mp.undo()
    assert seen[0].returncode is not None
