"""The port's bench_compare and bench_history against the JAX tools.

``kafka_tpu_torch.tools.bench_compare`` and ``.bench_history`` are held
to ``tools.bench_compare`` and ``tools.bench_history`` on the same
artifacts: the cases of ``tests/test_bench_compare.py`` and of the
bench_history part of ``tests/test_perf.py`` as synthetic artifacts in
``tmp_path``, and the checked-in ``BENCH_r01-r05.json`` (read only).
Each case must give the same exit code, the same flagged rows and the
same rendered lines; the port's messages name the port's tools where
the JAX tools name theirs (``PORT_NAMES``)."""

import json
import os

import pytest

from kafka_tpu_torch.tools import bench_compare as bc
from kafka_tpu_torch.tools import bench_history as bh
from kafka_tpu_torch.tools import device_report
from tools import bench_compare as jax_bc
from tools import bench_history as jax_bh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in range(1, 6)]

#: the port's tool names in its messages -> the JAX tools' names.
PORT_NAMES = {
    "python -m kafka_tpu_torch.tools.quality_report": "tools/quality_report.py",
    "python -m kafka_tpu_torch.tools.slo_report": "tools/slo_report.py",
    "python -m kafka_tpu_torch.tools.device_report": "tools/device_report.py",
    "python -m kafka_tpu_torch.tools.trace_report": "tools/trace_report.py",
    "python -m kafka_tpu_torch.cli.programlint": "python -m tools.programlint",
}


def jax_words(text: str) -> str:
    for port, jax in PORT_NAMES.items():
        text = text.replace(port, jax)
    return text


# -- synthetic artifacts, as tests/test_bench_compare.py builds them -------

def artifact(xla_ms=6.4, pallas_ms=3.8, unhealthy=False, telemetry=None):
    return {
        "metric": "assimilation_throughput",
        "device_xla_ms": xla_ms,
        "device_xla_ms_spread": 0.1,
        "device_pallas_ms": pallas_ms,
        "device_pallas_ms_spread": 0.1,
        "device_ms_matched_median": 1.2,
        "unhealthy": unhealthy,
        "telemetry": telemetry or {
            "kafka_engine_device_reads_total": 8,
            "kafka_compile_cache_hits_total": 3,
        },
    }


def without(art, key):
    art = dict(art)
    del art[key]
    return art


def serve_artifact(p50=5.0, p99=20.0, rejected=0, unhealthy=False, **kw):
    art = artifact(unhealthy=unhealthy, **kw)
    art.update({
        "serve_p50_ms": p50, "serve_p99_ms": p99,
        "serve_cold_ms": 800.0, "serve_rejected_total": rejected,
        "serve_requests_total": 24,
    })
    return art


def smoother_artifact(ms=12.5, px_s=1.0e7, smoothed_p99=35.0, **kw):
    art = artifact(**kw)
    art.update({
        "device_smoother_ms": ms,
        "device_smoother_px_s": px_s,
        "serve_smoothed_p99_ms": smoothed_p99,
    })
    return art


def health_artifact(quarantined=0, cap=0, **kw):
    art = artifact(**kw)
    art["solver_health"] = {
        "quarantined_pixels": quarantined, "cap_bailouts": cap,
        "damped_recoveries": 0, "nonfinite": 0, "clip_saturated": 0,
    }
    return art


def slo_artifact(fired=0, firing=(), budget_remaining=1.0, **kw):
    art = artifact(**kw)
    art["slo"] = {
        "enabled": True, "alerts_fired": fired,
        "alerts_resolved": fired, "firing": list(firing),
        "objectives": {},
    }
    art["serve_slo_alerts_total"] = fired
    art["serve_slo_budget_remaining"] = budget_remaining
    return art


def contracts_artifact(programs=None, findings=0, error=None, **kw):
    art = artifact(**kw)
    art["program_contracts"] = {
        "programs": dict(
            programs if programs is not None
            else {"date_twostream_inkernel": "a" * 16,
                  "linearize_twostream": "b" * 16}),
        "findings": findings, "clean": findings == 0, "error": error,
    }
    return art


def quality_artifact(verdict="CONSISTENT", drift=0, **kw):
    art = artifact(**kw)
    art["quality"] = {
        "verdict": verdict,
        "windows": {"CONSISTENT": 4, "OVERCONFIDENT":
                    0 if verdict == "CONSISTENT" else 2},
        "drift_events": drift, "drift_active": 0,
    }
    return art


def devprof_artifact(fraction=0.05, top="fused_gn_kernel", **kw):
    art = artifact(**kw)
    art["device_profile"] = {
        "captures_parsed": 2, "device_ms": 12.5,
        "collective_fraction": fraction,
        "kernels": [{"name": top, "bucket": "compute", "ms": 9.0,
                     "fraction": 0.7}],
        "hbm_peak_bytes": {}, "live_buffer_bytes": 0,
    }
    return art


def traced_artifact(coverage=1.0, slowest=25.0, series=(0.0, 2.0, 0.0),
                    **kw):
    art = serve_artifact(**kw)
    art["serve_trace_coverage"] = coverage
    art["serve_slowest_ms"] = slowest
    art["live_telemetry"] = {"series": {
        "kafka_serve_queue_depth": list(series)}}
    return art


def grown(art, **rows):
    return {**art, **rows}


#: (old, new, extra argv) — every case of tests/test_bench_compare.py
#: plus the delta kinds it does not exercise (quality, device profile,
#: request tracing, the live scrape).
COMPARE_CASES = {
    "parity": (artifact(), artifact(), []),
    "within_threshold": (artifact(), artifact(xla_ms=6.4 * 1.05), []),
    "regression": (artifact(), artifact(xla_ms=6.4 * 1.2), []),
    "regression_7_5": (artifact(), artifact(xla_ms=7.5), []),
    "spread_never_gated": (artifact(),
                           grown(artifact(), device_xla_ms_spread=99.0),
                           []),
    "null_pallas_old": (artifact(pallas_ms=None), artifact(), []),
    "disappeared_row": (artifact(),
                        without(artifact(), "device_pallas_ms"), []),
    "nulled_row": (artifact(), artifact(pallas_ms=None), []),
    "appearing_row": (artifact(),
                      grown(artifact(), device_pallas_fused_lin_ms=2.1),
                      []),
    "improvement": (artifact(xla_ms=6.4), artifact(xla_ms=3.9), []),
    "unhealthy_never_judged": (artifact(),
                               artifact(xla_ms=9.0, unhealthy=True), []),
    "threshold_default": (artifact(), artifact(xla_ms=6.4 * 1.07), []),
    "threshold_0_05": (artifact(), artifact(xla_ms=6.4 * 1.07),
                       ["--threshold", "0.05"]),
    "disappeared_unhealthy": (
        artifact(), without(artifact(unhealthy=True), "device_pallas_ms"),
        []),
    "telemetry_deltas": (artifact(), artifact(telemetry={
        "kafka_engine_device_reads_total": 16,
        "kafka_compile_cache_hits_total": 3}), []),
    "serve_gated": (serve_artifact(), serve_artifact(p99=30.0), []),
    "serve_within": (serve_artifact(), serve_artifact(p50=5.25), []),
    "serve_disappeared": (serve_artifact(),
                          grown(serve_artifact(), serve_p50_ms=None), []),
    "serve_rejected_cold_informational": (
        serve_artifact(rejected=0),
        grown(serve_artifact(rejected=1000), serve_cold_ms=99999.0), []),
    "serve_rows_appear": (artifact(), serve_artifact(), []),
    "serve_unhealthy": (serve_artifact(),
                        serve_artifact(p50=50.0, unhealthy=True), []),
    "smoother_ms_gated": (smoother_artifact(),
                          smoother_artifact(ms=18.75), []),
    "smoothed_p99_gated": (smoother_artifact(),
                           smoother_artifact(smoothed_p99=60.0), []),
    "smoother_px_s_drop": (smoother_artifact(px_s=1.0e7),
                           smoother_artifact(px_s=0.8e7), []),
    "smoother_px_s_rise": (smoother_artifact(px_s=1.0e7),
                           smoother_artifact(px_s=1.5e7), []),
    "smoother_px_s_disappeared": (
        smoother_artifact(),
        grown(smoother_artifact(), device_smoother_px_s=None), []),
    "smoother_rows_appear": (artifact(), smoother_artifact(), []),
    "solver_health_deltas": (health_artifact(cap=2),
                             health_artifact(cap=7), []),
    "quarantine_warns": (health_artifact(quarantined=0),
                         health_artifact(quarantined=5), []),
    "quarantine_preexisting": (health_artifact(quarantined=4),
                               health_artifact(quarantined=5), []),
    "slo_deltas": (slo_artifact(fired=1, budget_remaining=0.9),
                   slo_artifact(fired=2, budget_remaining=0.5), []),
    "slo_fired_warns": (slo_artifact(fired=0),
                        slo_artifact(fired=3,
                                     firing=["availability:page"]), []),
    "slo_preexisting": (slo_artifact(fired=2), slo_artifact(fired=3), []),
    "contracts_deltas": (contracts_artifact(), contracts_artifact(
        programs={"date_twostream_inkernel": "a" * 16,
                  "linearize_twostream": "b" * 16,
                  "linearize_wcm": "c" * 16}), []),
    "contracts_drift_warns": (contracts_artifact(), contracts_artifact(
        programs={"date_twostream_inkernel": "f" * 16,
                  "linearize_twostream": "b" * 16}), []),
    "contracts_findings_warn": (contracts_artifact(findings=0),
                                contracts_artifact(findings=3), []),
    "contracts_stable": (contracts_artifact(), contracts_artifact(), []),
    "contracts_analysis_error": (contracts_artifact(), contracts_artifact(
        programs={}, findings=None,
        error="RuntimeError: trace failed"), []),
    "quality_flip_warns": (quality_artifact(),
                           quality_artifact("OVERCONFIDENT", drift=2), []),
    "devprof_collective_grows": (devprof_artifact(0.05),
                                 devprof_artifact(0.30, top="nccl"), []),
    "trace_coverage_drop": (traced_artifact(),
                            traced_artifact(coverage=0.8, slowest=90.0,
                                            series=(0.0, 5.0, 1.0)), []),
}


def _write(tmp_path, name, doc):
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def _run(main, argv, capsys):
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_case_matches_jax_tool(case, tmp_path, capsys):
    """Exit code, stdout and stderr of ``main`` equal the JAX tool's, and
    so do the gated rows and every delta function's output."""
    old, new, extra = COMPARE_CASES[case]
    argv = [_write(tmp_path, "old.json", old),
            _write(tmp_path, "new.json", new), *extra]
    port = _run(bc.main, argv, capsys)
    want = _run(jax_bc.main, argv, capsys)
    assert port[0] == want[0]
    assert jax_words(port[1]) == want[1]
    assert jax_words(port[2]) == want[2]
    assert bc.device_rows(new) == jax_bc.device_rows(new)
    assert bc.compare_rows(old, new) == jax_bc.compare_rows(old, new)
    for name in ("solver_health_deltas", "quality_deltas", "slo_deltas",
                 "device_profile_deltas", "program_contracts_deltas"):
        warnings, lines = getattr(bc, name)(old, new)
        assert ([jax_words(w) for w in warnings], lines) == \
            getattr(jax_bc, name)(old, new), name
    for name in ("live_telemetry_deltas", "trace_coverage_deltas",
                 "telemetry_deltas"):
        assert [jax_words(ln) for ln in getattr(bc, name)(old, new)] == \
            getattr(jax_bc, name)(old, new), name


@pytest.mark.parametrize("case,rc", [
    ("parity", 0), ("regression", 1), ("unhealthy_never_judged", 0),
    ("threshold_default", 0), ("threshold_0_05", 1),
    ("disappeared_row", 1), ("disappeared_unhealthy", 0),
    ("serve_disappeared", 1), ("smoother_px_s_disappeared", 1),
    ("smoother_px_s_drop", 1), ("quarantine_warns", 0),
    ("contracts_drift_warns", 0),
])
def test_compare_exit_codes(case, rc, tmp_path, capsys):
    """The exit codes the JAX tests pin hold for the port too."""
    old, new, extra = COMPARE_CASES[case]
    argv = [_write(tmp_path, "old.json", old),
            _write(tmp_path, "new.json", new), *extra]
    assert _run(bc.main, argv, capsys)[0] == rc


def test_compare_missing_file_is_usage_error(tmp_path, capsys):
    old = _write(tmp_path, "old.json", artifact())
    argv = [old, str(tmp_path / "nope.json")]
    port = _run(bc.main, argv, capsys)
    want = _run(jax_bc.main, argv, capsys)
    assert port[0] == want[0] == 2
    assert port[1:] == want[1:]


@pytest.mark.parametrize("old,new", [(a, b) for a in range(5)
                                     for b in range(5) if a <= b])
def test_compare_checked_in_rounds(old, new, capsys):
    """Every ordered pair of the archived rounds (wrapped format),
    itself included: the same report as the JAX tool's."""
    argv = [BENCH[old], BENCH[new]]
    port = _run(bc.main, argv, capsys)
    want = _run(jax_bc.main, argv, capsys)
    assert port == want
    assert port[0] == 0


# -- bench_history ----------------------------------------------------------

#: each case: the artifacts, oldest first (the cases of test_perf.py's
#: TestBenchHistory).
HISTORY_CASES = {
    "noisy_row_unjudgeable": [
        {"e2e_pixel_steps_per_s": 74000.0, "device_xla_ms": 7.1,
         "device_pallas_px_s": 1.0e8},
        {"e2e_pixel_steps_per_s": 36000.0, "device_xla_ms": 6.6,
         "device_pallas_px_s": 9.0e7},
        {"e2e_pixel_steps_per_s": 73000.0, "device_xla_ms": 6.5,
         "device_pallas_px_s": 7.0e7},
        {"e2e_pixel_steps_per_s": 44000.0, "device_xla_ms": 5.2,
         "device_pallas_px_s": 6.0e7},
    ],
    "recorded_spread": [
        {"oracle_ms_median": 700.0, "oracle_ms_median_spread": 900.0},
        {"oracle_ms_median": 660.0, "oracle_ms_median_spread": 1900.0},
    ],
    "single_point": [{"serve_p99_ms": 20.0}],
    "flat": [{"serve_p99_ms": 20.0}, {"serve_p99_ms": 20.5}],
    "wrapped_and_bare": [
        {"n": 1, "cmd": "c", "rc": 0, "tail": "",
         "parsed": {"device_xla_ms": 6.4}},
        {"device_xla_ms": 6.5},
    ],
    "nulls_absent_rounds": [
        {"device_pallas_ms": None, "device_xla_ms": 6.4},
        {"device_pallas_ms": 3.8, "device_xla_ms": 6.5},
    ],
    "unhealthy_flagged": [
        {"device_xla_ms": 6.4, "unhealthy": False},
        {"device_xla_ms": 9.4, "unhealthy": True},
        {"device_xla_ms": 6.3},
    ],
    "no_trend_rows": [{"metric": "x"}],
}


def _history_paths(tmp_path, docs):
    return [_write(tmp_path, f"r{i}.json", doc) for i, doc in enumerate(docs)]


@pytest.mark.parametrize("case", sorted(HISTORY_CASES))
@pytest.mark.parametrize("argv", [[], ["--json"], ["--threshold", "0.01"]],
                         ids=["table", "json", "threshold"])
def test_history_case_matches_jax_tool(case, argv, tmp_path, capsys):
    paths = _history_paths(tmp_path, HISTORY_CASES[case])
    port = _run(bh.main, paths + argv, capsys)
    want = _run(jax_bh.main, paths + argv, capsys)
    assert port == want
    assert port[0] == 0
    assert bh.build_history(paths) == jax_bh.build_history(paths)


def test_history_verdicts_as_the_jax_tests_pin_them(tmp_path):
    rows = bh.build_history(_history_paths(
        tmp_path, HISTORY_CASES["noisy_row_unjudgeable"]))["rows"]
    assert rows["e2e_pixel_steps_per_s"]["verdict"] == "unjudgeable"
    assert rows["device_xla_ms"]["verdict"] == "improving"
    assert rows["device_pallas_px_s"]["verdict"] == "regressing"
    rows = bh.build_history(_history_paths(
        tmp_path, HISTORY_CASES["nulls_absent_rounds"]))["rows"]
    assert rows["device_pallas_ms"]["rounds"] == [1]


@pytest.mark.parametrize("doc", [
    {"metric": "x", "device_xla_ms": 6.4},
    {"n": 3, "cmd": "python bench.py", "rc": 0, "tail": "...",
     "parsed": {"metric": "x"}},
    {"n": 1, "cmd": "x", "rc": 0, "tail": "", "parsed": None},
    [1, 2],
], ids=["bare", "wrapped", "wrapped_failed_parse", "not_a_dict"])
def test_unwrap_artifact_matches_jax(doc):
    assert bh.unwrap_artifact(doc) == jax_bh.unwrap_artifact(doc)


def test_history_missing_artifact_exits_2(tmp_path, capsys):
    argv = [str(tmp_path / "gone.json")]
    port = _run(bh.main, argv, capsys)
    want = _run(jax_bh.main, argv, capsys)
    assert port == want
    assert port[0] == 2


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("argv", [[], ["--json"]], ids=["table", "json"])
def test_history_checked_in_rounds(k, argv, capsys):
    """The first ``k`` archived rounds: the JAX tool's table and trend
    document (five rounds flag the e2e row unjudgeable)."""
    port = _run(bh.main, BENCH[:k] + argv, capsys)
    want = _run(jax_bh.main, BENCH[:k] + argv, capsys)
    assert port == want
    if k == 5 and argv:
        rows = json.loads(port[1])["rows"]
        assert rows["e2e_pixel_steps_per_s"]["verdict"] == "unjudgeable"


def test_device_report_reads_artifacts_through_bench_history():
    """device_report holds no copy of the artifact helpers: it loads
    mesh history through bench_history's."""
    assert device_report.load_artifact is bh.load_artifact
    assert not hasattr(device_report, "unwrap_artifact")
