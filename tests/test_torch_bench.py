"""The port's bench (``kafka_tpu_torch.bench``), roofline and
measure_baseline against the JAX package's, on the CPU.

- ``assemble_result``: the port's artifact carries the JAX bench's key
  set on the same inputs, with the JAX null conventions (the cases of
  tests/test_bench_schema.py); the kernel rows are null on the CPU;
- the bench's TIP date solve at 256 px, on each of its three routes,
  equals ``kafka_tpu``'s ``assimilate_date_jit`` within the 2e-3 state
  budget of tests/test_solvers.py;
- ``bench_oracle``'s inputs give the JAX oracle's solution;
- ``roofline``'s ``min_traffic_bytes`` column equals the JAX tool's for
  every component, and its kernel bounds equal ``chip_smoke.py``'s;
- ``measure_baseline barrax`` at 32 x 32 px and 2 dates writes the
  states the JAX pipeline writes, within the S2 driver parity budgets of
  tests/test_torch_drivers.py, and prints the JAX JSON keys.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as jax_bench
from kafka_tpu import telemetry as jax_telemetry
from kafka_tpu.telemetry import MetricsRegistry as JaxRegistry
from kafka_tpu_torch import bench
from kafka_tpu_torch import telemetry
from kafka_tpu_torch.telemetry import MetricsRegistry
from kafka_tpu_torch.tools import measure_baseline, roofline

CPU = torch.device("cpu")
X_ATOL = 2e-3                      # tests/test_solvers.py:702-716
Y_ATOL = 1e-5                      # forward model (h0) atol
STATE_ATOL = 2e-3                  # tests/test_torch_drivers.py
SIGMA_RTOL, SIGMA_ATOL = 1e-2, 2e-3

#: the JAX bench artifact's key set (tests/test_bench_schema.py).
EXPECTED_KEYS = {
    "metric", "value", "unit",
    "vs_baseline", "vs_baseline_at_scale",
    "oracle_ms_median", "oracle_ms_spread", "oracle_ms_min",
    "n_pix_device", "n_pix_matched",
    "device_px_s_matched", "device_ms_matched_median",
    "device_ms_matched_spread",
    "device_xla_ms", "device_xla_ms_spread",
    "device_pallas_ms", "device_pallas_ms_spread", "device_pallas_px_s",
    "device_pallas_fused_lin_ms", "device_pallas_fused_lin_ms_spread",
    "device_pallas_fused_lin_px_s",
    "device_smoother_ms", "device_smoother_px_s",
    "e2e_pixel_steps_per_s", "e2e_pixel_steps_per_s_spread",
    "e2e_device_fraction", "e2e_n_pixels",
    "serve_p50_ms", "serve_p99_ms", "serve_cold_ms",
    "serve_rejected_total", "serve_requests_total",
    "serve_smoothed_p50_ms", "serve_smoothed_p99_ms",
    "serve_trace_coverage", "serve_slowest_ms",
    "live_telemetry",
    "serve_fleet_p50_ms", "serve_fleet_p99_ms", "serve_fleet_replicas",
    "serve_fleet_requests_total", "serve_fleet_rerouted_total",
    "serve_backoff_total",
    "serve_slo_alerts_total", "serve_slo_budget_remaining",
    "probe_device_ms", "probe_host_ms", "probe_retried",
    "unhealthy_reasons", "probe_host_after_ms", "unhealthy",
    "serve_sweep", "serve_batched_px_s", "serve_batch_mean_size",
    "serve_queue_wait_p99_ms", "serve_unbatched_p99_ms",
    "serve_unbatched_queue_wait_p99_ms",
    "telemetry", "solver_health", "quality", "perf", "slo",
    "device_profile", "program_contracts",
}
HEALTH_KEYS = {"probe_device_ms", "probe_host_ms", "probe_retried",
               "unhealthy", "unhealthy_reasons"}

#: row dicts as the loadgen benches and the smoother bench emit them
#: (tests/test_bench_schema.py's).
SERVE_ROWS = {
    "serve_p50_ms": 4.5, "serve_p99_ms": 22.0, "serve_cold_ms": 800.0,
    "serve_rejected_total": 0, "serve_requests_total": 24,
    "serve_ok_total": 24, "serve_cancelled_total": 0,
    "serve_error_total": 0,
    "serve_smoothed_p50_ms": 9.0, "serve_smoothed_p99_ms": 35.0,
    "serve_smoothed_ok_total": 6,
    "serve_trace_coverage": 1.0, "serve_slowest_ms": 25.5,
    "serve_slo_alerts_total": 0, "serve_slo_budget_remaining": 1.0,
    "live_telemetry": {
        "scrape_url": "http://127.0.0.1:1/metrics", "samples": 3,
        "scrape_errors": 0,
        "series": {"kafka_serve_queue_depth": [0.0, 2.0, 0.0]},
    },
}
FLEET_ROWS = {
    "serve_fleet_p50_ms": 5.1, "serve_fleet_p99_ms": 30.0,
    "serve_fleet_requests_total": 24, "serve_fleet_ok_total": 24,
    "serve_fleet_rejected_total": 0, "serve_fleet_error_total": 0,
    "serve_fleet_rps": 50.0, "serve_fleet_rerouted_total": 0,
    "serve_fleet_replicas": 3, "serve_fleet_cold_ms": 900.0,
    "serve_backoff_total": 0,
}
SWEEP_ROWS = {
    "serve_sweep": [
        {"concurrency": 1, "serve_p99_ms": 40.0,
         "serve_queue_wait_p99_ms": 1.0, "serve_batch_mean_size": 1.0,
         "serve_batch_coalesced_total": 0, "serve_px_s": 6.0e3},
        {"concurrency": 32, "serve_p99_ms": 210.0,
         "serve_queue_wait_p99_ms": 160.0, "serve_batch_mean_size": 7.5,
         "serve_batch_coalesced_total": 30, "serve_px_s": 1.1e4},
    ],
    "serve_sweep_concurrencies": [1, 32],
    "serve_batched_px_s": 1.1e4,
    "serve_batch_mean_size": 7.5,
    "serve_queue_wait_p99_ms": 160.0,
    "serve_unbatched_p99_ms": 260.0,
    "serve_unbatched_queue_wait_p99_ms": 240.0,
}
SMOOTHER_ROWS = {"device_smoother_ms": 12.5, "device_smoother_px_s": 1.05e7}
#: a contracts snapshot stand-in (the census of 16 programs is taken once,
#: in test_program_contracts_snapshot_on_the_cpu).
CONTRACTS = {"programs": {"date_twostream_inkernel": "a" * 16},
             "findings": 0, "clean": True, "error": None}

MEASURED = dict(
    oracle=(1.0e5, 160.0, 12.0, 154.0),
    device_matched=(2.0e6, 8.0, 0.5),
    device=(8.2e7, 6.4, 0.05),
    e2e=(5.0e4, 0.55, 7212, 1.2e4),
)


def _assemble(reg, host_after_ms=0.3, serve=SERVE_ROWS, fleet=FLEET_ROWS,
              smoother=SMOOTHER_ROWS, sweep=SWEEP_ROWS, **kw):
    health = bench.probe_health(retry_wait_s=0.0, registry=reg)
    kw = {"pallas": None, "fused_lin": None, **MEASURED, **kw}
    return health, bench.assemble_result(
        health, serve=serve, fleet=fleet, smoother=smoother, sweep=sweep,
        host_after_ms=host_after_ms, registry=reg,
        program_contracts=CONTRACTS, **kw)


def test_key_set_is_the_jax_benchs_on_the_same_inputs(monkeypatch):
    """Both packages assemble an artifact from the same measured rows:
    the same keys, and the same values wherever the row flows through."""
    monkeypatch.setattr(jax_bench, "program_contracts_snapshot",
                        lambda: CONTRACTS)
    with telemetry.use(MetricsRegistry()) as reg:
        health, port = _assemble(reg)
    with jax_telemetry.use(JaxRegistry()) as jreg:
        want = jax_bench.assemble_result(
            health, pallas=None, fused_lin=None, serve=SERVE_ROWS,
            fleet=FLEET_ROWS, smoother=SMOOTHER_ROWS, sweep=SWEEP_ROWS,
            host_after_ms=0.3, registry=jreg, **MEASURED)
    assert set(port) == set(want) == EXPECTED_KEYS
    snapshots = {"telemetry", "solver_health", "quality", "perf", "slo",
                 "device_profile"}
    for key in EXPECTED_KEYS - snapshots:
        assert port[key] == want[key], key
    for key in ("solver_health", "quality", "slo", "device_profile"):
        assert set(port[key]) == set(want[key]), key
    assert HEALTH_KEYS <= set(health)


def test_kernel_rows_null_on_the_cpu():
    assert bench.bench_kernel_rows(256, device="cpu") == (None, None)
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg)
    for key in ("device_pallas_ms", "device_pallas_ms_spread",
                "device_pallas_px_s", "device_pallas_fused_lin_ms",
                "device_pallas_fused_lin_ms_spread",
                "device_pallas_fused_lin_px_s"):
        assert result[key] is None, key
    # No card: the device probe does not run and its row is null.
    assert result["probe_device_ms"] is None


def test_telemetry_snapshot_carries_health_gauges():
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg)
        host_gauge = reg.value("kafka_health_probe_host_ms")
    tel = result["telemetry"]
    assert tel["kafka_health_probe_host_ms"] == host_gauge
    assert round(host_gauge, 3) == result["probe_host_ms"]
    assert "kafka_health_unhealthy" in tel


def test_solver_health_snapshot_sums_labelled_series():
    with telemetry.use(MetricsRegistry()) as reg:
        reg.counter("kafka_solver_quarantined_pixels_total", "t").inc(3)
        reg.counter("kafka_solver_clip_saturated_total", "t").inc(
            2, param="lai")
        reg.counter("kafka_solver_clip_saturated_total", "t").inc(
            1, param="sm")
        _, result = _assemble(reg)
    snap = result["solver_health"]
    assert snap["quarantined_pixels"] == 3
    assert snap["clip_saturated"] == 3
    assert snap["cap_bailouts"] == 0
    with telemetry.use(MetricsRegistry()) as reg:
        _, clean = _assemble(reg)
    assert all(v == 0 for v in clean["solver_health"].values())


def test_quality_snapshot_always_present():
    from kafka_tpu_torch.telemetry import quality as q

    with telemetry.use(MetricsRegistry()) as reg:
        _, clean = _assemble(reg)
    snap = clean["quality"]
    assert snap["verdict"] is None
    assert set(snap["windows"]) == set(q.VERDICTS)
    with telemetry.use(MetricsRegistry()) as reg:
        led = q.get_ledger(reg)
        led.record_window("2021-01-01", [0.9, 1.1], n_valid=10)
        led.record_window("2021-01-02", [44.0, 1.0], n_valid=10)
        _, result = _assemble(reg)
    snap = result["quality"]
    assert snap["windows"][q.CONSISTENT] == 1
    assert snap["windows"][q.OVERCONFIDENT] == 1
    assert snap["verdict"] == q.OVERCONFIDENT


def test_slo_snapshot_always_present():
    from kafka_tpu_torch.telemetry import slo

    with telemetry.use(MetricsRegistry()) as reg:
        _, clean = _assemble(reg)
    snap = clean["slo"]
    assert snap["enabled"] is False
    assert snap["alerts_fired"] == 0 and snap["firing"] == []
    assert clean["serve_slo_alerts_total"] == 0
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg, serve=None)
    assert result["serve_slo_alerts_total"] is None
    with telemetry.use(MetricsRegistry()) as reg:
        slo.get_engine(reg).evaluate_once(now=100.0)
        _, result = _assemble(reg)
    snap = result["slo"]
    assert snap["enabled"] is True
    assert set(snap["objectives"]) == {
        "availability", "latency", "quality", "solver", "perf"}
    assert all(o["budget_remaining"] == 1.0
               for o in snap["objectives"].values())


def test_device_profile_snapshot_always_present():
    with telemetry.use(MetricsRegistry()) as reg:
        _, clean = _assemble(reg)
    snap = clean["device_profile"]
    assert set(snap) == {"captures_parsed", "device_ms",
                         "collective_fraction", "kernels",
                         "hbm_peak_bytes", "live_buffer_bytes"}
    assert snap["captures_parsed"] == 0 and snap["kernels"] == []
    assert snap["collective_fraction"] is None


def test_program_contracts_snapshot_on_the_cpu():
    """The census snapshot of the registered programs, taken on the CPU
    when asked for it, cached per device, and never raising: without a
    card its default device (CUDA) becomes an error field."""
    with telemetry.use(MetricsRegistry()) as reg:
        health = bench.probe_health(retry_wait_s=0.0, registry=reg)
        result = bench.assemble_result(
            health, pallas=None, host_after_ms=0.3, registry=reg,
            run_device="cpu", **MEASURED)
    snap = result["program_contracts"]
    assert set(snap) == {"programs", "findings", "clean", "error"}
    assert snap["error"] is None
    assert snap["clean"] is True and snap["findings"] == 0
    assert len(snap["programs"]) >= 14
    assert all(isinstance(fp, str) and len(fp) == 16
               for fp in snap["programs"].values())
    assert bench.program_contracts_snapshot("cpu") is snap
    if not torch.cuda.is_available():
        assert bench.program_contracts_snapshot()["error"]


def test_json_serialisable_one_line():
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg)
    line = json.dumps(result)
    assert "\n" not in line
    assert json.loads(line)["metric"] == "assimilation_throughput"


def test_unhealthy_flag_closes_the_bracket():
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg, host_after_ms=bench.HEALTHY_HOST_MS * 10,
                              serve=None, fleet=None, sweep=None,
                              smoother=None, e2e=(5.0e4, 0.55, 7212))
    assert result["unhealthy"] is True
    assert result["e2e_pixel_steps_per_s_spread"] is None


def test_numbers_flow_through():
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg)
    assert result["value"] == 8.2e7
    assert result["vs_baseline"] == pytest.approx(20.0)
    assert result["vs_baseline_at_scale"] == pytest.approx(820.0)
    assert result["e2e_n_pixels"] == 7212
    assert result["oracle_ms_min"] == 154.0


@pytest.mark.parametrize("rows,keys", [
    ("serve", ("serve_p50_ms", "serve_p99_ms", "serve_rejected_total",
               "serve_trace_coverage", "serve_slowest_ms",
               "live_telemetry", "serve_smoothed_p99_ms")),
    ("fleet", ("serve_fleet_p50_ms", "serve_fleet_p99_ms",
               "serve_fleet_rerouted_total", "serve_backoff_total")),
    ("smoother", ("device_smoother_ms", "device_smoother_px_s")),
    ("sweep", ("serve_sweep", "serve_batched_px_s",
               "serve_batch_mean_size", "serve_queue_wait_p99_ms",
               "serve_unbatched_p99_ms",
               "serve_unbatched_queue_wait_p99_ms")),
])
def test_rows_flow_through_or_degrade_to_null(rows, keys):
    """Each bench's rows land verbatim; a run without that bench
    degrades them to null (bench_compare then gates the disappearance)."""
    source = {"serve": SERVE_ROWS, "fleet": FLEET_ROWS,
              "smoother": SMOOTHER_ROWS, "sweep": SWEEP_ROWS}[rows]
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg)
    for key in keys:
        assert result[key] == source[key], key
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg, **{rows: None})
    for key in keys:
        assert result[key] is None, key


def test_kernel_triples_flow_through():
    with telemetry.use(MetricsRegistry()) as reg:
        _, result = _assemble(reg, pallas=(1.4e8, 3.8, 0.04),
                              fused_lin=(2.6e8, 2.0, 0.03))
    assert result["device_pallas_ms"] == 3.8
    assert result["device_pallas_px_s"] == 1.4e8
    assert result["device_pallas_fused_lin_ms"] == 2.0
    assert result["device_pallas_fused_lin_px_s"] == 2.6e8


def test_bench_reexports_the_cards_health_bands():
    from kafka_tpu_torch.telemetry import health

    assert bench.HEALTHY_DEVICE_MS == health.HEALTHY_DEVICE_MS
    assert bench.DEVICE_BAND == health.DEVICE_BAND
    assert bench.HEALTHY_HOST_MS == health.HEALTHY_HOST_MS
    assert bench.probe_device is health.probe_device


# -- the bench's date solve and oracle --------------------------------------

@pytest.mark.parametrize("route", [
    {"use_pallas": False},
    {"use_pallas": True, "inkernel_linearize": False},
    {"use_pallas": True, "inkernel_linearize": True},
], ids=["plain", "row_loop", "fused_gn"])
def test_date_solve_equals_jax_at_256_px(route):
    """The solve each device row times, on the CPU (the plain versions),
    against the JAX ``assimilate_date_jit`` on the same problem."""
    from kafka_tpu.core.solvers import assimilate_date_jit
    from kafka_tpu.testing.synthetic import make_tip_problem as jax_problem
    from kafka_tpu_torch.core.solvers import assimilate_date
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    op, bands, x0, p_inv0 = make_tip_problem(256, device=CPU)
    opts = bench.date_solve_options(op, CPU, **route)
    assert opts.get("use_pallas") == (None if route.get(
        "inkernel_linearize") else route["use_pallas"])
    x, a, diags = assimilate_date(op.linearize, bands, x0, p_inv0, None,
                                  opts, device=CPU)
    jop, jbands, jx0, jp0 = jax_problem(256)
    jx, ja, jdiags = assimilate_date_jit(
        jop.linearize, jbands, jx0, jp0, None,
        {"state_bounds": (jnp.asarray(jop.state_bounds[0]),
                          jnp.asarray(jop.state_bounds[1]))})
    # The same draws; y is each package's forward model of the truth.
    np.testing.assert_allclose(bands.y.numpy(), np.asarray(jbands.y),
                               atol=Y_ATOL)
    np.testing.assert_array_equal(bands.mask.numpy(),
                                  np.asarray(jbands.mask))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=X_ATOL)
    assert int(diags.n_iterations) == int(jdiags.n_iterations)


def test_device_sizes_on_the_cpu_returns_the_triple():
    rows = bench.bench_device_sizes([64, 64], device="cpu", target_s=0.0,
                                    reps=1, ks=(1, 2))
    px_s, ms, spread = rows[64]
    assert px_s == pytest.approx(64 / (ms / 1e3))
    assert spread >= 0.0


def test_oracle_solution_equals_the_jax_oracles():
    """``bench_oracle`` times the oracle on ``oracle_inputs``: the JAX
    bench's problem (same draws), its linearisation the port's."""
    import jax

    from kafka_tpu.testing.oracle import iterated_sparse_solve as jax_solve
    from kafka_tpu.testing.synthetic import make_tip_problem as jax_problem
    from kafka_tpu_torch.testing.oracle import iterated_sparse_solve

    args = bench.oracle_inputs(256)
    x, _, n_iters = iterated_sparse_solve(*args)
    op, bands, x0, p_inv0 = jax_problem(256, host=True)

    def linearize(xv):
        lin = op.linearize(None, jax.device_put(np.asarray(xv, np.float32)))
        return list(np.asarray(lin.h0)), list(np.asarray(lin.jac))

    jx, _, j_iters = jax_solve(linearize, list(bands.y), list(bands.r_inv),
                               list(bands.mask), np.asarray(x0),
                               np.asarray(p_inv0))
    np.testing.assert_allclose(np.asarray(args[1]), np.asarray(bands.y),
                               atol=Y_ATOL)
    for port, want in zip(args[2:], (bands.r_inv, bands.mask, x0, p_inv0)):
        np.testing.assert_array_equal(np.asarray(port), np.asarray(want))
    assert n_iters == j_iters
    np.testing.assert_allclose(np.asarray(x), np.asarray(jx), atol=X_ATOL)
    px_s, ms, spread, best = bench.bench_oracle(256, reps=1)
    assert spread == 0.0 and best == ms
    assert px_s == pytest.approx(256 / (ms / 1e3))


# -- roofline -----------------------------------------------------------------

ROOFLINE_N = 1024


@pytest.fixture(scope="module")
def roofline_rows():
    """Both tools' component rows at ROOFLINE_N px on the CPU, timing
    stubbed (only the accounting is compared here)."""
    from tools import roofline as jax_roofline

    stub = (lambda *a, **k: (1e-3, 0.0))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_roofline, "slope_time", stub)
    mp.setattr(roofline, "slope_time", stub)
    try:
        jax_rows, port_rows = [], []
        jax_roofline.tip_components(ROOFLINE_N, jax_rows)
        jax_roofline.prosail_components(ROOFLINE_N, jax_rows)
        roofline.tip_components(ROOFLINE_N, port_rows, CPU)
        roofline.prosail_components(ROOFLINE_N, port_rows, CPU)
    finally:
        mp.undo()
    return ({r["component"]: r for r in jax_rows},
            {r["component"]: r for r in port_rows})


def test_roofline_min_traffic_equals_the_jax_tools(roofline_rows):
    jax_rows, port_rows = roofline_rows
    assert set(port_rows) == set(jax_rows) == {
        "tip/linearize", "tip/update", "tip/gn_full",
        "prosail/linearize", "prosail/update"}
    for name, row in port_rows.items():
        assert row["min_traffic_bytes"] == \
            jax_rows[name]["min_traffic_bytes"], name
        assert row["fusion_perfect_ms"] == pytest.approx(
            row["min_traffic_bytes"] / (roofline.HBM_GBPS * 1e9) * 1e3)
        # The cost-model columns stay, null: the JAX row's shape.
        assert set(jax_rows[name]) <= set(row), name
        assert row["xla_bytes"] is None and row["xla_flops"] is None
    assert port_rows["tip/gn_full"]["n_iterations"] == \
        jax_rows["tip/gn_full"]["n_iterations"]


def test_roofline_kernel_rows_take_the_jax_bounds():
    """The card-only rows (skipped on the CPU by both tools) carry the
    JAX tool's analytic bound for their component."""
    from kafka_tpu.telemetry import perf as jax_perf

    for p, nb in ((7, 2), (10, 10)):
        assert roofline.min_traffic_gn_full(ROOFLINE_N, p, nb) == \
            jax_perf.min_traffic_gn_full(ROOFLINE_N, p, nb)
        assert roofline.min_traffic_update(ROOFLINE_N, p, nb) == \
            jax_perf.min_traffic_update(ROOFLINE_N, p, nb)
    assert roofline.min_traffic_gn_inkernel(ROOFLINE_N, 7, 2) == \
        jax_perf.min_traffic_gn_inkernel(ROOFLINE_N, 7, 2)


@pytest.mark.parametrize("inst", [(2, 1), (2, 2), (7, 1), (7, 2), (10, 1),
                                  (10, 10), (11, 1), (11, 2), (11, 10)])
def test_roofline_kernel_bounds_are_chip_smokes(inst):
    """The bound column: each fused_update instance's bytes and
    operations as chip_smoke.py counts them (PERF.md's kernel table)."""
    import chip_smoke

    p, nb = inst
    n = 1 << 19
    read, written = chip_smoke.update_floats(p, nb)
    want = chip_smoke.bound(4.0 * (read + written) * n,
                            chip_smoke.update_flops(p, nb) * n)
    got = roofline.bound(*roofline.fused_update_work(n, p, nb))
    assert got == {k: want[k] for k in ("bound_ms", "bound_by")}


def test_roofline_fused_gn_bound_is_chip_smokes():
    import chip_smoke

    n, group, trips = 1 << 19, 2048, 2.5 * 256
    want = chip_smoke.bound(
        4 * (chip_smoke.MIN_FLOATS_PER_PIXEL * n
             + chip_smoke.MIN_FLOATS_PER_GROUP * (n // group)),
        chip_smoke.FLOPS_PER_PIXEL_TRIP * trips * group
        + chip_smoke.FLOPS_PER_PIXEL_ONCE * n)
    got = roofline.bound(*roofline.fused_gn_work(n, group, trips))
    assert got == {k: want[k] for k in ("bound_ms", "bound_by")}
    # PERF.md's kernel table at 2^19 px: 0.0507 ms (fused_gn) and
    # 0.183 ms (fused_update (10, 10)), bound by bytes.
    assert round(got["bound_ms"], 4) == 0.0507
    assert got["bound_by"] == "bytes"
    upd = roofline.bound(*roofline.fused_update_work(n, 10, 10))
    assert round(upd["bound_ms"], 3) == 0.183


def test_roofline_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(roofline, "slope_time", lambda *a, **k: (1e-3, 0.0))
    out = tmp_path / "roof.json"
    assert roofline.main(["--n", "512", "--device", "cpu", "--skip-prosail",
                          "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == doc
    assert doc["n_pix"] == 512 and doc["platform"] == "cpu"
    assert [r["component"] for r in doc["rows"]] == [
        "tip/linearize", "tip/update", "tip/gn_full"]
    assert all(r["share_of_bound"] <= 1.05 for r in doc["rows"])


# -- measure_baseline ----------------------------------------------------------

def test_measure_baseline_barrax_writes_the_jax_states(tmp_path, capsys):
    """``barrax`` at 32 x 32 px and 2 dates (pivot mask, float16 wire):
    the JAX JSON keys, and every state raster within the S2 driver's
    parity budgets of the JAX pipeline's on the same tree."""
    from kafka_tpu_torch.io.geotiff import read_geotiff

    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert measure_baseline.main(
        ["barrax", "--size", "32", "--dates", "2", "--passes", "1",
         "--device", "cpu", "--keep", str(port_dir)]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == {"row", "n_pixels", "pixel_steps_per_s",
                        "device_fraction"}
    assert row["row"] == "barrax"
    px_steps, frac, n_pix, _ = jax_bench.bench_end_to_end(
        ny=32, nx=32, n_dates=2, outdir=str(jax_dir), passes=1)
    assert row["n_pixels"] == n_pix
    names = sorted(os.listdir(port_dir / "out"))
    assert names == sorted(os.listdir(jax_dir / "out")) and names
    for name in names:
        a, _ = read_geotiff(str(port_dir / "out" / name))
        b, _ = read_geotiff(str(jax_dir / "out" / name))
        if name.endswith("_unc.tif"):
            np.testing.assert_allclose(a, b, rtol=SIGMA_RTOL,
                                       atol=SIGMA_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=STATE_ATOL, err_msg=name)


def test_measure_baseline_oracle_row(capsys):
    assert measure_baseline.main(["oracle", "--oracle-n", "128",
                                  "--reps", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == {"row", "n_pixels", "px_per_s", "ms_median",
                        "ms_spread", "ms_min"}
    assert row["n_pixels"] == 128


def test_measure_baseline_joint_names_h5py_when_missing(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(RuntimeError, match="h5py"):
        measure_baseline.main(["joint", "--size", "32", "--dates", "2",
                               "--device", "cpu"])
