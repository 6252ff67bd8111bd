"""Spans and counters inside the engine's date (``telemetry.spans``:
``span(..., per_date=True)`` and ``DateSums``): the sub-date ranges
``kafka/date_fetch``, ``kafka/date_record``, ``kafka/row_layout``,
``kafka/linearize`` and ``kafka/loop_sync`` nest inside
``kafka/assimilate`` in a ``torch.profiler`` capture, the date records
carry their sums (``date_host_ms``, ``linearize_ms``) and the
``fused_gn`` groups' ``mean_trips``, no JSONL event is written per
sub-date span, and the packed reads still equal the dispatches."""

import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from kafka_tpu_torch import telemetry  # noqa: E402
from kafka_tpu_torch.core import fused_gn  # noqa: E402
from kafka_tpu_torch.core.linalg import pack_rows  # noqa: E402
from kafka_tpu_torch.telemetry import MetricsRegistry  # noqa: E402
from kafka_tpu_torch.telemetry.spans import DateSums, span  # noqa: E402
from kafka_tpu_torch.testing.synthetic import (  # noqa: E402
    make_tip_problem, run_tip_engine)

SUB_DATE = ("date_fetch", "date_solve", "date_record", "linearize",
            "loop_sync", "row_layout")
ENGINE_PHASES = {"advance", "assimilate", "dump", "fused_scan"}
MAX_ITERATIONS = 40
#: the row loop (the kernel's linearisation opted out), linearised in
#: two blocks of the 128-px batch.
ROW_LOOP = {"relaxation": 0.7, "max_iterations": MAX_ITERATIONS,
            "inkernel_linearize": False, "linearize_block": 64}


def _run(scan_window=1, solver_options=None, profiled=False):
    reg = MetricsRegistry()
    with telemetry.use(reg):
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                kf = run_tip_engine(scan_window=scan_window,
                                    solver_options=solver_options,
                                    device="cpu")[0]
            return kf, reg, prof
        kf = run_tip_engine(scan_window=scan_window,
                            solver_options=solver_options, device="cpu")[0]
    return kf, reg, None


@pytest.fixture(scope="module")
def row_loop_run():
    return _run(solver_options=ROW_LOOP, profiled=True)


@pytest.fixture(scope="module")
def fused_gn_runs():
    return {k: _run(scan_window=k) for k in (1, 8)}


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name == name]


def test_sub_date_ranges_nest_inside_assimilate(row_loop_run):
    kf, _, prof = row_loop_run
    outer = _ranges(prof, "kafka/assimilate")
    assert outer
    for phase in SUB_DATE:
        inner = _ranges(prof, f"kafka/{phase}")
        assert inner, phase
        for s, e, tid in inner:
            assert any(s0 <= s and e <= e0 and t0 == tid
                       for s0, e0, t0 in outer), phase
    # One linearize range per call (the call's two blocks inside it),
    # one loop-condition read per round and one after the last.
    rounds = sum(r["n_iterations"] for r in kf.diagnostics_log)
    assert len(_ranges(prof, "kafka/linearize")) == rounds
    assert len(_ranges(prof, "kafka/loop_sync")) == \
        rounds + len(kf.diagnostics_log)
    # pack_rows once a date (P_f^-1) and unpack_rows once (A).
    assert len(_ranges(prof, "kafka/row_layout")) == \
        2 * len(kf.diagnostics_log)


def test_row_loop_records_carry_the_date_sums(row_loop_run):
    kf, reg, _ = row_loop_run
    for rec in kf.diagnostics_log:
        assert 0 < rec["date_host_ms"] < 1e3 * rec["wall_s"] + 1e4
        assert 0 < rec["linearize_ms"] <= 1e3 * rec["wall_s"]
        # Device-timed on a card only; the row loop runs no fused_gn.
        assert "row_layout_ms" not in rec and "mean_trips" not in rec
    hist = reg.value("kafka_engine_phase_seconds", phase="linearize")
    assert hist["count"] == sum(r["n_iterations"]
                                for r in kf.diagnostics_log)
    assert sum(r["linearize_ms"] for r in kf.diagnostics_log) == \
        pytest.approx(1e3 * hist["sum"], rel=1e-6)


def test_fused_gn_records_carry_mean_trips(fused_gn_runs):
    for k, (kf, _, _) in fused_gn_runs.items():
        recs = kf.diagnostics_log
        assert recs and (k == 1 or any("fused" in r for r in recs))
        for rec in recs:
            assert 1.0 <= rec["mean_trips"] <= rec["n_iterations"]
            assert rec["n_iterations"] <= MAX_ITERATIONS + 1
            assert rec["linearize_ms"] == 0.0  # inside the kernel
            assert rec["date_host_ms"] > 0
    # Fused and unfused give the same trips, date for date.
    assert [r["mean_trips"] for r in fused_gn_runs[1][0].diagnostics_log] \
        == [r["mean_trips"] for r in fused_gn_runs[8][0].diagnostics_log]


def test_a_fused_block_splits_its_sums_over_its_windows(fused_gn_runs):
    kf, _, _ = fused_gn_runs[8]
    blocks = {}
    for rec in kf.diagnostics_log:
        if "fused" in rec:
            blocks.setdefault(rec["wall_s"], []).append(rec)
    assert blocks
    for recs in blocks.values():
        assert len(recs) == recs[0]["fused"]
        assert len({r["date_host_ms"] for r in recs}) == 1


@pytest.mark.parametrize("k", [1, 8])
def test_no_event_per_sub_date_span_and_reads_equal_dispatches(
        fused_gn_runs, row_loop_run, k):
    for kf, reg, _ in (fused_gn_runs[k], row_loop_run):
        events = list(reg.events)
        phases = {e["phase"] for e in events if e["event"] == "phase"}
        assert phases <= ENGINE_PHASES
        solves = [e for e in events if e["event"] == "solve"]
        assert len(solves) == len(kf.diagnostics_log)
        assert all("date_host_ms" in e and "linearize_ms" in e
                   for e in solves)
        dispatches = sum(1.0 / r.get("fused", 1)
                         for r in kf.diagnostics_log)
        assert reg.value("kafka_engine_device_reads_total") == dispatches
        for phase in ("date_fetch", "date_record", "row_layout"):
            assert reg.value("kafka_engine_phase_seconds",
                             phase=phase)["count"] > 0


def test_mean_trips_from_the_plain_kernel_outputs():
    """``summarise``'s mean over the groups of ``fused_gn_raw_plain``'s
    per-group trip counts, between 1 and ``max_iterations + 1``."""
    op, obs, x0, p_inv = make_tip_problem(1024, seed=3, device="cpu")
    f32 = torch.float32
    y, w = obs.y.to(f32), obs.r_inv.to(f32)
    m = obs.mask.to(f32)
    xf = x0.T.to(f32).contiguous()
    pf = pack_rows(p_inv)
    args = (op.kernel_linearize_rows, y, w, m, xf, pf, 1e-3, 2, 6, 0.7,
            op.state_bounds, float(xf.numel()))
    raw = fused_gn.fused_gn_raw_plain(*args, block=256)
    per_group = raw[4][0, ::256]
    out = fused_gn.fused_gn_rows(*args, block=256, device="cpu",
                                 mean_trips=True)
    assert len(out) == 10
    assert float(out[9]) == pytest.approx(float(per_group.mean()))
    assert 1.0 <= float(out[9]) <= 6 + 1
    assert int(out[4]) == int(per_group.max())
    # Without the flag the JAX return tuple, unchanged.
    assert len(fused_gn.fused_gn_rows(*args, block=256,
                                      device="cpu")) == 9


class _Event:
    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


def test_date_sums_read_device_pairs_that_completed():
    sums = DateSums()
    assert sums.device_ms("row_layout") is None
    sums.pairs += [("row_layout", _Event(0.0), _Event(1.5)),
                   ("row_layout", _Event(2.0), _Event(2.25)),
                   ("row_layout", _Event(3.0), _Event(9.0, done=False)),
                   ("gp_rows", _Event(4.0), _Event(4.5))]
    assert sums.device_ms("row_layout") == pytest.approx(1.75)
    assert sums.device_ms("gp_rows") == pytest.approx(0.5)
    assert sums.device_ms("linearize") is None


def test_per_date_spans_outside_a_date_add_nothing():
    reg = MetricsRegistry()
    with telemetry.use(reg):
        with span("linearize", per_date=True):
            pass
        with DateSums() as sums:
            with span("linearize", per_date=True):
                pass
            with span("date_record", per_date=True):
                pass
    assert set(sums.seconds) == {"linearize", "date_record"}
    assert reg.value("kafka_engine_phase_seconds",
                     phase="linearize")["count"] == 2
    assert not [e for e in reg.events if e["event"] == "phase"]
    spans = [s for s in reg.trace.to_chrome()["traceEvents"]
             if s.get("ph") == "X"]
    assert [s["name"] for s in spans] == ["linearize", "linearize",
                                          "date_record"]
    assert np.all([s["cat"] == "phase" for s in spans])


def test_sub_date_trace_spans_keep_their_parent(row_loop_run):
    """The trace timeline's sub-date spans, written when their date
    closes, carry the enclosing ``assimilate`` span as their parent and
    lie inside it."""
    _, reg, _ = row_loop_run
    spans = [e for e in reg.trace.to_chrome()["traceEvents"]
             if e.get("ph") == "X"]
    outer = {e["args"]["span_id"]: e for e in spans
             if e["name"] == "assimilate"}
    inner = [e for e in spans if e["name"] in SUB_DATE]
    assert inner and outer
    for e in inner:
        parent = outer[e["args"]["parent_span"]]
        assert parent["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 0.2
