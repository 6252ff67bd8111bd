"""The yardstick's arithmetic: the frozen roofline counts against the
port's, the rate from dump timestamps, the sink's window bookkeeping,
the trace reduction and the per-layer readers, the comparison."""

import math
import time

import numpy as np
import pytest
import torch

from benchmark import compare, harness, roofline, trace
from benchmark.sink import HostSink, StopWindow, pixel_dates


@pytest.mark.parametrize("n,trips", [(4_608_000, 2.0), (1 << 19, 2.4),
                                     (1_205_760, 3.0)])
def test_fused_gn_work_matches_the_port(n, trips):
    from kafka_tpu_torch.tools import roofline as port

    group = math.gcd(n, 2048)
    total = trips * (n // group)
    assert roofline.fused_gn_work(n, group, total) == \
        port.fused_gn_work(n, group, total)
    assert roofline.bound_s(*roofline.fused_gn_work(n, group, total)) * 1e3 \
        == pytest.approx(port.bound(*port.fused_gn_work(
            n, group, total))["bound_ms"])


@pytest.mark.parametrize("n,p,nb", [(1_205_760, 10, 10), (4_608_000, 7, 2),
                                    (1 << 19, 2, 1)])
def test_fused_update_work_matches_the_port(n, p, nb):
    from kafka_tpu_torch.tools import roofline as port

    assert roofline.fused_update_work(n, p, nb) == \
        port.fused_update_work(n, p, nb)


def test_bounds_of_the_tile_and_the_chunk():
    """The kernel table's bound column: 0.4457 ms for a tile date's
    fused_gn, 0.422 ms for a chunk's (10, 10) fused update."""
    n = 4_608_000
    b = roofline.bound_s(*roofline.fused_gn_work(n, 2048, 2.0 * n / 2048))
    assert b * 1e3 == pytest.approx(0.4457, abs=5e-5)
    u = roofline.bound_s(*roofline.fused_update_work(1_205_760, 10, 10))
    assert u * 1e3 == pytest.approx(0.422, abs=5e-4)


def test_rate_from_dump_timestamps():
    # (job, window, dates, completion time)
    done = [(0, 0, 16, 10.5), (0, 1, 16, 11.0), (0, 2, 0, 11.2),
            (1, 0, 16, 12.0)]
    px, span = pixel_dates(done, 1000, since=10.0, until=float("inf"))
    assert (px, span) == (48_000, 2.0)
    px, span = pixel_dates(done, 1000, since=10.0, until=11.1)
    assert (px, span) == (32_000, 1.0)
    assert pixel_dates([], 1000, 0.0, 1.0) == (0, 0.0)


def _sink(windows, n=8, p=3):
    sink = HostSink(n, p, n_valid=6, pinned=False)
    sink.start_job(0, windows, np.array([1, 4]))
    return sink


def test_sink_completes_windows_in_grid_order_and_stops():
    ts = [1, 2, 3]
    sink = _sink([(1, 2), (2, 1), (3, 0)])
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    q = torch.ones(8, dtype=torch.int32)
    # A fused block dumps its windows' data first, then their QA.
    sink.dump_data(ts[0], x, x, None, None)
    sink.dump_data(ts[1], x + 1, x, None, None)
    assert sink.completed == []
    sink.dump_qa(ts[0], q, None)
    sink.dump_qa(ts[1], q * 2, None)
    assert [c[:3] for c in sink.completed] == [(0, 0, 2), (0, 1, 1)]
    np.testing.assert_array_equal(sink.kept[(0, 1)]["x"], x.numpy()[[1, 4]]
                                  + 1)
    np.testing.assert_array_equal(sink.kept[(0, 1)]["qa"], [2, 2])
    sink.stop_at = time.perf_counter()
    # A window without dates dumps no QA: complete at its data.
    with pytest.raises(StopWindow):
        sink.dump_data(ts[2], x, x, None, None)
    assert sink.job_finished()
    with pytest.raises(RuntimeError):
        _sink([(5, 1)]).dump_data(6, x, x, None, None)


class _Evt:
    def __init__(self, name, start, dur, cuda, kind="", annotation=False):
        self._v = (name, start, dur, cuda, kind, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else \
            torch.autograd.DeviceType.CPU

    def activity_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": lambda self_: events})()})()


def test_trace_reduction():
    ev = [
        _Evt("benchmark/window", 0, 1000, False, annotation=True),
        _Evt("kafka/assimilate", 100, 500, False, annotation=True),
        _Evt("kafka/dump", 700, 200, False, annotation=True),
        _Evt("aten::add", 120, 5, False),
        _Evt("kafka/assimilate", 150, 300, True, "gpu_user_annotation"),
        _Evt("fused_gn_kernel<TwoStream>", 150, 100, True, "kernel"),
        _Evt("other_kernel", 200, 100, True, "kernel"),
        _Evt("Memcpy DtoH (Device -> Pinned)", 750, 100, True,
             "gpu_memcpy"),
        _Evt("late_kernel", 990, 50, True, "kernel"),
    ]
    r = trace.reduce(_Prof(ev))
    assert r["window_s"] == pytest.approx(1000e-9)
    # 150-300, 750-850, 990-1000 busy.
    assert r["busy_s"] == pytest.approx(260e-9)
    assert [n for n, _ in r["kernels"]] == ["fused_gn_kernel<TwoStream>",
                                           "other_kernel", "late_kernel"]
    idle = dict(r["idle_gaps"])
    # Gaps 0-150 (none), 300-750 (middle 525: assimilate), 850-990
    # (middle 920: no range open).
    assert idle["kafka/assimilate"] == pytest.approx(450e-9)
    assert idle["none"] == pytest.approx(290e-9)
    assert "kafka/assimilate" not in dict(r["device_ops"])


def test_per_layer_readers():
    run = {
        "trace": {"window_s": 2.0, "busy_s": 1.5,
                  "kernels": [("fused_gn_kernel<x>", 1e-3)] * 4
                  + [("void fused_update_kernel<10, 10>(float)", 5e-4)] * 2
                  + [("k", 1e-5)] * 10},
        "dates": [{"n_pad": 4_608_000, "n_iterations": 2}] * 4,
        "config": {"solver": {"group_block": 2048}},
        "dump_s": 0.1, "window_wall_s": 2.0,
    }

    def read(name):
        return harness.metric_reader(name)(run)

    assert read("device.idle_share") == pytest.approx(25.0)
    assert read("solver.launches_per_date") == pytest.approx(4.0)
    assert read("engine.dump_share") == pytest.approx(5.0)
    assert read("fused_gn.roofline_share") == pytest.approx(
        100 * 0.4457e-3 / 1e-3, rel=2e-4)
    share = read("fused_update.roofline_share")
    assert share == pytest.approx(100 * roofline.bound_s(
        *roofline.fused_update_work(4_608_000, 10, 10)) / 5e-4)
    # Nothing to read: no launch of the kernel, or launches and dates
    # that do not match.
    run["trace"]["kernels"] = [("k", 1e-5)]
    assert read("fused_gn.roofline_share") is None
    assert read("fused_update.roofline_share") is None
    assert harness.metric_reader("device.idle_share")({}) is None


def test_compare_numbers_and_judge():
    ref = {"x": np.zeros((4, 2)), "info": np.ones((4, 2)),
           "qa": np.ones(4, np.int32)}
    good = {"x": np.full((4, 2), 1e-6), "info": np.full((4, 2), 1.0 + 1e-6),
            "qa": np.ones(4, np.int32)}
    bad = {"x": np.full((4, 2), np.nan), "info": np.ones((4, 2)),
           "qa": np.array([1, 2, 1, 1], np.int32)}
    v = compare.numbers([(good, ref), (good, ref)])
    assert v["x_gap_window_median"] == pytest.approx(1e-6)
    assert v["info_gap_window_median"] == pytest.approx(1e-6)
    assert v["qa_mismatch_share"] == 0.0
    w = compare.numbers([(good, ref), (bad, ref)])
    assert w["x_gap_window_median"] == float("inf")
    assert w["qa_mismatch_share"] == pytest.approx(1 / 8)
    limits = {"x_gap_window_median": 1e-5}
    assert compare.judge(v, limits)[0]
    ok, checks = compare.judge(w, limits)
    assert not ok and checks["x_gap_window_median"]["limit"] == 1e-5
    assert not compare.judge(v, {})[0]
    assert compare.numbers([])["x_gap_window_median"] == float("inf")


def test_share_over_counts_a_partial_fault():
    ref = {"x": np.zeros((4, 2)), "info": np.ones((4, 2)), "qa": None}
    part = {"x": np.array([[1e-6, 0.0], [0.0, 1e-6], [0.0, 0.5],
                           [1e-6, 1e-6]]),
            "info": np.ones((4, 2)), "qa": None}
    v = compare.numbers([(part, ref), (part, ref)], share_over=0.1)
    assert v["x_gap_window_median"] <= 1e-6
    assert v["x_gap_share"] == pytest.approx(0.25)
    assert "x_gap_share" not in compare.numbers([(part, ref)])
    assert compare.share_ladder([(part, ref)], (1e-7, 0.1, 1.0)) == {
        "1e-07": 1.0, "0.1": 0.25, "1": 0.0}
