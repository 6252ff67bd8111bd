"""The per-layer readers of the engine's per-date fields
(``date_host_ms``, ``linearize_ms``, ``row_layout_ms``, ``mean_trips``):
the mean over the window's date records, nothing where the program
records no such field (a parent without the fields, the CPU for the
device-timed one), and a fused block's records, each carrying its
share of the block, read as the dates they are."""

import pytest

from benchmark import harness
from benchmark.tests.tiny import SEED, TINY

READERS = {
    "engine.host_ms_per_date": "date_host_ms",
    "solver.linearize_ms_per_date": "linearize_ms",
    "solver.row_layout_ms_per_date": "row_layout_ms",
    "fused_gn.mean_trips": "mean_trips",
}


def _read(name, dates):
    return harness.metric_reader(name)({"dates": dates})


@pytest.mark.parametrize("name,field", READERS.items())
def test_reader_takes_the_mean_over_the_date_records(name, field):
    dates = [{"n_pad": 256, field: v} for v in (1.0, 2.0, 6.0)]
    assert _read(name, dates) == pytest.approx(3.0)


@pytest.mark.parametrize("name,field", READERS.items())
def test_reader_has_nothing_to_read_without_the_field(name, field):
    assert _read(name, [{"n_pad": 256, "n_iterations": 2}] * 3) is None
    assert _read(name, []) is None
    assert harness.metric_reader(name)({}) is None
    # A record that lacks the field is not a zero.
    assert _read(name, [{field: 4.0}, {"n_pad": 256}]) == pytest.approx(4.0)


@pytest.mark.parametrize("name,field", READERS.items())
def test_reader_counts_a_fused_block_as_its_windows(name, field):
    """A block of two windows whose sums were 8 (each record 4) beside
    an unfused date of 1: three dates, a mean of 3."""
    dates = [{field: 1.0},
             {field: 4.0, "fused": 2}, {field: 4.0, "fused": 2}]
    assert _read(name, dates) == pytest.approx(3.0)


@pytest.mark.parametrize("cell,present,absent", [
    ("modis_tip.daily_year", ("engine.host_ms_per_date",
                              "fused_gn.mean_trips"),
     ("solver.row_layout_ms_per_date",)),
    ("s2_prosail.july_chunks", ("engine.host_ms_per_date",
                                "solver.linearize_ms_per_date"),
     ("solver.row_layout_ms_per_date", "fused_gn.mean_trips")),
])
def test_a_traced_tiny_run_reports_the_date_metrics(cell, present, absent):
    """A traced run of the cell at its tiny size on the CPU: the
    program's date records carry the fields the cell's metrics read
    (the device-timed one only on a card)."""
    r = harness.run_cell(cell, SEED, 0.0, True, device="cpu",
                         overrides=TINY[cell])
    for name in present:
        assert r["metrics"][name]["value"] >= 0, name
    assert r["metrics"]["engine.host_ms_per_date"]["value"] > 0
    if "fused_gn.mean_trips" in present:
        assert 1.0 <= r["metrics"]["fused_gn.mean_trips"]["value"] <= 26.0
    for name in absent:
        assert name not in r["metrics"], name
