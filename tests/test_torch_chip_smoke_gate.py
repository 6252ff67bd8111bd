"""chip_smoke.py's gates and their inputs, on the CPU with made-up
outputs.  The fused Gauss-Newton kernel must give the float32 plain
version's trips and verdicts, except on a group whose trips the plain
version's own 1-ulp nudge of x_f moves, where the nudged or the float64
count is accepted too.  The packed solve must match its plain version
bit for bit, NaN equal to NaN at the same places."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from kafka_tpu_torch.core.solve_rows import solve_rows_plain  # noqa: E402

BLOCK, GROUPS = 4, 3


def _raw(trips, verdicts):
    """Raw outputs with the given per-group trips and per-pixel verdicts
    (only st and hl matter to the gate)."""
    n = BLOCK * GROUPS
    st = torch.zeros(2, n)
    st[0] = torch.tensor(trips, dtype=torch.float32).repeat_interleave(BLOCK)
    hl = torch.zeros(9, n)
    hl[0] = torch.tensor(verdicts, dtype=torch.float32)
    return [None, None, None, None, st, hl]


V = [1.0] * (BLOCK * GROUPS)
PLAIN = _raw([3, 4, 2], V)
REF = _raw([3, 5, 2], V)
NUDGED = [_raw([3, 5, 2], V), _raw([3, 4, 2], V)]  # moves group 1 only


@pytest.mark.parametrize("kernel_trips,differing,waived", [
    ([3, 4, 2], 0, 0),   # the float32 plain version's trips
    ([3, 5, 2], 0, 1),   # group 1 follows the nudge / float64
    ([3, 6, 2], 1, 0),   # group 1 matches no reference
    ([4, 4, 2], 1, 0),   # group 0 is steady under the nudge: no waiver
])
def test_trip_gate_waives_only_rounding_decided_groups(kernel_trips,
                                                       differing, waived):
    got = cs.held_trips(_raw(kernel_trips, V), PLAIN, REF, NUDGED, BLOCK)
    assert got["rounding_decided_groups"] == 1
    assert (got["groups_differing"], got["groups_waived"]) == (differing,
                                                              waived)
    assert got["verdicts_differing"] == got["verdicts_waived"] == 0


def test_verdict_gate_waives_only_pixels_of_decided_groups():
    plain = _raw([3, 4, 2], V)
    ref_v = list(V)
    ref_v[BLOCK] = ref_v[0] = 2.0  # pixel 0 of groups 0 and 1
    ref = _raw([3, 5, 2], ref_v)
    kern = _raw([3, 4, 2], ref_v)
    got = cs.held_trips(kern, plain, ref, NUDGED, BLOCK)
    assert (got["verdicts_differing"], got["verdicts_waived"]) == (1, 1)


def test_group_case_rows_leave_every_other_group_unobserved():
    n = 8 * 257  # 8-px groups: gcd(2056, 2048)
    rows, observed = cs.group_case_rows(n, 2e-3, torch.device("cpu"))
    assert observed.tolist() == [g % 2 == 0 for g in range(257)]
    unobserved = (torch.arange(n) // 8) % 2 == 1
    assert rows["mask_f"][:, ~unobserved].any()
    assert (rows["mask_f"][:, unobserved] == 0).all()
    assert (rows["r_inv"][:, unobserved] == 0).all()
    assert rows["y"][:, unobserved].isnan().all()
    assert (rows["tol"], rows["relaxation"]) == (2e-3, cs.GROUP_RELAXATION)


NAN = float("nan")


@pytest.mark.parametrize("kern,plain,differing", [
    ([[1.0, 2.0, NAN], [3.0, NAN, 4.0]],
     [[1.0, 2.0, NAN], [3.0, NAN, 4.0]], 0),   # NaN at the same places
    ([[1.0, 2.0, NAN], [3.0, 5.0, 4.0]],
     [[1.0, 2.0, NAN], [3.0, NAN, 4.0]], 1),   # NaN in one only
    ([[NAN, 2.0, 3.0], [3.0, 4.0, 4.0]],
     [[1.0, NAN, 3.0], [3.0, 4.0, 4.0]], 2),   # NaN at other places
    ([[1.0, 2.0, 3.0], [0.0, 4.0, 4.0]],
     [[1.0, 2.0, 3.0000002], [-0.0, 4.0, 4.0]], 2),  # 1 ulp; signed zero
])
def test_solve_gate_counts_pixels_whose_bits_differ(kern, plain, differing):
    a, b = torch.tensor(kern), torch.tensor(plain)
    assert cs.pixels_differing(a, b) == differing
    assert cs.pixels_differing(b, a) == differing
    assert cs.pixels_differing(a, a.clone()) == 0


def test_planted_solve_faults_are_non_finite_in_the_plain_version():
    a, b = cs.spd_rows(7, 300, torch.device("cpu"), seed=3)
    planted_a, planted = cs.plant_solve_faults(a, 7, n_each=8)
    x = solve_rows_plain(planted_a, b)
    bad = ~torch.isfinite(x).all(dim=0)
    hit = torch.cat(list(planted.values()))
    assert hit.unique().numel() == 16
    assert bad[hit].all() and int(bad.sum()) == 16
    assert torch.equal(planted_a[:, ~bad], a[:, ~bad])


# --- the cli phase's helpers ----------------------------------------------

def _jax_fits(n_pad, p, n_bands, k):
    """The JAX engine's own _block_fits on a filter of n_pad pixels."""
    from types import SimpleNamespace

    from kafka_tpu.engine.filter import KalmanFilter as JaxFilter

    kf = SimpleNamespace(gather=SimpleNamespace(n_pad=n_pad), n_params=p,
                         _aux_leaves=JaxFilter._aux_leaves,
                         _SCAN_MAX_STATE_ELEMS=JaxFilter._SCAN_MAX_STATE_ELEMS,
                         _SCAN_MAX_BAND_ELEMS=JaxFilter._SCAN_MAX_BAND_ELEMS,
                         _SCAN_MAX_AUX_BYTES=JaxFilter._SCAN_MAX_AUX_BYTES)
    obs = SimpleNamespace(bands=SimpleNamespace(
        y=SimpleNamespace(shape=(n_bands, n_pad))), aux=None)
    return JaxFilter._block_fits(kf, obs, k)


@pytest.mark.parametrize("n_pad,p,n_bands", [
    (256, 7, 2), (1_205_760, 10, 10), (4_608_000, 7, 2),
    (20_000_000, 7, 2), (3_000_000, 2, 2)])
def test_block_plan_uses_the_jax_guards(n_pad, p, n_bands):
    """Each block of the plan fits the JAX guards, and one more window
    would not (unless the scan window or the grid stopped it)."""
    n_windows = 12
    plan = cs.block_plan(n_windows, n_pad, p, n_bands)
    assert plan[0] == 1 and sum(plan) == n_windows
    max_k = max([k for k in range(1, cs.SCAN_WINDOW + 1)
                 if _jax_fits(n_pad, p, n_bands, k)], default=1)
    for k in plan[1:]:
        assert k & (k - 1) == 0 and k <= max_k
    bucket = 1
    while bucket * 2 <= max_k:
        bucket *= 2
    assert plan[1] == bucket


def test_block_plan_of_the_tile_and_of_a_small_jax_run():
    """The MODIS tile (4,608,000 px, p=7, 2 bands, 8 one-acquisition
    windows): three windows fit, bucketed to blocks of two.  A small run
    fits a block of 8, so the plan is the JAX engine's [1, 4, 2, 1]."""
    assert cs.block_plan(8, 4_608_000, 7, 2) == [1, 2, 2, 2, 1]
    assert cs.plan_fused_fields([1, 2, 2, 2, 1]) == \
        [None, 2, 2, 2, 2, 2, 2, None]
    assert cs.block_plan(8, 256, 7, 2) == [1, 4, 2, 1]
    assert cs.plan_fused_fields([1, 4, 2, 1]) == \
        [None, 4, 4, 4, 4, 2, 2, None]


def test_block_plan_equals_an_engine_run():
    """The formula against the port engine's own plan on the cli grid at
    a small size (its guards are the JAX constants, pinned in
    tests/test_torch_fusion.py)."""
    import argparse
    import datetime

    import numpy as np

    from kafka_tpu_torch.cli import run_synthetic as rs
    from kafka_tpu_torch.testing.synthetic import (MemoryOutput,
                                                   SyntheticObservations)

    mask = rs.make_pivot_mask(24, 28)
    op, params, prior, truth_val, aux_fn, sigma = rs.build_operator(
        "twostream", "cpu")
    truth = np.broadcast_to(truth_val, mask.shape + (7,)).astype(np.float32)
    base = datetime.datetime(2017, 7, 1)
    dates = [base + datetime.timedelta(days=d) for d in range(1, 32, 4)]
    grid = [base + datetime.timedelta(days=d) for d in range(0, 36, 4)]
    obs = SyntheticObservations(dates, op, lambda d: truth, sigma=sigma,
                                mask_prob=0.1, device="cpu")
    kf = rs._make_filter(argparse.Namespace(max_degraded_dates=8,
                                            scan_window=cs.SCAN_WINDOW),
                         mask, MemoryOutput(), op, params, obs, None, "cpu")
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    kf.run(grid, x0, None, p_inv0)
    plan = cs.block_plan(len(dates), kf.gather.n_pad, 7, 2)
    assert [r.get("fused") for r in kf.diagnostics_log] == \
        cs.plan_fused_fields(plan)


@pytest.mark.parametrize("a,b,same", [
    ([1.0, float("nan"), 2.0], [1.0, float("nan"), 2.0], True),
    ([1.0, float("nan"), 2.0], [1.0, 2.0, float("nan")], False),
    ([1.0, 2.0, 3.0], [1.0, 2.0, 3.0000002], False),
    ([0.0, 1.0], [-0.0, 1.0], False),
])
def test_same_bits(a, b, same):
    """NaN equals NaN at the same places; one differing pixel (or a sign
    of zero) fails."""
    import numpy as np

    a = np.array(a, np.float32)
    b = np.array(b, np.float32)
    assert cs.same_bits(a, b) is same
    assert cs.same_bits(a, a.astype(np.float64)) is False


def test_same_bits_on_rasters():
    import numpy as np

    r = np.random.default_rng(0).normal(size=(64, 48)).astype(np.float32)
    assert cs.same_bits(r, r.copy())
    q = r.copy()
    q[17, 5] = np.nextafter(q[17, 5], np.float32(np.inf))
    assert not cs.same_bits(r, q)
    u = (r > 0).astype(np.uint8)
    assert cs.same_bits(u, u.copy()) and not cs.same_bits(u, 1 - u)


def test_expected_outputs_is_the_writers_count(tmp_path):
    """2 p + 1 GeoTIFFs per window: what the JAX writer (and the port's)
    writes for one window's dump_data and dump_qa."""
    import datetime

    import numpy as np

    from kafka_tpu.engine.state import make_pixel_gather
    from kafka_tpu.io import GeoTIFFOutput as JaxOutput

    assert cs.expected_outputs(8, 7) == 120
    g = make_pixel_gather(np.ones((4, 4), bool), pad_multiple=16)
    params = ("a", "b", "c")
    out = JaxOutput(params, (0, 1, 0, 0, 0, -1), folder=str(tmp_path))
    ts = datetime.datetime(2017, 7, 2)
    out.dump_data(ts, np.ones((16, 3), np.float32),
                  np.ones((16, 3), np.float32), g, params)
    out.dump_qa(ts, np.ones(16, np.int32), g)
    out.close()
    assert len(list(tmp_path.glob("*.tif"))) == cs.expected_outputs(1, 3)


@pytest.mark.parametrize("n_pad", [256, 1_205_760, 4_608_000, 9_000_000])
def test_block_plan_counts_the_aux_bytes(n_pad):
    """With a per-pixel float32 aux (the WCM incidence angle) the plan's
    blocks fit the JAX guards' aux budget too."""
    from types import SimpleNamespace

    import numpy as np

    from kafka_tpu.engine.filter import KalmanFilter as JaxFilter

    kf = SimpleNamespace(gather=SimpleNamespace(n_pad=n_pad), n_params=2,
                         _aux_leaves=JaxFilter._aux_leaves,
                         _SCAN_MAX_STATE_ELEMS=JaxFilter._SCAN_MAX_STATE_ELEMS,
                         _SCAN_MAX_BAND_ELEMS=JaxFilter._SCAN_MAX_BAND_ELEMS,
                         _SCAN_MAX_AUX_BYTES=JaxFilter._SCAN_MAX_AUX_BYTES)
    obs = SimpleNamespace(
        bands=SimpleNamespace(y=SimpleNamespace(shape=(2, n_pad))),
        aux=(np.zeros(n_pad, np.float32),))
    plan = cs.block_plan(8, n_pad, 2, 2, aux_bytes=4 * n_pad)
    max_k = max([k for k in range(1, cs.SCAN_WINDOW + 1)
                 if JaxFilter._block_fits(kf, obs, k)], default=1)
    assert all(k <= max_k for k in plan[1:]) and sum(plan) == 8
    assert cs.SCAN_MAX_AUX_BYTES == JaxFilter._SCAN_MAX_AUX_BYTES
    if n_pad == 4_608_000:
        assert plan == [1, 2, 2, 2, 1]


def test_joint_dates_interleave_one_per_window():
    """The joint grid: 12 two-day windows from a day before the first
    date to a day after the last, each holding one date, S2 and S1 in
    turn."""
    s2, s1, grid = cs.joint_dates()
    assert len(s2) == len(s1) == cs.JOINT_N_DATES and len(grid) == 13
    dates = sorted(s2 + s1)
    for k, d in enumerate(dates):
        assert grid[k] < d <= grid[k + 1]
        assert (d in s2) == (k % 2 == 0)


@pytest.fixture
def counted_plain(monkeypatch):
    """The fused update's plain version counted as a launch (per
    instance), so the phases' launch gates can be rehearsed on the CPU."""
    from kafka_tpu_torch.core import fused_update as fu

    real = fu.fused_update_raw_plain

    def counted(*args, **kwargs):
        rows = dict(zip(cs.UPDATE_ROW_NAMES, args), **kwargs)
        inst = (rows["xf_rows"].shape[0], rows["h0"].shape[0])
        fu.fused_update_rows.launches += 1
        by = fu.fused_update_rows.launches_by_instance
        by[inst] = by.get(inst, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(fu, "fused_update_raw_plain", counted)


def _held(rows):
    dev = torch.device("cpu")
    rec = cs.phase_kernel_update(dev, "rehearsal", rows, kernel_reps=1,
                                 plain_reps=1)
    assert rec["pixels_differing_from_plain"] == {"x": 0, "A": 0, "inn": 0,
                                                  "hb": 0}
    faults = cs.phase_faults_update(dev, rows, n_each=4)
    assert all(b["equal"] and b["expected"]
               for b in faults["branches"].values())


def test_phase_main_joint_rehearsal(counted_plain):
    """phase_main_joint at 12 x 12 on the CPU: 12 dates, S2 / S1 in turn,
    no fused block, the launches per instance equal to each sensor's
    iterations, the soil-moisture gate held; then the kernel phases on
    both kept instances."""
    rec, kept = cs.phase_main_joint(torch.device("cpu"), ny=12, nx=12)
    assert rec["sensors"] == ["S2", "S1"] * cs.JOINT_N_DATES
    by = rec["kernel_launches"]["fused_update_by_instance"]
    assert by == {"11x10": rec["iterations"]["S2"],
                  "11x2": rec["iterations"]["S1"]}
    assert rec["mean_abs_sm_err"] < cs.JOINT_SM_GATE
    assert set(kept) == {(11, 10), (11, 2)}
    for inst, rows in kept.items():
        assert rows["xf_rows"].shape == (11, rec["n_pad"])
        assert rows["h0"].shape[0] == inst[1]
        _held(rows)


def test_phase_cli_wcm_rehearsal(tmp_path, counted_plain):
    """phase_cli_wcm at 48 x 48 on the CPU: the driver's summary line,
    the block plan, (2, 2) launches equal to the iterations and every
    GeoTIFF read back bit-identical; then the kernel phases on the kept
    date."""
    rec, kept = cs.phase_cli_wcm(torch.device("cpu"), str(tmp_path),
                                 ny=48, nx=48)
    assert rec["summary"]["operator"] == "wcm"
    assert rec["readback"] == {"files": 40, "differing": 0, "nonfinite": 0}
    assert rec["kernel_launches"]["fused_update_by_instance"] == \
        {"2x2": rec["iterations"]}
    assert kept["xf_rows"].shape[0] == 2
    _held(kept)


def test_phase_cli_wcm_fails_without_kernel_launches(tmp_path):
    """On the CPU nothing launches a kernel: the launch gate refuses."""
    with pytest.raises(AssertionError, match="launches"):
        cs.phase_cli_wcm(torch.device("cpu"), str(tmp_path), ny=32, nx=32)


# --- the real-sensor driver phases ------------------------------------------

@pytest.fixture
def counted_gn_plain(monkeypatch):
    """The fused Gauss-Newton kernel's plain version counted as a launch,
    so phase_cli_modis's launch gate can be rehearsed on the CPU."""
    from kafka_tpu_torch.core import fused_gn as fg

    real = fg.fused_gn_raw_plain

    def counted(*args, **kwargs):
        fg.fused_gn_rows.launches += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(fg, "fused_gn_raw_plain", counted)


def test_phase_main_rehearsal(counted_gn_plain):
    """phase_main at 48 x 48 on the CPU: the tile configuration of
    tip_tile_run, one fused_gn launch per date, the kernel's inputs kept
    on KEEP_DATE."""
    rec, kept = cs.phase_main(torch.device("cpu"), ny=48, nx=48)
    assert rec["dates_assimilated"] == len(cs.TIP_OBS_DAYS) == \
        rec["kernel_launches"]
    assert rec["windows"] == len(cs.TIP_GRID_DAYS) - 1
    assert kept["xf_rows"].shape == (7, rec["n_pad"])


def test_chunk_rasters_is_the_drivers_file_set():
    """The expected names: two chunks, a three-window grid with dates in
    the first two windows (half-open on the right) and none in the last."""
    import datetime

    from kafka_tpu_torch.io import get_chunks

    d = datetime.datetime
    grid = [d(2017, 7, 3), d(2017, 7, 5), d(2017, 7, 7), d(2017, 7, 9)]
    names = cs.chunk_rasters(list(get_chunks(8, 4, (4, 4))), grid,
                             [d(2017, 7, 3), d(2017, 7, 6)], ("a", "b"))
    assert len(names) == 2 * (3 * 4 + 2)
    assert "solver_qa_A2017186_0001.tif" in names      # Jul 5: holds Jul 3
    assert "solver_qa_A2017190_0002.tif" not in names  # Jul 9: no date
    assert "b_A2017190_0002_unc.tif" in names
    assert {cs.chunk_prefix(n) for n in names} == {"0001", "0002"}


def test_phase_cli_s2_rehearsal(tmp_path, counted_plain):
    """phase_cli_s2 at 96 x 96 px in four 48 x 48 chunks on the CPU: every
    chunk-date assimilated, (10, 10) launches equal to the iterations,
    the expected GeoTIFFs, the restart that skips every chunk, the mosaic
    equal to the chunks; then the kernel phase on the kept date."""
    rec, kept = cs.phase_cli_s2(torch.device("cpu"), str(tmp_path), ny=96,
                                nx=96, chunk=48)
    assert rec["chunks"] == 4 and rec["stats"]["dates_assimilated"] == 16
    assert rec["kernel_launches"]["fused_update_by_instance"] == \
        {"10x10": rec["iterations"]}
    assert rec["geotiffs"] == 4 * (4 * 20 + 4)
    assert (rec["restart"]["stats"]["run"],
            rec["restart"]["stats"]["skipped"]) == (0, 4)
    assert rec["mosaic"] == {**rec["mosaic"], "files": 4, "differing": 0}
    assert len(rec["reader_s_per_date"]) == 16
    assert kept["xf_rows"].shape[0] == 10
    _held(kept)


def test_phase_cli_s2_fails_without_kernel_launches(tmp_path):
    with pytest.raises(AssertionError, match="launches"):
        cs.phase_cli_s2(torch.device("cpu"), str(tmp_path), ny=64, nx=64,
                        chunk=64)


def test_phase_cli_modis_rehearsal(tmp_path, counted_gn_plain):
    """phase_cli_modis at 64 x 64 px on the CPU: one chunk, 4 dates, one
    fused_gn launch per date, 4 x 15 GeoTIFFs, TeLAI toward the truth,
    and the kernel's inputs kept on the kept date."""
    rec, kept = cs.phase_cli_modis(torch.device("cpu"), str(tmp_path),
                                   ny=64, nx=64)
    assert rec["stats"]["dates_assimilated"] == cs.CLI_MODIS_DATES == 4
    assert rec["kernel_launches"]["fused_gn"] == 4
    assert rec["geotiffs"] == 4 * 15
    m = rec["median_telai"]
    assert abs(m["last_window"] - m["truth"]) < abs(m["prior"] - m["truth"])
    # phase kernel itself reads the compiled kernel's geometry (the card
    # only); its inputs are the fused_gn call's, on the kept date.
    assert set(kept) == {*cs.ROW_ARGS, "corrupt"}
    assert kept["xf_rows"].shape == (7, rec["n_pad"])


def test_phase_cli_modis_fails_without_kernel_launches(tmp_path):
    with pytest.raises(AssertionError, match="launches"):
        cs.phase_cli_modis(torch.device("cpu"), str(tmp_path), ny=64,
                           nx=64)


# --- the real-sensor path's rest: MOD09, per-pixel, band-sequential,
# the Hessian correction ------------------------------------------------------

def test_phase_cli_mod09_rehearsal(tmp_path):
    """phase_cli_mod09 at 96 x 96 px in four 48 x 48 chunks on the CPU:
    every chunk-date assimilated on the dense path with no kernel
    launch, 8 windows x 21 weights x 2 rasters per chunk, b1_iso at the
    truth, the restart that skips every chunk, the unfused first chunk
    equal to the fused run, the dense update's parts timed."""
    rec = cs.phase_cli_mod09(torch.device("cpu"), str(tmp_path), ny=96,
                             nx=96, chunk=48)
    assert rec["chunks"] == 4 and rec["stats"]["dates_assimilated"] == 32
    assert rec["kernel_launches"]["fused_update"] == 0
    assert rec["geotiffs"] == 4 * cs.CLI_MOD09_DATES * 21 * 2
    assert (rec["restart"]["stats"]["run"],
            rec["restart"]["stats"]["skipped"]) == (0, 4)
    assert rec["unfused_first_chunk"]["differing"] == 0
    assert rec["unfused_first_chunk"]["files"] == cs.CLI_MOD09_DATES * 42
    assert any(rec["fused_per_date"])
    split = rec["dense_update_split"]
    assert split["nonfinite_pixels"] == 0 and split["updates_per_date"] >= 2
    assert {"assembly_ms", "cholesky_ex_ms", "triangular_solves_ms",
            "propagation_ms"} <= set(split)


def test_phase_cli_mod09_refuses_a_retrieval_off_the_truth(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(cs, "MOD09_ISO_GATE", 0.0)
    with pytest.raises(AssertionError, match="b1_iso"):
        cs.phase_cli_mod09(torch.device("cpu"), str(tmp_path), ny=48,
                           nx=48, chunk=48)


def test_phase_per_pixel_rehearsal(counted_plain):
    """phase_per_pixel at 48 x 48 on the CPU: (7, 2) launches equal the
    iterations, the converged fraction and its gauge equal the frozen
    mask's mean, the plain loop's run the same; then the kernel phase on
    the kept iteration."""
    rec, kept = cs.phase_per_pixel(torch.device("cpu"), ny=48, nx=48)
    assert rec["kernel_launches"]["fused_update_by_instance"] == \
        {"7x2": rec["iterations"]}
    assert rec["gauge"] == rec["converged_frac"][-1]
    assert len(rec["converged_frac"]) == rec["dates_assimilated"] == 6
    assert rec["vs_plain"]["max_abs_err"] <= cs.X_ATOL
    default = rec["default_blocks"]
    assert len(default["date_wall_s"]) == 1 and default["iterations"] >= 1
    assert kept["xf_rows"].shape == (7, rec["n_pad"])
    _held(kept)


def test_phase_per_pixel_fails_without_kernel_launches():
    with pytest.raises(AssertionError, match="launches"):
        cs.phase_per_pixel(torch.device("cpu"), ny=48, nx=48)


def test_phase_band_seq_rehearsal(counted_plain):
    """phase_band_seq at 48 x 48 on the CPU: two dates, (7, 1) launches
    equal the per-band iterations, no block fused, the plain loop's run
    the same; then the kernel phases at (7, 1) on the kept inputs and on
    seeded rows of the other one-band instances."""
    rec, kept = cs.phase_band_seq(torch.device("cpu"), ny=48, nx=48)
    assert rec["kernel_launches"]["fused_update_by_instance"] == \
        {"7x1": rec["iterations"]}
    assert rec["iterations"] == sum(rec["iterations_plain"])
    assert not any(d["fused"] for d in rec["per_date"])
    assert kept["h0"].shape[0] == 1
    _held(kept)
    for p, nb in ((2, 1), (10, 1), (11, 1)):
        rows = cs.seeded_update_rows(p, nb, 1000, torch.device("cpu"), p)
        assert rows["jac_rows"].shape == (p, 1000)
        assert rows["pf_rows"].shape == (p * (p + 1) // 2, 1000)
        rec = cs.phase_kernel_update(torch.device("cpu"), "seeded", rows,
                                     kernel_reps=1, plain_reps=1)
        assert not any(rec["pixels_differing_from_plain"].values())


def test_phase_band_seq_fails_without_kernel_launches():
    with pytest.raises(AssertionError, match="launches"):
        cs.phase_band_seq(torch.device("cpu"), ny=48, nx=48)


def test_phase_band_seq_fleet_rehearsal(counted_plain):
    """phase_band_seq_fleet at 12 x 12 on the CPU: the WCM, S2 and joint
    runs each launch only their one-band instance, as often as their
    per-band iterations, with no block fused; then the kernel phase on
    each kept instance."""
    rec, kept = cs.phase_band_seq_fleet(torch.device("cpu"), ny=12, nx=12)
    runs = rec["runs"]
    assert {name: r["instance"] for name, r in runs.items()} == \
        {"wcm": "2x1", "s2": "10x1", "joint": "11x1"}
    for r in runs.values():
        assert r["kernel_launches"]["fused_update_by_instance"] == \
            {r["instance"]: r["iterations"]}
        assert not any(d["fused"] for d in r["per_date"])
    assert [runs[n]["dates_assimilated"] for n in ("wcm", "s2", "joint")] \
        == [1, 1, 2]
    assert set(kept) == {(2, 1), (10, 1), (11, 1)}
    for (p, nb), rows in kept.items():
        assert rows["xf_rows"].shape[0] == p and rows["h0"].shape[0] == nb
        upd = cs.phase_kernel_update(torch.device("cpu"), "rehearsal", rows,
                                     kernel_reps=1, plain_reps=1)
        assert not any(upd["pixels_differing_from_plain"].values())


def test_phase_band_seq_fleet_fails_without_kernel_launches():
    with pytest.raises(AssertionError, match="launches"):
        cs.phase_band_seq_fleet(torch.device("cpu"), ny=12, nx=12)


def test_phase_hessian_rehearsal(counted_gn_plain):
    """phase_hessian at 48 x 48 on the CPU: one fused_gn launch, A
    finite and above the floor, the correction held to float64, the
    pixels the floor leaves alone equal to A - C bit for bit."""
    rec = cs.phase_hessian(torch.device("cpu"), ny=48, nx=48)
    assert rec["kernel_launches"]["fused_gn"] == 1
    assert rec["a_finite"] and rec["healthy_a_equal_a_minus_c"]
    assert rec["pixels_below_floor"] == 0
    assert rec["correction_vs_f64"]["max"] <= cs.HESSIAN_RTOL
    assert rec["correction_max_abs"] > 0


def test_phase_hessian_fails_without_kernel_launch():
    with pytest.raises(AssertionError, match="launches"):
        cs.phase_hessian(torch.device("cpu"), ny=48, nx=48)


# --- reanalysis and serving ------------------------------------------------

def test_phase_smooth_rehearsal(tmp_path, counted_gn_plain):
    """phase_cli at 96 x 96, then phase_smooth over the chain it leaves:
    one product set per chain date, the newest date the analysis, the
    float64 sample within budget, no kernel launch in the smoother."""
    dev = torch.device("cpu")
    cs.phase_cli(dev, str(tmp_path), ny=96, nx=96)
    rec = cs.phase_smooth(dev, str(tmp_path), ny=96, nx=96)
    assert rec["outputs_written"] == 15 * len(rec["chain_dates"])
    assert rec["kernel_launches"]["fused_gn"] == 0
    assert rec["sample"]["pixels"] == rec["n_valid"]
    assert rec["sample"]["beyond_budget"] == {"x": 0, "diag": 0}
    assert rec["clamped_px_per_date"][-1] == 0
    assert rec["chain_load_s"] > 0 and rec["sweep_blocks"] == 1


def test_phase_serve_rehearsal(tmp_path, counted_gn_plain):
    """phase_serve at 48 x 48: every served_from outcome from the inbox,
    warm equal to a fresh cold serve, smoothed equal to kafka_smooth."""
    rec = cs.phase_serve(torch.device("cpu"), str(tmp_path), ny=48, nx=48)
    assert set(rec["wall_ms_by_served_from"]) == {
        "cold", "cache", "warm_noop", "warm", "cold_replay",
        "smoothed_chain"}
    assert rec["warm_equals_fresh_cold"]
    assert rec["smoothed_equals_kafka_smooth"]
    assert rec["kernel_launches"]["fused_gn"] > 0


def test_phase_serve_fails_without_kernel_launches(tmp_path):
    with pytest.raises(AssertionError, match="no fused_gn launch"):
        cs.phase_serve(torch.device("cpu"), str(tmp_path), ny=48, nx=48)


def test_phase_serve_batch_rehearsal(tmp_path, counted_gn_plain,
                                     counted_plain):
    """phase_serve_batch at 48 x 48: both operators' ladders coalesce,
    every member equals its one-at-a-time baseline, one fused_gn launch
    per two-stream round and one (2, 2) launch per identity iteration;
    the kept fused-update launch held to the plain version."""
    dev = torch.device("cpu")
    rec, kept = cs.phase_serve_batch(dev, str(tmp_path), ny=48, nx=48)
    for op, kernel in (("twostream", "fused_gn"),
                       ("identity", "fused_update")):
        run = rec["runs"][op]
        assert run["differing_from_baseline"] == []
        assert run["coalesced_rounds"] == 4 and run["solo_rounds"] == 2
        assert run["launches"][kernel] > sum(
            run["launches_per_coalesced_round"])
    assert rec["runs"]["twostream"]["launches_per_coalesced_round"] == \
        [1, 1, 1, 1]
    assert kept["gn"]["xf_rows"].shape[1] == 2 * rec["n_pad"]
    from kafka_tpu_torch.core.fused_gn import _block

    assert kept["gn"]["block"] == _block(rec["n_pad"], 2048)
    assert kept["rows"]["xf_rows"].shape[1] == 2 * rec["n_pad"]


def test_phase_serve_batch_fails_without_kernel_launches(tmp_path):
    with pytest.raises(AssertionError, match="launches per coalesced"):
        cs.phase_serve_batch(torch.device("cpu"), str(tmp_path), ny=48,
                             nx=48)
