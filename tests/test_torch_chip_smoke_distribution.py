"""chip_smoke.py's distribution phases rehearsed on the CPU at small
sizes, with the kernels' plain versions counted as launches (under the
wrappers' lock: the mesh's shards launch from one thread each): phase
mesh (a tile whose shards hold whole 2,048-px convergence groups, so
the fused Gauss-Newton path runs sharded, and an S2 sub-tile on the row
loop, each the same bits as its unsharded run; then the tile on shards
that split some groups, still on the fused path and the same bits),
phase distributed (two gloo ranks in child processes) and phase queue
(a fleet with one worker SIGKILLed while it holds a lease, then the
chunk_worker subprocess)."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _count_plain(monkeypatch):
    from kafka_tpu_torch.core import _build
    from kafka_tpu_torch.core import fused_gn as fg
    from kafka_tpu_torch.core import fused_update as fu

    real_gn, real_fu = fg.fused_gn_raw_plain, fu.fused_update_raw_plain

    def gn(*args, **kwargs):
        _build.count_launch(fg.fused_gn_rows)
        return real_gn(*args, **kwargs)

    def upd(*args, **kwargs):
        rows = dict(zip(cs.UPDATE_ROW_NAMES, args), **kwargs)
        _build.count_launch(fu.fused_update_rows, (rows["xf_rows"].shape[0],
                                                   rows["h0"].shape[0]))
        return real_fu(*args, **kwargs)

    monkeypatch.setattr(fg, "fused_gn_raw_plain", gn)
    monkeypatch.setattr(fu, "fused_update_raw_plain", upd)


@pytest.fixture
def counted(monkeypatch):
    _count_plain(monkeypatch)


@pytest.fixture(scope="module")
def unsharded():
    """Phase main at 160 x 160 (20,480 px: two shards of five 2,048-px
    groups, four of 5,120 px that split them) and phase main_s2 at 16 x 16,
    their runs kept."""
    dev = torch.device("cpu")
    main_run, s2_run = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _count_plain(mp)
        cs.phase_main(dev, ny=160, nx=160, keep_run=main_run)
        cs.phase_main_s2(dev, ny=16, nx=16, keep_run=s2_run)
    return main_run, s2_run


def test_phase_mesh_rehearsal(unsharded, counted):
    main_run, s2_run = unsharded
    rec = cs.phase_mesh(torch.device("cpu"), main_run, s2_run, ny=160,
                        nx=160, s2_ny=16, s2_nx=16)
    tip, s2 = rec["tip_tile"], rec["s2_subtile"]
    assert tip["shard_px"] % tip["group_px"] == 0
    assert tip["kernel_launches"]["fused_gn"] == 2 * 6
    assert s2["kernel_launches"]["fused_update_by_instance"]["10x10"] == \
        2 * s2["iterations"]
    assert tip["bit_identical"] and s2["bit_identical"]
    split = rec["tip_tile_split_groups"]
    assert (split["shards"], split["groups_divide_shards"]) == (4, False)
    assert split["kernel_launches"]["fused_gn"] == (4 + 1) * 6
    assert split["bit_identical"]


def test_phase_mesh_fails_when_the_sharded_run_drifts(unsharded,
                                                      counted):
    """A sharded run off its unsharded one by more than the budget fails
    the phase."""
    main_run, s2_run = unsharded
    x, p_inv = main_run["final"]
    with pytest.raises(AssertionError, match="x off by"):
        cs.phase_mesh(torch.device("cpu"), dict(main_run, final=(
            x + 1e-3, p_inv)), s2_run, ny=160, nx=160, s2_ny=16, s2_nx=16)


@pytest.mark.parametrize("shift,match", [
    (1e-3, "sigma off by"),
    (1e-7, "same bits False"),
])
def test_phase_mesh_holds_every_date(unsharded, counted, shift, match):
    """One date's sigma raster off by more than the budget fails the
    phase; off by less, the tile's lost bit identity fails it too."""
    import types

    main_run, s2_run = unsharded
    output = {ts: dict(rasters) for ts, rasters in
              main_run["out"].output.items()}
    ts = sorted(output)[1]
    key = next(k for k in output[ts] if k.endswith("_unc"))
    output[ts][key] = output[ts][key] + shift
    with pytest.raises(AssertionError, match=match):
        cs.phase_mesh(torch.device("cpu"), dict(
            main_run, out=types.SimpleNamespace(output=output)), s2_run,
            ny=160, nx=160, s2_ny=16, s2_nx=16)


def test_phases_distributed_and_queue_rehearsal(tmp_path, counted):
    dev = torch.device("cpu")
    wd = str(tmp_path)
    cs.phase_cli_modis(dev, wd, ny=64, nx=64)
    rec = cs.phase_distributed(dev, wd, ny=64, nx=64, chunk=32)
    assert [r["run"] for r in rec["ranks"]] == [2, 2]
    assert rec["rasters"]["compared"] == 4 * 4 * 15
    assert rec["one_process"]["kernel_launches"]["fused_gn"] == 16
    rec = cs.phase_queue(dev, wd, ny=64, nx=64, chunk=32)
    assert sorted(rec["fleet"]["worker_rcs"]) == [-9, 0]
    assert sum(rec["fleet"]["reclaims"].values()) >= 1
    assert rec["fleet"]["queue_status"]["done"] == 4
    assert rec["chunk_worker"]["rc"] == 0
