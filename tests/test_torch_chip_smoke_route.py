"""chip_smoke.py's phases batch_modes and route rehearsed on the CPU at
small sizes, with the kernels' plain versions counted as launches (in
this process by monkeypatch, in the route replicas by their
``--count-plain-as-launches`` flag): the per-pixel coalesced round and
the dense p = 21 round against their solo solves, and the three-replica
fleet behind ``kafka_route`` with the tile0 owner SIGKILLed, every answer
holding phase serve's digests.  The ring walk the smoke pins (it imports
no JAX) is held to the JAX package's ring here."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")


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


def test_pinned_ring_walk_is_the_jax_rings():
    from kafka_tpu.serve.router import HashRing as JaxRing
    from kafka_tpu_torch.serve import HashRing

    for ring in (JaxRing(cs.ROUTE_REPLICAS), HashRing(cs.ROUTE_REPLICAS)):
        assert {t: tuple(ring.preference(t))
                for t in cs.ROUTE_JAX_PREFERENCE} == cs.ROUTE_JAX_PREFERENCE


def test_phase_batch_modes_rehearsal(monkeypatch):
    _count_plain(monkeypatch)
    rec = cs.phase_batch_modes(CPU, ny=96, nx=96, dense_px=192)
    pp, dense = rec["per_pixel"], rec["dense"]
    assert pp["n_pad"][0] != pp["n_pad"][1]  # the padding ran
    assert pp["fields_differing"] == [] == dense["fields_differing"]
    assert pp["batch_launches"]["fused_update_by_instance"] == \
        {"7x2": max(pp["iterations"])}
    assert sum(pp["iterations"]) > max(pp["iterations"])
    assert dense["iterations"][0] != dense["iterations"][1]
    assert dense["stacked_calls_identical"]["cholesky_ex"]
    assert dense["stacked_calls_identical"]["solve_triangular"]


def test_phase_batch_modes_fails_when_a_member_drifts(monkeypatch):
    """A round whose member differs from its solo solve fails the phase."""
    from kafka_tpu_torch.core import solvers

    _count_plain(monkeypatch)
    real = solvers.assimilate_date_batch

    def drift(*args, **kwargs):
        x, p_inv, d = real(*args, **kwargs)
        return x + 1e-6, p_inv, d

    monkeypatch.setattr(solvers, "assimilate_date_batch", drift)
    with pytest.raises(AssertionError, match="member 0 x"):
        cs.phase_batch_modes(CPU, ny=48, nx=48, dense_px=64)


@pytest.fixture(scope="module")
def serve_shas(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _count_plain(mp)
        rec = cs.phase_serve(CPU, str(tmp_path_factory.mktemp("serve")),
                             ny=48, nx=48)
    return rec["x_sha256"]


def test_phase_route_rehearsal(tmp_path, serve_shas):
    rec = cs.phase_route(CPU, str(tmp_path), serve_shas=serve_shas, ny=48,
                         nx=48, count_plain=True)
    assert rec["victim"] == "rep0" and rec["flagged_dead"] == ["rep0"]
    assert rec["rerouted"] and rec["requests"] == 12
    assert all(v["replica"] != "rep0" for r, v in rec["latency"].items()
               if r in rec["rerouted"])
    assert rec["kill_to_flagged_dead_s"] <= rec["flag_limit_s"]
    assert rec["router_metric_families"] == sorted(cs.ROUTE_NAMES)
    assert sorted(rec["replicas_out"]) == ["rep0", "rep1", "rep2"]
    assert rec["replicas_out"]["rep0"] is None
    for rid in ("rep1", "rep2"):
        assert rec["replicas_out"][rid]["launches"]["fused_gn"] > 0


def test_phase_route_fails_on_a_foreign_digest(tmp_path, serve_shas):
    """An answer whose digest is not phase serve's fails the phase."""
    shas = dict(serve_shas, **{"tile1:warm": "0" * 64})
    with pytest.raises(AssertionError, match="x_sha256 differ"):
        cs.phase_route(CPU, str(tmp_path), serve_shas=shas, ny=48, nx=48,
                       count_plain=True)
