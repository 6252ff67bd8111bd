"""chip_smoke.py's phase contracts rehearsed on the CPU, with fakes in
place of the card: a card run that agrees with the CPU passes, and a
census mismatch, a count of synchronising warnings other than the
census's host reads, a launch counter moved otherwise than the kernel
nodes, a plain version called on CUDA tensors, a checker finding, a
tensor away from its census placement, or a full-width census unlike the
canonical one each fail the phase.  Then the rule of the mesh half of
``/profilez``: a job queued for the next kernel launch while a shard
group runs (``shard.step.run_shards``) runs on the caller's thread after
the join, never on a shard thread; outside a group the next launching
thread runs it, as before."""

import sys
import threading
import warnings
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from kafka_tpu_torch import analysis  # noqa: E402
from kafka_tpu_torch.analysis import checkers, trace  # noqa: E402
from kafka_tpu_torch.core import _build  # noqa: E402
from kafka_tpu_torch.core import fused_gn as fg  # noqa: E402
from kafka_tpu_torch.core import fused_update as fu  # noqa: E402

CPU = torch.device("cpu")
NAMES = ["linearize_mlp", "date_twostream_inkernel",
         "date_twostream_jac_to_rows"]


def _stored_census(spec, **over):
    """A census built from the program's checked-in manifest."""
    m = checkers.load_manifest(analysis.contracts_dir(), spec.name)
    fields = {f: m[f] for f in ("primitives", "dtypes", "kernels",
                                "host_syncs", "collectives")}
    fields.update(over)
    return trace.TracedProgram(
        spec=spec, device="fake", callbacks={},
        n_eqns=sum(fields["primitives"].values()),
        torch_version=torch.__version__, mesh_devices=m["mesh_devices"],
        **fields)


def _fake_trace(fault=None, program="date_twostream_jac_to_rows"):
    """A stand-in for ``analysis.trace_program``: the CPU census is the
    manifest's; the card's counted run (``run_context`` given) emits one
    synchronising warning per host read and moves the launch counters by
    the kernel nodes — unless ``fault`` makes ``program`` misbehave."""

    def fake(spec, device, run_context=None, n_pix=None, **kw):
        tp = _stored_census(spec)
        if run_context is None:
            return tp
        bad = spec.name == program
        if bad and fault == "census":
            tp = _stored_census(spec, primitives=dict(
                tp.primitives, **{"aten.mul": tp.primitives.get(
                    "aten.mul", 0) + 1}))
        if bad and fault == "width" and n_pix is not None:
            tp = _stored_census(spec, host_syncs={"h2d": 99})
        if bad and fault == "placement":
            tp.placement_mismatches = 3
        syncs = sum(tp.host_syncs.values()) - (bad and fault == "syncs")
        with run_context() as run:
            for _ in range(syncs):
                warnings.warn(cs.SYNC_WARNING)
            for node, n in tp.kernels.items():
                n += bad and fault == "launches"
                if node == "fused_gn":
                    fg.fused_gn_rows.launches += n
                else:
                    key = tuple(int(v) for v in node[13:-1].split(","))
                    by = fu.fused_update_rows.launches_by_instance
                    by[key] = by.get(key, 0) + n
            if bad and fault == "plain":
                run.plain_calls += 1   # what a call on CUDA tensors adds
        if bad and fault == "finding":
            tp.callbacks = {"numpy": 1}
        return tp

    return fake


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(fg.fused_gn_rows, "launches", 0)
    monkeypatch.setattr(fu.fused_update_rows, "launches", 0)
    monkeypatch.setattr(fu.fused_update_rows, "launches_by_instance", {})


def test_a_card_that_agrees_passes(counters, capsys):
    rec = cs.phase_contracts(CPU, names=NAMES, full_width=1024,
                             trace=_fake_trace())
    assert rec["failures"] == []
    assert set(rec["programs"]) == set(NAMES)
    assert rec["full_width"]["date_twostream_inkernel"]["equal_to_canonical"]
    steps = rec["programs"]["date_twostream_jac_to_rows"]
    assert steps["sync_warnings"] == sum(steps["host_syncs"].values())
    assert steps["launches"] == steps["kernels"]
    assert steps["fingerprint"] == steps["manifest_fingerprint"]
    assert rec["kernel_launches"]["fused_gn"] == 2  # canonical + wide
    assert '"phase": "contracts"' in capsys.readouterr().out


@pytest.mark.parametrize("fault,says", [
    ("census", "census differs from the CPU's"),
    ("syncs", "synchronising warnings on the card"),
    ("launches", "kernel launches"),
    ("plain", "plain-version calls"),
    ("finding", "findings on the card"),
    ("placement", "not where the census placed them"),
    ("width", "census differs from the canonical one"),
])
def test_each_gate_fails_the_phase(counters, fault, says):
    program = "date_twostream_inkernel" if fault == "width" \
        else "date_twostream_jac_to_rows"
    with pytest.raises(AssertionError, match=says):
        cs.phase_contracts(CPU, names=NAMES, full_width=1024,
                           trace=_fake_trace(fault, program))


def test_card_run_resets_and_counts(counters):
    """CardRun counts the warnings carrying the sync message only, and
    the plain versions only on CUDA tensors."""
    run = cs.CardRun(CPU)
    with run():
        warnings.warn(cs.SYNC_WARNING)
        warnings.warn(cs.SYNC_WARNING)
        warnings.warn("something else")
        fg.fused_gn_rows.launches += 1
        fu.fused_update_raw_plain(*[torch.ones(1, 1)] * 8)
    assert run.syncs == 2
    assert run.launches == {"fused_gn": 1}
    assert run.plain_calls == 0


def test_real_census_on_the_cpu_passes():
    """The real census of two programs with no host read and no kernel,
    run twice on the CPU (the second standing in for the card)."""
    rec = cs.phase_contracts(CPU, names=["linearize_mlp",
                                         "linearize_gp_bank"])
    assert rec["failures"] == []
    for p in rec["programs"].values():
        assert p["fingerprint"] == p["cpu_fingerprint"] == \
            p["manifest_fingerprint"]


# ---------------------------------------------------------------------------
# The mesh half of /profilez: jobs wait for the shards' join.
# ---------------------------------------------------------------------------

class _Wrapper:
    launches = 0


def _mesh(size=2):
    from kafka_tpu_torch.shard import make_pixel_mesh

    return make_pixel_mesh(["cpu"] * size)


def test_a_job_queued_while_shards_run_runs_on_the_caller_after_the_join():
    from kafka_tpu_torch.shard.step import run_shards

    ran, joined = [], []
    queued = threading.Barrier(2)

    def job():
        ran.append((threading.current_thread().name, list(joined)))

    def shard(k):
        if k == 0:
            _build.after_next_launch(job)
        queued.wait()             # the job is queued before any launch
        _build.count_launch(_Wrapper)   # a fake launch on each shard
        _build.count_launch(_Wrapper)
        joined.append(k)
        return threading.current_thread().name

    names = run_shards(_mesh(), shard, 2)
    assert names == ["mesh-shard-0", "mesh-shard-1"]
    assert ran == [("MainThread", [0, 1])] or \
        ran == [("MainThread", [1, 0])]


def test_the_job_runs_after_the_join_when_a_shard_fails():
    from kafka_tpu_torch.shard.step import run_shards

    ran = []

    def shard(k):
        if k == 0:
            _build.after_next_launch(
                lambda: ran.append(threading.current_thread().name))
        _build.count_launch(_Wrapper)
        if k == 1:
            raise ValueError("shard 1 failed")

    with pytest.raises(ValueError, match="shard 1 failed"):
        run_shards(_mesh(), shard, 2)
    assert ran == ["MainThread"]


def test_outside_a_group_the_next_launching_thread_runs_the_job():
    ran = []
    _build.after_next_launch(
        lambda: ran.append(threading.current_thread().name))
    t = threading.Thread(target=_build.count_launch, args=(_Wrapper,),
                         name="launcher")
    t.start()
    t.join()
    assert ran == ["launcher"]
    with _build.shard_group():
        _build.after_next_launch(
            lambda: ran.append(threading.current_thread().name))
        with _build.shard_group():
            _build.count_launch(_Wrapper)
        assert ran == ["launcher"]     # a group is still live
    assert ran == ["launcher", "MainThread"]


def test_the_asker_waits_for_a_live_group(monkeypatch):
    """``/profilez``'s asker does not switch the tracing itself while a
    shard group is live, however long it waits: the group's end switches
    it on the caller's thread.  Outside a group its fallback stands."""
    import time

    from kafka_tpu_torch.telemetry import perf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(perf, "LAUNCH_WAIT_S", 0.05)

    def ask(out):
        out["r"] = perf._on_launching_thread(
            lambda: threading.current_thread().name)

    out = {}
    with _build.shard_group():
        asker = threading.Thread(target=ask, args=(out,), name="asker")
        asker.start()
        time.sleep(0.4)            # eight waits expire meanwhile
        assert "r" not in out
    asker.join(timeout=5)
    assert out["r"] == ("MainThread", "MainThread")

    alone = {}
    asker = threading.Thread(target=ask, args=(alone,), name="asker")
    asker.start()
    asker.join(timeout=5)
    assert alone["r"] == ("asker", "asker")
