"""The port's pixel mesh, sharded step and chunk scheduler (mirroring
tests/test_shard.py): the sharded step on ``["cpu"] * 8`` against the
port unsharded at the JAX sharding budgets (x atol 2e-4; P^-1 rtol 2e-4,
atol 2e-2) and against the JAX sharded step on eight CPU devices at the
port-vs-JAX budget of tests/test_torch_solvers.py (x atol 2e-3, P^-1
rtol and atol 2e-2), with equal iteration counts; the fused scan sharded
(diagnostics rtol 5e-3, atol 5e-2), per-pixel convergence, the fused
Gauss-Newton path bit for bit whether or not the shards hold whole
convergence groups, the partitioning, ``pad_for_mesh``, the round-robin
with restarts and crashes, the marker files, the stale-tmp sweep and
the telemetry.  Last, the kernel wrappers launch on the
device of their inputs whatever device is current."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_tpu_torch import telemetry
from kafka_tpu_torch.core import collective
from kafka_tpu_torch.core.propagators import propagate_information_filter
from kafka_tpu_torch.core.solvers import assimilate_windows_scan, \
    iterated_solve
from kafka_tpu_torch.core.types import BandBatch
from kafka_tpu_torch.io.tiling import get_chunks
from kafka_tpu_torch.shard import (PixelShards, assign_chunks,
                                   make_pixel_mesh, make_sharded_step,
                                   pad_for_mesh, pending_chunks,
                                   process_count, process_index,
                                   run_chunks, shard_bands, shard_state)
from kafka_tpu_torch.shard.step import sharded_windows_scan
from kafka_tpu_torch.testing.synthetic import make_tip_problem

X_ATOL = 2e-4
P_RTOL, P_ATOL = 2e-4, 2e-2
#: the port against the JAX package (float32 TIP sensitivity, ROADMAP
#: Queue 3 item 3): tests/test_torch_solvers.py's budgets.
JAX_X_ATOL = 2e-3
JAX_P_RTOL = JAX_P_ATOL = 2e-2


def mesh8():
    return make_pixel_mesh(["cpu"] * 8)


def problem(n_pix, seed=0):
    """The TIP problem on the CPU, as torch tensors and as numpy."""
    op, bands, x0, p_inv0 = make_tip_problem(n_pix, seed=seed,
                                             device="cpu")
    return op, bands, x0, p_inv0


def bounds_of(op):
    lo, hi = op.state_bounds
    return (torch.as_tensor(lo, dtype=torch.float32),
            torch.as_tensor(hi, dtype=torch.float32))


def to_jax(t):
    return jnp.asarray(np.asarray(t))


def jax_sharded_step(devices, bands, x0, p_inv0, opts, n_valid=None):
    """The JAX package's sharded step over ``devices`` on the port's
    arrays."""
    from kafka_tpu.core.propagators import \
        propagate_information_filter as jprop
    from kafka_tpu.core.types import BandBatch as JBands
    from kafka_tpu.obsops.twostream import TwoStreamOperator as JOp
    from kafka_tpu.shard import make_pixel_mesh as jmesh
    from kafka_tpu.shard import make_sharded_step as jstep
    from kafka_tpu.shard import shard_bands as jbands
    from kafka_tpu.shard import shard_state as jstate

    jop = JOp()
    mesh = jmesh(devices)
    jopts = {k: (tuple(to_jax(v) for v in val) if k == "state_bounds"
                 else val) for k, val in opts.items()}
    step = jstep(jop.linearize, mesh, state_propagator=jprop,
                 use_prior=False, solver_options=jopts, n_valid=n_valid)
    xs, ps = jstate(mesh, to_jax(x0), to_jax(p_inv0))
    bs = jbands(mesh, JBands(*(to_jax(f) for f in bands)))
    m = jnp.eye(7, dtype=jnp.float32)
    q = jnp.full((7,), 0.01, jnp.float32)
    return step(bs, xs, ps, m, q, xs, ps, None)


def test_sharded_step_matches_jax_and_unsharded(eight_cpu_devices):
    mesh = mesh8()
    n_pix = pad_for_mesh(300, mesh, lane=8)
    op, bands, x0, p_inv0 = problem(n_pix)
    opts = {"state_bounds": bounds_of(op)}
    m = torch.eye(7)
    q = torch.full((7,), 0.01)
    step = make_sharded_step(op.linearize, mesh,
                             state_propagator=propagate_information_filter,
                             use_prior=False, solver_options=opts)
    xs, ps = shard_state(mesh, x0, p_inv0)
    x_sh, p_sh, d_sh = step(shard_bands(mesh, bands), xs, ps, m, q, xs, ps,
                            None)
    assert isinstance(x_sh, PixelShards) and len(x_sh.shards) == 8

    x_f, _, p_f_inv = propagate_information_filter(x0, None, p_inv0, m, q)
    x_ref, p_ref, d_ref = iterated_solve(op.linearize, bands, x_f, p_f_inv,
                                         None, **opts)
    np.testing.assert_allclose(np.asarray(x_sh), x_ref.numpy(),
                               atol=X_ATOL)
    np.testing.assert_allclose(np.asarray(p_sh), p_ref.numpy(),
                               rtol=P_RTOL, atol=P_ATOL)
    assert int(d_sh.n_iterations) == int(d_ref.n_iterations)

    x_j, p_j, d_j = jax_sharded_step(eight_cpu_devices, bands, x0, p_inv0,
                                     opts)
    np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_j),
                               atol=JAX_X_ATOL)
    np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p_j),
                               rtol=JAX_P_RTOL, atol=JAX_P_ATOL)
    assert int(d_sh.n_iterations) == int(d_j[2])
    # Band-major diagnostics split on the pixel axis, scalars combined.
    assert isinstance(d_sh.innovations, PixelShards)
    np.testing.assert_allclose(np.asarray(d_sh.innovations),
                               d_ref.innovations.numpy(), atol=X_ATOL)
    np.testing.assert_allclose(d_sh.chi2_per_band.numpy(),
                               d_ref.chi2_per_band.numpy(), rtol=5e-3)
    assert int(d_sh.nodata_count) == int(d_ref.nodata_count)
    assert int(d_sh.quarantined_count) == int(d_ref.quarantined_count)


def test_sharded_step_is_actually_partitioned():
    mesh = mesh8()
    n_pix = pad_for_mesh(100, mesh, lane=8)
    op, bands, x0, p_inv0 = problem(n_pix)
    xs, ps = shard_state(mesh, x0, p_inv0)
    assert len(xs.shards) == 8 and xs.shape == (n_pix, 7)
    assert {s.shape[0] for s in xs.shards} == {n_pix // 8}
    assert {s.shape[0] for s in ps.shards} == {n_pix // 8}
    bs = shard_bands(mesh, bands)
    assert {s.shape for s in bs.y.shards} == {(2, n_pix // 8)}
    np.testing.assert_array_equal(np.asarray(bs.y), bands.y.numpy())


def test_pad_for_mesh(eight_cpu_devices):
    from kafka_tpu.shard import make_pixel_mesh as jmesh
    from kafka_tpu.shard import pad_for_mesh as jpad

    mesh = mesh8()
    n = pad_for_mesh(1000, mesh)
    assert n >= 1000 and n % (8 * 128) == 0
    assert pad_for_mesh(1, mesh) == 8 * 128
    jm = jmesh(eight_cpu_devices)
    for n_pix, lane in ((1, 128), (1000, 128), (300, 8), (4096, 64)):
        assert pad_for_mesh(n_pix, mesh, lane) == jpad(n_pix, jm, lane)


def test_mesh_refuses_absent_cuda_devices(monkeypatch):
    """A CUDA mesh needs its devices: without a card, or past the count,
    it raises (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pixel_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pixel_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="does not exist"):
        make_pixel_mesh(["cuda:0", "cuda:1"])
    assert make_pixel_mesh(["cuda:0", "cuda:0"]).size == 2


def test_no_process_group_means_one_process():
    assert (process_count(), process_index()) == (1, 0)


def test_scheduler_round_robin_and_restart(tmp_path):
    from kafka_tpu.io.tiling import get_chunks as jchunks
    from kafka_tpu.shard import assign_chunks as jassign

    chunks = list(get_chunks(512, 512, (128, 128)))  # 16 chunks
    a = assign_chunks(chunks, num_processes=4)
    assert [x.owner for x in a] == [i % 4 for i in range(16)]
    jas = jassign(list(jchunks(512, 512, (128, 128))), num_processes=4)
    assert [(x.owner, x.prefix, tuple(x.chunk)) for x in a] == \
        [(x.owner, x.prefix, tuple(x.chunk)) for x in jas]
    outdir = str(tmp_path)
    ran = []

    def run_one(chunk, prefix):
        ran.append((chunk.chunk_no, prefix))

    for p in range(4):
        stats = run_chunks(chunks, run_one, outdir,
                           num_processes=4, process_index=p)
        assert stats["run"] == 4 and stats["skipped"] == 0
    assert len(ran) == 16 and len({c for c, _ in ran}) == 16
    stats = run_chunks(chunks, run_one, outdir,
                       num_processes=4, process_index=0)
    assert stats["run"] == 0 and stats["skipped"] == 4
    assert pending_chunks(assign_chunks(chunks, 4), outdir, 2) == []


def test_scheduler_crash_midway_reruns_exactly_missing(tmp_path):
    from kafka_tpu_torch.shard.scheduler import marker_path

    chunks = list(get_chunks(512, 512, (128, 128)))
    outdir = str(tmp_path)
    mine = [a for a in assign_chunks(chunks, num_processes=2)
            if a.owner == 0]
    die_at = mine[3].prefix
    ran = []

    def run_one_dying(chunk, prefix):
        if prefix == die_at:
            raise RuntimeError("synthetic mid-chunk crash")
        ran.append(prefix)

    with pytest.raises(RuntimeError, match="mid-chunk crash"):
        run_chunks(chunks, run_one_dying, outdir,
                   num_processes=2, process_index=0)
    assert len(ran) == 3
    for p in ran:
        assert os.path.exists(marker_path(outdir, p))
    assert not os.path.exists(marker_path(outdir, die_at))
    pending = pending_chunks(assign_chunks(chunks, 2), outdir, 0)
    assert [a.prefix for a in pending] == \
        [a.prefix for a in mine if a.prefix not in ran]
    rerun = []
    stats = run_chunks(chunks, lambda c, p: rerun.append(p), outdir,
                       num_processes=2, process_index=0)
    assert stats["skipped"] == 3 and stats["run"] == len(mine) - 3
    assert set(rerun).isdisjoint(ran)


def test_legacy_failed_marker_payloads_honored(tmp_path):
    import json

    from kafka_tpu_torch.shard.queue import queue_status, scan_chunk
    from kafka_tpu_torch.shard.scheduler import failed_marker_path

    chunks = list(get_chunks(512, 512, (128, 128)))[:4]
    outdir = str(tmp_path)
    with open(failed_marker_path(outdir, "0001"), "w") as f:
        json.dump({"failed": 1234.5}, f)
    open(failed_marker_path(outdir, "0002"), "wb").close()
    pending = pending_chunks(assign_chunks(chunks, 1), outdir, 0)
    assert [a.prefix for a in pending] == ["0003", "0004"]
    assert scan_chunk(outdir, "0001").state == "failed"
    assert scan_chunk(outdir, "0002").state == "failed"
    ran = []
    stats = run_chunks(chunks, lambda c, p: ran.append(p), outdir,
                       num_processes=1, process_index=0)
    assert sorted(ran) == ["0003", "0004"] and stats["skipped"] == 2
    assert queue_status(outdir)["counts"]["failed"] == 2


def test_write_marker_tmp_names_are_unique(tmp_path):
    from kafka_tpu_torch.shard.scheduler import _tmp_name, _write_marker

    target = str(tmp_path / ".chunk_0001.done")
    names = {_tmp_name(target) for _ in range(16)}
    assert len(names) == 16
    assert all(f".tmp.{os.getpid()}." in n for n in names)
    _write_marker(target, {"finished": True})
    assert os.path.exists(target)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_sweep_stale_tmp_removes_orphans(tmp_path):
    from kafka_tpu_torch.shard.scheduler import sweep_stale_tmp

    (tmp_path / "ckpt").mkdir()
    legacy = tmp_path / ".chunk_0001.done.tmp"
    unique = tmp_path / f".chunk_0002.failed.tmp.{os.getpid()}.7"
    ckpt = tmp_path / "ckpt" / "state_20170101T000000.npz.tmp"
    fresh = tmp_path / ".chunk_0003.done.tmp"
    for p in (legacy, unique, ckpt, fresh):
        p.write_bytes(b"orphan")
    old = time.time() - 3600
    for p in (legacy, unique, ckpt):
        os.utime(p, (old, old))
    keeper = tmp_path / "a_A2017184_0001.tif"
    keeper.write_bytes(b"data")
    with telemetry.use(telemetry.MetricsRegistry()) as reg:
        removed = sweep_stale_tmp(str(tmp_path), older_than_s=60.0)
        assert reg.value("kafka_scheduler_stale_tmp_removed_total") == 3
        assert len([e for e in reg.events
                    if e["event"] == "stale_tmp_removed"]) == 3
    assert len(removed) == 3
    assert not legacy.exists() and not unique.exists() \
        and not ckpt.exists()
    assert fresh.exists() and keeper.exists()


def test_scheduler_records_telemetry(tmp_path):
    chunks = list(get_chunks(512, 256, (128, 128)))  # 8 chunks
    walls = iter([0.01] * 7 + [0.12])

    def run_one(chunk, prefix):
        time.sleep(next(walls))

    with telemetry.use(telemetry.MetricsRegistry()) as reg:
        stats = run_chunks(chunks, run_one, str(tmp_path),
                           num_processes=1, process_index=0)
        assert stats["run"] == 8
        assert reg.value("kafka_shard_chunks_completed_total") == 8
        assert reg.value("kafka_shard_chunks_pending") == 0
        assert reg.value("kafka_shard_stragglers_total") == 1
        events = [e["event"] for e in reg.events]
        assert events.count("chunk_done") == 8
        assert events.count("straggler") == 1


def test_fused_scan_composes_with_sharding(eight_cpu_devices):
    """assimilate_windows_scan shard by shard against the port's
    one-device scan (the JAX sharding budgets) and the JAX one-device scan
    (equal iterations; no farther from it than the port's one-device
    scan, plus the sharding budget)."""
    from kafka_tpu.core.propagators import \
        propagate_information_filter as jprop
    from kafka_tpu.core.solvers import assimilate_windows_scan as jscan
    from kafka_tpu.core.types import BandBatch as JBands
    from kafka_tpu.obsops.twostream import TwoStreamOperator as JOp

    mesh = mesh8()
    n_pix = pad_for_mesh(200, mesh, lane=8)
    op, b1, x0, pi0 = problem(n_pix, seed=0)
    _, b2, _, _ = problem(n_pix, seed=1)
    m = torch.eye(7)
    q = torch.full((7,), 0.01)
    opts = {"state_bounds": bounds_of(op)}
    stacked = BandBatch(*(torch.stack([u, v]) for u, v in zip(b1, b2)))
    _, _, xs_ref, diag_ref, it_ref, _, _, _ = assimilate_windows_scan(
        op.linearize, stacked, x0, pi0, None, m, q, None, None,
        propagate_information_filter, dict(opts), None)
    x_fin, _, xs_sh, diag_sh, it_sh, _, _, _ = sharded_windows_scan(
        mesh, op.linearize, stacked, x0, pi0, None, m, q, None, None,
        propagate_information_filter, dict(opts), None)
    assert isinstance(x_fin, PixelShards) and len(x_fin.shards) == 8
    np.testing.assert_array_equal(it_sh.numpy(), it_ref.numpy())
    np.testing.assert_allclose(np.asarray(xs_sh), xs_ref.numpy(),
                               atol=X_ATOL)
    np.testing.assert_allclose(np.asarray(diag_sh), diag_ref.numpy(),
                               rtol=5e-3, atol=5e-2)
    jopts = {"state_bounds": tuple(to_jax(v) for v in opts["state_bounds"])}
    _, _, xs_j, diag_j, it_j, _, _, _ = jscan(
        JOp().linearize, JBands(*(to_jax(f) for f in stacked)), to_jax(x0),
        to_jax(pi0), None, jnp.eye(7, dtype=jnp.float32),
        jnp.full((7,), 0.01, jnp.float32), None, None, jprop, jopts, None)
    np.testing.assert_array_equal(it_sh.numpy(), np.asarray(it_j))
    # Against JAX, sharding adds at most the sharding budget to the port's
    # own distance from the JAX scan (one ill-conditioned pixel of this
    # problem sits 5e-3 off in both: ROADMAP Queue 3 item 3).
    no_farther(xs_sh, xs_ref, xs_j, X_ATOL)
    no_farther(diag_sh, diag_ref, diag_j, 5e-2, rtol=5e-3)


def no_farther(sharded, port, jax_ref, atol, rtol=0.0):
    """Every entry of ``sharded`` is no farther from ``jax_ref`` than the
    port's unsharded value is, plus ``atol + rtol * |jax_ref|``."""
    sharded, port, ref = (np.asarray(a, np.float64)
                          for a in (sharded, port, jax_ref))
    limit = np.abs(port - ref) + atol + rtol * np.abs(ref)
    assert (np.abs(sharded - ref) <= limit).all()


def test_sharded_step_per_pixel_convergence():
    mesh = mesh8()
    n_pix = pad_for_mesh(200, mesh, lane=8)
    op, bands, x0, p_inv0 = problem(n_pix)
    opts = {"state_bounds": bounds_of(op), "relaxation": 0.7,
            "per_pixel_convergence": True}
    step = make_sharded_step(op.linearize, mesh,
                             state_propagator=propagate_information_filter,
                             use_prior=False, solver_options=opts,
                             n_valid=n_pix)
    xs, ps = shard_state(mesh, x0, p_inv0)
    x_a, p_a, diags = step(shard_bands(mesh, bands), xs, ps, torch.eye(7),
                           torch.full((7,), 0.01), xs, ps, None)
    frozen = np.asarray(diags.converged_mask)
    assert frozen.shape == (n_pix,) and frozen.any()
    assert len(diags.converged_mask.shards) == 8
    assert np.isfinite(np.asarray(x_a)).all()
    # Pixels behave as on one device.
    x_f, _, p_f_inv = propagate_information_filter(
        x0, None, p_inv0, torch.eye(7), torch.full((7,), 0.01))
    x_ref, _, d_ref = iterated_solve(op.linearize, bands, x_f, p_f_inv,
                                     None, norm_denominator=n_pix * 7.0,
                                     **opts)
    np.testing.assert_array_equal(frozen, d_ref.converged_mask.numpy())
    np.testing.assert_allclose(np.asarray(x_a), x_ref.numpy(), atol=X_ATOL)


def test_fused_gn_shards_keep_the_unsharded_groups(monkeypatch):
    """Shards that hold whole convergence groups (2048 px each here) run
    the fused Gauss-Newton path with the unsharded groups and their share
    of the test: each group takes its unsharded trips, so the sharded
    solve equals the unsharded one bit for bit."""
    from kafka_tpu_torch.core import fused_gn

    n_pix = 8 * 2048
    op, bands, x0, p_inv0 = problem(n_pix, seed=3)
    opts = {"state_bounds": bounds_of(op), "relaxation": 0.7}
    calls = []
    real = fused_gn.fused_gn_raw

    def counted(*a, **k):
        calls.append(a[5].shape[1])
        return real(*a, **k)

    monkeypatch.setattr(fused_gn, "fused_gn_raw", counted)
    x_ref, p_ref, d_ref = iterated_solve(op.linearize, bands, x0, p_inv0,
                                         None, **opts)
    step = make_sharded_step(op.linearize, make_pixel_mesh(["cpu"] * 8),
                             use_prior=False, solver_options=opts)
    x_sh, p_sh, d_sh = step(bands, x0, p_inv0, torch.eye(7),
                            torch.zeros(7), None, None, None)
    assert calls == [n_pix] + [2048] * 8
    np.testing.assert_array_equal(np.asarray(x_sh), x_ref.numpy())
    np.testing.assert_array_equal(np.asarray(p_sh), p_ref.numpy())
    np.testing.assert_array_equal(np.asarray(d_sh.health_verdicts),
                                  d_ref.health_verdicts.numpy())
    assert int(d_sh.n_iterations) == int(d_ref.n_iterations)


@pytest.mark.parametrize("n_pix,shards,launches", [
    # 2^12 x 3 px on 4 shards of 3,072: groups 1 and 4 straddle.
    (3 * 4096, 4, [(2048, 2048)] * 4 + [(4096, 2048)]),
    # One 1,536-px group over 8 shards of 192: no shard holds a group.
    (1536, 8, [(1536, 1536)]),
])
def test_fused_gn_shards_splitting_groups_stay_on_the_kernel(
        monkeypatch, n_pix, shards, launches):
    """Shards that split the unsharded groups still run the fused
    Gauss-Newton path: each shard launches over its whole groups and the
    groups straddling shards are launched once, whole, so the sharded
    solve equals the unsharded one bit for bit.  The MODIS tile's
    4,608,000 px = 2^12 x 1125 on 4 shards straddles the same way."""
    from kafka_tpu_torch.core import fused_gn

    assert fused_gn.shard_launches(4_608_000, 4) == 5
    assert fused_gn.shard_launches(4_608_000, 2) == 2
    assert fused_gn.shard_launches(n_pix, shards) == len(launches)
    op, bands, x0, p_inv0 = problem(n_pix, seed=4)
    opts = {"state_bounds": bounds_of(op), "relaxation": 0.7}
    calls = []
    real = fused_gn.fused_gn_raw

    def counted(*a, **k):
        calls.append((a[5].shape[1], a[12]))
        return real(*a, **k)

    monkeypatch.setattr(fused_gn, "fused_gn_raw", counted)
    x_ref, p_ref, d_ref = iterated_solve(op.linearize, bands, x0, p_inv0,
                                         None, **opts)
    step = make_sharded_step(op.linearize,
                             make_pixel_mesh(["cpu"] * shards),
                             use_prior=False, solver_options=opts)
    calls.clear()
    x_sh, p_sh, d_sh = step(bands, x0, p_inv0, torch.eye(7),
                            torch.zeros(7), None, None, None)
    assert sorted(calls) == sorted(launches)
    np.testing.assert_array_equal(np.asarray(x_sh), x_ref.numpy())
    np.testing.assert_array_equal(np.asarray(p_sh), p_ref.numpy())
    np.testing.assert_array_equal(np.asarray(d_sh.health_verdicts),
                                  d_ref.health_verdicts.numpy())
    assert int(d_sh.n_iterations) == int(d_ref.n_iterations)


def test_a_failing_shard_raises_its_error_without_hanging():
    """One shard raising must not leave the others waiting at the
    collective: they break out and the caller sees the real error."""
    from kafka_tpu_torch.shard.step import run_shards

    mesh = make_pixel_mesh(["cpu"] * 4)

    def fn(k):
        if k == 2:
            raise ValueError("shard 2 broke")
        return float(collective.all_reduce(torch.tensor(float(k))))

    t0 = time.time()
    with pytest.raises(ValueError, match="shard 2 broke"):
        run_shards(mesh, fn, 16)
    assert time.time() - t0 < 30
    assert run_shards(mesh, lambda k: float(collective.all_reduce(
        torch.tensor(float(k)))), 16) == [6.0] * 4
    assert collective.current() is None


class _Recorder:
    """Stands for ``torch.cuda.device``: records the device it is
    entered with, and what is current inside it."""

    current = "cuda:0"
    entered = []

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        _Recorder.entered.append(self.dev)
        self.prev, _Recorder.current = _Recorder.current, str(self.dev)

    def __exit__(self, *exc):
        _Recorder.current = self.prev


@pytest.mark.parametrize("module", ["fused_gn", "fused_update",
                                    "solve_rows"])
def test_kernel_wrappers_launch_on_their_inputs_device(monkeypatch,
                                                       module):
    """Each wrapper makes its inputs' device current for the launch and
    takes that device's stream, whatever device the caller has current
    (here cuda:0 while the inputs lie elsewhere); nothing is launched:
    the library is a stub that records what is current when called."""
    import importlib

    from kafka_tpu_torch.core import _build

    mod = importlib.import_module(f"kafka_tpu_torch.core.{module}")
    _Recorder.entered = []
    seen = {}

    class Stream:
        cuda_stream = 1234

    def current_stream(dev):
        seen["stream_for"] = (str(dev), _Recorder.current)
        return Stream()

    class Fn:
        def __call__(self, *args):
            seen["launch_current"] = _Recorder.current
            seen["stream_arg"] = args[-1]
            return 0

    class Lib:
        def __getattr__(self, name):
            return Fn()

    monkeypatch.setattr(torch.cuda, "device", _Recorder)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    launches = mod.__dict__[{"fused_gn": "fused_gn_rows",
                             "fused_update": "fused_update_rows",
                             "solve_rows": "solve_rows"}[module]]
    monkeypatch.setattr(launches, "launches", 0)
    for name in ("launches_by_instance", "route_launches"):
        if hasattr(launches, name):
            monkeypatch.setattr(launches, name,
                                dict(getattr(launches, name)))
    n = 64
    if module == "fused_gn":
        from kafka_tpu_torch.obsops import TwoStreamOperator

        rows = [torch.zeros(r, n) for r in (2, 2, 2, 7, 28)]
        mod._launch_cuda(TwoStreamOperator().kernel_linearize_rows, *rows,
                         1e-3, 2, 25, 1.0, None, 7.0 * n, 2048, None)
    elif module == "fused_update":
        mod._launch_cuda(*(torch.zeros(r, n) for r in
                           (14, 2, 2, 2, 2, 7, 7, 28, 1)))
    else:
        monkeypatch.setattr(mod, "_sm_count", lambda dev: 132)
        mod._launch_cuda(torch.zeros(28, n), torch.zeros(7, n))
    inputs_dev = "cpu"  # the stub tensors' device stands for cuda:1
    assert [str(d) for d in _Recorder.entered] == [inputs_dev]
    assert seen["stream_for"] == (inputs_dev, inputs_dev)
    assert seen["launch_current"] == inputs_dev
    assert seen["stream_arg"] == Stream.cuda_stream
    assert _Recorder.current == "cuda:0"
    assert launches.launches == 1
