"""Coalesced serving in the port (``serve/batch.py`` and
``core.solvers.assimilate_date_batch``), on the CPU where the kernel
wrappers run their plain versions:

- ``assimilate_date_batch`` against K solo ``assimilate_date`` calls,
  bit for bit, for the two-stream state (the fused Gauss-Newton fold,
  with members whose kernel scalars differ), the identity state (the
  row loop, members of different iteration counts) and the S2 PROSAIL
  state (the row loop with its aux), the plain loop, per-pixel
  convergence and a planted ``solver.pixel`` member;
- the fold's convergence groups pinned to one member's size;
- the micro-window and partition cases of
  tests/test_serve_batch.py:153-500 on the port: batched = solo bit for
  bit on every served_from path, a mid-batch poison answered alone,
  same-tile and smoothed requests never mixed, incompatible buckets
  apart, a drain flushing an open window, and the bucket warm-up.
"""

import time

import numpy as np
import pytest
import torch

from kafka_tpu_torch import telemetry
from kafka_tpu_torch.core import fused_gn, solvers
from kafka_tpu_torch.core.fused_update import fused_update_rows
from kafka_tpu_torch.core.types import BandBatch
from kafka_tpu_torch.resilience import POISON, RetryPolicy, faults
from kafka_tpu_torch.serve import (AdmissionPolicy, AssimilationService,
                                   TileSession, make_synthetic_tile,
                                   synthetic_dates)
from kafka_tpu_torch.serve import batch as batching
from kafka_tpu_torch.serve.synthetic import DEFAULT_BASE_DATE
from kafka_tpu_torch.telemetry import MetricsRegistry

DATES = synthetic_dates(DEFAULT_BASE_DATE, 16, 2)
D1, D2, D3, D4 = DATES[0], DATES[1], DATES[2], DATES[4]
FAST2 = RetryPolicy(max_attempts=2, base_delay=0.0, jitter=0.0)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------------------
# the batched date solve
# ---------------------------------------------------------------------------

def _stack_bands(bands):
    return BandBatch(*[torch.stack([torch.as_tensor(getattr(b, f))
                                    for b in bands])
                       for f in BandBatch._fields])


def _assert_members_equal_solo(problems, opts, linearize, aux=None,
                               corrupt=None):
    """``assimilate_date_batch`` over ``problems`` [(bands, x, p_inv)]
    equals one ``assimilate_date`` per member, every output and every
    diagnostic field bit for bit."""
    solo = []
    for m, (bands, x, p_inv) in enumerate(problems):
        if corrupt is not None and corrupt[m] is not None:
            faults.script("solver.pixel", corrupt[m])
        solo.append(solvers.assimilate_date(
            linearize, bands, x, p_inv, None if aux is None else aux[m],
            opts[m], device="cpu"))
        faults.reset()
    cor = None
    if corrupt is not None:
        n = problems[0][1].shape[0]
        rows = []
        for spec in corrupt:
            row = torch.zeros(n)
            if spec is not None:
                lo, hi = (int(v) for v in spec.split("-"))
                row[lo:hi + 1] = 1.0
            rows.append(row)
        cor = torch.stack(rows)
    xb, pib, diags = solvers.assimilate_date_batch(
        linearize, _stack_bands([p[0] for p in problems]),
        torch.stack([p[1] for p in problems]),
        torch.stack([p[2] for p in problems]),
        None if aux is None else solvers.stack_aux(aux),
        solvers.stack_solver_options(opts), corrupt=cor, device="cpu")
    for m, (x, p_inv, d) in enumerate(solo):
        assert torch.equal(xb[m], x), m
        assert torch.equal(pib[m], p_inv), m
        got = solvers.diagnostics_at(diags, m)
        for field in d._fields:
            a, b = getattr(got, field), getattr(d, field)
            if b is None:
                assert a is None, field
                continue
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) \
                and torch.equal(a.nan_to_num(), b.nan_to_num()), (m, field)
    return solo


def _tip(n, seeds=(0, 1, 2)):
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    out = [make_tip_problem(n, seed=s, device="cpu") for s in seeds]
    op = out[0][0]
    lo, hi = op.state_bounds
    bounds = (torch.as_tensor(lo, dtype=torch.float32),
              torch.as_tensor(hi, dtype=torch.float32))
    return op, [(b, x, p) for _, b, x, p in out], bounds


@pytest.mark.parametrize("extra", [{}, {"inkernel_linearize": False},
                                   {"use_pallas": False},
                                   {"per_pixel_convergence": True}],
                         ids=["fused_gn", "row_loop", "plain", "per_pixel"])
def test_twostream_batch_equals_solo(extra):
    op, problems, bounds = _tip(512)
    opts = [dict(relaxation=0.7, state_bounds=bounds,
                 norm_denominator=float(500 * 7 + k), **extra)
            for k in (0, 0, 9)]
    solo = _assert_members_equal_solo(problems, opts, op.linearize)
    assert all(int(d.n_iterations) >= 2 for _, _, d in solo)


def test_fused_gn_fold_is_one_launch_per_scalar_set(monkeypatch):
    """Members sharing the kernel's scalars ride ONE fused_gn call over
    their concatenated pixels, with groups of the solo size; a member
    with another norm denominator takes its own call."""
    op, problems, bounds = _tip(512)
    calls = []
    real = fused_gn.fused_gn_raw

    def spy(*args, **kwargs):
        calls.append((args[5].shape[1], args[12], kwargs.get("scalar_n")))
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_gn, "fused_gn_raw", spy)
    opts = [dict(relaxation=0.7, state_bounds=bounds,
                 norm_denominator=float(3500 + k)) for k in (0, 0, 9)]
    _assert_members_equal_solo(problems, opts, op.linearize)
    batched = [c for c in calls if c[2] is not None]
    assert sorted(batched) == [(512, 512, 512), (1024, 512, 512)]


def test_fused_gn_fold_pins_groups_to_the_member_size(monkeypatch):
    """n_pad = 2304: a member's groups are gcd(2304, 2048) = 256 px,
    while the fold's own gcd(4608, 2048) = 512 would merge groups
    across members; the fold must pass the solo size."""
    op, problems, bounds = _tip(2304, seeds=(3, 4))
    seen = []
    real = fused_gn.fused_gn_raw

    def spy(*args, **kwargs):
        if kwargs.get("scalar_n") is not None:
            seen.append((args[5].shape[1], args[12]))
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_gn, "fused_gn_raw", spy)
    opts = [dict(relaxation=0.5, state_bounds=bounds)] * 2
    _assert_members_equal_solo(problems, opts, op.linearize)
    assert seen == [(4608, 256)]
    assert fused_gn.launch_geometry(4608, 256)["group"] == 256
    assert fused_gn.launch_geometry(4608)["group"] == 512


def test_twostream_batch_with_a_planted_member():
    op, problems, bounds = _tip(256, seeds=(5, 6))
    opts = [dict(relaxation=0.7, state_bounds=bounds)] * 2
    _assert_members_equal_solo(problems, opts, op.linearize,
                               corrupt=[None, "10-19"])


def test_identity_row_loop_is_one_launch_per_iteration(monkeypatch):
    """Two identity members with different iteration counts: one
    fused_update_rows call per iteration over every member still
    iterating (both, then the slower one alone)."""
    from kafka_tpu_torch.obsops.identity import IdentityOperator

    op = IdentityOperator(n_params=2, obs_indices=(0, 1))
    rng = np.random.default_rng(0)
    problems = []
    for scale in (0.05, 1.0):
        n = 384
        y = torch.as_tensor(rng.normal(0.5, scale, (2, n)), dtype=torch.float32)
        mask = torch.as_tensor(rng.uniform(size=(2, n)) > 0.1)
        bands = BandBatch(y=y, r_inv=torch.full((2, n), 2500.0), mask=mask)
        x0 = torch.full((n, 2), 0.5)
        p0 = torch.eye(2).expand(n, 2, 2) * 6.25
        problems.append((bands, x0, p0))
    widths = []
    real = solvers.fused_update_rows

    def spy(*args):
        widths.append(args[5].shape[1])
        return real(*args)

    monkeypatch.setattr(solvers, "fused_update_rows", spy)
    opts = [{"relaxation": 0.5}, {"relaxation": 0.5}]
    solo = _assert_members_equal_solo(problems, opts, op.linearize)
    iters = [int(d.n_iterations) for _, _, d in solo]
    widths = widths[sum(iters):]
    assert len(widths) == max(iters)
    assert widths[:min(iters)] == [768] * min(iters)
    assert widths[min(iters):] == [384] * (max(iters) - min(iters))


def _identity_members(scales=(0.05, 1.0), n=384, seed=0):
    from kafka_tpu_torch.obsops.identity import IdentityOperator

    op = IdentityOperator(n_params=2, obs_indices=(0, 1))
    rng = np.random.default_rng(seed)
    problems = []
    for scale in scales:
        y = torch.as_tensor(rng.normal(0.5, scale, (2, n)),
                            dtype=torch.float32)
        mask = torch.as_tensor(rng.uniform(size=(2, n)) > 0.1)
        bands = BandBatch(y=y, r_inv=torch.full((2, n), 2500.0), mask=mask)
        x0 = torch.full((n, 2), 0.5)
        p0 = torch.eye(2).expand(n, 2, 2) * 6.25
        problems.append((bands, x0, p0))
    return op, problems


def _width_spy(monkeypatch, module, name, index, dim):
    """Record ``args[index].shape[dim]`` (the pixel width) of every call
    of ``module.name``."""
    widths = []
    real = getattr(module, name)

    def spy(*args):
        widths.append(args[index].shape[dim])
        return real(*args)

    monkeypatch.setattr(module, name, spy)
    return widths


def _lockstep_widths(widths, iters, n):
    """The calls of the batched round (after the solo ones): one per step
    over both members while both iterate, then the slower one alone."""
    widths = widths[sum(iters):]
    assert len(widths) == max(iters)
    assert widths[:min(iters)] == [2 * n] * min(iters)
    assert widths[min(iters):] == [n] * (max(iters) - min(iters))


def test_per_pixel_round_is_one_launch_per_step(monkeypatch):
    """Two identity members under per-pixel convergence that freeze at
    different steps: one fused_update_rows call per step over every
    member still iterating, all their pixels (frozen ones included), and
    each member the bits of its solo solve."""
    op, problems = _identity_members()
    widths = _width_spy(monkeypatch, solvers, "fused_update_rows", 5, -1)
    opts = [{"relaxation": 0.5, "per_pixel_convergence": True},
            {"relaxation": 0.3, "per_pixel_convergence": True}]
    solo = _assert_members_equal_solo(problems, opts, op.linearize)
    iters = [int(d.n_iterations) for _, _, d in solo]
    assert iters[0] != iters[1], iters
    _lockstep_widths(widths, iters, 384)
    # The members froze at different steps; frozen pixels still rode
    # every launch of their member.
    frozen = [d.converged_mask for _, _, d in solo]
    assert all(f is not None and bool(f.any()) for f in frozen)


def test_per_pixel_round_equals_solo_on_broadcast_priors():
    """Members whose solo solves get the prior as a broadcast view (the
    engine's prior-only dates: one pixel's mean and information expanded
    over the batch) keep their solo bits in the round, whose members are
    stacked copies: the loop runs on one memory layout whatever the
    caller's (on these seeds a stride-0 state once moved a member's
    convergence norm)."""
    op, problems, bounds = _tip(512, seeds=(2, 3))
    n = 512
    problems = [(b, x[:1].expand(n, -1), p[:1].expand(n, -1, -1))
                for b, x, p in problems]
    opts = [dict(relaxation=0.7, state_bounds=bounds,
                 per_pixel_convergence=True)] * 2
    _assert_members_equal_solo(problems, opts, op.linearize)


def test_per_pixel_round_reads_the_host_once_per_step(monkeypatch):
    """The members' loop conditions are read in one host transfer per
    step, not one per member."""
    op, problems = _identity_members()
    opts = [{"relaxation": 0.5, "per_pixel_convergence": True},
            {"relaxation": 0.3, "per_pixel_convergence": True}]
    reads = []
    real = torch.Tensor.tolist

    def tolist(t):
        reads.append(tuple(t.shape))
        return real(t)

    stacked = solvers.stack_solver_options(opts)
    args = (_stack_bands([p[0] for p in problems]),
            torch.stack([p[1] for p in problems]),
            torch.stack([p[2] for p in problems]))
    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    _, _, diags = solvers.assimilate_date_batch(
        op.linearize, *args, None, stacked, device="cpu")
    monkeypatch.undo()
    iters = sorted(int(v) for v in diags.n_iterations)
    # One read of both flags per step while both iterate (the last read
    # stops the faster member), then the slower member's own.
    assert reads.count((2,)) == iters[0] + 1


def _kernels_members(n=96, seeds=(1, 2)):
    """Two seeded MOD09-like dates of the p = 21 Ross-Li state (the
    dense path): per-pixel kernels, NaN nodata under the mask."""
    from kafka_tpu_torch.obsops.kernels import KernelsAux, KernelsOperator

    p, nb = 21, 7
    problems, aux = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        k_vol = rng.uniform(-0.1, 0.4, n).astype(np.float32)
        k_geo = rng.uniform(-1.5, -0.5, n).astype(np.float32)
        truth = np.tile([0.12, 0.05, 0.02], nb).astype(np.float32) \
            + rng.normal(0, 0.02, (n, p)).astype(np.float32)
        w = truth.reshape(n, nb, 3)
        y = (w[..., 0] + k_vol[:, None] * w[..., 1]
             + k_geo[:, None] * w[..., 2]).T
        y = (y + rng.normal(0, 0.005, y.shape)).astype(np.float32)
        mask = rng.uniform(size=y.shape) > 0.2
        bands = BandBatch(
            y=torch.as_tensor(np.where(mask, y, 0.0)),
            r_inv=torch.as_tensor(np.where(mask, 1.0 / 0.005 ** 2, 0.0)
                                  .astype(np.float32)),
            mask=torch.as_tensor(mask))
        x_f = torch.as_tensor(np.tile([0.15, 0.05, 0.02], nb)
                              .astype(np.float32)).expand(n, p).clone()
        p_inv = (torch.eye(p) / 0.2 ** 2).expand(n, p, p).clone()
        problems.append((bands, x_f, p_inv))
        aux.append(KernelsAux(torch.as_tensor(k_vol),
                              torch.as_tensor(k_geo)))
    return KernelsOperator(), problems, aux


@pytest.mark.parametrize("per_pixel", [False, True],
                         ids=["global_norm", "per_pixel"])
def test_dense_p21_round_equals_solo(monkeypatch, per_pixel):
    """The dense p = 21 path: the members' loops in lockstep, each step
    ONE dense solve over both members' stacked normal equations while
    both iterate, and each member the bits of its solo solve."""
    op, problems, aux = _kernels_members()
    widths = _width_spy(monkeypatch, solvers, "solve_spd_batched", 1, 0)
    opts = [{"relaxation": r, "norm_denominator": 1.0,
             "per_pixel_convergence": per_pixel} for r in (0.6, 0.9)]
    solo = _assert_members_equal_solo(problems, opts, op.linearize, aux=aux)
    iters = [int(d.n_iterations) for _, _, d in solo]
    assert iters[0] != iters[1], iters
    _lockstep_widths(widths, iters, 96)


def test_s2_prosail_batch_equals_solo():
    from kafka_tpu_torch.testing.synthetic import make_prosail_problem

    probs = [make_prosail_problem(64, seed=s, device="cpu") for s in (11, 12)]
    op = probs[0][0]
    problems = [(p[1], p[2], p[3]) for p in probs]
    aux = [p[4] for p in probs]
    opts = [{"relaxation": 0.7, "state_bounds": op.state_bounds}] * 2
    _assert_members_equal_solo(problems, opts, op.linearize, aux=aux)


def test_stack_solver_options_refuses_mixed_members():
    with pytest.raises(ValueError, match="structural"):
        solvers.stack_solver_options([{"use_pallas": False}, {}])
    with pytest.raises(ValueError, match="keys"):
        solvers.stack_solver_options([{"relaxation": 0.5}, {}])
    stacked = solvers.stack_solver_options(
        [{"relaxation": 0.5, "max_iterations": 7},
         {"relaxation": 0.25, "max_iterations": 7}])
    assert stacked["max_iterations"] == 7
    assert stacked["relaxation"].tolist() == [0.5, 0.25]
    assert solvers.structural_options({"use_pallas": True}) == \
        (None, True, False, True, None, None)


# ---------------------------------------------------------------------------
# the micro-window (stub sessions) and real partitions
# ---------------------------------------------------------------------------

class _Bucket:
    def __init__(self, key):
        self.key = key


class BucketStubSession:
    def __init__(self, name, key="bucket0", sleep_s=0.0):
        self.name = name
        self._key = key
        self.sleep_s = sleep_s
        self.serves = 0

    def serve_bucket(self):
        return None if self._key is None else _Bucket((self._key,))

    def serve(self, date, smoothed=False, dispatcher=None):
        self.serves += 1
        if self.sleep_s:
            time.sleep(self.sleep_s)
        return {"status": "ok", "x_sha256": f"stub-{self.name}",
                "date": date.isoformat(), "served_from": "cold"}


def stub_batch_service(tmp_path, names, window_ms=250.0, max_batch=8,
                       keys=None):
    sessions = {n: BucketStubSession(n, key=(keys[i] if keys else "b0"))
                for i, n in enumerate(names)}
    svc = AssimilationService(
        sessions, str(tmp_path), policy=AdmissionPolicy(max_queue_depth=64),
        retry_policy=FAST2, batch_window_ms=window_ms, max_batch=max_batch)
    return svc, sessions


def _submit_group(svc, reqs):
    for tile, date, rid in reqs:
        svc.submit({"tile": tile, "date": date.isoformat(),
                    "request_id": rid})
    return {rid: svc.result(rid, timeout_s=120) for _, _, rid in reqs}


def _stamp(body):
    trace = body.get("trace") or {}
    return trace.get("batch_id"), trace.get("batch_size")


def _sig(body):
    return (body.get("x_sha256"), body.get("solver_health"),
            body.get("quality"))


def test_window_coalesces_compatible_tiles(tmp_path):
    with telemetry.use(MetricsRegistry()) as reg:
        names = [f"t{i}" for i in range(4)]
        svc, sessions = stub_batch_service(tmp_path, names, 2000.0, 4)
        svc.start()
        try:
            got = _submit_group(svc, [(n, D1, f"r-{n}") for n in names])
        finally:
            svc.close()
        stamps = {_stamp(b) for b in got.values()}
        assert len(stamps) == 1 and next(iter(stamps))[1] == 4
        assert reg.value("kafka_serve_batches_total") == 1
        assert reg.value("kafka_serve_batch_requests_total") == 4
        assert all(s.serves == 1 for s in sessions.values())


def test_same_tile_and_smoothed_never_mix(tmp_path):
    with telemetry.use(MetricsRegistry()) as reg:
        svc, _ = stub_batch_service(tmp_path, ["t0", "t1"], 150.0)
        svc.start()
        try:
            got = _submit_group(svc, [("t0", D1, "a"), ("t0", D2, "a2"),
                                      ("t1", D1, "b")])
            assert _stamp(got["a"])[1] == _stamp(got["b"])[1] == 2
            assert _stamp(got["a2"]) == (None, None)
            svc.submit({"tile": "t0", "date": D3.isoformat(),
                        "request_id": "sm", "smoothed": True})
            sm = svc.result("sm", timeout_s=30)
            assert sm["status"] == "ok" and _stamp(sm) == (None, None)
            assert reg.value("kafka_serve_batches_total") == 1
        finally:
            svc.close()


def test_incompatible_buckets_do_not_mix(tmp_path):
    with telemetry.use(MetricsRegistry()) as reg:
        svc, _ = stub_batch_service(tmp_path, ["t0", "t1", "t2"], 100.0,
                                    keys=["ka", "kb", None])
        svc.start()
        try:
            got = _submit_group(svc, [("t0", D1, "a"), ("t1", D1, "b"),
                                      ("t2", D1, "c")])
        finally:
            svc.close()
        assert all(b["status"] == "ok" and _stamp(b) == (None, None)
                   for b in got.values())
        assert reg.value("kafka_serve_batches_total") is None


def test_drain_flushes_a_partial_window_immediately(tmp_path):
    with telemetry.use(MetricsRegistry()):
        svc, _ = stub_batch_service(tmp_path, ["t0", "t1"], 10_000.0)
        svc.start()
        try:
            svc.submit({"tile": "t0", "date": D1.isoformat(),
                        "request_id": "r1"})
            deadline = time.monotonic() + 5
            while svc.pending() and time.monotonic() < deadline:
                time.sleep(0.005)
            time.sleep(0.05)
            t0 = time.monotonic()
            svc.stop_admitting()
            assert svc.drain(timeout_s=30)
            got = svc.result("r1", timeout_s=1)
            assert got is not None and got["status"] == "ok"
            assert time.monotonic() - t0 < 2.0
        finally:
            svc.close()


SEEDS = {"t0": 1, "t1": 2, "t2": 3}


def _tile(tmp_path, name, seed, operator="identity"):
    return TileSession(make_synthetic_tile(
        name, str(tmp_path / f"ck_{name}_{seed}"), operator=operator,
        seed=seed, mask_seed=0, device="cpu"))


def _real_service(tmp_path, tag, operator="identity", window_ms=1500.0):
    sessions = {t: _tile(tmp_path, f"{tag}{t}", s, operator)
                for t, s in SEEDS.items()}
    return AssimilationService(
        sessions, str(tmp_path / f"root_{tag}"),
        policy=AdmissionPolicy(max_queue_depth=64),
        batch_window_ms=window_ms, max_batch=2)


def _baselines(tmp_path, operator, dates):
    base = {}
    with telemetry.use(MetricsRegistry()):
        for t, seed in SEEDS.items():
            sess = _tile(tmp_path, f"solo{t}", seed, operator)
            for d in dates:
                r = sess.serve(d)
                base[(t, d)] = (_sig(r), r["served_from"])
    return base


@pytest.mark.parametrize("operator", ["identity", "twostream"])
def test_partitions_are_bit_identical_on_every_path(tmp_path, operator):
    """{t0, t1} batched + {t2} solo at D1 (cold), {t0, t1} at D2
    (warm_noop) and D3 (warm), then a mixed cache-hit / miss group:
    every payload equal to the one-at-a-time baseline."""
    base = _baselines(tmp_path, operator, (D1, D2, D3))
    assert [base[("t0", d)][1] for d in (D1, D2, D3)] == \
        ["cold", "warm_noop", "warm"]
    with telemetry.use(MetricsRegistry()) as reg:
        svc = _real_service(tmp_path, "p1", operator)
        svc.start()
        try:
            got = _submit_group(svc, [("t0", D1, "c0"), ("t1", D1, "c1")])
            got.update(_submit_group(svc, [("t2", D1, "c2")]))
            assert _stamp(got["c0"])[1] == 2
            assert _stamp(got["c0"])[0] == _stamp(got["c1"])[0]
            assert _stamp(got["c2"]) == (None, None)
            for rid, t in (("c0", "t0"), ("c1", "t1"), ("c2", "t2")):
                assert got[rid]["served_from"] == "cold"
                assert _sig(got[rid]) == base[(t, D1)][0], rid
            for d, kind in ((D2, "warm_noop"), (D3, "warm")):
                got = _submit_group(svc, [("t0", d, f"{kind}0"),
                                          ("t1", d, f"{kind}1")])
                for rid, t in ((f"{kind}0", "t0"), (f"{kind}1", "t1")):
                    assert got[rid]["served_from"] == kind
                    assert _stamp(got[rid])[1] == 2
                    assert _sig(got[rid]) == base[(t, d)][0], rid
            got = _submit_group(svc, [("t0", D1, "m0"), ("t2", D3, "m1")])
            assert got["m0"]["served_from"] == "cache"
            assert _sig(got["m0"]) == base[("t0", D1)][0]
            assert got["m1"]["served_from"] == "warm"
            assert _sig(got["m1"]) == base[("t2", D3)][0]
        finally:
            svc.close()
        assert reg.value("kafka_serve_batch_coalesced_total") >= 3


def test_mid_batch_poison_is_answered_alone(tmp_path):
    base = _baselines(tmp_path, "identity", (D1, D3))
    with telemetry.use(MetricsRegistry()) as reg:
        svc = _real_service(tmp_path, "p2")
        svc.start()
        try:
            got = _submit_group(svc, [("t0", D1, "c0"), ("t2", D1, "c2")])
            got.update(_submit_group(svc, [("t1", D1, "c1")]))
            for rid, t in (("c0", "t0"), ("c1", "t1"), ("c2", "t2")):
                assert _sig(got[rid]) == base[(t, D1)][0], rid
            faults.script("serve.solve", "1", POISON)
            got = _submit_group(svc, [("t0", D3, "x0"), ("t2", D3, "x2")])
            assert {b["status"] for b in got.values()} == {"ok", "error"}
            for rid, t in (("x0", "t0"), ("x2", "t2")):
                assert _stamp(got[rid])[1] == 2
                if got[rid]["status"] == "ok":
                    assert _sig(got[rid]) == base[(t, D3)][0], rid
            assert reg.value("kafka_serve_errors_total") == 1
            faults.reset()
            got = _submit_group(svc, [("t1", D3, "after")])
            assert _sig(got["after"]) == base[("t1", D3)][0]
        finally:
            svc.close()


def test_bucket_probe_and_warm_up(tmp_path):
    """Two tiles over one mask share a bucket, a two-stream tile gets
    another, an explicit ``use_pallas: True`` gets none; the
    warm-up runs each bucket's program at each declared batch size and
    reports the JAX manifest's keys."""
    a, b = (_tile(tmp_path, n, s) for n, s in (("a", 1), ("b", 2)))
    c = _tile(tmp_path, "c", 5, operator="twostream")
    assert batching.session_bucket_key(a) == batching.session_bucket_key(b)
    assert batching.session_bucket_key(a) != batching.session_bucket_key(c)
    spec = make_synthetic_tile("d", str(tmp_path / "ck_d"), device="cpu")
    make = spec.make_filter

    def explicit():
        kf, x0, p0, out = make()
        kf.solver_options = {"use_pallas": True}
        return kf, x0, p0, out

    spec.make_filter = explicit
    assert batching.session_bucket_key(TileSession(spec)) is None
    launches = fused_update_rows.launches
    manifest = batching.aot_compile_buckets({"a": a, "b": b, "c": c},
                                            batch_sizes=(1, 2))
    assert fused_update_rows.launches == launches  # plain versions here
    assert manifest["count"] == 2
    entry = manifest["buckets"][0]
    assert entry["tiles"] == ["a", "b"] and entry["batch_sizes"] == [1, 2]
    assert {"n_pad", "p", "n_bands", "options", "compile_ms"} <= set(entry)


def test_rendezvous_under_thread_stress(monkeypatch):
    """Sixteen member threads, more than the cores, posting rounds of
    different lengths under a short switch interval: every post gets
    its own member's answer, every post rides exactly one launch, and
    the launch counters add up (a lost update in the rendezvous would
    break one of the three)."""
    import sys
    import threading

    def solo(linearize, obs, x, p_inv, aux, opts, hess, device=None):
        return x + 1.0, p_inv, None

    def batch(linearize, obs, xs, pis, aux, opts, hess, corrupt=None,
              device=None):
        return xs + 1.0, pis, None

    monkeypatch.setattr(solvers, "assimilate_date", solo)
    monkeypatch.setattr(solvers, "assimilate_date_batch", batch)
    monkeypatch.setattr(solvers, "diagnostics_at", lambda d, i: d)
    members, rounds = 16, [3 + (m % 5) for m in range(16)]
    bands = BandBatch(y=torch.zeros(1, 4), r_inv=torch.zeros(1, 4),
                      mask=torch.zeros(1, 4, dtype=torch.bool))
    wrong, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.use(MetricsRegistry()) as reg:
            executor = batching.BatchExecutor()
            handles = executor.open(members)

            def run(m):
                try:
                    dispatch = handles[m].dispatcher()
                    for r in range(rounds[m]):
                        x = torch.full((4, 2), float(1000 * m + r))
                        got = dispatch(None, bands, x, torch.eye(2)
                                       .expand(4, 2, 2), None, {}, None)[0]
                        if not torch.equal(got, x + 1.0):
                            wrong.append((m, r))
                except BaseException as exc:  # noqa: B036 — reported below
                    errors.append(repr(exc))
                finally:
                    handles[m].close()

            threads = [threading.Thread(target=run, args=(m,))
                       for m in range(members)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert errors == [] and wrong == []
            assert reg.value("kafka_serve_batch_launch_members_total") \
                == sum(rounds)
            # Round r waits for every member still posting: one launch
            # per round, coalesced while two or more are left.
            assert reg.value("kafka_serve_batch_launches_total") == \
                max(rounds)
            assert reg.value("kafka_serve_batch_coalesced_total") == sum(
                sum(n > r for n in rounds) > 1 for r in range(max(rounds)))
    finally:
        sys.setswitchinterval(old)
