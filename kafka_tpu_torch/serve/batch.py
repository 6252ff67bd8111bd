"""Coalesced serving: the batch executor (port of
``kafka_tpu/serve/batch.py``).

Every ``TileSession.serve`` call and every per-date solve dispatch on
the serve path funnels through here, so batching semantics — and their
bit-identity guarantee — cannot be bypassed by a new call site.

Admission groups compatible queued requests by COARSE shape bucket
(:func:`probe_bucket`): padded pixel-batch size ``n_pad``, parameter
count ``p``, band count, structural solver options and the operator
fingerprint.  The service then runs each member's FULL serve pipeline
concurrently (one thread per member, distinct tiles only — sessions are
not thread-safe), with the engine's per-date dispatch replaced by a
rendezvous post (:class:`_Rendezvous`).  When every live member has
posted, the last poster executes the round on its own thread: posts
with identical EXACT keys (argument shapes, dtypes, devices and
statics) ride one ``core.solvers.assimilate_date_batch`` round — for
the two-stream tile ONE fused Gauss-Newton launch over every member's
pixels, for the row loop one fused-update launch per iteration — each
member keeping its own convergence norm and iteration count, its
output bit-identical to a solo ``assimilate_date``.  Posts that don't
group execute solo through ``assimilate_date``.

Membership is dynamic: a member leaves on finish or error (a poison
request errors alone — its peers simply rendezvous without it), and a
leave triggers execution when everyone still in is already posted.

An explicit ``use_pallas: True`` gets no bucket (as in the JAX
package); an unset ``use_pallas`` — the kernel path in the port — does,
so a coalesced round of default sessions runs the hand kernels.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import solver_health, solvers
from ..core.types import BandBatch
from ..telemetry import get_registry

LOG = logging.getLogger(__name__)


def _batch_metrics(reg):
    """Rendezvous-level launch counters (the one owning site)."""
    return {
        "launches": reg.counter(
            "kafka_serve_batch_launches_total",
            "device launches issued by the serve batch executor's "
            "rendezvous (coalesced and solo rounds alike)",
        ),
        "launch_members": reg.counter(
            "kafka_serve_batch_launch_members_total",
            "solve members carried by rendezvous launches — divided by "
            "launches this is the mean device-level batch size",
        ),
        "coalesced": reg.counter(
            "kafka_serve_batch_coalesced_total",
            "rendezvous launches that stacked two or more members into "
            "one vmapped device program",
        ),
    }


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------

class ShapeBucket:
    """One tile's serve-compatibility fingerprint plus the
    representative pieces the warm-up needs.  Two sessions whose
    buckets share ``key`` may coalesce; ``linearize``/``hessian_forward``
    are the bucket's canonical statics."""

    def __init__(self, key, n_pad, p, n_bands, linearize,
                 hessian_forward, solver_options, example):
        self.key = key
        self.n_pad = int(n_pad)
        self.p = int(p)
        self.n_bands = int(n_bands)
        self.linearize = linearize
        self.hessian_forward = hessian_forward
        #: the per-date option dict exactly as the engine dispatches it
        self.solver_options = solver_options
        #: (bands, x0, p_inv0, aux) — representative concrete arguments
        self.example = example

    def describe(self) -> dict:
        return {
            "n_pad": self.n_pad, "p": self.p, "n_bands": self.n_bands,
            "options": sorted(
                k for k in (self.solver_options or {})
            ),
        }


def _array_token(a) -> tuple:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return (a.shape, str(a.dtype), hashlib.sha256(a.tobytes()).hexdigest())


def _plain_value(v):
    """``v`` as a hashable value when it is a scalar or a (nested)
    sequence of scalars, else None."""
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        return v
    if isinstance(v, (tuple, list)):
        items = tuple(_plain_value(e) for e in v)
        if all(e is not None or o is None for e, o in zip(items, v)):
            return (type(v).__name__,) + items
    return None


def _operator_fingerprint(op) -> tuple:
    """A conservative value fingerprint of an observation operator:
    equal fingerprints mean functionally identical operators; attributes
    the fingerprint cannot inspect make the operator unique — preventing
    coalescing rather than risking a wrong shared launch.  Operators may
    override via a ``serve_bucket_token()`` method."""
    token = getattr(op, "serve_bucket_token", None)
    if callable(token):
        return ("token", type(op).__module__, type(op).__qualname__,
                token())
    parts: List[Any] = [type(op).__module__, type(op).__qualname__]
    for k in sorted(vars(op) or {}):
        v = vars(op)[k]
        plain = _plain_value(v)
        if plain is not None or v is None:
            parts.append((k, plain))
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            parts.append((k,) + _array_token(v))
        else:
            # Opaque attribute: fall back to instance identity — this
            # operator only ever buckets with itself.
            parts.append((k, f"id:{id(v)}"))
    return tuple(parts)


def probe_bucket(session) -> Optional[ShapeBucket]:
    """Derive a session's :class:`ShapeBucket` from one throwaway
    filter, or ``None`` when the tile cannot coalesce: fused scan
    windows and band-sequential loops keep their own launch structure,
    an explicit ``use_pallas: True`` is excluded as in the JAX package,
    and duck-typed sessions without a real ``TileSpec`` serve
    unbatched."""
    spec = getattr(session, "spec", None)
    make = getattr(spec, "make_filter", None)
    if make is None:
        return None
    kf, x0, p_inv0, output = make()
    try:
        if getattr(kf, "scan_window", 1) != 1:
            return None
        if getattr(kf, "band_sequential", False):
            return None
        dates = list(kf.observations.dates)
        if not dates:
            return None
        obs = kf.observations.get_observations(dates[0], kf.gather)
        opts = kf.date_solver_options(obs.operator)
        statics = solvers.structural_options(opts)
        use_pallas = statics[1]
        if use_pallas:
            return None
        hess = None
        if kf.hessian_correction:
            hess = getattr(obs.operator, "forward_pixel", None)
        key = (
            kf.gather.n_pad, kf.n_params, obs.operator.n_bands,
            _operator_fingerprint(obs.operator), statics,
            tuple(sorted(
                k for k in opts
                if k not in solvers.STRUCTURAL_OPTION_KEYS
            )),
            bool(kf.hessian_correction),
            str(kf.device),
        )
        return ShapeBucket(
            key=key, n_pad=kf.gather.n_pad, p=kf.n_params,
            n_bands=obs.operator.n_bands,
            linearize=obs.operator.linearize, hessian_forward=hess,
            solver_options=opts,
            example=(obs.bands, x0, p_inv0, obs.aux),
        )
    finally:
        close = getattr(output, "close", None)
        if close is not None:
            close()


def session_bucket_key(session):
    """The coarse compatibility key the admission micro-window groups
    on, or ``None`` when the session cannot coalesce."""
    get = getattr(session, "serve_bucket", None)
    if get is None:
        return None
    bucket = get()
    return None if bucket is None else bucket.key


# ---------------------------------------------------------------------------
# the serve call-through
# ---------------------------------------------------------------------------

def solve_session(session, date, smoothed: bool = False,
                  dispatcher=None) -> dict:
    """The serve-solve entry point: the service's singleton path and
    every batch member funnel through here.  Plain calls keep the
    duck-typed ``serve(date)`` signature; only batch members pass a
    dispatcher."""
    if smoothed:
        return session.serve(date, smoothed=True)
    if dispatcher is None:
        return session.serve(date)
    return session.serve(date, dispatcher=dispatcher)


# ---------------------------------------------------------------------------
# the rendezvous
# ---------------------------------------------------------------------------

def _avals(tree) -> tuple:
    """Shapes, dtypes and devices of a tree's tensor leaves (NamedTuples,
    tuples, lists and dicts walk; other leaves by type and value)."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _avals(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_avals(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype), str(tree.device))
    if isinstance(tree, np.ndarray):
        return (tree.shape, str(tree.dtype))
    return (type(tree).__name__,)


class _Post:
    """One member's blocked per-date dispatch."""

    __slots__ = ("linearize", "obs", "x", "p_inv", "aux", "opts",
                 "hess", "corrupt", "done", "result", "error")

    def __init__(self, linearize, obs, x, p_inv, aux, opts, hess,
                 corrupt):
        self.linearize = linearize
        self.obs = obs
        self.x = x
        self.p_inv = p_inv
        self.aux = aux
        self.opts = opts
        self.hess = hess
        self.corrupt = corrupt
        self.done = False
        self.result = None
        self.error = None

    def exact_key(self) -> tuple:
        """Stackability: identical shapes + statics + option keys."""
        opts = dict(self.opts or {})
        statics = solvers.structural_options(opts)
        return (
            _avals(tuple(self.obs)), _avals(self.x), _avals(self.p_inv),
            _avals(self.aux), statics,
            _avals({k: v for k, v in opts.items()
                    if k not in solvers.STRUCTURAL_OPTION_KEYS}),
            self.corrupt is None,
        )


class _Rendezvous:
    """Barrier-cycle meeting point for one admitted batch: members post
    per-date dispatches; when every live member has posted, the last
    poster (or the last leaver) executes the round on its own thread
    and wakes everyone with their own slice."""

    def __init__(self, executor: "BatchExecutor", size: int):
        self._executor = executor
        self._cond = threading.Condition()
        self._active = size
        self._posted: Dict[int, _Post] = {}

    def post(self, index: int, post: _Post):
        with self._cond:
            self._posted[index] = post
            if len(self._posted) >= self._active:
                self._execute_locked()
            else:
                while not post.done:
                    self._cond.wait()
        if post.error is not None:
            raise post.error
        return post.result

    def leave(self, index: int) -> None:
        with self._cond:
            self._active -= 1
            self._posted.pop(index, None)
            if self._posted and len(self._posted) >= self._active:
                self._execute_locked()

    # -- execution (condition lock held; every live member is parked) --

    def _execute_locked(self) -> None:
        posts = self._posted
        self._posted = {}
        groups: Dict[tuple, List[_Post]] = {}
        for index in sorted(posts):
            p = posts[index]
            groups.setdefault(p.exact_key(), []).append(p)
        for key, group in groups.items():
            try:
                self._launch(key, group)
            except BaseException as exc:  # noqa: B036 — delivered to members
                for p in group:
                    p.error = exc
                    p.done = True
        self._cond.notify_all()

    def _launch(self, key: tuple, group: List[_Post]) -> None:
        metrics = self._executor.metrics()
        t0 = time.perf_counter()
        dev = group[0].x.device
        if len(group) == 1:
            p = group[0]
            # Solo round: the exact dispatch a dispatcher-less serve
            # would have made.
            p.result = solvers.assimilate_date(
                p.linearize, p.obs, p.x, p.p_inv, p.aux, p.opts, p.hess,
                device=dev,
            ) + (t0, time.perf_counter(), 1)
            p.done = True
        else:
            lin, hess = self._executor.canonical_statics(key, group[0])
            bands = BandBatch(*[
                torch.stack([torch.as_tensor(getattr(p.obs, f), device=dev)
                             for p in group])
                for f in BandBatch._fields])
            xs = torch.stack([p.x for p in group])
            pis = torch.stack([p.p_inv for p in group])
            aux = solvers.stack_aux([p.aux for p in group])
            bopts = solvers.stack_solver_options(
                [p.opts for p in group]
            )
            corrupt = None
            if any(p.corrupt is not None for p in group):
                n_pix = group[0].x.shape[0]
                corrupt = torch.stack([
                    torch.zeros((n_pix,), dtype=torch.float32, device=dev)
                    if p.corrupt is None
                    else torch.as_tensor(p.corrupt, dtype=torch.float32,
                                         device=dev)
                    for p in group
                ])
            xb, pib, diagb = solvers.assimilate_date_batch(
                lin, bands, xs, pis, aux, bopts, hess, corrupt, device=dev,
            )
            t1 = time.perf_counter()
            for i, p in enumerate(group):
                p.result = (
                    xb[i], pib[i], solvers.diagnostics_at(diagb, i),
                    t0, t1, len(group),
                )
                p.done = True
            metrics["coalesced"].inc()
        metrics["launches"].inc()
        metrics["launch_members"].inc(len(group))


class _Member:
    """One request's handle on a rendezvous: provides the engine
    dispatcher and the obligatory ``close()`` (idempotent; call it in a
    ``finally`` — success, error and cache-hit paths alike)."""

    def __init__(self, rendezvous: _Rendezvous, index: int):
        self._rendezvous = rendezvous
        self._index = index
        self._closed = False
        #: set by the service on the member's first (and only) batched
        #: solve attempt — retries run solo, after the member left.
        self.used = False
        #: (t_start, t_end) of every coalesced launch this member rode
        self.batch_spans: List[tuple] = []
        #: member counts of those launches
        self.launch_sizes: List[int] = []

    def dispatcher(self):
        """An ``assimilate_date``-shaped callable that posts to the
        rendezvous instead of launching directly."""

        def dispatch(linearize, obs, x, p_inv, aux, opts, hess):
            # solver.pixel chaos hook: host-side, per member, at the
            # same point the solo path evaluates it.
            corrupt = solver_health.corruption_mask(x.shape[0])
            post = _Post(linearize, obs, x, p_inv, aux,
                         dict(opts or {}), hess, corrupt)
            x_a, p_inv_a, diags, t0, t1, size = \
                self._rendezvous.post(self._index, post)
            if size > 1:
                self.batch_spans.append((t0, t1))
                self.launch_sizes.append(size)
                get_registry().trace.add_span(
                    "serve_batch", t0, t1, cat="phase", members=size,
                )
            return x_a, p_inv_a, diags

        return dispatch

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._rendezvous.leave(self._index)


class BatchExecutor:
    """Factory for rendezvous batches + the process-wide canonical
    statics per exact key."""

    def __init__(self):
        self._lock = threading.Lock()
        self._canonical: Dict[tuple, tuple] = {}
        self._metrics = None

    def metrics(self):
        with self._lock:
            if self._metrics is None:
                self._metrics = _batch_metrics(get_registry())
            return self._metrics

    def reset_metrics(self) -> None:
        """Re-bind counters after a registry swap (tests)."""
        with self._lock:
            self._metrics = None

    def canonical_statics(self, key: tuple, post: _Post) -> tuple:
        with self._lock:
            if key not in self._canonical:
                self._canonical[key] = (post.linearize, post.hess)
            return self._canonical[key]

    def open(self, size: int) -> List[_Member]:
        """A fresh rendezvous with ``size`` member handles."""
        rendezvous = _Rendezvous(self, size)
        return [_Member(rendezvous, i) for i in range(size)]


# ---------------------------------------------------------------------------
# start-up warm-up of the shape buckets
# ---------------------------------------------------------------------------

def aot_compile_buckets(sessions: dict, batch_sizes=(1,)) -> dict:
    """Warm every distinct shape bucket among the resident tiles before
    the first request is admitted (the JAX package lowers and compiles
    them here; the port has no per-shape compile): the kernel sources
    are built (``core/_build.py``) and each bucket's solo program, and
    its program at each declared batch size, run once on zeros of the
    bucket's shapes (``solvers.lower_date_program``) — so no request
    pays the build, and no two member threads race to build a kernel.

    Returns the ``serve_aot_buckets`` status fact: one entry per
    distinct bucket with its tiles, shapes and warm-up wall time (the
    JAX manifest's keys: ``compile_ms`` is that wall time)."""
    buckets: Dict[tuple, dict] = {}
    for name in sorted(sessions):
        get = getattr(sessions[name], "serve_bucket", None)
        bucket = get() if get is not None else None
        if bucket is None:
            continue
        if bucket.key in buckets:
            buckets[bucket.key]["tiles"].append(name)
            continue
        bands, x0, p_inv0, aux = bucket.example
        dev = x0.device
        t0 = time.perf_counter()
        for k in sorted(set(int(k) for k in batch_sizes)):
            if k <= 0:
                continue
            if k == 1:
                solvers.lower_date_program(
                    bucket.linearize, bands, x0, p_inv0, aux,
                    dict(bucket.solver_options),
                    bucket.hessian_forward, device=dev,
                )
            else:
                def stack(t):
                    return torch.stack([torch.as_tensor(t)] * k)

                solvers.lower_date_program(
                    bucket.linearize,
                    BandBatch(*[stack(v) for v in bands]), stack(x0),
                    stack(p_inv0),
                    solvers.stack_aux([aux] * k),
                    solvers.stack_solver_options(
                        [dict(bucket.solver_options)] * k
                    ),
                    bucket.hessian_forward, batch_size=k, device=dev,
                )
        entry = dict(bucket.describe())
        entry.update(
            tiles=[name],
            batch_sizes=sorted(
                int(k) for k in set(batch_sizes) if int(k) > 0
            ),
            compile_ms=round((time.perf_counter() - t0) * 1e3, 3),
        )
        buckets[bucket.key] = entry
    out = list(buckets.values())
    LOG.info(
        "warmed %d serve shape bucket(s) covering %d tile(s)",
        len(out), sum(len(e["tiles"]) for e in out),
    )
    return {"count": len(out), "buckets": out}
