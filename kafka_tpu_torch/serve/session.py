"""Warm per-tile filter state and the incremental serve path (port of
``kafka_tpu/serve/session.py``).

The analysis at the last grid step is a sufficient statistic for
everything before it, so a request only needs the predict/correct steps
AFTER the newest checkpoint — not a full-series rerun.  A
:class:`TileSession` holds one tile's serving state with the CHECKPOINT
SET as the canonical store (``engine.checkpoint.Checkpointer``): every
serve resumes from ``load_latest`` + ``resume_time_grid`` and
re-checkpoints at its end, so a SIGKILLed daemon and an uninterrupted
one read the same durable bytes, and the incremental result equals a
cold full-series rerun.

Serve outcomes (the response's ``served_from`` field):

``cold``
    no usable checkpoint — full-series run from the tile prior,
    checkpointing as it goes.
``warm``
    resumed from the newest intact checkpoint; only the grid windows
    after it ran.
``warm_noop``
    the newest checkpoint already sits AT the requested grid step —
    the state is read back and answered with zero solve work.
``cold_replay``
    the request is BEHIND the warm state.  Served by a throwaway full
    run up to that date with NO checkpointing, so historical reads
    never rewind the warm chain.
``smoothed_chain``
    a ``smoothed=true`` (reanalysis) request: the RTS backward pass
    over the tile's whole checkpoint chain (``kafka_tpu_torch.smoother``),
    answered read-only.  The response's ``x_sha256`` matches what the
    offline ``kafka_smooth`` driver reports for the same chain
    bit for bit.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..engine.checkpoint import Checkpointer
from ..telemetry import get_registry, quality, span, tracing

LOG = logging.getLogger(__name__)


def _host(a) -> np.ndarray:
    """A float32 host array of a tensor (on any device) or array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


class UnknownDateError(ValueError):
    """A requested date the tile's observation source does not carry.
    Poison-classed: retrying cannot make the date exist."""

    kafka_failure_class = "poison"


@dataclasses.dataclass
class TileSpec:
    """Everything needed to (re)build one tile's filter.

    ``make_filter()`` returns ``(kf, x0, p_inv0, output)`` — a FRESH
    ``KalmanFilter`` with its observation source and output writer, plus
    the tile prior's initial state.  It is called once per serve: filter
    objects are cheap, and a fresh prefetcher per run is the engine's
    existing lifecycle.
    """

    name: str
    make_filter: Callable[[], tuple]
    base_date: datetime.datetime
    step_days: int
    ckpt_dir: str
    n_shards: int = 1

    def grid_through(self, date: datetime.datetime) -> List[datetime.datetime]:
        """The tile's canonical time grid extended just past ``date``
        (windows are half-open ``[t_{k-1}, t_k)``, so the last grid
        point must be strictly after the requested observation)."""
        if date < self.base_date:
            raise UnknownDateError(
                f"{date} predates tile base {self.base_date}"
            )
        grid = [self.base_date]
        step = datetime.timedelta(days=self.step_days)
        while grid[-1] <= date:
            grid.append(grid[-1] + step)
        return grid


class TileSession:
    """One tile's serving state; NOT thread-safe (the service serializes
    serves on its worker thread)."""

    def __init__(self, spec: TileSpec):
        self.spec = spec
        self.name = spec.name
        self.checkpointer = Checkpointer(
            spec.ckpt_dir, n_shards=spec.n_shards
        )
        #: the last serve's final (x, p_inv) as host arrays — test and
        #: diagnostics access; the durable state is the checkpoint set.
        self.last_state: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.serves = 0
        self._bucket = None
        self._bucket_built = False

    # -- the serve path -------------------------------------------------

    def serve_bucket(self):
        """The tile's serve shape bucket (``serve.batch.ShapeBucket``) —
        the coarse compatibility fingerprint the admission micro-window
        groups on, plus the representative pieces AOT lowering needs.
        Built once from a throwaway filter; ``None`` when the tile's
        configuration cannot coalesce (fused scans, band-sequential
        loops, filters the probe cannot build)."""
        if not self._bucket_built:
            self._bucket_built = True
            from .batch import probe_bucket

            try:
                self._bucket = probe_bucket(self)
            except Exception:
                LOG.warning(
                    "tile %s: serve-bucket probe failed; the tile will "
                    "serve unbatched", self.name, exc_info=True,
                )
                self._bucket = None
        return self._bucket

    def serve(self, date: datetime.datetime,
              smoothed: bool = False, dispatcher=None) -> dict:
        """Answer one observation-date request; returns the response
        body (status/served_from/summary fields, JSON-serialisable).
        ``smoothed=True`` answers with the RTS reanalysis from the
        checkpoint chain instead of running the forward filter.
        ``dispatcher`` (coalesced serving) replaces the engine's per-date
        solve dispatch — same signature and bit-identical results as
        ``assimilate_date`` from this session's point of view."""
        t0 = time.perf_counter()
        kf, x0, p_inv0, output = self.spec.make_filter()
        if dispatcher is not None:
            kf.date_dispatcher = dispatcher
        # Tile-scoped trace/quality context: the quality ledger keys its
        # sentinel streams by chunk_id, so each tile keeps its own
        # per-band chi^2 series (the serving analogue of a chunk).
        with tracing.push(chunk_id=f"tile:{self.name}"):
            if smoothed:
                return self._serve_smoothed_in_context(
                    kf, output, date, t0,
                )
            return self._serve_in_context(
                kf, x0, p_inv0, output, date, t0,
            )

    def _serve_in_context(self, kf, x0, p_inv0, output, date, t0) -> dict:
        phases = {}
        try:
            if date not in set(kf.observations.dates):
                raise UnknownDateError(
                    f"tile {self.name} has no observation on {date}"
                )
            with span("serve_resume"):
                grid = self.spec.grid_through(date)
                resumed, seed = self.checkpointer.resume_time_grid(grid)
            phases["resume_ms"] = (time.perf_counter() - t0) * 1e3
            t_solve = time.perf_counter()
            if seed is None:
                served_from = "cold"
                windows_run = len(grid) - 1
                with span("serve_solve"):
                    x, _, p_inv = kf.run(
                        grid, x0, None, p_inv0,
                        checkpointer=self.checkpointer,
                    )
            elif len(resumed) == 1 and resumed[0] == grid[-1]:
                # Empty remainder: the checkpoint IS the answer.
                served_from = "warm_noop"
                windows_run = 0
                x, p_inv = seed
            elif resumed[0] > grid[-1]:
                # The warm chain moved past this date; replay history
                # without touching the chain's checkpoints.
                served_from = "cold_replay"
                windows_run = len(grid) - 1
                with span("serve_solve"):
                    x, _, p_inv = kf.run(
                        grid, x0, None, p_inv0, checkpointer=None,
                    )
            else:
                served_from = "warm"
                windows_run = len(resumed) - 1
                x_r, p_inv_r = seed
                with span("serve_solve"):
                    x, _, p_inv = kf.run(
                        resumed, x_r, None, p_inv_r,
                        checkpointer=self.checkpointer,
                        advance_first=True,
                    )
            phases["solve_ms"] = (time.perf_counter() - t_solve) * 1e3
        finally:
            close = getattr(output, "close", None)
            if close is not None:
                close()
        t_dump = time.perf_counter()
        x_np = _host(x)
        n_valid = kf.gather.n_valid
        x_valid = np.ascontiguousarray(x_np[:n_valid])
        if served_from in ("cold", "warm"):
            self.last_state = (x_np, None if p_inv is None
                               else _host(p_inv))
        self.serves += 1
        wall_ms = (time.perf_counter() - t0) * 1e3
        health = self._solver_health(kf)
        qual = self._quality(kf)
        self._record(served_from, windows_run, wall_ms, health)
        phases["dump_ms"] = (time.perf_counter() - t_dump) * 1e3
        return {
            # Session-local phase durations (resume / solve / dump) —
            # consumed by the service, which folds its own waits in and
            # replaces this with the response's "trace" block.
            "trace_phases": {k: round(v, 3) for k, v in phases.items()},
            "status": "ok",
            "tile": self.name,
            "date": date.isoformat(),
            "served_from": served_from,
            "windows_run": windows_run,
            "n_pixels": int(n_valid),
            "x_mean": [round(float(v), 7)
                       for v in x_valid.mean(axis=0)],
            "x_sha256": hashlib.sha256(x_valid.tobytes()).hexdigest(),
            "wall_ms": round(wall_ms, 3),
            # Result QUALITY, not just latency: the run's solve-health
            # totals so clients —
            # and the request journal, which persists every response —
            # can see a degraded answer for what it is.  A warm_noop /
            # cache-style serve runs zero windows, so the totals are 0.
            "solver_health": health,
            # Filter-consistency verdict for the windows THIS request
            # ran: worst verdict
            # over the run's quality-ledger records, plus whether this
            # tile's drift sentinels are currently alarming.  A
            # zero-window serve (warm_noop) has no verdict.
            "quality": qual,
        }

    def _serve_smoothed_in_context(self, kf, output, date, t0) -> dict:
        """The ``smoothed=true`` request kind: run the RTS backward pass
        over the tile's checkpoint chain and answer with the smoothed
        state at the grid step covering ``date``.  Strictly read work —
        the chain is walked, never written, so any replica sharing the
        checkpoint directory can serve it.  The fresh filter supplies
        the trajectory model / uncertainty / propagator the fallback
        re-derivation needs for pre-sidecar checkpoint sets, and the
        device the sweep runs on."""
        from ..smoother import (
            QA_CLAMPED, SmootherError, smooth_checkpoints, state_sha256,
        )

        phases = {}
        try:
            target = self.spec.grid_through(date)[-1]
            t_smooth = time.perf_counter()
            # The serve_smooth phase joins the request waterfall next to
            # serve_resume/serve_solve (the smoother's own
            # smooth_rederive / smooth_sweep spans nest under it).
            with span("serve_smooth"):
                try:
                    result = smooth_checkpoints(
                        self.checkpointer,
                        m_matrix=_host(kf.trajectory_model),
                        q_diag=_host(kf.trajectory_uncertainty),
                        state_propagator=kf._state_propagator,
                        device=kf.device,
                    )
                except SmootherError as exc:
                    raise UnknownDateError(
                        f"tile {self.name} has no smoothable "
                        f"checkpoint chain: {exc}"
                    ) from exc
                try:
                    t = result.index_of(target)
                except KeyError as exc:
                    raise UnknownDateError(
                        f"tile {self.name}: grid step "
                        f"{target.date().isoformat()} is not in the "
                        "warm checkpoint chain — serve the date "
                        "forward first, then request the reanalysis"
                    ) from exc
            phases["smooth_ms"] = (time.perf_counter() - t_smooth) * 1e3
        finally:
            close = getattr(output, "close", None)
            if close is not None:
                close()
        x_t = np.asarray(result.x_smoothed[t], np.float32)
        qa_t = np.asarray(result.qa[t])
        n_valid = kf.gather.n_valid
        shrink = result.sigma_shrink(t)
        quality.get_ledger().record_smoothed(
            target.date().isoformat(), shrink, n_valid=int(n_valid),
            prefix=f"tile:{self.name}",
        )
        self.serves += 1
        wall_ms = (time.perf_counter() - t0) * 1e3
        self._record("smoothed_chain", 0, wall_ms)
        return {
            "trace_phases": {k: round(v, 3) for k, v in phases.items()},
            "status": "ok",
            "tile": self.name,
            "date": date.isoformat(),
            "smoothed": True,
            # The chain step actually answered (the grid point covering
            # the requested observation date, like the forward path).
            "timestep": target.isoformat(),
            "served_from": "smoothed_chain",
            "windows_run": 0,
            "windows_smoothed": len(result.timesteps),
            "rederived": len(result.rederived),
            "skipped": len(result.skipped),
            "n_pixels": int(n_valid),
            "x_mean": [round(float(v), 7)
                       for v in x_t[:n_valid].mean(axis=0)],
            # Digest over ALL stored rows — the same bytes the offline
            # kafka-smooth driver hashes, so served and offline
            # reanalysis compare bit-for-bit.
            "x_sha256": state_sha256(x_t),
            "wall_ms": round(wall_ms, 3),
            # The backward pass has no innovations: quality scores on
            # sigma-shrink (smoothed/filter posterior width) instead of
            # chi^2, the same verdict quality_report recomputes.
            "quality": {
                "verdict": quality.smoothed_verdict_for(shrink),
                "sigma_shrink": [
                    None if not np.isfinite(v) else round(float(v), 6)
                    for v in shrink
                ],
                "clamped_px": int(np.count_nonzero(qa_t & QA_CLAMPED)),
                "rederived_step": result.timesteps[t] in result.rederived,
            },
        }

    def _quality(self, kf) -> dict:
        """The run's quality summary from the engine's diagnostics log
        (the verdicts were computed by the quality ledger during the
        run — this reads host state only)."""
        verdicts = [r["quality_verdict"] for r in kf.diagnostics_log
                    if "quality_verdict" in r]
        windows: dict = {}
        for v in verdicts:
            windows[v] = windows.get(v, 0) + 1
        drifting = sorted(
            key for key in quality.get_ledger().summary()["drifting"]
            if key.startswith(f"tile:{self.name}:")
        )
        return {
            "verdict": quality.worst_verdict(verdicts),
            "windows": windows,
            "drift_active": bool(drifting),
        }

    @staticmethod
    def _solver_health(kf) -> dict:
        """Sum the run's per-window solve-health counts from the
        engine's diagnostics log (zeros when the run's solve mode
        tracked no health)."""
        recs = [r for r in kf.diagnostics_log if "quarantined" in r]
        return {
            "quarantined": int(sum(r["quarantined"] for r in recs)),
            "cap_bailouts": int(sum(r["cap_bailouts"] for r in recs)),
            "damped_recovered": int(
                sum(r["damped_recovered"] for r in recs)
            ),
            "nonfinite": int(sum(r["nonfinite"] for r in recs)),
        }

    def _record(self, served_from: str, windows_run: int,
                wall_ms: float, health: Optional[dict] = None) -> None:
        reg = get_registry()
        if health and health.get("quarantined"):
            reg.emit(
                "serve_degraded_result", tile=self.name,
                quarantined=health["quarantined"],
                cap_bailouts=health.get("cap_bailouts", 0),
            )
        reg.counter(
            "kafka_serve_solves_total",
            "tile serves by path (cold / warm / warm_noop / "
            "cold_replay / smoothed_chain)",
        ).inc(served_from=served_from)
        reg.counter(
            "kafka_serve_windows_run_total",
            "grid windows actually executed by serves — the warm path's "
            "win is this number staying near the per-request delta "
            "instead of the full series length",
        ).inc(windows_run)
        reg.emit(
            "serve_solved", tile=self.name, served_from=served_from,
            windows_run=windows_run, wall_ms=round(wall_ms, 3),
        )
