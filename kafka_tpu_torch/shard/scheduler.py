"""Chunk scheduler (port of ``kafka_tpu/shard/scheduler.py``).

``run_chunks`` runs this process's pending chunks of a chunked run in
turn:

- **across processes**: a deterministic round-robin of the chunks over
  the ranks of ``torch.distributed`` (``shard.mesh.process_count`` /
  ``process_index``; one process when none is initialised) — every
  process computes the same assignment, with no coordinator and no
  message passing; ``num_processes`` / ``process_index`` override them
  for external launchers;

- **restartability**: a per-chunk ``.chunk_<prefix>.done`` marker next to
  the outputs, written atomically (unique tmp + ``os.replace``), so a
  crash mid-write never leaves an empty marker that suppresses a rerun;
  ``pending_chunks`` skips completed and quarantined chunks.  The marker
  names and payloads are the JAX package's, so either package's restart
  sees the other's completed chunks as done;
- **fault tolerance**: optional retries under a ``RetryPolicy``
  (transient failures only), a per-chunk deadline, and ``quarantine=True``
  converting an exhausted or poison chunk into a ``.chunk_<prefix>.failed``
  marker so the run continues;
- **telemetry**: completion counters, per-chunk wall-time histograms,
  straggler flags and a ``chunk`` span per chunk in the trace;
- **self-healing** (``run_queue``, ``shard.queue``): lease-based claiming
  instead of the static assignment, so a dead worker's chunks are
  reclaimed by the survivors.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence

from ..io.tiling import Chunk
from ..resilience import (
    FATAL,
    Deadline,
    RetryPolicy,
    classify_failure,
    faults,
)
from ..telemetry import get_registry, stopwatch, tracing
from .mesh import process_count, process_index as _process_index

LOG = logging.getLogger(__name__)

#: a completed chunk is flagged a straggler when its wall time exceeds
#: this multiple of the median of the chunks completed before it (with at
#: least ``_STRAGGLER_MIN_SAMPLES`` priors) — the dask-dashboard signal
#: the reference lost when it dropped dask, now a counter + event.
STRAGGLER_FACTOR = 3.0
_STRAGGLER_MIN_SAMPLES = 3


@dataclass(frozen=True)
class ChunkAssignment:
    chunk: Chunk
    owner: int           # process index that runs it
    prefix: str          # output filename prefix (chunk-id trick,
    #                      kafka_test_Py36.py:164-166)


def assign_chunks(chunks: Sequence[Chunk],
                  num_processes: Optional[int] = None,
                  ) -> List[ChunkAssignment]:
    """Deterministic round-robin over the processes (default: the
    process group's size); identical on every process."""
    n = num_processes if num_processes is not None else process_count()
    return [
        ChunkAssignment(chunk=c, owner=i % n, prefix=f"{c.chunk_no:04x}")
        for i, c in enumerate(chunks)
    ]


def marker_path(outdir: str, prefix: str) -> str:
    return os.path.join(outdir, f".chunk_{prefix}.done")


def failed_marker_path(outdir: str, prefix: str) -> str:
    """Quarantine marker: this chunk exhausted its retries (or was
    poison) and the run continued without it.  Delete the marker to make
    a restart re-attempt the chunk."""
    return os.path.join(outdir, f".chunk_{prefix}.failed")


#: per-process tmp-name counter: together with the pid it makes every
#: writer's tmp unique, so two hosts racing on the SAME marker (lease
#: contention) can never interleave open/os.replace on one tmp file and
#: commit a torn payload.
_TMP_COUNTER = itertools.count()

#: tmp files left by a crash between open and os.replace — both the
#: legacy fixed ``.tmp`` suffix and the unique ``.tmp.<pid>.<n>`` form.
_TMP_RX = re.compile(r"\.tmp(\.\d+\.\d+)?$")


def _tmp_name(path: str) -> str:
    """A tmp name unique to this writer (pid + counter)."""
    return f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}"


def _write_marker(path: str, payload: dict) -> None:
    """Atomic marker write: a crash mid-write must never leave an empty
    marker that suppresses a rerun (unique tmp + ``os.replace``, same
    pattern as ``engine.checkpoint``)."""
    tmp = _tmp_name(path)
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def sweep_stale_tmp(outdir: str, older_than_s: float = 60.0) -> List[str]:
    """Remove orphaned ``*.tmp`` marker/checkpoint files (recursive).

    A crash between ``open`` and ``os.replace`` leaks the tmp forever;
    this sweep runs on scheduler startup (``run_chunks``)
    and clears them.  ``older_than_s`` protects writers that are mid-write
    RIGHT NOW on another host — a live atomic write completes in
    milliseconds, so anything older than a minute is a corpse."""
    removed: List[str] = []
    if not os.path.isdir(outdir):
        return removed
    now = time.time()
    reg = get_registry()
    for dirpath, _dirnames, filenames in os.walk(outdir):
        for fn in filenames:
            if not _TMP_RX.search(fn):
                continue
            path = os.path.join(dirpath, fn)
            try:
                if now - os.path.getmtime(path) < older_than_s:
                    continue
                os.unlink(path)
            except OSError:  # raced another sweeper, or vanished
                continue
            removed.append(path)
            reg.counter(
                "kafka_scheduler_stale_tmp_removed_total",
                "orphaned .tmp marker/checkpoint files removed by the "
                "startup sweep (crash between open and os.replace)",
            ).inc()
            reg.emit(
                "stale_tmp_removed",
                path=os.path.relpath(path, outdir),
            )
    return removed


def mark_done(outdir: str, prefix: str,
              payload: Optional[dict] = None) -> None:
    _write_marker(marker_path(outdir, prefix),
                  {"finished": time.time(), **(payload or {})})


def mark_failed(outdir: str, prefix: str,
                payload: Optional[dict] = None) -> None:
    _write_marker(failed_marker_path(outdir, prefix),
                  {"failed": time.time(), **(payload or {})})


def pending_chunks(assignments: Iterable[ChunkAssignment], outdir: str,
                   process_index: Optional[int] = None,
                   ) -> List[ChunkAssignment]:
    """This process's still-to-run chunks (restart-safe; quarantined
    chunks — ``.failed`` marker — are skipped too, so a restarted run
    doesn't immediately re-wedge on a known-bad chunk)."""
    me = process_index if process_index is not None \
        else _process_index()
    return [
        a for a in assignments
        if a.owner == me
        and not os.path.exists(marker_path(outdir, a.prefix))
        and not os.path.exists(failed_marker_path(outdir, a.prefix))
    ]


def chunk_metrics(reg) -> dict:
    """The chunk-level metric vocabulary, registered at its ONE literal
    site (the metric-name lint requires exactly one registration site per
    name; ``run_chunks`` and ``queue.run_queue`` share these handles)."""
    return {
        "done": reg.counter(
            "kafka_shard_chunks_completed_total",
            "chunks run to completion (.done marker written)",
        ),
        "wall": reg.histogram(
            "kafka_shard_chunk_seconds",
            "wall seconds per completed chunk",
        ),
        "pending": reg.gauge(
            "kafka_shard_chunks_pending",
            "this process's chunks still to run",
        ),
        "stragglers": reg.counter(
            "kafka_shard_stragglers_total",
            "completed chunks slower than STRAGGLER_FACTOR x the median "
            "of prior completions",
        ),
        "failed": reg.counter(
            "kafka_shard_chunks_failed_total",
            "chunks quarantined after exhausting retries (.failed marker "
            "written, run continued)",
        ),
    }


def run_chunks(
    chunks: Sequence[Chunk],
    run_one: Callable[[Chunk, str], None],
    outdir: str,
    num_processes: Optional[int] = None,
    process_index: Optional[int] = None,
    retry_policy: Optional[RetryPolicy] = None,
    quarantine: bool = False,
    chunk_deadline_s: Optional[float] = None,
) -> dict:
    """Execute ``run_one(chunk, prefix)`` for every pending chunk owned by
    this process.  The serial-loop / ``client.map`` duality of the reference
    (``kafka_test_S2.py:203-205`` vs ``kafka_test_Py36.py:254``) collapses
    into this one function: single-process runs own every chunk.

    Fault tolerance is opt-in and layered: ``retry_policy`` re-runs a
    chunk whose failure classifies TRANSIENT (backoff between attempts);
    ``chunk_deadline_s`` turns an over-budget attempt into a
    ``DeadlineExceeded`` (poison — a hung in-process ``run_one`` cannot
    be killed, so it is never retried); ``quarantine=True`` converts any
    non-FATAL failure that survives retries into a
    ``.chunk_<prefix>.failed`` marker + ``failed`` count instead of
    aborting the run.  Defaults preserve the
    historical fail-fast semantics exactly."""
    os.makedirs(outdir, exist_ok=True)
    sweep_stale_tmp(outdir)
    me = process_index if process_index is not None \
        else _process_index()
    assignments = assign_chunks(chunks, num_processes)
    todo = pending_chunks(assignments, outdir, me)
    stats = {"assigned": len([a for a in assignments if a.owner == me]),
             "run": 0, "skipped": 0, "failed": 0, "wall_s": 0.0}
    stats["skipped"] = stats["assigned"] - len(todo)
    reg = get_registry()
    metrics = chunk_metrics(reg)
    m_done, m_wall = metrics["done"], metrics["wall"]
    m_pending, m_failed = metrics["pending"], metrics["failed"]
    m_straggle = metrics["stragglers"]
    m_pending.set(len(todo))
    walls: List[float] = []
    t0 = time.time()
    for a in todo:
        sw_chunk = stopwatch()

        def attempt(a=a):
            deadline = Deadline(chunk_deadline_s) \
                if chunk_deadline_s else None
            faults.fault_point("scheduler.run_one", prefix=a.prefix)
            # chunk_id scopes every span/event recorded inside the chunk
            # run (engine phases, writes, reads) to this chunk's
            # forensics.
            with tracing.push(chunk_id=a.prefix):
                run_one(a.chunk, a.prefix)
            if deadline is not None:
                # In-process there is no way to kill a hung run_one; the
                # deadline is checked on completion and classifies
                # poison, so the chunk quarantines instead of retrying
                # into the same hang.
                deadline.check(f"chunk {a.prefix}")

        try:
            if retry_policy is not None:
                retry_policy.call(attempt, site="scheduler.run_one")
            else:
                attempt()
        except BaseException as exc:
            cls = classify_failure(exc)
            if cls == FATAL or not quarantine:
                raise
            stats["failed"] += 1
            mark_failed(outdir, a.prefix, {
                "chunk": a.chunk.chunk_no,
                "failure_class": cls,
                "error": repr(exc)[:500],
            })
            m_failed.inc()
            m_pending.set(len(todo) - stats["run"] - stats["failed"])
            reg.emit(
                "chunk_quarantined", prefix=a.prefix,
                chunk=a.chunk.chunk_no, failure_class=cls,
                error=repr(exc)[:300],
            )
            LOG.error(
                "chunk %s quarantined (%s): %r — run continues; delete "
                "%s to re-attempt it",
                a.prefix, cls, exc, failed_marker_path(outdir, a.prefix),
            )
            continue
        t_end = sw_chunk.now()
        wall = t_end - sw_chunk.t0
        # The chunk-level block lands on its own "scheduler" track, so
        # the timeline shows chunk boundaries above the engine phases.
        reg.trace.add_span(
            "chunk", sw_chunk.t0, t_end, lane="scheduler", cat="chunk",
            prefix=a.prefix, chunk=a.chunk.chunk_no,
        )
        mark_done(outdir, a.prefix, {"chunk": a.chunk.chunk_no,
                                     "wall_s": round(wall, 3)})
        stats["run"] += 1
        m_done.inc()
        m_wall.observe(wall)
        m_pending.set(len(todo) - stats["run"] - stats["failed"])
        if len(walls) >= _STRAGGLER_MIN_SAMPLES:
            median = statistics.median(walls)
            if wall > STRAGGLER_FACTOR * median:
                m_straggle.inc()
                reg.emit(
                    "straggler", prefix=a.prefix,
                    chunk=a.chunk.chunk_no, wall_s=round(wall, 3),
                    median_s=round(median, 3),
                )
        walls.append(wall)
        reg.emit(
            "chunk_done", prefix=a.prefix, chunk=a.chunk.chunk_no,
            wall_s=round(wall, 3),
        )
    stats["wall_s"] = time.time() - t0
    return stats


def run_queue(chunks: Sequence[Chunk], run_one: Callable[[Chunk, str], None],
              outdir: str, **kwargs) -> dict:
    """Self-healing execution: lease-based claiming over a shared
    filesystem queue instead of static assignment (delegates to
    :func:`kafka_tpu_torch.shard.queue.run_queue`, imported lazily — the
    queue module builds on this one)."""
    from .queue import run_queue as _run_queue

    return _run_queue(chunks, run_one, outdir, **kwargs)
