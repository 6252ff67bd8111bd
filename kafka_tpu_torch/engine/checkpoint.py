"""Checkpoint / resume (port of ``kafka_tpu/engine/checkpoint.py``).

The full analysis state (mean + information matrix) is written per
timestep, and a run resumes from the latest (or any) checkpoint.  Files
are the JAX package's: one ``.npz`` per timestep and shard with the same
members (``x_analysis``, ``p_inv_tril``, ``p`` and the forecast sidecar's
``x_forecast``, ``f_inv_tril``, ``f_p``, ``sidecar``), names and dtypes,
so a checkpoint written by either package loads in the other.  Only the
lower triangle of the symmetric information matrix is stored
(``p(p+1)/2`` floats per pixel), and the pixel axis can be split across
``n_shards`` files.

``save`` takes tensors (on any device) or numpy arrays; a CUDA state is
packed on the device and copied to the host once.  Members are deflated
in parallel pieces (``_ParallelDeflate``) — one deflate stream that any
zip reader inflates — because a tile's information matrix is ~0.5 GB
and a serial deflate of it takes tens of seconds.
"""

from __future__ import annotations

import concurrent.futures
import datetime
import io
import itertools
import logging
import os
import re
import zipfile
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..resilience import faults
from ..telemetry import get_registry

LOG = logging.getLogger(__name__)

_FMT = "%Y%m%dT%H%M%S"
_RX = re.compile(r"state_(\d{8}T\d{6})(?:\.shard(\d+)of(\d+))?\.npz$")

#: what a truncated / empty / corrupted .npz raises out of ``np.load``
#: (zip CRC and header errors, short reads, missing keys).
_UNREADABLE_ERRORS = (
    OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile,
)

#: per-process tmp-name counter: with the pid it makes every writer's tmp
#: unique, so two processes checkpointing into one folder (chunk workers,
#: queue-mode reruns of the same chunk) can never interleave open and
#: ``os.replace`` on a shared fixed-name tmp and commit a torn file.
_TMP_COUNTER = itertools.count()

#: forecast-sidecar schema version.  The sidecar rides INSIDE the same
#: per-shard .npz as the analysis (extra keys, never extra files, so the
#: shard-set completeness rules are unchanged).  Back-compat rule: a set
#: without the keys, or with a DIFFERENT schema number, simply has no
#: sidecar — readers fall back to re-deriving the forecast through the
#: propagator; they never fail the load.
SIDECAR_SCHEMA = 1


def pack_tril(a: np.ndarray) -> np.ndarray:
    """Symmetric ``(..., p, p)`` -> packed lower triangle ``(..., p(p+1)/2)``."""
    p = a.shape[-1]
    i, j = np.tril_indices(p)
    return np.ascontiguousarray(a[..., i, j])


def _host_tril(a) -> np.ndarray:
    """``pack_tril`` of a tensor (packed where it lies, then copied to the
    host once) or of a numpy array."""
    if not isinstance(a, torch.Tensor):
        return pack_tril(np.asarray(a))
    i, j = np.tril_indices(a.shape[-1])
    dev = a.device
    return a[..., torch.as_tensor(i, device=dev),
             torch.as_tensor(j, device=dev)].cpu().numpy()


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


#: bytes per independently deflated piece of a member.
_DEFLATE_PIECE = 4 << 20


class _ParallelDeflate:
    """A stand-in for the zlib compressor of one zip member: ``compress``
    deflates its data in ``_DEFLATE_PIECE`` pieces on a thread pool
    (zlib releases the GIL), each piece a raw deflate stream ended by a
    sync flush, and ``flush`` adds the final empty block — so the
    concatenation is one valid raw deflate stream."""

    def __init__(self, pool, level: int = zlib.Z_DEFAULT_COMPRESSION):
        self._pool = pool
        self._level = level

    def _piece(self, data) -> bytes:
        c = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        return c.compress(data) + c.flush(zlib.Z_SYNC_FLUSH)

    def compress(self, data) -> bytes:
        view = memoryview(data).cast("B")
        pieces = [view[k:k + _DEFLATE_PIECE]
                  for k in range(0, len(view), _DEFLATE_PIECE)]
        return b"".join(self._pool.map(self._piece, pieces))

    def flush(self) -> bytes:
        return zlib.compressobj(self._level, zlib.DEFLATED, -15).flush()


def _savez_compressed(f, **arrays) -> None:
    """``np.savez_compressed(f, **arrays)`` with each member deflated by
    ``_ParallelDeflate``: the same zip members, names and ``.npy``
    contents, read back by ``np.load``."""
    workers = min(8, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool, \
            zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_DEFLATED,
                            allowZip64=True) as zf:
        for name, val in arrays.items():
            npy = io.BytesIO()
            np.lib.format.write_array(npy, np.asanyarray(val),
                                      allow_pickle=False)
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                fid._compressor = _ParallelDeflate(pool)
                fid.write(npy.getbuffer())


def unpack_tril(packed: np.ndarray, p: int) -> np.ndarray:
    """Packed lower triangle -> full symmetric ``(..., p, p)``: one
    gather of each entry's packed position (an order of magnitude
    faster than scattering the two triangles on a tile's state)."""
    i, j = np.tril_indices(p)
    pos = np.empty((p, p), np.intp)
    pos[i, j] = pos[j, i] = np.arange(len(i))
    return np.take(packed, pos.reshape(-1), axis=-1).reshape(
        packed.shape[:-1] + (p, p))


class Checkpointer:
    """Per-timestep state persistence.

    ``n_shards > 1`` splits the pixel axis into that many independent
    files per timestep (``state_<ts>.shard<k>of<n>.npz``); ``load_latest``
    only considers timesteps whose shard set is complete, so a crash
    mid-save resumes from the previous intact checkpoint.
    """

    def __init__(self, folder: str, prefix: str = "", n_shards: int = 1,
                 dtype=np.float32):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.folder = folder
        self.prefix = prefix
        self.n_shards = int(n_shards)
        self.dtype = np.dtype(dtype)
        os.makedirs(folder, exist_ok=True)

    def _path(self, timestep: datetime.datetime, shard: int) -> str:
        stamp = timestep.strftime(_FMT)
        name = (f"state_{stamp}.npz" if self.n_shards == 1
                else f"state_{stamp}.shard{shard}of{self.n_shards}.npz")
        return os.path.join(self.folder, self.prefix + name)

    def save(self, timestep: datetime.datetime, x_analysis,
             p_analysis_inverse, x_forecast=None,
             p_forecast_inverse=None) -> List[str]:
        """Persist one timestep's analysis (and, optionally, the forecast
        sidecar the RTS smoother consumes).

        ``x_forecast``/``p_forecast_inverse`` — when BOTH are given — are
        the window's pre-update forecast state, stored as extra keys in
        the same shard files (``SIDECAR_SCHEMA``).  The engine only
        passes them when the forecast was propagated from the PREVIOUS
        checkpointed analysis (per-window checkpointing), because that
        adjacency is exactly what the smoother gain assumes."""
        x = _host(x_analysis).astype(self.dtype, copy=False)
        n_pix = x.shape[0] if x.ndim > 1 else x.size
        if p_analysis_inverse is None:
            tril = np.zeros((n_pix, 0), self.dtype)
            p = 0
        else:
            p = p_analysis_inverse.shape[-1]
            tril = _host_tril(p_analysis_inverse).astype(self.dtype,
                                                         copy=False)
        sidecar = x_forecast is not None and p_forecast_inverse is not None
        if sidecar:
            xf = _host(x_forecast).astype(self.dtype, copy=False)
            f_p = p_forecast_inverse.shape[-1]
            f_tril = _host_tril(p_forecast_inverse).astype(self.dtype,
                                                           copy=False)
        paths = []
        bounds = np.linspace(0, n_pix, self.n_shards + 1).astype(int)
        for shard in range(self.n_shards):
            lo, hi = bounds[shard], bounds[shard + 1]
            path = self._path(timestep, shard)
            faults.fault_point("checkpoint.save", path=path)
            # Atomic write: a crash mid-save must never leave a
            # truncated .npz under the FINAL name (load_latest would
            # have treated it as the newest complete checkpoint).  The
            # tmp is written through a file handle so np.savez doesn't
            # append its own .npz suffix; its name is unique per writer
            # (pid + counter) so concurrent savers can't tear each
            # other's writes.
            tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}"
            extra = {}
            if sidecar:
                extra = dict(
                    x_forecast=xf[lo:hi],
                    f_inv_tril=f_tril[lo:hi],
                    f_p=np.int64(f_p),
                    sidecar=np.int64(SIDECAR_SCHEMA),
                )
            with open(tmp, "wb") as f:
                _savez_compressed(
                    f,
                    x_analysis=x[lo:hi],
                    p_inv_tril=tril[lo:hi],
                    p=np.int64(p),
                    **extra,
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            paths.append(path)
        return paths

    def _scan_sets(self) -> List[Tuple[datetime.datetime,
                                       Optional[List[str]], List[str]]]:
        """All checkpoint timesteps oldest first, complete or not:
        ``(ts, complete_paths | None, stray_paths)``.

        Shards are grouped by their ``of<total>`` declaration, so leftovers
        from a run with a different ``n_shards`` can never be mixed into a
        set (each file's shard count must agree).  If several totals have a
        complete set for one timestep (e.g. an old 2-shard and a finished
        3-shard save), the most recently written set wins.  ``stray_paths``
        are the files of that timestep's INCOMPLETE totals — evidence of a
        crash mid-save (or a concurrent save in flight) the loader must
        treat as corrupt, never as a resumable state."""
        by_ts: dict = {}
        if not os.path.isdir(self.folder):
            return []
        for name in sorted(os.listdir(self.folder)):
            if not name.startswith(self.prefix):
                continue
            m = _RX.search(name)
            if not m:
                continue
            ts = datetime.datetime.strptime(m.group(1), _FMT)
            shard = int(m.group(2)) if m.group(2) else 0
            total = int(m.group(3)) if m.group(3) else 1
            group = by_ts.setdefault(ts, {}).setdefault(total, {})
            group[shard] = os.path.join(self.folder, name)
        out = []
        for ts in sorted(by_ts):
            complete = []
            strays: List[str] = []
            for total, shards in by_ts[ts].items():
                if set(shards) == set(range(total)):
                    paths = [shards[k] for k in range(total)]
                    complete.append(
                        (max(os.path.getmtime(p) for p in paths), paths)
                    )
                else:
                    strays.extend(shards[k] for k in sorted(shards))
            out.append(
                (ts, max(complete)[1] if complete else None, strays)
            )
        return out

    def list_checkpoints(self) -> List[Tuple[datetime.datetime, List[str]]]:
        """Timesteps with a COMPLETE shard set, oldest first (see
        ``_scan_sets`` for the grouping rules)."""
        return [(ts, paths) for ts, paths, _ in self._scan_sets()
                if paths is not None]

    def load_latest(self, shard: Optional[int] = None,
                    ) -> Optional[Tuple[datetime.datetime, np.ndarray,
                                        Optional[np.ndarray]]]:
        """Returns (timestep, x_analysis, p_analysis_inverse) of the newest
        complete checkpoint, or None.

        ``shard`` restricts loading to that shard's pixel slice — the
        per-piece path for chunk-level restarts at scales where the
        assembled full matrix would not fit host RAM (the shards partition
        the pixel axis in order, ``np.linspace`` bounds as written)."""
        # Newest first; a corrupt set — an unreadable/truncated shard
        # (crash mid-save pre-dating the atomic writer, torn filesystem,
        # bit rot), a MISSING shard (crash between shard writes), or
        # shards whose shapes disagree — is skipped with a logged event
        # and the previous intact set wins: resuming slightly earlier
        # beats dying on a corrupt file.
        for ts, paths, strays in reversed(self._scan_sets()):
            if paths is None:
                self._note_unreadable(
                    ts, strays,
                    "incomplete shard set (missing shard files)",
                )
                continue
            use = [paths[shard]] if shard is not None else paths
            try:
                x, p_inv = self._load_set(use)
            except _UNREADABLE_ERRORS as exc:
                self._note_unreadable(ts, use, repr(exc)[:300])
                continue
            return ts, x, p_inv
        return None

    def _note_unreadable(self, ts, paths: List[str], error: str) -> None:
        LOG.warning(
            "checkpoint %s is unusable (%s); falling back to the "
            "previous intact checkpoint", ts, error,
        )
        get_registry().counter(
            "kafka_checkpoint_unreadable_total",
            "checkpoint sets skipped by load_latest because a file was "
            "truncated/corrupt or a shard was missing",
        ).inc()
        get_registry().emit(
            "checkpoint_unreadable", timestep=str(ts),
            paths=[os.path.basename(q) for q in paths],
            error=error,
        )

    @staticmethod
    def _load_set(paths: List[str], with_sidecar: bool = False):
        xs, trils, p = [], [], 0
        fxs, ftrils, f_p = [], [], 0
        have_sidecar = True
        for path in paths:
            data = np.load(path)
            xs.append(data["x_analysis"])
            if "p_inv_tril" in data:
                trils.append(data["p_inv_tril"])
                p = int(data["p"])
            else:  # the older full-matrix layout
                full = data["p_analysis_inverse"]
                if full.size:
                    p = full.shape[-1]
                    trils.append(pack_tril(full))
            # Forecast sidecar: EVERY shard must carry it under the one
            # schema this reader knows, else the set has no sidecar
            # (pre-sidecar sets and future schemas both degrade to the
            # propagator fallback, never to a load failure).
            if "sidecar" in data and int(data["sidecar"]) == SIDECAR_SCHEMA:
                fxs.append(data["x_forecast"])
                ftrils.append(data["f_inv_tril"])
                f_p = int(data["f_p"])
            else:
                have_sidecar = False
        # Cross-shard consistency: shards written by different runs (or a
        # torn rewrite under a different state layout) must read as
        # corrupt, not silently concatenate into a wrong-shaped state.
        if len({a.shape[-1] for a in xs if a.ndim > 1}) > 1 or \
                len({t.shape[-1] for t in trils}) > 1:
            raise ValueError(
                "checkpoint shards disagree on the state/information "
                f"width: {[a.shape for a in xs]} / "
                f"{[t.shape for t in trils]}"
            )
        x = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        if p == 0:
            p_inv = None
        else:
            tril = (np.concatenate(trils, axis=0) if len(trils) > 1
                    else trils[0])
            p_inv = unpack_tril(tril.astype(np.float32), p)
        if not with_sidecar:
            return x, p_inv
        sidecar = None
        if have_sidecar and fxs and f_p > 0:
            if len({t.shape[-1] for t in ftrils}) > 1:
                raise ValueError(
                    "checkpoint shards disagree on the forecast-sidecar "
                    f"width: {[t.shape for t in ftrils]}"
                )
            xf = np.concatenate(fxs, axis=0) if len(fxs) > 1 else fxs[0]
            ftril = (np.concatenate(ftrils, axis=0) if len(ftrils) > 1
                     else ftrils[0])
            sidecar = (xf, unpack_tril(ftril.astype(np.float32), f_p))
        return x, p_inv, sidecar

    def resume_time_grid(self, time_grid):
        """Trim a time grid to the steps strictly after the last checkpoint.

        The returned grid starts AT the checkpoint time and the seed state
        is an *analysis*: run the resumed filter with ``advance_first=True``
        so the propagation/prior blend into the first resumed window — which
        the original run performed — is not skipped."""
        latest = self.load_latest()
        if latest is None:
            return time_grid, None
        ts, x, p_inv = latest
        remaining = [t for t in time_grid if t > ts]
        return [ts] + remaining, (x, p_inv)
