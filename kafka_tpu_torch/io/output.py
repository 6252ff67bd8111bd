"""Output writers (port of ``kafka_tpu/io/output.py``).

``GeoTIFFOutput``: one GeoTIFF per parameter per timestep named
``{param}_{A%Y%j}[_{prefix}].tif`` plus ``..._unc.tif`` holding
``1/sqrt(diag(P^-1))``, DEFLATE-compressed and tiled, unmasked pixels
zero, and a ``solver_qa_{A%Y%j}`` uint8 band per window.  Writes can run
on a background thread so the device never waits on disk.

A CUDA tensor is not immutable: the engine may write into its memory
again once a dump returns.  So the writer never holds one.  Each dumped
tensor is snapshotted at the dump: a CUDA tensor by a ``non_blocking``
copy into pinned host memory, with a CUDA event recorded after it on the
caller's stream (the writer thread waits on the event before it reads
the bytes); a CPU tensor or numpy array by a copy.  The copy is queued
on the stream before anything the engine does later, so later writes
cannot reach it, and the queue holds host memory only: after ``close()``
the writer holds no device memory.
"""

from __future__ import annotations

import datetime
import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np

import torch

from ..engine.state import PixelGather
from ..telemetry import get_registry, tracing
from .geotiff import GeoInfo, write_geotiff


class HostSnapshot:
    """A host copy of a tensor or array taken at construction.  For a
    CUDA tensor: a ``non_blocking`` copy into pinned memory and an event
    recorded after it on the current stream; ``numpy()`` waits on the
    event.  Anything else is copied to a numpy array at once."""

    __slots__ = ("_host", "_event")

    def __init__(self, arr):
        self._event = None
        if isinstance(arr, torch.Tensor) and arr.is_cuda:
            self._host = torch.empty(arr.shape, dtype=arr.dtype,
                                     pin_memory=True)
            self._host.copy_(arr.detach(), non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(arr.device))
        elif isinstance(arr, torch.Tensor):
            self._host = arr.detach().cpu().clone()
        else:
            self._host = np.array(arr, copy=True)

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        host = self._host
        return host.numpy() if isinstance(host, torch.Tensor) else host


def _host_array(arr):
    """numpy view of a snapshot, tensor or array (None stays None)."""
    if arr is None:
        return None
    if isinstance(arr, HostSnapshot):
        return arr.numpy()
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class GeoTIFFOutput:
    def __init__(
        self,
        parameter_list: Sequence[str],
        geotransform,
        projection: str = "",
        folder: str = ".",
        prefix: Optional[str] = None,
        epsg: Optional[int] = None,
        async_writes: bool = False,
        predictor: int = 3,
        level: Optional[int] = None,
        wire_dtype: str = "float32",
    ):
        self.parameter_list = tuple(parameter_list)
        self.geo = GeoInfo(
            geotransform=tuple(geotransform), projection=projection,
            epsg=epsg,
        )
        self.folder = folder
        self.prefix = prefix
        # Float rasters deflate ~2.4x faster AND ~10% smaller with the
        # floating-point predictor at level 1 than raw bytes at level 6
        # (measured on real analysis outputs) — and output compression is
        # the writer-side bottleneck of a chunked run.  Level 1 is only a
        # win WITH the byte-plane predictor, so the default level follows
        # the predictor choice.
        self.predictor = int(predictor)
        self.level = int(level) if level is not None else (
            1 if self.predictor == 3 else 6
        )
        # Device->host wire format for tensor inputs.  "float32" (the
        # default) is bit-exact.  "float16" is the opt-in fast wire: it
        # halves the bytes crossing the device link — the on-disk rasters
        # stay float32 — at <= 2^-11 relative quantisation, two orders of
        # magnitude below the 5% observation uncertainty every reader
        # attaches to the data.  Under float16 the device-computed sigma
        # is clamped to the float16 max (65504) before the cast, so
        # weakly-observed and unobserved pixels stay finite ("absurdly
        # large sigma", thresholdable) instead of overflowing to +inf.
        # numpy inputs are never touched either way.
        if wire_dtype not in ("float16", "float32"):
            raise ValueError(f"wire_dtype {wire_dtype!r}")
        self.wire_dtype = wire_dtype
        os.makedirs(folder, exist_ok=True)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        reg = get_registry()
        self._trace = reg.trace
        # Captured for the writer thread: contextvars don't cross thread
        # creation, so the constructing (engine/chunk) context is
        # re-installed in _drain to keep the timeline correlated.
        self._trace_ctx = tracing.current_context()
        self._m_backlog = reg.gauge(
            "kafka_io_writer_backlog",
            "queued dump requests the async writer thread has not "
            "finished (0 for synchronous writers)",
        )
        self._m_writes = reg.counter(
            "kafka_io_writes_total",
            "timesteps written to GeoTIFF outputs",
        )
        self._m_write_s = reg.histogram(
            "kafka_io_write_seconds",
            "wall seconds per timestep write (scatter + encode + disk, "
            "all parameters)",
        )
        #: the most dump requests queued at once (async writes only).
        self.peak_backlog = 0
        if async_writes:
            self._queue = queue.Queue(maxsize=4)
            self._worker = threading.Thread(
                target=self._drain, daemon=True
            )
            self._worker.start()

    def _fname(self, param: str, timestep: datetime.datetime,
               unc: bool) -> str:
        date = timestep.strftime("A%Y%j")
        parts = [param, date]
        if self.prefix is not None:
            parts.append(str(self.prefix))
        if unc:
            parts.append("unc")
        return os.path.join(self.folder, "_".join(parts) + ".tif")

    def _qa_fname(self, timestep: datetime.datetime) -> str:
        return self._fname("solver_qa", timestep, False)

    def _write_all(self, timestep, x, unc, gather, parameter_list,
                   unc_is_sigma=False):
        t0 = time.perf_counter()
        try:
            x = _host_array(x)
            for ii, param in enumerate(parameter_list):
                raster = gather.scatter(x[:, ii].astype(np.float32))
                write_geotiff(self._fname(param, timestep, False), raster,
                              self.geo, predictor=self.predictor,
                              level=self.level)
            if unc is None:
                return
            unc = _host_array(unc)
            for ii, param in enumerate(parameter_list):
                if unc_is_sigma:
                    sigma = unc[:, ii].astype(np.float32)
                else:
                    sigma = 1.0 / np.sqrt(np.maximum(
                        unc[:, ii].astype(np.float32), 1e-30
                    ))
                raster = gather.scatter(sigma)
                write_geotiff(self._fname(param, timestep, True), raster,
                              self.geo, predictor=self.predictor,
                              level=self.level)
        finally:
            t1 = time.perf_counter()
            self._m_writes.inc()
            self._m_write_s.observe(t1 - t0)
            self._trace.add_span(
                "write", t0, t1, cat="io",
                timestep=timestep.strftime("%Y-%m-%d"),
            )

    def _to_wire(self, x, p_inv_diag):
        """Device-side downcast (and sigma computation) under the float16
        wire, then the host snapshots (which start the device->host
        copies at once, so the transfer overlaps the rest of the time
        loop).  numpy inputs are only copied."""
        unc, unc_is_sigma = p_inv_diag, False
        if self.wire_dtype == "float16":
            if isinstance(x, torch.Tensor):
                x = x.to(torch.float16)
            if isinstance(p_inv_diag, torch.Tensor):
                sigma = 1.0 / torch.sqrt(p_inv_diag.clamp(min=1e-30))
                # Clamp at float16 max: sigma in (65504, 1e15) — weakly
                # observed pixels — must stay finite, not collapse to the
                # same +inf as truly unobserved ones.
                unc = sigma.clamp(max=65504.0).to(torch.float16)
                unc_is_sigma = True
        return self._snapshot(x), self._snapshot(unc), unc_is_sigma

    def dump_data(self, timestep, x, p_inv_diag, gather: PixelGather,
                  parameter_list) -> None:
        self._raise_pending()
        x, unc, unc_is_sigma = self._to_wire(x, p_inv_diag)
        if self._queue is not None:
            # Host snapshots only (see the module docstring): the writer
            # thread waits on their copies, overlapped with the next
            # date's work, and never touches device memory.
            self._put((timestep, x, unc, gather, tuple(parameter_list),
                       unc_is_sigma))
        else:
            self._write_all(timestep, x, unc, gather, parameter_list,
                            unc_is_sigma)

    def dump_block(self, timesteps, xs, p_inv_diags,
                   gather: PixelGather, parameter_list) -> None:
        """Dump K consecutive timesteps from stacked ``(K, n, p)`` arrays
        (the engine's temporal-fusion path): ONE wire conversion and one
        pair of device->host transfers covers the whole block."""
        self._raise_pending()
        xs, uncs, unc_is_sigma = self._to_wire(xs, p_inv_diags)
        item = (
            tuple(timesteps), xs, uncs, gather, tuple(parameter_list),
            unc_is_sigma,
        )
        if self._queue is not None:
            self._put(("block",) + item)
        else:
            self._write_block(*item)

    def _write_block(self, timesteps, xs, uncs, gather, parameter_list,
                     unc_is_sigma=False):
        xs = _host_array(xs)
        uncs = _host_array(uncs)
        for k, ts in enumerate(timesteps):
            self._write_all(
                ts, xs[k], None if uncs is None else uncs[k],
                gather, parameter_list, unc_is_sigma,
            )

    # -- per-pixel solve-health QA band ---------------------------------

    def dump_qa(self, timestep, verdicts, gather: PixelGather) -> None:
        """Write the window's per-pixel solve-health QA band
        (``core.solver_health`` bitmask: converged / cap-bailout /
        damped-recovered / quarantined / nodata; 0 outside the state
        mask) as ``solver_qa_{A%Y%j}[_{prefix}].tif`` — a uint8 raster
        alongside every parameter/unc pair, so downstream users can MASK
        non-converged values instead of trusting them blind."""
        self._raise_pending()
        verdicts = self._snapshot(verdicts)
        if self._queue is not None:
            self._put(("qa", timestep, verdicts, gather))
        else:
            self._write_qa(timestep, verdicts, gather)

    def dump_qa_block(self, timesteps, verdicts, gather: PixelGather
                      ) -> None:
        """QA bands for K stacked windows (``verdicts`` (K, n_pad) from
        the fused scan): one device->host transfer for the block."""
        self._raise_pending()
        verdicts = self._snapshot(verdicts)
        if self._queue is not None:
            self._put(("qa_block", tuple(timesteps), verdicts, gather))
        else:
            self._write_qa_block(timesteps, verdicts, gather)

    def _write_qa(self, timestep, verdicts, gather):
        raster = gather.scatter(
            _host_array(verdicts).astype(np.uint8)
        )
        # uint8 bitmask: byte predictor (1), not the float predictor
        # the parameter rasters use.
        write_geotiff(self._qa_fname(timestep), raster, self.geo,
                      predictor=1)

    def _write_qa_block(self, timesteps, verdicts, gather):
        verdicts = _host_array(verdicts)
        for k, ts in enumerate(timesteps):
            self._write_qa(ts, verdicts[k], gather)

    @staticmethod
    def _snapshot(arr):
        return None if arr is None else HostSnapshot(arr)

    def _put(self, item) -> None:
        self._queue.put(item)
        n = self._queue.qsize()
        self.peak_backlog = max(self.peak_backlog, n)
        self._set_backlog(n)

    def _set_backlog(self, n: int) -> None:
        self._m_backlog.set(n)
        self._trace.add_counter("writer_backlog", n)

    def _drain(self):
        tracing.set_context(self._trace_ctx)
        tracing.set_lane("writer")
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                if item[0] == "block":
                    self._write_block(*item[1:])
                elif item[0] == "qa":
                    self._write_qa(*item[1:])
                elif item[0] == "qa_block":
                    self._write_qa_block(*item[1:])
                else:
                    self._write_all(*item)
            except Exception as exc:  # surfaced on next dump/flush/close
                self._error = exc
            finally:
                self._set_backlog(self._queue.qsize())
                self._queue.task_done()

    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError(
                "asynchronous GeoTIFF write failed"
            ) from exc

    def flush(self):
        """Block until queued writes are on disk (raises if any failed)."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    def close(self):
        if self._queue is not None:
            self.flush()
            self._queue.put(None)
            self._worker.join()
            self._queue = None
