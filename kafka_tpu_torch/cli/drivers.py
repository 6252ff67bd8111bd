"""Shared driver harness: a ``RunConfig`` -> chunked assimilation run
(port of ``kafka_tpu/cli/drivers.py``).

Each chunk of the state mask gets the same wiring — sub-mask, reader,
output with the chunk's prefix, prior, ``KalmanFilter``, ``run()`` —
driven by the declarative ``RunConfig``; chunk scheduling and restarts
come from ``shard.run_chunks``.  Output names, chunk prefixes, restart
markers and the OOM split's quarter prefixes are the JAX package's, so
either package can resume, mosaic or check the other's run.

As in the JAX module:

- ``RunConfig.device_mesh`` splits each chunk's pixels over a mesh of the
  local devices (``"auto"``: every local CUDA device when there are at
  least two, so one H100 gives none; ``"local"``: all of them; ``"none"``);
- chunks round-robin over the processes of ``torch.distributed``
  (``num_processes`` / ``process_index`` override), or — ``queue=True`` —
  every process is one worker of the lease-based queue in
  ``output_folder``;
- after a device OOM the process is treated as poisoned (a CUDA sticky
  error ruins its context as a TPU OOM does): the chunk and every chunk
  after it run in fresh ``cli.chunk_worker`` subprocesses, a chunk that
  OOMs there too splits into quarters, and a worker past
  ``extra["chunk_worker_timeout"]`` is killed (rc 124, a transient
  failure for the retry policy).

The run's device is an argument (``run_config(..., device=None)``, None
means CUDA).  As in the JAX ``run_config``, a run points the kernel
builds at the compilation cache, counts them (compile listeners),
installs the flight recorder and, for its duration, publishes live
snapshots and runs the SLO engine (the last three write only with a
telemetry directory).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..engine import KalmanFilter
from ..engine.config import RunConfig
from ..io import GeoTIFFOutput, read_geotiff
from ..io.tiling import Chunk, chunk_geotransform, chunk_mask, get_chunks
from ..shard.scheduler import run_chunks

LOG = logging.getLogger(__name__)


def load_state_mask(cfg: RunConfig):
    """(mask bool array, GeoInfo) from the config's state-mask GeoTIFF."""
    if cfg.state_mask is None:
        raise ValueError("RunConfig.state_mask must point to a GeoTIFF")
    arr, info = read_geotiff(cfg.state_mask)
    return np.asarray(arr).astype(bool), info.geo


def _crs_parts(crs):
    """Split a reader's ``define_output`` CRS into (projection, epsg)."""
    if isinstance(crs, int):
        return "", crs
    return (crs or ""), None


def prosail_aux_builder(metadata, gather):
    """Scene angles -> ``ProsailAux`` of 0-d float32 tensors (broadcast
    over the pixels).  They are made on the host; the reader moves them
    to its device with the date's bands."""
    from ..obsops.prosail import ProsailAux

    def t(v):
        return torch.tensor(float(v), dtype=torch.float32)

    return ProsailAux(
        sza=t(metadata["sza"]),
        vza=t(metadata["vza"]),
        raa=t(metadata["vaa"] - metadata["saa"]),
    )


def make_run_mesh(cfg: RunConfig, device=None):
    """The chunk-level pixel mesh per ``RunConfig.device_mesh``: every
    LOCAL device of the run's device type (``shard.mesh.local_devices``),
    or None ("none"; "auto" with fewer than two).  Chunks stay the
    process axis via the scheduler."""
    mode = getattr(cfg, "device_mesh", "auto")
    if mode not in ("auto", "local", "none"):
        raise ValueError(
            f"device_mesh={mode!r}: expected 'auto', 'local' or 'none'"
        )
    if mode == "none":
        return None
    from ..shard.mesh import local_devices, make_pixel_mesh

    devices = local_devices(resolve_device(device).type)
    if mode == "auto" and len(devices) < 2:
        return None
    return make_pixel_mesh(devices)


def run_one_chunk(
    cfg: RunConfig,
    chunk,
    prefix: str,
    full_mask: np.ndarray,
    geo,
    aux_builder: Optional[Callable] = None,
    operator=None,
    device=None,
) -> Optional[dict]:
    """One chunk's full assimilation on ``device``: reader, prior,
    filter, outputs.

    Returns a summary dict, or None when the chunk's mask is empty (the
    reference's mask-nonempty guard).  ``operator`` should be the ONE
    instance shared across chunks, as in the JAX package.
    """
    dev = resolve_device(device)
    sub_mask = chunk_mask(full_mask, chunk)
    if not sub_mask.any():
        return None
    mesh = make_run_mesh(cfg, dev)
    if mesh is not None:
        dev = mesh.devices[0]
    if operator is None:
        operator = cfg.make_operator()
    gt = chunk_geotransform(geo.geotransform, chunk)
    obs = cfg.make_observations(
        operator, state_geo=(gt, geo.epsg), aux_builder=aux_builder,
        device=dev,
    )
    if hasattr(obs, "apply_roi"):
        # Native-grid reader (MODIS family): window to the chunk instead
        # of warping.
        obs.apply_roi(
            chunk.x0, chunk.y0,
            chunk.x0 + chunk.nx_valid, chunk.y0 + chunk.ny_valid,
        )
    crs, out_gt = obs.define_output()
    projection, epsg = _crs_parts(crs)
    output = GeoTIFFOutput(
        cfg.parameter_list, out_gt, projection,
        folder=cfg.output_folder, prefix=prefix, epsg=epsg,
        async_writes=True, wire_dtype=cfg.wire_dtype,
    )
    try:
        kf = KalmanFilter(
            obs, output, sub_mask, cfg.parameter_list,
            state_propagation=cfg.make_propagator(),
            prior=cfg.make_prior(dev),
            pad_multiple=cfg.pad_multiple,
            solver_options=cfg.resolved_solver_options(),
            hessian_correction=cfg.hessian_correction,
            prefetch_depth=cfg.prefetch_depth,
            prefetch_workers=cfg.prefetch_workers,
            scan_window=cfg.scan_window,
            mesh=mesh,
            checkpoint_every_n=cfg.checkpoint_every_n,
            band_sequential=cfg.band_sequential,
            device=dev,
        )
        kf.set_trajectory_model()
        q = cfg.q_diag if cfg.q_diag is not None else np.zeros(cfg.n_params)
        kf.set_trajectory_uncertainty(np.asarray(q, np.float32))
        init_prior = cfg.make_initial_prior(dev)
        if init_prior is None:
            raise ValueError(
                "RunConfig needs `prior` or `initial_prior` for the start "
                "state"
            )
        x0, p_inv0 = init_prior.process_prior(None, kf.gather)
        grid = cfg.time_grid()
        checkpointer = None
        advance_first = False
        if cfg.checkpoint_folder:
            from ..engine.checkpoint import Checkpointer

            checkpointer = Checkpointer(
                cfg.checkpoint_folder, prefix=f"{prefix}_",
                n_shards=int(cfg.extra.get("checkpoint_shards", 1)),
            )
            grid, seed = checkpointer.resume_time_grid(grid)
            if seed is not None:
                x0, p_inv0 = seed
                advance_first = True
                LOG.info(
                    "chunk %s: resuming from checkpoint at %s (%d steps "
                    "left)", prefix, grid[0], len(grid) - 1,
                )
        t0 = time.time()
        kf.run(grid, x0, None, p_inv0, checkpointer=checkpointer,
               advance_first=advance_first)
    except BaseException:
        # Tear the async writer down on failure too: an abandoned worker
        # thread (and the device tensors in its queue) would outlive the
        # failed attempt and eat into a retry's device memory.
        try:
            output.close()
        except Exception as close_exc:
            LOG.warning(
                "output teardown after a failed run also failed "
                "(original error propagates): %s", close_exc,
            )
        raise
    output.close()
    return {
        "prefix": prefix,
        "n_pixels": int(kf.gather.n_valid),
        "n_dates_assimilated": len(kf.diagnostics_log),
        "wall_s": round(time.time() - t0, 3),
    }


def _is_oom(exc: BaseException) -> bool:
    return isinstance(exc, torch.cuda.OutOfMemoryError)


#: set once this process has met a device OOM: from then on every chunk
#: runs in a fresh subprocess (see ``run_one_chunk_resilient``).
_DEVICE_POISONED = False


def split_chunk(chunk) -> list:
    """Quarter a chunk (2x2, odd sizes rounded up in the first half)."""
    hx = (chunk.nx_valid + 1) // 2
    hy = (chunk.ny_valid + 1) // 2
    subs = []
    for y0, ny in ((chunk.y0, hy), (chunk.y0 + hy, chunk.ny_valid - hy)):
        for x0, nx in ((chunk.x0, hx), (chunk.x0 + hx, chunk.nx_valid - hx)):
            if nx > 0 and ny > 0:
                subs.append(Chunk(x0, y0, nx, ny, chunk.chunk_no))
    return subs


@functools.lru_cache(maxsize=4)
def _emulator_banks(folder: str, device: str):
    """Converted per-geometry emulator banks on ``device``, loaded once
    per process (every chunk shares them).  When ``folder`` holds raw
    pickles, the converted banks are written to a ``.kafka_tpu_banks/``
    cache next to them (best-effort), the JAX package's cache, which
    either package then loads instead of re-converting."""
    import glob as _glob

    from ..obsops.gp_import import load_emulator_directory, save_bank_npz

    cache = os.path.join(folder, ".kafka_tpu_banks")
    if _glob.glob(os.path.join(cache, "*.npz")):
        return load_emulator_directory(cache, device=device)
    banks = load_emulator_directory(folder, device=device)
    had_pickles = bool(_glob.glob(os.path.join(folder, "*.pkl")))
    if had_pickles and not _glob.glob(os.path.join(folder, "*.npz")):
        try:
            os.makedirs(cache, exist_ok=True)
            for (sza, vza, raa), bank in banks.items():
                save_bank_npz(
                    os.path.join(
                        cache, f"bank_{vza:g}_{sza:g}_{raa:g}.npz"
                    ),
                    bank,
                )
            LOG.info("cached %d converted emulator bank(s) in %s",
                     len(banks), cache)
        except OSError as exc:
            LOG.warning("could not cache converted banks in %s: %s",
                        cache, exc)
    return banks


@functools.lru_cache(maxsize=4)
def _gp_bank_builder(folder: str, device: str) -> Callable:
    from ..io.sentinel2 import geometry_bank_aux_builder

    return geometry_bank_aux_builder(_emulator_banks(folder, device))


def gp_bank_aux_builder(cfg: RunConfig, device=None) -> Callable:
    """Per-date geometry -> converted emulator bank on ``device``.
    Cached per (folder, device), so repeated resolution returns the SAME
    callable."""
    return _gp_bank_builder(cfg.extra["emulator_folder"],
                            str(resolve_device(device)))


def resolve_aux_builder(cfg: RunConfig, device=None) -> Optional[Callable]:
    """The aux builder a config's operator needs, by name."""
    # The joint S2+S1 configuration feeds the same scene-angle builder to
    # its Sentinel-2 side (run_joint.py).
    if cfg.operator in ("prosail", "prosail_joint"):
        return prosail_aux_builder
    if cfg.operator == "gp_bank":
        return gp_bank_aux_builder(cfg, device)
    return None


def _remove_outputs(cfg, patterns) -> None:
    """Delete output rasters matching ``patterns`` in the run's output
    folder — the split/success paths use this to guarantee that exactly
    one generation of files covers any pixel."""
    if not getattr(cfg, "output_folder", None):
        return
    import glob as _glob

    for pattern in patterns:
        for stale in _glob.glob(os.path.join(cfg.output_folder, pattern)):
            LOG.info("removing stale output %s", stale)
            os.unlink(stale)


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def child_env() -> dict:
    """The environment of a child process of the port: this one's, with
    the checkout that holds the package first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_package_root(), env.get("PYTHONPATH")) if p)
    return env


def _run_chunk_subprocess(cfg: RunConfig, chunk, prefix: str, device=None):
    """Run one chunk in a fresh interpreter (a fresh CUDA context):
    ``python -m kafka_tpu_torch.cli.chunk_worker``.  Returns
    ``(exit_code, summary_or_None)``; 124 when the worker outlived its
    hang guard and was killed."""
    import subprocess
    import sys
    import tempfile

    with tempfile.NamedTemporaryFile(
        "w", suffix=".json", delete=False
    ) as f:
        f.write(cfg.to_json())
        cfg_path = f.name
    # Generous hang guard: a wedged device context must surface as a
    # failed worker, not block the scheduler forever; overridable per
    # run via extra["chunk_worker_timeout"].
    timeout_s = float(
        (getattr(cfg, "extra", None) or {}).get(
            "chunk_worker_timeout", 4 * 3600
        )
    )
    env = child_env()
    # Hand the run id down so the worker's spans correlate with this
    # scheduler's trace (telemetry.tracing).
    from ..telemetry import tracing

    ctx = tracing.current_context()
    if ctx is not None:
        env["KAFKA_TPU_RUN_ID"] = ctx.run_id
    cmd = [sys.executable, "-m", "kafka_tpu_torch.cli.chunk_worker",
           cfg_path, str(chunk.x0), str(chunk.y0),
           str(chunk.nx_valid), str(chunk.ny_valid),
           str(chunk.chunk_no), prefix]
    if device is not None:
        cmd += ["--device", str(device)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        LOG.error(
            "chunk worker %s exceeded %.0f s and was killed",
            prefix, timeout_s,
        )
        return 124, None
    finally:
        os.unlink(cfg_path)
    summary = None
    if proc.returncode == 0:
        parsed = False
        for line in reversed(proc.stdout.strip().splitlines() or [""]):
            try:
                summary = json.loads(line)
                parsed = True
                break
            except json.JSONDecodeError:
                continue
        if not parsed:
            # rc 0 contractually prints one JSON line; a silent None here
            # would undercount run stats while the outputs exist on disk.
            LOG.error(
                "chunk worker %s exited 0 without a summary JSON line "
                "(stdout: %r)", prefix, proc.stdout[-300:],
            )
    else:
        LOG.warning(
            "chunk worker %s rc=%d: %s", prefix, proc.returncode,
            proc.stderr.strip()[-500:],
        )
    return proc.returncode, summary


def run_one_chunk_resilient(
    cfg: RunConfig,
    chunk,
    prefix: str,
    full_mask: np.ndarray,
    geo,
    aux_builder: Optional[Callable] = None,
    operator=None,
    max_splits: int = 2,
    device=None,
) -> Optional[dict]:
    """``run_one_chunk`` with device-OOM recovery, routed as the JAX
    package routes it.

    A device OOM marks this process poisoned (``_DEVICE_POISONED``): a
    CUDA sticky error ruins the context as a TPU OOM does, so recovery
    is process-based.  The failed chunk and every chunk after it run in
    fresh ``cli.chunk_worker`` subprocesses; a chunk that OOMs there too
    (``OOM_EXIT_CODE``) is split into four quarter chunks (recursively,
    up to ``max_splits`` levels), each with the JAX package's suffixed
    prefix (``<prefix>-a`` .. ``-d``).  Stale outputs are removed as in
    the JAX package: the whole chunk's before a split, its quarters'
    after a whole-chunk success.  A worker killed by its hang guard
    raises ``TimeoutError`` (transient: a retry policy re-attempts it);
    any other failure propagates.  The subprocess path needs the aux
    builder reconstructible by name (``resolve_aux_builder``)."""
    global _DEVICE_POISONED
    from .chunk_worker import OOM_EXIT_CODE

    if not _DEVICE_POISONED:
        try:
            result = run_one_chunk(
                cfg, chunk, prefix, full_mask, geo, aux_builder,
                operator=operator, device=device,
            )
            # A full-chunk success removes quarter outputs left by an
            # earlier split of the same chunk, or mosaics would
            # double-read them.
            _remove_outputs(cfg, [f"*_{prefix}-[abcd]*.tif"])
            return result
        except Exception as exc:  # noqa: BLE001 — filtered to OOM below
            if not _is_oom(exc):
                raise
            _DEVICE_POISONED = True
            LOG.warning(
                "chunk %s (%dx%d px) exhausted device memory; running "
                "the remaining work in fresh subprocesses",
                prefix, chunk.nx_valid, chunk.ny_valid,
            )
    if aux_builder is not None and \
            aux_builder is not resolve_aux_builder(cfg, device):
        raise RuntimeError(
            "device OOM recovery needs a subprocess, but the injected "
            "aux_builder cannot be reconstructed there; re-run with "
            "smaller chunk_size"
        )
    rc, summary = _run_chunk_subprocess(cfg, chunk, prefix, device)
    if rc == 0:
        _remove_outputs(cfg, [f"*_{prefix}-[abcd]*.tif"])
        return summary
    if rc == 124:
        raise TimeoutError(
            f"chunk worker for {prefix} exceeded its wall-clock "
            "timeout and was killed"
        )
    if rc != OOM_EXIT_CODE:
        raise RuntimeError(
            f"chunk worker for {prefix} failed (rc={rc})"
        )
    if max_splits <= 0 or min(chunk.nx_valid, chunk.ny_valid) < 2:
        raise RuntimeError(
            f"chunk {prefix} exceeds device memory even at "
            f"{chunk.nx_valid}x{chunk.ny_valid} px (split limit reached)"
        )
    LOG.warning(
        "chunk %s (%dx%d px) exceeds device memory; splitting 2x2",
        prefix, chunk.nx_valid, chunk.ny_valid,
    )
    # The failed attempts may have flushed partial rasters under this
    # prefix; remove them so the quarter outputs are the only files for
    # these pixels.
    _remove_outputs(cfg, [f"*_{prefix}.tif", f"*_{prefix}_unc.tif"])
    merged = {
        "prefix": prefix, "n_pixels": 0, "n_dates_assimilated": 0,
        "wall_s": 0.0, "oom_split": True,
    }
    any_ran = False
    for tag, sub in zip("abcd", split_chunk(chunk)):
        # Dash separator: a bare hex append would collide with larger
        # runs' chunk ids (prefix '1000' + 'a' == chunk '1000a').
        s = run_one_chunk_resilient(
            cfg, sub, f"{prefix}-{tag}", full_mask, geo, aux_builder,
            operator=operator, max_splits=max_splits - 1, device=device,
        )
        if s is not None:
            any_ran = True
            merged["n_pixels"] += s.get("n_pixels", 0)
            merged["n_dates_assimilated"] = max(
                merged["n_dates_assimilated"],
                s.get("n_dates_assimilated", 0),
            )
            merged["wall_s"] += s.get("wall_s", 0.0)
    return merged if any_ran else None


def run_config(
    cfg: RunConfig,
    aux_builder: Optional[Callable] = None,
    num_processes: Optional[int] = None,
    process_index: Optional[int] = None,
    queue: bool = False,
    lease_ttl_s: Optional[float] = None,
    device=None,
) -> dict:
    """Chunked run over the whole state mask on ``device`` (None means
    CUDA; raises without a card), restart markers beside the outputs.
    Returns the JAX package's stats: ``assigned``, ``run``, ``skipped``,
    ``failed``, ``wall_s``, ``chunks_with_pixels``, ``pixels`` and
    ``dates_assimilated`` (the queue's own stats with ``queue=True``).

    This process runs its round-robin share of the chunks over the
    ``torch.distributed`` ranks (``num_processes`` / ``process_index``
    override them).  ``queue=True`` replaces the static assignment with
    the lease-based chunk queue (``shard.run_queue``): this process
    becomes one worker claiming from the shared ``output_folder``, a
    dying worker's chunks are reclaimed by the survivors after
    ``lease_ttl_s``, and ``num_processes`` / ``process_index`` are
    irrelevant."""
    from ..resilience import RetryPolicy, faults
    from ..telemetry import (configure, flight_recorder, get_registry,
                             install_compile_listeners, live, slo, tracing)
    from ..utils.compilation_cache import enable_compilation_cache

    dev = resolve_device(device)
    enable_compilation_cache()
    install_compile_listeners()
    if cfg.telemetry_dir:
        configure(cfg.telemetry_dir)
    # Chaos-run hook: KAFKA_TPU_FAULTS scripts deterministic failures at
    # the fault points.
    faults.install_from_env()
    # Crash forensics: unhandled exceptions, SIGTERM/SIGINT and unhealthy
    # probe verdicts dump crash_<ts>.json into the telemetry directory
    # (no-op without one).
    recorder = flight_recorder.install(cfg.telemetry_dir)
    full_mask, geo = load_state_mask(cfg)
    ny, nx = full_mask.shape
    chunks = list(get_chunks(nx, ny, tuple(cfg.chunk_size)))
    # Keyed by prefix, not appended: queue-mode at-least-once execution
    # (commit retries, reclaims) may run a chunk twice.
    summaries = {}
    # One operator for ALL chunks.
    operator = cfg.make_operator()

    def run_one(chunk, prefix):
        s = run_one_chunk_resilient(
            cfg, chunk, prefix, full_mask, geo, aux_builder,
            operator=operator, device=dev,
        )
        if s is not None:
            summaries[prefix] = s
            LOG.info("chunk %s: %s", prefix, json.dumps(s))

    # Fault-tolerance knobs ride RunConfig.extra["fault_tolerance"]:
    # {"chunk_attempts": 3, "backoff_s": 2.0, "quarantine": true,
    #  "chunk_deadline_s": 3600}.  Defaults keep fail-fast semantics.
    ft = dict((getattr(cfg, "extra", None) or {})
              .get("fault_tolerance") or {})
    attempts = int(ft.get("chunk_attempts", 1))
    retry_policy = RetryPolicy(
        max_attempts=attempts,
        base_delay=float(ft.get("backoff_s", 2.0)),
        multiplier=float(ft.get("backoff_multiplier", 2.0)),
        jitter=float(ft.get("jitter", 0.1)),
    ) if attempts > 1 else None
    deadline_s = ft.get("chunk_deadline_s")
    deadline_s = float(deadline_s) if deadline_s is not None else None
    # One trace context for the whole run: chunk/window ids are pushed
    # below it, and the recorder guard dumps on the way out of a failure.
    with tracing.push(run_id=tracing.new_run_id()), recorder:
        # Live heartbeat (no-op without a telemetry dir; the stop writes
        # the clean-shutdown snapshot) and the SLO evaluator.
        live.start_publisher(role="queue_worker" if queue else "engine")
        slo.start_engine()
        try:
            if queue:
                from ..shard.queue import DEFAULT_LEASE_TTL_S, run_queue

                stats = run_queue(
                    chunks, run_one, cfg.output_folder,
                    lease_ttl_s=(lease_ttl_s if lease_ttl_s
                                 else DEFAULT_LEASE_TTL_S),
                    retry_policy=retry_policy,
                    quarantine=bool(ft.get("quarantine", True)),
                    chunk_deadline_s=deadline_s,
                    max_requeues=ft.get("max_requeues"),
                )
            else:
                stats = run_chunks(
                    chunks, run_one, cfg.output_folder,
                    num_processes=num_processes,
                    process_index=process_index,
                    retry_policy=retry_policy,
                    quarantine=bool(ft.get("quarantine", False)),
                    chunk_deadline_s=deadline_s,
                )
        finally:
            slo.stop_engine()
            live.stop_publisher()
    stats["chunks_with_pixels"] = len(summaries)
    stats["pixels"] = int(
        sum(s["n_pixels"] for s in summaries.values())
    )
    stats["dates_assimilated"] = int(
        sum(s["n_dates_assimilated"] for s in summaries.values())
    )
    reg = get_registry()
    reg.emit("run_done", **stats)
    # Snapshot the run's metrics + trace timeline (no-op without a
    # telemetry_dir).
    reg.dump()
    return stats
