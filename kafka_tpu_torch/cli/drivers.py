"""Shared driver harness: a ``RunConfig`` -> chunked assimilation run
(port of ``kafka_tpu/cli/drivers.py``).

Each chunk of the state mask gets the same wiring — sub-mask, reader,
output with the chunk's prefix, prior, ``KalmanFilter``, ``run()`` —
driven by the declarative ``RunConfig``; chunk scheduling and restarts
come from ``shard.run_chunks``.  Output names, chunk prefixes, restart
markers and the OOM split's quarter prefixes are the JAX package's, so
either package can resume, mosaic or check the other's run.

Differences from the JAX module:

- the run's device is an argument (``run_config(..., device=None)``,
  None means CUDA); ``device_mesh="auto"`` and ``"none"`` run each chunk
  on that one device, ``"local"`` raises (ROADMAP slice 5);
- a device OOM (``torch.cuda.OutOfMemoryError``) leaves the process
  usable, so the chunk is split into quarters in-process (the JAX path
  moves to subprocess workers, because a TPU OOM poisons its process);
- ``num_processes > 1`` and ``queue=True`` raise (ROADMAP slice 5); the
  flight recorder, live publisher, SLO engine, compile listeners and
  compilation cache of ``run_config`` come with ROADMAP slice 7.
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

_SLICE_5 = ("is not ported to kafka_tpu_torch yet; it comes with ROADMAP "
            "slice 5 (distribution)")


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


def make_run_mesh(cfg: RunConfig):
    """The chunk-level pixel mesh per ``RunConfig.device_mesh``: always
    None in the port ("auto" and "none" run on the run's one device);
    "local" raises."""
    mode = getattr(cfg, "device_mesh", "auto")
    if mode not in ("auto", "local", "none"):
        raise ValueError(
            f"device_mesh={mode!r}: expected 'auto', 'local' or 'none'"
        )
    if mode == "local":
        raise NotImplementedError(f"device_mesh='local' {_SLICE_5}")
    return None


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
            mesh=make_run_mesh(cfg),
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
    """``run_one_chunk`` with device-OOM recovery.

    A chunk whose working set exceeds device memory is split into four
    quarter chunks (recursively, up to ``max_splits`` levels), each with
    the JAX package's suffixed prefix (``<prefix>-a`` .. ``-d``), in this
    process: a ``torch.cuda.OutOfMemoryError`` leaves the CUDA context
    usable once the failed attempt's tensors are freed.  Stale outputs
    are removed as in the JAX package: the whole chunk's before a split,
    its quarters' after a whole-chunk success.  Non-OOM errors propagate.
    """
    try:
        result = run_one_chunk(
            cfg, chunk, prefix, full_mask, geo, aux_builder,
            operator=operator, device=device,
        )
    except Exception as exc:  # noqa: BLE001 — filtered to OOM below
        if not _is_oom(exc):
            raise
        if max_splits <= 0 or min(chunk.nx_valid, chunk.ny_valid) < 2:
            raise RuntimeError(
                f"chunk {prefix} exceeds device memory even at "
                f"{chunk.nx_valid}x{chunk.ny_valid} px (split limit "
                "reached)"
            ) from exc
        LOG.warning(
            "chunk %s (%dx%d px) exceeds device memory; splitting 2x2",
            prefix, chunk.nx_valid, chunk.ny_valid,
        )
    else:
        # A full-chunk success removes quarter outputs left by an earlier
        # split of the same chunk, or mosaics would double-read them.
        _remove_outputs(cfg, [f"*_{prefix}-[abcd]*.tif"])
        return result
    # Outside the handler: the failed attempt's frames (and the tensors
    # they hold) are released before the quarters run.
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    # The failed attempt may have flushed partial rasters under this
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
    device=None,
) -> dict:
    """Chunked run over the whole state mask on ``device`` (None means
    CUDA; raises without a card): every pending chunk in turn, restart
    markers beside the outputs.  Returns the JAX package's stats:
    ``assigned``, ``run``, ``skipped``, ``failed``, ``wall_s``,
    ``chunks_with_pixels``, ``pixels`` and ``dates_assimilated``.

    ``num_processes > 1`` and ``queue=True`` raise: several processes
    over one chunk set come with ROADMAP slice 5."""
    from ..resilience import RetryPolicy, faults
    from ..telemetry import configure, get_registry, tracing

    if queue:
        raise NotImplementedError(f"the lease-based chunk queue {_SLICE_5}")
    dev = resolve_device(device)
    if cfg.telemetry_dir:
        configure(cfg.telemetry_dir)
    # Chaos-run hook: KAFKA_TPU_FAULTS scripts deterministic failures at
    # the registered fault points.
    faults.install_from_env()
    full_mask, geo = load_state_mask(cfg)
    ny, nx = full_mask.shape
    chunks = list(get_chunks(nx, ny, tuple(cfg.chunk_size)))
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
    # One trace context for the whole run: chunk/window ids are pushed
    # below it.
    with tracing.push(run_id=tracing.new_run_id()):
        stats = run_chunks(
            chunks, run_one, cfg.output_folder,
            num_processes=num_processes,
            process_index=process_index,
            retry_policy=retry_policy,
            quarantine=bool(ft.get("quarantine", False)),
            chunk_deadline_s=(
                float(deadline_s) if deadline_s is not None else None
            ),
        )
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

