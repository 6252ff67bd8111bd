"""Device-side diagnostics, host-side accounting (port of
``kafka_tpu/telemetry/device.py``).

The engine's convergence scalars (GN iterations, innovation chi^2 per
band, bounds-clip counts, nodata counts, solve-health counts) are
computed on the device and travel to the host as ONE packed tensor per
window or fused block.  :func:`fetch_scalars` is the one funnel for
those packed reads: every call increments
``kafka_engine_device_reads_total``, which is how the tests prove that
telemetry adds no device->host transfer (the counter equals the solve
dispatches whether or not a telemetry directory is configured).

:func:`record_memory_watermark` publishes the per-device memory gauges
from the CUDA caching allocator — host calls, no device->host copy —
for the devices this process has used (:func:`use_device`), and ticks
the devprof memory ledger.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from .registry import MetricsRegistry, get_registry

_used_lock = threading.Lock()
_used: set = set()


def fetch_scalars(packed) -> np.ndarray:
    """Materialise one packed device tensor of diagnostic scalars.

    The ONLY sanctioned device->host read for engine diagnostics: callers
    concatenate every scalar they need into ``packed`` first, so the
    counter below is an exact census of diagnostic round-trips.
    """
    _reads(get_registry()).inc()
    return packed.cpu().numpy()


def _reads(reg: MetricsRegistry):
    """Single registration site of the read counter."""
    return reg.counter(
        "kafka_engine_device_reads_total",
        "packed diagnostic device->host reads (one per solve dispatch)",
    )


def _memory_gauges(reg: MetricsRegistry) -> dict:
    """Single registration site of the memory gauges."""
    return {
        "in_use": reg.gauge(
            "kafka_device_memory_bytes_in_use",
            "device memory currently allocated (bytes, per device)",
        ),
        "peak": reg.gauge(
            "kafka_device_memory_peak_bytes",
            "high-water mark of device memory allocation (bytes, "
            "per device)",
        ),
        "headroom": reg.gauge(
            "kafka_device_memory_headroom_bytes",
            "device memory still allocatable (bytes_limit - "
            "bytes_in_use, per device) — the distance to an OOM",
        ),
    }


def declare(reg: MetricsRegistry) -> None:
    """Register this module's metric families (``httpd``'s /metrics)."""
    _reads(reg)
    _memory_gauges(reg)


def use_device(device) -> None:
    """Note that this process runs work on ``device`` (a
    ``torch.device`` or string); the CUDA ones are the devices the
    memory gauges read.  Reading only these keeps the watermark from
    creating a CUDA context on a card the run never touched."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        with _used_lock:
            _used.add(dev.index if dev.index is not None
                      else torch.cuda.current_device())


def used_devices() -> List[int]:
    with _used_lock:
        return sorted(_used)


def reset_peak(device=None) -> None:
    """Start a new peak window of the CUDA caching allocator on
    ``device`` (``torch.cuda.reset_peak_memory_stats``): callers that
    measure a phase's peak read it through :func:`peak_bytes`."""
    import torch

    torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device=None) -> int:
    """Peak CUDA allocation on ``device`` since the process started or
    the last :func:`reset_peak` (``torch.cuda.max_memory_allocated``)."""
    import torch

    return torch.cuda.max_memory_allocated(device)


def allocated_bytes(device=None) -> int:
    """CUDA bytes allocated on ``device`` now
    (``torch.cuda.memory_allocated``)."""
    import torch

    return torch.cuda.memory_allocated(device)


def mem_info(device=None):
    """``(free, total)`` bytes of the card (``torch.cuda.mem_get_info``)."""
    import torch

    return torch.cuda.mem_get_info(device)


def record_memory_watermark(
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Per-device memory gauges from the caching allocator
    (``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``, host
    calls: no device->host transfer, so the zero-extra-transfer
    invariant above holds).  For each used device:

    - ``kafka_device_memory_bytes_in_use``: ``allocated_bytes.all.current``;
    - ``kafka_device_memory_peak_bytes``: ``allocated_bytes.all.peak``;
    - ``kafka_device_memory_headroom_bytes``: free + reserved - allocated,
      the bytes still allocatable — what the card has free plus what the
      allocator holds cached but unused;

    each also a trace counter track.  A no-op on the CPU.  The watermark
    doubles as the per-window memory-ledger tick (``devprof``'s
    allocator census, throttled there)."""
    from . import devprof

    reg = registry if registry is not None else get_registry()
    for m in devprof.memory_stats():
        g = _memory_gauges(reg)
        d = m["device"]
        in_use, peak = m["bytes_in_use"], m["peak_bytes_in_use"]
        g["in_use"].set(float(in_use), device=d)
        reg.trace.add_counter(f"device{d}_bytes_in_use", in_use)
        g["peak"].set(float(peak), device=d)
        reg.trace.add_counter(f"device{d}_peak_bytes", peak)
        g["headroom"].set(
            float(m["bytes_free"] + m["bytes_reserved"] - in_use), device=d)
    devprof.update_ledger(reg)
