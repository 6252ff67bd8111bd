"""Compilation observability: kernel-build cache hits/misses and per-build
compile wall time (port of ``kafka_tpu/telemetry/compilemon.py``).

The port compiles its hand kernels with ``nvcc`` at first use
(``core._build.build``), keyed by a hash of the sources and flags under
the build directory (``utils.compilation_cache``).  A run that silently
recompiles — a new checkout, a cache directory miss — pays seconds per
kernel before its first launch; this module forwards every build into
the telemetry registry, under the JAX package's names:

- ``kafka_compile_cache_hits_total`` — a library found already built;
- ``kafka_compile_cache_misses_total`` — an ``nvcc`` run, whose wall
  seconds ``kafka_compile_program_seconds`` observes, with a ``compile``
  JSONL event and a ``cat: "compile"`` span in the trace timeline.

The listener resolves :func:`~.registry.get_registry` at event time, so
``configure()``/``use()`` swap the sink as usual.  Installation is
idempotent.
"""

from __future__ import annotations

import time

from .registry import get_registry

#: build outcome (cached?) -> registry counter, as the JAX package maps
#: the monitoring events of its compiler.
_CACHE_COUNTERS = {
    True: (
        "kafka_compile_cache_hits_total",
        "persistent compilation-cache hits (program loaded from disk)",
    ),
    False: (
        "kafka_compile_cache_misses_total",
        "persistent compilation-cache misses (full XLA compile paid)",
    ),
}

#: compile-wall buckets (the JAX package's): ~10 ms .. minutes.
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                    30.0, 60.0, 180.0)

_installed = False


def _on_build(name: str, cached: bool, seconds: float) -> None:
    reg = get_registry()
    counter, help = _CACHE_COUNTERS[bool(cached)]
    reg.counter(counter, help).inc()
    if cached:
        return
    _program_seconds(reg).observe(seconds)
    reg.emit("compile", seconds=round(seconds, 3), program=name)
    # The build reports at its end on the building thread: a synthesized
    # [now - seconds, now] span puts the stall on that thread's track.
    t1 = time.perf_counter()
    reg.trace.add_span("nvcc_compile", t1 - seconds, t1, cat="compile",
                       program=name)


def _program_seconds(reg):
    """Single registration site of the compile-wall histogram."""
    return reg.histogram(
        "kafka_compile_program_seconds",
        "wall seconds per XLA backend compile",
        buckets=_COMPILE_BUCKETS,
    )


def declare(reg) -> None:
    """Register this module's metric families (``httpd``'s /metrics)."""
    for name, help in _CACHE_COUNTERS.values():
        reg.counter(name, help)
    _program_seconds(reg)


def install_compile_listeners() -> bool:
    """Register the build listener once per process; returns True."""
    global _installed
    if not _installed:
        from ..core import _build

        _build.BUILD_LISTENERS.append(_on_build)
        _installed = True
    return True
