"""Observability of the port (``kafka_tpu/telemetry``'s modules, on
``torch``; names, files and schemas are the JAX package's, so either
package's tools read the other's artifacts):

- :mod:`registry` — the thread-safe metrics store (counters / gauges /
  histograms with labels), JSONL events and Prometheus text;
- :mod:`spans` — timed engine phases in the registry, the trace timeline
  and ``torch.profiler`` (``record_function``); inside ``assimilate`` /
  ``fused_scan`` the sub-date phases ``date_fetch``, ``date_solve``,
  ``date_record``, ``linearize``, ``loop_sync`` and ``row_layout``, summed
  a date (``DateSums``) into the engine's date records;
- :mod:`tracing` — the trace timeline and its run/chunk/window context;
- :mod:`flight_recorder` — ``crash_<ts>.json`` on an unhandled
  exception, SIGTERM/SIGINT or an unhealthy probe, with OOM forensics;
- :mod:`compilemon` — kernel-build cache hits/misses and compile walls;
- :mod:`device` — the one counted funnel for packed device->host reads
  and the per-window CUDA memory watermark gauges;
- :mod:`health` — the host and device (fused Gauss-Newton) probes;
- :mod:`live` — the per-process heartbeat snapshot publisher and the
  process status facts;
- :mod:`httpd` — the live HTTP endpoint (``/metrics``, ``/healthz``,
  ``/statusz``, ``/profilez``, ``/requestz``, ``/alertz``, ``/kernelz``,
  ``/meshz``; port 0 = disabled);
- :mod:`aggregate` — live snapshots merged into one fleet view, and
  per-process traces stitched into one;
- :mod:`quality` — the assimilation-quality ledger and drift sentinels;
- :mod:`request_log` — the per-request wide events;
- :mod:`perf` — per-window throughput, device fraction and roofline
  gauges, and on-demand ``torch.profiler`` capture;
- :mod:`devprof` — kernel-time attribution from profiler captures, the
  CUDA memory ledger with OOM forensics, and mesh introspection;
- :mod:`slo` — declarative objectives, burn-rate alerts and error
  budgets.
"""

from . import devprof, flight_recorder, live, perf, quality, request_log, \
    slo, tracing
from .compilemon import install_compile_listeners
from .device import fetch_scalars, record_memory_watermark
from .registry import MetricsRegistry, configure, get_registry, set_registry, use
from .spans import span, stopwatch

__all__ = [
    "MetricsRegistry",
    "configure",
    "devprof",
    "fetch_scalars",
    "flight_recorder",
    "get_registry",
    "install_compile_listeners",
    "live",
    "perf",
    "quality",
    "record_memory_watermark",
    "request_log",
    "set_registry",
    "slo",
    "span",
    "stopwatch",
    "tracing",
    "use",
]
