"""Host-side telemetry of the port (copies of the JAX-free parts of
``kafka_tpu/telemetry``): the metrics registry, the trace timeline,
timed phase spans, the assimilation-quality ledger (``quality``), the
per-request wide events (``request_log``) and the status half of
``live``.

The device plane waits for a later slice (ROADMAP.md, Queue 1): of the
JAX package's exports, ``devprof``, ``flight_recorder``, ``perf``,
``slo``, ``install_compile_listeners`` (``compilemon``),
``fetch_scalars`` and ``record_memory_watermark`` (``device``) are not
here, nor are ``health``, ``httpd``, ``aggregate`` and ``live``'s
heartbeat publisher."""

from . import live, quality, request_log, tracing
from .registry import MetricsRegistry, configure, get_registry, set_registry, use
from .spans import span, stopwatch

__all__ = ["MetricsRegistry", "configure", "get_registry", "live",
           "quality", "request_log", "set_registry", "span", "stopwatch",
           "tracing", "use"]
