"""Host-side telemetry of the port: the metrics registry, the trace
timeline and timed phase spans (copies of the JAX-free parts of
``kafka_tpu/telemetry``).  Exporters, the HTTP endpoint, the SLO
engine, the flight recorder and profiler capture are not ported."""

from . import tracing
from .registry import MetricsRegistry, configure, get_registry
from .spans import span, stopwatch

__all__ = ["MetricsRegistry", "configure", "get_registry", "span",
           "stopwatch", "tracing"]
