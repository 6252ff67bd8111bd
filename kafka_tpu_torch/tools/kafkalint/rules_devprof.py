"""Device-plane rule: raw device introspection stays in the telemetry
funnel.

``raw-device-introspection``, the torch counterpart of
``tools/kafkalint/rules_devprof.py``: the CUDA memory queries and the
profiler are cheap to call and ruinously easy to scatter.  A stray
``torch.cuda.memory_allocated()`` in engine code duplicates the
watermark gauges under ad-hoc names, a ``reset_peak_memory_stats()``
outside the ledger silently resets the peak the memory ledger reports,
and a second ``torch.profiler.profile`` collides with the ``/profilez``
single-capture contract (one profiler session per process).  Every
consumer reads these through
``kafka_tpu_torch/telemetry/{device,devprof,perf}.py``, which publish
the results as metrics, census entries and parsed kernel tables
everything else (endpoints, fleet view, flight recorder) consumes.

The rule flags, anywhere OUTSIDE that three-file allowlist:

- any ``.memory_stats()`` attribute call;
- ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` /
  ``memory_reserved`` / ``max_memory_reserved`` / ``memory_snapshot``
  / ``mem_get_info`` / ``reset_peak_memory_stats`` (also after ``from
  torch import cuda``);
- any dotted ``torch.profiler.*`` or ``torch.autograd.profiler.*`` call
  (``profile``, ``record_function``, ...), including ``profiler.*``
  after ``from torch import profiler``.

``utils/profiling.py`` predates the funnel and wraps the profiler as
degradable context managers; its sites carry inline ``# kafkalint:
disable=raw-device-introspection`` waivers with reasons rather than an
allowlist hole — new call sites must justify themselves the same way.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: the telemetry funnel allowed to touch the raw device APIs.
ALLOWED_FILES = (
    "kafka_tpu_torch/telemetry/device.py",
    "kafka_tpu_torch/telemetry/devprof.py",
    "kafka_tpu_torch/telemetry/perf.py",
)

#: ``torch.cuda`` memory queries and resets.
CUDA_MEMORY_CALLS = {
    "memory_allocated", "max_memory_allocated", "memory_reserved",
    "max_memory_reserved", "memory_snapshot", "mem_get_info",
    "reset_peak_memory_stats",
}


@register
class RawDeviceIntrospection(Rule):
    name = "raw-device-introspection"
    description = (
        "raw device introspection (torch.cuda.memory_allocated/"
        "memory_stats/mem_get_info/reset_peak_memory_stats, "
        "torch.profiler.*, torch.autograd.profiler.*) outside the "
        "telemetry funnel kafka_tpu_torch/telemetry/{device,devprof,"
        "perf}.py — go through the watermark gauges, the buffer census "
        "and the capture plumbing so every consumer reads one accounting"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or ctx.rel in ALLOWED_FILES:
            return ()
        findings: List[Finding] = []
        for node in torchscan.nodes(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            raw = self._raw_call(node)
            if raw:
                findings.append(Finding(
                    path=ctx.rel, line=node.lineno, rule=self.name,
                    message=(
                        f"{raw} outside the telemetry device funnel — "
                        "read device memory through telemetry.device's "
                        "watermark/headroom gauges and the memory "
                        "ledger, and drive profiler captures through "
                        "telemetry.perf (/profilez, --profile-windows)"
                    ),
                ))
        return findings

    @staticmethod
    def _raw_call(call: ast.Call) -> str:
        f = call.func
        if not isinstance(f, ast.Attribute):
            return ""
        if f.attr == "memory_stats":
            return ".memory_stats(...)"
        base = torchscan.dotted(f.value) or ""
        base_tail = base.rsplit(".", 1)[-1]
        if f.attr in CUDA_MEMORY_CALLS and base_tail == "cuda":
            return f"{base}.{f.attr}(...)"
        if base_tail == "profiler":
            return f"{base}.{f.attr}(...)"
        return ""
