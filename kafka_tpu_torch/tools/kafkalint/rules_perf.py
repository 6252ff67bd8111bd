"""Performance-observability rule: no ad-hoc timing in device code.

``ad-hoc-timing`` encodes the perf-attribution convention:
``kafka_tpu_torch/telemetry/perf.py`` derives the live throughput /
device-fraction / phase gauges from the span histograms and the packed
per-window diagnostic read, so a raw ``time.perf_counter()`` /
``time.monotonic()`` pair (or a device flush used as a timing barrier:
``torch.cuda.synchronize()``, the twin of the JAX rule's
``block_until_ready()``, which is still read) in the device-adjacent
modules (``core/``, ``engine/``, ``shard/``, ``obsops/``) is an interval
the attribution plane can never see — and the flush in particular
forces a device sync the engine otherwise avoids (the one packed read
per window IS the sync budget).  Timed intervals there go through
``telemetry.spans.span`` (a histogram + event + timeline span in one)
or, where the raw endpoints are needed (labelled metric observations,
``TraceBuffer.add_span``), ``telemetry.spans.stopwatch`` — both live in
``telemetry/``, which this rule exempts along with ``chip_smoke.py`` and
the operator tools (measurement code is allowed to measure).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from .core import FileContext, Finding, Rule, register
from . import torchscan

#: device-adjacent trees where raw timing is banned.
SCOPES = (
    "kafka_tpu_torch/core/",
    "kafka_tpu_torch/engine/",
    "kafka_tpu_torch/shard/",
    "kafka_tpu_torch/obsops/",
)

#: clock calls that are timing when called raw (time.time() is wall-clock
#: bookkeeping — record timestamps, lease deadlines — and stays legal).
CLOCK_ATTRS = ("perf_counter", "monotonic", "perf_counter_ns",
               "monotonic_ns")


@register
class AdHocTiming(Rule):
    name = "ad-hoc-timing"
    description = (
        "time.perf_counter/time.monotonic/torch.cuda.synchronize timing in "
        "device-adjacent modules (core/, engine/, shard/, obsops/) — "
        "route intervals through telemetry.spans.span or "
        "telemetry.spans.stopwatch so the perf-attribution plane "
        "(kafka_perf_* gauges, trace timeline) sees them"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or \
                not any(ctx.rel.startswith(s) for s in SCOPES):
            return ()
        findings: List[Finding] = []
        for node in torchscan.nodes(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = self._violation(node)
            if msg:
                findings.append(Finding(
                    path=ctx.rel, line=node.lineno, rule=self.name,
                    message=msg,
                ))
        return findings

    @staticmethod
    def _violation(call: ast.Call) -> str:
        f = call.func
        tail = torchscan.tail(f)
        if tail in CLOCK_ATTRS:
            base = torchscan.tail(f.value) if isinstance(f, ast.Attribute) \
                else ""
            if not isinstance(f, ast.Attribute) or "time" in (base or ""):
                return (
                    f"raw {tail}() timing in a device-adjacent module — "
                    "use telemetry.spans.span for phase intervals or "
                    "telemetry.spans.stopwatch where the raw endpoints "
                    "are needed (histogram observations, trace spans)"
                )
        if tail == "block_until_ready" or (
                tail == "synchronize" and "cuda" in (
                    torchscan.dotted(f) or "")):
            return (
                f"{tail}() in a device-adjacent module is an "
                "ad-hoc timing barrier AND an extra device sync — the "
                "engine's sync budget is the one packed diagnostic read "
                "per window; time through telemetry.spans instead"
            )
        return ""
