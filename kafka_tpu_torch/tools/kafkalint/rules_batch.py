"""Coalesced-serving rule: one sanctioned solve-dispatch site.

``unbatched-serve-dispatch`` encodes the coalesced-serving
convention: every solve the serving layer launches goes through the
batch executor module, ``kafka_tpu_torch/serve/batch.py``.  That module is
where the admission micro-window's compatibility contract lives — the
rendezvous that coalesces shape-compatible requests into one device
launch, the solo fallback that keeps the exact unbatched program, and
the batch telemetry (launch counters, ``serve_batch`` spans).

A direct ``session.serve(...)`` call or a raw
``assimilate_date_jit`` dispatch anywhere else in ``serve/`` silently
bypasses all of it: the request never meets its batch peers (the
window waits out its deadline for a member that will not post), the
coalescing metrics under-count, and the AOT bucket manifest no longer
describes what actually runs.  The bypass WORKS — the answer is
bit-identical — which is exactly why it needs a lint: nothing else
would catch it.

The rule flags, in ``kafka_tpu_torch/serve/`` outside the sanctioned
executor module:

- any ``.serve(...)`` attribute call (route through
  ``serve.batch.solve_session``);
- any reference to the raw engine entry points
  ``assimilate_date_jit`` / ``assimilate_date_batch_jit`` — import or
  call; a dispatch that does not exist cannot drift.

``kafka_tpu_torch/serve/batch.py`` is exempt (it IS the executor).
``TileSession.serve`` definitions are out of scope — the rule guards
call sites, not the method itself.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: the tree where serve dispatch lives.
SCOPES = ("kafka_tpu_torch/serve/",)

#: the one sanctioned batch-executor module.
SANCTIONED = ("kafka_tpu_torch/serve/batch.py",)

#: raw engine entry points that must not appear outside the executor.
RAW_DISPATCH = {"assimilate_date_jit", "assimilate_date_batch_jit"}


@register
class UnbatchedServeDispatch(Rule):
    name = "unbatched-serve-dispatch"
    description = (
        "direct session.serve(...) call or raw assimilate_date_jit "
        "dispatch in serve/ outside serve/batch.py — solves launched "
        "around the batch executor never coalesce, starve the "
        "admission micro-window and under-count batch telemetry. "
        "Route through serve.batch.solve_session"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or \
                not any(ctx.rel.startswith(s) for s in SCOPES) or \
                ctx.rel in SANCTIONED:
            return ()
        findings: List[Finding] = []
        for node in torchscan.nodes(ctx.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "serve":
                findings.append(Finding(
                    path=ctx.rel, line=node.lineno, rule=self.name,
                    message=(
                        "direct .serve(...) call in serve/ — solve "
                        "dispatch has ONE site (serve.batch."
                        "solve_session); a bypass never meets its "
                        "batch peers and leaves the micro-window "
                        "waiting for a member that will not post"
                    ),
                ))
            elif isinstance(node, (ast.Name, ast.Attribute)):
                name = node.id if isinstance(node, ast.Name) \
                    else node.attr
                if name in RAW_DISPATCH:
                    findings.append(self._raw(ctx, node.lineno, name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    base = alias.name.rsplit(".", 1)[-1]
                    if base in RAW_DISPATCH or \
                            (alias.asname or "") in RAW_DISPATCH:
                        findings.append(
                            self._raw(ctx, node.lineno, base)
                        )
        return findings

    def _raw(self, ctx: FileContext, lineno: int, name: str) -> Finding:
        return Finding(
            path=ctx.rel, line=lineno, rule=self.name,
            message=(
                f"raw engine entry point {name} referenced in "
                "serve/ — the batch executor (serve/batch.py) owns "
                "engine dispatch; anywhere else it bypasses "
                "coalescing, batch telemetry and the AOT bucket "
                "manifest"
            ),
        )
