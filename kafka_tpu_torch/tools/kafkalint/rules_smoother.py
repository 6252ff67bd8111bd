"""Reanalysis read-only contract rule.

``forward-state-mutation-in-smoother`` pins the smoother package's one
architectural invariant: the RTS backward pass is STRICTLY READ WORK
over the forward run's checkpoint chain.  Any replica sharing the chain
may serve ``smoothed=true`` requests precisely because the smoother
never writes — a ``Checkpointer.save`` call (or any ``save``/``savez``
on a checkpoint-ish receiver) from ``kafka_tpu_torch/smoother/`` would let a
reanalysis rewind or fork the warm chain the forward filter resumes
from, and a write to a chain node's analysis/forecast fields would
corrupt the recursion's inputs mid-sweep.

Scope: files under ``kafka_tpu_torch/smoother/`` only — the forward engine
(``engine/checkpoint.py``, ``engine/filter.py``) is the sanctioned
writer and is untouched by this rule.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: the package whose files must never mutate forward state.
SMOOTHER_PREFIX = "kafka_tpu_torch/smoother/"

#: method names that persist state (the Checkpointer write surface and
#: the raw numpy writers it is built on).
_WRITE_METHODS = {"save", "savez", "savez_compressed"}

#: attributes of a chain node / checkpoint set that hold forward state —
#: assigning to any of them from the smoother mutates the recursion's
#: own inputs.
_FORWARD_FIELDS = {
    "x_analysis", "p_analysis_inverse",
    "x_forecast", "p_forecast_inverse", "sidecar",
}


@register
class ForwardStateMutationInSmoother(Rule):
    name = "forward-state-mutation-in-smoother"
    description = (
        "the smoother package writes forward state: a "
        "Checkpointer.save / savez call or an assignment to a chain "
        "node's analysis/forecast fields from kafka_tpu_torch/smoother/ — "
        "the RTS pass is read-only over the checkpoint chain by "
        "contract (that is what makes smoothed=true serveable from "
        "any replica sharing the chain)"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or not ctx.rel.startswith(SMOOTHER_PREFIX):
            return ()
        findings: List[Finding] = []

        def flag(node: ast.AST, what: str) -> None:
            findings.append(Finding(
                path=ctx.rel, line=node.lineno, rule=self.name,
                message=(
                    f"{what} — the smoother is read-only over the "
                    "forward chain; persist derived products through "
                    "the output writers, never the checkpoint store"
                ),
            ))

        for node in torchscan.nodes(ctx.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _WRITE_METHODS:
                flag(node, f"call to .{node.func.attr}() writes a "
                           "checkpoint set from the smoother")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            t.attr in _FORWARD_FIELDS:
                        flag(node, f"assignment to .{t.attr} mutates "
                                   "forward state on a chain node")
                        break
        return findings
