"""SLO convention rule.

``magic-slo-threshold`` encodes the SLO-layer convention (the
``magic-quality-threshold`` twin): every objective target, burn-rate
threshold, evaluation-window length and error-budget literal lives in
the sanctioned module-level config block of
``kafka_tpu_torch/telemetry/slo.py``, where every consumer (the
evaluator, ``/alertz``, admission's ``slo_burn`` shed, the
``slo_report`` tool) reads the SAME value.  A numeric SLO literal
anywhere else is a second, silently-divergent definition of "burning
too fast": the report would then disagree with the alert that paged.

Detection is vocabulary-based on identifier SEGMENTS (the quality
rule's substring match would false-positive on ``slopes``/``slowest``):
a numeric literal assigned to a name — or passed as a keyword
argument — any of whose underscore-separated segments is ``slo``,
``burn``, ``budget`` or ``objective`` is a finding outside the
sanctuary's module level.  Booleans and non-literal expressions are
out of scope (thresholds are numbers; flags and derived values are
not thresholds).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: the ONE module whose top-level assignments may carry SLO threshold
#: literals (the documented config block).
SLO_SANCTUARY = "kafka_tpu_torch/telemetry/slo.py"

#: identifier segments that mark a name as SLO vocabulary.
_VOCAB = frozenset({"slo", "burn", "budget", "objective"})


def _vocab_name(name: str) -> bool:
    return any(seg in _VOCAB for seg in name.lower().split("_"))


def _numeric_literal(node: ast.AST) -> bool:
    """True for an int/float literal (unary +/- included; bools are
    flags, not thresholds)."""
    if isinstance(node, ast.UnaryOp) and \
            isinstance(node.op, (ast.UAdd, ast.USub)):
        node = node.operand
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool))


@register
class MagicSloThreshold(Rule):
    name = "magic-slo-threshold"
    description = (
        "numeric SLO literal (objective target, burn-rate threshold, "
        "window length, error-budget parameter) outside the sanctioned "
        "module-level config block of kafka_tpu_torch/telemetry/slo.py — a "
        "second definition of 'burning too fast' silently diverges "
        "from the one the evaluator, the report and admission all "
        "share"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None:
            return ()
        sanctuary = ctx.rel == SLO_SANCTUARY
        sanctioned_lines = set()
        if sanctuary:
            # Module-level assignments ARE the config block.
            for stmt in ctx.tree.body:
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    sanctioned_lines.add(stmt.lineno)
        findings: List[Finding] = []

        def flag(node: ast.AST, what: str) -> None:
            findings.append(Finding(
                path=ctx.rel, line=node.lineno, rule=self.name,
                message=(
                    f"{what} sets an SLO literal outside the "
                    f"sanctioned config block ({SLO_SANCTUARY}) — "
                    "import the constant (or add it to the block) so "
                    "every consumer shares one definition of the "
                    "objective"
                ),
            ))

        for node in torchscan.nodes(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                if node.lineno in sanctioned_lines:
                    continue
                value = node.value
                if value is None or not _numeric_literal(value):
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and _vocab_name(t.id):
                        flag(node, f"assignment to {t.id!r}")
                        break
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg and _vocab_name(kw.arg) and \
                            _numeric_literal(kw.value):
                        flag(kw.value, f"keyword argument {kw.arg!r}")
        return findings
