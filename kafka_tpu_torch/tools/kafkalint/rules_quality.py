"""Assimilation-quality convention rule.

``magic-quality-threshold`` encodes the quality-layer convention: every
consistency / drift threshold literal — the chi^2 CONSISTENT band, the
EWMA/CUSUM sentinel parameters, the obs.bias magnitude — lives in the
sanctioned module-level config block of
``kafka_tpu_torch/telemetry/quality.py``, where every consumer (engine
ledger, quality_report CLI, serve responses, admission shedding) reads
the SAME value.  A numeric quality-threshold
literal anywhere else is a second, silently-divergent definition of
"consistent": the scorecard would then disagree with the ledger that
fed it.

Detection is vocabulary-based: a numeric literal assigned to a name —
or passed as a keyword argument — whose identifier mentions the quality
vocabulary (``chi2``, ``consistent``/``consistency``, ``ewma``,
``cusum``, ``drift``, ``quality``) is a finding outside the sanctuary's
module level.  Booleans and non-literal expressions are out of scope
(thresholds are numbers; flags and derived values are not thresholds).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: the ONE module whose top-level assignments may carry quality
#: threshold literals (the documented config block).
QUALITY_SANCTUARY = "kafka_tpu_torch/telemetry/quality.py"

_VOCAB_RE = re.compile(
    r"(chi2|consistency|consistent|ewma|cusum|drift|quality)", re.I
)


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
class MagicQualityThreshold(Rule):
    name = "magic-quality-threshold"
    description = (
        "numeric consistency/drift threshold literal (chi2 band, "
        "EWMA/CUSUM parameter, quality limit) outside the sanctioned "
        "module-level config block of kafka_tpu_torch/telemetry/quality.py — "
        "a second definition of 'consistent' silently diverges from "
        "the one the ledger, the scorecard and admission all share"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None:
            return ()
        sanctuary = ctx.rel == QUALITY_SANCTUARY
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
                    f"{what} sets a quality-threshold literal outside "
                    f"the sanctioned config block "
                    f"({QUALITY_SANCTUARY}) — import the constant (or "
                    "add it to the block) so every consumer shares one "
                    "definition of consistency"
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
                    if isinstance(t, ast.Name) and \
                            _VOCAB_RE.search(t.id):
                        flag(node, f"assignment to {t.id!r}")
                        break
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg and _VOCAB_RE.search(kw.arg) and \
                            _numeric_literal(kw.value):
                        flag(kw.value, f"keyword argument {kw.arg!r}")
        return findings
