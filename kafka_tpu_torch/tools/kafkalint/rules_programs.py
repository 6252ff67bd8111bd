"""Program-registry rule: every device entry point is contract-analyzed.

``unregistered-device-program``, the torch counterpart of
``tools/kafkalint/rules_programs.py``: the program contracts
(``kafka_tpu_torch/analysis/``, ``python -m
kafka_tpu_torch.cli.programlint``) take an operator census of the
*registered* device programs — an entry point nobody registered is a
device program with no contract, and its regressions (a float64
upcast, a new host read, a surprise relayout) ship silently.  This rule
closes the loop from the source side, as the static twin of that
census: any def in the device packages
(``kafka_tpu_torch/{core,engine,smoother,obsops,shard}/``) that
launches a hand kernel (calls ``core._build.count_launch``) or enters a
kernel region (``with core._build.kernel_region(...)``) must have its
name listed in ``COVERED_ENTRY_POINTS`` of
``kafka_tpu_torch/analysis/programs.py``.

Those two are the port's program roots, as ``jit`` / ``pmap`` /
``pallas_call`` / ``shard_map`` are the JAX package's.  A
``torch.func`` transform body is not one: it runs inside a program,
as a ``vmap`` body does in JAX (``torchscan``).  ``core/_build.py``
defines the launch plumbing and is out of scope.

The covered set is read by AST (``ast.literal_eval`` on the
``COVERED_ENTRY_POINTS`` assignment) from the linted root's own
``kafka_tpu_torch/analysis/programs.py``, so fixture trees carry their
own small registry and the rule imports nothing of the port.
"""

from __future__ import annotations

import ast
import os
from typing import FrozenSet, Iterable, List, Optional

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: packages whose kernel launch sites must be registry-covered.
DEVICE_PACKAGES = (
    "kafka_tpu_torch/core/", "kafka_tpu_torch/engine/",
    "kafka_tpu_torch/smoother/", "kafka_tpu_torch/obsops/",
    "kafka_tpu_torch/shard/",
)

#: the AST-readable registry twin, relative to the linted root.
REGISTRY_RELPATH = os.path.join("kafka_tpu_torch", "analysis",
                                "programs.py")


def covered_entry_points(root: str) -> Optional[FrozenSet[str]]:
    """``COVERED_ENTRY_POINTS`` parsed from the root's registry module,
    or None when the module (or the literal) is absent/unreadable."""
    path = os.path.join(root, REGISTRY_RELPATH)
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        targets = ()
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = (node.target,)
        for t in targets:
            if (isinstance(t, ast.Name)
                    and t.id == "COVERED_ENTRY_POINTS"):
                try:
                    val = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    return None
                return frozenset(str(v) for v in val)
    return None


@register
class UnregisteredDeviceProgram(Rule):
    name = "unregistered-device-program"
    description = (
        "def in the device packages that launches a hand kernel "
        "(count_launch) or enters a kernel_region but is not in "
        "COVERED_ENTRY_POINTS of kafka_tpu_torch/analysis/programs.py "
        "— register a program spec so programlint takes its census, or "
        "waive it inline with a reason"
    )

    def __init__(self) -> None:
        self._covered: Optional[FrozenSet[str]] = None
        self._covered_root: Optional[str] = None

    def _covered_for(self, root: str) -> Optional[FrozenSet[str]]:
        if self._covered_root != root:
            self._covered_root = root
            self._covered = covered_entry_points(root)
        return self._covered

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None:
            return ()
        if not any(ctx.rel.startswith(p) for p in DEVICE_PACKAGES):
            return ()
        covered = self._covered_for(ctx.root)
        if covered is None:
            # No registry in this tree: nothing to check against (the
            # production tree always has one; bare tmp trees don't).
            return ()
        findings: List[Finding] = []
        for fn in torchscan.launch_defs(ctx.tree, ctx.rel):
            if fn.name in covered:
                continue
            findings.append(Finding(
                path=ctx.rel, line=fn.lineno, rule=self.name,
                message=(
                    f"device program '{fn.name}' (launches a hand "
                    "kernel) is not in COVERED_ENTRY_POINTS of "
                    "kafka_tpu_torch/analysis/programs.py — register a "
                    "program spec so programlint takes its census"
                ),
            ))
        return findings
