"""Placement-determinism rule: no salted/random routing decisions.

``nondeterministic-placement`` encodes the elastic-fleet
routing convention: the tile keyspace is partitioned by a STABLE
consistent-hash ring (``kafka_tpu_torch/serve/router.py``'s ``stable_hash``,
a blake2b digest), because placement must agree across processes and
across restarts — the router, a restarted router replaying its
journal, and any operator tool reasoning about ownership all have to
land every tile on the same replica.  Python's builtin ``hash()`` is
salted per process (PYTHONHASHSEED): two routers would disagree about
every tile's owner, and a restart would silently re-shuffle the whole
keyspace, turning every warm tile cold.  ``random.*`` placement is the
same bug with extra steps.

The rule flags, in the placement-bearing trees ``kafka_tpu_torch/serve/``
and ``kafka_tpu_torch/shard/``:

- any call of the BUILTIN ``hash()`` (a shadowing local def counts as
  a violation too — don't name things ``hash`` in these trees);
- any ``random.*`` / ``np.random.*`` call.

``kafka_tpu_torch/serve/router.py`` is the ONE sanctioned home of placement
hashing and is exempt.  Entropy for IDENTITY (``os.urandom`` request
ids) is not placement and stays legal everywhere.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: placement-bearing trees where salted/random decisions are banned.
SCOPES = ("kafka_tpu_torch/serve/", "kafka_tpu_torch/shard/")

#: the sanctioned ring module — the one home of placement hashing.
SANCTIONED = ("kafka_tpu_torch/serve/router.py",)


def _dotted(node) -> str:
    """Best-effort dotted name of a call target (``np.random.choice``
    -> "np.random.choice"); empty for non-name expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@register
class NondeterministicPlacement(Rule):
    name = "nondeterministic-placement"
    description = (
        "builtin hash() (per-process salted) or random.* used in "
        "serve/ or shard/ — routing/partitioning decisions must go "
        "through the stable ring (serve.router.stable_hash) so every "
        "process and every restart agrees on placement"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or \
                not any(ctx.rel.startswith(s) for s in SCOPES) or \
                ctx.rel in SANCTIONED:
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
        dotted = _dotted(call.func)
        if dotted == "hash":
            return (
                "builtin hash() is salted per process "
                "(PYTHONHASHSEED): two routers would disagree about "
                "every tile and a restart re-shuffles the keyspace — "
                "use serve.router.stable_hash for placement"
            )
        parts = dotted.split(".")
        if "random" in parts[:-1] or dotted == "random":
            return (
                f"{dotted}() in a placement-bearing module — random "
                "routing/partitioning breaks cross-process agreement "
                "and replay determinism; place via the stable ring "
                "(serve.router) instead"
            )
        return ""
