"""Request-identity rule: one sanctioned request-id origin.

``request-id-origin`` encodes the request-tracing
convention: a request id is the PER-REQUEST TRACE KEY — minted once at
admission by ``kafka_tpu_torch/serve/request.py``'s ``new_request_id`` and
then propagated verbatim on the filesystem wire (request payloads,
journal entries, response bodies, spans).  A second minting site
anywhere in ``serve/`` forks the trace: the router's spans and the
replica's spans would carry different ids for the same request, the
journal replay would start a fresh waterfall instead of continuing the
recorded one, and ``stitch_traces(request_id=...)`` would silently
show half a request.

The rule flags, in ``kafka_tpu_torch/serve/`` outside the sanctioned origin
module:

- any call of the id-entropy primitives — ``uuid.*``, ``os.urandom``,
  ``secrets.token_hex`` / ``token_urlsafe`` / ``token_bytes``;
- direct literal construction of a request id: a ``request_id=``
  keyword, a ``"request_id"`` dict key or a ``[...]["request_id"]``
  assignment whose value is a string literal, an f-string or a string
  concatenation — ids must FLOW (``req.request_id``), never be built.

``kafka_tpu_torch/serve/request.py`` is exempt (it IS the origin).  Entropy
elsewhere in the repo (chunk prefixes, run ids) is out of scope: the
rule guards request identity, not randomness.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: the tree where request identity lives.
SCOPES = ("kafka_tpu_torch/serve/",)

#: the one sanctioned origin module.
SANCTIONED = ("kafka_tpu_torch/serve/request.py",)

#: dotted call targets that mint identity entropy.
MINT_CALLS = {
    "os.urandom",
    "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.token_bytes",
}


def _dotted(node) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_literal_construction(node) -> bool:
    """A string literal, f-string, or string concatenation — an id
    BUILT in place rather than flowed from the origin."""
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _is_literal_construction(node.left) or \
            _is_literal_construction(node.right)
    return False


@register
class RequestIdOrigin(Rule):
    name = "request-id-origin"
    description = (
        "request id minted (uuid/os.urandom/token_hex) or built from "
        "literals in serve/ outside serve/request.py — a request id "
        "is the per-request trace key; duplicate origins fork traces. "
        "Use serve.request.new_request_id and let ids flow"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or \
                not any(ctx.rel.startswith(s) for s in SCOPES) or \
                ctx.rel in SANCTIONED:
            return ()
        findings: List[Finding] = []
        for node in torchscan.nodes(ctx.tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted in MINT_CALLS or dotted == "uuid" or \
                        dotted.startswith("uuid."):
                    findings.append(Finding(
                        path=ctx.rel, line=node.lineno, rule=self.name,
                        message=(
                            f"{dotted}() mints id entropy in serve/ — "
                            "request ids have ONE origin "
                            "(serve.request.new_request_id); a second "
                            "minting site forks the per-request trace"
                        ),
                    ))
                for kw in node.keywords:
                    if kw.arg == "request_id" and \
                            _is_literal_construction(kw.value):
                        findings.append(self._built(ctx, kw.value))
            elif isinstance(node, ast.Dict):
                for key, val in zip(node.keys, node.values):
                    if isinstance(key, ast.Constant) and \
                            key.value == "request_id" and \
                            _is_literal_construction(val):
                        findings.append(self._built(ctx, val))
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript) and \
                            isinstance(tgt.slice, ast.Constant) and \
                            tgt.slice.value == "request_id" and \
                            _is_literal_construction(node.value):
                        findings.append(self._built(ctx, node.value))
        return findings

    def _built(self, ctx: FileContext, node) -> Finding:
        return Finding(
            path=ctx.rel, line=node.lineno, rule=self.name,
            message=(
                "request_id built from literals — ids must flow from "
                "the admission-time origin (req.request_id), never be "
                "constructed in place: a rebuilt id detaches the "
                "request from its trace and its journal entry"
            ),
        )
