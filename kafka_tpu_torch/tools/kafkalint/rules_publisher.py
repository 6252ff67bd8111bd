"""Telemetry-plane rule: the publisher/httpd threads must never block.

``blocking-call-in-publisher``: the live publisher
(``kafka_tpu_torch/telemetry/live.py``) and the HTTP endpoint handlers
(``kafka_tpu_torch/telemetry/httpd.py``) run on background threads inside
EVERY instrumented process — engine runs, queue workers, the serving
daemon.  An unbounded outbound call there (an HTTP fetch, a raw socket
connect, a subprocess) turns the observability plane into a liveness
hazard: a hung scrape target stalls the heartbeat, the heartbeat going
stale flags the host dead, and the fleet starts reclaiming work from a
perfectly healthy process.  The plane must stay strictly local — read
the registry, write one atomic file, answer one socket that the OS
accepted for us.

The rule flags, anywhere under ``kafka_tpu_torch/telemetry/``:

- any ``requests.*`` call (the library's default timeout is None —
  unbounded by construction);
- ``urllib`` fetches (``urlopen``);
- outbound socket construction (``socket.socket``,
  ``socket.create_connection``, ``socket.getaddrinfo``) — inbound
  serving via ``http.server`` never constructs these directly;
- subprocess spawns (``subprocess.run`` / ``Popen`` / ``call`` /
  ``check_call`` / ``check_output`` / ``getoutput``).

``socket.gethostname()`` stays legal (local, non-blocking — the
snapshot's identity field).  Consumers that legitimately scrape over
HTTP (``kafka_tpu_torch/tools/loadgen.py``, tests) live outside the
telemetry tree and are out of scope.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from . import torchscan
from .core import FileContext, Finding, Rule, register

#: the publisher/httpd tree the no-blocking contract covers.
SCOPE_PREFIX = "kafka_tpu_torch/telemetry/"

#: module -> banned attribute calls on it ("*" = every attribute).
_BANNED_ATTRS = {
    "requests": {"*"},
    "socket": {"socket", "create_connection", "getaddrinfo"},
    "subprocess": {"run", "Popen", "call", "check_call",
                   "check_output", "getoutput"},
    "request": {"urlopen"},   # urllib.request.urlopen
    "urllib": {"urlopen"},
}

#: bare-name calls (``from subprocess import Popen`` style imports).
_BANNED_NAMES = {
    "urlopen", "Popen", "check_output", "check_call",
    "create_connection", "getaddrinfo",
}


@register
class BlockingCallInPublisher(Rule):
    name = "blocking-call-in-publisher"
    description = (
        "unbounded requests/socket/subprocess calls inside the "
        "telemetry publisher/httpd tree (kafka_tpu_torch/telemetry/) — the "
        "heartbeat and endpoint threads run in every process and must "
        "never block on the outside world, or a hung scrape target "
        "reads as a dead host"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or not ctx.rel.startswith(SCOPE_PREFIX):
            return ()
        findings: List[Finding] = []
        for node in torchscan.nodes(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            blocked = self._blocked_call(node)
            if blocked:
                findings.append(Finding(
                    path=ctx.rel, line=node.lineno, rule=self.name,
                    message=(
                        f"{blocked} inside the telemetry "
                        "publisher/httpd tree — the live plane must "
                        "stay local and non-blocking (read the "
                        "registry, write one atomic file); move "
                        "outbound work to the consumer side "
                        "(the operator tools, aggregate callers)"
                    ),
                ))
        return findings

    @staticmethod
    def _blocked_call(call: ast.Call) -> str:
        f = call.func
        if isinstance(f, ast.Attribute):
            base = torchscan.dotted(f.value) or ""
            base_tail = base.rsplit(".", 1)[-1]
            banned = _BANNED_ATTRS.get(base_tail)
            if banned and ("*" in banned or f.attr in banned):
                return f"{base}.{f.attr}(...)"
            return ""
        if isinstance(f, ast.Name) and f.id in _BANNED_NAMES:
            return f"{f.id}(...)"
        return ""
