"""Runtime-convention rules: thread trace propagation, exception hygiene.

``untracked-thread`` encodes the tracing convention: contextvars do
NOT flow into new threads, so every thread owner captures
``tracing.current_context()`` at construction and the thread target
re-installs it with ``tracing.set_context(...)`` — otherwise the thread's
spans detach from the run timeline (see ``engine/prefetch.py`` and
``io/output.py`` for the canonical shape).

``bare-except`` flags ``except:`` / ``except Exception:`` /
``except BaseException:`` handlers that swallow the error: no re-raise,
no logging (stdlib logger methods or registry ``emit``), and no
justification comment.  The accepted justification form is a trailing
comment on the ``except`` line (or a comment line opening the handler
body) that says *why* swallowing is correct — kafkalint/expect directives
and bare ``noqa`` codes do not count.

``ad-hoc-retry`` encodes the resilience-layer convention:
``time.sleep`` outside ``kafka_tpu_torch/resilience/`` is a hand-rolled
backoff/poll — inside a loop it is an ad-hoc retry loop that must go
through ``resilience.RetryPolicy`` (classified failures, counted retries,
injectable sleep); straight-line sleeps are flagged too, so waits either
move behind the policy layer or carry an inline suppression saying why
not (``telemetry/health.py``'s single probe re-read is the production
example).

``naive-marker-write`` encodes the queue-protocol convention:
the ``.done``/``.failed``/``.lease`` markers ARE the multi-host
coordination protocol, and a plain ``open(path, "w")`` on one is a torn
half-written marker waiting to happen (another host can read it
mid-write) — every marker write must go through the atomic
``_write_marker`` helpers (unique tmp + ``os.replace``).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional

from .core import FileContext, Finding, Rule, register
from . import torchscan

_LOG_ATTRS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log", "emit",
}

#: directives are machine syntax, not human justification.
_DIRECTIVE_RE = re.compile(r"^\s*(kafkalint\s*:|expect\s*:)")
_NOQA_RE = re.compile(r"noqa\s*:?\s*[A-Z0-9, ]*")


@register
class UntrackedThread(Rule):
    name = "untracked-thread"
    description = (
        "threading.Thread spawns whose target does not re-install the "
        "TraceContext (tracing.set_context) — contextvars don't cross "
        "thread creation, so the thread's spans/events detach from the "
        "run timeline"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None:
            return ()
        defs = torchscan.collect_defs(ctx.tree)
        findings: List[Finding] = []
        for node in torchscan.nodes(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and torchscan.tail(node.func) == "Thread"):
                continue
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and node.args:
                # threading.Thread(group, target, ...) positional form.
                target = node.args[1] if len(node.args) > 1 else None
            if target is None:
                findings.append(self._finding(
                    ctx, node,
                    "threading.Thread(...) with no resolvable target — "
                    "cannot verify the TraceContext re-install",
                ))
                continue
            resolved = torchscan.resolve_callable(target, defs)
            if not resolved:
                findings.append(self._finding(
                    ctx, node,
                    f"threading.Thread target "
                    f"{ast.unparse(target)!r} is not resolvable in this "
                    "module — cannot verify the TraceContext re-install",
                ))
                continue
            for func in resolved:
                if not self._installs_context(func):
                    name = getattr(func, "name", "<lambda>")
                    findings.append(self._finding(
                        ctx, node,
                        f"threading.Thread target '{name}' never calls "
                        "tracing.set_context(...) — capture "
                        "tracing.current_context() at construction and "
                        "re-install it first thing in the target",
                    ))
        return findings

    @staticmethod
    def _installs_context(func) -> bool:
        body = func.body if isinstance(func.body, list) else [func.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if (isinstance(node, ast.Call)
                        and torchscan.tail(node.func) == "set_context"):
                    return True
        return False

    def _finding(self, ctx: FileContext, node: ast.AST,
                 msg: str) -> Finding:
        return Finding(path=ctx.rel, line=node.lineno, rule=self.name,
                       message=msg + " (the tracing convention; see "
                               "engine/prefetch.py for the shape)")


@register
class BareExcept(Rule):
    name = "bare-except"
    description = (
        "except:/except Exception: handlers with no re-raise, no "
        "logging, and no justification comment — silent swallows hide "
        "real failures; narrow the type, log it, or justify it inline"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None:
            return ()
        findings: List[Finding] = []
        for node in torchscan.nodes(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            caught = self._broad_catch(node.type)
            if caught is None:
                continue
            if any(isinstance(n, ast.Raise)
                   for stmt in node.body for n in ast.walk(stmt)):
                continue
            if self._logs(node):
                continue
            if self._justified(ctx, node):
                continue
            findings.append(Finding(
                path=ctx.rel, line=node.lineno, rule=self.name,
                message=(
                    f"'except {caught}' swallows the error with no "
                    "re-raise, no logging, and no justification comment "
                    "— narrow the exception type, log through the "
                    "registry/logger, or add a trailing '# <why this is "
                    "safe>' comment"
                ),
            ))
        return findings

    @staticmethod
    def _broad_catch(type_node) -> Optional[str]:
        if type_node is None:
            return ""
        names = []
        nodes = (type_node.elts if isinstance(type_node, ast.Tuple)
                 else [type_node])
        for n in nodes:
            names.append(torchscan.tail(n) or "?")
        broad = [n for n in names if n in ("Exception", "BaseException")]
        return broad[0] if broad else None

    @staticmethod
    def _logs(handler: ast.ExceptHandler) -> bool:
        for stmt in handler.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in _LOG_ATTRS:
                    return True
        return False

    @staticmethod
    def _justified(ctx: FileContext, handler: ast.ExceptHandler) -> bool:
        """A human reason on the except line, between it and the first
        body statement, or trailing the first body line."""
        first_body = handler.body[0].lineno if handler.body else \
            handler.lineno
        for lineno in range(handler.lineno, first_body + 1):
            line = ctx.line_text(lineno)
            if "#" not in line:
                continue
            comment = line.split("#", 1)[1]
            if _DIRECTIVE_RE.match(comment):
                continue
            stripped = _NOQA_RE.sub("", comment)
            if re.search(r"[A-Za-z]{2}", stripped):
                return True
        return False


@register
class AdHocRetry(Rule):
    name = "ad-hoc-retry"
    description = (
        "time.sleep outside kafka_tpu_torch/resilience/ — hand-rolled "
        "backoff/poll loops must go through resilience.RetryPolicy "
        "(classified failures, counted retries, injectable sleep); "
        "inline-suppress the rare justified wait"
    )

    #: the one module allowed to sleep: the policy layer itself.
    EXEMPT_PREFIX = "kafka_tpu_torch/resilience/"

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or ctx.rel.startswith(self.EXEMPT_PREFIX):
            return ()
        findings: List[Finding] = []
        self._scan(ctx, ctx.tree, False, findings)
        return findings

    def _scan(self, ctx: FileContext, node: ast.AST, in_loop: bool,
              findings: List[Finding]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Call) and self._is_sleep(child):
                if in_loop:
                    msg = (
                        "time.sleep inside a loop is a hand-rolled "
                        "backoff — retry through "
                        "kafka_tpu_torch.resilience.RetryPolicy instead"
                    )
                else:
                    msg = (
                        "ad-hoc time.sleep wait — route retries/backoff "
                        "through kafka_tpu_torch.resilience.RetryPolicy, or "
                        "justify the wait with an inline suppression"
                    )
                findings.append(Finding(
                    path=ctx.rel, line=child.lineno, rule=self.name,
                    message=msg,
                ))
            self._scan(
                ctx, child,
                in_loop or isinstance(
                    child, (ast.For, ast.While, ast.AsyncFor)
                ),
                findings,
            )

    @staticmethod
    def _is_sleep(call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "sleep":
            # time.sleep / aliased-module sleep; object methods named
            # .sleep on non-module receivers are out of scope.
            base = torchscan.tail(f.value) or ""
            return "time" in base
        return isinstance(f, ast.Name) and f.id == "sleep"


@register
class NaiveMarkerWrite(Rule):
    name = "naive-marker-write"
    description = (
        "open(..., 'w') on a .done/.failed/.lease marker path outside "
        "the sanctioned _write_marker helpers — marker files are the "
        "multi-host protocol and must be written atomically (unique tmp "
        "+ os.replace), or another host reads a torn payload"
    )

    #: marker suffixes that form the queue protocol.
    MARKERS = (".done", ".failed", ".lease")
    #: functions allowed to touch marker paths directly (the atomic
    #: writers themselves).
    SANCTIONED = ("_write_marker",)

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None:
            return ()
        findings: List[Finding] = []
        self._scan(ctx, ctx.tree, (), findings)
        return findings

    def _scan(self, ctx: FileContext, node: ast.AST, stack, findings):
        for child in ast.iter_child_nodes(node):
            child_stack = stack
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_stack = stack + (child.name,)
            if (isinstance(child, ast.Call)
                    and self._is_marker_write(child)
                    and not any(s in self.SANCTIONED for s in stack)):
                findings.append(Finding(
                    path=ctx.rel, line=child.lineno, rule=self.name,
                    message=(
                        "marker file written with a plain open(..., 'w') "
                        "— route .done/.failed/.lease writes through the "
                        "atomic _write_marker helpers "
                        "(shard.scheduler/shard.queue), or a racing host "
                        "reads a torn payload"
                    ),
                ))
            self._scan(ctx, child, child_stack, findings)

    def _is_marker_write(self, call: ast.Call) -> bool:
        if not (isinstance(call.func, ast.Name)
                and call.func.id == "open") or not call.args:
            return False
        mode = None
        if len(call.args) > 1:
            mode = call.args[1]
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if not (isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and ("w" in mode.value or "x" in mode.value
                     or "a" in mode.value)):
            return False
        target = ast.unparse(call.args[0])
        return any(m in target for m in self.MARKERS)
