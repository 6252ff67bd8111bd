"""Telemetry-vocabulary rules + the check_metric_names API (the port of
``tools/kafkalint/rules_telemetry.py``, the same three rules).

Three lints — metric registration conventions; emit()/span() casing;
near-duplicate and cross-namespace name collisions — run in the
kafkalint walker as three rules sharing its suppression syntax and
output.  The module-level API (``check``, ``collect_registrations``,
``collect_names``, the regexes, ``main``) backs the
``kafka_tpu_torch/tools/check_metric_names.py`` shim.

These rules scan ``kafka_tpu_torch/`` but its ``tools/``, and
``chip_smoke.py`` — the telemetry vocabulary lives in the engine tree;
the operator tools never register metrics (and this module's own regex
sources must not lint themselves), as ``tools/`` is left out of the JAX
package's scan.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from .core import FileContext, Finding, Rule, register

#: registration call with a literal first argument.
REGISTRATION_RE = re.compile(
    r"\.\s*(counter|gauge|histogram)\(\s*\n?\s*\"([^\"]+)\"", re.MULTILINE
)
NAME_RE = re.compile(r"^kafka_[a-z0-9]+_[a-z0-9_]+$")

#: emit("...") event and span("...") phase call sites with a literal
#: first argument (the lookbehind keeps trace_span()/add_span() out of
#: the span scan — those carry arbitrary span names, not engine phases).
EMIT_RE = re.compile(r"\.\s*emit\(\s*\n?\s*\"([^\"]+)\"", re.MULTILINE)
SPAN_RE = re.compile(r"(?<!\w)span\(\s*\n?\s*\"([^\"]+)\"", re.MULTILINE)
EVENT_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

#: sources the telemetry vocabulary may live in, relative to the root.
SCAN = ("kafka_tpu_torch", "chip_smoke.py")

#: the operator tools (and this linter) inside the scanned package.
TOOLS_PREFIX = "kafka_tpu_torch/tools/"

Site = Tuple[str, int]


def _eligible(rel: str) -> bool:
    return rel == "chip_smoke.py" or (
        rel.startswith("kafka_tpu_torch/")
        and not rel.startswith(TOOLS_PREFIX))


# ---------------------------------------------------------------------------
# Pure error builders shared by the rules and the legacy check().
# ---------------------------------------------------------------------------

def registration_errors(
    regs: Dict[str, List[Tuple[str, int, str]]],
) -> List[Tuple[str, Site]]:
    """(message, anchor site) per metric-registration violation."""
    errors: List[Tuple[str, Site]] = []
    for name, sites in sorted(regs.items()):
        anchor = min((p, ln) for p, ln, _ in sites)
        where = ", ".join(f"{p}:{ln}" for p, ln, _ in sites)
        if not NAME_RE.match(name):
            errors.append((
                f"{name!r} ({where}) does not match "
                "kafka_<subsystem>_<name>",
                anchor,
            ))
        if len(sites) > 1:
            errors.append((
                f"{name!r} registered at {len(sites)} sites ({where}); "
                "each metric must have exactly one owner",
                anchor,
            ))
        kinds = {k for _, _, k in sites}
        if len(kinds) > 1:
            errors.append((
                f"{name!r} registered as multiple kinds "
                f"({sorted(kinds)}; {where})",
                anchor,
            ))
    return errors


def casing_errors(
    events: Dict[str, List[Site]], phases: Dict[str, List[Site]],
) -> List[Tuple[str, Site]]:
    """Off-convention emit()/span() literals."""
    errors: List[Tuple[str, Site]] = []
    for namespace, names in (("event", events), ("phase", phases)):
        for name, sites in names.items():
            if not EVENT_NAME_RE.match(name):
                where = ", ".join(f"{p}:{ln}" for p, ln in sites)
                errors.append((
                    f"{namespace} name {name!r} ({where}) is not "
                    "lower_snake_case",
                    min(sites),
                ))
    return errors


def collision_errors(
    events: Dict[str, List[Site]], phases: Dict[str, List[Site]],
) -> List[Tuple[str, Site]]:
    """Near-duplicate literals and event/phase namespace collisions."""
    by_norm: Dict[str, Dict[Tuple[str, str], List[Site]]] = {}
    for namespace, names in (("event", events), ("phase", phases)):
        for name, sites in names.items():
            norm = name.replace("_", "").lower()
            by_norm.setdefault(norm, {})[(namespace, name)] = sites
    errors: List[Tuple[str, Site]] = []
    for norm, variants in sorted(by_norm.items()):
        literals = {name for _, name in variants}
        namespaces = {ns for ns, _ in variants}
        anchor = min(s for sites in variants.values() for s in sites)
        where = "; ".join(
            f"{ns} {name!r} at " + ", ".join(f"{p}:{ln}" for p, ln in sites)
            for (ns, name), sites in sorted(variants.items())
        )
        if len(literals) > 1:
            errors.append((
                f"near-duplicate names {sorted(literals)} ({where}) — "
                "case/underscore variants of one name",
                anchor,
            ))
        elif len(namespaces) > 1:
            errors.append((
                f"{next(iter(literals))!r} used as both an event and a "
                f"span phase ({where}) — one name, one meaning",
                anchor,
            ))
    return errors


# ---------------------------------------------------------------------------
# kafkalint rules: per-file collection, cross-file finalize.
# ---------------------------------------------------------------------------

class _VocabRule(Rule):
    """Shared collection: registrations, events, phases over the
    eligible subset of the walk."""

    def __init__(self) -> None:
        self.regs: Dict[str, List[Tuple[str, int, str]]] = {}
        self.events: Dict[str, List[Site]] = {}
        self.phases: Dict[str, List[Site]] = {}
        self.saw_eligible = False

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if not _eligible(ctx.rel):
            return ()
        self.saw_eligible = True
        text = ctx.text
        for m in REGISTRATION_RE.finditer(text):
            kind, name = m.group(1), m.group(2)
            line = text.count("\n", 0, m.start()) + 1
            self.regs.setdefault(name, []).append((ctx.rel, line, kind))
        for regex, out in ((EMIT_RE, self.events), (SPAN_RE, self.phases)):
            for m in regex.finditer(text):
                line = text.count("\n", 0, m.start()) + 1
                out.setdefault(m.group(1), []).append((ctx.rel, line))
        return ()

    def _findings(self, errors: List[Tuple[str, Site]]
                  ) -> Iterable[Finding]:
        for msg, (path, line) in errors:
            yield Finding(path=path, line=line, rule=self.name,
                          message=msg)


@register
class MetricName(_VocabRule):
    name = "metric-name"
    description = (
        "metric registrations must match kafka_<subsystem>_<name>, have "
        "exactly one owning site, and exactly one kind (the "
        "observability contract of the JAX package's BASELINE.md)"
    )

    def finalize(self) -> Iterable[Finding]:
        if self.saw_eligible and not self.regs:
            yield Finding(
                path="kafka_tpu_torch", line=0, rule=self.name,
                message=(
                    "no metric registrations found — the scanner or the "
                    "telemetry wiring is broken"
                ),
            )
            return
        yield from self._findings(registration_errors(self.regs))


@register
class EventName(_VocabRule):
    name = "event-name"
    description = (
        "emit() event and span() phase literals must be "
        "lower_snake_case — off-convention casing silently forks "
        "grep/dashboard queries"
    )

    def finalize(self) -> Iterable[Finding]:
        yield from self._findings(casing_errors(self.events, self.phases))


@register
class EventCollision(_VocabRule):
    name = "event-collision"
    description = (
        "near-duplicate event/phase literals (case or underscore "
        "variants) and one name used as both an event and a span phase "
        "— one name, one meaning"
    )

    def finalize(self) -> Iterable[Finding]:
        yield from self._findings(
            collision_errors(self.events, self.phases)
        )


# ---------------------------------------------------------------------------
# check_metric_names API (the shim re-exports all of this).
# ---------------------------------------------------------------------------

def iter_sources(root: str):
    for entry in SCAN:
        path = os.path.join(root, entry)
        if os.path.isfile(path):
            yield path
        else:
            for dirpath, _dirnames, filenames in os.walk(path):
                for fn in sorted(filenames):
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, root).replace(os.sep, "/")
                    if fn.endswith(".py") and _eligible(rel):
                        yield full


def collect_registrations(
    root: str,
) -> Dict[str, List[Tuple[str, int, str]]]:
    """name -> [(relative_path, line, kind), ...] over the scanned tree."""
    out: Dict[str, List[Tuple[str, int, str]]] = {}
    for path in iter_sources(root):
        with open(path) as f:
            text = f.read()
        for m in REGISTRATION_RE.finditer(text):
            kind, name = m.group(1), m.group(2)
            line = text.count("\n", 0, m.start()) + 1
            rel = os.path.relpath(path, root)
            out.setdefault(name, []).append((rel, line, kind))
    return out


def collect_names(root: str, regex: re.Pattern,
                  ) -> Dict[str, List[Site]]:
    """literal first-arg -> [(relative_path, line), ...] for ``regex``."""
    out: Dict[str, List[Site]] = {}
    for path in iter_sources(root):
        with open(path) as f:
            text = f.read()
        for m in regex.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            rel = os.path.relpath(path, root)
            out.setdefault(m.group(1), []).append((rel, line))
    return out


def check_event_and_phase_names(root: str) -> List[str]:
    """emit()/span() vocabulary violations (empty list = clean)."""
    events = collect_names(root, EMIT_RE)
    phases = collect_names(root, SPAN_RE)
    return [m for m, _ in casing_errors(events, phases)] + [
        m for m, _ in collision_errors(events, phases)
    ]


def check(root: str) -> List[str]:
    """All convention violations in ``root`` (empty list = clean)."""
    errors: List[str] = []
    regs = collect_registrations(root)
    if not regs:
        errors.append(
            f"no metric registrations found under {root!r} — the scanner "
            "or the telemetry wiring is broken"
        )
    errors.extend(m for m, _ in registration_errors(regs))
    errors.extend(check_event_and_phase_names(root))
    return errors


def _default_root() -> str:
    """The checkout holding this package."""
    here = os.path.abspath(__file__)
    for _ in range(4):
        here = os.path.dirname(here)
    return here


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else _default_root()
    errors = check(root)
    regs = collect_registrations(root)
    if errors:
        for e in errors:
            print(f"check_metric_names: {e}", file=sys.stderr)
        return 1
    events = collect_names(root, EMIT_RE)
    phases = collect_names(root, SPAN_RE)
    print(
        f"check_metric_names: {len(regs)} metric names OK "
        f"({sum(len(s) for s in regs.values())} registrations), "
        f"{len(events)} event names, {len(phases)} span phases"
    )
    return 0
