"""kafkalint framework: rule registry, file walking, suppressions, baseline.

The port of ``tools/kafkalint/core.py`` over the port's own source: only
the scan set and the baseline path differ.  The engine's hardest-won
invariants — one device->host read per window, float32-only device
math, TraceContext re-installed on every spawned thread — are
runtime-enforced only on the paths tier-1 happens to execute.
kafkalint checks them statically: one ``ast`` parse per production source,
a plugin rule registry walked over every file, inline suppressions, and a
checked-in baseline for grandfathered findings.

Vocabulary:

- :class:`Finding` — one (rule, path, line, message) violation.
- :class:`Rule` — plugin base class.  ``check_file(ctx)`` yields findings
  for one file; ``finalize()`` yields cross-file findings after the walk
  (the telemetry-vocabulary rules aggregate across the tree).  Register
  concrete rules with :func:`register`.
- :class:`FileContext` — one scanned file: text, lines, parsed AST, and
  the suppression map.
- :func:`run_lint` — the single-pass driver: walk, check, suppress,
  baseline-filter.

Suppressions: ``# kafkalint: disable=<rule>[,<rule>...]`` either trailing
on the flagged line or on a comment line immediately above it
(``disable=all`` silences every rule for that line).  An optional reason
after the rule list is encouraged: ``# kafkalint: disable=implicit-f64 —
host-only constant table``.

Baseline: a JSON list of ``{"rule", "path", "contains", "reason"}``
entries (``kafka_tpu_torch/tools/kafkalint/baseline.json`` of the linted
root).  A finding is grandfathered when an entry's rule and path match
and ``contains`` is a substring of the message.  Entries that match
nothing are STALE and reported as ``stale-baseline`` findings — the
baseline only shrinks.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Type

#: production sources walked, relative to the linted root: the port
#: package (its tools included) and its card harness.
SCAN = ("kafka_tpu_torch", "chip_smoke.py")

#: default baseline location, relative to the linted root.
BASELINE_RELPATH = os.path.join("kafka_tpu_torch", "tools", "kafkalint",
                                "baseline.json")

_SUPPRESS_RE = re.compile(
    r"#\s*kafkalint:\s*disable=([a-z0-9_\-]+(?:\s*,\s*[a-z0-9_\-]+)*)"
)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One violation at a source location (path is root-relative posix)."""

    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Rule:
    """Plugin base.  Subclasses set ``name``/``description`` and override
    ``check_file`` (per-file findings) and/or ``finalize`` (cross-file
    findings, emitted once after every file was visited).  One instance
    lives per :func:`run_lint` call, so rules may accumulate state."""

    name: str = ""
    description: str = ""

    def check_file(self, ctx: "FileContext") -> Iterable[Finding]:
        return ()

    def finalize(self) -> Iterable[Finding]:
        return ()


#: rule name -> rule class (populated by @register at import time).
REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} has no rule name")
    if cls.name in REGISTRY:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    REGISTRY[cls.name] = cls
    return cls


class FileContext:
    """One scanned source file: text, lines, AST, suppression map."""

    def __init__(self, root: str, path: str):
        self.root = root
        self.path = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8", errors="replace") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(self.text, filename=self.rel)
        except SyntaxError as exc:
            self.parse_error = exc
        #: 1-based line -> set of rule names disabled on that line.
        self._supp: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self._supp[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""

    def suppressed(self, line: int, rule: str) -> bool:
        """True when ``rule`` is disabled for ``line`` — by a trailing
        directive on the line itself, or by a directive anywhere in the
        contiguous block of pure-comment lines immediately above it."""
        rules = set(self._supp.get(line, ()))
        above = line - 1
        while above >= 1 and self.line_text(above).lstrip().startswith("#"):
            rules |= self._supp.get(above, set())
            above -= 1
        return "all" in rules or rule in rules


def iter_files(root: str) -> Iterable[str]:
    """Absolute paths of every ``.py`` in the scan set, sorted."""
    for entry in SCAN:
        path = os.path.join(root, entry)
        if os.path.isfile(path):
            yield path
        elif os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames.sort()
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files_scanned: int
    rules: List[str]
    baseline_path: Optional[str]
    baseline_entries: int
    baseline_matched: int

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        """The ``--json`` schema (stable; tests pin it)."""
        return {
            "version": 1,
            "root": None,  # filled by the CLI, which knows the arg form
            "files_scanned": self.files_scanned,
            "rules": list(self.rules),
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "baseline": {
                "path": self.baseline_path,
                "entries": self.baseline_entries,
                "matched": self.baseline_matched,
            },
        }


def load_baseline(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path}: expected a JSON list")
    for e in entries:
        if not isinstance(e, dict) or "rule" not in e or "path" not in e:
            raise ValueError(
                f"baseline {path}: each entry needs 'rule' and 'path'"
            )
    return entries


def _apply_baseline(findings: List[Finding], entries: List[dict],
                    baseline_rel: str) -> List[Finding]:
    """Drop grandfathered findings; report stale entries as findings."""
    hits = [0] * len(entries)

    def grandfathered(f: Finding) -> bool:
        ok = False
        for i, e in enumerate(entries):
            if (e["rule"] == f.rule and e["path"] == f.path
                    and e.get("contains", "") in f.message):
                hits[i] += 1
                ok = True
        return ok

    kept = [f for f in findings if not grandfathered(f)]
    for i, e in enumerate(entries):
        if hits[i] == 0:
            kept.append(Finding(
                path=baseline_rel, line=0, rule="stale-baseline",
                message=(
                    f"baseline entry for [{e['rule']}] at {e['path']} "
                    f"matches no current finding — remove it "
                    f"(reason was: {e.get('reason', 'none given')!r})"
                ),
            ))
    return kept


def make_rules(rule_names: Optional[Sequence[str]] = None) -> List[Rule]:
    # Import for the registration side effect; late so core stays
    # importable on its own (the shim path).
    from . import (  # noqa: F401
        rules_batch, rules_devprof, rules_perf, rules_placement,
        rules_programs, rules_publisher, rules_quality, rules_request,
        rules_runtime, rules_slo, rules_smoother, rules_telemetry,
        rules_torch,
    )

    names = sorted(REGISTRY) if rule_names is None else list(rule_names)
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown}; known: {sorted(REGISTRY)}"
        )
    return [REGISTRY[n]() for n in names]


def run_lint(root: str, rule_names: Optional[Sequence[str]] = None,
             baseline_path: Optional[str] = None,
             use_baseline: bool = True) -> LintResult:
    """Walk ``root``'s scan set once and return every surviving finding.

    ``baseline_path`` defaults to
    ``<root>/kafka_tpu_torch/tools/kafkalint/baseline.json`` when that
    file exists (so linting a fixture tree applies no baseline).
    """
    root = os.path.abspath(root)
    rules = make_rules(rule_names)
    findings: List[Finding] = []
    contexts: Dict[str, FileContext] = {}
    n_files = 0
    for path in iter_files(root):
        n_files += 1
        ctx = FileContext(root, path)
        contexts[ctx.rel] = ctx
        if ctx.parse_error is not None:
            findings.append(Finding(
                path=ctx.rel, line=ctx.parse_error.lineno or 0,
                rule="parse-error",
                message=f"could not parse: {ctx.parse_error.msg}",
            ))
            continue
        for rule in rules:
            findings.extend(rule.check_file(ctx))
    for rule in rules:
        findings.extend(rule.finalize())

    kept = [
        f for f in findings
        if f.path not in contexts
        or not contexts[f.path].suppressed(f.line, f.rule)
    ]

    n_entries = matched = 0
    if use_baseline:
        if baseline_path is None:
            candidate = os.path.join(root, BASELINE_RELPATH)
            baseline_path = candidate if os.path.isfile(candidate) else None
        if baseline_path is not None:
            entries = load_baseline(baseline_path)
            n_entries = len(entries)
            before = len(kept)
            kept = _apply_baseline(
                kept, entries,
                os.path.relpath(baseline_path, root).replace(os.sep, "/"),
            )
            matched = before - sum(
                1 for f in kept if f.rule != "stale-baseline"
            )
    else:
        baseline_path = None

    return LintResult(
        findings=sorted(kept),
        files_scanned=n_files,
        rules=[r.name for r in rules],
        baseline_path=baseline_path,
        baseline_entries=n_entries,
        baseline_matched=matched,
    )
