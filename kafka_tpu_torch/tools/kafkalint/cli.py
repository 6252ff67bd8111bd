"""kafkalint command line: human and --json output, stable exit codes
(the options and exit codes of ``tools/kafkalint/cli.py``)."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .core import BASELINE_RELPATH, REGISTRY, make_rules, run_lint


def _default_root() -> str:
    """The checkout holding this package (three levels above this
    directory)."""
    here = os.path.abspath(__file__)
    for _ in range(4):
        here = os.path.dirname(here)
    return here


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kafka_tpu_torch.tools.kafkalint",
        description=(
            "AST static analysis of the port's source for device-path "
            "hazards and repo conventions"
        ),
    )
    p.add_argument("root", nargs="?", default=None,
                   help="tree to lint (default: this repo)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings on stdout")
    p.add_argument("--rules", default=None,
                   help="comma-separated subset of rules to run")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON path (default: <root>/"
                        "kafka_tpu_torch/tools/kafkalint/baseline.json "
                        "if present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--baseline-update", action="store_true",
                   help="regenerate the baseline from the current "
                        "findings (grandfather everything; stale "
                        "semantics unchanged — entries that later match "
                        "nothing become stale-baseline findings)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    return p


def _baseline_update(root: str, rule_names: Optional[List[str]],
                     baseline_path: Optional[str]) -> int:
    """Regenerate the baseline file from the current (un-baselined)
    findings.  One entry per distinct (rule, path, message), with the
    full message as ``contains`` so an entry stops matching — and goes
    stale — the moment the finding changes at all."""
    result = run_lint(root, rule_names=rule_names, use_baseline=False)
    path = baseline_path or os.path.join(root, BASELINE_RELPATH)
    entries = []
    seen = set()
    for f in result.findings:
        key = (f.rule, f.path, f.message)
        if key in seen:
            continue
        seen.add(key)
        entries.append({
            "rule": f.rule, "path": f.path, "contains": f.message,
            "reason": "grandfathered by --baseline-update",
        })
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, indent=2)
        fh.write("\n")
    print(
        f"kafkalint: wrote {len(entries)} baseline entr"
        f"{'y' if len(entries) == 1 else 'ies'} to {path}"
    )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        make_rules()  # import rule modules so REGISTRY is populated
        for name in sorted(REGISTRY):
            print(f"{name}: {REGISTRY[name].description}")
        return 0
    root = args.root or _default_root()
    if not os.path.isdir(root):
        print(f"kafkalint: no such directory: {root}", file=sys.stderr)
        return 2
    rule_names = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules else None
    )
    try:
        if args.baseline_update:
            return _baseline_update(root, rule_names, args.baseline)
        result = run_lint(
            root, rule_names=rule_names, baseline_path=args.baseline,
            use_baseline=not args.no_baseline,
        )
    except ValueError as exc:  # unknown rule / malformed baseline
        print(f"kafkalint: {exc}", file=sys.stderr)
        return 2
    if args.as_json:
        payload = result.to_json()
        payload["root"] = os.path.abspath(root)
        json.dump(payload, sys.stdout, indent=2)
        print()
        return 0 if result.clean else 1
    for f in result.findings:
        print(f"kafkalint: {f.format()}", file=sys.stderr)
    if result.findings:
        print(
            f"kafkalint: {len(result.findings)} finding(s) in "
            f"{result.files_scanned} file(s)",
            file=sys.stderr,
        )
        return 1
    grandfathered = (
        f", {result.baseline_matched} grandfathered"
        if result.baseline_matched else ""
    )
    print(
        f"kafkalint: clean ({result.files_scanned} files, "
        f"{len(result.rules)} rules{grandfathered})"
    )
    return 0
