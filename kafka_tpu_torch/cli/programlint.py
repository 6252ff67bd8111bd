"""programlint: contract analysis of the port's registered device
programs (port of ``tools/programlint.py``).

Runs every program registered in ``kafka_tpu_torch.analysis.programs``
once under an operator census, on ``--device`` (default CUDA; it raises
without a card — pass ``--device cpu`` on the CPU), and verifies its
contracts: no float64 device data, no host callback and no host read
beyond the manifest's budget, no relayout copy of a rank-3 intermediate
in relayout-clean programs, no unmanifested collective in mesh
programs, and no silent drift against the checked-in fingerprint
manifests (``kafka_tpu_torch/analysis/contracts/*.json``, written with
``--update --device cpu``).

Usage::

    python -m kafka_tpu_torch.cli.programlint --device cpu
    python -m kafka_tpu_torch.cli.programlint --device cpu \\
        --programs date_twostream_inkernel
    python -m kafka_tpu_torch.cli.programlint --device cpu --update
    python -m kafka_tpu_torch.cli.programlint --device cpu --json
    python -m kafka_tpu_torch.cli.programlint --list

Exit codes: 0 clean, 1 findings, 2 usage/configuration error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kafka_tpu_torch.cli.programlint",
        description=(
            "operator-census contract analysis of the port's registered "
            "device programs"
        ),
    )
    p.add_argument("--programs", default=None,
                   help="comma-separated subset of registered programs")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings on stdout")
    p.add_argument("--update", action="store_true",
                   help="regenerate the contract manifests from the "
                        "current censuses (waivers preserved)")
    p.add_argument("--list", action="store_true", dest="list_programs",
                   help="print the registered programs and exit")
    p.add_argument("--contracts-dir", default=None,
                   help="manifest directory (default: "
                        "kafka_tpu_torch/analysis/contracts)")
    p.add_argument("--no-manifest", action="store_true",
                   help="skip manifest comparison (checkers only)")
    p.add_argument("--no-collectives", action="store_true",
                   help="skip the collective inventory of mesh programs")
    p.add_argument("--spec-module", default=None,
                   help="import this module's REGISTRY instead of the "
                        "production kafka_tpu_torch.analysis.programs "
                        "(the fixture tests use it)")
    p.add_argument("--device", default=None,
                   help="device the programs run on (default: CUDA; "
                        "raises without one)")
    return p


def _load_registry(spec_module: Optional[str]):
    from ..analysis import registry as reg_mod

    if spec_module is None:
        from ..analysis import programs  # noqa: F401

        return reg_mod.REGISTRY
    mod = importlib.import_module(spec_module)
    registry = getattr(mod, "REGISTRY", None)
    if not isinstance(registry, dict) or not registry:
        raise ValueError(
            f"spec module {spec_module!r} exposes no non-empty "
            "REGISTRY dict"
        )
    return registry


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)

    from .. import analysis, resolve_device

    try:
        registry = _load_registry(args.spec_module)
        names = (
            [n.strip() for n in args.programs.split(",") if n.strip()]
            if args.programs else None
        )
        specs = analysis.get_specs(names, registry=registry)
    except (ImportError, KeyError, ValueError) as exc:
        print(f"programlint: {exc}", file=sys.stderr)
        return 2

    if args.list_programs:
        for spec in specs:
            extras = []
            if spec.relayout_clean:
                extras.append("relayout-clean")
            if spec.collectives:
                extras.append(
                    "collectives=" + ",".join(spec.collectives)
                )
            suffix = f" [{'; '.join(extras)}]" if extras else ""
            print(f"{spec.name}: {spec.description}{suffix}")
        return 0

    device = resolve_device(args.device)
    contracts_dir = (
        None if args.no_manifest
        else args.contracts_dir or analysis.contracts_dir()
    )
    result = analysis.analyze(
        specs, contracts_dir=contracts_dir, update=args.update,
        compile_collectives=not args.no_collectives, device=device,
    )

    if args.as_json:
        payload = {
            "version": 1,
            "programs": result.reports,
            "findings": [
                {"program": f.program, "checker": f.checker,
                 "message": f.message}
                for f in result.findings
            ],
            "updated": result.updated,
        }
        json.dump(payload, sys.stdout, indent=2)
        print()
        return 0 if result.clean else 1

    for f in result.findings:
        print(f"programlint: {f.format()}", file=sys.stderr)
    for path in result.updated:
        print(f"programlint: wrote {os.path.relpath(path, repo_root)}")
    if result.findings:
        print(
            f"programlint: {len(result.findings)} finding(s) across "
            f"{len(specs)} program(s)",
            file=sys.stderr,
        )
        return 1
    print(
        f"programlint: clean ({len(specs)} programs, "
        f"{sum(p['eqns'] for p in result.reports.values())} operators "
        f"on {device})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
