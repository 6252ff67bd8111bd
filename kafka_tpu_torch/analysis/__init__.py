"""Program contracts of the port (port of ``kafka_tpu/analysis``).

``python -m kafka_tpu_torch.cli.programlint`` drives this package: every
registered device program (:mod:`.programs`) runs once under an
operator census (:mod:`.trace`) and is verified against
machine-checkable contracts (:mod:`.checkers`) — dtype hygiene, a
pinned budget of host reads and no host callbacks, no relayout copies,
and (for mesh programs) a collective manifest — with checked-in
fingerprint manifests under ``contracts/`` guarding against silent
drift.  The census does not depend on the device: the manifests are
written on the CPU, and ``chip_smoke.py``'s phase ``contracts`` holds
the card's census of every program to the CPU's.
"""

from .checkers import (
    AnalysisResult,
    ContractFinding,
    analyze,
    fingerprint,
    manifest_payload,
)
from .registry import (
    REGISTRY,
    BuiltProgram,
    ProgramSpec,
    get_specs,
    register_program,
)
from .trace import TracedProgram, trace_program

__all__ = [
    "AnalysisResult",
    "BuiltProgram",
    "ContractFinding",
    "ProgramSpec",
    "REGISTRY",
    "TracedProgram",
    "analyze",
    "contracts_dir",
    "contracts_snapshot",
    "fingerprint",
    "get_specs",
    "manifest_payload",
    "register_program",
    "trace_program",
]


def contracts_dir() -> str:
    """The checked-in manifest directory (next to this package)."""
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "contracts")


_SNAPSHOT_CACHE = {}


def contracts_snapshot(device=None) -> dict:
    """Compact census-level snapshot for a bench artifact: per-program
    fingerprints plus the contract-finding count, on ``device`` (default
    CUDA).  No collective inventory, and cached per device — a benchmark
    assembles many artifacts per process and the programs don't change
    mid-run.  Never raises: an analysis failure (no card included)
    becomes an ``error`` field, not a dead benchmark."""
    key = str(device)
    if key in _SNAPSHOT_CACHE:
        return _SNAPSHOT_CACHE[key]
    try:
        from .. import resolve_device
        from . import programs  # noqa: F401  (registration side effect)

        result = analyze(
            get_specs(), contracts_dir=None, compile_collectives=False,
            device=resolve_device(device),
        )
        snap = {
            "programs": {
                name: payload["fingerprint"]
                for name, payload in sorted(result.reports.items())
            },
            "findings": len(result.findings),
            "clean": result.clean,
            "error": None,
        }
    except Exception as exc:  # pragma: no cover - defensive
        snap = {
            "programs": {}, "findings": None, "clean": None,
            "error": f"{type(exc).__name__}: {exc}",
        }
    _SNAPSHOT_CACHE[key] = snap
    return snap
