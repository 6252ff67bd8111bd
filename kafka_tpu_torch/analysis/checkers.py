"""Contract checkers over program censuses + fingerprint manifests (port
of ``kafka_tpu/analysis/checkers.py``).

Four checkers read the census of every registered program
(:mod:`kafka_tpu_torch.analysis.trace`):

- ``dtype`` — no float64/complex128 on device data (host tensors made
  float64 by design, like the stacked serve options, are told apart by
  the census), plus the bf16-readiness rule: reduce/dot operators
  consuming bf16 must produce f32 accumulators.
- ``transfer`` — no host callback on device data (a ``.numpy()`` of it)
  inside the program, and the host reads and synchronising transfers by
  operator equal to the budget the manifest pins: the static twin of
  the runtime ``kafka_engine_device_reads_total == dispatches``
  invariant.  A new ``.item()`` in a solve loop is a named finding.
- ``relayout`` — for programs registered ``relayout_clean``, no
  materialising copy (``clone``, ``contiguous``, ``copy_``,
  ``_to_copy``, a copying ``reshape``) of a non-contiguous rank-3
  (Jacobian-shaped) tensor: in PyTorch a ``permute`` is a free view and
  the cost is the copy that makes it dense.
- ``collective`` — for mesh programs, every collective op the shards
  called must appear in the program's declared manifest; an
  unmanifested ``all_gather`` is called out as a full replication of a
  pixel-sharded operand.

Manifests: one JSON per program under ``contracts/`` records the census
and a fingerprint hash.  ``compare_manifest`` turns any divergence into
a ``drift`` finding (regenerate deliberately with ``--update``, never
silently).  Waivers live inside each manifest as ``{"checker",
"contains", "reason"}`` entries with stale-waiver semantics — a waiver
matching nothing is itself a finding, so the waiver set only shrinks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional

from .trace import TracedProgram

#: dtypes forbidden on device data.
FORBIDDEN_DTYPES = ("float64", "complex128")
#: the manifests' home inside the checkout (for the messages).
CONTRACTS_HOME = "kafka_tpu_torch/analysis/contracts"
#: the command that regenerates them.
UPDATE_COMMAND = ("python -m kafka_tpu_torch.cli.programlint --update "
                  "--device cpu")


@dataclasses.dataclass(frozen=True, order=True)
class ContractFinding:
    """One violated contract on one program."""

    program: str
    checker: str    # dtype | transfer | relayout | collective | drift |
    #                 manifest | stale-waiver | trace
    message: str

    def format(self) -> str:
        return f"{self.program}: [{self.checker}] {self.message}"


# ---------------------------------------------------------------------------
# The four checkers.
# ---------------------------------------------------------------------------

def check_dtype(tp: TracedProgram) -> List[ContractFinding]:
    out: List[ContractFinding] = []
    for bad in FORBIDDEN_DTYPES:
        n = tp.dtypes.get(bad, 0)
        if n:
            culprit = next((
                f" (first producer: '{e['op']}' -> {bad}{e['shape']})"
                for e in tp.events
                if e["kind"] == "dtype" and e["dtype"] == bad), "")
            out.append(ContractFinding(
                program=tp.spec.name, checker="dtype",
                message=(
                    f"{bad} appears on {n} device value(s) in the program"
                    f"{culprit} — device code is float32-only (the AST "
                    "implicit-f64 lint cannot see computed dtypes; this "
                    "checker can)"
                ),
            ))
    for e in tp.events:
        if e["kind"] != "bf16_reduce":
            continue
        out.append(ContractFinding(
            program=tp.spec.name, checker="dtype",
            message=(
                f"'{e['op']}' consumes bfloat16 and accumulates in "
                "bfloat16 — reduce/dot operators on bf16 storage must "
                "produce f32 accumulators; the bf16-readiness gate for "
                "the mixed-precision arc"
            ),
        ))
    return out


def check_transfer(tp: TracedProgram,
                   budget: Optional[Dict[str, int]] = None
                   ) -> List[ContractFinding]:
    """Callbacks always; the host reads against ``budget`` (the
    manifest's ``host_syncs``) when one is given."""
    out: List[ContractFinding] = []
    for name in sorted(tp.callbacks):
        out.append(ContractFinding(
            program=tp.spec.name, checker="transfer",
            message=(
                f"'{name}' of device data appears {tp.callbacks[name]}x "
                "inside the program — a host callback per execution; the "
                "device program must keep its data on the device (one "
                "packed read per window, outside the program)"
            ),
        ))
    if budget is not None and dict(budget) != dict(tp.host_syncs):
        out.append(ContractFinding(
            program=tp.spec.name, checker="transfer",
            message=(
                "host reads and synchronising transfers differ from the "
                "manifest's budget"
                f"{_census_diff(budget, tp.host_syncs, label='host-read deltas')}"
                " — each is a device sync per execution; remove the new "
                "read or accept the budget deliberately with "
                f"{UPDATE_COMMAND}"
            ),
        ))
    return out


def check_relayout(tp: TracedProgram) -> List[ContractFinding]:
    if not tp.spec.relayout_clean:
        return []
    copies = [e for e in tp.events if e["kind"] == "relayout"]
    if not copies:
        return []
    first = copies[0]
    ops = sorted({e["op"] for e in copies})
    return [ContractFinding(
        program=tp.spec.name, checker="relayout",
        message=(
            f"{len(copies)} materialising copies ({', '.join(ops)}) of "
            f"non-contiguous rank-3 intermediates (e.g. '{first['op']}' "
            f"of {first['dtype']}{first['shape']} strides "
            f"{first['stride']}) in a program registered relayout_clean — "
            "a (B, n, p) Jacobian relayout is an extra HBM pass the "
            "in-kernel path exists to delete (jac_to_rows is the only "
            "sanctioned shim, and it lives outside relayout-clean "
            "programs)"
        ),
    )]


def check_collectives(tp: TracedProgram) -> List[ContractFinding]:
    if tp.collectives is None:
        return []
    out: List[ContractFinding] = []
    allowed = set(tp.spec.collectives)
    for op in sorted(tp.collectives):
        if op in allowed:
            continue
        hint = (
            " — a FULL REPLICATION of a pixel-sharded operand (every "
            "shard received every other shard's pixels)"
            if op == "all_gather" else
            " — a cross-shard dependency the program's manifest does "
            "not declare"
        )
        out.append(ContractFinding(
            program=tp.spec.name, checker="collective",
            message=(
                f"the shards called '{op}' {tp.collectives[op]}x, not in "
                f"the program's collectives manifest "
                f"{sorted(allowed) or '[]'}{hint}; either the sharding "
                "regressed or the manifest must be extended deliberately"
            ),
        ))
    return out


CHECKERS = (check_dtype, check_transfer, check_relayout, check_collectives)


def run_checkers(tp: TracedProgram,
                 stored: Optional[dict] = None) -> List[ContractFinding]:
    """Every checker over ``tp``; ``stored`` (the checked-in manifest)
    supplies the host-read budget."""
    findings: List[ContractFinding] = []
    for checker in CHECKERS:
        if checker is check_transfer:
            findings.extend(check_transfer(
                tp, None if stored is None else stored.get("host_syncs")
                or {}))
        else:
            findings.extend(checker(tp))
    return findings


# ---------------------------------------------------------------------------
# Fingerprints + manifests.
# ---------------------------------------------------------------------------

def _transfer_count(tp: TracedProgram) -> int:
    return sum(tp.callbacks.values())


def fingerprint(tp: TracedProgram) -> str:
    """Deterministic 16-hex-digit digest of the program's census: the
    JAX package's payload (operator inventory, dtype census, transfer
    count), with the host reads and the kernel nodes where the census
    has any — so a census with neither gives the JAX digest.  Census
    level on purpose: it does not depend on the device the run took."""
    body = {
        "primitives": dict(sorted(tp.primitives.items())),
        "dtypes": dict(sorted(tp.dtypes.items())),
        "transfer_count": _transfer_count(tp),
    }
    host_syncs = getattr(tp, "host_syncs", None) or {}
    kernels = getattr(tp, "kernels", None) or {}
    if host_syncs:
        body["host_syncs"] = dict(sorted(host_syncs.items()))
    if kernels:
        body["kernels"] = dict(sorted(kernels.items()))
    payload = json.dumps(body, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def manifest_payload(tp: TracedProgram,
                     waivers: Optional[List[dict]] = None) -> dict:
    return {
        "program": tp.spec.name,
        "description": tp.spec.description,
        "fingerprint": fingerprint(tp),
        "eqns": tp.n_eqns,
        "primitives": dict(sorted(tp.primitives.items())),
        "dtypes": dict(sorted(tp.dtypes.items())),
        "kernels": dict(sorted(tp.kernels.items())),
        "host_syncs": dict(sorted(tp.host_syncs.items())),
        "transfer_count": _transfer_count(tp),
        "relayout_clean": tp.spec.relayout_clean,
        "mesh_devices": tp.mesh_devices,
        "collectives": (
            None if tp.collectives is None
            else dict(sorted(tp.collectives.items()))
        ),
        "collectives_manifest": sorted(tp.spec.collectives),
        "torch": tp.torch_version,
        "device": tp.device,
        "waivers": list(waivers or ()),
    }


def manifest_path(contracts_dir: str, name: str) -> str:
    return os.path.join(contracts_dir, f"{name}.json")


def load_manifest(contracts_dir: str, name: str) -> Optional[dict]:
    path = manifest_path(contracts_dir, name)
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_manifest(contracts_dir: str, payload: dict) -> str:
    os.makedirs(contracts_dir, exist_ok=True)
    path = manifest_path(contracts_dir, payload["program"])
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def compare_manifest(tp: TracedProgram,
                     stored: Optional[dict]) -> List[ContractFinding]:
    """Drift findings between the fresh census and the checked-in
    manifest (accept drift deliberately with ``--update``).  A drift
    under another torch version than the manifest's names both."""
    name = tp.spec.name
    if stored is None:
        return [ContractFinding(
            program=name, checker="manifest",
            message=(
                "no checked-in contract manifest "
                f"({CONTRACTS_HOME}/{name}.json) — run "
                f"{UPDATE_COMMAND} to record the current fingerprint"
            ),
        )]
    out: List[ContractFinding] = []
    fp_new = fingerprint(tp)
    fp_old = stored.get("fingerprint")
    if fp_old != fp_new:
        versions = ""
        written = stored.get("torch")
        traced = getattr(tp, "torch_version", None)
        if written and traced and written != traced:
            versions = (f" (manifest written under torch {written}, "
                        f"traced under torch {traced})")
        out.append(ContractFinding(
            program=name, checker="drift",
            message=(
                f"census fingerprint drifted {fp_old} -> {fp_new}"
                f"{versions}"
                f"{_census_diff(stored.get('primitives') or {}, tp.primitives)} "
                "— the device program changed shape; review the diff and "
                f"accept deliberately with {UPDATE_COMMAND}"
            ),
        ))
    old_coll = stored.get("collectives")
    if (old_coll is not None and tp.collectives is not None
            and dict(old_coll) != dict(tp.collectives)):
        out.append(ContractFinding(
            program=name, checker="drift",
            message=(
                f"collective inventory drifted {dict(old_coll)} -> "
                f"{dict(tp.collectives)} — the shards' collective calls "
                "changed; review and accept with --update"
            ),
        ))
    return out


def _census_diff(old: Dict[str, int], new: Dict[str, int],
                 limit: int = 6, label: str = "primitive deltas") -> str:
    changed = []
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key, 0), new.get(key, 0)
        if a != b:
            changed.append(f"{key} {a}->{b}")
    if not changed:
        return ""
    shown = ", ".join(changed[:limit])
    more = f", +{len(changed) - limit} more" if len(changed) > limit else ""
    return f" ({label}: {shown}{more})"


def apply_waivers(findings: List[ContractFinding], waivers: List[dict],
                  program: str) -> List[ContractFinding]:
    """Drop waived findings; report waivers that match nothing as
    ``stale-waiver`` findings (the manifest-embedded twin of kafkalint's
    stale-baseline semantics)."""
    hits = [0] * len(waivers)

    def waived(f: ContractFinding) -> bool:
        ok = False
        for i, w in enumerate(waivers):
            if (w.get("checker") == f.checker
                    and w.get("contains", "") in f.message):
                hits[i] += 1
                ok = True
        return ok

    kept = [f for f in findings if f.checker == "stale-waiver" or
            not waived(f)]
    for i, w in enumerate(waivers):
        if hits[i] == 0:
            kept.append(ContractFinding(
                program=program, checker="stale-waiver",
                message=(
                    f"waiver for [{w.get('checker')}] containing "
                    f"{w.get('contains', '')!r} matches no current "
                    "finding — remove it (reason was: "
                    f"{w.get('reason', 'none given')!r})"
                ),
            ))
    return kept


# ---------------------------------------------------------------------------
# The full analysis pass.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AnalysisResult:
    findings: List[ContractFinding]
    reports: Dict[str, dict]        # program -> fresh manifest payload
    updated: List[str]              # manifest paths written (--update)

    @property
    def clean(self) -> bool:
        return not self.findings


def analyze(specs, contracts_dir: Optional[str], update: bool = False,
            compile_collectives: bool = True,
            device="cpu") -> AnalysisResult:
    """Census + check every spec on ``device``; compare (or regenerate)
    manifests.

    ``contracts_dir=None`` skips manifest handling entirely (the fixture
    tests exercise the checkers in isolation that way).
    """
    from .trace import trace_program

    findings: List[ContractFinding] = []
    reports: Dict[str, dict] = {}
    updated: List[str] = []
    for spec in specs:
        try:
            tp = trace_program(
                spec, device, compile_collectives=compile_collectives
            )
        except Exception as exc:  # any builder failure becomes a finding
            findings.append(ContractFinding(
                program=spec.name, checker="trace",
                message=(
                    f"builder/run failed: {type(exc).__name__}: "
                    f"{exc}"
                ),
            ))
            continue
        stored = (
            load_manifest(contracts_dir, spec.name)
            if contracts_dir else None
        )
        waivers = list((stored or {}).get("waivers") or ())
        payload = manifest_payload(tp, waivers=waivers)
        reports[spec.name] = payload
        if contracts_dir and update:
            prog_findings = run_checkers(tp)
            updated.append(write_manifest(contracts_dir, payload))
        else:
            prog_findings = run_checkers(tp, stored)
            if contracts_dir:
                prog_findings.extend(compare_manifest(tp, stored))
        findings.extend(
            apply_waivers(prog_findings, waivers, spec.name)
        )
    return AnalysisResult(
        findings=sorted(findings), reports=reports, updated=updated
    )
