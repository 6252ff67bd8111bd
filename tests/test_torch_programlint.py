"""The port's program contracts (``kafka_tpu_torch.analysis`` and
``python -m kafka_tpu_torch.cli.programlint``) on the CPU: every
registered device program runs once under the operator census and is
verified against its contracts — dtype hygiene, the host-read budget,
relayout-freedom, the collective manifest and the checked-in fingerprint
manifests — on every test run, so a float64 leak, a new ``.item()`` in a
solve loop, a relayout copy or an unmanifested ``all_gather`` breaks the
suite, not a card run later.

Also pins the analyzer itself: each seeded violation in
``kafka_tpu_torch.testing.programlint_fixtures`` is reported by exactly
its intended checker, manifests round-trip with drift and waiver
semantics, the CLI's exit codes stay those of ``tools/programlint.py``,
and every def of the device packages that launches a hand kernel or
enters a kernel region is named in ``COVERED_ENTRY_POINTS`` (the port's
counterpart of kafkalint rule 21).
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from kafka_tpu_torch import analysis
from kafka_tpu_torch.analysis import checkers, programs, trace
from kafka_tpu_torch.cli import programlint
from kafka_tpu_torch.core import _build, collective
from kafka_tpu_torch.testing import programlint_fixtures

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def production_result():
    """One full analysis pass over every production program on the CPU,
    shared by the assertions below (the census is deterministic)."""
    return analysis.analyze(analysis.get_specs(),
                            contracts_dir=analysis.contracts_dir(),
                            device="cpu")


# ---------------------------------------------------------------------------
# The production programs analyze clean.
# ---------------------------------------------------------------------------

def test_all_production_programs_clean(production_result):
    assert production_result.findings == [], "\n".join(
        f.format() for f in production_result.findings)


def test_production_manifests_checked_in_and_waiver_free(production_result):
    """Every manifest is on disk, carries the census's fingerprint and
    the torch that wrote it, and waives nothing: no production finding
    was waived in this slice."""
    names = set(analysis.REGISTRY)
    on_disk = {fn[:-len(".json")] for fn in
               os.listdir(analysis.contracts_dir()) if fn.endswith(".json")}
    assert on_disk == names
    for name in names:
        stored = checkers.load_manifest(analysis.contracts_dir(), name)
        assert stored["waivers"] == []
        assert stored["fingerprint"] == \
            production_result.reports[name]["fingerprint"]
        assert stored["torch"] == torch.__version__
        assert stored["device"] == "cpu"


def test_registry_covers_the_flagship_programs():
    names = set(analysis.REGISTRY)
    assert {
        "date_twostream_xla", "date_twostream_inkernel",
        "date_twostream_jac_to_rows", "windows_scan_twostream",
        "windows_scan_twostream_inkernel", "smoother_rts_sweep",
        "sharded_step_tip", "sharded_forward_tip",
    } <= names
    assert sum(1 for n in names if n.startswith("linearize_")) >= 6


def test_kernel_nodes_and_host_reads_of_the_solves(production_result):
    """The in-kernel solve is one fused_gn node with no host read of
    device memory; the row loop is one fused_update node per step and
    one read of its loop condition per step; the plain loops read their
    condition per step too."""
    rep = production_result.reports
    assert rep["date_twostream_inkernel"]["kernels"] == {"fused_gn": 1}
    assert "aten._local_scalar_dense" not in \
        rep["date_twostream_inkernel"]["host_syncs"]
    assert rep["windows_scan_twostream_inkernel"]["kernels"] == \
        {"fused_gn": 3}
    steps = programs.PIN["max_iterations"] + 1
    assert rep["date_twostream_jac_to_rows"]["kernels"] == \
        {"fused_update[7,2]": steps}
    for name in ("date_twostream_jac_to_rows", "date_twostream_xla"):
        assert rep[name]["host_syncs"]["aten._local_scalar_dense"] == \
            steps + 1
    for name, rep_ in rep.items():
        if not name.endswith("_inkernel") and name != "sharded_step_tip" \
                and name != "date_twostream_jac_to_rows":
            assert rep_["kernels"] == {}, name


def test_stacked_options_are_host_data_not_device_float64(
        production_result):
    """The coalesced program's stacked options are float64 host tensors
    by design: the census counts them as host data, so the dtype checker
    passes, while a float64 device value would not."""
    dtypes = production_result.reports["date_batched_twostream_xla"]["dtypes"]
    assert dtypes.get("float64@host", 0) > 0
    assert "float64" not in dtypes


def test_mesh_program_collectives_are_inventoried(production_result):
    """The sharded step on a 2-shard CPU mesh: its shards combine the
    trip count and the norm (all_reduce) and hand the straddling groups
    back (all_gather: 256 px in groups of 256 on shards of 128); the
    forward calls no collective."""
    step = production_result.reports["sharded_step_tip"]
    assert step["mesh_devices"] == 2
    assert set(step["collectives"]) == {"all_reduce", "all_gather"}
    assert set(step["collectives"]) <= set(step["collectives_manifest"])
    assert step["kernels"] == {"fused_gn": 1}
    fwd = production_result.reports["sharded_forward_tip"]
    assert fwd["collectives"] == {}


def test_fingerprints_are_deterministic():
    spec = analysis.REGISTRY["linearize_twostream"]
    fp = [analysis.fingerprint(trace.trace_program(spec, CPU))
          for _ in range(2)]
    assert fp[0] == fp[1] and len(fp[0]) == 16


def test_kernel_region_hides_the_plain_version():
    """A kernel region is one node whatever runs inside it; outside a
    census it and the collective hooks are no-ops."""
    registry = {}

    @analysis.register_program("probe_region", registry=registry)
    def _probe(device):
        def run(x):
            with _build.kernel_region("fused_gn"):
                y = (x * 2).sum() + x.exp().mean()
            return x + y

        return run, (torch.ones(8, device=device),)

    tp = trace.trace_program(registry["probe_region"], CPU)
    assert tp.kernels == {"fused_gn": 1}
    assert tp.primitives == {"aten.add": 1}
    assert _build.current_census() is None
    assert collective.all_gather(3) == [3]
    with _build.kernel_region("fused_gn"):
        pass


# ---------------------------------------------------------------------------
# Seeded fixtures: each violation caught by exactly its intended checker.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "name,expected_checker", sorted(programlint_fixtures.EXPECT.items()))
def test_seeded_fixture_caught_by_exactly_its_checker(name,
                                                      expected_checker):
    spec = programlint_fixtures.REGISTRY[name]
    findings = checkers.run_checkers(trace.trace_program(spec, CPU))
    assert {f.checker for f in findings} == {expected_checker}, \
        "\n".join(f.format() for f in findings)


def test_fixture_expect_map_spans_all_four_checkers():
    assert set(programlint_fixtures.EXPECT.values()) == {
        "dtype", "transfer", "relayout", "collective"}
    assert set(programlint_fixtures.EXPECT) == \
        set(programlint_fixtures.REGISTRY)


# ---------------------------------------------------------------------------
# Manifest mechanics: missing -> update -> clean -> drift; waivers; the
# host-read budget.
# ---------------------------------------------------------------------------

def _toy_registry(reads: int = 0):
    registry = {}

    @analysis.register_program(
        "toy_scale", description="manifest round-trip probe",
        registry=registry)
    def _build_toy(device):
        def run(x):
            y = x * 2.0
            for _ in range(reads):
                bool(y.sum() > 0)
            return y

        return run, (torch.ones(8, device=device),)

    return registry


def test_manifest_roundtrip_and_drift(tmp_path):
    specs = analysis.get_specs(registry=_toy_registry())
    cdir = str(tmp_path)

    missing = analysis.analyze(specs, contracts_dir=cdir)
    assert [f.checker for f in missing.findings] == ["manifest"]
    assert "--update" in missing.findings[0].message

    updated = analysis.analyze(specs, contracts_dir=cdir, update=True)
    assert updated.findings == []
    assert [os.path.basename(p) for p in updated.updated] == \
        ["toy_scale.json"]

    clean = analysis.analyze(specs, contracts_dir=cdir)
    assert clean.findings == []

    stored = checkers.load_manifest(cdir, "toy_scale")
    stored["fingerprint"] = "0" * 16
    checkers.write_manifest(cdir, stored)
    drifted = analysis.analyze(specs, contracts_dir=cdir)
    assert [f.checker for f in drifted.findings] == ["drift"]
    assert "0000000000000000 ->" in drifted.findings[0].message
    assert "written under torch" not in drifted.findings[0].message

    stored["torch"] = "2.11.0+cu128"
    checkers.write_manifest(cdir, stored)
    other = analysis.analyze(specs, contracts_dir=cdir)
    assert [f.checker for f in other.findings] == ["drift"]
    msg = other.findings[0].message
    assert "torch 2.11.0+cu128" in msg and f"torch {torch.__version__}" in msg


def test_a_new_host_read_is_a_named_transfer_finding(tmp_path):
    """A manifest pins the host reads: one more ``bool()`` of device data
    is a transfer finding naming the operator and the counts, beside the
    drift."""
    cdir = str(tmp_path)
    analysis.analyze(analysis.get_specs(registry=_toy_registry(1)),
                     contracts_dir=cdir, update=True)
    stored = checkers.load_manifest(cdir, "toy_scale")
    assert stored["host_syncs"] == {"aten._local_scalar_dense": 1}
    more = analysis.analyze(analysis.get_specs(registry=_toy_registry(2)),
                            contracts_dir=cdir)
    by = {f.checker: f.message for f in more.findings}
    assert set(by) == {"transfer", "drift"}
    assert "aten._local_scalar_dense 1->2" in by["transfer"]


def test_waiver_silences_and_goes_stale(tmp_path):
    spec = programlint_fixtures.REGISTRY["fixture_smuggled_callback"]
    cdir = str(tmp_path)
    analysis.analyze([spec], contracts_dir=cdir, update=True)

    stored = checkers.load_manifest(cdir, spec.name)
    stored["waivers"] = [{
        "checker": "transfer", "contains": "'numpy'",
        "reason": "seeded fixture, waiver mechanics probe",
    }]
    checkers.write_manifest(cdir, stored)
    waived = analysis.analyze([spec], contracts_dir=cdir)
    assert waived.findings == []

    stored["waivers"] = [{
        "checker": "dtype", "contains": "no such finding",
        "reason": "stale on purpose",
    }]
    checkers.write_manifest(cdir, stored)
    stale = analysis.analyze([spec], contracts_dir=cdir)
    assert {f.checker for f in stale.findings} == \
        {"transfer", "stale-waiver"}


# ---------------------------------------------------------------------------
# CLI: exit codes, --json schema, --spec-module, --list, --device.
# ---------------------------------------------------------------------------

FIXTURES = "kafka_tpu_torch.testing.programlint_fixtures"


def test_cli_clean_subset_exits_zero(capsys):
    rc = programlint.main(["--device", "cpu", "--programs",
                           "linearize_twostream"])
    assert rc == 0
    assert "clean (1 programs" in capsys.readouterr().out


def test_cli_fixture_violation_exits_one_naming_checker(capsys):
    rc = programlint.main([
        "--device", "cpu", "--spec-module", FIXTURES, "--no-manifest",
        "--programs", "fixture_f64_upcast",
    ])
    assert rc == 1
    err = capsys.readouterr().err
    assert "[dtype]" in err and "fixture_f64_upcast" in err


def test_cli_json_schema(capsys):
    rc = programlint.main([
        "--device", "cpu", "--spec-module", FIXTURES, "--no-manifest",
        "--programs", "fixture_rank3_relayout", "--json",
    ])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["version"] == 1
    assert set(payload["programs"]) == {"fixture_rank3_relayout"}
    report = payload["programs"]["fixture_rank3_relayout"]
    assert {"fingerprint", "eqns", "primitives", "dtypes",
            "relayout_clean", "collectives_manifest", "kernels",
            "host_syncs", "torch"} <= set(report)
    assert payload["findings"] and all(
        set(f) == {"program", "checker", "message"}
        for f in payload["findings"])
    assert payload["findings"][0]["checker"] == "relayout"


def test_cli_unknown_program_and_bad_module_exit_two(capsys):
    assert programlint.main(["--device", "cpu", "--programs",
                             "no_such_program"]) == 2
    assert "no_such_program" in capsys.readouterr().err
    assert programlint.main(["--device", "cpu", "--spec-module",
                             "json"]) == 2
    assert "REGISTRY" in capsys.readouterr().err


def test_cli_list_names_every_program(capsys):
    assert programlint.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in analysis.REGISTRY:
        assert name in out
    assert "relayout-clean" in out
    assert "collectives=all_reduce,all_gather" in out


def test_cli_without_a_device_raises_without_a_card():
    """The default device is CUDA: with no card the CLI raises, it does
    not quietly run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        programlint.main(["--programs", "linearize_mlp"])


def test_cli_subprocess_entry_point():
    """``python -m kafka_tpu_torch.cli.programlint`` works cold (a fresh
    interpreter, no conftest)."""
    proc = subprocess.run(
        [sys.executable, "-m", "kafka_tpu_torch.cli.programlint",
         "--device", "cpu", "--programs", "linearize_wcm"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


# ---------------------------------------------------------------------------
# Coverage: the port's counterpart of kafkalint rule 21.
# ---------------------------------------------------------------------------

DEVICE_PACKAGES = ("core", "engine", "smoother", "obsops", "shard")


def _kernel_defs():
    """``(file, def name)`` of every def in the device packages whose body
    calls ``count_launch`` or enters ``kernel_region``."""
    found = []
    for pkg in DEVICE_PACKAGES:
        for path in sorted((REPO / "kafka_tpu_torch" / pkg).rglob("*.py")):
            if path.name == "_build.py":
                continue
            tree = ast.parse(path.read_text(), filename=str(path))
            for node in ast.walk(tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call):
                        fn = sub.func
                        name = fn.attr if isinstance(fn, ast.Attribute) \
                            else getattr(fn, "id", None)
                        if name in ("count_launch", "kernel_region"):
                            found.append((path.name, node.name))
                            break
    return found


def test_every_kernel_def_is_a_covered_entry_point():
    defs = _kernel_defs()
    assert {d for _, d in defs} >= {"fused_gn_raw", "fused_update_rows",
                                    "solve_rows", "_launch_cuda"}
    missing = sorted({d for _, d in defs}
                     - programs.COVERED_ENTRY_POINTS)
    assert missing == [], missing


def test_covered_entry_points_exist():
    """Every covered name is a def of the port."""
    defs = set()
    for path in (REPO / "kafka_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef):
                defs.add(node.name)
    assert programs.COVERED_ENTRY_POINTS <= defs
