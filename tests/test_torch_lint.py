"""The port's source lints (``kafka_tpu_torch/tools/kafkalint``): the
device-path hazard and repo-convention rules run over ``kafka_tpu_torch/``
and ``chip_smoke.py`` on every test run, the counterpart of
``tests/test_lint.py``.

Also pins the framework (every seeded violation in
``tests/torch_lint_fixtures/`` reported by exactly its intended rule,
suppressions, the baseline and its ageing, the ``--json`` schema), and
holds the rules kept as they are to the JAX linter: on the JAX fixture
tree copied under the port's package name they report the
(rule, path, line) findings ``tools.kafkalint`` reports on the original.
"""

import ast
import collections
import json
import os
import re
import shutil
import sys
import textwrap

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from kafka_tpu_torch.tools.kafkalint import (  # noqa: E402
    cli, core, torchscan,
)
from kafka_tpu_torch.tools.kafkalint.core import (  # noqa: E402
    iter_files, make_rules, run_lint,
)

FIXTURES = os.path.join(REPO_ROOT, "tests", "torch_lint_fixtures")
JAX_FIXTURES = os.path.join(REPO_ROOT, "tests", "lint_fixtures")

EXPECT_RE = re.compile(r"#\s*expect:\s*([a-z0-9\-, ]+)")

#: the JAX linter's rules less ``static-arg-flag``, which has no torch
#: counterpart (``rules_torch.py``'s docstring says why).
ALL_RULES = {
    "host-transfer-in-jit", "implicit-f64", "untracked-thread",
    "bare-except", "metric-name", "event-name",
    "event-collision", "kernel-relayout", "ad-hoc-retry",
    "naive-marker-write", "nonfinite-launder",
    "blocking-call-in-publisher", "magic-quality-threshold",
    "ad-hoc-timing", "nondeterministic-placement",
    "request-id-origin", "magic-slo-threshold",
    "forward-state-mutation-in-smoother", "raw-device-introspection",
    "unregistered-device-program", "unbatched-serve-dispatch",
}

#: the rules the port keeps as they are (only the package prefix
#: differs): the runtime, telemetry, perf, request, SLO, quality,
#: publisher, smoother, placement and batch rules.
KEPT_RULES = {
    "untracked-thread", "bare-except", "ad-hoc-retry",
    "naive-marker-write", "metric-name", "event-name", "event-collision",
    "ad-hoc-timing", "request-id-origin", "magic-slo-threshold",
    "magic-quality-threshold", "blocking-call-in-publisher",
    "forward-state-mutation-in-smoother", "nondeterministic-placement",
    "unbatched-serve-dispatch",
}

BASELINE = os.path.join(REPO_ROOT, "kafka_tpu_torch", "tools", "kafkalint",
                        "baseline.json")


@pytest.fixture(scope="module")
def repo_result():
    """One lint pass over the checkout, shared by the assertions below."""
    return run_lint(REPO_ROOT)


# ---------------------------------------------------------------------------
# The port's tree lints clean; the baseline holds only reasoned entries.
# ---------------------------------------------------------------------------

def test_production_tree_is_clean(repo_result):
    assert repo_result.findings == [], "\n".join(
        f.format() for f in repo_result.findings
    )


def test_baseline_entries_carry_reasons_and_all_match(repo_result):
    """Every entry names why it is grandfathered, and none is stale (a
    stale one would be a finding above); no entry cites ROADMAP 10h —
    its host-to-device copies were removed, not grandfathered."""
    entries = json.load(open(BASELINE))
    assert repo_result.baseline_entries == len(entries)
    assert repo_result.baseline_matched >= len(entries)
    for e in entries:
        assert e["reason"] and e["contains"], e
    assert not any("10h" in e["reason"] for e in entries)
    sites = {(e["path"], e["contains"].rsplit(" ", 1)[-1]) for e in entries
             if e["rule"] == "host-transfer-in-jit"}
    assert not sites & {
        ("kafka_tpu_torch/obsops/_jaxrules.py", "'_max'"),
        ("kafka_tpu_torch/obsops/_jaxrules.py", "'_min'"),
        ("kafka_tpu_torch/obsops/prosail.py", "'_f32'"),
        ("kafka_tpu_torch/obsops/prosail.py", "'forward_pixel'")}


def test_roadmap_10h_sites_are_host_transfer_findings():
    """ROADMAP 10h's sites — the clip helpers, PROSAIL's ``_f32`` and
    ``forward_pixel``'s default geometry — are clean without the
    baseline: they take their constants from the per-device cache
    (``core.device_constants``).  The scanner still follows the
    linearised forward model into them: each is a device region."""
    result = run_lint(REPO_ROOT, rule_names=["host-transfer-in-jit"],
                      use_baseline=False)
    assert result.findings == [], "\n".join(
        f.format() for f in result.findings)
    index = torchscan.TreeIndex()
    for path in iter_files(REPO_ROOT):
        rel = os.path.relpath(path, REPO_ROOT).replace(os.sep, "/")
        if rel.endswith(".py"):
            with open(path) as fh:
                index.add(rel, ast.parse(fh.read()))
    regions = {(r.rel, r.name) for r in index.regions()}
    assert {("kafka_tpu_torch/obsops/_jaxrules.py", "_max"),
            ("kafka_tpu_torch/obsops/_jaxrules.py", "_min"),
            ("kafka_tpu_torch/obsops/prosail.py", "_f32"),
            ("kafka_tpu_torch/obsops/prosail.py", "forward_pixel")} <= \
        regions


def test_cli_exits_zero_on_production_tree(capsys):
    assert cli.main([REPO_ROOT]) == 0
    out = capsys.readouterr().out
    entries = json.load(open(BASELINE))
    assert "clean" in out
    assert ("grandfathered" in out) == bool(entries)


def test_scanned_set_covers_the_package_and_chip_smoke():
    """chip_smoke.py, the operator tools and the linter itself are in
    the scanned set — an empty walk must never pass silently."""
    rels = {
        os.path.relpath(p, REPO_ROOT).replace(os.sep, "/")
        for p in iter_files(REPO_ROOT)
    }
    assert "chip_smoke.py" in rels
    assert "kafka_tpu_torch/tools/loadgen.py" in rels
    assert "kafka_tpu_torch/tools/kafkalint/rules_torch.py" in rels
    assert any(r.startswith("kafka_tpu_torch/core/") for r in rels)
    assert not any(r.startswith(("kafka_tpu/", "tools/")) for r in rels)
    assert len(rels) > 100


def test_all_rules_registered():
    names = {r.name for r in make_rules()}
    assert names == ALL_RULES


# ---------------------------------------------------------------------------
# Fixture tree: findings must match the # expect annotations EXACTLY.
# ---------------------------------------------------------------------------

def _expected_findings(root=FIXTURES):
    expected = collections.Counter()
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path) as f:
                for lineno, line in enumerate(f, start=1):
                    m = EXPECT_RE.search(line)
                    if not m:
                        continue
                    for rule in m.group(1).split(","):
                        expected[(rel, lineno, rule.strip())] += 1
    return expected


@pytest.fixture(scope="module")
def fixture_result():
    return run_lint(FIXTURES)


def test_fixture_findings_match_annotations_exactly(fixture_result):
    actual = collections.Counter(
        (f.path, f.line, f.rule) for f in fixture_result.findings
    )
    expected = _expected_findings()
    assert expected, "fixture annotations went missing"
    missing = expected - actual
    surplus = actual - expected
    assert not missing and not surplus, (
        f"missing findings: {sorted(missing)}\n"
        f"unexpected findings: {sorted(surplus)}"
    )


def test_every_rule_has_a_seeded_fixture_violation():
    rules_seeded = {rule for _, _, rule in _expected_findings()}
    assert rules_seeded == ALL_RULES


def test_suppressed_fixture_reports_nothing(fixture_result):
    assert not any("suppressed" in f.path for f in fixture_result.findings)


def test_translated_rules_see_the_torch_constructs(fixture_result):
    """The region scanner reaches a helper in another module, an
    override handed to a transform as ``self.forward_pixel`` and a
    method it calls, and keeps a launch site's host options out."""
    by_path = collections.defaultdict(set)
    for f in fixture_result.findings:
        if f.rule == "host-transfer-in-jit":
            by_path[f.path].add(f.line)
    assert by_path["kafka_tpu_torch/obsops/bad_helpers.py"] == {9}
    assert by_path["kafka_tpu_torch/obsops/bad_operator.py"] == {11, 14}
    assert 11 not in by_path["kafka_tpu_torch/core/bad_launch.py"]


# ---------------------------------------------------------------------------
# The rules kept as they are, against the JAX linter on its own fixtures.
# ---------------------------------------------------------------------------

def test_kept_rules_match_the_jax_linter_on_its_fixtures(tmp_path):
    from tools.kafkalint.core import run_lint as jax_run_lint

    shutil.copytree(os.path.join(JAX_FIXTURES, "kafka_tpu"),
                    tmp_path / "kafka_tpu_torch")
    theirs = jax_run_lint(JAX_FIXTURES, rule_names=sorted(KEPT_RULES))
    ours = run_lint(str(tmp_path), rule_names=sorted(KEPT_RULES))
    want = collections.Counter(
        (f.rule, "kafka_tpu_torch/" + f.path[len("kafka_tpu/"):], f.line)
        for f in theirs.findings)
    got = collections.Counter((f.rule, f.path, f.line)
                              for f in ours.findings)
    assert want and got == want
    assert {r for r, _, _ in got} == KEPT_RULES


# ---------------------------------------------------------------------------
# Suppression mechanics in isolation.
# ---------------------------------------------------------------------------

def _write_tree(tmp_path, name, body):
    """One module under the port's ``tools/`` (as ``tests/test_lint.py``
    writes under ``tools/``: out of the telemetry rules' scan, so a tree
    without registrations is not a finding)."""
    pkg = tmp_path / "kafka_tpu_torch" / "tools"
    pkg.mkdir(parents=True, exist_ok=True)
    (pkg / name).write_text(textwrap.dedent(body))


def test_trailing_suppression_silences_only_its_line(tmp_path):
    _write_tree(tmp_path, "s.py", """\
        def f(fn):
            try:
                fn()
            except Exception:  # kafkalint: disable=bare-except
                pass
            try:
                fn()
            except Exception:
                pass
        """)
    result = run_lint(str(tmp_path))
    assert [f.line for f in result.findings] == [8]
    assert result.findings[0].rule == "bare-except"


def test_disable_all_and_comment_block_form(tmp_path):
    _write_tree(tmp_path, "s.py", """\
        def f(fn):
            try:
                fn()
            # the teardown is best-effort by design
            # kafkalint: disable=all
            except Exception:
                pass
        """)
    assert run_lint(str(tmp_path)).findings == []


# ---------------------------------------------------------------------------
# Baseline: grandfather, then age out.
# ---------------------------------------------------------------------------

_VIOLATION = """\
    def f(fn):
        try:
            fn()
        except Exception:
            pass
    """


def _write_baseline(tmp_path, entries):
    bl_dir = tmp_path / "kafka_tpu_torch" / "tools" / "kafkalint"
    bl_dir.mkdir(parents=True, exist_ok=True)
    (bl_dir / "baseline.json").write_text(json.dumps(entries))


def test_baseline_grandfathers_matching_finding(tmp_path):
    _write_tree(tmp_path, "legacy.py", _VIOLATION)
    _write_baseline(tmp_path, [{
        "rule": "bare-except", "path": "kafka_tpu_torch/tools/legacy.py",
        "contains": "swallows the error",
        "reason": "pre-kafkalint code, tracked for cleanup",
    }])
    result = run_lint(str(tmp_path))
    assert result.findings == []
    assert result.baseline_entries == 1
    assert result.baseline_matched == 1


def test_stale_baseline_entry_is_a_finding(tmp_path):
    _write_tree(tmp_path, "clean.py", "X = 1\n")
    _write_baseline(tmp_path, [{
        "rule": "bare-except", "path": "kafka_tpu_torch/tools/gone.py",
        "contains": "", "reason": "file was deleted",
    }])
    result = run_lint(str(tmp_path))
    assert [f.rule for f in result.findings] == ["stale-baseline"]
    assert "kafka_tpu_torch/tools/gone.py" in result.findings[0].message


def test_baseline_update_regenerates_and_grandfathers(tmp_path, capsys):
    _write_tree(tmp_path, "legacy.py", _VIOLATION)
    assert cli.main([str(tmp_path)]) == 1  # dirty before
    capsys.readouterr()
    assert cli.main([str(tmp_path), "--baseline-update"]) == 0
    out = capsys.readouterr().out
    assert "wrote 1 baseline entry" in out
    bl_path = tmp_path / "kafka_tpu_torch" / "tools" / "kafkalint" / \
        "baseline.json"
    entries = json.loads(bl_path.read_text())
    assert [
        (e["rule"], e["path"]) for e in entries
    ] == [("bare-except", "kafka_tpu_torch/tools/legacy.py")]
    assert all(e["contains"] and e["reason"] for e in entries)
    # the regenerated baseline grandfathers the finding...
    capsys.readouterr()
    assert cli.main([str(tmp_path)]) == 0
    # ...and stale semantics are unchanged: fix the code, entry goes
    # stale and is itself a finding.
    _write_tree(tmp_path, "legacy.py", "X = 1\n")
    result = run_lint(str(tmp_path))
    assert [f.rule for f in result.findings] == ["stale-baseline"]


def test_baseline_update_on_clean_tree_writes_empty_list(tmp_path, capsys):
    _write_tree(tmp_path, "ok.py", "X = 1\n")
    assert cli.main([str(tmp_path), "--baseline-update"]) == 0
    bl_path = tmp_path / "kafka_tpu_torch" / "tools" / "kafkalint" / \
        "baseline.json"
    assert json.loads(bl_path.read_text()) == []


def test_no_baseline_flag_ignores_baseline(tmp_path):
    _write_tree(tmp_path, "legacy.py", _VIOLATION)
    _write_baseline(tmp_path, [{
        "rule": "bare-except", "path": "kafka_tpu_torch/tools/legacy.py",
        "contains": "", "reason": "grandfathered",
    }])
    result = run_lint(str(tmp_path), use_baseline=False)
    assert [f.rule for f in result.findings] == ["bare-except"]
    assert cli.main([str(tmp_path), "--no-baseline"]) == 1


# ---------------------------------------------------------------------------
# CLI: --json schema and exit codes.
# ---------------------------------------------------------------------------

def test_json_output_schema(capsys):
    rc = cli.main([FIXTURES, "--json"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["version"] == 1
    assert payload["root"] == os.path.abspath(FIXTURES)
    assert payload["files_scanned"] == 26
    assert set(payload["rules"]) == ALL_RULES
    assert isinstance(payload["findings"], list) and payload["findings"]
    for f in payload["findings"]:
        assert set(f) == {"rule", "path", "line", "message"}
        assert isinstance(f["line"], int) and f["line"] > 0
    bl = payload["baseline"]
    assert set(bl) == {"path", "entries", "matched"}
    assert bl["path"] is None  # fixtures carry no baseline file


def test_json_output_clean_tree(tmp_path, capsys):
    _write_tree(tmp_path, "ok.py", "X = 1\n")
    rc = cli.main([str(tmp_path), "--json"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == []


def test_rules_subset_and_unknown_rule(tmp_path, capsys):
    _write_tree(tmp_path, "legacy.py", _VIOLATION)
    assert cli.main([str(tmp_path), "--rules", "implicit-f64"]) == 0
    capsys.readouterr()
    assert cli.main([str(tmp_path), "--rules", "no-such-rule"]) == 2
    assert "unknown rule" in capsys.readouterr().err
    assert cli.main([str(tmp_path / "nope")]) == 2


def test_list_rules_names_every_jax_rule_but_the_dropped_one(capsys):
    from tools.kafkalint.core import REGISTRY as JAX_REGISTRY
    from tools.kafkalint.core import make_rules as jax_make_rules

    jax_make_rules()
    assert cli.main(["--list-rules"]) == 0
    listed = {line.split(":")[0]
              for line in capsys.readouterr().out.splitlines()}
    assert listed == ALL_RULES
    assert set(JAX_REGISTRY) - listed == {"static-arg-flag"}


def test_parse_error_is_reported(tmp_path):
    _write_tree(tmp_path, "broken.py", "def f(:\n")
    result = run_lint(str(tmp_path))
    assert [f.rule for f in result.findings] == ["parse-error"]


def test_default_root_is_this_checkout():
    assert os.path.samefile(cli._default_root(), REPO_ROOT)
    assert core.BASELINE_RELPATH == os.path.join(
        "kafka_tpu_torch", "tools", "kafkalint", "baseline.json")
