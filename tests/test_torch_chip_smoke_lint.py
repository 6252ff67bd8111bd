"""Phase ``lint`` of ``chip_smoke.py`` rehearsed on the CPU (it runs no
kernel): both source lints as ``python -m`` children through
``tool_child``, gated on rc 0, no finding, every baseline entry matched
and no JAX module in either process — on a clean tree it passes and
records the counts, on the seeded fixture tree it fails naming the
findings."""

import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402

FIXTURES = os.path.join(REPO_ROOT, "tests", "torch_lint_fixtures")


def test_phase_lint_passes_a_clean_tree_and_records_the_counts(
        tmp_path, capsys):
    tel = tmp_path / "kafka_tpu_torch" / "telemetry"
    tel.mkdir(parents=True)
    (tel / "a.py").write_text(
        'def setup(reg):\n    reg.counter("kafka_engine_ok_total")\n')
    rec = chip_smoke.phase_lint(str(tmp_path))
    assert rec["findings"] == 0 and rec["files_scanned"] == 1
    assert rec["rules"] == 21 and rec["metric_names"] == 1
    assert rec["baseline_entries"] == rec["baseline_matched"] == 0
    assert rec["rc"] == {"kafkalint": 0, "check_metric_names": 0}
    assert rec["processes_without_jax"] and not rec["failures"]
    assert '"phase": "lint"' in capsys.readouterr().out


def test_phase_lint_fails_on_the_seeded_fixture_tree(capsys):
    with pytest.raises(AssertionError) as info:
        chip_smoke.phase_lint(FIXTURES)
    text = str(info.value)
    assert "kafkalint: rc 1" in text and "check_metric_names: rc 1" in text
    assert "[host-transfer-in-jit]" in text
    assert '"findings": 85' in capsys.readouterr().out
