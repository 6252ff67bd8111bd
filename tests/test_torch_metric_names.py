"""The port's telemetry-name lint (``kafka_tpu_torch/tools/
check_metric_names.py``), the counterpart of ``tests/test_metric_names.py``:
the metric-name convention is enforced statically over
``kafka_tpu_torch/`` and ``chip_smoke.py``, so a rename or a duplicate
breaks the suite, not the dashboards scraping metrics.prom — and the
port registers the JAX package's names, with their kinds."""

import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from kafka_tpu_torch.tools import check_metric_names as checker  # noqa: E402


def _tree(tmp_path, files):
    pkg = tmp_path / "kafka_tpu_torch"
    pkg.mkdir()
    for name, text in files.items():
        (pkg / name).write_text(text)
    (tmp_path / "chip_smoke.py").write_text("")
    return str(tmp_path)


def test_repo_metric_names_are_clean():
    errors = checker.check(REPO_ROOT)
    assert errors == [], "\n".join(errors)


def test_every_registration_found():
    """The scanner must actually see the port's registrations — an
    empty scan (regex rot, moved files) must fail, not silently pass."""
    regs = checker.collect_registrations(REPO_ROOT)
    subsystems = {name.split("_")[1] for name in regs}
    assert {"engine", "prefetch", "shard", "io", "health"} <= subsystems


#: the port's registrations with no JAX counterpart: the row loop's
#: linearisation routes and the GP bank's row-kernel launches (the JAX
#: package has no PROSAIL or GP row kernel).
PORT_ONLY = {("kafka_rowloop_linearizations_total", "counter"),
             ("kafka_gp_rows_launches_total", "counter")}


def test_the_port_and_the_jax_package_register_the_same_names():
    """The two collectors find the same names with the same kinds on
    their packages (95 today, the router's nine included), the port
    besides them only ``PORT_ONLY``."""
    from tools.kafkalint import rules_telemetry as jax_rules

    def kinds(regs, prefix):
        return {(name, kind) for name, sites in regs.items()
                for path, _, kind in sites
                if path.replace(os.sep, "/").startswith(prefix)}

    ours = kinds(checker.collect_registrations(REPO_ROOT),
                 "kafka_tpu_torch/")
    theirs = kinds(jax_rules.collect_registrations(REPO_ROOT), "kafka_tpu/")
    assert ours == theirs | PORT_ONLY
    assert len({name for name, _ in theirs}) == 95


def test_checker_flags_violations(tmp_path):
    root = _tree(tmp_path, {
        "a.py": 'reg.counter("kafka_engine_dup_total")\n'
                'reg.gauge("badName")\n',
        "b.py": 'reg.counter("kafka_engine_dup_total")\n',
    })
    text = "\n".join(checker.check(root))
    assert "badName" in text
    assert "kafka_engine_dup_total" in text and "2 sites" in text


def test_checker_flags_empty_scan(tmp_path):
    root = _tree(tmp_path, {})
    errors = checker.check(root)
    assert errors and "no metric registrations" in errors[0]
    assert checker.main([root]) == 1


def test_event_and_phase_names_collected():
    """The scanners must see the port's emit()/span() vocabulary (regex
    rot would silently lint nothing)."""
    events = checker.collect_names(REPO_ROOT, checker.EMIT_RE)
    phases = checker.collect_names(REPO_ROOT, checker.SPAN_RE)
    assert {"solve", "phase", "run_done", "chunk_done",
            "health_probe"} <= set(events)
    assert {"advance", "assimilate", "dump", "fused_scan"} <= set(phases)


def test_checker_flags_event_casing_and_near_duplicates(tmp_path):
    root = _tree(tmp_path, {
        "a.py": 'reg.emit("chunkDone", n=1)\n'
                'reg.emit("chunk_done", n=1)\n'
                'with span("advance"):\n    pass\n',
        "b.py": 'reg.counter("kafka_engine_ok_total")\n'
                'with span("Fused_Scan"):\n    pass\n',
    })
    text = "\n".join(checker.check(root))
    assert "'chunkDone'" in text and "not lower_snake_case" in text
    assert "'Fused_Scan'" in text
    assert "near-duplicate" in text and "chunk_done" in text


def test_checker_flags_event_phase_name_collision(tmp_path):
    root = _tree(tmp_path, {
        "a.py": 'reg.counter("kafka_engine_ok_total")\n'
                'reg.emit("dump", n=1)\n'
                'with span("dump"):\n    pass\n',
    })
    text = "\n".join(checker.check(root))
    assert "both an event and a span phase" in text


def test_exact_duplicates_across_sites_allowed(tmp_path):
    """run_done is legitimately emitted by each driver and span('dump')
    by both engine paths — same-literal reuse is NOT an error; the
    operator tools under ``kafka_tpu_torch/tools/`` are out of the
    scan."""
    root = _tree(tmp_path, {
        "a.py": 'reg.counter("kafka_engine_ok_total")\n'
                'reg.emit("run_done", n=1)\n'
                'with span("dump"):\n    pass\n',
        "b.py": 'reg.emit("run_done", n=2)\n'
                'with span("dump"):\n    pass\n',
    })
    tools = tmp_path / "kafka_tpu_torch" / "tools"
    tools.mkdir()
    (tools / "c.py").write_text('reg.gauge("notAMetricName")\n')
    assert checker.check(root) == []


def test_checker_main_exits_zero_on_repo(capsys):
    assert checker.main([REPO_ROOT]) == 0
    assert "97 metric names OK" in capsys.readouterr().out
