"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``kafka_tpu_torch`` is the program, not
``kafka_tpu``), and the plain references load nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests.tiny import CELLS, SEED, TINY

ROOT = Path(harness.__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kafka_tpu"}

RUN = """
import json, sys
from benchmark.harness import run_cell
r = run_cell(sys.argv[1], int(sys.argv[2]), 0.0, False, device="cpu",
             overrides=json.loads(sys.argv[3]))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_cells_run_loads_no_jax(name):
    out = subprocess.run(
        [sys.executable, "-c", RUN, name, str(SEED), json.dumps(TINY[name])],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "kafka_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_harness_refuses_a_run_that_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


@pytest.fixture
def stub_jax(tmp_path, monkeypatch):
    """A module named ``jax`` on the path, unloaded again afterwards."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("STUB = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    yield
    for m in [m for m in sys.modules if m.split(".")[0] == "jax"]:
        del sys.modules[m]


def test_a_metric_reader_that_loads_jax_refuses_the_run(stub_jax,
                                                        monkeypatch):
    """The look comes after the metric readers: a traced run whose
    reader imports ``jax`` gives no result."""
    name = CELLS[0]
    real = harness.metric_reader
    read_jax = []

    def reader(metric, here=harness.HERE):
        read = real(metric, here)

        def loads_jax(run):
            import jax  # noqa: F401

            read_jax.append(metric)
            return read(run)
        return loads_jax

    monkeypatch.setattr(harness, "metric_reader", reader)
    with pytest.raises(harness.ForbiddenModules, match="jax"):
        harness.run_cell(name, SEED, 0.0, True, device="cpu",
                         overrides=TINY[name])
    assert read_jax


def test_run_exits_without_a_result_when_jax_is_loaded(monkeypatch,
                                                       capsys):
    from benchmark import run

    def refused(*args, **kwargs):
        raise harness.ForbiddenModules("modules of the JAX stack are "
                                       "loaded: ['jax']")

    monkeypatch.setattr(harness, "run_cell", refused)
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                   "--seconds", "1", "--trace", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err


def test_the_references_load_nothing_of_the_program():
    ref = ROOT / "benchmark" / "reference"
    for path in ref.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "kafka_tpu_torch"}, (path.name, n)
    code = ("import sys, benchmark.reference.filter, "
            "benchmark.reference.twostream, benchmark.reference.prosail; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"kafka_tpu_torch"})
