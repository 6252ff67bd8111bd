"""The port stands alone: no JAX and nothing of kafka_tpu in the package
or in chip_smoke.py, entry points that refuse to run without CUDA unless
asked for the CPU, and a CUDA build that fails loudly."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "kafka_tpu_torch"


def _sources():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    return files


def test_import_leaves_jax_and_kafka_tpu_out():
    code = (
        "import sys, kafka_tpu_torch, kafka_tpu_torch.engine, "
        "kafka_tpu_torch.convert, kafka_tpu_torch.testing.synthetic, "
        "kafka_tpu_torch.core.solvers, kafka_tpu_torch.core.fused_update, "
        "kafka_tpu_torch.core.solve_rows, kafka_tpu_torch.obsops.prosail, "
        "kafka_tpu_torch.obsops.prospect_data, "
        "kafka_tpu_torch.core.propagators, kafka_tpu_torch.core.linalg, "
        "kafka_tpu_torch.engine.filter, kafka_tpu_torch.engine.checkpoint, "
        "kafka_tpu_torch.engine.prefetch, kafka_tpu_torch.io, "
        "kafka_tpu_torch.io.geotiff, kafka_tpu_torch.io.output, "
        "kafka_tpu_torch.io.native_codec, kafka_tpu_torch.native, "
        "kafka_tpu_torch.resilience, kafka_tpu_torch.resilience.faults, "
        "kafka_tpu_torch.resilience.policy, kafka_tpu_torch.telemetry, "
        "kafka_tpu_torch.telemetry.registry, "
        "kafka_tpu_torch.telemetry.tracing, "
        "kafka_tpu_torch.telemetry.spans, kafka_tpu_torch.testing.fixtures, "
        "kafka_tpu_torch.obsops.identity, kafka_tpu_torch.cli, "
        "kafka_tpu_torch.cli.run_synthetic, kafka_tpu_torch.core, "
        "kafka_tpu_torch.core.types, kafka_tpu_torch.engine.priors, "
        "kafka_tpu_torch.obsops, kafka_tpu_torch.obsops.wcm, "
        "kafka_tpu_torch.obsops.joint, kafka_tpu_torch.obsops.gp, "
        "kafka_tpu_torch.obsops.gp_import, kafka_tpu_torch.obsops.mlp, "
        "kafka_tpu_torch.obsops.protocol, kafka_tpu_torch.io.multi, "
        "kafka_tpu_torch.testing, kafka_tpu_torch.io.tiling, "
        "kafka_tpu_torch.io.warp, kafka_tpu_torch.io.roi, "
        "kafka_tpu_torch.io.sentinel2, kafka_tpu_torch.io.modis, "
        "kafka_tpu_torch.io.sentinel1, kafka_tpu_torch.engine.config, "
        "kafka_tpu_torch.shard, kafka_tpu_torch.shard.scheduler, "
        "kafka_tpu_torch.cli.drivers, kafka_tpu_torch.cli.run_s2, "
        "kafka_tpu_torch.cli.run_modis, kafka_tpu_torch.cli.run_s1, "
        "kafka_tpu_torch.cli.run_joint, kafka_tpu_torch.cli.mosaic, "
        "kafka_tpu_torch.cli.import_emulators, kafka_tpu_torch.core.hessian, "
        "kafka_tpu_torch.obsops.kernels, kafka_tpu_torch.io.mod09, "
        "kafka_tpu_torch.cli.run_mod09, kafka_tpu_torch.smoother, "
        "kafka_tpu_torch.smoother.rts_pass, kafka_tpu_torch.serve, "
        "kafka_tpu_torch.analysis, kafka_tpu_torch.analysis.programs, "
        "kafka_tpu_torch.analysis.checkers, kafka_tpu_torch.analysis.trace, "
        "kafka_tpu_torch.cli.programlint, "
        "kafka_tpu_torch.testing.programlint_fixtures, "
        "kafka_tpu_torch.serve.admission, kafka_tpu_torch.serve.batch, "
        "kafka_tpu_torch.serve.daemon, kafka_tpu_torch.serve.journal, "
        "kafka_tpu_torch.serve.request, kafka_tpu_torch.serve.service, "
        "kafka_tpu_torch.serve.session, kafka_tpu_torch.serve.synthetic, "
        "kafka_tpu_torch.telemetry.quality, kafka_tpu_torch.telemetry.live, "
        "kafka_tpu_torch.telemetry.request_log, "
        "kafka_tpu_torch.cli.kafka_smooth, kafka_tpu_torch.cli.kafka_serve, "
        "kafka_tpu_torch.core.collective, kafka_tpu_torch.shard.mesh, "
        "kafka_tpu_torch.shard.step, kafka_tpu_torch.shard.queue, "
        "kafka_tpu_torch.cli.chunk_worker, "
        "kafka_tpu_torch.cli.run_modis_distributed, "
        "kafka_tpu_torch.testing.multiprocess_worker, "
        "kafka_tpu_torch.telemetry.device, kafka_tpu_torch.telemetry.devprof, "
        "kafka_tpu_torch.telemetry.perf, kafka_tpu_torch.telemetry.compilemon, "
        "kafka_tpu_torch.telemetry.health, kafka_tpu_torch.telemetry.slo, "
        "kafka_tpu_torch.telemetry.aggregate, "
        "kafka_tpu_torch.telemetry.httpd, "
        "kafka_tpu_torch.telemetry.flight_recorder, kafka_tpu_torch.utils, "
        "kafka_tpu_torch.utils.profiling, "
        "kafka_tpu_torch.utils.compilation_cache, "
        "kafka_tpu_torch.serve.router, kafka_tpu_torch.cli.kafka_route, "
        "kafka_tpu_torch.testing.oracle\n"
        "from kafka_tpu_torch import (BandBatch, GaussianState, "
        "Linearization, PixelPrior, iterate_time_grid, tip_prior)\n"
        "from kafka_tpu_torch.core import *\n"
        "from kafka_tpu_torch.core import (flat_to_pixel_major, "
        "pixel_major_to_flat, block_diag_to_batched, blend_gaussians, "
        "linear_solve, build_normal_equations, hessian_correction)\n"
        "from kafka_tpu_torch.io import (read_info, read_geotiff_window, "
        "TiledTiffWriter, TiffInfo, CompositeObservations, "
        "BHRObservations, SynergyKernels, S1Observations, "
        "Sentinel2Observations, find_nearest_geometry, "
        "geometry_bank_aux_builder, parse_s2_xml, Chunk, "
        "chunk_geotransform, chunk_mask, get_chunks, from_lonlat, "
        "grid_mapping, lonlat_to_utm, reproject_raster, resample, "
        "to_lonlat, utm_to_lonlat, MOD09Observations, decode_state_qa, "
        "zoom2_nearest)\n"
        "from kafka_tpu_torch.testing.fixtures import (make_s2_granule_tree, "
        "make_mcd43_series, make_s1_series, make_synergy_series, "
        "make_mod09_granules)\n"
        "from kafka_tpu_torch.testing import (SyntheticObservations, "
        "MemoryOutput, make_tip_problem, make_prosail_problem, "
        "run_tip_engine, run_s2_engine, s2_observations, "
        "joint_observations)\n"
        "from kafka_tpu_torch.obsops import (WCMOperator, WCMAux, "
        "ProsailJointOperator, WCMJointOperator, GPBankOperator, "
        "MLPOperator, BandView, MappedStateModel, KernelsOperator, "
        "KernelsAux, ross_li_kernels)\n"
        "from kafka_tpu_torch.engine import (kernels_prior, "
        "KERNEL_PARAMETER_LIST)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kafka_tpu' or m.startswith('kafka_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_kafka_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "kafka_tpu"), \
                f"{path.name}:{node.lineno} imports {name}"


def _entry_points():
    from kafka_tpu_torch import resolve_device
    from kafka_tpu_torch.core.fused_gn import fused_gn_rows
    from kafka_tpu_torch.core.propagators import tip_prior
    from kafka_tpu_torch.core.solvers import assimilate_date
    from kafka_tpu_torch.cli import run_synthetic
    from kafka_tpu_torch.core.types import BandBatch
    from kafka_tpu_torch.engine import KalmanFilter, jrc_prior, sail_prior
    from kafka_tpu_torch.engine import joint_prior, kernels_prior, wcm_prior
    from kafka_tpu_torch.obsops import TwoStreamOperator, fit_gp, fit_mlp
    from kafka_tpu_torch.testing.synthetic import (SyntheticObservations,
                                                   joint_observations,
                                                   make_prosail_problem,
                                                   make_tip_problem,
                                                   run_s2_engine,
                                                   run_tip_engine,
                                                   s2_observations)

    from kafka_tpu_torch.cli import (drivers, run_joint, run_mod09,
                                     run_modis, run_s1, run_s2)
    from kafka_tpu_torch.io import (BHRObservations, MOD09Observations,
                                    S1Observations, Sentinel2Observations,
                                    SynergyKernels)
    from kafka_tpu_torch.obsops import KernelsOperator
    from kafka_tpu_torch.cli import kafka_serve, kafka_smooth
    from kafka_tpu_torch.core.solvers import assimilate_date_batch
    from kafka_tpu_torch.serve import make_synthetic_tile
    from kafka_tpu_torch.smoother import smooth_chain
    from kafka_tpu_torch.cli import chunk_worker, run_modis_distributed
    from kafka_tpu_torch.shard import make_pixel_mesh

    op = TwoStreamOperator()
    z = np.zeros((2, 4), np.float32)
    geo = ((0.0, 10.0, 0.0, 0.0, 0.0, -10.0), 32630)
    return {
        "run_s2.main": lambda: run_s2.main(["--outdir", os.devnull]),
        "run_modis.main": lambda: run_modis.main(["--outdir", os.devnull]),
        "run_mod09.main": lambda: run_mod09.main(["--outdir", os.devnull]),
        "MOD09Observations": lambda: MOD09Observations(str(REPO),
                                                       KernelsOperator()),
        "kernels_prior": lambda: kernels_prior(),
        "RunConfig.make_initial_prior kernels":
            lambda: run_mod09.default_config().make_initial_prior(),
        "run_s1.main": lambda: run_s1.main(["--outdir", os.devnull]),
        "run_joint.main": lambda: run_joint.main(
            ["--outdir", os.devnull, "--s1-folder", os.devnull]),
        "run_config": lambda: drivers.run_config(run_s2.default_config()),
        "RunConfig.make_prior": lambda: run_s2.default_config().make_prior(),
        "Sentinel2Observations": lambda: Sentinel2Observations(
            str(REPO), op, geo),
        "BHRObservations": lambda: BHRObservations(str(REPO), op),
        "SynergyKernels": lambda: SynergyKernels(str(REPO), op),
        "S1Observations": lambda: S1Observations(str(REPO), geo),
        "resolve_device": lambda: resolve_device(None),
        "KalmanFilter": lambda: KalmanFilter(None, None, np.ones((2, 2)),
                                             ["a"] * 7),
        "assimilate_date": lambda: assimilate_date(
            op.linearize, BandBatch(z, z, z > 0), np.zeros((4, 7)),
            np.zeros((4, 7, 7))),
        "fused_gn_rows": lambda: fused_gn_rows(
            op.kernel_linearize_rows, *(torch.zeros(r, 4) for r in
                                        (2, 2, 2, 7, 28)),
            1e-3, 2, 25, 1.0, None, 28.0),
        "make_tip_problem": lambda: make_tip_problem(16),
        "make_prosail_problem": lambda: make_prosail_problem(16),
        "run_s2_engine": lambda: run_s2_engine(),
        "s2_observations": lambda: s2_observations([], None),
        "sail_prior": lambda: sail_prior(),
        "run_tip_engine": lambda: run_tip_engine(),
        "jrc_prior": lambda: jrc_prior(),
        "tip_prior": lambda: tip_prior(),
        "SyntheticObservations": lambda: SyntheticObservations([], op, None),
        "run_synthetic.main": lambda: run_synthetic.main(
            ["--operator", "identity", "--ny", "8", "--nx", "8",
             "--outdir", os.devnull]),
        "run_synthetic.build_operator": lambda: run_synthetic.build_operator(
            "twostream", None),
        "run_synthetic.build_operator wcm":
            lambda: run_synthetic.build_operator("wcm", None),
        "wcm_prior": lambda: wcm_prior(),
        "joint_prior": lambda: joint_prior(),
        "joint_observations": lambda: joint_observations([], [], None, 35.0),
        "fit_gp": lambda: fit_gp(np.zeros((4, 2)), np.zeros(4)),
        "fit_mlp": lambda: fit_mlp(lambda a: a, np.zeros((4, 2)), steps=1),
        "smooth_chain": lambda: smooth_chain([]),
        "kafka_smooth.main": lambda: kafka_smooth.main(
            ["--ckpt-dir", os.devnull]),
        "make_synthetic_tile": lambda: make_synthetic_tile("t", os.devnull),
        "kafka_serve.main": lambda: kafka_serve.main(
            ["--root", os.devnull]),
        "make_pixel_mesh": lambda: make_pixel_mesh(),
        "run_modis_distributed.main": lambda: run_modis_distributed.main(
            ["--outdir", os.devnull]),
        "chunk_worker --queue": lambda: chunk_worker.main(
            ["--queue", os.devnull]),
        "run_synthetic.main --queue": lambda: run_synthetic.main(
            ["--chunk-size", "4", "--queue", "--num-workers", "2",
             "--outdir", os.devnull]),
        "assimilate_date_batch": lambda: assimilate_date_batch(
            op.linearize, BandBatch(z[None], z[None], z[None] > 0),
            np.zeros((1, 4, 7)), np.zeros((1, 4, 7, 7))),
    }


@pytest.mark.parametrize("name", sorted(
    ["resolve_device", "KalmanFilter", "assimilate_date", "fused_gn_rows",
     "make_tip_problem", "run_tip_engine", "jrc_prior", "tip_prior",
     "SyntheticObservations", "make_prosail_problem", "run_s2_engine",
     "s2_observations", "sail_prior", "run_synthetic.main",
     "run_synthetic.build_operator", "run_synthetic.build_operator wcm",
     "wcm_prior", "joint_prior", "joint_observations", "fit_gp",
     "fit_mlp", "run_s2.main", "run_modis.main", "run_s1.main",
     "run_joint.main", "run_config", "RunConfig.make_prior",
     "Sentinel2Observations", "BHRObservations", "SynergyKernels",
     "S1Observations", "run_mod09.main", "MOD09Observations",
     "kernels_prior", "RunConfig.make_initial_prior kernels",
     "smooth_chain", "kafka_smooth.main", "make_synthetic_tile",
     "kafka_serve.main", "assimilate_date_batch", "make_pixel_mesh",
     "run_modis_distributed.main", "chunk_worker --queue",
     "run_synthetic.main --queue"]))
def test_entry_points_raise_without_cuda(name, monkeypatch):
    """device=None means CUDA; without a CUDA device it raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


class _CudaStub:
    """Stands for a CUDA tensor: only its device and shape are read
    before the wrapper dispatches."""

    device = torch.device("cuda", 0)

    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("module,wrapper,args", [
    ("fused_update", "fused_update_rows",
     [(20, 4), (2, 4), (2, 4), (2, 4), (2, 4), (7, 4), (7, 4), (28, 4)]),
    ("solve_rows", "solve_rows", [(28, 4), (7, 4)]),
])
def test_kernel_wrappers_send_cuda_tensors_to_the_kernel(monkeypatch, module,
                                                         wrapper, args):
    """A CUDA tensor goes to the kernel launch, never to the plain
    version (which would raise here if reached)."""
    import importlib

    mod = importlib.import_module(f"kafka_tpu_torch.core.{module}")
    seen = []
    monkeypatch.setattr(mod, "_launch_cuda", lambda *a: seen.append(a) or 1)
    plain = "fused_update_raw_plain" if module == "fused_update" \
        else "solve_rows_plain"
    monkeypatch.setattr(mod, plain, lambda *a: pytest.fail("plain ran"))
    assert getattr(mod, wrapper)(*(_CudaStub(*sh) for sh in args)) == 1
    assert len(seen) == 1


def test_explicit_cpu_runs():
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    op, bands, x0, p_inv0 = make_tip_problem(16, device="cpu")
    assert bands.y.device.type == "cpu" and x0.shape == (16, 7)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from kafka_tpu_torch.core import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("fused_gn")
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").rglob("*.so"))


def test_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A failing nvcc raises with its output; nothing is cached."""
    from kafka_tpu_torch.core import _build

    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refuses' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        _build.build("fused_gn")
    assert not any((tmp_path / "build").rglob("*.so"))


def test_build_key_tracks_sources_and_flags(monkeypatch):
    from kafka_tpu_torch.core import _build

    key = _build._source_hash("fused_gn")
    assert key == _build._source_hash("fused_gn")
    assert _build._source_hash("fused_update") != key
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._source_hash("fused_gn") != key
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("name", ["fused_gn", "fused_update", "solve_rows"])
def test_every_kernel_source_exists_with_a_c_interface(name):
    """Each kernel's source is in csrc/ and exports its launch function
    and the error-string helper the wrapper reads on failure."""
    from kafka_tpu_torch.core import _build

    text = (_build.CSRC / f"{name}.cu").read_text()
    assert 'extern "C"' in text and "kafka_cuda_error_string" in text
    assert "cudaGetLastError" in text


def test_build_all_starts_every_build_at_once(monkeypatch):
    """build_all runs one build per source concurrently and returns each
    library path."""
    import threading

    from kafka_tpu_torch.core import _build

    barrier = threading.Barrier(3, timeout=10)

    def fake_build(name):
        barrier.wait()
        return f"lib{name}.so"

    monkeypatch.setattr(_build, "build", fake_build)
    assert _build.build_all(["a", "b", "c"]) == {
        "a": "liba.so", "b": "libb.so", "c": "libc.so"}


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and also when it stands alone in a directory."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
