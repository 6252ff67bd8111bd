"""The row loop's GP emulator bank linearisation (``core/gp_rows.py``,
``csrc/gp_rows.cu``) on the CPU.

- The wrapper's plain version, the closed form, against ``linearize`` and
  ``jac_to_rows`` (``torch.func``), against the benchmark's float64
  reference (``benchmark/reference/gp.py``) and against the JAX package's
  ``GPBankOperator``: a (p, bands, m) = (10, 10, 40) bank and the mapped
  7-parameter, 2-band bank, with and without blocks.
- The kernel's arithmetic, compiled as host C++ from the same source,
  against the plain version: both banks, a bank whose training set
  spans two tiles, and every input count 1-16.
- The row loop takes the route for ``GPBankOperator`` (a spy and the
  ``kafka_rowloop_linearizations_total`` counter), keeping the
  ``torch.func`` route's trips and verdicts, and one small GP-bank job
  through ``KalmanFilter.run`` (the benchmark's ``s2_gp_bank`` scenario
  at a tiny size) matches the float64 reference filter.
- The wrapper refuses what the kernel does not take; its C entry takes
  every pointer and the stream as ``c_void_p``.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kafka_tpu_torch.core import _build
from kafka_tpu_torch.core import gp_rows as gr
from kafka_tpu_torch.core import solvers
from kafka_tpu_torch.core.fused_update import jac_to_rows
from kafka_tpu_torch.obsops import NIR_MAPPER, VIS_MAPPER
from kafka_tpu_torch.obsops import gp
from kafka_tpu_torch.telemetry import MetricsRegistry, use

CPU = torch.device("cpu")
COUNTER = "kafka_rowloop_linearizations_total"
#: float32 sums of two routes: values and Jacobian entries (of the
#: largest entry's magnitude).
VAL_ATOL, JAC_RTOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: beside other test
    processes on the same cores, the fits' and the row loop's small
    threaded ops wait on each other's threads (the tiny job took over
    600 s in each of six such processes, 19 s with one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bank(kind, seed=0, m=40, k=None):
    """``(op, bank)``: ``full`` a (10, 10, m) bank of an unmapped state,
    ``mapped`` the 7-parameter, 2-band bank of
    ``test_gp_bank_emulates_twostream``'s mappers, ``inputs`` a 2-band
    bank of ``k`` inputs mapped from a 16-entry state."""
    rng = np.random.default_rng(seed)
    if kind == "full":
        p, nb, k, maps = 10, 10, 10, None
    elif kind == "mapped":
        p, nb, k = 7, 2, 4
        maps = np.stack([VIS_MAPPER, NIR_MAPPER])
    else:
        p, nb = 16, 2
        maps = np.stack([rng.permutation(p)[:k] for _ in range(nb)])
    x = rng.uniform(0.1, 0.9, (nb, m, k)).astype(np.float32)
    y = np.sin(x @ rng.normal(size=k)) + 0.1 * (x ** 2).sum(-1)
    bank = gp.fit_gp(x, y, lengthscales=np.full(k, 0.5, np.float32),
                     noise=1e-4, device=CPU)
    return gp.GPBankOperator(p, nb, maps), bank


def _states(p, n, seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.05, 0.95, (p, n))
                           .astype(np.float32))


def _close(a, b, atol):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a.double() - b.double()).abs().max()) <= atol * max(
        scale, 1.0)


@pytest.mark.parametrize("kind", ["full", "mapped"])
@pytest.mark.parametrize("block", [None, 333])
def test_plain_version_is_linearize_then_jac_to_rows(kind, block):
    op, bank = _bank(kind)
    x_rows = _states(op.n_params, 1000)
    h0, jac = op.linearize_rows(bank, x_rows, linearize_block=block)
    lin = op.linearize(bank, x_rows.T)
    assert h0.shape == (op.n_bands, 1000) and h0.dtype == torch.float32
    assert jac.shape == (op.n_bands * op.n_params, 1000)
    assert jac.is_contiguous()
    assert _close(h0, lin.h0, VAL_ATOL)
    assert _close(jac, jac_to_rows(lin.jac), JAC_RTOL)


@pytest.mark.parametrize("kind", ["full", "mapped"])
def test_plain_version_held_to_the_float64_reference(kind):
    from benchmark.reference import gp as rg

    op, bank = _bank(kind, seed=2)
    x_rows = _states(op.n_params, 700, seed=3)
    h0, jac = op.linearize_rows(bank, x_rows)
    h_r, j_r = rg.jacobian(bank, x_rows.T.double(), op.mappers)
    assert _close(h0, h_r.T, VAL_ATOL)
    assert _close(jac, j_r.permute(1, 2, 0).reshape(-1, 700), JAC_RTOL)
    # The float64 plain version is the reference's closed form.
    h64, j64 = gr.linearize_rows_plain(op, bank, x_rows.double(),
                                       dtype=torch.float64)
    assert _close(h64, h_r.T, 1e-12)
    assert _close(j64, j_r.permute(1, 2, 0).reshape(-1, 700), 1e-12)


@pytest.mark.parametrize("kind", ["full", "mapped"])
def test_plain_version_matches_the_jax_bank(kind):
    import jax.numpy as jnp

    from kafka_tpu.obsops import gp as jgp
    from kafka_tpu_torch import convert

    op, bank = _bank(kind, seed=4)
    jbank = jgp.GPParams(*(jnp.asarray(leaf.numpy()) for leaf in bank))
    jop = jgp.GPBankOperator(op.n_params, op.n_bands, op.mappers)
    x_rows = _states(op.n_params, 300, seed=5)
    jl = jop.linearize(jbank, jnp.asarray(x_rows.T.numpy()))
    h0, jac = op.linearize_rows(convert.gp_params(jbank, CPU), x_rows)
    np.testing.assert_allclose(h0.numpy(), np.asarray(jl.h0), atol=1e-5)
    np.testing.assert_allclose(
        jac.numpy(), np.asarray(jl.jac).transpose(0, 2, 1)
        .reshape(-1, 300), atol=1e-4)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/gp_rows.cu built as host C++ (its kafka_gp_rows_host
    entry)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host build of the kernel source needs it")
    lib_path = tmp_path_factory.mktemp("gp_rows") / "libhost.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x",
                    "c++", str(_build.CSRC / "gp_rows.cu"), "-o",
                    str(lib_path)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).kafka_gp_rows_host
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong])

    def run(op, bank, x_rows):
        bank, bands, m, k = gr.check_inputs(op, bank, x_rows)
        p, n = x_rows.shape
        table = np.ascontiguousarray(gr.mapper_table(op, k))
        h0, jac = torch.empty((bands, n)), torch.empty((bands * p, n))
        rc = fn(x_rows.data_ptr(), p, bank.x_train.data_ptr(),
                bank.alpha.data_ptr(), bank.log_lengthscales.data_ptr(),
                bank.log_amplitude.data_ptr(), bank.y_mean.data_ptr(),
                table.ctypes.data, bands, m, k, h0.data_ptr(),
                jac.data_ptr(), n)
        assert rc == 0
        return h0, jac

    return run


@pytest.mark.parametrize("kind,m", [("full", 40), ("mapped", 60),
                                    ("full", 300)])
def test_kernel_arithmetic_matches_the_plain_version_on_the_host(
        host_kernel, kind, m):
    """The kernel's per-pixel arithmetic (host build; 300 training points
    span two staged tiles) against the plain version: float32 sums in
    another order, against the float64 closed form no further off than
    the plain version, or a float32 floor."""
    op, bank = _bank(kind, seed=6, m=m)
    x_rows = _states(op.n_params, 512, seed=7)
    h_k, j_k = host_kernel(op, bank, x_rows)
    h_p, j_p = gr.linearize_rows_plain(op, bank, x_rows)
    h_r, j_r = gr.linearize_rows_plain(op, bank, x_rows.double(),
                                       dtype=torch.float64)
    for got, plain, ref in ((h_k, h_p, h_r), (j_k, j_p, j_r)):
        scale = max(float(ref.abs().max()), 1.0)
        k_err = float((got.double() - ref).abs().max())
        p_err = float((plain.double() - ref).abs().max())
        assert k_err <= max(2.0 * p_err, 4e-6 * scale), (k_err, p_err)


def test_kernel_takes_every_input_count_on_the_host(host_kernel):
    for k in range(1, 17):
        op, bank = _bank("inputs", seed=k, m=24, k=k)
        x_rows = _states(op.n_params, 64, seed=k)
        h_k, j_k = host_kernel(op, bank, x_rows)
        h_p, j_p = gr.linearize_rows_plain(op, bank, x_rows)
        assert _close(h_k, h_p, 1e-5) and _close(j_k, j_p, 1e-5), k


def _solve(linearize, bands, x0, p0, aux, opts):
    reg = MetricsRegistry()
    with use(reg):
        out = solvers.assimilate_date(linearize, bands, x0, p0, aux, opts,
                                      device="cpu")
    return out, {k: v for k, v in reg.flat().items()
                 if k.startswith(COUNTER)}


@pytest.mark.parametrize("block", [None, 100])
def test_row_loop_takes_the_route_for_the_gp_bank(monkeypatch, block):
    from kafka_tpu_torch.core.types import BandBatch

    op, bank = _bank("full", seed=8)
    n = 256
    rng = np.random.default_rng(9)
    x0 = torch.full((n, 10), 0.5)
    truth = x0 + torch.as_tensor(0.05 * rng.normal(size=(n, 10))
                                 .astype(np.float32))
    y = op.forward(bank, truth)
    bands = BandBatch(y=y, r_inv=torch.full_like(y, 1e3),
                      mask=torch.ones_like(y, dtype=torch.bool))
    p0 = torch.eye(10).expand(n, 10, 10) * 100.0
    opts = {"relaxation": 0.7, "linearize_block": block,
            "state_bounds": (torch.zeros(10), torch.ones(10))}
    calls = []
    real = gr.gp_linearize_rows

    def spy(*args, **kwargs):
        calls.append(tuple(args[2].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(gr, "gp_linearize_rows", spy)
    (x, a, d), counts = _solve(op.linearize, bands, x0, p0, bank, opts)
    trips = int(d.n_iterations)
    assert trips >= 2 and calls == [(10, n)] * trips
    assert counts == {f'{COUNTER}{{route="plain"}}': trips}
    (x_t, a_t, d_t), counts_t = _solve(lambda b, z: op.linearize(b, z),
                                       bands, x0, p0, bank, opts)
    assert counts_t == {f'{COUNTER}{{route="torch_func"}}': trips}
    assert int(d_t.n_iterations) == trips
    assert torch.equal(d.health_verdicts, d_t.health_verdicts)
    assert float((x - x_t).abs().max()) < 1e-4
    assert float(((a - a_t).abs() / a_t.abs().clamp_min(1.0)).max()) < 1e-3


def test_tiny_gp_bank_job_matches_the_float64_reference_filter():
    """The benchmark's s2_gp_bank scenario at a tiny size on the CPU:
    a fitted bank (one geometry, which every acquisition takes: the fit
    of the configuration's eight is most of the time),
    KalmanFilter.run over each of two 16 x 16 chunks, the row loop on
    the plain route, the sampled outputs of every window within the
    cell's limits of the float64 reference filter (the calibration's
    program reading: the harness's own run refuses a process that holds
    the JAX package, as this suite's does)."""
    from benchmark import calibrate

    over = {"config": {"chunk": [16, 16], "n_chunks": 2,
                       "emulators": {"training_points": 100,
                                     "fit_steps": 100, "holdout": 200,
                                     "sza": [25.0], "vza": [5.0],
                                     "raa": [0.0]}},
            "workload": {"sample_pixels": 128}}
    reg = MetricsRegistry()
    with use(reg):
        r = calibrate.program_reading("s2_gp_bank.july_chunks",
                                      2 ** 31 + 17, CPU, over)
    assert r["limits_pass"] and r["failed"] == 0 and r["windows"] == 8
    routes = {k: v for k, v in reg.flat().items() if k.startswith(COUNTER)}
    assert set(routes) == {f'{COUNTER}{{route="plain"}}'}


@pytest.mark.parametrize("bad", ["bands", "inputs", "mapper", "p",
                                 "float64", "noncontiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    op, bank = _bank("mapped", seed=10)
    x_rows = _states(7, 64)
    if bad == "bands":
        op.n_bands = 3
    elif bad == "inputs":
        op.mappers = np.zeros((2, 17), int)
        bank = bank._replace(x_train=torch.zeros((2, 60, 17)),
                             log_lengthscales=torch.zeros((2, 17)))
    elif bad == "mapper":
        op.mappers = np.array([[0, 1, 2, 7], [0, 1, 2, 3]])
    elif bad == "p":
        x_rows = x_rows[:6].contiguous()
    elif bad == "float64":
        x_rows = x_rows.double()
    else:
        x_rows = x_rows.T.contiguous().T
    with pytest.raises((ValueError, TypeError)):
        gr.gp_linearize_rows(op, bank, x_rows)


def test_kernel_source_is_built_with_the_others():
    assert "gp_rows" in _build.KERNEL_SOURCES
    assert (_build.CSRC / "gp_rows.cu").is_file()
    assert "gp_rows" not in _build.SOURCE_FLAGS
    assert "--use_fast_math" not in _build._flags("gp_rows")


def test_c_entry_takes_pointers_and_the_stream_as_void_pointers(
        monkeypatch):
    """The launch's ctypes signature against the C declaration: every
    pointer and the stream c_void_p, the sizes c_int, n c_longlong; one
    launch counted, with the registry's counter."""
    text = (_build.CSRC / "gp_rows.cu").read_text()
    decl = re.search(r"int kafka_gp_rows\(([^)]*)\)", text).group(1)
    params = [" ".join(p.split()) for p in decl.split(",")]

    class Fn:
        def __call__(self, *args):
            self.args = args
            return 0

    class Lib:
        kafka_gp_rows = Fn()

    lib = Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: __import__("contextlib")
                        .nullcontext(0))
    op, bank = _bank("mapped", seed=11)
    launches = gr.gp_linearize_rows.launches
    reg = MetricsRegistry()
    with use(reg):
        h0, jac = gr._launch_cuda(op, bank, _states(7, 128))
    assert h0.shape == (2, 128) and jac.shape == (14, 128)
    assert gr.gp_linearize_rows.launches == launches + 1
    assert reg.flat()["kafka_gp_rows_launches_total"] == 1
    kinds = lib.kafka_gp_rows.argtypes
    assert len(kinds) == len(params) == 15
    for p, kind in zip(params, kinds):
        if "*" in p:
            assert kind is ctypes.c_void_p, p
        elif p.startswith("int "):
            assert kind is ctypes.c_int, p
        else:
            assert p.startswith("long long ") and kind is ctypes.c_longlong
    assert params[-1] == "void* stream"
    assert lib.kafka_gp_rows.args[8:11] == (2, 40, 4)
