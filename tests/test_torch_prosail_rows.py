"""The row loop's PROSAIL linearisation route (``core/prosail_rows.py``,
``csrc/prosail_rows.cu``) on the CPU.

- The wrapper's plain version is today's path, bit for bit:
  ``jac_to_rows(op.linearize(aux, x_rows.T))``, with 0-d and per-pixel
  angles, with and without blocks.
- The row loop takes the PROSAIL route for ``ProsailOperator`` only (a
  spy and the ``kafka_rowloop_linearizations_total`` counter; the GP
  bank takes its own, ``core/gp_rows.py``), and its S2 result keeps the
  bits of the ``torch.func`` path.
- The wrapper refuses what the kernel does not take; the kernel source
  is built with the others and its C entry takes every pointer and the
  stream as ``c_void_p``.
- The kernel's arithmetic, compiled as host C++ from the same source,
  held to the float64 plain version as far as the float32 plain version
  is (``chip_smoke.prosail_rows_case``'s errors, at bulk quantiles).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from kafka_tpu_torch.core import _build
from kafka_tpu_torch.core import prosail_rows as pr
from kafka_tpu_torch.core import solvers
from kafka_tpu_torch.core.fused_update import jac_to_rows
from kafka_tpu_torch.obsops.prosail import ProsailOperator
from kafka_tpu_torch.telemetry import MetricsRegistry, use

CPU = torch.device("cpu")
COUNTER = "kafka_rowloop_linearizations_total"


@pytest.mark.parametrize("case", [0, 3, "per_pixel"])
@pytest.mark.parametrize("block", [None, 1024, 777])
def test_plain_version_is_linearize_then_jac_to_rows(case, block):
    op = ProsailOperator()
    n = 3000
    x_rows = cs.prosail_rows_states(n, CPU, 3)
    aux = cs.prosail_rows_aux(case, n, CPU, 3, torch.float32)
    lin = op.linearize(aux, x_rows.T)
    h0, jac = op.linearize_rows(aux, x_rows, linearize_block=block)
    assert torch.equal(h0, lin.h0)
    assert torch.equal(jac, jac_to_rows(lin.jac))
    assert jac.shape == (100, n) and jac.is_contiguous()


def _counts(reg):
    return {k: v for k, v in reg.flat().items() if k.startswith(COUNTER)}


def _solve(linearize, bands, x0, p_inv0, aux, opts):
    reg = MetricsRegistry()
    with use(reg):
        out = solvers.assimilate_date(linearize, bands, x0, p_inv0, aux,
                                      opts, device="cpu")
    return out, _counts(reg)


def _spy(monkeypatch):
    calls = []
    real = pr.prosail_linearize_rows

    def spy(*args, **kwargs):
        calls.append(args[2].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(pr, "prosail_linearize_rows", spy)
    return calls


@pytest.mark.parametrize("block", [None, 1000])
def test_row_loop_takes_the_route_for_prosail_with_the_same_bits(
        monkeypatch, block):
    from kafka_tpu_torch.testing.synthetic import make_prosail_problem

    op, bands, x0, p0, aux = make_prosail_problem(2500, device="cpu")
    opts = {"relaxation": 0.7, "linearize_block": block}
    calls = _spy(monkeypatch)
    (x, a, d), counts = _solve(op.linearize, bands, x0, p0, aux, opts)
    trips = int(d.n_iterations)
    assert trips >= 2 and calls == [(10, 2500)] * trips
    assert counts == {f'{COUNTER}{{route="plain"}}': trips}

    # The parent's path: a closure hides the operator (torch.func).
    del calls[:]
    (x_t, a_t, d_t), counts_t = _solve(lambda p, z: op.linearize(p, z),
                                       bands, x0, p0, aux, opts)
    assert calls == []
    assert counts_t == {f'{COUNTER}{{route="torch_func"}}': trips}
    assert torch.equal(x, x_t) and torch.equal(a, a_t)
    for field in ("n_iterations", "health_verdicts", "fwd_modelled",
                  "innovations", "convergence_norm", "clip_saturated_count"):
        assert torch.equal(getattr(d, field), getattr(d_t, field)), field


def _random_problem(op, aux, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(v, np.float32) for v in op.state_bounds)
    x0 = torch.as_tensor((lo + (hi - lo) * rng.uniform(0.2, 0.8, (n, lo.size)))
                         .astype(np.float32))
    y = op.forward(aux, x0)
    y = y + 0.01 * torch.as_tensor(rng.normal(size=tuple(y.shape)),
                                   dtype=torch.float32)
    from kafka_tpu_torch.core.types import BandBatch

    bands = BandBatch(y=y, r_inv=torch.full_like(y, 1e4),
                      mask=torch.ones_like(y, dtype=torch.bool))
    p0 = torch.eye(lo.size).expand(n, lo.size, lo.size) * 4.0
    return bands, x0, p0


def _gp_bank():
    from kafka_tpu_torch.obsops import NIR_MAPPER, VIS_MAPPER, gp

    rng = np.random.default_rng(20)
    sub = rng.uniform(0.2, 0.8, (60, 4)).astype(np.float32)
    band = gp.fit_gp(sub, sub.sum(axis=1) / 4.0, noise=1e-4, device=CPU)
    op = gp.GPBankOperator(n_params=7, n_bands=2,
                           state_mappers=np.stack([VIS_MAPPER, NIR_MAPPER]))
    op.state_bounds = (np.zeros(7, np.float32), np.ones(7, np.float32))
    return op, gp.stack_gp_bank([band, band])


def _joint():
    from kafka_tpu_torch.obsops.joint import ProsailJointOperator

    aux = cs.prosail_rows_aux(1, 64, CPU, 0, torch.float32)
    return ProsailJointOperator(), aux


def _band_view():
    from kafka_tpu_torch.obsops.protocol import BandView

    return BandView(ProsailOperator(), 3), cs.prosail_rows_aux(
        2, 64, CPU, 0, torch.float32)


@pytest.mark.parametrize("make,route", [(_joint, "torch_func"),
                                        (_band_view, "torch_func"),
                                        (_gp_bank, "plain")],
                         ids=["joint", "band_view", "gp_bank"])
def test_row_loop_keeps_torch_func_for_other_operators(monkeypatch, make,
                                                       route):
    """Operators without a row linearisation keep ``torch.func``; the GP
    bank takes its own (``core/gp_rows.py``, its plain version on the
    CPU), never the PROSAIL kernel's."""
    op, aux = make()
    assert hasattr(op, "linearize_rows") == (route == "plain")
    bands, x0, p0 = _random_problem(op, aux, 64, 5)
    calls = _spy(monkeypatch)
    (_x, _a, d), counts = _solve(op.linearize, bands, x0, p0, aux,
                                 {"use_pallas": True})
    assert calls == []
    assert counts == {f'{COUNTER}{{route="{route}"}}':
                      int(d.n_iterations)}


def test_row_loop_keeps_torch_func_for_tip_opted_out(monkeypatch):
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    op, bands, x0, p0 = make_tip_problem(256, device="cpu")
    calls = _spy(monkeypatch)
    (_x, _a, d), counts = _solve(op.linearize, bands, x0, p0, None,
                                 {"use_pallas": True,
                                  "inkernel_linearize": False})
    assert calls == []
    assert counts == {f'{COUNTER}{{route="torch_func"}}':
                      int(d.n_iterations)}


def test_route_counter_silent_on_the_fused_gn_route():
    from kafka_tpu_torch.testing.synthetic import make_tip_problem

    op, bands, x0, p0 = make_tip_problem(256, device="cpu")
    _out, counts = _solve(op.linearize, bands, x0, p0, None, None)
    assert counts == {}


@pytest.mark.parametrize("bad", ["p", "bands", "float64", "noncontiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    op = ProsailOperator()
    x_rows = cs.prosail_rows_states(256, CPU, 0)
    aux = cs.prosail_rows_aux(0, 256, CPU, 0, torch.float32)
    if bad == "p":
        x_rows = x_rows[:9].contiguous()
    elif bad == "bands":
        op.n_bands = 9
    elif bad == "float64":
        x_rows = x_rows.double()
    else:
        x_rows = x_rows.T.contiguous().T
    with pytest.raises((ValueError, TypeError)):
        pr.prosail_linearize_rows(op, aux, x_rows)


def test_angles_checked_before_a_launch():
    x = torch.zeros(4)
    steps = pr.angle_steps((x[0], x, x[1]), 4, CPU)
    assert [s for _, s in steps] == [0, 1, 0]
    for aux in ((x[0], x.double(), x[0]), (x[0], torch.zeros(8)[::2], x[0]),
                (x[0], torch.zeros(5), x[0]), (x[0], 1.0, x[0])):
        with pytest.raises((ValueError, TypeError)):
            pr.angle_steps(aux, 4, CPU)


def test_kernel_source_is_built_with_the_others():
    assert "prosail_rows" in _build.KERNEL_SOURCES
    assert (_build.CSRC / "prosail_rows.cu").is_file()
    assert _build.SOURCE_FLAGS["prosail_rows"] == ("-fmad=false",)
    assert "--use_fast_math" not in _build._flags("prosail_rows")


def test_c_entry_takes_pointers_and_the_stream_as_void_pointers(
        monkeypatch):
    """The launch's ctypes signature against the C declaration: every
    pointer and the stream c_void_p, the steps c_int, the hotspot
    c_float, n c_longlong (a pointer passed as a 32-bit int is cut)."""
    text = (_build.CSRC / "prosail_rows.cu").read_text()
    decl = re.search(r"int kafka_prosail_rows\(([^)]*)\)", text).group(1)
    params = [" ".join(p.split()) for p in decl.split(",")]

    class Fn:
        def __call__(self, *args):
            self.args = args
            return 0

    class Lib:
        kafka_prosail_rows = Fn()
        kafka_prosail_rows_constants = Fn()

    lib = Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: __import__("contextlib")
                        .nullcontext(0))
    monkeypatch.setattr(pr, "_CONSTANTS_SET", set())
    op = ProsailOperator()
    x_rows = cs.prosail_rows_states(128, CPU, 0)
    h0, jac = pr._launch_cuda(op, None, x_rows)
    assert h0.shape == (10, 128) and jac.shape == (100, 128)
    kinds = lib.kafka_prosail_rows.argtypes
    assert len(kinds) == len(params) == 12
    for p, kind in zip(params, kinds):
        if "*" in p:
            assert kind is ctypes.c_void_p, p
        elif p.startswith("int "):
            assert kind is ctypes.c_int, p
        elif p.startswith("float "):
            assert kind is ctypes.c_float, p
        else:
            assert p.startswith("long long ") and kind is ctypes.c_longlong
    assert params[-1] == "void* stream"
    assert lib.kafka_prosail_rows_constants.argtypes == [ctypes.c_void_p,
                                                         ctypes.c_int]
    assert lib.kafka_prosail_rows_constants.args[1] == pr.constants().size


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/prosail_rows.cu built as host C++ (its kafka_prosail_rows_host
    entry) with the per-band constants set."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the host build of the kernel source needs it")
    lib_path = tmp_path_factory.mktemp("prosail_rows") / "libhost.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x",
                    "c++", str(_build.CSRC / "prosail_rows.cu"), "-o",
                    str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    values = np.ascontiguousarray(pr.constants())
    lib.kafka_prosail_rows_constants.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
    assert lib.kafka_prosail_rows_constants(values.ctypes.data,
                                            values.size) == 0
    fn = lib.kafka_prosail_rows_host
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_void_p, ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong])

    def run(op, aux, x_rows):
        n = x_rows.shape[1]
        h0 = torch.empty((10, n))
        jac = torch.empty((100, n))
        angles = pr.angle_steps(aux, n, CPU)
        assert fn(x_rows.data_ptr(),
                  *(v for a, s in angles for v in (a.data_ptr(), s)),
                  op.hotspot, h0.data_ptr(), jac.data_ptr(), n) == 0
        return h0, jac

    return run


@pytest.mark.parametrize("case", [0, 1, 2, 3, "per_pixel"])
def test_kernel_arithmetic_held_to_float64_on_the_host(
        monkeypatch, host_kernel, case):
    """The kernel's per-pixel arithmetic (host build) at 16,384 px with
    1/16 of the pixels on each bound of every parameter, against the
    float64 plain version (``prosail_rows_case``): at the median, the
    0.99 and the 0.999 quantile of the per-pixel error, at most twice
    the float32 plain version's, or 2e-6 (value) / 1e-4 of the column
    (Jacobian).  The card holds the kernel to chip_smoke.py's tighter
    rule (1.25 x, every quantile and the maximum); the host build calls
    glibc's exp, log and pow, which round otherwise than the CPU kernels
    of torch, so the float32-ill-conditioned tail is left to the card.
    A wrong tie rule or tangent is off by orders of magnitude."""
    op = ProsailOperator()
    n = 16384
    x_rows = cs.prosail_rows_states(n, CPU, 7)
    aux, aux64 = (cs.prosail_rows_aux(case, n, CPU, 7, dt)
                  for dt in (torch.float32, torch.float64))
    monkeypatch.setattr(pr, "prosail_linearize_rows", host_kernel)
    rec = cs.prosail_rows_case(op, x_rows, aux, aux64)
    assert rec["nonfinite"] == 0
    floors = {"h0": cs.PROSAIL_H0_ATOL, "jac": cs.PROSAIL_JAC_RTOL}
    for nm, floor in floors.items():
        for q in ("0.5", "0.99", "0.999"):
            kq = rec["kernel_vs_f64"][nm][q]
            pq = rec["plain_vs_f64"][nm][q]
            assert kq <= max(2.0 * pq, floor), (nm, q, kq, pq)
