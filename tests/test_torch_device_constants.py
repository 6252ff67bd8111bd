"""The per-device constants of the port (``core.device_constants``): the
clip helpers and PROSAIL's constants take their tensors from a cache
made once per (value, dtype, device) instead of copying a host value to
the device on every call (ROADMAP Queue 3 item 10h).

Held here: the cached clips give the bits of the ``torch.as_tensor``
form they replace, in float32 and float64, and the JAX tangent rule at
ties (half to each side, as ``jnp.clip``); the cache keeps one entry per
value, dtype and device, also when threads fill it at once; a constant
first made inside ``vmap`` / ``jacfwd`` is a plain tensor; and the
census of every linearisation program records no host-to-device copy.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kafka_tpu_torch.core import device_constants as dc
from kafka_tpu_torch.core import solvers
from kafka_tpu_torch.obsops import prosail
from kafka_tpu_torch.obsops._jaxrules import _clip, _max, _min

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACTS = os.path.join(REPO_ROOT, "kafka_tpu_torch", "analysis",
                         "contracts")
EPS = 1e-6
#: (lo, hi) pairs of the operators' clips: exact and inexact in binary.
CLIPS = ((0.0, 1.0), (EPS, 1.0 - EPS), (-0.95, 0.95), (0.05, 1.0),
         (15.0, 80.0))


def _old_max(x, c):
    return torch.maximum(x, torch.as_tensor(c, dtype=x.dtype,
                                            device=x.device))


def _old_min(x, c):
    return torch.minimum(x, torch.as_tensor(c, dtype=x.dtype,
                                            device=x.device))


def _old_clip(x, lo, hi):
    return _old_min(_old_max(x, lo), hi)


def _points(lo, hi, dtype):
    """Inside, outside and exactly on each limit (as ``dtype`` rounds
    it), one ulp either side of each limit (the smallest normal either
    side of a limit of 0: XLA on the CPU flushes subnormals to zero, so
    JAX would see a tie there), and signed zeros."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    tiny = np.finfo(np_dt).tiny
    lims = [np_dt(lo), np_dt(hi)]
    pts = [np_dt(0.5 * (lo + hi)), np_dt(lo - 1.0), np_dt(hi + 1.0),
           np_dt(0.0), np_dt(-0.0)]
    for v in lims:
        pts += [v, np.nextafter(v, np_dt(np.inf)) if v else tiny,
                np.nextafter(v, np_dt(-np.inf)) if v else -tiny]
    return torch.as_tensor(np.array(pts, np_dt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("lo,hi", CLIPS)
def test_cached_clips_give_the_bits_of_the_copying_form(lo, hi, dtype):
    x = _points(lo, hi, dtype)
    for new, old, args in ((_max, _old_max, (lo,)), (_min, _old_min, (hi,)),
                           (_clip, _old_clip, (lo, hi))):
        got, want = new(x, *args), old(x, *args)
        assert got.dtype == want.dtype == dtype
        # Bit for bit, signed zeros included.
        assert torch.equal(got.view(torch.int64 if dtype == torch.float64
                                    else torch.int32),
                           want.view(torch.int64 if dtype == torch.float64
                                     else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("lo,hi", CLIPS)
def test_cached_clip_tangents_split_ties_half_and_half(lo, hi, dtype):
    """``jacfwd`` of the cached clip equals the copying form's, and is
    0.5 exactly on a limit, 1 inside and 0 outside; in float32 it equals
    ``jax.jacfwd`` of ``jnp.clip`` on the same points."""
    x = _points(lo, hi, dtype)
    jac = torch.func.jacfwd(lambda v: _clip(v, lo, hi))(x)
    old = torch.func.jacfwd(lambda v: _old_clip(v, lo, hi))(x)
    assert torch.equal(jac, old)
    lo_t, hi_t = (torch.as_tensor(v, dtype=dtype) for v in (lo, hi))
    want = torch.where((x > lo_t) & (x < hi_t), 1.0, 0.0).to(dtype)
    want = torch.where((x == lo_t) | (x == hi_t), 0.5, want)
    assert torch.equal(torch.diagonal(jac), want)
    assert torch.count_nonzero(jac - torch.diag(torch.diagonal(jac))) == 0
    if dtype == torch.float32:
        jj = jax.jacfwd(lambda v: jnp.clip(v, lo, hi))(jnp.asarray(
            x.numpy()))
        np.testing.assert_array_equal(jac.numpy(), np.asarray(jj))


def test_one_entry_per_value_dtype_and_device():
    value = 0.3183098861837907  # a value no module of the port uses
    n0 = len(dc._CACHE)
    a = dc.device_constant(value, torch.float32, "cpu")
    assert len(dc._CACHE) == n0 + 1
    # The same value, dtype and device: the same tensor, no new entry,
    # however the value arrives (a fresh float, a numpy scalar, a 0-d
    # array) and however the device is named.
    for v in (float(str(value)), np.float64(value), np.array(value)):
        assert dc.device_constant(v, torch.float32, torch.device("cpu")) \
            is a
    assert len(dc._CACHE) == n0 + 1
    # Another dtype and another device each get their own entry.
    b = dc.device_constant(value, torch.float64, "cpu")
    m = dc.device_constant(value, torch.float32, "meta")
    assert b is not a and b.dtype == torch.float64
    assert m.device.type == "meta"
    assert len(dc._CACHE) == n0 + 3
    # The value is the key: 0.0 and -0.0 are two constants.
    z, nz = (dc.device_constant(v, torch.float32, "cpu")
             for v in (0.0, -0.0))
    assert z is not nz and torch.signbit(nz) and not torch.signbit(z)
    # An array rebuilt per call finds its entry; the bits are those of
    # the copy it replaces.
    arr = np.arange(7, dtype=np.float32) / 3
    c = dc.device_constant(arr, torch.float32, "cpu")
    assert dc.device_constant(arr.copy(), torch.float32, "cpu") is c
    assert torch.equal(c, torch.as_tensor(arr, dtype=torch.float32))
    # A tensor is moved as torch.as_tensor moves it, never cached.
    t = torch.ones(3)
    n1 = len(dc._CACHE)
    assert dc.device_constant(t, torch.float32, "cpu") is t
    assert len(dc._CACHE) == n1


def test_inputs_are_refused():
    with pytest.raises(ValueError, match="input, not a constant"):
        dc.device_constant(np.zeros(dc.MAX_ELEMENTS + 1, np.float32),
                           torch.float32, "cpu")
    with pytest.raises(TypeError):
        dc.device_constant("0.5", torch.float32, "cpu")


def test_two_threads_filling_at_once_make_one_tensor(monkeypatch):
    made = []
    real = dc._make

    def slow_make(value, dtype, device):
        made.append(value)
        time.sleep(0.05)  # widen the window between lookup and insert
        return real(value, dtype, device)

    monkeypatch.setattr(dc, "_make", slow_make)
    value = 2.718281828459045 / 7
    start = threading.Barrier(8)
    got = []

    def fill():
        start.wait()
        got.append(dc.device_constant(value, torch.float32, "cpu"))

    threads = [threading.Thread(target=fill) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(got) == 8 and all(t is got[0] for t in got)
    assert made == [value]


@pytest.mark.parametrize("transform", ["vmap", "jacfwd", "vmap_jacfwd"])
def test_constant_made_inside_a_transform_is_plain(transform):
    """A cache miss inside ``torch.func`` makes a plain constant: no
    batch dimension, no tangent; it serves calls outside the transform
    and inside another one alike."""
    value = {"vmap": 0.1234567, "jacfwd": 0.2345678,
             "vmap_jacfwd": 0.3456789}[transform]
    seen = []

    def f(x):
        c = dc.device_constant(value, torch.float32, x.device)
        seen.append(c)
        return torch.maximum(x, c)

    x = torch.tensor([[0.0, value, 1.0]], dtype=torch.float32)
    if transform == "vmap":
        out = torch.func.vmap(f)(x)
    elif transform == "jacfwd":
        out = torch.func.jacfwd(f)(x[0])
    else:
        out = torch.func.vmap(torch.func.jacfwd(f))(x)
    c = seen[0]
    assert type(c) is torch.Tensor and c.shape == () and not c.requires_grad
    assert not torch._C._functorch.is_functorch_wrapped_tensor(c)
    assert not torch._C._functorch.is_batchedtensor(c)
    assert not torch._C._functorch.is_gradtrackingtensor(c)
    assert dc.device_constant(value, torch.float32, "cpu") is c
    assert float(c) == float(np.float32(value))
    if transform != "vmap":
        # The tie at x == value splits the tangent half and half.
        jac = out.reshape(3, 3) if transform == "jacfwd" else out[0]
        assert torch.equal(torch.diagonal(jac),
                           torch.tensor([0.0, 0.5, 1.0]))


def test_prosail_constants_and_default_geometry_keep_their_bits():
    like = torch.zeros(3)
    for a in (prosail.BAND_K, prosail._TAV40, prosail._TAV90,
              prosail.N_REFRACT, prosail.SOIL_DRY, prosail.SOIL_WET):
        got = prosail._f32(a, like)
        want = torch.as_tensor(np.asarray(a), dtype=torch.float32)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert prosail._f32(a, like) is got
    op = prosail.ProsailOperator()
    x = torch.as_tensor(np.array([1.5, 0.6, 0.9, 0.1, 0.7, 0.6, 0.4, 0.5,
                                  1.0, 0.5], np.float32))
    default = op.forward_pixel(None, x)
    explicit = op.forward_pixel(prosail.ProsailAux(*(
        torch.tensor(v, dtype=torch.float32) for v in (30.0, 0.0, 0.0))), x)
    assert torch.equal(default, explicit)


@pytest.mark.parametrize("bounds", [
    (np.float32(0.0), np.float32(1.0)),
    (np.zeros(3, np.float32), np.full(3, 2.0, np.float32)),
    ([0.0, -1.0, 0.1], [1.0, 1.0, 0.9]),
    (np.zeros((5, 3), np.float32), np.ones((5, 3), np.float32)),
], ids=["scalar", "vector", "list", "per_pixel"])
def test_state_bounds_rows_keep_their_bits(bounds):
    lo, hi = solvers._bounds_rows(bounds, 5, 3, torch.device("cpu"))

    def old(v):
        v = torch.as_tensor(v, dtype=torch.float32)
        return v if v.ndim == 0 else v[:, None] if v.ndim == 1 else v.T

    for got, v in ((lo, bounds[0]), (hi, bounds[1])):
        assert torch.equal(got, old(v)) and got.dtype == torch.float32


LINEARIZE_PROGRAMS = ("linearize_twostream", "linearize_prosail",
                      "linearize_joint_optical", "linearize_joint_sar",
                      "linearize_wcm", "linearize_gp_bank", "linearize_mlp",
                      "sharded_forward_tip")


@pytest.mark.parametrize("name", LINEARIZE_PROGRAMS)
def test_linearisation_census_has_no_host_to_device_copy(name):
    """One counted run of the program, after its warm-up (which fills
    the cache): no host-to-device copy and no host read — and the
    checked-in manifest says the same."""
    from kafka_tpu_torch.analysis import programs  # noqa: F401
    from kafka_tpu_torch.analysis.registry import get_specs
    from kafka_tpu_torch.analysis.trace import trace_program

    (spec,) = get_specs([name])
    traced = trace_program(spec, "cpu")
    assert traced.host_syncs == {}
    with open(os.path.join(CONTRACTS, f"{name}.json")) as fh:
        assert json.load(fh)["host_syncs"] == {}


def test_date_and_window_manifests_keep_only_the_loop_reads():
    """The date and window programs' only host reads are the plain
    loop's per-trip convergence reads (``aten._local_scalar_dense``):
    no host-to-device copy is left in any census manifest."""
    for fname in sorted(os.listdir(CONTRACTS)):
        with open(os.path.join(CONTRACTS, fname)) as fh:
            syncs = json.load(fh)["host_syncs"]
        assert "h2d" not in syncs, fname
        assert set(syncs) <= {"aten._local_scalar_dense",
                              "aten._linalg_check_errors"}, fname
