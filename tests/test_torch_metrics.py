"""The engine's per-window metrics and solve-health counters of the port
against the JAX engine's, on the same runs.

Both packages run ``run_tip_engine`` (and a faults run, below) into a
fresh registry each.  The nine metrics of the JAX ``_record_window`` and
``_record_solver_health`` that read only the host record — four
``kafka_engine_*`` and five ``kafka_solver_*`` — must exist in the port
with the JAX help strings, label sets and histogram buckets.  Counters
and histogram bucket counts must be equal; histogram sums and the
convergence-norm gauge are float32 results of two libraries and are
held to rtol 1e-3, the gauge to rtol 1e-2: it is the norm of the last
Gauss-Newton step, a difference of nearly equal iterates, so the float32
rounding of the iterates (~1e-7) is a larger share of it (the step norm
is ~1e-4 here).  On the faults run the float sums are not compared,
only the counts and buckets: its pinned pixels' innovations are read at
iterates clipped against data beyond the bound, with sigma 0.001, where
an ulp of the iterate moves chi^2 by percents.
``kafka_engine_converged_frac`` comes with
``per_pixel_convergence`` and is compared in test_torch_per_pixel.py.

The faults run arms the ``solver.pixel`` fault on pixels 3-5 (their
linearisation reads NaN: quarantined) and starts 16 pixels on the upper
bound of ``w_vis`` with data that push beyond it (clipped on every
iteration): both events fire.  There the JAX engine runs its Pallas
generation (``use_pallas``, interpret mode on the CPU), which the port's
default path mirrors: on two of the pinned pixels the JAX package's own
XLA loop leaves the bound where its Pallas generation and the port stay
on it (a pixel whose data pull against the clip is within noise).
"""

import datetime

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kafka_tpu import telemetry as jtel
from kafka_tpu.resilience import faults as jfaults
from kafka_tpu.telemetry.registry import MetricsRegistry as JRegistry
from kafka_tpu_torch.resilience import faults as tfaults
from kafka_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry
from kafka_tpu_torch.telemetry.registry import use as tuse

NEW = ("kafka_engine_convergence_norm", "kafka_engine_innovation_chi2",
       "kafka_engine_bounds_clipped_total",
       "kafka_engine_nodata_pixels_total",
       "kafka_solver_cap_bailouts_total",
       "kafka_solver_damped_recoveries_total",
       "kafka_solver_quarantined_pixels_total",
       "kafka_solver_nonfinite_total", "kafka_solver_clip_saturated_total")
KEPT = ("kafka_engine_windows_total", "kafka_engine_pixels_total",
        "kafka_engine_gn_iterations")
RTOL = 1e-3
NORM_RTOL = 1e-2


def _tip_runs():
    from kafka_tpu.testing.synthetic import run_tip_engine as jax_run
    from kafka_tpu_torch.testing.synthetic import run_tip_engine as port_run

    with jtel.use(JRegistry()) as jreg:
        jax_run()
    with tuse(TRegistry()) as treg:
        port_run(device="cpu")
    return jreg, treg


def _pinned_run(pkg: str):
    """A TIP run with three corrupted pixels and 16 pixels pinned at the
    w_vis upper bound (truth above it), in ``pkg``."""
    import importlib

    eng = importlib.import_module(pkg + ".engine")
    syn = importlib.import_module(pkg + ".testing.synthetic")
    obsops = importlib.import_module(pkg + ".obsops")
    prop = importlib.import_module(pkg + ".core.propagators")
    port = pkg == "kafka_tpu_torch"
    kw = {"device": "cpu"} if port else {}
    if port:
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32)
    else:
        t = jnp.asarray

    def day(i):
        return datetime.datetime(2021, 3, 1) + datetime.timedelta(days=i)

    mean, cov, inv = prop.tip_prior_arrays()
    mask = np.ones((6, 8), bool)
    truth = np.broadcast_to(mean, mask.shape + (7,)).copy()
    truth[..., 6] = 0.45
    truth[:2, :, 0] = 0.99999
    obs = syn.SyntheticObservations(
        [day(1)], obsops.TwoStreamOperator(), lambda d: truth, sigma=0.001,
        mask_prob=0.05, **kw)
    prior = eng.FixedGaussianPrior(
        prop.PixelPrior(mean=t(mean), cov=t(cov), inv_cov=t(inv)),
        eng.TIP_PARAMETER_LIST)
    opts = {"relaxation": 0.7, "max_iterations": 40}
    if not port:
        opts["use_pallas"] = True
    kf = eng.KalmanFilter(obs, syn.MemoryOutput(), mask,
                          eng.TIP_PARAMETER_LIST, state_propagation=None,
                          prior=prior, pad_multiple=64, solver_options=opts,
                          **kw)
    x0, p_inv0 = prior.process_prior(None, kf.gather)
    x0 = np.array(x0)
    x0[:16, 0] = 0.999
    kf.run([day(0), day(2)], t(x0), None, p_inv0)


def _fault_runs():
    jfaults.reset()
    tfaults.reset()
    try:
        jfaults.script("solver.pixel", "3-5")
        tfaults.script("solver.pixel", "3-5")
        with jtel.use(JRegistry()) as jreg:
            _pinned_run("kafka_tpu")
        with tuse(TRegistry()) as treg:
            _pinned_run("kafka_tpu_torch")
    finally:
        jfaults.reset()
        tfaults.reset()
    return jreg, treg


@pytest.fixture(scope="module", params=["tip", "faults"])
def registries(request):
    return request.param, (_tip_runs() if request.param == "tip"
                           else _fault_runs())


def _series(snapshot, name):
    return {tuple(sorted(s["labels"].items())): s
            for s in snapshot[name]["series"]}


def test_every_metric_with_its_help_labels_and_buckets(registries):
    _, (jreg, treg) = registries
    js, ts = jreg.snapshot(), treg.snapshot()
    for name in NEW + KEPT:
        assert name in ts, name
        assert ts[name]["type"] == js[name]["type"], name
        assert set(_series(ts, name)) == set(_series(js, name)), name
        if name in NEW:
            assert ts[name]["help"] == js[name]["help"], name
        for key, s in _series(ts, name).items():
            if ts[name]["type"] == "histogram":
                assert s["le"] == _series(js, name)[key]["le"], name


def test_counter_and_histogram_values_equal(registries):
    run, (jreg, treg) = registries
    js, ts = jreg.snapshot(), treg.snapshot()
    for name in NEW + KEPT:
        kind = ts[name]["type"]
        for key, s in _series(ts, name).items():
            j = _series(js, name)[key]
            if kind == "counter":
                assert s["value"] == j["value"], (name, key)
            elif kind == "histogram":
                assert (s["count"], s["buckets"]) == \
                    (j["count"], j["buckets"]), (name, key)
                if run == "tip":
                    assert s["sum"] == pytest.approx(j["sum"], rel=RTOL)
            elif run == "tip":
                assert s["value"] == pytest.approx(j["value"],
                                                   rel=NORM_RTOL)


def test_solver_events_equal(registries):
    kind, (jreg, treg) = registries

    def events(reg):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in reg.events if e["event"].startswith("solver_")]

    assert events(treg) == events(jreg)
    names = {e["event"] for e in events(treg)}
    if kind == "faults":
        assert names == {"solver_clip_saturated",
                         "solver_pixels_quarantined"}
        assert treg.value("kafka_solver_quarantined_pixels_total") == 3
    else:
        assert not names
