"""Performance observability: always-on attribution, live roofline
utilization, and on-demand profiler capture (port of
``kafka_tpu/telemetry/perf.py``).

- **Steady-state attribution** (:func:`record_window`): the engine calls
  this once per assimilated window with the host record its one packed
  ``fetch_scalars`` read already built — no added synchronisation and no
  added read (``kafka_engine_device_reads_total == dispatches`` holds
  with attribution active).  Publishes ``kafka_perf_px_steps_per_s``,
  ``kafka_perf_device_fraction`` and ``kafka_perf_phase_fraction{phase=}``.
- **Live roofline utilization** (:func:`roofline_utilization`): the
  analytic minimum-traffic bounds over the H100's HBM roof give
  ``kafka_perf_roofline_utilization{component=}``, a lower bound on the
  bandwidth the window's solve sustained (the window wall includes host
  work).  The port's solve routes carry the JAX component labels:
  ``fused_gn`` is ``gn_inkernel``, the row loop ``gn_full_pallas``, the
  plain loop ``gn_full`` (:func:`component_for`).
- **On-demand profiler capture** (:func:`capture` /
  :func:`start_windowed_capture`): a ``torch.profiler`` capture (CPU
  and, with a card, CUDA activity) written as a capture session under
  the telemetry dir (``devprof.write_capture``), serving
  ``/profilez?seconds=N`` and the drivers' ``--profile-windows N``.  One
  capture at a time (:class:`CaptureBusy`); a profiler that cannot
  start raises :class:`CaptureUnavailable` (the endpoint answers 503).
"""

from __future__ import annotations

import collections
import os
import shutil
import threading
import time
import weakref
from typing import Deque, Dict, Optional, Tuple

from .registry import MetricsRegistry, get_registry

# ---------------------------------------------------------------------------
# Device roofs and analytic minimum-traffic bounds.
#
# The single home of the card's roofs (``chip_smoke.py``'s ``bound()``
# reads them from here): NVIDIA's published H100 SXM figures, dense, at
# the 700 W limit — HBM3 at 3.35 TB/s and 67 TFLOP/s in float32 outside
# the tensor cores.  The byte counts are fusion-perfect: every input
# read once, every output written once, so utilisation derived from them
# is a lower bound on the bandwidth achieved.
# ---------------------------------------------------------------------------

HBM_GBPS = 3350.0
PEAK_TFLOPS_F32 = 67.0

_F32 = 4  # bytes; the device paths are float32 throughout (kafkalint
#           implicit-f64 enforces it)


def min_traffic_linearize(n_pix: int, p: int, n_bands: int) -> int:
    """Batched value+Jacobian: reads x ``(n, p)``, writes h0 ``(B, n)``
    + jac ``(B, n, p)``."""
    return n_pix * _F32 * (p + n_bands * (1 + p))


def min_traffic_update(n_pix: int, p: int, n_bands: int) -> int:
    """One packed normal-equations update: linearisation + observations
    + states in, solution + packed A out."""
    return n_pix * _F32 * (
        n_bands * (1 + p)          # h0 + jac
        + 3 * n_bands              # y, r_inv, mask (bool rounded up)
        + 2 * p                    # x_lin, x_f
        + p * p                    # p_inv_f (dense as stored)
        + p                        # x out
        + p * p                    # A out
    )


def min_traffic_gn_full(n_pix: int, p: int, n_bands: int) -> int:
    """The WHOLE per-date Gauss-Newton solve, fusion-perfect: inputs
    once, outputs once — iterations live in VMEM/registers in the ideal
    kernel (the bound both ``gn_full`` and ``gn_full_pallas`` are
    measured against in ``tools/roofline.py``)."""
    return n_pix * _F32 * (
        3 * n_bands + 2 * p + p * p   # obs + x_f(+x_lin=x_f) + p_inv_f
        + p + p * p                   # x out + A out
    )


def min_traffic_gn_inkernel(n_pix: int, p: int, n_bands: int) -> int:
    """The fused Gauss-Newton kernel's bound: packed prior/information
    triangles instead of dense ``(p, p)`` batches, and the diagnostic
    outputs (fwd, innovations, per-pixel counters) counted.

    For p = 7, B = 2 this is 82 floats a pixel; ``chip_smoke.py``'s own
    bound of the kernel counts 81 (the kernel writes one verdict a pixel
    and two floats a convergence group where this counts two a pixel),
    so this bound lies 1.2 % above it on the 2400 x 2400 tile date
    (4.608 M px: 0.4512 ms against 0.4457 ms at 3.35 TB/s)."""
    tri = p * (p + 1) // 2
    return n_pix * _F32 * (
        3 * n_bands        # y, r_inv, mask in
        + p                # x_f lane rows in
        + tri              # P_f^-1 packed rows in
        + p + tri          # x out + packed A out
        + 2 * n_bands      # fwd + innovation diagnostics out
        + 2                # per-block iteration/norm rows out
    )


#: solve-generation component -> its analytic bound (the runtime gauge's
#: label values; ``tools/roofline.py`` components carry the same names).
TRAFFIC_BOUNDS = {
    "gn_full": min_traffic_gn_full,
    "gn_full_pallas": min_traffic_gn_full,
    "gn_inkernel": min_traffic_gn_inkernel,
}


def component_for(solver_options: Optional[dict],
                  operator=None) -> str:
    """Which solve route a window ran — the ``component=`` label of the
    utilization gauge, in the JAX package's vocabulary: ``use_pallas``
    False is the plain loop (``gn_full``); otherwise an operator that
    advertises ``inkernel_linearize`` (not opted out) runs ``fused_gn``
    (``gn_inkernel``) and any other the row loop (``gn_full_pallas``)."""
    so = solver_options or {}
    if so.get("use_pallas") is False:
        return "gn_full"
    if getattr(operator, "inkernel_linearize", False) and \
            so.get("inkernel_linearize", True):
        return "gn_inkernel"
    return "gn_full_pallas"


def roofline_utilization(component: str, n_pix: int, p: int,
                         n_bands: int, device_s: float,
                         ) -> Optional[float]:
    """Fraction of the HBM roof the window's solve provably sustained:
    ``min_traffic / (device_s * roof)``.  None when untimeable."""
    bound = TRAFFIC_BOUNDS.get(component, min_traffic_gn_full)
    if device_s <= 0:
        return None
    return bound(n_pix, p, n_bands) / (device_s * HBM_GBPS * 1e9)


# ---------------------------------------------------------------------------
# Always-on steady-state attribution.
#
# Per-registry rolling state: a deque of (ts, cumulative px-steps,
# cumulative device seconds) samples, one per recorded window.  The
# rolling rate over the deque span smooths per-window jitter without
# hiding a sustained slowdown; a fused block's k records share one
# arrival timestamp, which the cumulative form handles for free.
# ---------------------------------------------------------------------------

#: windows in the rolling attribution window.
ROLL_WINDOW = 32

#: phase -> (histogram metric, label kv) whose cumulative sum feeds the
#: phase-fraction gauge (the PR 2/3 span histograms; ``solve`` comes
#: from the attribution state's own device-seconds accumulator).
PHASE_SOURCES: Dict[str, Tuple[str, Dict[str, str]]] = {
    "fetch": ("kafka_prefetch_read_seconds", {}),
    "advance": ("kafka_engine_phase_seconds", {"phase": "advance"}),
    "dump": ("kafka_engine_phase_seconds", {"phase": "dump"}),
    "write": ("kafka_io_write_seconds", {}),
}


class _PerfState:
    """Rolling attribution state for one registry."""

    def __init__(self):
        self.lock = threading.Lock()
        # (arrival perf_counter ts, cumulative px-steps, cumulative
        # device seconds) — maxlen+1 so a full deque still spans
        # ROLL_WINDOW inter-sample intervals.
        self.samples: Deque[Tuple[float, float, float]] = \
            collections.deque(maxlen=ROLL_WINDOW + 1)
        self.t_origin: Optional[float] = None
        self.px_total = 0.0
        self.device_total = 0.0
        # (n_pad, n_params, n_bands, component) of the last recorded
        # window — the problem dims devprof's measured-vs-analytic
        # roofline cross-check needs.
        self.last_dims: Optional[Tuple[int, int, int, str]] = None


_states: "weakref.WeakKeyDictionary[MetricsRegistry, _PerfState]" = \
    weakref.WeakKeyDictionary()
_states_lock = threading.Lock()


def _state_for(reg: MetricsRegistry) -> _PerfState:
    with _states_lock:
        st = _states.get(reg)
        if st is None:
            st = _states[reg] = _PerfState()
        return st


def _hist_sum(reg: MetricsRegistry, name: str,
              labels: Dict[str, str]) -> float:
    val = reg.value(name, **labels)
    if isinstance(val, dict):
        return float(val.get("sum") or 0.0)
    return 0.0


def record_window(rec: dict, *, n_valid: int, n_pad: int, n_params: int,
                  n_bands: int, solver_options: Optional[dict] = None,
                  operator=None,
                  registry: Optional[MetricsRegistry] = None) -> None:
    """Fold one assimilated window into the live perf gauges.

    Called by the engine from ``_record_window`` with the record the
    packed diagnostic read already produced — attribution adds no
    device->host transfer and no synchronisation.  ``rec["wall_s"]`` is
    the device-inclusive dispatch wall of the window (a fused block's
    records each carry ``wall/k``); ``operator`` picks the route label
    (:func:`component_for`).
    """
    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    now = time.perf_counter()
    device_s = float(rec.get("wall_s") or 0.0)
    px_steps = float(n_valid)
    with st.lock:
        if st.t_origin is None:
            # The first record's dispatch covered the whole first block:
            # anchor the wall-time origin at its start so the very first
            # device fraction is 1.0, not a division by ~zero.
            st.t_origin = now - max(
                device_s * float(rec.get("fused", 1)), 1e-9
            )
        st.px_total += px_steps
        st.device_total += device_s
        st.samples.append((now, st.px_total, st.device_total))
        t_old, px_old, dev_old = st.samples[0]
        dt = now - t_old
        if dt < 1e-6:
            # Rolling window collapsed to one instant (a fused block's
            # records arrive together): fall back to run-cumulative.
            t_old, px_old, dev_old = st.t_origin, 0.0, 0.0
            dt = max(now - st.t_origin, 1e-9)
        px_rate = (st.px_total - px_old) / dt
        dev_frac = min(1.0, (st.device_total - dev_old) / dt)
        elapsed = max(now - st.t_origin, 1e-9)
        device_total = st.device_total

    g = _window_gauges(reg)
    g["px_rate"].set(px_rate)
    g["device_fraction"].set(dev_frac)

    # Phase busy fractions: cumulative span-histogram seconds over
    # cumulative run wall.  Overlapped phases (prefetch threads, the
    # async writer) legitimately make these sum past 1.0.
    phase_gauge = g["phase"]
    for phase, (metric, labels) in PHASE_SOURCES.items():
        phase_gauge.set(_hist_sum(reg, metric, labels) / elapsed,
                        phase=phase)
    phase_gauge.set(device_total / elapsed, phase="solve")

    component = component_for(solver_options, operator)
    with st.lock:
        st.last_dims = (int(n_pad), int(n_params), int(n_bands),
                        component)
    util = roofline_utilization(
        component, n_pad, n_params, n_bands, device_s
    )
    if util is not None:
        g["roofline"].set(util, component=component)

    _tick_windowed_capture(reg)


def _window_gauges(reg: MetricsRegistry) -> dict:
    """Single registration site of the per-window gauges."""
    return {
        "px_rate": reg.gauge(
            "kafka_perf_px_steps_per_s",
            "rolling assimilation throughput (valid pixels x window "
            "steps per wall second) over the last windows — the live "
            "form of the bench e2e row",
        ),
        "device_fraction": reg.gauge(
            "kafka_perf_device_fraction",
            "rolling fraction of wall time spent in device-inclusive "
            "solve dispatch — the live form of bench e2e_device_fraction",
        ),
        "phase": reg.gauge(
            "kafka_perf_phase_fraction",
            "per-phase busy fraction of run wall time (fetch/advance/"
            "solve/dump/write, from the span histograms; overlapped "
            "phases may sum past 1)",
        ),
        "roofline": reg.gauge(
            "kafka_perf_roofline_utilization",
            "fraction of the HBM roof the latest window's solve "
            "provably sustained (analytic minimum traffic / measured "
            "device time; lower bound — only meaningful on TPU)",
        ),
    }


def declare(reg: MetricsRegistry) -> None:
    """Register this module's metric families (``httpd``'s /metrics)."""
    _window_gauges(reg)
    _captures_total(reg)
    _evictions(reg)


def last_window_dims(registry: Optional[MetricsRegistry] = None,
                     ) -> Optional[Tuple[int, int, int, str]]:
    """``(n_pad, n_params, n_bands, component)`` of the last recorded
    window, or None before any window landed — the analytic side of
    ``devprof.roofline_crosscheck``."""
    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    with st.lock:
        return st.last_dims


def summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """Compact perf state for ``/statusz``, live snapshots and the BENCH
    artifact: the throughput/device-fraction gauges, the per-component
    roofline utilization, and the phase breakdown."""
    reg = registry if registry is not None else get_registry()
    roofline: Dict[str, float] = {}
    phases: Dict[str, float] = {}
    for m in reg.metrics():
        if m.name == "kafka_perf_roofline_utilization":
            for key, val in m._series():
                roofline[dict(key).get("component", "?")] = val
        elif m.name == "kafka_perf_phase_fraction":
            for key, val in m._series():
                phases[dict(key).get("phase", "?")] = round(val, 6)
    return {
        "px_steps_per_s": reg.value("kafka_perf_px_steps_per_s"),
        "device_fraction": reg.value("kafka_perf_device_fraction"),
        "roofline_utilization": roofline,
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# On-demand profiler capture (torch.profiler).
# ---------------------------------------------------------------------------

class CaptureUnavailable(RuntimeError):
    """``torch.profiler`` refusing to start — the caller (the httpd
    endpoint) answers a clean 503, never a crash."""


class CaptureBusy(RuntimeError):
    """A capture is already running; one at a time by design (two
    concurrent profiler sessions corrupt each other's dumps)."""


#: maximum /profilez capture length — a handler thread is held for the
#: duration, so the knob is bounded.
MAX_CAPTURE_S = 60.0

#: capture dirs kept under the retention root (<telemetry>/profile) —
#: the keep-N bound on /profilez / --profile-windows accumulation.
#: Evictions are counted and evented, never silent.
CAPTURE_KEEP = 8

#: seconds a capture waits for a kernel launch to switch its CUDA
#: tracing on or off on the launching thread (``_on_launching_thread``)
#: before the asking thread switches it itself.
LAUNCH_WAIT_S = 2.0

_capture_lock = threading.Lock()
_windowed = {"remaining": 0, "directory": None}
_windowed_lock = threading.Lock()
#: the running profiler session: (profile, directory, epoch) or None.
_session: Dict[str, object] = {}


def prepare_profiler() -> None:
    """Set ``torch.profiler``'s CUDA tracing up on the calling thread when
    it is the main thread and a card is present: one empty capture.  A
    capture started later on another thread (``/profilez``'s handler)
    records the GPU kernels only after this; started first off the main
    thread, CUDA tracing refuses to initialise and the capture holds no
    GPU activity.  A no-op while another capture runs (the profiler is
    set up then)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available() or \
            threading.current_thread() is not threading.main_thread():
        return
    if not _capture_lock.acquire(blocking=False):
        return
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    finally:
        _capture_lock.release()


def _start_trace(directory: str) -> None:
    """Start a ``torch.profiler`` session (CPU activity, and CUDA
    activity when a card is present) that :func:`_stop_trace` writes as
    a capture session under ``directory``.  Called with the capture lock
    held."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(directory, exist_ok=True)
    prof = profile(activities=activities)
    # The epoch anchors the capture's device lanes on the stitched
    # timeline (the profiler's own timestamps have no wall-clock epoch).
    epoch = time.time()
    try:
        prof.start()
    except RuntimeError as exc:
        raise CaptureUnavailable(f"profiler refused to start: {exc!r}")
    _session.update(prof=prof, directory=directory, epoch=epoch)


def _halt_trace() -> None:
    """Stop the running session's tracing and keep the session for
    :func:`_stop_trace` to write; a failure is kept for it to event."""
    prof = _session.get("prof")
    if prof is None or "halted" in _session:
        return
    try:
        prof.stop()
        _session["halted"] = None
    except Exception as exc:  # noqa: BLE001 — evented by _stop_trace
        _session["halted"] = exc


def _stop_trace() -> bool:
    """Stop the running session (unless :func:`_halt_trace` did) and
    write it as a capture session (``devprof.export_profile``); returns
    whether the session traced CUDA activity.  A failure is evented, not
    raised: the stop runs in a driver's ``finally``, where it must not
    mask the run's own outcome; the missing capture then counts as a
    parse failure."""
    from . import devprof

    prof = _session.pop("prof", None)
    directory = _session.pop("directory", None)
    epoch = _session.pop("epoch", None)
    halted = _session.pop("halted", False)
    if prof is None:
        return False
    try:
        if halted is False:
            prof.stop()
        elif halted is not None:
            raise halted
        devprof.export_profile(prof, directory, epoch)
    except Exception as exc:  # noqa: BLE001 — evented; see docstring
        get_registry().emit("profile_stop_failed", directory=directory,
                            error=repr(exc)[:200])
    return devprof.traced_cuda(prof)


def _on_launching_thread(fn, *args) -> Tuple[object, str]:
    """``fn(*args)`` on the next thread that launches one of the
    package's kernels, just after its launch returned
    (``core._build.after_next_launch``), or on this thread when none
    launches within LAUNCH_WAIT_S.  Returns ``fn``'s value and the name
    of the thread that ran it; raises what ``fn`` raised.

    CUDA tracing switched on or off by one thread while another is
    inside a CUDA call can lose that other thread's GPU records for the
    rest of the process.  On the H100 (torch 2.11, the CUPTI of CUDA
    12.8), 1-s captures switched by a handler thread while the main
    thread launched and synchronised lost them in 23 of 871 captures,
    and from then on no capture held a kernel of the main thread
    (another thread's still came); captures switched by the main thread
    itself lost none in 150.  The switching thread pauses for the
    profiler's start and stop.  On a pixel mesh, where every shard
    launches from a thread of its own, ``fn`` runs on the caller of
    ``shard.step.run_shards`` once the shards were joined
    (``core._build.shard_group``), and this thread waits for the
    shards' join however long the date takes.  Without a card there is
    no CUDA tracing: ``fn`` runs here."""
    import torch

    from ..core import _build

    if not torch.cuda.is_available():
        return fn(*args), threading.current_thread().name
    done = threading.Event()
    claim = threading.Lock()
    box: Dict[str, object] = {}

    def job():
        if not claim.acquire(blocking=False):
            return
        try:
            box["value"] = fn(*args)
        except Exception as exc:  # noqa: BLE001 — raised by the asker
            box["error"] = exc
        finally:
            box["thread"] = threading.current_thread().name
            done.set()

    _build.after_next_launch(job)
    while not done.wait(LAUNCH_WAIT_S):
        if _build.discard_launch_job(job):
            job()
    done.wait()
    if "error" in box:
        raise box["error"]
    return box.get("value"), str(box["thread"])


def capture(seconds: float, directory: str,
            registry: Optional[MetricsRegistry] = None) -> dict:
    """Run one bounded profiler capture into ``directory`` and block
    until it finishes.  Its CUDA tracing is switched on and off by a
    thread that launches the package's kernels, when one does
    (:func:`_on_launching_thread`).  Raises :class:`CaptureBusy` when
    another capture (including a windowed one) is active,
    :class:`CaptureUnavailable` when the profiler cannot run here or a
    session that traced CUDA caught no GPU work (the capture then counts
    as a parse failure).  Returns a summary dict the ``/profilez``
    endpoint answers with."""
    seconds = max(0.05, min(float(seconds), MAX_CAPTURE_S))
    reg = registry if registry is not None else get_registry()
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already running")
    t0 = time.perf_counter()
    try:
        _, started_on = _on_launching_thread(_start_trace, directory)
        # Bounded wait, not time.sleep: the run under observation keeps
        # going on its own threads while this handler thread idles.
        threading.Event().wait(seconds)
        _, stopped_on = _on_launching_thread(_halt_trace)
        cuda = _stop_trace()
    finally:
        _capture_lock.release()
    files = sum(len(fs) for _, _, fs in os.walk(directory))
    _captures_total(reg).inc()
    reg.emit(
        "profile_capture", directory=directory, seconds=seconds,
        files=files, wall_s=round(time.perf_counter() - t0, 3),
        switched_on=[started_on, stopped_on],
    )
    if _finish_capture(directory, reg) is None and cuda:
        raise CaptureUnavailable(
            "the capture traced CUDA but caught no GPU work (torch.profiler "
            "records other threads' kernels only once it was first set up "
            "on the main thread: perf.prepare_profiler)")
    return {"directory": directory, "seconds": seconds, "files": files}


def _captures_total(reg: MetricsRegistry):
    """Single registration site (metric-name lint: one owner per name)."""
    return reg.counter(
        "kafka_perf_profile_captures_total",
        "completed on-demand jax.profiler captures (/profilez or "
        "--profile-windows)",
    )


def start_windowed_capture(n_windows: int, directory: str,
                           registry: Optional[MetricsRegistry] = None,
                           ) -> None:
    """Drivers' ``--profile-windows N``: start a capture now and stop it
    automatically after the next ``n_windows`` assimilated windows (the
    attribution path ticks it).  ``stop_windowed_capture`` is the
    end-of-run safety net for short runs."""
    if n_windows <= 0:
        return
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a profiler capture is already running")
    try:
        _start_trace(directory)
    except CaptureUnavailable:
        _capture_lock.release()
        raise
    with _windowed_lock:
        _windowed["remaining"] = int(n_windows)
        _windowed["directory"] = directory
    reg = registry if registry is not None else get_registry()
    reg.emit("profile_windows_started", directory=directory,
             windows=int(n_windows))


def _tick_windowed_capture(reg: MetricsRegistry) -> None:
    with _windowed_lock:
        if not _windowed["directory"]:
            return
        _windowed["remaining"] -= 1
        if _windowed["remaining"] > 0:
            return
    stop_windowed_capture(registry=reg)


def stop_windowed_capture(registry: Optional[MetricsRegistry] = None,
                          ) -> Optional[dict]:
    """Stop an active windowed capture (idempotent; returns the capture
    summary, or None when no windowed capture was running)."""
    with _windowed_lock:
        directory = _windowed["directory"]
        if not directory:
            return None
        _windowed["directory"] = None
        _windowed["remaining"] = 0
    _stop_trace()
    _capture_lock.release()
    reg = registry if registry is not None else get_registry()
    files = sum(len(fs) for _, _, fs in os.walk(directory))
    _captures_total(reg).inc()
    reg.emit("profile_capture", directory=directory, files=files,
             windowed=True)
    _finish_capture(directory, reg)
    return {"directory": directory, "files": files}


def _finish_capture(directory: str, reg: MetricsRegistry,
                    ) -> Optional[dict]:
    """Post-capture hooks, both capture paths: parse the fresh capture
    into devprof's kernel table (so /kernelz is live immediately; the
    table, or None when it did not parse) and enforce keep-N retention.
    Best-effort — the windowed stop runs in the engine's ``finally``,
    where a telemetry bug must never mask the run's own outcome."""
    try:
        from . import devprof

        table = devprof.ingest_capture(directory, registry=reg)
        prune_captures(_retention_root(directory), registry=reg)
        return table
    except Exception as exc:  # noqa: BLE001 — post-capture hygiene, never fatal
        reg.emit("devprof_ingest_failed", directory=directory,
                 error=repr(exc)[:200])
        return None


def _retention_root(directory: str) -> str:
    """The keep-N scope for a capture dir.  ``/profilez`` captures land
    in ``<telemetry>/profile/<ts>`` (prune across the sibling
    timestamps); ``--profile-windows`` captures go straight into
    ``<telemetry>/profile`` (prune inside it)."""
    directory = directory.rstrip(os.sep)
    if os.path.basename(directory) == "profile":
        return directory
    return os.path.dirname(directory) or directory


def prune_captures(root: str, keep: Optional[int] = None,
                   registry: Optional[MetricsRegistry] = None) -> int:
    """Keep only the newest ``keep`` profiler capture sessions under
    ``root``, deleting the oldest beyond the cap (plus their emptied
    ancestor dirs and epoch sidecars) — a long-lived daemon answering
    ``/profilez`` must not grow captures without bound.  Every eviction
    increments ``kafka_perf_capture_evictions_total`` and emits a
    ``profile_capture_evicted`` event.  Returns the eviction count."""
    from . import devprof

    reg = registry if registry is not None else get_registry()
    if keep is None:
        keep = CAPTURE_KEEP
    sessions = devprof.find_capture_sessions(root)
    if keep < 0 or len(sessions) <= keep:
        return 0

    def mtime(d: str) -> float:
        try:
            return os.path.getmtime(d)
        except OSError:
            return 0.0

    sessions.sort(key=lambda d: (mtime(d), d))
    evicted = 0
    root_abs = os.path.abspath(root)
    for session in sessions[:len(sessions) - keep]:
        try:
            shutil.rmtree(session)
        except OSError:
            continue
        evicted += 1
        reg.emit("profile_capture_evicted", directory=session,
                 keep=keep)
        # Collapse emptied ancestors (the plugins/profile scaffolding
        # and per-capture roots), stopping at the retention root; an
        # orphaned epoch sidecar goes with its capture.
        parent = os.path.dirname(os.path.abspath(session))
        while parent != root_abs and parent.startswith(root_abs):
            try:
                left = os.listdir(parent)
                if left == ["capture_meta.json"]:
                    os.unlink(os.path.join(parent, "capture_meta.json"))
                    left = []
                if left:
                    break
                os.rmdir(parent)
            except OSError:
                break
            parent = os.path.dirname(parent)
    if evicted:
        _evictions(reg).inc(evicted)
    return evicted


def _evictions(reg: MetricsRegistry):
    """Single registration site of the eviction counter."""
    return reg.counter(
        "kafka_perf_capture_evictions_total",
        "profiler capture sessions evicted by keep-N retention "
        "(oldest first; default keep=8)",
    )
