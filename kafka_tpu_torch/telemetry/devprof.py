"""Device-plane observability: kernel-time attribution, the CUDA memory
ledger and mesh introspection (port of ``kafka_tpu/telemetry/devprof.py``).

- **Kernel-time attribution**: a stdlib-only (gzip+json) parser for the
  ``*.trace.json.gz`` Chrome traces inside profiler capture dirs.
  ``torch.profiler`` (Kineto) marks GPU work with ``cat`` ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` on a per-device ``pid``;
  :func:`write_capture` lays a capture out as the JAX profiler does
  (``<root>/plugins/profile/<ts>/<host>.trace.json.gz`` beside the
  ``capture_meta.json`` epoch sidecar) and names each GPU process track
  ``/device:GPU:<i>``, so this parser and the JAX package's (and
  ``tools/device_report.py``) read it alike.  A session that did not
  trace CUDA activity (no card: the CPU is the device) gets one
  ``/device:CPU:0`` lane holding the outermost operators the program
  ran; a session that traced CUDA gets GPU lanes only, so one that
  caught no GPU work parses as nothing (a parse failure), never as host
  time.  ``capture_meta.json`` records which.  Device spans fold into a ranked
  per-kernel table with fusion/collective/transfer/other buckets (NCCL
  and gloo kernels are collectives, memcpy a transfer, the hand kernels
  ``other``), publish ``kafka_devprof_kernel_ms_total{bucket=}`` and the
  collective-time fraction gauge, and join the stitched fleet trace as
  device lanes (``aggregate.stitch_traces``).  Surfaced by ``/kernelz``.
- **Memory ledger**: a census of the CUDA caching allocator's active
  blocks (``torch.cuda.memory_snapshot()``: host-side allocator
  metadata, no device->host copy) grouped by device, pool and block
  size, refreshed per assimilated window by
  ``device.record_memory_watermark`` (at most once per
  ``LEDGER_MIN_INTERVAL_S``) and captured as OOM forensics: when a
  ``torch.cuda.OutOfMemoryError`` (or a fault-injected ``device.oom``)
  unwinds, the flight recorder attaches :func:`forensics` — a fresh
  census, the newest kernel table and the per-device memory stats.
- **Mesh introspection**: ``/meshz`` reports the visible devices, the
  pixel mesh (:func:`note_mesh`, a ``shard.mesh.PixelMesh``), the hand
  kernels' compiled attributes (:func:`note_compiled`: registers,
  spills, shared memory, threads), the per-device share of parsed
  device time and the collective fraction.
"""

from __future__ import annotations

import gzip
import json
import os
import socket
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry

#: epoch sidecar filename written by ``perf._start_trace`` at the
#: capture root — the wall-clock anchor that lets stitched traces put
#: device lanes on the same axis as the TraceBuffer host spans (the
#: profiler's own timestamps are monotonic ticks with no epoch).
CAPTURE_META = "capture_meta.json"

#: kernel-table rows kept per capture (ranked by total time; the long
#: tail is aggregated into the table's ``truncated_ms`` remainder).
MAX_KERNELS = 64

#: buffer-census groups kept (ranked by resident bytes).
MAX_CENSUS_GROUPS = 64

#: minimum seconds between per-window ledger censuses.  The watermark
#: tick rides every engine window; walking the allocator snapshot each
#: time is O(blocks) host work.  The gauges only feed dashboards, so a
#: stale-by-seconds census is fine — and OOM forensics takes its own
#: fresh census at dump time regardless.
LEDGER_MIN_INTERVAL_S = 15.0


# ---------------------------------------------------------------------------
# Kernel buckets.
# ---------------------------------------------------------------------------

_COLLECTIVE_TOKENS = (
    "all-reduce", "allreduce", "all-gather", "allgather",
    "reduce-scatter", "reducescatter", "all-to-all", "alltoall",
    "collective", "psum", "ppermute", "nccl", "gloo",
)
_TRANSFER_TOKENS = (
    "copy", "memcpy", "transfer", "infeed", "outfeed", "send", "recv",
)


def bucket_for(name: str) -> str:
    """fusion / collective / transfer / other, from the kernel name —
    the label vocabulary of ``kafka_devprof_kernel_ms_total``."""
    low = name.lower()
    if any(t in low for t in _COLLECTIVE_TOKENS):
        return "collective"
    if any(t in low for t in _TRANSFER_TOKENS):
        return "transfer"
    if "fusion" in low:
        return "fusion"
    return "other"


# ---------------------------------------------------------------------------
# Per-registry state (the perf._states weakref pattern).
# ---------------------------------------------------------------------------

class _DevprofState:
    def __init__(self):
        self.lock = threading.Lock()
        #: ranked kernel table of the newest parsed capture.
        self.kernel_table: List[dict] = []
        self.capture_dir: Optional[str] = None
        self.device_ms: float = 0.0
        self.collective_fraction: Optional[float] = None
        #: per-device-lane share of parsed device time (track -> frac).
        self.device_split: Dict[str, float] = {}
        self.n_captures_parsed = 0
        #: newest live-buffer census (memory ledger).
        self.census: List[dict] = []
        self.census_bytes: float = 0.0
        #: monotonic time of the newest census (throttle anchor).
        self.census_t: Optional[float] = None
        #: mesh facts registered by the engine / compile sites.
        self.mesh: Optional[dict] = None
        self.programs: Dict[str, dict] = {}


_states: "weakref.WeakKeyDictionary[MetricsRegistry, _DevprofState]" = \
    weakref.WeakKeyDictionary()
_states_lock = threading.Lock()


def _state_for(reg: MetricsRegistry) -> _DevprofState:
    with _states_lock:
        st = _states.get(reg)
        if st is None:
            st = _states[reg] = _DevprofState()
        return st


def _parse_failures(reg: MetricsRegistry):
    """Single registration site (metric-name lint)."""
    return reg.counter(
        "kafka_devprof_parse_failures_total",
        "profiler captures that could not be parsed into a kernel "
        "table (malformed/empty trace.json.gz) — the run degrades, "
        "never crashes",
    )


def _capture_metrics(reg: MetricsRegistry) -> dict:
    """Single registration site of the parsed-capture metrics."""
    return {
        "kernel_ms": reg.counter(
            "kafka_devprof_kernel_ms_total",
            "parsed device kernel time (ms) from profiler captures, by "
            "fusion/collective/transfer/other bucket",
        ),
        "collective": reg.gauge(
            "kafka_devprof_collective_fraction",
            "fraction of parsed device time spent in collectives "
            "(newest capture) — the mesh-balance red flag",
        ),
        "parsed": reg.counter(
            "kafka_devprof_captures_parsed_total",
            "profiler captures parsed into a kernel table",
        ),
    }


def _ledger_gauges(reg: MetricsRegistry) -> dict:
    """Single registration site of the memory-ledger gauges."""
    return {
        "bytes": reg.gauge(
            "kafka_devprof_live_buffer_bytes",
            "bytes resident in live jax arrays (buffer-census total, "
            "host-side metadata — no device reads)",
        ),
        "buffers": reg.gauge(
            "kafka_devprof_live_buffers",
            "count of live jax arrays in the newest buffer census",
        ),
    }


def declare(reg: MetricsRegistry) -> None:
    """Register this module's metric families (``httpd``'s /metrics)."""
    _parse_failures(reg)
    _capture_metrics(reg)
    _ledger_gauges(reg)


# ---------------------------------------------------------------------------
# Capture discovery and parsing (stdlib only: gzip + json).
# ---------------------------------------------------------------------------

def find_capture_sessions(root: str) -> List[str]:
    """Profiler session dirs under ``root``: every directory holding at
    least one ``*.trace.json.gz`` (captures are laid out as
    ``<root>/plugins/profile/<ts>/<host>.trace.json.gz``), sorted so
    the newest timestamped session is last."""
    sessions: List[str] = []
    if not os.path.isdir(root):
        return sessions
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        if any(fn.endswith(".trace.json.gz") for fn in filenames):
            sessions.append(dirpath)
    return sorted(sessions)


def capture_epoch(session_dir: str, stop_at: Optional[str] = None,
                  ) -> Optional[float]:
    """The wall-clock epoch of a capture session, from the
    ``capture_meta.json`` sidecar ``perf._start_trace`` wrote at the
    capture root (the session dir sits a few ``plugins/profile/<ts>``
    levels below it).  None when no sidecar exists — an externally
    produced capture still parses, it just can't be epoch-aligned."""
    d = os.path.abspath(session_dir)
    stop = os.path.abspath(stop_at) if stop_at else None
    for _ in range(6):
        meta = os.path.join(d, CAPTURE_META)
        if os.path.isfile(meta):
            try:
                with open(meta, encoding="utf-8") as f:
                    doc = json.load(f)
                return float(doc["epoch_unix_s"])
            except (OSError, ValueError, KeyError, TypeError):
                return None
        parent = os.path.dirname(d)
        if parent == d or (stop is not None and d == stop):
            return None
        d = parent
    return None


def load_capture_events(session_dir: str) -> Tuple[List[dict], int]:
    """Every trace event from every ``*.trace.json.gz`` in the session
    dir, plus the count of files that failed to parse."""
    events: List[dict] = []
    errors = 0
    try:
        names = sorted(os.listdir(session_dir))
    except OSError:
        return events, 1
    for fn in names:
        if not fn.endswith(".trace.json.gz"):
            continue
        path = os.path.join(session_dir, fn)
        try:
            with gzip.open(path, "rt", encoding="utf-8",
                           errors="replace") as f:
                doc = json.load(f)
            ev = doc.get("traceEvents") if isinstance(doc, dict) else None
            if not isinstance(ev, list):
                errors += 1
                continue
            events.extend(e for e in ev if isinstance(e, dict))
        except (OSError, ValueError, EOFError):
            errors += 1
    return events, errors


def _track_names(events: Iterable[dict],
                 ) -> Tuple[Dict[Any, str], Dict[Tuple[Any, Any], str]]:
    """(pid -> process name, (pid, tid) -> thread name) from the
    metadata events."""
    procs: Dict[Any, str] = {}
    threads: Dict[Tuple[Any, Any], str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        name = (e.get("args") or {}).get("name")
        if not isinstance(name, str):
            continue
        if e.get("name") == "process_name":
            procs[e.get("pid")] = name
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = name
    return procs, threads


def device_events(events: List[dict]) -> List[dict]:
    """The device-lane kernel spans of a capture: complete (``ph: X``)
    events on a ``/device:`` process track (how :func:`write_capture`
    names GPU and CPU device lanes), or carrying the JAX package's HLO
    attribution (``args.hlo_op`` / ``args.hlo_module``), so a capture of
    either package parses here.  Host frames stay out."""
    procs, _ = _track_names(events)
    out: List[dict] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        on_device_track = procs.get(e.get("pid"), "").startswith("/device:")
        if "hlo_op" in args or "hlo_module" in args or on_device_track:
            out.append(e)
    return out


def kernel_table_from_events(dev_events: List[dict],
                             max_kernels: int = MAX_KERNELS) -> dict:
    """Aggregate device spans into the ranked kernel table:
    ``{"kernels": [{name, bucket, ms, count, fraction}...],
    "device_ms", "by_bucket", "collective_fraction", "truncated_ms"}``.
    Fractions are of total parsed device time."""
    acc: Dict[str, List[float]] = {}
    for e in dev_events:
        dur = e.get("dur")
        if not isinstance(dur, (int, float)) or dur < 0:
            continue
        name = str(e.get("name") or "?")
        cell = acc.setdefault(name, [0.0, 0.0])
        cell[0] += float(dur) / 1000.0  # us -> ms
        cell[1] += 1.0
    total_ms = sum(v[0] for v in acc.values())
    by_bucket: Dict[str, float] = {}
    ranked = sorted(acc.items(), key=lambda kv: -kv[1][0])
    kernels: List[dict] = []
    for name, (ms, count) in ranked:
        by_bucket[bucket_for(name)] = \
            by_bucket.get(bucket_for(name), 0.0) + ms
        if len(kernels) < max_kernels:
            kernels.append({
                "name": name,
                "bucket": bucket_for(name),
                "ms": round(ms, 4),
                "count": int(count),
                "fraction": round(ms / total_ms, 4) if total_ms else 0.0,
            })
    truncated_ms = total_ms - sum(k["ms"] for k in kernels)
    return {
        "kernels": kernels,
        "device_ms": round(total_ms, 4),
        "by_bucket": {b: round(v, 4) for b, v in sorted(by_bucket.items())},
        "collective_fraction": (
            round(by_bucket.get("collective", 0.0) / total_ms, 4)
            if total_ms else None
        ),
        "truncated_ms": round(max(0.0, truncated_ms), 4),
    }


def _device_split(dev_events: List[dict], events: List[dict],
                  ) -> Dict[str, float]:
    """Per-device-track share of parsed device time — the per-shard
    balance column of ``/meshz`` (one entry on a single-device CPU
    run; a skewed mesh shows up as unequal fractions)."""
    procs, _ = _track_names(events)
    per: Dict[str, float] = {}
    for e in dev_events:
        dur = e.get("dur")
        if not isinstance(dur, (int, float)):
            continue
        track = procs.get(e.get("pid")) or f"pid{e.get('pid')}"
        per[track] = per.get(track, 0.0) + float(dur)
    total = sum(per.values())
    if total <= 0:
        return {}
    return {t: round(v / total, 4) for t, v in sorted(per.items())}


def parse_capture(session_dir: str) -> Optional[dict]:
    """One session dir -> parsed capture summary (kernel table +
    device split), or None when nothing parseable/attributable was
    found.  Pure function — no registry side effects (callers count)."""
    events, errors = load_capture_events(session_dir)
    dev = device_events(events)
    if not dev:
        return None
    table = kernel_table_from_events(dev)
    table["session_dir"] = session_dir
    table["parse_errors"] = errors
    table["device_split"] = _device_split(dev, events)
    return table


def ingest_capture(root: str,
                   registry: Optional[MetricsRegistry] = None,
                   ) -> Optional[dict]:
    """Parse the NEWEST capture session under ``root`` into the
    registry's devprof state and publish the kernel metrics.  Called by
    ``telemetry.perf`` after every completed capture (``/profilez`` and
    ``--profile-windows`` both), so ``/kernelz`` is live the moment a
    capture lands.  A malformed or empty capture increments
    ``kafka_devprof_parse_failures_total`` and emits a
    ``devprof_parse_failed`` event — degrade, never crash."""
    reg = registry if registry is not None else get_registry()
    sessions = find_capture_sessions(root)
    table = parse_capture(sessions[-1]) if sessions else None
    if table is None:
        _parse_failures(reg).inc()
        reg.emit(
            "devprof_parse_failed", directory=root,
            sessions=len(sessions),
        )
        return None
    st = _state_for(reg)
    with st.lock:
        st.kernel_table = table["kernels"]
        st.capture_dir = table["session_dir"]
        st.device_ms = table["device_ms"]
        st.collective_fraction = table["collective_fraction"]
        st.device_split = table["device_split"]
        st.n_captures_parsed += 1
    m = _capture_metrics(reg)
    for b, ms in table["by_bucket"].items():
        m["kernel_ms"].inc(ms, bucket=b)
    if table["collective_fraction"] is not None:
        m["collective"].set(table["collective_fraction"])
    m["parsed"].inc()
    reg.emit(
        "devprof_capture_parsed", directory=table["session_dir"],
        device_ms=table["device_ms"],
        kernels=len(table["kernels"]),
        collective_fraction=table["collective_fraction"],
    )
    return table


def roofline_crosscheck(registry: Optional[MetricsRegistry] = None,
                        ) -> Optional[dict]:
    """Measured-vs-analytic cross-check: the newest capture's measured
    device time against the analytic minimum-traffic time of the last
    recorded window's solve (``perf.min_traffic_*`` over the HBM roof).
    The ratio is a consistency probe, not a utilization claim — a
    capture spans many windows, so only the ORDER of magnitude should
    agree; None when either side is missing (no capture, no window)."""
    from . import perf

    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    dims = perf.last_window_dims(reg)
    with st.lock:
        device_ms = st.device_ms
        have_capture = st.n_captures_parsed > 0
    if not have_capture or device_ms <= 0 or dims is None:
        return None
    n_pad, n_params, n_bands, component = dims
    bound_fn = perf.TRAFFIC_BOUNDS.get(component,
                                       perf.min_traffic_gn_full)
    bound_bytes = bound_fn(n_pad, n_params, n_bands)
    analytic_ms = bound_bytes / (perf.HBM_GBPS * 1e9) * 1e3
    return {
        "measured_device_ms": round(device_ms, 4),
        "analytic_min_ms_per_window": round(analytic_ms, 6),
        "component": component,
        "n_pad": n_pad,
        "n_params": n_params,
        "n_bands": n_bands,
        "measured_over_analytic": (
            round(device_ms / analytic_ms, 2) if analytic_ms > 0 else None
        ),
    }


def kernel_summary(registry: Optional[MetricsRegistry] = None,
                   n: int = 16) -> dict:
    """The ``/kernelz`` payload: newest ranked kernel table, bucket
    split, collective fraction, and the roofline cross-check."""
    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    with st.lock:
        table = list(st.kernel_table[:max(0, n)])
        payload = {
            "captures_parsed": st.n_captures_parsed,
            "capture_dir": st.capture_dir,
            "device_ms": round(st.device_ms, 4),
            "collective_fraction": st.collective_fraction,
            "kernels": table,
        }
    payload["roofline_crosscheck"] = roofline_crosscheck(reg)
    return payload


# ---------------------------------------------------------------------------
# Stitched-trace fold-in: device lanes beside the host phase spans.
# ---------------------------------------------------------------------------

def device_lane_tracks(root: str, epoch0: float, first_pid: int,
                       ) -> Tuple[List[dict], List[dict]]:
    """Device-lane Chrome-trace tracks for every capture session under
    ``root``, pid-remapped from ``first_pid`` and shifted onto the
    stitched timeline's shared epoch axis.

    The profiler's timestamps are monotonic ticks with no wall-clock
    anchor, so alignment pins each session's EARLIEST device event to
    the ``capture_meta.json`` epoch recorded when the capture started —
    exact to within profiler startup latency, which is enough to read
    "which host phase was live during this kernel burst" off one
    Perfetto window.  Sessions with no sidecar pin to ``epoch0``
    (trace-relative time zero).  Returns ``(events, sources)`` in
    ``stitch_traces``'s vocabulary.
    """
    events: List[dict] = []
    sources: List[dict] = []
    pid = first_pid
    for session in find_capture_sessions(root):
        raw, _ = load_capture_events(session)
        dev = device_events(raw)
        if not dev:
            continue
        epoch = capture_epoch(session, stop_at=root)
        ts_min = min(e.get("ts", 0) for e in dev)
        shift = ((epoch - epoch0) * 1e6 if epoch is not None else 0.0) \
            - ts_min
        rel = os.path.relpath(session, root).replace(os.sep, "/")
        _, threads = _track_names(raw)
        events.append({
            "name": "process_name", "ph": "M", "ts": 0.0,
            "pid": pid, "tid": 0,
            "args": {"name": f"kafka_tpu device {rel}"},
        })
        seen_tids = set()
        for e in dev:
            tid = e.get("tid", 0)
            if tid not in seen_tids:
                seen_tids.add(tid)
                tname = threads.get((e.get("pid"), tid))
                if tname:
                    events.append({
                        "name": "thread_name", "ph": "M", "ts": 0.0,
                        "pid": pid, "tid": tid,
                        "args": {"name": tname},
                    })
            events.append({
                "name": e.get("name"), "ph": "X",
                "ts": round(float(e.get("ts", 0)) + shift, 1),
                "dur": e.get("dur"),
                "pid": pid, "tid": tid,
                "args": {
                    k: v for k, v in (e.get("args") or {}).items()
                    if k in ("hlo_op", "hlo_module", "long_name")
                },
            })
        sources.append({
            "pid": pid, "path": rel,
            "epoch_unix_s": epoch, "device_lane": True,
        })
        pid += 1
    return events, sources


# ---------------------------------------------------------------------------
# Writing a torch.profiler capture in the layout the parsers read.
# ---------------------------------------------------------------------------

#: Kineto categories of work that ran on a GPU.
GPU_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _outermost(events: List[dict]) -> List[dict]:
    """The events not nested inside another of ``events`` on the same
    thread: the operators the program called, without their children."""
    out: List[dict] = []
    end: Dict[Any, float] = {}
    for e in sorted(events, key=lambda e: (str(e.get("tid")),
                                            e.get("ts", 0),
                                            -(e.get("dur") or 0))):
        tid, ts = e.get("tid"), float(e.get("ts", 0))
        if ts < end.get(tid, float("-inf")):
            continue
        end[tid] = ts + float(e.get("dur") or 0)
        out.append(e)
    return out


def device_lanes(doc: dict, cuda: bool) -> dict:
    """A Kineto Chrome trace (``export_chrome_trace``'s JSON) with its
    device lanes named for the parsers.  ``cuda``: whether the session
    traced CUDA activity.  If it did, every ``pid`` that carries GPU
    work (``GPU_CATEGORIES``) becomes the track ``/device:GPU:<i>``
    (``i`` the event's ``args.device``), and the other events on those
    tracks (``gpu_user_annotation`` ranges, which repeat host labels on
    the device timeline) are dropped, so device time is counted once; a
    trace without GPU work then has no device lane.  If it did not (no
    card), one ``/device:CPU:0`` lane holds the outermost ``cpu_op``
    events: the CPU is the device and those operators are its
    kernels."""
    events = [e for e in doc.get("traceEvents") or []
              if isinstance(e, dict)]
    out: List[dict] = []
    if cuda:
        lanes: Dict[Any, int] = {}
        for e in events:
            if e.get("ph") == "X" and \
                    str(e.get("cat", "")).lower() in GPU_CATEGORIES:
                dev = (e.get("args") or {}).get("device", e.get("pid"))
                lanes.setdefault(e.get("pid"), int(dev or 0))
        for e in events:
            if e.get("pid") not in lanes:
                out.append(e)
            elif e.get("ph") == "M" or (
                    e.get("ph") == "X"
                    and str(e.get("cat", "")).lower() in GPU_CATEGORIES):
                out.append(e)
        names = {pid: f"/device:GPU:{dev}" for pid, dev in lanes.items()}
    else:
        ops = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "cpu_op"]
        lane = "cpu_device"
        out = [e for e in events if e.get("cat") != "cpu_op"]
        out.extend({**e, "pid": lane} for e in _outermost(ops))
        names = {lane: "/device:CPU:0"} if ops else {}
    out = [e for e in out if not (e.get("ph") == "M"
                                  and e.get("name") == "process_name"
                                  and e.get("pid") in names)]
    out.extend({"name": "process_name", "ph": "M", "ts": 0, "pid": pid,
                "tid": 0, "args": {"name": name}}
               for pid, name in names.items())
    return {**doc, "traceEvents": out}


def write_capture(doc: dict, root: str,
                  epoch_unix_s: Optional[float] = None,
                  cuda: bool = True) -> str:
    """Write one capture session under ``root`` as the parsers expect it:
    ``<root>/plugins/profile/<ts>/<host>.trace.json.gz`` holding
    :func:`device_lanes` of ``doc`` (``cuda``: the session traced CUDA
    activity), and the ``capture_meta.json`` sidecar at ``root``: the
    epoch (``epoch_unix_s``, default now) and the traced
    ``activities``.  Returns the session directory."""
    session = os.path.join(root, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
    while os.path.exists(session):
        session += "_"
    os.makedirs(session)
    path = os.path.join(session, f"{socket.gethostname()}.trace.json.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        json.dump(device_lanes(doc, cuda), f)
    with open(os.path.join(root, CAPTURE_META), "w") as f:
        json.dump({"epoch_unix_s": (time.time() if epoch_unix_s is None
                                    else float(epoch_unix_s)),
                   "pid": os.getpid(),
                   "activities": ["CPU", "CUDA"] if cuda else ["CPU"]}, f)
    return session


def traced_cuda(prof) -> bool:
    """Whether a ``torch.profiler.profile`` session traces CUDA
    activity."""
    from torch.profiler import ProfilerActivity

    return ProfilerActivity.CUDA in (getattr(prof, "activities", None)
                                     or ())


def export_profile(prof, root: str, epoch_unix_s: float) -> str:
    """Write a finished ``torch.profiler.profile`` as a capture session
    under ``root`` (:func:`write_capture`, with the session's own
    activities)."""
    import tempfile

    fd, tmp = tempfile.mkstemp(suffix=".json", dir=root)
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        with open(tmp, encoding="utf-8", errors="replace") as f:
            doc = json.load(f)
    finally:
        os.unlink(tmp)
    return write_capture(doc, root, epoch_unix_s, cuda=traced_cuda(prof))


# ---------------------------------------------------------------------------
# Memory ledger: the caching allocator's census (host-side metadata only).
# ---------------------------------------------------------------------------

def _cuda_ready() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def buffer_census(max_groups: int = MAX_CENSUS_GROUPS) -> List[dict]:
    """The CUDA caching allocator's active blocks grouped by (device,
    pool, block size), ranked by resident bytes, from
    ``torch.cuda.memory_snapshot()`` — allocator bookkeeping on the
    host, no device->host transfer (the
    ``kafka_engine_device_reads_total`` invariant is untouched).  ``[]``
    on a process that has not initialised CUDA."""
    if not _cuda_ready():
        return []
    import torch

    groups: Dict[Tuple[int, str, int], List[float]] = {}
    for seg in torch.cuda.memory_snapshot():
        dev = int(seg.get("device", 0))
        pool = str(seg.get("segment_type", "?"))
        for blk in seg.get("blocks") or ():
            if not str(blk.get("state", "")).startswith("active"):
                continue
            size = int(blk.get("size", 0))
            cell = groups.setdefault((dev, pool, size), [0.0, 0.0])
            cell[0] += size
            cell[1] += 1.0
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][0])
    return [
        {"device": dev, "pool": pool, "block_bytes": size,
         "count": int(count), "bytes": int(nbytes)}
        for (dev, pool, size), (nbytes, count) in ranked[:max_groups]
    ]


def update_ledger(registry: Optional[MetricsRegistry] = None,
                  force: bool = False) -> List[dict]:
    """Refresh the per-window memory ledger: take a buffer census,
    store it as this registry's newest ledger entry, and publish the
    live-buffer gauges.  Called from
    ``device.record_memory_watermark`` — once per window, host-side.
    Throttled to one census per ``LEDGER_MIN_INTERVAL_S``;
    ``force=True`` bypasses the throttle."""
    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    now = time.monotonic()
    if not force:
        with st.lock:
            last, census = st.census_t, st.census
        if last is not None and now - last < LEDGER_MIN_INTERVAL_S:
            return census
    census = buffer_census()
    total = float(sum(g["bytes"] for g in census))
    n = sum(g["count"] for g in census)
    with st.lock:
        st.census = census
        st.census_bytes = total
        st.census_t = now
    g = _ledger_gauges(reg)
    g["bytes"].set(total)
    g["buffers"].set(float(n))
    return census


# ---------------------------------------------------------------------------
# OOM forensics.
# ---------------------------------------------------------------------------

def is_oom(exc: Optional[BaseException]) -> bool:
    """True when the exception is a device out-of-memory unwind: a
    ``torch.cuda.OutOfMemoryError``, an allocator's out-of-memory
    message, or an injected fault at the ``device.oom`` chaos site."""
    if exc is None:
        return False
    if getattr(exc, "site", None) == "device.oom":
        return True
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in text
            or "Out of memory" in text
            or "out of memory" in text)


def memory_stats() -> List[dict]:
    """Per-device allocator readings (host calls, no device->host copy)
    of the devices this process has used (``device.used_devices``):
    bytes in use (``allocated_bytes.all.current``), peak
    (``allocated_bytes.all.peak``), reserved, and the card's free and
    total bytes from ``mem_get_info``.  ``[]`` where CUDA is not
    initialised."""
    if not _cuda_ready():
        return []
    import torch

    from .device import used_devices

    out: List[dict] = []
    for d in used_devices():
        stats = torch.cuda.memory_stats(d)
        free, total = torch.cuda.mem_get_info(d)
        out.append({
            "device": int(d),
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_reserved": stats.get("reserved_bytes.all.current"),
            "bytes_free": int(free),
            "bytes_limit": int(total),
            "num_ooms": stats.get("num_ooms"),
        })
    return out


def forensics(registry: Optional[MetricsRegistry] = None) -> dict:
    """The OOM forensic bundle the flight recorder attaches to a crash
    dump: a FRESH buffer census (what is resident right now, the
    question an OOM asks), the newest kernel table, and the per-device
    memory stats."""
    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    with st.lock:
        table = list(st.kernel_table[:16])
    return {
        "buffer_census": buffer_census(),
        "kernel_table": table,
        "memory": memory_stats(),
    }


# ---------------------------------------------------------------------------
# Mesh introspection.
# ---------------------------------------------------------------------------

def note_mesh(mesh: Any,
              registry: Optional[MetricsRegistry] = None) -> None:
    """Register the engine's pixel mesh (a ``shard.mesh.PixelMesh``: its
    ordered device list, repeats allowed) for ``/meshz``.  Called by the
    engine's mesh path at construction."""
    reg = registry if registry is not None else get_registry()
    devices = [str(d) for d in mesh.devices]
    st = _state_for(reg)
    with st.lock:
        st.mesh = {"axes": {"pixels": len(devices)},
                   "n_devices": len(devices), "devices": devices}


def note_compiled(name: str, attributes: dict,
                  registry: Optional[MetricsRegistry] = None) -> None:
    """Register one hand kernel's compiled attributes for ``/meshz``:
    registers, spill (local) bytes, static shared bytes and threads per
    block, as ``core._build.attributes`` reads them."""
    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    with st.lock:
        st.programs[str(name)] = dict(attributes)


def mesh_summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """The ``/meshz`` payload: the backend and visible devices, the
    registered mesh, the hand kernels' compiled attributes, the
    per-device share of parsed device time and the collective
    fraction."""
    import torch

    reg = registry if registry is not None else get_registry()
    devices: List[dict] = []
    backend = "cpu"
    if torch.cuda.is_available():
        backend = "cuda"
        for i in range(min(torch.cuda.device_count(), 64)):
            devices.append({"id": i, "platform": "gpu",
                            "kind": torch.cuda.get_device_name(i),
                            "process_index": 0})
    else:
        devices.append({"id": 0, "platform": "cpu", "kind": "cpu",
                        "process_index": 0})
    st = _state_for(reg)
    with st.lock:
        mesh = dict(st.mesh) if st.mesh else None
        programs = {k: dict(v) for k, v in st.programs.items()}
        split = dict(st.device_split)
        coll = st.collective_fraction
    return {
        "backend": backend,
        "n_devices": len(devices),
        "devices": devices,
        "mesh": mesh,
        "programs": programs,
        "device_time_split": split,
        "collective_fraction": coll,
    }


# ---------------------------------------------------------------------------
# Snapshots for the live plane / BENCH artifact.
# ---------------------------------------------------------------------------

def summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """Compact device-plane state for live snapshots, ``/statusz`` and
    the fleet view: capture count, top kernel, collective fraction,
    mesh axes, live-buffer total."""
    reg = registry if registry is not None else get_registry()
    st = _state_for(reg)
    with st.lock:
        top = st.kernel_table[0] if st.kernel_table else None
        return {
            "captures_parsed": st.n_captures_parsed,
            "device_ms": round(st.device_ms, 4),
            "collective_fraction": st.collective_fraction,
            "top_kernel": None if top is None else {
                "name": top["name"], "bucket": top["bucket"],
                "ms": top["ms"], "fraction": top["fraction"],
            },
            "mesh": dict(st.mesh) if st.mesh else None,
            "live_buffer_bytes": st.census_bytes,
        }
