"""Stdlib-only live metrics HTTP endpoint (the fleet plane's pull side)
(port of ``kafka_tpu/telemetry/httpd.py``).

The live snapshots (``telemetry.live``) cover fleets that share a
filesystem; a Prometheus server, a load balancer's health check or a
human with ``curl`` want HTTP.  This module is that surface with ZERO
new dependencies — ``http.server`` from the stdlib, threaded, bound to
loopback by default:

``/metrics``
    the registry's Prometheus text exposition (v0.0.4) — scrape a live
    run instead of waiting for ``metrics.prom`` at exit.  Every
    device-plane family is registered before the first scrape
    (:func:`declare_device_plane`), so the vocabulary is complete from
    the start.
``/healthz``
    the health verdict, backed by ``telemetry.health.probe_health``:
    by default it reads the LAST probe verdict through the shared
    ``health.latest_verdict`` sampling path (cheap enough for a load
    balancer's 1 Hz check); ``/healthz?probe=1`` runs a fresh probe
    round inline.  200 when healthy or unprobed, 503 when the verdict
    is off-band — or when a PAGE-severity SLO alert is firing
    (``telemetry.slo``; the objective is named in the body), so an
    external load balancer inherits SLO awareness for free.
``/statusz``
    one JSON page of process state: pid/host/uptime, TraceContext run
    id, session/queue facts from the status provider, solver-health
    counters, perf attribution (throughput / device fraction / roofline
    utilization — ``telemetry.perf``), and the crash-dump index (which
    forensics file to read when something already died).
``/profilez?seconds=N``
    on-demand ``torch.profiler`` capture (``telemetry.perf.capture``):
    records N seconds (default 2, capped) of the LIVE run into
    ``<telemetry dir>/profile/`` and answers with the capture summary.
    One capture at a time (409 while busy); 503 with a reason when the
    profiler cannot run here (no telemetry dir, profiler unavailable) or
    a capture on the card caught no GPU work — never a crash of the run
    being observed.
``/requestz``
    the serving layer's last-N request view (``telemetry.request_log``):
    in-flight requests with their stage, plus completed ones with
    status / served_from / phase durations — human text by default,
    JSON via ``?json=1``, ``?n=K`` bounds the list.  Served on both
    ``kafka-serve`` and ``kafka-route``.
``/alertz``
    the SLO engine's alert + error-budget view (``telemetry.slo``):
    per-objective status (ok/pending/firing), burn rates over the
    fast/slow windows, budget consumed/remaining and time to
    exhaustion — human text by default, JSON via ``?json=1``.  Present
    on every instrumented process; shows the stable disabled shape
    when no evaluator was started.
``/kernelz``
    the device-plane kernel view (``telemetry.devprof``): the ranked
    device kernel table from the newest parsed profiler capture
    (fusion/collective/transfer buckets, % device time), the
    collective-time fraction and the measured-vs-analytic roofline
    cross-check — human text by default, JSON via ``?json=1``, ``?n=K``
    bounds the table.  Answers 200 with ``captures_parsed: 0`` before
    any capture exists — a live probe, never a 404.
``/meshz``
    mesh/sharding introspection (``telemetry.devprof``): backend,
    device topology (id/platform/kind/process), registered mesh axes,
    partition specs of compiled solve programs, per-device
    utilization split and collective fraction — text by default,
    ``?json=1`` for machines.

**Port 0 = disabled** at the CLI layer (:func:`maybe_start`): the
endpoint is opt-in, a batch run should not open sockets.  The class
itself treats port 0 as "any free port" (`.port` reports the bound
one) — the form tests and embedded scrapers use.

Handler threads serve READS of the registry only — no sockets out, no
subprocesses (kafkalint rule 13 enforces this for the telemetry tree).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from . import devprof, perf, quality, slo, tracing
from . import live
from .live import build_snapshot, crash_dump_index
from .registry import MetricsRegistry, get_registry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class TelemetryHTTPd:
    """One process's live metrics endpoint.  ``port=0`` binds any free
    port (read it back from ``.port``); use :func:`maybe_start` for the
    CLI convention where 0 means disabled."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 status_provider: Optional[Callable[[], dict]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 role: str = "engine"):
        self.host = host
        self.status_provider = status_provider
        self.role = role
        self._registry = registry
        self._t0 = time.time()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                outer._handle(self)

            def log_message(self, fmt, *args):
                pass  # the registry counter is the access log

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        # Cross-thread trace propagation (PR 3 convention): capture the
        # constructing thread's context, re-install it on the worker.
        self._ctx = tracing.current_context()
        self._thread = threading.Thread(
            target=self._serve, name="telemetry-httpd", daemon=True,
        )

    # -- lifecycle ------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    def start(self) -> "TelemetryHTTPd":
        # /profilez starts torch.profiler on a handler thread, which
        # records no GPU kernel unless the profiler was first set up on
        # the main thread (measured on the H100: an empty capture).
        perf.prepare_profiler()
        self._thread.start()
        self._reg().emit(
            "httpd_started", host=self.host, port=self.port,
            role=self.role,
        )
        return self

    def _serve(self) -> None:
        tracing.set_context(self._ctx)
        tracing.set_lane("telemetry")
        self._server.serve_forever(poll_interval=0.1)

    def close(self) -> None:
        self._server.shutdown()
        self._thread.join(timeout=5.0)
        self._server.server_close()

    # -- request handling ----------------------------------------------

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(req.path)
        path = parsed.path.rstrip("/") or "/"
        reg = self._reg()
        reg.counter(
            "kafka_httpd_requests_total",
            "live-endpoint requests served, labelled by endpoint",
        ).inc(endpoint=path)
        try:
            if path == "/metrics":
                declare_device_plane(reg)
                self._send(req, 200, reg.prom_text(),
                           content_type=PROM_CONTENT_TYPE)
            elif path == "/healthz":
                self._healthz(req, reg, parse_qs(parsed.query))
            elif path == "/statusz":
                self._statusz(req, reg)
            elif path == "/profilez":
                self._profilez(req, reg, parse_qs(parsed.query))
            elif path == "/requestz":
                self._requestz(req, reg, parse_qs(parsed.query))
            elif path == "/alertz":
                self._alertz(req, reg, parse_qs(parsed.query))
            elif path == "/kernelz":
                self._kernelz(req, reg, parse_qs(parsed.query))
            elif path == "/meshz":
                self._meshz(req, reg, parse_qs(parsed.query))
            elif path == "/":
                self._send_json(req, 200, {
                    "endpoints": ["/metrics", "/healthz", "/statusz",
                                  "/profilez", "/requestz", "/alertz",
                                  "/kernelz", "/meshz"],
                })
            else:
                self._send_json(req, 404, {"error": f"no such endpoint "
                                                    f"{path!r}"})
        except BrokenPipeError:
            pass  # client went away mid-response — nothing to answer
        except Exception as exc:  # noqa: BLE001 — a handler bug must 500, not kill the serving thread
            reg.emit("httpd_error", path=path, error=repr(exc)[:200])
            try:
                self._send_json(req, 500, {"error": repr(exc)[:200]})
            except OSError:  # socket already torn down — response lost
                pass

    def _healthz(self, req, reg, query: Dict[str, list]) -> None:
        from .health import latest_verdict

        verdict: Optional[dict] = None
        if query.get("probe", ["0"])[0] in ("1", "true"):
            from .health import probe_health

            verdict = probe_health(retry_wait_s=0.0, registry=reg)
            unhealthy: Optional[float] = float(verdict["unhealthy"])
            last = latest_verdict(reg)
        else:
            # The shared sampling path (health.latest_verdict): the
            # gauges probe_health maintains, no probing here.
            last = latest_verdict(reg)
            unhealthy = last["unhealthy"]
        # SLO integration: a firing PAGE-severity alert flips the
        # verdict to 503 with the objective named, so external load
        # balancers inherit SLO awareness for free.
        slo_firing = slo.firing_pages(reg)
        ok = not unhealthy and not slo_firing
        body = {
            "ok": ok,
            "verdict": (
                "slo_burn" if slo_firing and not unhealthy
                else "unprobed" if unhealthy is None
                else "unhealthy" if unhealthy else "healthy"
            ),
            "probe_host_ms": last["probe_host_ms"],
            "probe_device_ms": last["probe_device_ms"],
            "slo_firing": slo_firing,
        }
        if verdict is not None:
            body["unhealthy_reasons"] = verdict["unhealthy_reasons"]
            body["probe_retried"] = verdict["probe_retried"]
        self._send_json(req, 200 if ok else 503, body)

    def _run_context(self):
        """The run's TraceContext, best source first: handler threads
        don't inherit contextvars, and the endpoint may be constructed
        before the driver pushes its run id — the live publisher
        (started inside the push) then carries the authoritative one."""
        ctx = tracing.current_context() or self._ctx
        if ctx is None:
            from .live import active_publisher

            pub = active_publisher()
            if pub is not None:
                ctx = pub._ctx
        return ctx

    def _profilez(self, req, reg, query: Dict[str, list]) -> None:
        """On-demand profiler capture into the telemetry dir.  Blocks
        THIS handler thread for the capture length (the server is
        threaded, other endpoints keep answering)."""
        try:
            seconds = float(query.get("seconds", ["2"])[0])
        except ValueError:
            self._send_json(req, 400, {
                "error": "seconds must be a number",
            })
            return
        if not reg.directory:
            self._send_json(req, 503, {
                "error": "no telemetry directory configured — start the "
                         "run with --telemetry-dir to give captures a "
                         "home",
            })
            return
        directory = os.path.join(
            reg.directory, "profile", time.strftime("%Y%m%dT%H%M%S")
        )
        try:
            result = perf.capture(seconds, directory, registry=reg)
        except perf.CaptureBusy as exc:
            self._send_json(req, 409, {"error": str(exc)})
            return
        except perf.CaptureUnavailable as exc:
            self._send_json(req, 503, {"error": str(exc)})
            return
        self._send_json(req, 200, {"ok": True, **result})

    def _requestz(self, req, reg, query: Dict[str, list]) -> None:
        """Last-N in-flight and completed requests (the serving
        layer's per-request view, ``telemetry.request_log``)."""
        from . import request_log

        try:
            n = int(query.get("n", ["32"])[0])
        except ValueError:
            self._send_json(req, 400, {"error": "n must be an integer"})
            return
        payload = request_log.requestz(n, registry=reg)
        if query.get("json", ["0"])[0] in ("1", "true"):
            self._send_json(req, 200, payload)
            return
        lines = [f"{len(payload['inflight'])} in flight, "
                 f"{len(payload['recent'])} recent"]
        for r in payload["inflight"]:
            lines.append(
                f"  INFLIGHT {r.get('request_id')} "
                f"tile={r.get('tile')} stage={r.get('stage')}"
                + (f" replica={r['replica']}" if r.get("replica")
                   else "")
            )
        for r in payload["recent"]:
            phases = r.get("phases") or {}
            worst = max(phases, key=phases.get) if phases else None
            e2e = r.get("e2e_ms")
            lines.append(
                f"  {r.get('request_id')} {r.get('status')}"
                + (f" {r['served_from']}" if r.get("served_from")
                   else "")
                + (f" {e2e:.1f}ms" if isinstance(e2e, (int, float))
                   else "")
                + (f" worst={worst}({phases[worst]:.1f}ms)"
                   if worst else "")
            )
        self._send(req, 200, "\n".join(lines) + "\n")

    def _alertz(self, req, reg, query: Dict[str, list]) -> None:
        """SLO alert + error-budget state (``telemetry.slo``): text by
        default, full summary via ``?json=1``."""
        payload = slo.summary(reg)
        if query.get("json", ["0"])[0] in ("1", "true"):
            self._send_json(req, 200, payload)
            return
        if not payload.get("enabled"):
            self._send(req, 200, "slo engine not running\n")
            return
        firing = payload["firing"]
        lines = [
            f"slo: {len(firing)} alert(s) firing, "
            f"{payload['alerts_fired']} fired / "
            f"{payload['alerts_resolved']} resolved this run "
            f"(windows {payload['fast_window_s']:g}s/"
            f"{payload['slow_window_s']:g}s)"
        ]
        for a in firing:
            lines.append(
                f"  FIRING [{a['severity']}] {a['objective']} "
                f"burn fast={a['burn_fast']} slow={a['burn_slow']}"
            )
        for name, o in payload["objectives"].items():
            b = o["budget"]
            tte = "-" if b.get("tte_s") is None else f"{b['tte_s']:g}s"
            lines.append(
                f"  {name}: {o['status']} target={o['target']:g} "
                f"burn={o['burn_fast'] if o['burn_fast'] is not None else '-'}"
                f"/{o['burn_slow'] if o['burn_slow'] is not None else '-'} "
                f"budget consumed={b['consumed']:g} "
                f"remaining={b['remaining']:g} tte={tte}"
            )
        self._send(req, 200, "\n".join(lines) + "\n")

    def _kernelz(self, req, reg, query: Dict[str, list]) -> None:
        """Ranked device kernel table from the newest parsed capture
        (``telemetry.devprof``): text by default, ``?json=1`` for the
        full payload, ``?n=K`` bounds the table.  200 even before any
        capture was parsed — the empty shape IS the answer."""
        try:
            n = int(query.get("n", ["16"])[0])
        except ValueError:
            self._send_json(req, 400, {"error": "n must be an integer"})
            return
        payload = devprof.kernel_summary(reg, n=n)
        if query.get("json", ["0"])[0] in ("1", "true"):
            self._send_json(req, 200, payload)
            return
        cf = payload.get("collective_fraction")
        lines = [
            f"kernels: {payload['captures_parsed']} capture(s) parsed, "
            f"device {payload['device_ms']:.3f}ms"
            + (f", collective {cf:.1%}" if cf is not None else "")
        ]
        if not payload["kernels"]:
            lines.append(
                "  (no capture parsed yet — trigger one via /profilez "
                "or --profile-windows)"
            )
        for k in payload["kernels"]:
            lines.append(
                f"  {k['ms']:10.3f}ms {k['fraction']:6.1%} "
                f"[{k['bucket']:10s}] x{k['count']} {k['name']}"
            )
        rc = payload.get("roofline_crosscheck")
        if rc:
            lines.append(
                f"  roofline: measured {rc['measured_device_ms']:.3f}ms "
                f"vs analytic floor "
                f"{rc['analytic_min_ms_per_window']:.4f}ms/window "
                f"({rc['component']}-bound)"
            )
        self._send(req, 200, "\n".join(lines) + "\n")

    def _meshz(self, req, reg, query: Dict[str, list]) -> None:
        """Mesh/sharding introspection (``telemetry.devprof``): device
        topology, registered mesh axes, compiled-program partition
        specs, per-device time split.  Text by default, ``?json=1``."""
        payload = devprof.mesh_summary(reg)
        if query.get("json", ["0"])[0] in ("1", "true"):
            self._send_json(req, 200, payload)
            return
        mesh = payload.get("mesh")
        lines = [
            f"mesh: backend={payload['backend']} "
            f"n_devices={payload['n_devices']}"
            + (f" axes={mesh['axes']}" if mesh else " (no mesh registered)")
        ]
        for d in payload["devices"]:
            lines.append(
                f"  device {d['id']}: {d['platform']}"
                + (f" {d['kind']}" if d.get("kind") else "")
                + f" process={d['process_index']}"
            )
        for name, prog in (payload.get("programs") or {}).items():
            lines.append(
                f"  program {name}: in={prog.get('in')} "
                f"out={prog.get('out')}"
            )
        split = payload.get("device_time_split") or {}
        for track, frac in sorted(split.items()):
            lines.append(f"  time {track}: {frac:.1%}")
        cf = payload.get("collective_fraction")
        if cf is not None:
            lines.append(f"  collective fraction: {cf:.1%}")
        self._send(req, 200, "\n".join(lines) + "\n")

    def _statusz(self, req, reg) -> None:
        ctx = self._run_context()
        solver = {
            k: v for k, v in reg.flat().items()
            if k.startswith("kafka_solver_")
        }
        status = {}
        if self.status_provider is not None:
            status = dict(self.status_provider() or {})
        snap = build_snapshot(reg, role=self.role)
        self._send_json(req, 200, {
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "role": self.role,
            "uptime_s": round(time.time() - self._t0, 3),
            "run_id": None if ctx is None else ctx.run_id,
            "telemetry_dir": reg.directory,
            "events_buffered": len(reg.events),
            "metric_series": (len(snap["counters"]) + len(snap["gauges"])
                              + len(snap["histograms"])),
            "solver_health": solver,
            # Assimilation-quality verdicts (telemetry.quality): the
            # science-side health next to the process-side one.
            "quality": quality.summary(reg),
            # Performance attribution (telemetry.perf): live throughput,
            # device fraction, phase breakdown, roofline utilization.
            "perf": perf.summary(reg),
            # SLO alert + budget state (telemetry.slo): the /alertz
            # payload inline, so one /statusz read answers "is anything
            # firing" too.
            "slo": slo.summary(reg),
            # Device-plane state (telemetry.devprof): captures parsed,
            # top kernel, mesh facts, live-buffer bytes.
            "devprof": devprof.summary(reg),
            "crash_dumps": crash_dump_index(reg.directory),
            "status": status,
        })

    # -- response plumbing ---------------------------------------------

    @staticmethod
    def _send(req, code: int, body: str,
              content_type: str = "text/plain; charset=utf-8") -> None:
        payload = body.encode("utf-8")
        req.send_response(code)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)

    @classmethod
    def _send_json(cls, req, code: int, body: dict) -> None:
        cls._send(req, code, json.dumps(body, default=str, indent=2),
                  content_type="application/json")


def declare_device_plane(reg: MetricsRegistry) -> None:
    """Register every device-plane metric family in ``reg`` (counters at
    zero, gauges and histograms without samples until their first
    event), so a scrape shows the whole vocabulary from the first
    request on, failure counters included."""
    from . import compilemon, device, health

    for module in (device, devprof, perf, health, compilemon, live):
        module.declare(reg)
    slo._slo_metrics(reg)


def maybe_start(port: Optional[int], **kwargs) -> Optional[TelemetryHTTPd]:
    """The CLI convention: ``--http-port 0`` (the default) means
    DISABLED — a batch run must not open listening sockets unasked.
    Any nonzero port starts the endpoint and returns it."""
    if not port:
        return None
    return TelemetryHTTPd(port=int(port), **kwargs).start()
